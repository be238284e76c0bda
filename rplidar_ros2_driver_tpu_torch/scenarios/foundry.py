"""Procedural world foundry: seeded segment-list scenes with a
vectorized 2-D raycaster and a ground-truth occupancy rasterization.

A copy of the JAX package's ``scenarios/foundry.py``.  Its output FEEDS
WIRE BYTES: ``FoundryScene.dist_mm`` is the ``SimConfig.scene``
provider the sim encodes into all six measurement formats.  The
byte-determinism contract is therefore strict:

- **pure function of (seed, rev, beam)** — a scene built twice from the
  same :class:`SceneSpec` returns byte-equal distances for the same
  (theta, rev) queries, in ANY chunking.  All randomness is either
  construction-time (``default_rng(seed)`` lays out walls once) or a
  counter-based splitmix64 hash of (seed, rev, beam-index) — never a
  stateful stream-time RNG, whose draws would depend on query order.
- **no transcendental stream math** — ray directions come from the
  matcher's int32 :func:`rotation_table` (theta quantized to
  ``spec.theta_table`` bins, the table exact over ``ANG = 2**14``), and
  per-revolution pose trig is precomputed by :class:`Trajectory`; the
  stream path is elementwise float64 mul/add/div + per-row min, all
  chunking-invariant.

World vocabulary (ROADMAP item 4): multi-room floorplans with doorways
and clutter, feature-starved corridors (where range-only de-skew ties
to identity), a return-to-start loop annulus, limited sensor range
(``max_range_m`` → no return), specular panels and seeded dropout
(no-return beams), and moving obstacles that relocate or vanish at a
scripted revolution (the mapper-decay workload).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from rplidar_ros2_driver_tpu_torch.ops.scan_match import ANG, rotation_table
from rplidar_ros2_driver_tpu_torch.scenarios.trajectory import (
    Trajectory,
    organic,
    scripted_line,
    scripted_loop,
    scripted_waypoints,
)

MAT_PLAIN = 0
MAT_SPECULAR = 1       # drops ~3/4 of returns (hash-kept quarter survives)

_RAY_EPS = 1e-9
_SPECULAR_KEEP = 0x40000000  # keep a specular return iff hash32 < 2^30

SCENE_KINDS = ("rooms", "corridor", "loop", "decay")


@dataclasses.dataclass(frozen=True)
class SceneSpec:
    """Construction recipe for one procedural world.  Frozen: the spec
    IS the scene identity — equal specs build byte-equal scenes."""

    kind: str                    # one of SCENE_KINDS
    seed: int = 0
    n_revs: int = 32             # trajectory length (poses park after)
    max_range_m: float = 8.0     # returns beyond this are dropped (0 mm)
    dropout_rate: float = 0.0    # seeded per-(rev, beam) no-return rate
    theta_table: int = 14400     # ray-direction quantization bins / rev

    def __post_init__(self):
        if self.kind not in SCENE_KINDS:
            raise ValueError(
                f"scene kind must be one of {SCENE_KINDS}, got "
                f"{self.kind!r}"
            )
        if self.n_revs < 5:
            raise ValueError("scene n_revs must be >= 5")
        if not (0.5 <= self.max_range_m <= 30.0):
            raise ValueError("scene max_range_m must be in [0.5, 30]")
        if not (0.0 <= self.dropout_rate <= 0.5):
            raise ValueError("scene dropout_rate must be in [0, 0.5]")
        if self.theta_table < 360 or self.theta_table % 360:
            raise ValueError(
                "scene theta_table must be a positive multiple of 360"
            )


@dataclasses.dataclass(frozen=True)
class MovingBox:
    """Axis-aligned square obstacle whose center is a pure function of
    the revolution: at ``(x0, y0)`` before ``move_rev``, then either at
    ``(x1, y1)`` or absent entirely (``vanish``)."""

    x0: float
    y0: float
    x1: float
    y1: float
    half: float
    move_rev: int
    vanish: bool = False

    def at(self, revs: np.ndarray):
        """(present mask, center x, center y) per query revolution."""
        before = np.asarray(revs, np.int64) < self.move_rev
        present = before | (not self.vanish)
        cx = np.where(before, np.float64(self.x0), np.float64(self.x1))
        cy = np.where(before, np.float64(self.y0), np.float64(self.y1))
        return present, cx, cy


def _mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer, elementwise over uint64."""
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def _hash32(seed: int, revs: np.ndarray, beam_idx: np.ndarray) -> np.ndarray:
    """Counter-based per-(rev, beam) hash — high 32 bits of splitmix64
    over the (rev, beam) counter, salted by the scene seed.  Pure and
    elementwise, so identical for a beam no matter how the stream is
    chunked."""
    with np.errstate(over="ignore"):
        ctr = (
            (np.asarray(revs, np.uint64) << np.uint64(32))
            | np.asarray(beam_idx, np.uint64)
        )
        salt = np.uint64((seed * 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF)
        return _mix64(ctr ^ salt) >> np.uint64(32)


def _ray_seg_t(ox, oy, dx, dy, x1, y1, x2, y2):
    """Ray/segment intersection parameter t (distance in metres for a
    unit direction), +inf where there is none.  Broadcasts: rays and
    segment endpoints may be any mutually-broadcastable shapes."""
    ex, ey = x2 - x1, y2 - y1
    ax, ay = x1 - ox, y1 - oy
    denom = dx * ey - dy * ex
    with np.errstate(divide="ignore", invalid="ignore"):
        t = (ax * ey - ay * ex) / denom
        u = (ax * dy - ay * dx) / denom
        hit = (
            (np.abs(denom) > np.float64(_RAY_EPS))
            & (t > np.float64(_RAY_EPS))
            & (u >= np.float64(0.0))
            & (u <= np.float64(1.0))
        )
    return np.where(hit, t, np.float64(np.inf))


class FoundryScene:
    """One built world: static segments + materials, moving obstacles,
    and the ground-truth :class:`Trajectory` driving the sensor."""

    def __init__(self, spec: SceneSpec) -> None:
        self.spec = spec
        segs, mats, moving, traj = _BUILDERS[spec.kind](spec)
        self.segments = np.asarray(segs, np.float64).reshape(-1, 4)
        self.materials = np.asarray(mats, np.int32)
        if self.materials.shape[0] != self.segments.shape[0]:
            raise ValueError("one material per segment")
        self.moving = tuple(moving)
        self.traj = traj
        # int32-exact ray-direction table: ANG is a power of two, so the
        # float64 division below is exact and the directions are a pure
        # function of the table index
        tab = rotation_table(spec.theta_table)
        self._dir_x = tab[:, 0] / np.float64(ANG)
        self._dir_y = tab[:, 1] / np.float64(ANG)
        self._drop_thr = int(round(
            np.float64(spec.dropout_rate) * np.float64(1 << 32)
        ))

    # ------------------------------------------------------------------
    # stream seam (the SimConfig.scene provider contract)
    # ------------------------------------------------------------------

    def beam_index(self, thetas_deg: np.ndarray) -> np.ndarray:
        """Quantize query angles onto the ray table — the beam identity
        used by the per-(rev, beam) hash."""
        th = np.asarray(thetas_deg, np.float64)
        bins = np.float64(self.spec.theta_table / 360.0)
        # graftlint: policed — theta_deg is a finite angle in [0, 360)
        # from the sim's (p % ppr) contract; round lands in [0, bins]
        idx = np.round(th * bins).astype(np.int64)
        return idx % self.spec.theta_table

    def dist_mm(self, thetas_deg, revs) -> np.ndarray:
        """Measured range in mm per (theta, rev) query — 0.0 for a
        no-return beam (out of range, dropout, or specular loss).  The
        ONE stream-time entry point; pure in (seed, rev, beam)."""
        rv = np.asarray(revs, np.int64)
        idx = self.beam_index(thetas_deg)
        bx, by = self._dir_x[idx], self._dir_y[idx]
        k = np.clip(rv, 0, self.traj.n_revs - 1)
        ch, sh = self.traj.cos_h[k], self.traj.sin_h[k]
        ox, oy = self.traj.x_m[k], self.traj.y_m[k]
        dxw = bx * ch - by * sh
        dyw = bx * sh + by * ch
        d_m, mat = self.raycast(ox, oy, dxw, dyw, rv)
        keep = d_m <= np.float64(self.spec.max_range_m)
        h32 = _hash32(self.spec.seed, rv, idx)
        if self._drop_thr:
            keep &= h32 >= self._drop_thr
        keep &= (mat != MAT_SPECULAR) | (h32 < _SPECULAR_KEEP)
        return np.where(keep, d_m * np.float64(1000.0), np.float64(0.0))

    def truth_dist_mm(self, thetas_deg, revs) -> np.ndarray:
        """Geometric ground truth: the same raycast with the range limit
        but WITHOUT dropout/specular losses — what a perfect sensor
        would measure, for metric targets."""
        rv = np.asarray(revs, np.int64)
        idx = self.beam_index(thetas_deg)
        bx, by = self._dir_x[idx], self._dir_y[idx]
        k = np.clip(rv, 0, self.traj.n_revs - 1)
        ch, sh = self.traj.cos_h[k], self.traj.sin_h[k]
        dxw = bx * ch - by * sh
        dyw = bx * sh + by * ch
        d_m, _mat = self.raycast(
            self.traj.x_m[k], self.traj.y_m[k], dxw, dyw, rv
        )
        keep = d_m <= np.float64(self.spec.max_range_m)
        return np.where(keep, d_m * np.float64(1000.0), np.float64(0.0))

    def probe_dist_mm(self, x_m: float, y_m: float, thetas_deg,
                      rev: int = 0) -> np.ndarray:
        """Clean ranges (mm) from an arbitrary probe pose with heading
        0 — geometry only (range-limited, no dropout/specular loss) —
        for de-skew/metric probes off the scripted trajectory."""
        idx = self.beam_index(thetas_deg)
        bx, by = self._dir_x[idx], self._dir_y[idx]
        n = idx.shape[0]
        d_m, _mat = self.raycast(
            np.full(n, np.float64(x_m)), np.full(n, np.float64(y_m)),
            bx, by, np.full(n, int(rev), np.int64),
        )
        keep = d_m <= np.float64(self.spec.max_range_m)
        return np.where(keep, d_m * np.float64(1000.0), np.float64(0.0))

    # ------------------------------------------------------------------
    # raycaster
    # ------------------------------------------------------------------

    def raycast(self, ox, oy, dx, dy, revs):
        """First-hit distance (metres, +inf for a miss) and material per
        ray.  Static segments resolve as a (rays x segments) min per
        row; moving boxes overlay their four edges with per-ray rev-
        dependent coordinates."""
        t = _ray_seg_t(
            np.asarray(ox, np.float64)[:, None],
            np.asarray(oy, np.float64)[:, None],
            np.asarray(dx, np.float64)[:, None],
            np.asarray(dy, np.float64)[:, None],
            self.segments[:, 0], self.segments[:, 1],
            self.segments[:, 2], self.segments[:, 3],
        )
        j = np.argmin(t, axis=1)
        rows = np.arange(t.shape[0])
        best = t[rows, j]
        mat = np.where(
            np.isfinite(best), self.materials[j], np.int32(MAT_PLAIN)
        )
        for box in self.moving:
            present, cx, cy = box.at(revs)
            h = np.float64(box.half)
            xa, xb = cx - h, cx + h
            ya, yb = cy - h, cy + h
            edges = ((xa, ya, xb, ya), (xb, ya, xb, yb),
                     (xb, yb, xa, yb), (xa, yb, xa, ya))
            for (x1, y1, x2, y2) in edges:
                tb = _ray_seg_t(ox, oy, dx, dy, x1, y1, x2, y2)
                tb = np.where(present, tb, np.float64(np.inf))
                closer = tb < best
                best = np.where(closer, tb, best)
                mat = np.where(closer, np.int32(MAT_PLAIN), mat)
        return best, mat

    # ------------------------------------------------------------------
    # ground-truth occupancy raster
    # ------------------------------------------------------------------

    def occupancy(
        self, grid: int, cell_m: float, center_xy=(0.0, 0.0),
        rev: int = 0,
    ) -> np.ndarray:
        """(grid, grid) bool geometric occupancy: cells crossed by any
        segment (moving boxes evaluated at ``rev``), the map frame
        centered on ``center_xy`` like the mapper centers its grid on
        the start pose."""
        occ = np.zeros((grid, grid), bool)
        segs = [tuple(s) for s in self.segments]
        rev_arr = np.asarray([rev], np.int64)
        for box in self.moving:
            present, cx, cy = box.at(rev_arr)
            if bool(present[0]):
                x0, x1 = float(cx[0] - box.half), float(cx[0] + box.half)
                y0, y1 = float(cy[0] - box.half), float(cy[0] + box.half)
                segs.extend([
                    (x0, y0, x1, y0), (x1, y0, x1, y1),
                    (x1, y1, x0, y1), (x0, y1, x0, y0),
                ])
        step = np.float64(cell_m) / np.float64(4.0)
        for (x1, y1, x2, y2) in segs:
            n = max(int(np.hypot(x2 - x1, y2 - y1) / np.float64(step)), 1)
            ts = np.linspace(np.float64(0.0), np.float64(1.0), n + 1)
            xs = np.float64(x1) + ts * np.float64(x2 - x1)
            ys = np.float64(y1) + ts * np.float64(y2 - y1)
            # graftlint: policed — sample coords are finite scene
            # geometry; floor lands within ±grid after the bounds mask
            ix = np.floor(
                (xs - np.float64(center_xy[0])) / np.float64(cell_m)
            ).astype(np.int64) + grid // 2
            # graftlint: policed — same finite-geometry floor as ix
            iy = np.floor(
                (ys - np.float64(center_xy[1])) / np.float64(cell_m)
            ).astype(np.int64) + grid // 2
            inb = (ix >= 0) & (ix < grid) & (iy >= 0) & (iy < grid)
            occ[ix[inb], iy[inb]] = True
        return occ


def raycast_brute(
    scene: FoundryScene, ox: float, oy: float, dx: float, dy: float,
    rev: int,
):
    """Scalar per-segment twin of :meth:`FoundryScene.raycast` — one
    ray, a Python loop over every segment with the same float64
    formulas, for the golden test.  Returns (t, material)."""
    best, mat = np.inf, MAT_PLAIN
    for s, m in zip(scene.segments, scene.materials):
        t = float(_ray_seg_t(
            np.float64(ox), np.float64(oy), np.float64(dx),
            np.float64(dy), np.float64(s[0]), np.float64(s[1]),
            np.float64(s[2]), np.float64(s[3]),
        ))
        if t < best:
            best, mat = t, int(m)
    rev_arr = np.asarray([rev], np.int64)
    for box in scene.moving:
        present, cx, cy = box.at(rev_arr)
        if not bool(present[0]):
            continue
        h = float(box.half)
        x0, x1 = float(cx[0]) - h, float(cx[0]) + h
        y0, y1 = float(cy[0]) - h, float(cy[0]) + h
        for (ax, ay, bx, by) in ((x0, y0, x1, y0), (x1, y0, x1, y1),
                                 (x1, y1, x0, y1), (x0, y1, x0, y0)):
            t = float(_ray_seg_t(
                np.float64(ox), np.float64(oy), np.float64(dx),
                np.float64(dy), np.float64(ax), np.float64(ay),
                np.float64(bx), np.float64(by),
            ))
            if t < best:
                best, mat = t, MAT_PLAIN
    return best, mat


# ----------------------------------------------------------------------
# scene builders (construction-time RNG only)
# ----------------------------------------------------------------------

def _box_segments(x0, y0, x1, y1):
    return [(x0, y0, x1, y0), (x1, y0, x1, y1),
            (x1, y1, x0, y1), (x0, y1, x0, y0)]


def _build_rooms(spec: SceneSpec):
    """Two-room floorplan: outer shell, a dividing wall with a doorway,
    clutter boxes in the far room, one specular panel on the west wall,
    and an organically drifting robot in the near room."""
    rng = np.random.default_rng(spec.seed)
    half = 3.0
    segs = _box_segments(-half, -half, half, half)
    mats = [MAT_PLAIN] * 4
    wall_x = float(rng.uniform(0.4, 1.0))
    door_c = float(rng.uniform(-1.2, 1.2))
    door_h = 0.45
    segs += [(wall_x, -half, wall_x, door_c - door_h),
             (wall_x, door_c + door_h, wall_x, half)]
    mats += [MAT_PLAIN, MAT_PLAIN]
    for _ in range(3):  # clutter lives in the far room
        cx = float(rng.uniform(wall_x + 0.5, half - 0.4))
        cy = float(rng.uniform(-half + 0.4, half - 0.4))
        h = float(rng.uniform(0.12, 0.25))
        segs += _box_segments(cx - h, cy - h, cx + h, cy + h)
        mats += [MAT_PLAIN] * 4
    panel_c = float(rng.uniform(-1.5, 1.5))
    segs.append((-half, panel_c - 0.6, -half, panel_c + 0.6))
    mats.append(MAT_SPECULAR)
    traj = organic(
        spec.n_revs, seed=spec.seed + 101, start_xy=(-1.2, 0.0),
        speed_m=0.1,
        bounds=(-half + 0.6, wall_x - 0.5, -half + 0.6, half - 0.6),
    )
    return segs, mats, [], traj


def _build_corridor(spec: SceneSpec):
    """Feature-starved hall: two parallel walls whose ends lie beyond
    sensor range, robot marching straight down the axis — translation
    along x is range-invariant, the de-skew tie-to-identity workload."""
    segs = [(-40.0, -0.9, 40.0, -0.9), (-40.0, 0.9, 40.0, 0.9)]
    mats = [MAT_PLAIN, MAT_PLAIN]
    traj = scripted_line(
        spec.n_revs, start_xy=(-1.5, 0.0), heading=0.0, speed_m=0.12
    )
    return segs, mats, [], traj


def _build_loop(spec: SceneSpec):
    """Square annulus: outer shell + inner block form a closed corridor
    loop; the scripted trajectory walks the ring and genuinely returns
    to its start pose (the PR 11 loop-closure workload).  The ring is
    sized twice over: per-rev motion (perimeter 8 * 1.2 m over n_revs)
    stays inside the matcher search window for ``n_revs`` >= ~40, and
    every pose keeps |x|,|y| <= 2.4 m RELATIVE TO THE START so the
    truth lattice fits a 6.4 m map plane."""
    segs = _box_segments(-2.0, -2.0, 2.0, 2.0)
    segs += _box_segments(-1.0, -1.0, 1.0, 1.0)
    # a bare square annulus aliases under pure translation (the view
    # repeats every inner-box side), so a matcher can re-lock a whole
    # period off — seeded clutter hugging the outer wall of each side
    # breaks the symmetry the way real corridors' furniture does
    rng = np.random.default_rng(spec.seed)
    for side in range(4):
        # stratified: one box per side-half, so no seed can leave a
        # whole side featureless (a bare side re-aliases the ring)
        for lo, hi in ((-1.5, -0.2), (0.2, 1.5)):
            a = float(rng.uniform(lo, hi))
            h = float(rng.uniform(0.08, 0.14))
            cx, cy = [(a, 1.72), (1.72, a), (a, -1.72), (-1.72, a)][side]
            segs += _box_segments(cx - h, cy - h, cx + h, cy + h)
    mats = [MAT_PLAIN] * len(segs)
    traj = scripted_loop(spec.n_revs, center_xy=(0.0, 0.0), radius_m=1.2)
    return segs, mats, [], traj


def _build_decay(spec: SceneSpec):
    """Moved-obstacle workload: a box is mapped up close, the robot
    leaves its sensor-range bubble, THEN the box vanishes — no later
    ray ever crosses the stale cells, so only log-odds decay can fade
    them (build with a small ``max_range_m``, e.g. 2.0)."""
    half = 3.0
    segs = _box_segments(-half, -half, half, half)
    mats = [MAT_PLAIN] * 4
    dwell = max(spec.n_revs // 4, 4)
    move_rev = dwell + 8  # after the robot is out of range of (1.8, 0)
    box = MovingBox(
        x0=1.8, y0=0.0, x1=1.8, y1=0.0, half=0.25,
        move_rev=move_rev, vanish=True,
    )
    traj = scripted_waypoints(
        [(0.9, 0.0), (-2.2, 0.0)],
        [dwell, max(spec.n_revs - dwell, 1)], speed_m=0.3,
    )
    return segs, mats, [box], traj


_BUILDERS = {
    "rooms": _build_rooms,
    "corridor": _build_corridor,
    "loop": _build_loop,
    "decay": _build_decay,
}


def build_scene(spec: SceneSpec) -> FoundryScene:
    """Build the world for ``spec`` — equal specs yield scenes whose
    ``dist_mm`` streams are byte-equal in any chunking."""
    return FoundryScene(spec)

"""Ground-truth robot trajectories for the scenario foundry.

A :class:`Trajectory` is a per-revolution pose table ``(x_m, y_m,
heading_rad)`` built ONCE at construction — the foundry's stream-time
raycast only indexes the precomputed arrays, so any math here (libm
trig, RNG) cannot perturb the foundry's byte-determinism-across-
chunkings contract.

Two families:

- **scripted** paths (:func:`scripted_line`, :func:`scripted_loop`,
  :func:`scripted_waypoints`) — exact geometric programs; the loop
  variant is a genuine return-to-start (``pose[last] == pose[0]``),
  which is what the PR 11 loop-closure machinery needs to fire.
- **organic** drift (:func:`organic`) — a seeded velocity-noise random
  walk (heading random walk + constant speed, clamped to a bounding
  box), the "clean rooms cannot produce organic front-end drift"
  answer from config 17's own notes.
"""

from __future__ import annotations

import math

import numpy as np


class Trajectory:
    """Per-revolution ground-truth poses.

    ``poses`` is ``(N, 3)`` float64 ``[x_m, y_m, heading_rad]``.  The
    heading cos/sin are precomputed so stream-time consumers never call
    trig.  Revolutions past the end hold the final pose (a stream that
    outruns the script parks, it does not wrap)."""

    def __init__(self, poses: np.ndarray) -> None:
        poses = np.asarray(poses, np.float64)
        if poses.ndim != 2 or poses.shape[1] != 3 or poses.shape[0] < 1:
            raise ValueError("trajectory poses must be (N>=1, 3)")
        self.poses = poses
        self.x_m = poses[:, 0].copy()
        self.y_m = poses[:, 1].copy()
        self.heading = poses[:, 2].copy()
        self.cos_h = np.array([math.cos(h) for h in self.heading])
        self.sin_h = np.array([math.sin(h) for h in self.heading])

    @property
    def n_revs(self) -> int:
        return int(self.poses.shape[0])

    def pose(self, rev: int) -> np.ndarray:
        """Ground-truth pose at ``rev`` (clamped into the table)."""
        k = min(max(int(rev), 0), self.n_revs - 1)
        return self.poses[k]

    def relative_poses(self) -> np.ndarray:
        """Poses expressed in the START frame (pose 0 becomes the
        origin with heading 0) — the frame the mapper's pose lattice
        lives in."""
        c0, s0 = self.cos_h[0], self.sin_h[0]
        dx = self.x_m - self.x_m[0]
        dy = self.y_m - self.y_m[0]
        out = np.empty_like(self.poses)
        out[:, 0] = c0 * dx + s0 * dy
        out[:, 1] = -s0 * dx + c0 * dy
        out[:, 2] = self.heading - self.heading[0]
        return out

    def is_loop(self, tol_m: float = 1e-9) -> bool:
        """True when the path genuinely returns to its start pose."""
        return (
            abs(self.x_m[-1] - self.x_m[0]) <= tol_m
            and abs(self.y_m[-1] - self.y_m[0]) <= tol_m
        )


def scripted_line(
    n_revs: int, start_xy=(0.0, 0.0), heading: float = 0.0,
    speed_m: float = 0.12,
) -> Trajectory:
    """Straight constant-speed run: ``speed_m`` metres per revolution
    along ``heading``."""
    k = np.arange(n_revs, dtype=np.float64)
    poses = np.empty((n_revs, 3))
    poses[:, 0] = start_xy[0] + speed_m * k * math.cos(heading)
    poses[:, 1] = start_xy[1] + speed_m * k * math.sin(heading)
    poses[:, 2] = heading
    return Trajectory(poses)


def scripted_loop(
    n_revs: int, center_xy=(0.0, 0.0), radius_m: float = 2.2,
) -> Trajectory:
    """Square return-to-start loop: out along +x then around the four
    corners of a square of half-side ``radius_m`` and back to the exact
    start pose (``pose[n_revs-1] == pose[0]``), heading fixed so the
    matcher sees pure translation.  Needs ``n_revs >= 5``."""
    if n_revs < 5:
        raise ValueError("a return-to-start loop needs n_revs >= 5")
    r = radius_m
    cx, cy = center_xy
    corners = np.array([
        [cx + r, cy + 0.0],
        [cx + r, cy + r],
        [cx - r, cy + r],
        [cx - r, cy - r],
        [cx + r, cy - r],
        [cx + r, cy + 0.0],
    ])
    # arc-length parameterization: n_revs poses over the closed polyline,
    # first and last exactly equal
    seg = np.diff(corners, axis=0)
    seg_len = np.hypot(seg[:, 0], seg[:, 1])
    cum = np.concatenate([[0.0], np.cumsum(seg_len)])
    total = cum[-1]
    s = np.linspace(0.0, total, n_revs)
    poses = np.empty((n_revs, 3))
    for i, si in enumerate(s):
        j = int(np.searchsorted(cum, si, side="right") - 1)
        j = min(j, len(seg) - 1)
        t = (si - cum[j]) / seg_len[j]
        poses[i, 0] = corners[j, 0] + t * seg[j, 0]
        poses[i, 1] = corners[j, 1] + t * seg[j, 1]
        poses[i, 2] = 0.0
    poses[-1, :2] = poses[0, :2]  # exact, not within-float-of
    return Trajectory(poses)


def scripted_waypoints(
    waypoints, dwell_revs, speed_m: float = 0.3,
) -> Trajectory:
    """Dwell-then-transit program: park ``dwell_revs[i]`` revolutions at
    ``waypoints[i]``, then walk toward the next waypoint at ``speed_m``
    per revolution.  Used by the decay scenario (map an obstacle up
    close, then leave its sensor-range bubble)."""
    wps = [np.asarray(w, np.float64) for w in waypoints]
    if len(wps) != len(dwell_revs) or not wps:
        raise ValueError("waypoints and dwell_revs must pair up")
    rows = []
    for i, (w, dwell) in enumerate(zip(wps, dwell_revs)):
        rows.extend([(w[0], w[1], 0.0)] * int(dwell))
        if i + 1 < len(wps):
            vec = wps[i + 1] - w
            dist = float(np.hypot(vec[0], vec[1]))
            steps = max(int(math.ceil(dist / speed_m)), 1)
            for k in range(1, steps):
                p = w + vec * (k / steps)
                rows.append((p[0], p[1], 0.0))
    return Trajectory(np.asarray(rows))


def organic(
    n_revs: int, seed: int, start_xy=(0.0, 0.0), speed_m: float = 0.1,
    turn_noise_rad: float = 0.035, bounds=(-2.4, 2.4, -2.4, 2.4),
) -> Trajectory:
    """Seeded velocity-noise drift: the heading takes a uniform random
    walk of at most ``turn_noise_rad`` per revolution while the
    position integrates a constant ``speed_m`` along it — organic
    wander a scripted trace cannot produce, reproducible from ``seed``.

    EVERY per-revolution heading change is capped at 0.05 rad (~2.9°),
    inside the matcher's ±3° θ search window: near a bound the robot
    slows to quarter speed and steers toward the room centre under
    that same cap instead of reflecting (an instant bounce is a
    180°-in-one-rev pose jump no correlative matcher can follow, which
    would make every rooms cell score matcher limits, not scenario
    difficulty)."""
    rng = np.random.default_rng(seed)
    x0, x1, y0, y1 = bounds
    cx, cy = (x0 + x1) / 2.0, (y0 + y1) / 2.0
    margin = max(3.0 * speed_m, 0.3)
    max_turn = 0.05  # rad/rev — the matcher-trackable cap
    poses = np.empty((n_revs, 3))
    x, y, h = float(start_xy[0]), float(start_xy[1]), 0.0
    for k in range(n_revs):
        poses[k] = (x, y, h)
        v = speed_m
        near = (
            x - x0 < margin or x1 - x < margin
            or y - y0 < margin or y1 - y < margin
        )
        if near:
            # steering replaces noise: full correction toward centre,
            # clipped into the trackable per-rev turn budget
            want = math.atan2(cy - y, cx - x)
            d = math.atan2(math.sin(want - h), math.cos(want - h))
            h += min(max(d, -max_turn), max_turn)
            v = speed_m * 0.25
        else:
            h += float(rng.uniform(-turn_noise_rad, turn_noise_rad))
        x = min(max(x + v * math.cos(h), x0), x1)
        y = min(max(y + v * math.sin(h), y0), y1)
    return Trajectory(poses)

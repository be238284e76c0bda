"""Correlative scan-to-map matching and log-odds occupancy mapping.

The PyTorch counterpart of the JAX package's ``ops/scan_match.py``: the
SLAM front-end's dense multi-resolution correlative matcher against a
persistent Q10 log-odds grid, one fleet tick at a time.  Every function
here works on a leading stream axis N, so one fleet tick of N streams is
one call — and, on the ``"pallas"`` matcher lowering, one launch of each
of the three matcher kernels for all N streams (ops/scan_match_kernels.py:
B6 coarse scores, B7 fine scores, B8 log-odds update).

EXACTNESS.  The datapath is the JAX package's int32 fixed point, bit for
bit:

  * endpoints quantize to int32 subcell coordinates (SUB=32 subcells per
    cell) with ONE float32 multiply and round-half-even;
  * rotations read a numpy-built int32 cos/sin table at 2^14 scale, shared
    verbatim with the JAX package and uploaded once per device — no device
    ever evaluates a transcendental here;
  * the bilinear map lookup is four integer gathers with 5-bit weights;
  * the log-odds grid is int32 Q10 with integer hit/miss increments and a
    clamp;
  * argmaxes are first-max-wins in C order (``torch.argmax`` returns the
    first maximal index), in shared code outside the kernels.

int32 addition is associative and commutative even at wrap-around, so any
evaluation order (a kernel's block reduction, an atomic add) lands on the
same bits.  Arithmetic bounds (why nothing overflows) are the JAX
package's: subcells clamped to ±(2^15 - 1) before rotation, and
``quant_shift`` chosen so (clamp_q >> quant_shift)·1024·beams < 2^31.

``MapConfig.match_backend`` keeps the JAX package's names: ``"xla"`` is the
plain-PyTorch arm (the kernels' plain versions) and ``"pallas"`` the CUDA
kernels, which on a CPU tensor run those same plain versions.  The state
(:class:`MapState`) is updated in place, like ``FilterState``; nothing in a
tick synchronises the host until the caller fetches the wire rows.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

# fixed-point geometry (see the module docstring for the overflow bounds)
SUB_BITS = 5
SUB = 1 << SUB_BITS            # subcells per map cell
ANG_BITS = 14
ANG = 1 << ANG_BITS            # rotation-table scale
LO_SCALE = 1024                # log-odds Q10 fixed point (1/1024 units)
W_SCALE = SUB * SUB            # bilinear weight denominator (Σw)
PQ_LIMIT = (1 << 15) - 1       # subcell clamp ahead of the int32 rotation

MAP_STATE_VERSION = 1          # checkpoint schema version of MapState

STATE_KEYS = ("log_odds", "pose", "origin_xy", "revision")
# numpy dtype of each MapState field in a snapshot
STATE_DTYPES = {"log_odds": np.int32, "pose": np.int32, "origin_xy": np.float32,
                "revision": np.int32}


@dataclasses.dataclass
class MapState:
    """Per-stream SLAM state of N streams, on one device, updated in place.
    ``log_odds`` is Q10 fixed point (int32, 1/1024 units, [ix, iy] layout);
    ``pose`` is (tx_sub, ty_sub, theta_idx) int32 — translation in
    subcells, heading as an index into the ``theta_divisions``-entry
    rotation table."""

    log_odds: torch.Tensor   # (N, G, G) int32
    pose: torch.Tensor       # (N, 3) int32
    origin_xy: torch.Tensor  # (N, 2) float32 world coords of the grid centre
    revision: torch.Tensor   # (N,) int32, revolutions absorbed

    @staticmethod
    def shapes(grid: int) -> dict[str, tuple[int, ...]]:
        """One stream's array shapes (host-side, no allocation)."""
        return {"log_odds": (grid, grid), "pose": (3,), "origin_xy": (2,), "revision": ()}

    @classmethod
    def create(cls, cfg: "MapConfig", streams: int = 1, device="cpu") -> "MapState":
        g = cfg.grid
        return cls(
            log_odds=torch.zeros((streams, g, g), dtype=torch.int32, device=device),
            pose=torch.zeros((streams, 3), dtype=torch.int32, device=device),
            origin_xy=torch.zeros((streams, 2), dtype=torch.float32, device=device),
            revision=torch.zeros((streams,), dtype=torch.int32, device=device),
        )

    @classmethod
    def from_numpy(cls, arrays: dict, device) -> "MapState":
        """A state from a snapshot dict of stream-stacked numpy arrays
        (either package's ``FleetMapper.snapshot()`` layout)."""
        return cls(**{
            k: torch.from_numpy(np.array(arrays[k], dtype=STATE_DTYPES[k])).to(device)
            for k in STATE_KEYS
        })

    def to_numpy(self) -> dict[str, np.ndarray]:
        """Host copies of every field (fresh arrays, never views)."""
        return {k: getattr(self, k).cpu().numpy().copy() for k in STATE_KEYS}


@dataclasses.dataclass(frozen=True)
class MapConfig:
    """Static mapping + matcher configuration (the JAX package's, field for
    field)."""

    grid: int = 256            # cells per side of the log-odds grid
    cell_m: float = 0.05       # metres per cell
    beams: int = 2048          # points per scan (the chain's beam grid)
    hit_q: int = 922           # Q10 log-odds increment per endpoint hit
    miss_q: int = -410         # Q10 decrement per free-space pass
    clamp_q: int = 8192        # Q10 clamp (±) on the log-odds grid
    theta_divisions: int = 720 # rotation-table entries over a full turn
    theta_window: int = 6      # match search: ± table steps
    coarse: int = 4            # pyramid pool factor (power of two)
    window_cells: int = 2      # coarse translation radius (coarse cells)
    fine_radius: int = 4       # fine translation radius (cells)
    free_samples: int = 4      # ray samples for the free-space miss pass
    # Q10 per-revolution log-odds decay toward zero; 0 disables
    decay_q: int = 0
    quant_shift: int = 4       # match-map right shift (int32 score bound)
    voxel_backend: str = "scatter"  # endpoint histogram: scatter | matmul
    # score volume + log-odds update: "xla" (plain PyTorch) or "pallas"
    # (the CUDA kernels B6/B7/B8; their plain versions on a CPU tensor)
    match_backend: str = "xla"

    def __post_init__(self):
        if self.grid < 8 or self.grid > 1024:
            raise ValueError("map grid must be within [8, 1024]")
        if self.coarse < 1 or self.coarse & (self.coarse - 1):
            raise ValueError("coarse pool factor must be a power of two")
        if self.grid % self.coarse:
            raise ValueError("map grid must divide by the coarse factor")
        if self.cell_m <= 0:
            raise ValueError("map cell size must be positive")
        if self.hit_q <= 0 or self.miss_q >= 0 or self.clamp_q <= 0:
            raise ValueError(
                "log-odds increments must satisfy hit > 0 > miss, clamp > 0"
            )
        if self.clamp_q < self.hit_q:
            raise ValueError("log-odds clamp must be >= the hit increment")
        if self.decay_q < 0 or self.decay_q > self.clamp_q:
            raise ValueError(
                "log-odds decay must satisfy 0 <= decay_q <= clamp_q "
                "(0 disables; anything past the clamp is meaningless)"
            )
        if self.theta_window >= self.theta_divisions // 2:
            raise ValueError("theta window exceeds half a turn")
        if self.match_backend not in ("xla", "pallas"):
            raise ValueError(
                "match_backend must be 'xla' or 'pallas' once resolved "
                "(the 'auto' spelling resolves in mapping/mapper."
                "resolve_match_backend before MapConfig is built)"
            )
        if (self.clamp_q >> self.quant_shift) * W_SCALE * self.beams >= 2**31:
            raise ValueError(
                "match score can overflow int32: raise quant_shift "
                f"(clamp_q={self.clamp_q}, beams={self.beams})"
            )

    @property
    def sub_per_m(self) -> float:
        """The one metres -> subcells constant, exact in float32."""
        return float(np.float32(SUB / self.cell_m))

    @property
    def t_limit_sub(self) -> int:
        """Pose translation clamp: the sensor stays inside the map."""
        return (self.grid // 2) * SUB


def min_quant_shift(clamp_q: int, beams: int) -> int:
    """Smallest match-map shift keeping the int32 score bound."""
    s = 0
    while (clamp_q >> s) * W_SCALE * beams >= 2**31:
        s += 1
    return s


@functools.lru_cache(maxsize=8)
def rotation_table(divisions: int) -> np.ndarray:
    """(divisions, 2) int32 [cos, sin] at ANG scale — built in float64 on
    the host, exactly as the JAX package builds it, so both packages (and
    every device) read the same integers."""
    k = np.arange(divisions, dtype=np.float64) * (2.0 * np.pi / divisions)
    return np.stack(
        [np.rint(np.cos(k) * ANG), np.rint(np.sin(k) * ANG)], axis=1
    ).astype(np.int32)


def theta_offsets(cfg: MapConfig) -> np.ndarray:
    """(T,) int32 search offsets in rotation-table steps."""
    w = cfg.theta_window
    return np.arange(-w, w + 1, dtype=np.int32)


_DEVICE_TABLES: dict = {}


def _device_tables(cfg: MapConfig, device: torch.device):
    """The rotation table and θ offsets on ``device``, uploaded once."""
    key = (cfg.theta_divisions, cfg.theta_window, device)
    got = _DEVICE_TABLES.get(key)
    if got is None:
        got = (
            torch.from_numpy(rotation_table(cfg.theta_divisions)).to(device),
            torch.from_numpy(theta_offsets(cfg)).to(device),
        )
        _DEVICE_TABLES[key] = got
    return got


# ---------------------------------------------------------------------------
# fixed-point building blocks (each has a literal numpy twin in
# ops/scan_match_ref.py; the parity tests pin them bit-exact)
# ---------------------------------------------------------------------------


def quantize_points(xy: torch.Tensor, mask: torch.Tensor, cfg: MapConfig):
    """(..., B, 2) float32 metres -> int32 subcell coords + validity: one
    float32 multiply, then round-half-even.  Range and finiteness are
    policed in float space before the cast (a cast of an out-of-range or
    NaN float is implementation-defined): points beyond ±PQ_LIMIT subcells
    are invalidated, NaN fails the compare, non-finite values are zeroed
    and everything is clamped before ``torch.round``."""
    s = xy * cfg.sub_per_m          # float32 × a float32-exact scalar
    lim = float(PQ_LIMIT)
    ok = mask & (s[..., 0].abs() <= lim) & (s[..., 1].abs() <= lim)
    s = torch.where(torch.isfinite(s), s, 0.0)
    pq = torch.round(s.clamp(-lim, lim)).to(torch.int32)
    return pq, ok


def rotate_rows(x, y, cos_q, sin_q):
    """Fixed-point rotation of split x/y planes: (c·x - s·y) at ANG scale,
    rounded back to subcells with an arithmetic shift (int32 throughout)."""
    half = 1 << (ANG_BITS - 1)
    xr = (cos_q * x - sin_q * y + half) >> ANG_BITS
    yr = (sin_q * x + cos_q * y + half) >> ANG_BITS
    return xr, yr


def rotate_points(pq: torch.Tensor, cos_q, sin_q):
    """`rotate_rows` on packed (..., 2) points."""
    return rotate_rows(pq[..., 0], pq[..., 1], cos_q, sin_q)


def _bilinear_gather(mf: torch.Tensor, gdim: int, ix, iy, fx, fy) -> torch.Tensor:
    """Integer bilinear lookup on N flattened [ix, iy] maps ``mf`` (N,
    gdim²): 4 gathers with 5-bit fractional weights (Σw = 1024); a corner
    off the map contributes 0 (clipped index, masked value).  ``ix/iy/
    fx/fy`` broadcast to one shape with the stream axis first."""
    shape = torch.broadcast_shapes(ix.shape, iy.shape, fx.shape, fy.shape)
    n = mf.shape[0]
    total = None
    for dx_c, dy_c in ((0, 0), (1, 0), (0, 1), (1, 1)):
        cx, cy = ix + dx_c, iy + dy_c
        ok = (cx >= 0) & (cx < gdim) & (cy >= 0) & (cy < gdim)
        idx = cx.clamp(0, gdim - 1) * gdim + cy.clamp(0, gdim - 1)
        idx = torch.broadcast_to(idx, shape).reshape(n, -1).long()
        val = torch.where(ok, torch.gather(mf, 1, idx).reshape(shape), 0)
        wx = SUB - fx if dx_c == 0 else fx
        wy = SUB - fy if dy_c == 0 else fy
        term = wx * wy * val
        total = term if total is None else total + term
    return total


def cell_hits(cells_x, cells_y, inb, grid: int) -> torch.Tensor:
    """(N, G, G) int32 endpoint counts from (N, B) integer cell indices:
    one ``index_add_`` keyed by ``stream·(G²+1) + cell``, out-of-map
    points sent to each stream's extra slot and dropped."""
    n = cells_x.shape[0]
    gg = grid * grid
    flat = torch.where(inb, cells_x * grid + cells_y, gg).long()
    flat = flat + torch.arange(n, device=flat.device)[:, None] * (gg + 1)
    counts = torch.zeros(n * (gg + 1), dtype=torch.int32, device=flat.device)
    counts.index_add_(0, flat.reshape(-1), torch.ones_like(flat, dtype=torch.int32).reshape(-1))
    return counts.view(n, gg + 1)[:, :gg].reshape(n, grid, grid)


def cell_hits_matmul(cells_x, cells_y, inb, grid: int) -> torch.Tensor:
    """The one-hot product twin of :func:`cell_hits`: (B, G) 0/1 planes
    multiplied in float32 (exact below 2^24 hits per cell, with or
    without TF32, since 0 and 1 are exact in both)."""
    cells = torch.arange(grid, dtype=torch.int32, device=cells_x.device)
    ohx = ((cells_x[..., None] == cells) & inb[..., None]).to(torch.float32)
    ohy = (cells_y[..., None] == cells).to(torch.float32)
    return torch.bmm(ohx.transpose(1, 2), ohy).to(torch.int32)


def select_cell_hits(backend: str):
    """voxel_backend -> integer-cell histogram (strict: a typo fails)."""
    try:
        return {"scatter": cell_hits, "matmul": cell_hits_matmul}[backend]
    except KeyError:
        raise ValueError(
            f"voxel_backend must be 'scatter' or 'matmul' once resolved, "
            f"got {backend!r}"
        ) from None


# ---------------------------------------------------------------------------
# matcher + map update, batched over the stream axis
# ---------------------------------------------------------------------------


def _theta_trig(pose: torch.Tensor, cfg: MapConfig):
    """(N, T) int32 cos/sin rows of the θ candidates around each stream's
    heading — device gathers from the uploaded table, no host sync."""
    table, dth = _device_tables(cfg, pose.device)
    th_idx = torch.remainder(pose[:, 2:3] + dth, cfg.theta_divisions).long()
    return table[:, 0][th_idx], table[:, 1][th_idx]


def _kernels():
    from rplidar_ros2_driver_tpu_torch.ops import scan_match_kernels

    return scan_match_kernels


def match_coarse_scores(log_odds, pose, pq, ok, cfg: MapConfig, cos_q=None, sin_q=None):
    """Coarse translation-only sweep at the predicted heading (B6): the
    match map ``mq`` and the (N, U, V) int32 coarse score plane."""
    if cos_q is None:
        cos_q, sin_q = _theta_trig(pose, cfg)
    t_mid = cfg.theta_window                                    # the dθ=0 column
    posec = pose[:, :2] + (cfg.grid // 2) * SUB
    trig = torch.stack([cos_q[:, t_mid], sin_q[:, t_mid]], dim=1)
    smk = _kernels()
    fn = smk.coarse_scores_kernel if cfg.match_backend == "pallas" else smk.coarse_scores_plain
    return fn(log_odds, pq, ok, posec, trig, cfg)


def match_fine_scores(mq, pose, pq, ok, u_best, v_best, cfg: MapConfig, cos_q=None, sin_q=None):
    """Joint (dθ, dx, dy) refinement around the coarse winner (B7): the
    (N, T, F, F) int32 score volume in C order."""
    if cos_q is None:
        cos_q, sin_q = _theta_trig(pose, cfg)
    posec = pose[:, :2] + (cfg.grid // 2) * SUB
    uv = torch.stack([u_best, v_best], dim=1)
    smk = _kernels()
    fn = smk.fine_scores_kernel if cfg.match_backend == "pallas" else smk.fine_scores_plain
    return fn(mq, pq, ok, posec, cos_q, sin_q, uv, cfg)


def match_scan_volumes(log_odds, pose, pq, ok, cfg: MapConfig):
    """The matcher's score-volume core for N streams: coarse sweep, first-
    max-wins seed, joint refinement, raw-delta decode.  Returns
    ``(dpose_raw (N, 3), best (N,), minv (N,))`` — the ungated argmax delta
    [dx_sub, dy_sub, dθ_steps], the best fine score and the volume's
    minimum, all int32 device tensors."""
    n = log_odds.shape[0]
    c, w, r = cfg.coarse, cfg.window_cells, cfg.fine_radius
    _table, dth = _device_tables(cfg, pose.device)
    cos_q, sin_q = _theta_trig(pose, cfg)

    mq, score_c = match_coarse_scores(log_odds, pose, pq, ok, cfg, cos_q, sin_q)
    nu = 2 * w + 1
    kbest = torch.argmax(score_c.reshape(n, -1), dim=1).to(torch.int32)
    u_best = kbest // nu - w                                    # coarse cells
    v_best = kbest % nu - w

    score_f = match_fine_scores(mq, pose, pq, ok, u_best, v_best, cfg, cos_q, sin_q)
    nf = 2 * r + 1
    flat = score_f.reshape(n, -1)
    fbest = torch.argmax(flat, dim=1).to(torch.int32)
    t_best = fbest // (nf * nf)
    du = (fbest // nf) % nf - r
    dv = fbest % nf - r
    dpose_raw = torch.stack([(u_best * c + du) * SUB, (v_best * c + dv) * SUB, dth[t_best]], dim=1)
    return dpose_raw, flat.amax(dim=1), flat.amin(dim=1)


def match_scan(log_odds, pose, pq, ok, cfg: MapConfig):
    """Correlative match of N quantized scans against N maps with the
    front-end accept epilogue.  Returns (dpose (N, 3), score (N,),
    n_valid (N,)), int32; a best score ≤ 0 yields the identity delta."""
    dpose_raw, best, _minv = match_scan_volumes(log_odds, pose, pq, ok, cfg)
    accept = best > 0
    dpose = torch.where(accept[:, None], dpose_raw, 0)
    n_valid = ok.sum(dim=1, dtype=torch.int32)
    return dpose, torch.where(accept, best, 0), n_valid


def update_map(log_odds, pose, pq, ok, cfg: MapConfig) -> torch.Tensor:
    """Log-odds occupancy update of N maps from N scans at ``pose`` (B8):
    endpoint cells get ``hit_q``, ray-sampled free cells ``miss_q``
    (unless hit this revolution), clamped to ±clamp_q.  ``decay_q`` first
    shrinks every cell toward zero, before either arm.  Returns a new
    (N, G, G) int32 tensor."""
    if cfg.decay_q:
        mag = (log_odds.abs() - cfg.decay_q).clamp_min(0)
        log_odds = torch.sign(log_odds) * mag
    table, _dth = _device_tables(cfg, pose.device)
    trig = table[pose[:, 2].long()]                             # (N, 2) [cos, sin]
    posec = pose[:, :2] + (cfg.grid // 2) * SUB
    smk = _kernels()
    fn = smk.log_odds_update_kernel if cfg.match_backend == "pallas" else smk.log_odds_update_plain
    return fn(log_odds, pq, ok, posec, trig, cfg)


def fleet_map_match_step(
    state: MapState, points_xy: torch.Tensor, masks: torch.Tensor, live: torch.Tensor,
    cfg: MapConfig,
):
    """One fleet tick of N streams: match each scan against its map built
    so far, compose the accepted delta into the pose, absorb the scan at
    the new pose.  ``live`` (N,) int32 0/1 gates each stream: an idle
    stream's state passes through untouched and its wire reports score 0
    and no matched points.  ``state`` is updated in place; returns it and
    the (N, 5) int32 wire [tx_sub, ty_sub, th_idx, score, n_valid]."""
    pq, ok = quantize_points(points_xy, masks, cfg)
    alive = live > 0
    ok = ok & alive[:, None]
    dpose, score, n_valid = match_scan(state.log_odds, state.pose, pq, ok, cfg)
    lim = cfg.t_limit_sub
    pose = torch.stack([
        (state.pose[:, 0] + dpose[:, 0]).clamp(-lim, lim),
        (state.pose[:, 1] + dpose[:, 1]).clamp(-lim, lim),
        torch.remainder(state.pose[:, 2] + dpose[:, 2], cfg.theta_divisions),
    ], dim=1)
    log_odds = update_map(state.log_odds, pose, pq, ok, cfg)
    state.log_odds.copy_(torch.where(alive[:, None, None], log_odds, state.log_odds))
    state.pose.copy_(torch.where(alive[:, None], pose, state.pose))
    state.revision.add_(live.to(torch.int32))
    wire = torch.cat([state.pose, score[:, None], n_valid[:, None]], dim=1)
    return state, wire


def map_match_step(
    state: MapState, points_xy: torch.Tensor, mask: torch.Tensor, live, cfg: MapConfig
):
    """Single-stream step: ``state`` holds one stream, ``points_xy`` is
    (B, 2) and ``mask`` (B,); returns the state and the (5,) wire row."""
    live_t = torch.as_tensor(live, dtype=torch.int32, device=points_xy.device).reshape(1)
    state, wire = fleet_map_match_step(state, points_xy[None], mask[None], live_t, cfg)
    return state, wire[0]


def unpack_wire(wire) -> dict:
    """Host-side view of one stream's (5,) int32 wire row."""
    w = np.asarray(wire)
    return {"pose_q": w[:3].astype(np.int32), "score": int(w[3]), "n_valid": int(w[4])}


def pose_to_metric(pose_q, cfg: MapConfig) -> tuple:
    """(x_m, y_m, theta_rad) floats from the integer pose — reporting only."""
    x = float(pose_q[0]) * (cfg.cell_m / SUB)
    y = float(pose_q[1]) * (cfg.cell_m / SUB)
    th = float(pose_q[2]) * (2.0 * np.pi / cfg.theta_divisions)
    if th > np.pi:
        th -= 2.0 * np.pi
    return x, y, th

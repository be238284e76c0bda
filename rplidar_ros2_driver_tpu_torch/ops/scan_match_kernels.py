"""Wrappers of the correlative-matcher CUDA kernels (csrc/scan_match.cu).

Three kernels replace the JAX package's Pallas TPU kernels of
``ops/pallas_scan_match.py`` (``match_backend="pallas"``); each launches
once per fleet tick for all N streams:

  * B6 :func:`coarse_scores_kernel` — ``coarse_scores_pallas``: the
    quantized match map ``mq = clip(log_odds, 0, clamp_q) >> quant_shift``
    (emitted for B7) and the (U, V) coarse translation scores of the scan
    rotated to the predicted heading, bilinear-gathered on the
    ``coarse``-max-pooled map.
  * B7 :func:`fine_scores_kernel` — ``fine_scores_pallas``: the
    (T, F, F) joint (dθ, dx, dy) scores around the coarse winner on ``mq``.
  * B8 :func:`log_odds_update_kernel` — ``log_odds_update_pallas``: the
    endpoint-hit and sampled free-space passes, Q10 increments and clamp.

Each wrapper checks dtype, shape, contiguity and device.  A tensor on the
CPU runs the kernel's plain PyTorch version (:func:`coarse_scores_plain`,
:func:`fine_scores_plain`, :func:`log_odds_update_plain` — also the
``match_backend="xla"`` arm); a CUDA tensor launches the kernel (built
from the source at first use, utils/cuda_build.py) or raises — there is
no fallback.  ``launch_counts`` counts the launches of each kernel and
``card_launches`` each kernel's on each card; only a launch adds to them.
Each launches through the slim launch path (utils/launch.py).  The design
of each kernel is in the source's header note; all three launch in thread
block clusters on the shapes :func:`coarse_plan`, :func:`fine_plan` and
:func:`update_plan` choose (pure functions of the shape and the card's SM
count).
"""

from __future__ import annotations

import functools
import math

import torch

from rplidar_ros2_driver_tpu_torch.ops.scan_match import (
    SUB,
    SUB_BITS,
    MapConfig,
    _bilinear_gather,
    rotate_rows,
    select_cell_hits,
)
from rplidar_ros2_driver_tpu_torch.utils.launch import (
    I,
    VP,
    KernelEntry,
    count_launch,
    current_stream,
)

# kernel name -> launches since the last reset_launch_counts()
launch_counts = {"coarse_scores": 0, "fine_scores": 0, "log_odds_update": 0}
# (kernel name, card index) -> launches since the last reset_launch_counts()
card_launches: dict = {}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0
    card_launches.clear()


# the C entries: pointers, sizes and the plan, the card's index, the stream
_B6 = KernelEntry("scan_match", "coarse_scores_i32", [VP] * 7 + [I] * 14 + [VP])
_B7 = KernelEntry("scan_match", "fine_scores_i32", [VP] * 8 + [I] * 11 + [VP])
_B8 = KernelEntry("scan_match", "log_odds_update_i32", [VP] * 6 + [I] * 13 + [VP])


def _check(name: str, t: torch.Tensor, dtype, shape: tuple, device: torch.device) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")


def _check_scan(log_odds, pq, ok, posec, cfg: MapConfig):
    """Shared checks of the map and scan arguments; returns (N, B, device)."""
    if log_odds.ndim != 3 or pq.ndim != 3:
        raise ValueError(
            f"expected (N, G, G) map and (N, B, 2) points, got "
            f"{tuple(log_odds.shape)} and {tuple(pq.shape)}"
        )
    n, b, dev = log_odds.shape[0], pq.shape[1], log_odds.device
    g = cfg.grid
    _check("log_odds", log_odds, torch.int32, (n, g, g), dev)
    _check("pq", pq, torch.int32, (n, b, 2), dev)
    _check("ok", ok, torch.bool, (n, b), dev)
    _check("posec", posec, torch.int32, (n, 2), dev)
    return n, b, dev


def _launch_device(dev: torch.device, what: str) -> None:
    if dev.type != "cuda":
        raise RuntimeError(f"no {what} kernel for device {dev}")


# ---------------------------------------------------------------------------
# B6/B7 launch plans
# ---------------------------------------------------------------------------

# dynamic shared memory one block may opt into on sm_90 (227 KiB)
SMEM_LIMIT = 232_448
# the fine_radius (B7) and window_cells (B6) values whose candidate sums a
# thread holds in registers: csrc/scan_match.cu instantiates these, the
# values of the repo's configurations (map_config_from_params fixes the
# fine radius at 4; param/rplidar.yaml and config 12 give a window of 2);
# any other value takes the shared-memory accumulator path
FINE_RADII = (4,)
COARSE_WINDOWS = (2,)
MAX_CLUSTER = 8       # the portable cluster size
MAX_THREADS = 256     # the kernels' launch bound
INT16_MAX = 0x7FFF
# threads an SM keeps resident of B7: the kernel's launch bound (256
# threads, two blocks a SM) caps a thread at 128 registers
FINE_THREADS_PER_SM = 512


def _slot(rows: int, f: int) -> int:
    """Ints of one thread's sums in shared memory: rows·F, made odd so a
    warp's slots fall in distinct banks."""
    return (rows * f) | 1


def _accumulators(f: int, registers: bool, pooled: int, threads=(128, 64, 32)):
    """(threads, rows, shared bytes) of a block scoring F×F candidates
    beside ``pooled`` bytes of staged map, or None when nothing fits.  The
    layout is the kernel's: [pooled][part F²][red threads·slot][hrow
    F·threads, shared-memory path only]; on the register path a thread
    holds all F candidate rows, on the shared-memory path as many as fit
    (the kernel walks the rows in chunks)."""
    for nt in threads:
        for rows in ((f,) if registers else range(f, 0, -1)):
            smem = pooled + 4 * (f * f + nt * _slot(rows, f) + (0 if registers else nt * f))
            if smem <= SMEM_LIMIT:
                return nt, rows, smem
    return None


@functools.lru_cache(maxsize=64)
def fine_plan(n: int, t: int, r: int, sms: int):
    """B7's launch: ``(cluster, threads, rows, shared bytes)`` for N streams,
    T θ candidates and fine radius r on a card of ``sms`` SMs — one
    cluster per (θ, stream), its blocks splitting the beams.  256 threads a
    block on the register path, and the largest power-of-two cluster (up
    to MAX_CLUSTER) whose blocks take at most 80% of the card's resident
    threads, so that whole clusters fit each GPC in one wave."""
    f = 2 * r + 1
    registers = r in FINE_RADII
    acc = _accumulators(f, registers, 0, (256, 128, 64, 32) if registers else (128, 64, 32))
    if acc is None:
        raise ValueError(f"fine_radius {r}: the fine-scores kernel's sums do not fit a block")
    threads, rows, smem = acc
    room = int(0.8 * sms * FINE_THREADS_PER_SM) // (max(n * t, 1) * threads)
    cluster = 1
    while 2 * cluster <= min(room, MAX_CLUSTER):
        cluster *= 2
    return cluster, threads, rows, smem


@functools.lru_cache(maxsize=64)
def coarse_plan(n: int, g: int, c: int, w: int, clamp_q: int, quant_shift: int, sms: int):
    """B6's launch: ``(elem, cluster, threads, rows, shared bytes)`` — one
    cluster per stream, of up to MAX_CLUSTER blocks (about two per SM).
    ``elem`` is 2 when the pooled map is staged in shared memory as int16:
    ``clamp_q >> quant_shift``, the largest value of mq, fits int16 and the
    map fits beside the sums; else 0, the direct route (each corner pooled
    from the log-odds)."""
    u, gc = 2 * w + 1, g // c
    registers = w in COARSE_WINDOWS
    elem, acc = 0, None
    if (clamp_q >> quant_shift) <= INT16_MAX:
        elem, acc = 2, _accumulators(u, registers, -(-gc * gc * 2 // 16) * 16)
    if acc is None:
        elem, acc = 0, _accumulators(u, registers, 0)
    if acc is None:
        raise ValueError(f"window_cells {w}: the coarse-scores kernel's sums do not fit a block")
    return (elem, max(1, min(MAX_CLUSTER, 2 * sms // max(n, 1))), *acc)


# B8: threads a block (csrc/scan_match.cu kUpdateThreads, its launch bound)
# and the largest cluster the kernel is prepared for (kUpdateMaxCluster;
# past 8 a cluster size is not portable, and launch_clusters allows it)
UPDATE_THREADS = 512
UPDATE_MAX_CLUSTER = 16


def update_bytes(local: bool, rows: int, g: int) -> int:
    """Shared bytes of one B8 block, two bits a cell in 32-bit words: the
    local route's bitmap of the whole map (padded to 16 bytes) and its
    stripe's gathered words (one more, for a stripe that starts inside a
    word); the remote route's stripe of rows·G cells."""
    words = -(-g * g // 16)
    bitmap = -(-words // 4) * 4 if local else 0
    stripe = -(-rows * g // 16) + (1 if local else 0)
    return -(-(bitmap + stripe) // 4) * 16


@functools.lru_cache(maxsize=64)
def update_plan(n: int, g: int, sms: int):
    """B8's launch: ``(local, cluster, threads, rows, shared bytes)`` — one
    cluster of K blocks per stream, block k owning the rows [k·rows,
    (k+1)·rows) of the map (those past G are empty).  K is the largest
    power of two up to UPDATE_MAX_CLUSTER and G whose N clusters take at most
    one block a SM.  ``local`` is 1 when a block's shared memory holds a
    bitmap of the whole map (G up to 935 at K = 16), where each block marks
    its own beams; else 0, the remote route, each block's flags holding its
    stripe only (K raised, if need be, until they fit)."""
    k = 1
    while 2 * k <= min(UPDATE_MAX_CLUSTER, g) and 2 * k * n <= sms:
        k *= 2
    local = update_bytes(True, -(-g // k), g) <= SMEM_LIMIT
    while (not local and update_bytes(False, -(-g // k), g) > SMEM_LIMIT
           and k < UPDATE_MAX_CLUSTER):
        k *= 2
    rows = -(-g // k)
    smem = update_bytes(local, rows, g)
    if smem > SMEM_LIMIT:
        raise ValueError(f"grid {g}: the log-odds update's flags do not fit a cluster")
    return int(local), k, UPDATE_THREADS, rows, smem


@functools.lru_cache(maxsize=8)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# ---------------------------------------------------------------------------
# B6: coarse translation sweep
# ---------------------------------------------------------------------------


def coarse_scores_plain(log_odds, pq, ok, posec, trig, cfg: MapConfig):
    """Plain version of B6 for N streams: ``(mq (N, G, G), score_c (N, U,
    V))``.  ``posec`` is pose[:2] + the grid centre in subcells, ``trig``
    (N, 2) the [cos, sin] table row of the predicted heading."""
    n, g, c = log_odds.shape[0], cfg.grid, cfg.coarse
    gc, clog, w = g // c, int(math.log2(c)), cfg.window_cells
    mq = log_odds.clamp(0, cfg.clamp_q) >> cfg.quant_shift
    mc = mq.reshape(n, gc, c, gc, c).amax(dim=(2, 4))
    rx, ry = rotate_rows(pq[..., 0], pq[..., 1], trig[:, 0:1], trig[:, 1:2])
    # coarse-scale subcell coords: SUB subcells per COARSE cell, so only
    # the cell index shifts per candidate and the fraction is shared
    scx, scy = (rx + posec[:, 0:1]) >> clog, (ry + posec[:, 1:2]) >> clog
    ccx, ccy = scx >> SUB_BITS, scy >> SUB_BITS
    cfx, cfy = scx & (SUB - 1), scy & (SUB - 1)
    shifts = torch.arange(-w, w + 1, dtype=torch.int32, device=log_odds.device)
    ix = ccx[:, :, None, None] + shifts[:, None]                # (N, B, U, 1)
    iy = ccy[:, :, None, None] + shifts[None, :]                # (N, B, 1, V)
    vals = _bilinear_gather(
        mc.reshape(n, -1), gc, ix, iy, cfx[:, :, None, None], cfy[:, :, None, None]
    )                                                           # (N, B, U, V)
    score = torch.where(ok[:, :, None, None], vals, 0).sum(dim=1, dtype=torch.int32)
    return mq, score


def coarse_scores_kernel(log_odds, pq, ok, posec, trig, cfg: MapConfig):
    """B6: (N, G, G) int32 log-odds, (N, B, 2) int32 subcell points,
    (N, B) bool validity, (N, 2) int32 ``posec``, (N, 2) int32 [cos, sin]
    -> ``(mq (N, G, G), score_c (N, U, V))`` int32."""
    n, b, dev = _check_scan(log_odds, pq, ok, posec, cfg)
    _check("trig", trig, torch.int32, (n, 2), dev)
    if dev.type == "cpu":
        return coarse_scores_plain(log_odds, pq, ok, posec, trig, cfg)
    _launch_device(dev, "coarse-scores")
    u = 2 * cfg.window_cells + 1
    mq = torch.empty_like(log_odds)
    score = torch.empty((n, u, u), dtype=torch.int32, device=dev)
    if n == 0:
        return mq, score
    plan = coarse_plan(n, cfg.grid, cfg.coarse, cfg.window_cells, cfg.clamp_q,
                       cfg.quant_shift, _sm_count(dev.index))
    _B6(
        log_odds.data_ptr(), pq.data_ptr(), ok.data_ptr(), posec.data_ptr(),
        trig.data_ptr(), mq.data_ptr(), score.data_ptr(),
        n, cfg.grid, b, cfg.coarse, int(math.log2(cfg.coarse)), cfg.clamp_q,
        cfg.quant_shift, cfg.window_cells, *plan, dev.index, current_stream(dev.index),
    )
    count_launch(launch_counts, card_launches, "coarse_scores", dev.index)
    return mq, score


# ---------------------------------------------------------------------------
# B7: joint (dθ, dx, dy) refinement
# ---------------------------------------------------------------------------


def fine_scores_plain(mq, pq, ok, posec, cos_q, sin_q, uv, cfg: MapConfig):
    """Plain version of B7 for N streams: the (N, T, F, F) int32 volume in
    C order (θ, du, dv).  ``cos_q``/``sin_q`` are the (N, T) table rows of
    the θ candidates, ``uv`` the (N, 2) coarse winner in coarse cells."""
    n, g, r = mq.shape[0], cfg.grid, cfg.fine_radius
    csub = cfg.coarse * SUB
    rx, ry = rotate_rows(pq[:, None, :, 0], pq[:, None, :, 1], cos_q[..., None], sin_q[..., None])
    fbx = rx + (posec[:, 0] + uv[:, 0] * csub)[:, None, None]  # (N, T, B)
    fby = ry + (posec[:, 1] + uv[:, 1] * csub)[:, None, None]
    fcx, fcy = fbx >> SUB_BITS, fby >> SUB_BITS
    ffx, ffy = fbx & (SUB - 1), fby & (SUB - 1)
    fsh = torch.arange(-r, r + 1, dtype=torch.int32, device=mq.device)
    fix = fcx[..., None, None] + fsh[:, None]                   # (N, T, B, F, 1)
    fiy = fcy[..., None, None] + fsh[None, :]                   # (N, T, B, 1, F)
    fvals = _bilinear_gather(
        mq.reshape(n, -1), g, fix, fiy, ffx[..., None, None], ffy[..., None, None]
    )                                                           # (N, T, B, F, F)
    return torch.where(ok[:, None, :, None, None], fvals, 0).sum(dim=2, dtype=torch.int32)


def fine_scores_kernel(mq, pq, ok, posec, cos_q, sin_q, uv, cfg: MapConfig):
    """B7: (N, G, G) int32 ``mq`` (B6's output), the scan as for B6, (N, T)
    int32 cos/sin of the θ candidates, (N, 2) int32 coarse winner ->
    (N, T, F, F) int32."""
    n, b, dev = _check_scan(mq, pq, ok, posec, cfg)
    t = 2 * cfg.theta_window + 1
    f = 2 * cfg.fine_radius + 1
    _check("cos_q", cos_q, torch.int32, (n, t), dev)
    _check("sin_q", sin_q, torch.int32, (n, t), dev)
    _check("uv", uv, torch.int32, (n, 2), dev)
    if dev.type == "cpu":
        return fine_scores_plain(mq, pq, ok, posec, cos_q, sin_q, uv, cfg)
    _launch_device(dev, "fine-scores")
    out = torch.empty((n, t, f, f), dtype=torch.int32, device=dev)
    if n == 0:
        return out
    plan = fine_plan(n, t, cfg.fine_radius, _sm_count(dev.index))
    _B7(
        mq.data_ptr(), pq.data_ptr(), ok.data_ptr(), posec.data_ptr(),
        cos_q.data_ptr(), sin_q.data_ptr(), uv.data_ptr(), out.data_ptr(),
        n, cfg.grid, b, t, cfg.coarse * SUB, cfg.fine_radius, *plan, dev.index,
        current_stream(dev.index),
    )
    count_launch(launch_counts, card_launches, "fine_scores", dev.index)
    return out


# ---------------------------------------------------------------------------
# B8: log-odds update
# ---------------------------------------------------------------------------


def log_odds_update_plain(log_odds, pq, ok, posec, trig, cfg: MapConfig):
    """Plain version of B8 for N streams (``cfg.voxel_backend``'s
    histogram): endpoint hits and the ``free_samples`` ray samples
    ``o + (w - o)·k // S`` (floor division), ``+hit_q`` on hit cells,
    ``+miss_q`` on free cells not hit, clamp ±``clamp_q``."""
    g = cfg.grid
    rx, ry = rotate_rows(pq[..., 0], pq[..., 1], trig[:, 0:1], trig[:, 1:2])
    ox, oy = posec[:, 0:1], posec[:, 1:2]                       # the sensor
    wx, wy = rx + ox, ry + oy                                   # (N, B)
    hits_fn = select_cell_hits(cfg.voxel_backend)

    def hist(sx, sy):
        cx, cy = sx >> SUB_BITS, sy >> SUB_BITS
        inb = ok & (cx >= 0) & (cx < g) & (cy >= 0) & (cy < g)
        return hits_fn(cx, cy, inb, g)

    hit = hist(wx, wy) > 0
    delta = hit.to(torch.int32) * cfg.hit_q
    if cfg.free_samples > 0:
        s = cfg.free_samples
        free = None
        for k in range(s):
            counts = hist(
                ox + torch.div((wx - ox) * k, s, rounding_mode="floor"),
                oy + torch.div((wy - oy) * k, s, rounding_mode="floor"),
            )
            free = counts if free is None else free + counts
        delta = delta + ((free > 0) & ~hit).to(torch.int32) * cfg.miss_q
    return (log_odds + delta).clamp(-cfg.clamp_q, cfg.clamp_q)


def log_odds_update_kernel(log_odds, pq, ok, posec, trig, cfg: MapConfig):
    """B8: (N, G, G) int32 log-odds, the scan as for B6, (N, 2) int32
    ``posec`` and [cos, sin] of the composed pose -> the updated (N, G, G)
    int32 map (a new tensor)."""
    n, b, dev = _check_scan(log_odds, pq, ok, posec, cfg)
    _check("trig", trig, torch.int32, (n, 2), dev)
    if dev.type == "cpu":
        return log_odds_update_plain(log_odds, pq, ok, posec, trig, cfg)
    _launch_device(dev, "log-odds-update")
    out = torch.empty_like(log_odds)
    if n == 0:
        return out
    _B8(
        log_odds.data_ptr(), pq.data_ptr(), ok.data_ptr(), posec.data_ptr(),
        trig.data_ptr(), out.data_ptr(),
        n, cfg.grid, b, cfg.hit_q, cfg.miss_q, cfg.clamp_q, cfg.free_samples,
        *update_plan(n, cfg.grid, _sm_count(dev.index)), dev.index, current_stream(dev.index),
    )
    count_launch(launch_counts, card_launches, "log_odds_update", dev.index)
    return out

"""NumPy golden reference for the SLAM front-end (ops/scan_match.py).

The mapper's ``map_backend="host"`` path and the parity tests' third
oracle: a copy of the JAX package's ``ops/scan_match_ref.py``, a literal
numpy transcription of the matcher and the map update, one stream at a
time.  The datapath is integer end to end, so it is bit-exact against the
port's batched plain arm and its CUDA kernels.
"""

from __future__ import annotations

import math

import numpy as np

from rplidar_ros2_driver_tpu_torch.ops.scan_match import (
    ANG_BITS,
    PQ_LIMIT,
    SUB,
    SUB_BITS,
    MapConfig,
    rotation_table,
    theta_offsets,
)


def create_map_state_np(cfg: MapConfig) -> dict:
    """Fresh host-side MapState as the snapshot dict layout."""
    return {
        "log_odds": np.zeros((cfg.grid, cfg.grid), np.int32),
        "pose": np.zeros((3,), np.int32),
        "origin_xy": np.zeros((2,), np.float32),
        "revision": np.int32(0),
    }


def quantize_points_np(xy, mask, cfg: MapConfig):
    s = np.asarray(xy, np.float32) * np.float32(cfg.sub_per_m)
    lim = np.float32(PQ_LIMIT)
    with np.errstate(invalid="ignore"):
        ok = (
            np.asarray(mask, bool)
            & (np.abs(s[:, 0]) <= lim)
            & (np.abs(s[:, 1]) <= lim)
        )
        s = np.where(np.isfinite(s), s, np.float32(0.0))
        # graftlint: policed — NaN/inf zeroed and clamped into ±PQ_LIMIT
        # in float space above (literal twin of ops/scan_match.py)
        pq = np.rint(np.clip(s, -lim, lim)).astype(np.int32)
    return pq, ok


def rotate_points_np(pq, cos_q, sin_q):
    x, y = pq[..., 0], pq[..., 1]
    half = 1 << (ANG_BITS - 1)
    xr = (cos_q * x - sin_q * y + half) >> ANG_BITS
    yr = (sin_q * x + cos_q * y + half) >> ANG_BITS
    return xr, yr


def _bilinear_gather_np(mf, gdim, ix, iy, fx, fy):
    total = np.zeros(np.broadcast(ix, fx).shape, np.int32)
    for dx_c, dy_c in ((0, 0), (1, 0), (0, 1), (1, 1)):
        cx, cy = ix + dx_c, iy + dy_c
        ok = (cx >= 0) & (cx < gdim) & (cy >= 0) & (cy < gdim)
        idx = np.clip(cx, 0, gdim - 1) * gdim + np.clip(cy, 0, gdim - 1)
        val = np.where(ok, mf[idx], 0).astype(np.int32)
        wx = SUB - fx if dx_c == 0 else fx
        wy = SUB - fy if dy_c == 0 else fy
        total = total + wx * wy * val
    return total


def cell_hits_np(cells_x, cells_y, inb, grid: int) -> np.ndarray:
    counts = np.zeros((grid * grid,), np.int32)
    flat = np.where(inb, cells_x * grid + cells_y, 0)
    np.add.at(counts, flat[inb], 1)
    return counts.reshape(grid, grid)


def match_scan_volumes_np(log_odds, pose, pq, ok, cfg: MapConfig):
    """The shared score-volume core: the UNGATED argmax delta, the best
    fine score and the fine volume's minimum."""
    g, c = cfg.grid, cfg.coarse
    gc = g // c
    clog = int(math.log2(c))
    center = (g // 2) * SUB

    mq = (np.clip(log_odds, 0, cfg.clamp_q) >> cfg.quant_shift).astype(
        np.int32
    )
    mc = mq.reshape(gc, c, gc, c).max(axis=(1, 3))
    mq_f, mc_f = mq.reshape(-1), mc.reshape(-1)

    table = rotation_table(cfg.theta_divisions)
    dth = theta_offsets(cfg)
    th_idx = np.mod(pose[2] + dth, cfg.theta_divisions)
    cos_q = table[:, 0][th_idx][:, None]
    sin_q = table[:, 1][th_idx][:, None]
    rx, ry = rotate_points_np(pq[None, :, :], cos_q, sin_q)
    bx = rx + pose[0] + center
    by = ry + pose[1] + center
    t_mid = cfg.theta_window  # the dθ=0 row

    # coarse: translation-only at the predicted heading
    scx, scy = bx[t_mid] >> clog, by[t_mid] >> clog
    ccx, ccy = scx >> SUB_BITS, scy >> SUB_BITS
    cfx, cfy = scx & (SUB - 1), scy & (SUB - 1)
    w = cfg.window_cells
    shifts = np.arange(-w, w + 1, dtype=np.int32)
    ix = ccx[:, None, None] + shifts[None, :, None]
    iy = ccy[:, None, None] + shifts[None, None, :]
    vals = _bilinear_gather_np(
        mc_f, gc, ix, iy, cfx[:, None, None], cfy[:, None, None]
    )
    score_c = np.sum(
        np.where(ok[:, None, None], vals, 0), axis=0, dtype=np.int32
    )

    nu = 2 * w + 1
    kbest = int(np.argmax(score_c.reshape(-1)))
    u_best = kbest // nu - w
    v_best = kbest % nu - w

    # fine: joint (θ, dx, dy) at full resolution around the winner
    fbx = bx + u_best * (c * SUB)
    fby = by + v_best * (c * SUB)
    fcx, fcy = fbx >> SUB_BITS, fby >> SUB_BITS
    ffx, ffy = fbx & (SUB - 1), fby & (SUB - 1)
    r = cfg.fine_radius
    fsh = np.arange(-r, r + 1, dtype=np.int32)
    fix = fcx[:, :, None, None] + fsh[None, None, :, None]
    fiy = fcy[:, :, None, None] + fsh[None, None, None, :]
    fvals = _bilinear_gather_np(
        mq_f, g, fix, fiy,
        ffx[:, :, None, None], ffy[:, :, None, None],
    )
    score_f = np.sum(
        np.where(ok[None, :, None, None], fvals, 0), axis=1, dtype=np.int32
    )

    nf = 2 * r + 1
    fbest = int(np.argmax(score_f.reshape(-1)))
    t_best = fbest // (nf * nf)
    du = (fbest // nf) % nf - r
    dv = fbest % nf - r
    best = int(np.max(score_f))
    minv = int(np.min(score_f))

    dpose_raw = np.asarray([
        (u_best * c + du) * SUB,
        (v_best * c + dv) * SUB,
        int(dth[t_best]),
    ], np.int32)
    return dpose_raw, np.int32(best), np.int32(minv)


def match_scan_np(log_odds, pose, pq, ok, cfg: MapConfig):
    dpose_raw, best, _minv = match_scan_volumes_np(log_odds, pose, pq, ok, cfg)
    if int(best) > 0:
        dpose, score = dpose_raw, int(best)
    else:
        dpose, score = np.zeros((3,), np.int32), 0
    return dpose, np.int32(score), np.int32(np.sum(ok))


def update_map_np(log_odds, pose, pq, ok, cfg: MapConfig):
    g = cfg.grid
    center = (g // 2) * SUB
    if cfg.decay_q:
        # shrink toward zero BEFORE the hit/miss pass
        mag = np.maximum(np.abs(log_odds) - cfg.decay_q, 0)
        log_odds = (np.sign(log_odds) * mag).astype(np.int32)
    table = rotation_table(cfg.theta_divisions)
    cos_q, sin_q = table[pose[2], 0], table[pose[2], 1]
    wx, wy = rotate_points_np(pq, cos_q, sin_q)
    wx, wy = wx + pose[0] + center, wy + pose[1] + center

    cx, cy = wx >> SUB_BITS, wy >> SUB_BITS
    inb = ok & (cx >= 0) & (cx < g) & (cy >= 0) & (cy < g)
    hits = cell_hits_np(cx, cy, inb, g)

    if cfg.free_samples > 0:
        ox, oy = pose[0] + center, pose[1] + center
        free = np.zeros((g, g), np.int32)
        for k in range(cfg.free_samples):
            sx = ox + ((wx - ox) * k) // cfg.free_samples
            sy = oy + ((wy - oy) * k) // cfg.free_samples
            fx_c, fy_c = sx >> SUB_BITS, sy >> SUB_BITS
            finb = ok & (fx_c >= 0) & (fx_c < g) & (fy_c >= 0) & (fy_c < g)
            free = free + cell_hits_np(fx_c, fy_c, finb, g)
        i_miss = (free > 0) & ~(hits > 0)
    else:
        i_miss = np.zeros((g, g), bool)

    delta = (
        np.where(hits > 0, cfg.hit_q, 0) + np.where(i_miss, cfg.miss_q, 0)
    ).astype(np.int32)
    return np.clip(log_odds + delta, -cfg.clamp_q, cfg.clamp_q).astype(
        np.int32
    )


def map_match_step_np(
    state: dict, points_xy, mask, live: int, cfg: MapConfig
):
    """One host-reference revolution.  ``state`` is the snapshot-dict
    layout; returns (new state dict, (5,) int32 wire row)."""
    pq, ok = quantize_points_np(points_xy, mask, cfg)
    ok = ok & (int(live) > 0)
    dpose, score, n_valid = match_scan_np(
        state["log_odds"], state["pose"], pq, ok, cfg
    )
    lim = cfg.t_limit_sub
    pose = np.asarray([
        np.clip(state["pose"][0] + dpose[0], -lim, lim),
        np.clip(state["pose"][1] + dpose[1], -lim, lim),
        np.mod(state["pose"][2] + dpose[2], cfg.theta_divisions),
    ], np.int32)
    if int(live) > 0:
        log_odds = update_map_np(state["log_odds"], pose, pq, ok, cfg)
    else:
        log_odds, pose = state["log_odds"], state["pose"]
    new_state = {
        "log_odds": log_odds,
        "pose": pose,
        "origin_xy": state["origin_xy"],
        "revision": np.int32(state["revision"] + int(live)),
    }
    wire = np.concatenate([
        pose, np.asarray([score, n_valid], np.int32)
    ]).astype(np.int32)
    return new_state, wire

"""NumPy golden reference for the loop-closure back-end
(ops/loop_close.py).

The loop engine's ``loop_backend=host`` path and the parity tests' oracle:
a copy of the JAX package's ``ops/loop_close_ref.py`` with its imports
pointed at this package — a literal numpy transcription of one stream's
closure check (candidate match through ops/scan_match_ref.
match_scan_volumes_np, the integer gates, the constraint append, the
pose-graph relaxation through ops/pose_graph_ref.solve_pose_graph_np),
step for step.  The datapath is int32 end to end, so it is bit-exact
against the port's batched check and the JAX package's
(tests/test_torch_loop_close.py).
"""

from __future__ import annotations

import numpy as np

from rplidar_ros2_driver_tpu_torch.ops.loop_close import (
    ODOM_WEIGHT,
    WIRE_LEN,
    LoopConfig,
    LoopState,
)
from rplidar_ros2_driver_tpu_torch.ops.pose_graph_ref import (
    pose_compose_np,
    pose_relative_np,
    rel_inverse_np,
    solve_pose_graph_np,
)
from rplidar_ros2_driver_tpu_torch.ops.scan_match import rotation_table
from rplidar_ros2_driver_tpu_torch.ops.scan_match_ref import (
    match_scan_volumes_np,
    quantize_points_np,
)

INT32_MIN1 = -(2**31) + 1


def create_loop_state_np(cfg: LoopConfig) -> dict:
    """Fresh host-side LoopState as the snapshot dict layout."""
    return {
        k: np.zeros(v, np.int32) for k, v in LoopState.shapes(cfg).items()
    }


def install_submap_np(state: dict, plane, anchor, cfg: LoopConfig) -> dict:
    """Literal twin of ops/loop_close._install_submap_impl."""
    k = cfg.max_submaps
    div = cfg.match.theta_divisions
    table = rotation_table(div)
    count = int(state["count"])
    if count >= k:                      # cap-and-hold: library frozen
        return state
    slot = count
    if count == 0:
        odom_leg = np.zeros((3,), np.int32)
    else:
        prev = state["anchors"][count - 1]
        odom_leg = pose_relative_np(prev, np.asarray(anchor), table, div)
    out = {key: np.asarray(v).copy() for key, v in state.items()}
    out["planes"][slot] = np.asarray(plane, np.int32)
    out["anchors"][slot] = np.asarray(anchor, np.int32)
    out["odom"][slot] = odom_leg
    out["valid"][slot] = 1
    out["count"] = np.int32(count + 1)
    return out


def loop_close_step_np(
    state: dict, points_xy, mask, pose, cand_idx, check: int,
    cfg: LoopConfig,
):
    """One host-reference closure check — the literal twin of
    ops/loop_close._loop_close_step_impl.  Returns (new state dict,
    (WIRE_LEN,) int32 wire row, (K, 3) corrected anchors)."""
    m = cfg.match
    k = cfg.max_submaps
    div = m.theta_divisions
    lim = m.t_limit_sub
    table = rotation_table(div)
    pose = np.asarray(pose, np.int32)
    cand_idx = np.asarray(cand_idx, np.int32)

    pq, ok = quantize_points_np(points_xy, mask, m)
    ok = ok & (int(check) > 0)
    n_valid = int(np.sum(ok))

    slots = np.clip(cand_idx, 0, k - 1)
    cvalid = (cand_idx >= 0) & (state["valid"][slots] > 0)
    bests = np.full(len(cand_idx), INT32_MIN1, dtype=np.int32)
    dposes = np.zeros((len(cand_idx), 3), dtype=np.int32)
    minvs = np.zeros((len(cand_idx),), dtype=np.int32)
    for c in range(len(cand_idx)):
        dp, b, mv = match_scan_volumes_np(
            state["planes"][slots[c]], pose, pq, ok, m
        )
        dposes[c], minvs[c] = dp, mv
        bests[c] = b if cvalid[c] else INT32_MIN1
    kc = int(np.argmax(bests))                                  # first-max-wins
    best = int(bests[kc])
    dpose = dposes[kc]
    minv = int(minvs[kc])
    best_slot = int(slots[kc])
    has_cand = bool(np.any(cvalid))

    accept = (
        int(check) > 0
        and has_cand
        and n_valid >= cfg.min_points
        and best > 0
        and best >= n_valid * cfg.accept_q
        and (best - minv) >= (best >> cfg.peak_shift)
    )

    p_m = np.asarray([
        np.clip(pose[0] + dpose[0], -lim, lim),
        np.clip(pose[1] + dpose[1], -lim, lim),
        np.mod(pose[2] + dpose[2], div),
    ], np.int32)
    count = int(state["count"])
    last = int(np.clip(count - 1, 0, k - 1))
    a_last = state["anchors"][last]
    a_best = state["anchors"][best_slot]
    o_cur = pose_relative_np(a_last, pose, table, div)
    z_jc = pose_relative_np(a_best, p_m, table, div)
    z_ij = pose_compose_np(
        o_cur, rel_inverse_np(z_jc, table, div), table, div
    )
    room = int(state["ncons"]) < cfg.max_constraints
    do_append = accept and room
    cons = state["cons"].copy()
    if do_append:
        cons[int(state["ncons"])] = np.concatenate([
            np.asarray([last, best_slot], np.int32), z_ij,
            np.asarray([cfg.weight], np.int32),
        ])
    ncons = np.int32(int(state["ncons"]) + int(do_append))
    dropped = np.int32(int(state["dropped"]) + int(accept and not room))

    ks = np.arange(k, dtype=np.int32)
    odom_w = ((ks >= 1) & (ks < count)).astype(np.int32) * ODOM_WEIGHT
    odom_rows = np.stack([
        np.maximum(ks - 1, 0), ks,
        state["odom"][:, 0], state["odom"][:, 1], state["odom"][:, 2],
        odom_w,
    ], axis=1).astype(np.int32)
    all_cons = np.concatenate([odom_rows, cons], axis=0)
    corrected = solve_pose_graph_np(state["anchors"], all_cons, cfg.graph)

    cur_c = pose_compose_np(corrected[last], o_cur, table, div)
    cur_c = np.asarray([
        np.clip(cur_c[0], -lim, lim),
        np.clip(cur_c[1], -lim, lim),
        cur_c[2],
    ], np.int32)
    if count == 0:
        cur_c = pose.copy()

    anchors = state["anchors"]
    if cfg.reanchor and accept:
        anchors = corrected.copy()

    new_state = {
        "planes": state["planes"], "anchors": anchors,
        "odom": state["odom"], "valid": state["valid"],
        "count": state["count"], "cons": cons,
        "ncons": ncons, "dropped": dropped,
    }
    wire = np.concatenate([
        np.asarray([
            int(accept),
            best_slot if has_cand else -1,
            max(best, 0) if has_cand else 0,
            n_valid,
        ], np.int32),
        cur_c,
        np.asarray([int(ncons), int(dropped)], np.int32),
    ]).astype(np.int32)
    assert wire.shape == (WIRE_LEN,)
    return new_state, wire, corrected

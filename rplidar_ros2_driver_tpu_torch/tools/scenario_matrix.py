"""The scenario regression matrix over the port (the bench's config 23).

Procedural foundry worlds (scenarios/foundry.py) swept over scene × chaos ×
fleet, each cell scored against the foundry's ground truth: the end-pose
error in map cells and the map's F1 against the visible-truth raster.  This
is the port's copy of ``bench.py``'s ``_scenario_chaos_mask``,
``_scenario_determinism_check``, ``_scenario_deskew_probe``,
``_scenario_loop_probe``, ``_scenario_decay_probe``, ``_scenario_cell`` and
``bench_scenarios``, built on this package, with the same five structural
claims asserted (a violation raises):

  1. DETERMINISM — a scene is a pure function of (seed, rev, beam).
  2. DE-SKEW OBSERVABILITY — the feature-starved corridor ties the motion
     estimate to identity while the rooms and the loop recover a known
     translation within band.
  3. LOOP CLOSURE — the loop scene's return to start closes under
     slam/loop.LoopClosureEngine (fused backend) under both chaos columns.
  4. DECAY — a moved obstacle's stale evidence stays frozen with
     ``map_decay`` off and fades to <= 0 with it on.
  5. ACCURACY FLOORS — feature-rich cells hold error and F1 floors; the
     corridor cell degrades (error >= 25% of the along-axis travel).

Two checks of the port's own are added.  Each cell also runs its streams as
one fused ``FleetMapper`` fleet on ``device`` (kernels B6/B7/B8 on the
card), held equal to the host matcher (``map_match_step_np``, the bench's
arm) pose for pose and map for map; and the de-skew probe also runs the
port's ``ops/deskew`` estimate (B4/B5 on the card) beside
``estimate_motion_np``, held equal.  Each scene is built once and feeds
both arms.

``smoke`` is the bench's seconds-scale CPU geometry (64² at 0.1 m, 256
beams, 16 revolutions); the full geometry is 128² at 0.05 m, 384 beams,
fleets (2, 4), 24 revolutions (128 for the loop scene, 64 for the loop
probes).  Run it with ``python -m
rplidar_ros2_driver_tpu_torch.tools.scenario_matrix [--smoke] [--cpu]``.
"""

from __future__ import annotations

import argparse
import json
import math
import time

import numpy as np
import torch

SCENES = ("rooms", "corridor", "loop")
CHAOS = ("clean", "faulty")
SEED = 20260807  # the matrix is a pure function of this


def _backend_name(device: torch.device) -> str:
    return "cpu" if device.type == "cpu" else "cuda"


def chaos_mask(chaos: str, rev: int, beams: int, salt: int):
    """Deterministic per-revolution fault schedule for the ``faulty`` chaos
    column: every 7th revolution stalls outright (live=0), every 3rd loses
    a contiguous 30% beam sector whose start walks with (rev, salt) — a
    seeded script, so every cell is exactly reproducible."""
    if chaos != "faulty":
        return np.ones(beams, bool), 1
    if rev % 7 == 5:
        return np.zeros(beams, bool), 0
    mask = np.ones(beams, bool)
    if rev % 3 == 1:
        width = (beams * 3) // 10
        start = (rev * 7919 + salt * 104729) % beams
        mask[(start + np.arange(width)) % beams] = False
    return mask, 1


def determinism_check(base_seed: int) -> None:
    """Claim 1: rebuilt scenes streamed under different chunkings emit
    byte-equal ranges."""
    from rplidar_ros2_driver_tpu_torch.scenarios.foundry import (
        SCENE_KINDS,
        SceneSpec,
        build_scene,
    )

    th = 360.0 * np.arange(200) / 200
    revs = np.repeat(np.arange(2, dtype=np.int64), 100)
    for kind in SCENE_KINDS:
        spec = SceneSpec(kind=kind, seed=base_seed + 3, n_revs=8, dropout_rate=0.1)
        whole = build_scene(spec).dist_mm(th, revs)
        b = build_scene(spec)
        parts = np.concatenate([b.dist_mm(th[:63], revs[:63]), b.dist_mm(th[63:], revs[63:])])
        if whole.tobytes() != parts.tobytes():
            raise RuntimeError(
                f"foundry determinism broke for {kind!r}: rebuilt scene streamed "
                "under a different chunking emitted different bytes"
            )


def deskew_probe(base_seed: int, device="cpu") -> dict:
    """Claim 2, on two profile captures a known +x translation apart: the
    host estimator (``estimate_motion_np``) and the port's
    ``ops/deskew`` estimate on ``device`` (B4 builds the profiles, B5
    scores the shifts on the card), held equal."""
    from rplidar_ros2_driver_tpu_torch.ops import deskew as dsk
    from rplidar_ros2_driver_tpu_torch.ops.deskew_ref import (
        estimate_motion_np,
        profile_from_nodes_np,
    )
    from rplidar_ros2_driver_tpu_torch.scenarios.foundry import SceneSpec, build_scene

    dev = torch.device(device)
    cfg = dsk.DeskewConfig(recon_beams=256, backend=dsk.resolve_deskew_backend("auto", dev.type))
    beams = 512
    th = 360.0 * np.arange(beams) / beams
    ang = np.round(th / 360.0 * 65536.0).astype(np.int64).astype(np.int32)
    t_m = 0.05
    truth_q2 = int(round(t_m * 4000.0))  # metres -> quarter-mm
    out = {}
    for kind in SCENES:
        scene = build_scene(SceneSpec(kind=kind, seed=base_seed, n_revs=16))
        x0 = float(scene.traj.x_m[0])
        y0 = float(scene.traj.y_m[0])

        def dq2(x):
            return np.round(scene.probe_dist_mm(x, y0, th) * 4.0).astype(np.int32)

        d0, d1 = dq2(x0), dq2(x0 + t_m)
        est = estimate_motion_np(profile_from_nodes_np(ang, d0, d0 > 0, cfg),
                                 profile_from_nodes_np(ang, d1, d1 > 0, cfg), cfg)
        # the port's arm: both captures as one (2, n) batch of rows
        a = torch.from_numpy(np.stack([ang, ang])).to(dev)
        d = torch.from_numpy(np.stack([d0, d1])).to(dev)
        prof = dsk.profile_from_nodes(a, d, d > 0, cfg)
        port = dsk.estimate_motion(prof[0], prof[1], cfg).cpu().numpy()
        if not np.array_equal(port, est):
            raise RuntimeError(
                f"de-skew probe on {kind!r}: the port's estimate {port.tolist()} on "
                f"{dev} != estimate_motion_np {est.tolist()}"
            )
        out[kind] = {
            "est_dx_q2": int(est[0]), "est_dy_q2": int(est[1]),
            "est_dth_u16": int(est[2]), "truth_dx_q2": truth_q2,
        }
    corr = out["corridor"]
    if abs(corr["est_dx_q2"]) > 40 or abs(corr["est_dy_q2"]) > 40:
        raise RuntimeError(
            "corridor de-skew tie-to-identity broke: estimated "
            f"({corr['est_dx_q2']}, {corr['est_dy_q2']}) q2 for an along-axis "
            "translation that must be unobservable"
        )
    for kind in ("rooms", "loop"):
        dx = out[kind]["est_dx_q2"]
        if not (0.4 * truth_q2 <= dx <= 2.5 * truth_q2):
            raise RuntimeError(
                f"de-skew recovery failed on {kind!r}: estimated {dx} q2 for a "
                f"{truth_q2} q2 translation (band [0.4x, 2.5x])"
            )
    return out


def loop_probe(chaos: str, streams: int, n_revs: int, grid: int, cell: float, beams: int,
               base_seed: int, device="cpu") -> dict:
    """Claim 3: foundry ``loop`` scans rasterized at drift-injected poses
    through the scripted front-end (tools/loop_drift.DriftingFrontEnd) and
    the fused LoopClosureEngine on ``device``, the loop building nothing
    and mapping no new device memory.  The corrected end pose lands within bar while the
    baseline carries the injected drift, and at least one closure is
    accepted.  Sector faults apply under ``faulty``; stalls don't (the
    front-end is odometry-clocked).  ``corrected_poses`` (the per-stream
    corrected end poses) lets two devices' runs be held equal."""
    from rplidar_ros2_driver_tpu_torch.core.config import DriverParams
    from rplidar_ros2_driver_tpu_torch.ops.scan_match import SUB
    from rplidar_ros2_driver_tpu_torch.scenarios import metrics as smet
    from rplidar_ros2_driver_tpu_torch.scenarios.foundry import SceneSpec, build_scene
    from rplidar_ros2_driver_tpu_torch.slam.loop import LoopClosureEngine
    from rplidar_ros2_driver_tpu_torch.tools.loop_drift import DriftingFrontEnd
    from rplidar_ros2_driver_tpu_torch.utils import guards

    dev = torch.device(device)
    p = DriverParams(
        filter_chain=("clip", "median", "voxel"), filter_backend=_backend_name(dev),
        map_enable=True, map_backend="host",
        map_grid=grid, map_cell_m=cell,
        loop_enable=True, loop_backend="fused",
        loop_submap_revs=4, loop_check_revs=2,
        loop_max_submaps=16, loop_candidates=2, loop_weight=8,
        pose_graph_max_constraints=32, pose_graph_iters=256,
    )
    # total injected drift ~8 cells: past the 4-cell degeneracy bar, inside
    # the candidate-match search reach
    drift_sub = max((8 * SUB) // n_revs, 1)
    fe = DriftingFrontEnd(p, streams, beams, 4)
    eng = LoopClosureEngine(p, fe)
    eng.precompile()
    thetas = 360.0 * np.arange(beams) / beams
    scenes, truths = [], []
    for s in range(streams):
        spec = SceneSpec(kind="loop", seed=base_seed + 17 * s, n_revs=n_revs,
                         dropout_rate=0.08 if chaos == "faulty" else 0.0)
        sc = build_scene(spec)
        rel = sc.traj.relative_poses()
        truths.append(np.stack([smet.pose_to_lattice(rel[k, 0], rel[k, 1], rel[k, 2], fe.cfg)
                                for k in range(n_revs)]))
        scenes.append(sc)
    # the bench's guards.steady_state less its guard (c): the port's loop
    # engine reads device scalars on the host inside a check (its pose
    # helpers index tables by them), so only (a) nothing built and (b) no
    # new device memory are held
    tag = f"scenario loop probe {chaos}"
    with guards.assert_no_recompile(tag=tag), guards.no_new_device_memory(tag):
        for k in range(n_revs):
            pts = np.zeros((streams, beams, 2), np.float32)
            masks = np.ones((streams, beams), bool)
            drifted = np.zeros((streams, 3), np.int32)
            for s, sc in enumerate(scenes):
                d = sc.dist_mm(thetas, np.full(beams, k, np.int64))
                xy, m = smet.scan_points_xy(thetas, d)
                cmask, _live = chaos_mask(chaos, k, beams, s)
                pts[s], masks[s] = xy, m & cmask
                drifted[s] = truths[s][k]
                drifted[s, 0] += drift_sub * (k + 1)
            eng.observe(fe.submit(pts, masks, drifted))
    base_err = corr_err = 0.0
    corrected = []
    for s in range(streams):
        end, te = fe.pose[s], truths[s][n_revs - 1]
        base_err = max(base_err, (abs(int(end[0]) - int(te[0]))
                                  + abs(int(end[1]) - int(te[1]))) / SUB)
        cor = eng.corrected_pose_q(s, end)
        corrected.append([int(v) for v in cor])
        corr_err = max(corr_err, (abs(int(cor[0]) - int(te[0]))
                                  + abs(int(cor[1]) - int(te[1]))) / SUB)
    accepted = int(eng.closures_accepted.sum())
    bar = 2.0 if chaos == "clean" else 2.5
    if corr_err > bar:
        raise RuntimeError(
            f"loop scene failed to close under {chaos} chaos: corrected end-pose "
            f"error {corr_err:.2f} cells > {bar}"
        )
    if base_err < 4.0:
        raise RuntimeError(
            f"loop drift scenario degenerate: baseline end error {base_err:.2f} cells < 4"
        )
    if accepted < 1:
        raise RuntimeError("loop scene produced zero accepted closures")
    return {
        "chaos": chaos,
        "baseline_end_err_cells": round(base_err, 3),
        "corrected_end_err_cells": round(corr_err, 3),
        "closures_accepted": accepted,
        "drift_sub_per_rev": drift_sub,
        "revs": n_revs, "streams": streams,
        "corrected_poses": corrected,
        "checks": int(eng.checks), "dispatches": int(eng.dispatch_count),
    }


def decay_probe(grid: int, cell: float, beams: int, base_seed: int) -> dict:
    """Claim 4: the ``decay`` scene maps a box up close, walks out of its
    sensor-range bubble, then the box vanishes.  With ``map_decay`` off the
    stale evidence persists byte-frozen; with it on it fades to <= 0.  Both
    arms run the host mapper at ground-truth poses (mapping semantics
    isolated from matcher error)."""
    from rplidar_ros2_driver_tpu_torch.core.config import DriverParams
    from rplidar_ros2_driver_tpu_torch.mapping.mapper import map_config_from_params
    from rplidar_ros2_driver_tpu_torch.ops.scan_match_ref import quantize_points_np, update_map_np
    from rplidar_ros2_driver_tpu_torch.scenarios import metrics as smet
    from rplidar_ros2_driver_tpu_torch.scenarios.foundry import SceneSpec, build_scene

    # max_range 2.0 m: the stale site leaves sensor range before the box moves
    scene = build_scene(SceneSpec(kind="decay", seed=base_seed, n_revs=32, max_range_m=2.0))
    n = scene.traj.n_revs
    thetas = 360.0 * np.arange(beams) / beams
    rel = scene.traj.relative_poses()
    box = scene.moving[0]
    sx, sy = float(scene.traj.x_m[0]), float(scene.traj.y_m[0])
    gx0 = grid // 2 + int(math.floor((box.x0 - box.half - sx) / cell))
    gx1 = grid // 2 + int(math.ceil((box.x0 + box.half - sx) / cell))
    gy0 = grid // 2 + int(math.floor((box.y0 - box.half - sy) / cell))
    gy1 = grid // 2 + int(math.ceil((box.y0 + box.half - sy) / cell))
    region = (slice(gx0, gx1 + 1), slice(gy0, gy1 + 1))

    def run(map_decay):
        p = DriverParams(map_enable=True, map_backend="host", map_grid=grid, map_cell_m=cell,
                         map_decay=map_decay)
        cfg = map_config_from_params(p, beams)
        lo = np.zeros((grid, grid), np.int32)
        at_vanish = 0
        for k in range(n):
            d = scene.dist_mm(thetas, np.full(beams, k, np.int64))
            xy, m = smet.scan_points_xy(thetas, d)
            pq, ok = quantize_points_np(xy, m, cfg)
            pose = smet.pose_to_lattice(rel[k, 0], rel[k, 1], rel[k, 2], cfg)
            lo = update_map_np(lo, pose, pq, ok, cfg)
            if k == box.move_rev:
                at_vanish = int(lo[region].max())
        return int(lo[region].max()), at_vanish, cfg.decay_q

    end_off, at_off, _ = run(0.0)
    end_on, _at_on, decay_q = run(1.0)
    if end_off <= 0:
        raise RuntimeError("decay scenario degenerate: the moved obstacle left no "
                           "positive evidence with decay off")
    if end_off != at_off:
        raise RuntimeError("decay scenario degenerate: the stale region changed after "
                           "the obstacle moved — rays reached it")
    if end_on > 0:
        raise RuntimeError(f"map_decay failed to fade the moved obstacle: stale region "
                           f"max {end_on} Q10 > 0 with decay_q={decay_q}")
    return {"stale_region_max_q_off": end_off, "stale_region_max_q_on": end_on,
            "decay_q_on": decay_q, "revs": n}


def cell_scans(kind: str, chaos: str, fleet: int, base_seed: int, n_revs: int,
               cfg) -> list[dict]:
    """One cell's scenes, built once: per stream the seed, the truth poses
    on the lattice and every revolution's (points, mask, live)."""
    from rplidar_ros2_driver_tpu_torch.scenarios import metrics as smet
    from rplidar_ros2_driver_tpu_torch.scenarios.foundry import SceneSpec, build_scene

    beams = cfg.beams
    thetas = 360.0 * np.arange(beams) / beams
    out = []
    for s in range(fleet):
        spec = SceneSpec(kind=kind, seed=base_seed + 17 * s, n_revs=n_revs,
                         dropout_rate=0.08 if chaos == "faulty" else 0.0)
        scene = build_scene(spec)
        rel = scene.traj.relative_poses()
        truth_q = np.stack([smet.pose_to_lattice(rel[k, 0], rel[k, 1], rel[k, 2], cfg)
                            for k in range(n_revs)])
        scans = []
        for k in range(n_revs):
            d = scene.dist_mm(thetas, np.full(beams, k, np.int64))
            xy, m = smet.scan_points_xy(thetas, d)
            cmask, live = chaos_mask(chaos, k, beams, spec.seed)
            scans.append((xy, m & cmask, live))
        out.append({"scene": scene, "truth_q": truth_q, "scans": scans, "thetas": thetas})
    return out


def host_arm(kind: str, chaos: str, fleet: int, base_seed: int, n_revs: int, grid: int,
             cell: float, beams: int) -> tuple:
    """The bench's cell: ``fleet`` streams of a scene through the HOST
    matcher (``map_match_step_np``), scored against the foundry's truth —
    the worst stream's end-pose error and map F1, and the drain rate (scans
    pre-baked, so the raycaster isn't timed).  Returns (record, the cell's
    streams, the host poses per revolution, the final maps)."""
    from rplidar_ros2_driver_tpu_torch.core.config import DriverParams
    from rplidar_ros2_driver_tpu_torch.mapping.mapper import map_config_from_params
    from rplidar_ros2_driver_tpu_torch.ops import scan_match_ref as smr
    from rplidar_ros2_driver_tpu_torch.scenarios import metrics as smet

    p = DriverParams(map_enable=True, map_backend="host", map_grid=grid, map_cell_m=cell)
    cfg = map_config_from_params(p, beams)
    streams = cell_scans(kind, chaos, fleet, base_seed, n_revs, cfg)
    worst_err, worst_f1, dt_total = 0.0, 1.0, 0.0
    host_poses = np.zeros((n_revs, fleet, 3), np.int32)
    host_maps = []
    for s, st in enumerate(streams):
        state = smr.create_map_state_np(cfg)
        used = []
        t0 = time.perf_counter()
        for k, (xy, m, live) in enumerate(st["scans"]):
            state, _wire = smr.map_match_step_np(state, xy, m, live, cfg)
            host_poses[k, s] = state["pose"]
            if live:
                used.append(k)
        dt_total += time.perf_counter() - t0
        host_maps.append(state["log_odds"])
        # a trailing stalled rev leaves the pose parked one rev back by
        # construction — score against the last LIVE rev's truth
        err = smet.end_pose_error_cells(state["pose"], st["truth_q"][used[-1]])
        occ = smet.visible_truth_occupancy(st["scene"], st["thetas"], used,
                                           st["truth_q"][used], cfg)
        f1 = smet.map_f1(state["log_odds"], occ)
        worst_err, worst_f1 = max(worst_err, err), min(worst_f1, f1)
    rec = {
        "scene": kind, "chaos": chaos, "fleet": fleet, "revs": n_revs,
        "grid": grid, "cell_m": cell,
        "end_pose_err_cells": round(worst_err, 3),
        "map_f1": round(worst_f1, 3),
        "scans_per_sec": round(fleet * n_revs / max(dt_total, 1e-9), 2),
        "clamped": bool(dt_total < 0.05),
        "_dt_s": dt_total,
    }
    return rec, streams, host_poses, host_maps


def matrix_cell(kind: str, chaos: str, fleet: int, base_seed: int, n_revs: int, grid: int,
                cell: float, beams: int, device="cpu") -> dict:
    """One matrix cell: :func:`host_arm`, then the same scans through one
    fused FleetMapper fleet on ``device`` (one B6/B7/B8 step a revolution on
    the card), held equal to the host matcher pose for pose and map for
    map."""
    from rplidar_ros2_driver_tpu_torch.core.config import DriverParams
    from rplidar_ros2_driver_tpu_torch.mapping.mapper import FleetMapper

    rec, streams, host_poses, host_maps = host_arm(kind, chaos, fleet, base_seed, n_revs,
                                                   grid, cell, beams)
    dev = torch.device(device)
    mapper = FleetMapper(DriverParams(map_enable=True, map_backend="fused", map_grid=grid,
                                      map_cell_m=cell, filter_backend=_backend_name(dev)),
                         fleet, beams=beams, device=dev)
    mapper.precompile()
    t0 = time.perf_counter()
    for k in range(n_revs):
        pts = np.stack([st["scans"][k][0] for st in streams]).astype(np.float32)
        masks = np.stack([st["scans"][k][1] for st in streams])
        live = np.asarray([st["scans"][k][2] for st in streams], np.int32)
        ests = mapper.submit_points(pts, masks, live)
        for s, est in enumerate(ests):
            if est is not None and not np.array_equal(est.pose_q, host_poses[k, s]):
                raise RuntimeError(
                    f"fused mapper on {dev} diverged from the host matcher: {kind}/{chaos}/"
                    f"fleet {fleet} rev {k} stream {s}: {est.pose_q.tolist()} != "
                    f"{host_poses[k, s].tolist()}"
                )
    fused_dt = time.perf_counter() - t0
    snap = mapper.snapshot()
    for s in range(fleet):
        if not (np.array_equal(snap["pose"][s], host_poses[-1, s])
                and np.array_equal(snap["log_odds"][s], host_maps[s])):
            raise RuntimeError(f"fused mapper on {dev} ended with another map or pose than "
                               f"the host matcher: {kind}/{chaos}/fleet {fleet} stream {s}")
    rec.update(fused_equal=True, fused_ticks=n_revs,
               fused_dispatches=int(mapper.dispatch_count),
               fused_ticks_per_sec=round(n_revs / max(fused_dt, 1e-9), 2))
    return rec


def geometry(smoke: bool) -> dict:
    """The bench's two geometries of config 23."""
    if smoke:
        g = dict(grid=64, cell=0.1, beams=256, n_revs=16, fleets=(1, 2))
    else:
        g = dict(grid=128, cell=0.05, beams=384, n_revs=24, fleets=(2, 4))
    # 128 revs around the 9.6 m ring (robust tracking across seeds and the
    # faulty schedule); the closure probe keeps 64 revs so its 16 submap
    # epochs fit loop_max_submaps; the loop cells pin the fine lattice in
    # both profiles
    g.update(loop_revs=128, probe_revs=64, loop_grid=128, loop_cell=0.05)
    return g


ERR_BARS = {"rooms": {"clean": 4.0, "faulty": 6.0}, "loop": {"clean": 8.0, "faulty": 8.0}}
F1_BARS = {"rooms": {"clean": 0.3, "faulty": 0.2}, "loop": {"clean": 0.15, "faulty": 0.15}}


def check_floors(cells: list) -> None:
    """Claim 5, and the per-cell evidence flags."""
    for rec in cells:
        kind, chaos = rec["scene"], rec["chaos"]
        err, f1 = rec["end_pose_err_cells"], rec["map_f1"]
        if kind == "corridor":
            traveled = 0.12 * (rec["revs"] - 1) / rec["cell_m"]
            if err < 0.25 * traveled:
                raise RuntimeError(
                    f"corridor degradation claim failed ({chaos}, fleet {rec['fleet']}): "
                    f"err {err:.2f} cells over {traveled:.1f} cells of unobservable "
                    "travel — the matcher is hallucinating along-axis corrections"
                )
        else:
            if err > ERR_BARS[kind][chaos]:
                raise RuntimeError(
                    f"accuracy floor failed: {kind}/{chaos}/fleet {rec['fleet']} end-pose "
                    f"error {err:.2f} cells > {ERR_BARS[kind][chaos]}"
                )
            if f1 < F1_BARS[kind][chaos]:
                raise RuntimeError(
                    f"accuracy floor failed: {kind}/{chaos}/fleet {rec['fleet']} map F1 "
                    f"{f1:.3f} < {F1_BARS[kind][chaos]}"
                )
        rec["deskew_ok"] = True          # claim 2 held for this kind
        rec["loop_ok"] = kind == "loop"  # claim 3 held on loop cells
        rec["match_ok"] = kind != "corridor"  # floors held (claim 5)


def scenario_matrix(smoke: bool = False, device="cpu") -> dict:
    """The whole matrix (12 cells: 3 scenes × 2 chaos columns × 2 fleets)
    with its probes and claims on ``device``; returns the bench's record
    plus the fused arm's counts."""
    g = geometry(smoke)
    grid, cell, beams = g["grid"], g["cell"], g["beams"]
    base_seed = SEED
    determinism_check(base_seed)
    deskew = deskew_probe(base_seed, device)
    loop_probes = {
        chaos: loop_probe(chaos, g["fleets"][-1], g["probe_revs"], g["loop_grid"],
                          g["loop_cell"], beams, base_seed, device)
        for chaos in CHAOS
    }
    decay = decay_probe(grid, cell, beams, base_seed)
    cells = []
    for kind in SCENES:
        for chaos in CHAOS:
            for fleet in g["fleets"]:
                loop_kind = kind == "loop"
                cells.append(matrix_cell(
                    kind, chaos, fleet, base_seed,
                    g["loop_revs"] if loop_kind else g["n_revs"],
                    g["loop_grid"] if loop_kind else grid,
                    g["loop_cell"] if loop_kind else cell,
                    beams, device,
                ))
    check_floors(cells)
    total_scans = sum(r["fleet"] * r["revs"] for r in cells)
    total_dt = sum(r.pop("_dt_s") for r in cells)
    return {
        "scans_per_sec": round(total_scans / max(total_dt, 1e-9), 2),
        "matrix_cells": len(cells),
        "scenes": list(SCENES), "chaos": list(CHAOS), "fleets": list(g["fleets"]),
        "worst_end_pose_err_cells": round(max(r["end_pose_err_cells"] for r in cells
                                              if r["scene"] != "corridor"), 3),
        "worst_map_f1": round(min(r["map_f1"] for r in cells if r["scene"] != "corridor"), 3),
        "scenario_matrix": cells,
        "deskew_probe": deskew,
        "loop_probe": loop_probes,
        "decay_probe": decay,
        "structural": {
            "scene_byte_determinism_holds": True,
            "corridor_ties_deskew_to_identity": True,
            "loop_closes_under_pr11": True,
            "decay_fades_moved_obstacle": True,
            "accuracy_floors_hold": True,
            "fused_arm_equals_host_matcher": True,
        },
        "grid": grid, "cell_m": cell, "loop_grid": g["loop_grid"],
        "loop_cell_m": g["loop_cell"], "beams": beams, "smoke": smoke,
        "device": str(torch.device(device)),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true", help="the CPU smoke geometry")
    ap.add_argument("--cpu", action="store_true", help="run the port's arms on the host")
    args = ap.parse_args(argv)
    print(json.dumps(scenario_matrix(args.smoke, "cpu" if args.cpu else "cuda")))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

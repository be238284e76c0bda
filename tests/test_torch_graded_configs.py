"""The port's runs of bench.py's remaining graded configurations against the
JAX package's same paths, on the CPU.

``rplidar_ros2_driver_tpu_torch/tools/graded.py`` drives configs 1–4, 9,
11, 13 and 16 and config 12's room on a 1024² map through the port's entry
points (``chip_smoke.py``'s graded phase runs it on the card beside the
CPU).  Here each runs at the bench's smoke geometry (a narrow one for
configs 1–4, which have none) and is held to the JAX package driven the way
``bench.py`` drives it, on the same seeded inputs:

  * every output exact, ``points_xy`` within 2 ulp (ROADMAP C.1);
  * every count equal: dispatches, staged transfers, revolutions, mapper
    updates, quarantines and rejoins;
  * the scenes themselves equal to bench.py's builders.
"""

from __future__ import annotations

import math

import numpy as np
import pytest

import bench
from rplidar_ros2_driver_tpu.core.config import DriverParams as JParams
from rplidar_ros2_driver_tpu_torch.tools import graded as gr
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

SMOKE = gr.GEOMETRY["smoke"]
FIELDS = gr.OUTPUT_FIELDS


def ulp_distance(a, b) -> np.ndarray:
    def ordered(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)

    return np.abs(ordered(a) - ordered(b))


def assert_arrays(name: str, got: list, want: list) -> None:
    assert len(got) == len(want), f"{name}: {len(got)} != {len(want)}"
    for k, (a, b) in enumerate(zip(got, want)):
        b = np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, f"{name}[{k}] {a.dtype}{a.shape}"
        if name.endswith("points_xy"):
            assert ulp_distance(a, b).max(initial=0) <= 2, f"{name}[{k}]"
        else:
            np.testing.assert_array_equal(a, b, err_msg=f"{name}[{k}]")


def assert_outputs(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for name in want:
        assert_arrays(name, got[name], want[name])


def fields(out) -> list:
    return [np.asarray(getattr(out, f)).copy() for f in FIELDS]


def by_field(outs: list, prefix: str = "") -> dict:
    return {f"{prefix}{f}": [o[k] for o in outs] for k, f in enumerate(FIELDS)}


def jparams(g: dict, chain=("clip", "median", "voxel"), **over):
    return JParams(filter_backend="cpu", filter_chain=chain, filter_window=g["window"],
                   voxel_grid_size=g["grid"], voxel_cell_m=0.25, **over)


def jservice(params, streams: int, g: dict, run: int):
    from rplidar_ros2_driver_tpu.parallel.service import ShardedFilterService
    from rplidar_ros2_driver_tpu.parallel.sharding import make_mesh

    svc = ShardedFilterService(params, streams, beams=g["beams"], capacity=g["capacity"],
                               mesh=make_mesh(1), fleet_ingest_buckets=(run,))
    svc._ensure_byte_ingest()
    svc.fleet_ingest.precompile([gr.DENSE])
    return svc


# ---------------------------------------------------------------------------
# the scenes
# ---------------------------------------------------------------------------


def test_scenes_are_the_bench_scenes():
    """The port's copies of bench.py's scene builders give its bytes,
    stamps, revolutions and room planes."""
    frames = gr.wire_frames(3, 800)
    assert frames == bench._denseboost_wire_frames(3, 800)
    got = gr.paced_fleet_ticks(frames, 20, 3)
    want = bench._paced_fleet_byte_ticks(frames, 20, 3, gr.DENSE)
    assert got == want
    for a, b in zip(gr.host_scans(4, 920), bench._host_scans(4, 920)):
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])
            assert a[k].dtype == b[k].dtype
    room, _truth, _masks, _live = bench._room_fleet_ticks(2, 64, 3)
    for a, b in zip(gr.room_ticks(2, 64, 3), room):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


# ---------------------------------------------------------------------------
# configs 1-4
# ---------------------------------------------------------------------------


def test_config1_passthrough_matches_jax():
    """Config 1: 360-node batches through ``to_laserscan`` — every field
    of every batch's LaserScan equal to JAX's."""
    from rplidar_ros2_driver_tpu.core.types import ScanBatch
    from rplidar_ros2_driver_tpu.ops.laserscan import to_laserscan

    g = SMOKE[1]
    got = gr.run_config1("cpu", g)
    rng = np.random.default_rng(0)
    points = g["points"]
    want = {f: [] for f in got["outputs"]}
    for _ in range(g["batches"]):
        b = ScanBatch.from_numpy(((np.arange(points) * 65536) // points).astype(np.int32),
                                 (rng.uniform(0.2, 11.0, points) * 4000).astype(np.int32),
                                 np.full(points, 190, np.int32))
        out = to_laserscan(b, 0.1, 12.0, scan_processing=False, inverted=False,
                           is_new_type=False)
        for f in want:
            want[f].append(np.asarray(getattr(out, f)))
    assert_outputs(got["outputs"], want)
    assert got["counts"] == {"scans": g["iters"], "beams": int(want["beam_count"][-1])}


@pytest.mark.parametrize("config,median", [(2, "pallas"), (3, "pallas"), (4, "pallas"),
                                           (4, "inc")])
def test_chain_configs_match_jax(config, median):
    """Configs 2–4: the chain at window 1 with the median and the voxel
    grid off (3,200 and 920 points) and at window 16 with the voxel grid
    off (800 points; both median arms) equal to JAX's chain, revolution
    for revolution."""
    from rplidar_ros2_driver_tpu.filters.chain import ScanFilterChain

    g = SMOKE[config]
    got = gr.run_chain_config(config, "cpu", g, median=median)
    chain = ScanFilterChain(jparams(g, gr.CHAIN_STAGES[config], median_backend="xla"),
                            g["beams"], capacity=g["capacity"])
    want = [fields(chain.process_raw(r["angle_q14"], r["dist_q2"], r["quality"]))
            for r in bench._host_scans(g["revs"], g["points"])]
    assert_outputs(got["outputs"], by_field(want))
    assert got["counts"] == {"revolutions": g["revs"]}


# ---------------------------------------------------------------------------
# config 9: host against fused ingest
# ---------------------------------------------------------------------------


def test_config9_ingest_matches_jax():
    """Config 9: one DenseBoost byte stream through the host ingest and
    FusedIngest — the port's revolutions (equal on both of its arms) equal
    JAX's host arm's, and the port's fused dispatches a frame run equal
    JAX's."""
    from rplidar_ros2_driver_tpu.driver.assembly import ScanAssembler
    from rplidar_ros2_driver_tpu.driver.decode import BatchScanDecoder
    from rplidar_ros2_driver_tpu.driver.ingest import FusedIngest
    from rplidar_ros2_driver_tpu.filters.chain import ScanFilterChain

    g = SMOKE[9]
    got = gr.run_config9("cpu", g)
    frames, run = bench._denseboost_wire_frames(g["revs"], g["points"]), g["run"]
    batches, t = [], 1000.0
    for i in range(0, len(frames), run):
        batch = []
        for f in frames[i: i + run]:
            t += 1.25e-3
            batch.append((f, t))
        batches.append(batch)
    params = jparams(g)
    completed = []
    dec = BatchScanDecoder(ScanAssembler(on_complete=lambda s: completed.append(dict(s))))
    chain = ScanFilterChain(params, beams=g["beams"], capacity=g["capacity"])
    want = []
    for batch in batches:
        dec.on_measurement_batch(gr.DENSE, list(batch))
    for s in completed:
        want.append(fields(chain.process_raw(s["angle_q14"], s["dist_q2"], s["quality"],
                                             s["flag"])))
    fused = FusedIngest(params, beams=g["beams"], capacity=g["capacity"], max_revs=2,
                        buckets=(run,))
    fused.precompile(gr.DENSE)
    dispatched = []            # JAX's engine has no dispatch counter: count its calls
    inner = fused._dispatch
    fused._dispatch = lambda *a: (dispatched.append(1), inner(*a))[1]
    jf = []
    for batch in batches:
        fused.on_measurement_batch(gr.DENSE, list(batch))
        jf += fused.collect_pipelined()
    jf += fused.flush()
    assert_outputs(got["outputs"], by_field(want))
    assert_outputs(got["outputs"], by_field([fields(o) for o, _t, _d in jf]))
    assert got["counts"] == {"runs": len(batches), "fused_dispatches": len(dispatched),
                             "revolutions": len(want), "revs_dropped": fused.revs_dropped}


# ---------------------------------------------------------------------------
# config 11: per tick against super-steps
# ---------------------------------------------------------------------------


def test_config11_super_tick_matches_jax():
    """Config 11: the backlog drained per tick and as super-steps of T —
    the port's revolutions equal JAX's super-step drain's, stream by
    stream, and every counter (dispatches, super-steps, staged transfers,
    revolutions) equals JAX's on both arms."""
    g = SMOKE[11]
    got = gr.run_config11("cpu", g)
    n, big_t, run = g["streams"], g["super_t"], g["points"] // 40
    ticks = bench._paced_fleet_byte_ticks(bench._denseboost_wire_frames(g["revs"], g["points"]),
                                          run, n, gr.DENSE)
    counts = {"ticks": len(ticks)}
    want = []
    for name, t_max in (("per_tick", 1), ("super", big_t)):
        svc = jservice(jparams(g, fleet_ingest_backend="fused", super_tick_max=t_max), n, g, run)
        eng = svc.fleet_ingest
        if t_max == 1:
            for tick in ticks:
                svc.submit_bytes(tick, pipelined=True)
            eng.flush()
        else:
            outs = svc.submit_bytes_backlog(ticks)
            want = [fields(o) for stream in outs for o in stream]
            counts["super_steps"] = eng.super_dispatches
            counts["revolutions"] = eng.scans_completed
        counts[f"{name}_dispatches"] = eng.dispatch_count
        counts[f"{name}_h2d"] = eng.h2d_transfers
    assert counts["super_dispatches"] == math.ceil(len(ticks) / big_t)
    assert got["counts"] == counts
    assert_outputs(got["outputs"], by_field(want))


# ---------------------------------------------------------------------------
# config 13: chaos
# ---------------------------------------------------------------------------


def test_config13_chaos_matches_jax():
    """Config 13: K ∈ {0, 1} faulty streams under the health supervisor —
    every stream's revolutions in every arm, the quarantined sets, the
    rejoins and the dispatches equal JAX's service driven as the bench
    drives it (two clean warm ticks, then the arms tick-paired)."""
    from rplidar_ros2_driver_tpu.driver.chaos import ChaosConfig, chaos_ticks
    from rplidar_ros2_driver_tpu.driver.health import FleetHealth, HealthConfig

    g = SMOKE[13]
    got = gr.run_config13("cpu", g)
    n, arms, run = g["streams"], g["arms"], g["points"] // 40
    frames = bench._denseboost_wire_frames(g["revs"], g["points"])
    fault_stop = int(len(frames) * 0.35)
    healthy = list(range(max(arms), n))
    lanes = {}
    for k in arms:
        cticks = chaos_ticks(bench._paced_fleet_byte_ticks(frames, run, n, gr.DENSE), {
            i: ChaosConfig(seed=1300 + i, start_frame=gr.WARM * run, stop_frame=fault_stop,
                           corrupt_rate=0.5, truncate_rate=0.85) for i in range(k)})
        svc = jservice(jparams(g, fleet_ingest_backend="fused"), n, g, run)
        fake = {"now": 0.0}
        health = FleetHealth(
            n, HealthConfig(window_ticks=3, corrupt_ratio=0.5, starvation_ticks=4,
                            suspect_ticks=2, probation_ticks=2, backoff_base_s=g["backoff"][0],
                            backoff_max_s=g["backoff"][1], backoff_jitter=0.0, seed=13),
            clock=lambda fake=fake: fake["now"], probes={i: (lambda: 0) for i in range(k)})
        svc.attach_health(health)
        for tick in cticks[:gr.WARM]:
            svc.submit_bytes(tick)
            fake["now"] += 0.1
        lanes[k] = dict(svc=svc, health=health, fake=fake, ticks=cticks,
                        d0=svc.fleet_ingest.dispatch_count, outs=[[] for _ in range(n)])
    n_ticks = len(lanes[0]["ticks"]) - gr.WARM
    for t in range(n_ticks):
        for k in arms[t % len(arms):] + arms[:t % len(arms)]:
            lane = lanes[k]
            res = lane["svc"].submit_bytes(lane["ticks"][gr.WARM + t])
            lane["fake"]["now"] += 0.1
            for i, o in enumerate(res):
                if o is not None:
                    lane["outs"][i].append(fields(o))
    want_counts, want = {"ticks": n_ticks}, {}
    for k, lane in lanes.items():
        want_counts[f"k{k}"] = {
            "dispatches": lane["svc"].fleet_ingest.dispatch_count - lane["d0"],
            "quarantined": [i for i, h in enumerate(lane["health"].health) if h.quarantines],
            "rejoins": lane["svc"].rejoins,
            "healthy_revs": sum(len(lane["outs"][i]) for i in healthy),
            "revs": sum(map(len, lane["outs"]))}
        for i in range(n):
            want.update(by_field(lane["outs"][i], f"k{k}_s{i}_"))
    assert want_counts["k1"]["quarantined"] == [0] and want_counts["k1"]["rejoins"] >= 1
    assert got["counts"] == want_counts
    assert_outputs(got["outputs"], want)


# ---------------------------------------------------------------------------
# config 16: de-skew
# ---------------------------------------------------------------------------


def test_config16_deskew_matches_jax():
    """Config 16: the reconstruct arm against the plain fused fleet, each
    with a host-reference FleetMapper — both arms' revolutions, mapper
    poses and stream 0's reconstructed sweep planes equal JAX's, and the
    update and revolution counts too."""
    g = SMOKE[16]
    got = gr.run_config16("cpu", g)
    n, run = g["streams"], g["run"]
    frames = bench._denseboost_wire_frames(g["revs"], g["points"])
    lanes = {}
    for name, deskew in (("base", False), ("rec", True)):
        params = jparams(g, fleet_ingest_backend="fused", deskew_enable=deskew,
                         sweep_reconstruct_window=4, deskew_profile_beams=128,
                         deskew_shift_window=4, map_enable=True, map_backend="host",
                         map_grid=g["map_grid"], map_cell_m=0.1)
        svc = jservice(params, n, g, run)
        if deskew:
            svc.fleet_ingest.recon_log = True
        svc.attach_mapper()
        ticks = bench._paced_fleet_byte_ticks(frames, run, n, gr.DENSE)
        for t in ticks[:gr.WARM]:
            svc.submit_bytes(t)
        lanes[name] = dict(svc=svc, ticks=ticks, outs=[], poses=[], updates=0)
    n_ticks = len(lanes["base"]["ticks"]) - gr.WARM
    for t in range(n_ticks):
        for name in (("base", "rec") if t % 2 == 0 else ("rec", "base")):
            lane = lanes[name]
            svc = lane["svc"]
            res = svc.submit_bytes(lane["ticks"][gr.WARM + t])
            lane["outs"] += [fields(o) for o in res if o is not None]
            for p in svc.last_poses:
                if p is not None:
                    lane["updates"] += 1
                    lane["poses"].append(np.asarray(p.pose_q, np.int32))
            svc.last_poses = [None] * n
    want = {}
    for name, lane in lanes.items():
        want.update(by_field(lane["outs"], f"{name}_"))
        want[f"{name}_poses"] = lane["poses"]
    want["recon_planes"] = [np.asarray(p) for p, _pts in
                            lanes["rec"]["svc"].fleet_ingest.recon_history[0]]
    assert_outputs(got["outputs"], want)
    assert got["counts"] == {"ticks": n_ticks, "revolutions": len(lanes["rec"]["outs"]),
                             "base_updates": lanes["base"]["updates"],
                             "rec_updates": lanes["rec"]["updates"],
                             "recon_planes": len(want["recon_planes"])}
    assert lanes["rec"]["updates"] >= 2 * lanes["base"]["updates"]


# ---------------------------------------------------------------------------
# config 12's room on a 1024² map
# ---------------------------------------------------------------------------


def test_map1024_mapper_matches_jax():
    """Config 12's room at ``map_grid=1024`` (0.05 m): the port's fused
    FleetMapper (its kernels' plain versions on the CPU; B8's remote route
    on the card) equals JAX's fused FleetMapper tick for tick, every
    snapshot key too."""
    from rplidar_ros2_driver_tpu.mapping.mapper import FleetMapper

    g = SMOKE["map1024"]
    got = gr.run_map1024("cpu", g)
    n, b = g["streams"], g["beams"]
    mapper = FleetMapper(JParams(filter_backend="cpu", filter_chain=("clip", "median", "voxel"),
                                 map_enable=True, map_backend="fused", map_grid=g["grid"],
                                 map_cell_m=g["cell_m"], map_match_window=g["window_m"]),
                         n, beams=b)
    masks, live = np.ones((n, b), bool), np.ones((n,), np.int32)
    traj, scores = [], []
    room, _truth, _m, _l = bench._room_fleet_ticks(n, b, g["ticks"])
    for pts in room:
        ests = mapper.submit_points(pts, masks, live)
        traj.append(np.stack([e.pose_q for e in ests]).astype(np.int32))
        scores.append(np.asarray([e.score for e in ests], np.int32))
    want = {"traj": traj, "scores": scores}
    want.update({f"snap_{k}": [np.asarray(v)] for k, v in mapper.snapshot().items()})
    assert mapper.cfg.grid == 1024
    assert_outputs(got["outputs"], want)
    assert got["counts"]["matched"] == int(sum(int((s > 0).sum()) for s in scores)) > 0

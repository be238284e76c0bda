"""The JAX package's remaining graded configurations through the port.

``bench.py``'s configs 1–4, 9, 11, 13 and 16 (``GRADED``), and config 12's
drifting room on a 1024² map, driven through the port's own entry points
(``to_laserscan``, ``ScanFilterChain``, ``BatchScanDecoder`` +
``ScanAssembler``, ``FusedIngest``, ``ShardedFilterService``,
``FleetMapper``) on one device.  Each ``run_*`` takes a ``filter_backend``
(``cuda`` or ``cpu``) and a geometry from :data:`GEOMETRY` (``full``: the
bench's non-smoke widths, depth cut as listed there; ``smoke``: the bench's
smoke geometry, or a narrow one where the bench has none) and returns::

    {"outputs": {name: [numpy arrays]},   # what must be byte-equal
     "counts": {name: int},               # dispatches, revolutions, ...
     "launches": {arm: {kernel: int}},    # kernel launches in the timed loop
     "stats": {name: float}}              # rates and latencies (host clock)

Every claim the bench asserts for its config is checked here and raises
:class:`ClaimError`: dispatch counts, the same revolutions across arms,
fault isolation and rejoin under chaos, the update multiplication and the
zero-motion identity of the de-skew arm.  Comparing a card run with a CPU
run (:func:`same_outputs`) and asserting the launches is the caller's (on
the CPU the wrappers run their plain versions and count nothing).

The scenes are the bench's own: :func:`wire_frames`,
:func:`paced_fleet_ticks`, :func:`host_scans` and :func:`room_ticks` are
copies of ``_denseboost_wire_frames``, ``_paced_fleet_byte_ticks``,
``_host_scans`` and ``_room_fleet_ticks``, kept in
:mod:`rplidar_ros2_driver_tpu_torch.tools.scenes`.

Used by ``chip_smoke.py``'s graded phase and
tests/test_torch_graded_configs.py.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from rplidar_ros2_driver_tpu_torch.protocol.constants import Ans
from rplidar_ros2_driver_tpu_torch.tools.scenes import (  # noqa: F401  (the scenes, re-exported)
    host_scans,
    paced_fleet_ticks,
    room_ticks,
    wire_frames,
)
from rplidar_ros2_driver_tpu_torch.utils import guards

# bench.py's widths (full) and smoke geometry per config; ``revs``/``ticks``
# /``iters`` are depth, the only thing cut (PERF.md §4 lists the cuts):
# configs 2-4 stream 64 revolutions (the bench 310, cycling 32), config
# 16 4 of its 16 (its host-reference mappers take ~0.5 s a tick at 4 x
# 2048 beams), the 1024^2 room 8 ticks of config 12's 20; the bench's
# repeated rounds (best-of) run once
GEOMETRY = {
    "full": {
        1: dict(points=360, batches=8, iters=300),
        2: dict(points=3200, window=1, beams=2048, grid=256, capacity=4096, revs=64),
        3: dict(points=920, window=1, beams=2048, grid=256, capacity=4096, revs=64),
        4: dict(points=800, window=16, beams=2048, grid=256, capacity=4096, revs=64),
        9: dict(window=64, beams=2048, grid=256, points=3200, revs=40, capacity=4096, run=32),
        11: dict(window=64, beams=2048, grid=256, points=3200, revs=20, capacity=4096,
                 streams=4, super_t=8),
        13: dict(window=64, beams=2048, grid=256, points=3200, revs=32, capacity=4096,
                 streams=8, arms=(0, 1, 3), backoff=(1.2, 2.4)),
        16: dict(window=64, beams=2048, grid=256, points=3200, revs=4, capacity=4096,
                 streams=4, run=16, map_grid=128),
        "map1024": dict(streams=4, grid=1024, cell_m=0.05, beams=2048, window_m=0.4, ticks=8),
    },
    "smoke": {
        1: dict(points=360, batches=8, iters=8),
        2: dict(points=3200, window=1, beams=512, grid=64, capacity=4096, revs=6),
        3: dict(points=920, window=1, beams=512, grid=64, capacity=1024, revs=6),
        4: dict(points=800, window=16, beams=512, grid=64, capacity=1024, revs=20),
        9: dict(window=8, beams=512, grid=64, points=800, revs=10, capacity=1024, run=32),
        11: dict(window=8, beams=512, grid=64, points=800, revs=6, capacity=1024,
                 streams=2, super_t=4),
        13: dict(window=8, beams=512, grid=64, points=800, revs=20, capacity=1024,
                 streams=4, arms=(0, 1), backoff=(0.8, 1.6)),
        16: dict(window=4, beams=256, grid=32, points=800, revs=8, capacity=1024,
                 streams=2, run=8, map_grid=64),
        "map1024": dict(streams=4, grid=1024, cell_m=0.05, beams=256, window_m=0.4, ticks=3),
    },
}

DENSE = int(Ans.MEASUREMENT_DENSE_CAPSULED)
WARM = 2                # clean warm-up ticks (configs 13, 16), outside the guard
OUTPUT_FIELDS = ("ranges", "intensities", "points_xy", "point_mask", "voxel")


class ClaimError(RuntimeError):
    """A claim the bench asserts for its configuration did not hold."""


def claim(cond, msg: str) -> None:
    if not cond:
        raise ClaimError(msg)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def launch_counts() -> dict:
    """Every kernel wrapper's launch count, by kernel name."""
    from rplidar_ros2_driver_tpu_torch.ops import deskew_kernels as dk
    from rplidar_ros2_driver_tpu_torch.ops import median_kernels as mk
    from rplidar_ros2_driver_tpu_torch.ops import scan_match_kernels as smk

    return {**mk.launch_counts, **dk.launch_counts, **smk.launch_counts}


def _launched(before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in launch_counts().items()}


def _device(backend: str) -> torch.device:
    from rplidar_ros2_driver_tpu_torch.filters.chain import pick_device

    return pick_device(backend)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _pcts(seconds) -> dict:
    ms = np.asarray(seconds, np.float64) * 1e3
    if ms.size == 0:
        return {"p50_ms": None, "p99_ms": None}
    return {"p50_ms": float(np.percentile(ms, 50)), "p99_ms": float(np.percentile(ms, 99))}


def _fields(out) -> list[np.ndarray]:
    """A FilterOutput's fields as host arrays, in OUTPUT_FIELDS order."""
    return [np.asarray(getattr(out, f)).copy() for f in OUTPUT_FIELDS]


def same_outputs(a: dict, b: dict) -> list[str]:
    """The output names whose arrays differ between two runs (dtype,
    shape or bytes); empty when every array is byte-equal."""
    bad = []
    for name in sorted(set(a) | set(b)):
        x, y = a.get(name), b.get(name)
        if x is None or y is None or len(x) != len(y) or not all(
                u.dtype == v.dtype and u.shape == v.shape and u.tobytes() == v.tobytes()
                for u, v in zip(x, y)):
            bad.append(name)
    return bad


def _chain_params(backend: str, g: dict, chain: tuple, **over):
    from rplidar_ros2_driver_tpu_torch.core.config import DriverParams

    return DriverParams(filter_backend=backend, filter_chain=chain,
                        filter_window=g["window"], voxel_grid_size=g["grid"],
                        voxel_cell_m=0.25, **over)


# ---------------------------------------------------------------------------
# config 1: the A1M8 passthrough (to_laserscan, no chain)
# ---------------------------------------------------------------------------


def run_config1(backend: str, g: dict) -> dict:
    """bench.py ``bench_passthrough``: 360-node ScanBatches of the seeded
    ring through ``to_laserscan`` (0.1 s, 12 m, no scan processing, the
    legacy quality shift), ``iters`` calls over 8 batches."""
    from rplidar_ros2_driver_tpu_torch.core.types import ScanBatch
    from rplidar_ros2_driver_tpu_torch.ops.laserscan import to_laserscan

    dev, points = _device(backend), g["points"]
    rng = np.random.default_rng(0)
    batches = [
        ScanBatch.from_numpy(((np.arange(points) * 65536) // points).astype(np.int32),
                             (rng.uniform(0.2, 11.0, points) * 4000).astype(np.int32),
                             np.full(points, 190, np.int32), device=dev)
        for _ in range(g["batches"])
    ]

    def convert(b):
        return to_laserscan(b, 0.1, 12.0, scan_processing=False, inverted=False,
                            is_new_type=False)

    outs = [convert(b) for b in batches]
    _sync(dev)
    fields = ("ranges", "intensities", "beam_count", "angle_min", "angle_max",
              "angle_increment", "time_increment", "scan_time", "range_min", "range_max")
    lat, l0 = [], launch_counts()
    t0 = time.perf_counter()
    for k in range(g["iters"]):
        tb = time.perf_counter()
        out = convert(batches[k % len(batches)])
        _sync(dev)
        lat.append(time.perf_counter() - tb)
    wall = time.perf_counter() - t0
    return {
        "outputs": {f: [getattr(o, f).cpu().numpy().copy() for o in outs] for f in fields},
        "counts": {"scans": g["iters"], "beams": int(out.beam_count)},
        "launches": {"passthrough": _launched(l0)},
        "stats": {"scans_per_s": g["iters"] / wall, **_pcts(lat)},
    }


# ---------------------------------------------------------------------------
# configs 2-4: the chain (ScanFilterChain.process_raw)
# ---------------------------------------------------------------------------

CHAIN_STAGES = {2: ("clip",), 3: ("clip",), 4: ("clip", "median")}


def run_chain_config(config: int, backend: str, g: dict, median: str = "pallas") -> dict:
    """bench.py configs 2–4 (``GRADED``): ``revs`` seeded revolutions of
    ``points`` through ``ScanFilterChain.process_raw`` at window W, 2048
    beams, 256² at 0.25 m — configs 2 and 3 with the median and the voxel
    grid off, config 4 with the voxel grid off (``median`` picks the
    median arm: ``pallas`` is B1, ``inc`` B2)."""
    from rplidar_ros2_driver_tpu_torch.filters.chain import ScanFilterChain

    dev = _device(backend)
    params = _chain_params(backend, g, CHAIN_STAGES[config], median_backend=median)
    chain = ScanFilterChain(params, g["beams"], capacity=g["capacity"])
    claim(chain.cfg.enable_median == (config == 4) and not chain.cfg.enable_voxel,
          f"config {config}: the chain's stages are {CHAIN_STAGES[config]}, "
          f"not median={chain.cfg.enable_median} voxel={chain.cfg.enable_voxel}")
    revs = host_scans(g["revs"], g["points"])
    _sync(dev)
    outs, lat, l0 = [], [], launch_counts()
    t0 = time.perf_counter()
    for r in revs:
        tb = time.perf_counter()
        out = chain.process_raw(r["angle_q14"], r["dist_q2"], r["quality"])
        lat.append(time.perf_counter() - tb)
        outs.append(_fields(out))
    wall = time.perf_counter() - t0
    return {
        "outputs": {f: [o[k] for o in outs] for k, f in enumerate(OUTPUT_FIELDS)},
        "counts": {"revolutions": len(outs)},
        "launches": {median: _launched(l0)},
        "stats": {"scans_per_s": len(outs) / wall, **_pcts(lat)},
    }


# ---------------------------------------------------------------------------
# config 9: host ingest against the fused ingest on one byte stream
# ---------------------------------------------------------------------------


def run_config9(backend: str, g: dict) -> dict:
    """bench.py ``bench_ingest``: identical DenseBoost wire frames, ``run``
    a delivery, through the host ingest (BatchScanDecoder -> ScanAssembler
    -> ``ScanFilterChain.process_raw``) and through ``FusedIngest`` (one
    dispatch a frame run, pipelined collect).  Claims: one fused dispatch
    a run; the same revolutions, byte-equal, on both arms."""
    from rplidar_ros2_driver_tpu_torch.driver.assembly import ScanAssembler
    from rplidar_ros2_driver_tpu_torch.driver.decode import BatchScanDecoder
    from rplidar_ros2_driver_tpu_torch.driver.ingest import FusedIngest
    from rplidar_ros2_driver_tpu_torch.filters.chain import ScanFilterChain

    dev, run = _device(backend), g["run"]
    params = _chain_params(backend, g, ("clip", "median", "voxel"))
    frames = wire_frames(g["revs"], g["points"])
    batches, t = [], 1000.0
    for i in range(0, len(frames), run):
        batch = []
        for f in frames[i: i + run]:
            t += 1.25e-3
            batch.append((f, t))
        batches.append(batch)

    completed: list = []
    dec = BatchScanDecoder(ScanAssembler(on_complete=lambda s: completed.append(dict(s))))
    chain = ScanFilterChain(params, beams=g["beams"], capacity=g["capacity"])
    dec.precompile(DENSE)
    _sync(dev)
    host_outs, host_lat, done, l0 = [], [], 0, launch_counts()
    t0 = time.perf_counter()
    for batch in batches:
        tb = time.perf_counter()
        dec.on_measurement_batch(DENSE, list(batch))
        while done < len(completed):
            s = completed[done]
            done += 1
            host_outs.append(_fields(chain.process_raw(s["angle_q14"], s["dist_q2"],
                                                       s["quality"], s["flag"])))
        host_lat.append(time.perf_counter() - tb)
    host_wall = time.perf_counter() - t0
    launches = {"host": _launched(l0)}

    fused = FusedIngest(params, beams=g["beams"], capacity=g["capacity"], max_revs=2,
                        buckets=(run,))
    fused.precompile(DENSE)
    _sync(dev)
    d0, l0 = fused.dispatch_count, launch_counts()
    fused_outs, fused_lat = [], []
    t0 = time.perf_counter()
    for batch in batches:
        tb = time.perf_counter()
        fused.on_measurement_batch(DENSE, list(batch))
        fused_outs += [_fields(o) for o, _ts0, _dur in fused.collect_pipelined()]
        fused_lat.append(time.perf_counter() - tb)
    fused_outs += [_fields(o) for o, _ts0, _dur in fused.flush()]
    fused_wall = time.perf_counter() - t0
    launches["fused"] = _launched(l0)

    dispatches = fused.dispatch_count - d0
    claim(dispatches == len(batches),
          f"config 9: {dispatches} fused dispatches for {len(batches)} frame runs")
    claim(len(host_outs) == len(fused_outs) == fused.scans_completed > 0,
          f"config 9: host {len(host_outs)} against fused {len(fused_outs)} revolutions "
          f"({fused.scans_completed} completed)")
    bad = [OUTPUT_FIELDS[k] for k in range(len(OUTPUT_FIELDS))
           if any(h[k].tobytes() != f[k].tobytes() for h, f in zip(host_outs, fused_outs))]
    claim(not bad, f"config 9: the fused arm's revolutions differ from the host's in {bad}")
    return {
        "outputs": {f: [o[k] for o in host_outs] for k, f in enumerate(OUTPUT_FIELDS)},
        "counts": {"runs": len(batches), "fused_dispatches": dispatches,
                   "revolutions": len(host_outs), "revs_dropped": fused.revs_dropped},
        "launches": launches,
        "stats": {"host_scans_per_s": len(host_outs) / host_wall,
                  "fused_scans_per_s": len(fused_outs) / fused_wall,
                  **{f"host_run_{k}": v for k, v in _pcts(host_lat).items()},
                  **{f"fused_run_{k}": v for k, v in _pcts(fused_lat).items()}},
    }


# ---------------------------------------------------------------------------
# config 11: one backlog drained per tick and as super-steps
# ---------------------------------------------------------------------------


def _fleet_service(params, streams: int, g: dict, run: int):
    from rplidar_ros2_driver_tpu_torch.parallel.service import ShardedFilterService

    svc = ShardedFilterService(params, streams, beams=g["beams"], capacity=g["capacity"],
                               fleet_ingest_buckets=(run,))
    svc._ensure_byte_ingest()
    svc.fleet_ingest.precompile([DENSE])
    return svc


def run_config11(backend: str, g: dict) -> dict:
    """bench.py ``bench_super_tick``: one backlog of fleet byte ticks (a
    revolution a stream a tick) drained per tick (``super_tick_max=1``,
    ``submit_bytes`` pipelined, then the flush) and as super-steps of T
    (``submit_bytes_backlog``).  Claims: ``ticks`` dispatches against
    ``ceil(ticks/T)``, two staged transfers a dispatch, the same
    revolutions, byte-equal, per stream."""
    dev, n, big_t = _device(backend), g["streams"], g["super_t"]
    run = g["points"] // 40
    ticks = paced_fleet_ticks(wire_frames(g["revs"], g["points"]), run, n)
    arms = {}
    for name, t_max in (("per_tick", 1), ("super", big_t)):
        svc = _fleet_service(_chain_params(backend, g, ("clip", "median", "voxel"),
                                           fleet_ingest_backend="fused",
                                           super_tick_max=t_max), n, g, run)
        eng = svc.fleet_ingest
        _sync(dev)
        per_stream, lat, l0 = [[] for _ in range(n)], [], launch_counts()
        t0 = time.perf_counter()
        if t_max == 1:
            for tick in ticks:
                tb = time.perf_counter()
                res = svc.submit_bytes(tick, pipelined=True)
                lat.append(time.perf_counter() - tb)
                for i, o in enumerate(res):
                    if o is not None:
                        per_stream[i].append(_fields(o))
            for i, outs in enumerate(eng.flush()):
                per_stream[i] += [_fields(o) for o, _ts0, _dur in outs]
        else:
            outs = svc.submit_bytes_backlog(ticks)
            for i, got in enumerate(outs):
                per_stream[i] = [_fields(o) for o in got]
        _sync(dev)
        wall = time.perf_counter() - t0
        arms[name] = {"per_stream": per_stream, "dispatches": eng.dispatch_count,
                      "h2d": eng.h2d_transfers, "revs": eng.scans_completed,
                      "super_dispatches": eng.super_dispatches, "wall": wall, "lat": lat,
                      "launches": _launched(l0)}
    a, b = arms["per_tick"], arms["super"]
    want_super = math.ceil(len(ticks) / big_t)
    claim(a["dispatches"] == len(ticks),
          f"config 11: the per-tick arm dispatched {a['dispatches']} times for {len(ticks)} ticks")
    claim(b["dispatches"] == want_super,
          f"config 11: the super arm dispatched {b['dispatches']} times for {len(ticks)} "
          f"ticks at T={big_t} (expected {want_super})")
    for arm in (a, b):
        claim(arm["h2d"] == 2 * arm["dispatches"],
              f"config 11: {arm['h2d']} staged transfers for {arm['dispatches']} dispatches")
    claim(a["revs"] == b["revs"] > 0,
          f"config 11: per-tick {a['revs']} against super {b['revs']} revolutions")
    claim(sum(map(len, a["per_stream"])) == a["revs"],
          "config 11: the per-tick arm hid a completed revolution")
    same = all(len(x) == len(y) and all(p.tobytes() == q.tobytes() for u, v in zip(x, y)
                                        for p, q in zip(u, v))
               for x, y in zip(a["per_stream"], b["per_stream"]))
    claim(same, "config 11: the super-step's revolutions differ from the per-tick drain's")
    flat = [o for s in b["per_stream"] for o in s]
    return {
        "outputs": {f: [o[k] for o in flat] for k, f in enumerate(OUTPUT_FIELDS)},
        "counts": {"ticks": len(ticks), "per_tick_dispatches": a["dispatches"],
                   "super_dispatches": b["dispatches"], "super_steps": b["super_dispatches"],
                   "per_tick_h2d": a["h2d"], "super_h2d": b["h2d"], "revolutions": b["revs"]},
        "launches": {name: arm["launches"] for name, arm in arms.items()},
        "stats": {"per_tick_scans_per_s": a["revs"] / a["wall"],
                  "super_scans_per_s": b["revs"] / b["wall"],
                  "per_tick_ticks_per_s": len(ticks) / a["wall"],
                  "super_ticks_per_s": len(ticks) / b["wall"],
                  "per_tick_drain_ms": a["wall"] * 1e3, "super_drain_ms": b["wall"] * 1e3,
                  **{f"per_tick_{k}": v for k, v in _pcts(a["lat"]).items()}},
    }


# ---------------------------------------------------------------------------
# config 13: K faulty streams under the health supervisor
# ---------------------------------------------------------------------------


def run_config13(backend: str, g: dict) -> dict:
    """bench.py ``bench_chaos``: one fused fleet service per K in ``arms``
    (K = 0 the baseline), streams 0..K-1 fed ``driver/chaos.chaos_ticks``
    (truncation and corruption over the middle of the run, a clean tail),
    ``attach_health`` with the bench's thresholds on a fake clock of 0.1 s
    a tick; two clean warm ticks, then every arm advanced tick-paired
    under the whole ``guards.steady_state`` (quarantine snapshots and
    rejoin restores inside it).  Claims: one dispatch a tick whatever K;
    exactly the faulty streams quarantined, each rejoined; the healthy
    streams' revolutions byte-identical to the baseline's."""
    from rplidar_ros2_driver_tpu_torch.driver.chaos import ChaosConfig, chaos_ticks
    from rplidar_ros2_driver_tpu_torch.driver.health import FleetHealth, HealthConfig

    dev, n, arms = _device(backend), g["streams"], tuple(g["arms"])
    run = g["points"] // 40
    frames = wire_frames(g["revs"], g["points"])
    fault_stop = int(len(frames) * 0.35)
    healthy = list(range(max(arms), n))
    params = _chain_params(backend, g, ("clip", "median", "voxel"), fleet_ingest_backend="fused")

    def build(k: int):
        cfgs = {i: ChaosConfig(seed=1300 + i, start_frame=WARM * run, stop_frame=fault_stop,
                               corrupt_rate=0.5, truncate_rate=0.85) for i in range(k)}
        cticks = chaos_ticks(paced_fleet_ticks(frames, run, n), cfgs)
        svc = _fleet_service(params, n, g, run)
        fake = {"now": 0.0}
        health = FleetHealth(
            n, HealthConfig(window_ticks=3, corrupt_ratio=0.5, starvation_ticks=4,
                            suspect_ticks=2, probation_ticks=2, backoff_base_s=g["backoff"][0],
                            backoff_max_s=g["backoff"][1], backoff_jitter=0.0, seed=13),
            clock=lambda: fake["now"], probes={i: (lambda: 0) for i in range(k)})
        svc.attach_health(health)
        for tick in cticks[:WARM]:
            svc.submit_bytes(tick)
            fake["now"] += 0.1
        return {"svc": svc, "health": health, "fake": fake, "ticks": cticks,
                "d0": svc.fleet_ingest.dispatch_count, "lat": [],
                "outs": [[] for _ in range(n)]}

    lanes = {k: build(k) for k in arms}
    _sync(dev)
    n_ticks = len(lanes[0]["ticks"]) - WARM
    l0 = launch_counts()
    t_all = time.perf_counter()
    with guards.steady_state(tag="graded config 13"):
        for t in range(n_ticks):
            # rotate which lane goes first (the bench's tick-paired order)
            order = arms[t % len(arms):] + arms[:t % len(arms)]
            for k in order:
                lane = lanes[k]
                tb = time.perf_counter()
                res = lane["svc"].submit_bytes(lane["ticks"][WARM + t])
                lane["lat"].append(time.perf_counter() - tb)
                lane["fake"]["now"] += 0.1
                for i, o in enumerate(res):
                    if o is not None:
                        lane["outs"][i].append(_fields(o))
    _sync(dev)
    wall = time.perf_counter() - t_all
    launches = {"all_arms": _launched(l0)}

    counts, stats, outputs = {"ticks": n_ticks}, {"wall_s": wall}, {}
    base = lanes[0]
    for k in arms:
        lane = lanes[k]
        svc, health = lane["svc"], lane["health"]
        got = svc.fleet_ingest.dispatch_count - lane["d0"]
        claim(got == n_ticks, f"config 13 K={k}: {got} dispatches over {n_ticks} ticks")
        quarantined = [i for i, h in enumerate(health.health) if h.quarantines > 0]
        claim(quarantined == list(range(k)),
              f"config 13 K={k}: quarantined {quarantined}, faulty {list(range(k))}")
        claim(svc.rejoins >= k, f"config 13 K={k}: {svc.rejoins} rejoins for {k} faulty streams")
        for i in healthy:
            a, b = base["outs"][i], lane["outs"][i]
            claim(len(a) == len(b) and all(x.tobytes() == y.tobytes()
                                          for u, v in zip(a, b) for x, y in zip(u, v)),
                  f"config 13 K={k}: healthy stream {i} diverged from the K=0 baseline")
        healthy_revs = sum(len(lane["outs"][i]) for i in healthy)
        counts[f"k{k}"] = {"dispatches": got, "quarantined": quarantined,
                           "rejoins": svc.rejoins, "healthy_revs": healthy_revs,
                           "revs": sum(map(len, lane["outs"]))}
        ratio = np.asarray(base["lat"]) / np.maximum(np.asarray(lane["lat"]), 1e-9)
        stats[f"k{k}"] = {"ticks_per_s": n_ticks / sum(lane["lat"]),
                          "healthy_scans_per_s": healthy_revs / sum(lane["lat"]),
                          "steady_tick_ratio": float(np.percentile(ratio, 50)),
                          **_pcts(lane["lat"])}
        for i in range(n):
            for f_i, f in enumerate(OUTPUT_FIELDS):
                outputs[f"k{k}_s{i}_{f}"] = [o[f_i] for o in lane["outs"][i]]
    return {"outputs": outputs, "counts": counts, "launches": launches, "stats": stats}


# ---------------------------------------------------------------------------
# config 16: the reconstruct arm against the plain fused fleet
# ---------------------------------------------------------------------------


def run_config16(backend: str, g: dict) -> dict:
    """bench.py ``bench_deskew``: two fused fleets with a host-reference
    FleetMapper each, tick-paired over one static byte stream under the
    whole ``guards.steady_state``; the reconstruct arm runs
    ``deskew_enable`` (B4/B5 inside the fused step), the baseline the
    plain per-revolution path.  Claims: the same dispatch count (one a
    tick) and revolutions on both arms; >= 2 mapper updates a revolution
    on the reconstruct arm; byte-identical revolutions (zero motion);
    stream 0's sweep planes and revolutions equal to
    ``ops/deskew_ref.DeskewHostTwin`` + a golden ScanFilterChain."""
    from rplidar_ros2_driver_tpu_torch.filters.chain import ScanFilterChain
    from rplidar_ros2_driver_tpu_torch.ops.deskew import deskew_config_from_params
    from rplidar_ros2_driver_tpu_torch.ops.deskew_ref import DeskewHostTwin

    dev, n, run = _device(backend), g["streams"], g["run"]
    ticks_per_rev = g["points"] / 40 / run
    claim(ticks_per_rev >= 2, "config 16: the scene must span >= 2 ticks a revolution")
    frames = wire_frames(g["revs"], g["points"])

    def build(deskew: bool):
        params = _chain_params(
            backend, g, ("clip", "median", "voxel"), fleet_ingest_backend="fused",
            deskew_enable=deskew, sweep_reconstruct_window=4, deskew_profile_beams=128,
            deskew_shift_window=4, map_enable=True, map_backend="host",
            map_grid=g["map_grid"], map_cell_m=0.1)
        svc = _fleet_service(params, n, g, run)
        if deskew:
            svc.fleet_ingest.recon_log = True
        svc.attach_mapper()
        ticks = paced_fleet_ticks(frames, run, n)
        for t in ticks[:WARM]:
            svc.submit_bytes(t)
        return {"svc": svc, "params": params, "ticks": ticks, "lat": [], "revs": 0,
                "updates": 0, "outs": [], "poses": [], "launches": {},
                "d0": svc.fleet_ingest.dispatch_count}

    lanes = {"base": build(False), "rec": build(True)}
    _sync(dev)
    n_ticks = len(lanes["base"]["ticks"]) - WARM
    with guards.steady_state(tag="graded config 16"):
        for t in range(n_ticks):
            order = ("base", "rec") if t % 2 == 0 else ("rec", "base")
            for name in order:
                lane = lanes[name]
                svc = lane["svc"]
                l0 = launch_counts()
                tb = time.perf_counter()
                res = svc.submit_bytes(lane["ticks"][WARM + t])
                lane["lat"].append(time.perf_counter() - tb)
                for k, v in _launched(l0).items():
                    lane["launches"][k] = lane["launches"].get(k, 0) + v
                for i, o in enumerate(res):
                    if o is not None:
                        lane["revs"] += 1
                        lane["outs"].append((t, i, _fields(o)))
                for p in svc.last_poses:
                    if p is not None:
                        lane["updates"] += 1
                        lane["poses"].append(np.asarray(p.pose_q, np.int32).copy())
                # baseline poses are per revolution: clear so an idle tick
                # cannot count the stash twice
                svc.last_poses = [None] * n
    _sync(dev)
    base, rec = lanes["base"], lanes["rec"]
    for name, lane in lanes.items():
        got = lane["svc"].fleet_ingest.dispatch_count - lane["d0"]
        claim(got == n_ticks, f"config 16 {name}: {got} ingest dispatches over {n_ticks} ticks")
    claim(base["revs"] == rec["revs"] > 0,
          f"config 16: {base['revs']} against {rec['revs']} revolutions on one byte stream")
    claim(len(base["outs"]) == len(rec["outs"]) and all(
        tb == tr and ib == ir and all(x.tobytes() == y.tobytes() for x, y in zip(a, b))
        for (tb, ib, a), (tr, ir, b) in zip(base["outs"], rec["outs"])),
        "config 16: the reconstruct arm's revolutions differ from the baseline's on a "
        "static scene (zero-motion de-skew is not the identity)")
    multiplier = rec["updates"] / max(base["updates"], 1)
    claim(multiplier >= 2.0,
          f"config 16: the reconstruct arm made {multiplier:.2f}x the baseline's map updates")

    # stream 0 through the host twin and a golden chain
    rec_params = rec["params"]
    twin = DeskewHostTwin(deskew_config_from_params(rec_params, g["beams"], platform=dev.type),
                          max_nodes=g["capacity"])
    chain = ScanFilterChain(rec_params, beams=g["beams"], warmup=False)
    twin_recons, twin_revs = [], []
    for items in (t[0] for t in rec["ticks"]):
        combined, pushed, revs_t = twin.tick(items[0], items[1])
        if pushed:
            twin_recons.append(np.asarray(combined))
        for a2, d2, scan in revs_t:
            twin_revs.append(_fields(chain.process_raw(a2, d2, scan["quality"], scan["flag"])))
    eng_recons = [np.asarray(plane) for plane, _pts in rec["svc"].fleet_ingest.recon_history[0]]
    claim(len(eng_recons) == len(twin_recons) and all(
        a.tobytes() == b.tobytes() for a, b in zip(eng_recons, twin_recons)),
        "config 16: the reconstructed sweep planes differ from DeskewHostTwin's")
    fused0 = [o for _t, i, o in rec["outs"] if i == 0]
    tail = twin_revs[len(twin_revs) - len(fused0):]
    claim(fused0 and len(tail) == len(fused0) and all(
        all(x.tobytes() == y.tobytes() for x, y in zip(a, b)) for a, b in zip(fused0, tail)),
        "config 16: stream 0's de-skewed revolutions differ from the host twin's golden chain")
    outputs = {f"{name}_{f}": [o[k] for _t, _i, o in lane["outs"]]
               for name, lane in lanes.items() for k, f in enumerate(OUTPUT_FIELDS)}
    outputs["rec_poses"] = rec["poses"]
    outputs["base_poses"] = base["poses"]
    outputs["recon_planes"] = eng_recons
    return {
        "outputs": outputs,
        "counts": {"ticks": n_ticks, "revolutions": rec["revs"],
                   "base_updates": base["updates"], "rec_updates": rec["updates"],
                   "recon_planes": len(eng_recons)},
        "launches": {name: lane["launches"] for name, lane in lanes.items()},
        "stats": {"update_multiplier": multiplier, "ticks_per_rev": ticks_per_rev,
                  "rec_updates_per_s": rec["updates"] / sum(rec["lat"]),
                  "base_updates_per_s": base["updates"] / sum(base["lat"]),
                  "steady_tick_ratio": float(np.percentile(
                      np.asarray(base["lat"]) / np.maximum(np.asarray(rec["lat"]), 1e-9), 50)),
                  **{f"base_tick_{k}": v for k, v in _pcts(base["lat"]).items()},
                  **{f"rec_tick_{k}": v for k, v in _pcts(rec["lat"]).items()}},
    }


# ---------------------------------------------------------------------------
# config 12's room on a 1024² map
# ---------------------------------------------------------------------------


def map1024_params(backend: str, g: dict, **over):
    from rplidar_ros2_driver_tpu_torch.core.config import DriverParams

    return DriverParams(filter_backend=backend, filter_chain=("clip", "median", "voxel"),
                        map_enable=True, map_backend="fused", map_grid=g["grid"],
                        map_cell_m=g["cell_m"], map_match_window=g["window_m"], **over)


def run_map1024(backend: str, g: dict) -> dict:
    """bench.py config 12's drifting room (4 streams) through the fused
    ``FleetMapper`` on a ``grid``² map at 0.05 m (51.2 m at 1024: an S2's
    reach), one warm tick, then ``ticks`` ticks.  Returns the trajectory,
    the scores and every snapshot key."""
    from rplidar_ros2_driver_tpu_torch.mapping.mapper import FleetMapper

    dev, n, b = _device(backend), g["streams"], g["beams"]
    mapper = FleetMapper(map1024_params(backend, g), n, beams=b)
    claim(mapper.backend == "fused" and mapper.cfg.grid == g["grid"],
          f"map1024: the mapper resolved {mapper.backend} at grid {mapper.cfg.grid}")
    mapper.precompile()
    masks, live = np.ones((n, b), bool), np.ones((n,), np.int32)
    _sync(dev)
    traj, scores, lat, l0 = [], [], [], launch_counts()
    t0 = time.perf_counter()
    for pts in room_ticks(n, b, g["ticks"]):
        tb = time.perf_counter()
        ests = mapper.submit_points(pts, masks, live)
        lat.append(time.perf_counter() - tb)
        traj.append(np.stack([e.pose_q for e in ests]).astype(np.int32))
        scores.append(np.asarray([e.score for e in ests], np.int32))
    wall = time.perf_counter() - t0
    snap = mapper.snapshot()
    outputs = {"traj": traj, "scores": scores}
    outputs.update({f"snap_{k}": [np.asarray(v)] for k, v in snap.items()})
    return {
        "outputs": outputs, "mapper": mapper,
        "counts": {"ticks": g["ticks"], "dispatches": mapper.dispatch_count,
                   "matched": int(sum(int((s > 0).sum()) for s in scores))},
        "launches": {"mapper": _launched(l0)},
        "stats": {"ticks_per_s": g["ticks"] / wall, "scans_per_s": g["ticks"] * n / wall,
                  **_pcts(lat)},
    }

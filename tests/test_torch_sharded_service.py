"""The PyTorch package's ShardedFilterService against the JAX package's.

The JAX service runs its shard_map step on a (2, 4) mesh of the 8 forced
CPU devices; the port's runs on its one-process (1, 1) mesh on the CPU
(the median kernels' plain versions).  The cases mirror the JAX suite's
(tests/test_sharded_service.py) one for one, each held to the JAX
service on the same inputs: ``submit``, the pipelined shift and its
restore/failure paths, ``submit_local``.  Then the byte seams at config
10's smoke geometry (bench.py ``bench_fleet_ingest``) on both arms,
``FleetFusedIngest`` and service snapshots JAX -> port -> JAX continued
byte-equal, the three SLAM seams on config 12's room, ``replay_fleet``
and the ``replay --chain`` lines of several captures, and the sharded
checkpoints' round trip.  Every output is bit-exact except ``points_xy``, within 2
ulp (ROADMAP C.1).
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np
import pytest
import torch

from rplidar_ros2_driver_tpu import replay as jreplay
from rplidar_ros2_driver_tpu.core.config import DriverParams as JParams
from rplidar_ros2_driver_tpu.driver import ingest as jdi
from rplidar_ros2_driver_tpu.parallel.service import ShardedFilterService as JService
from rplidar_ros2_driver_tpu.parallel.sharding import make_mesh as jmake_mesh
from rplidar_ros2_driver_tpu_torch import replay as treplay
from rplidar_ros2_driver_tpu_torch.__main__ import main
from rplidar_ros2_driver_tpu_torch.core.config import DriverParams
from rplidar_ros2_driver_tpu_torch.driver import ingest as tdi
from rplidar_ros2_driver_tpu_torch.filters.chain import ScanFilterChain
from rplidar_ros2_driver_tpu_torch.parallel import sharding as ts
from rplidar_ros2_driver_tpu_torch.parallel.service import ShardedFilterService
from rplidar_ros2_driver_tpu_torch.protocol.constants import Ans
from rplidar_ros2_driver_tpu_torch.tools import scenes

from test_torch_replay import dense_frames, write_capture
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

DENSE = int(Ans.MEASUREMENT_DENSE_CAPSULED)
OUT_FIELDS = ("ranges", "intensities", "point_mask", "voxel")


def _params(pkg: str = "torch", **kw):
    base = dict(dummy_mode=True, filter_backend="cpu", filter_chain=("clip", "median", "voxel"),
                filter_window=4, voxel_grid_size=32)
    base.update(kw)
    return (JParams if pkg == "jax" else DriverParams)(**base)


def _scan(k: int, points: int = 300) -> dict:
    rng = np.random.default_rng(k)
    return {
        "angle_q14": ((np.arange(points) * 65536) // points).astype(np.int32),
        "dist_q2": (rng.uniform(0.3, 8.0, points) * 4000).astype(np.int32),
        "quality": np.full(points, 180, np.int32),
        "flag": None,
    }


def ulp_distance(a, b) -> np.ndarray:
    def ordered(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)

    return np.abs(ordered(a) - ordered(b))


def assert_same_output(j, t, what: str = "") -> None:
    assert (j is None) == (t is None), what
    if j is None:
        return
    for name in OUT_FIELDS:
        jv, tv = np.asarray(getattr(j, name)), np.asarray(getattr(t, name))
        np.testing.assert_array_equal(tv, jv, f"{what} {name}")
        assert tv.dtype == jv.dtype, (what, name)
    assert ulp_distance(np.asarray(j.points_xy), np.asarray(t.points_xy)).max() <= 2, what


def assert_same_snapshot(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k


@pytest.fixture(scope="module")
def jmesh():
    return jmake_mesh(8)  # (2, 4): conftest forces 8 virtual CPU devices


@pytest.fixture(scope="module")
def mesh():
    return ts.make_mesh(device="cpu")


@pytest.fixture(scope="module")
def jax_two(jmesh):
    """One JAX service of two streams (default params) built once per
    module and run through every sequence the two-stream cases hold the
    port to, each from the fresh state (``restore(None)``, the cold reset,
    between them): their outputs, and the snapshot after one submit."""
    jsvc = JService(_params("jax"), streams=2, mesh=jmesh, beams=128)
    one_two, three_four = [_scan(1), _scan(2)], [_scan(3), _scan(4)]
    runs = {"submit": jsvc.submit(one_two),
            "snapshot": {k: np.array(v) for k, v in jsvc.snapshot().items()}}
    jsvc.restore(None)
    jsvc.submit(one_two)
    jsvc.restore(None)
    runs["submit_after_reset"] = jsvc.submit(three_four)
    jsvc.restore(None)
    runs["local"] = [jsvc.submit_local([_scan(2 * k), _scan(2 * k + 1)]) for k in range(4)]
    jsvc.restore(None)
    runs["local2"] = [jsvc.submit_local(one_two), jsvc.submit_local(three_four)]
    return runs


def pair(jmesh, mesh, streams: int, beams: int = 128, **kw):
    """(JAX service, port service) over the same params."""
    over = {k: v for k, v in kw.items() if k not in ("capacity",)}
    cap = {"capacity": kw["capacity"]} if "capacity" in kw else {}
    return (JService(_params("jax", **over), streams=streams, mesh=jmesh, beams=beams, **cap),
            ShardedFilterService(_params(**over), streams=streams, mesh=mesh, beams=beams, **cap))


class TestService:
    def test_matches_jax_service_and_single_stream_chain(self, jmesh, mesh):
        jsvc, svc = pair(jmesh, mesh, 4)
        chains = [ScanFilterChain(_params(), beams=128) for _ in range(4)]
        for tick in range(6):
            scans = [_scan(100 * s + tick) for s in range(4)]
            outs, jouts = svc.submit(scans), jsvc.submit(scans)
            for s in range(4):
                ref = chains[s].process_raw(scans[s]["angle_q14"], scans[s]["dist_q2"],
                                            scans[s]["quality"])
                assert_same_output(jouts[s], outs[s], f"tick {tick} stream {s}")
                np.testing.assert_array_equal(outs[s].ranges, ref.ranges)
                np.testing.assert_array_equal(outs[s].voxel, ref.voxel)
        assert_same_snapshot(svc.snapshot(), jsvc.snapshot())

    def test_inc_median_backend_matches_jax(self, jmesh, mesh):
        jsvc, svc = pair(jmesh, mesh, 2, median_backend="inc")
        assert svc.cfg.median_backend == "inc_xla" and svc._state.median_sorted is not None
        for tick in range(7):
            scans = [_scan(tick), None if tick % 3 == 1 else _scan(50 + tick)]
            for s, (j, t) in enumerate(zip(jsvc.submit(scans), svc.submit(scans))):
                assert_same_output(j, t, f"tick {tick} stream {s}")
        np.testing.assert_array_equal(svc._state.median_sorted.numpy(),
                                      np.sort(svc.snapshot()["range_window"], axis=1))

    def test_idle_stream_returns_none_but_advances(self, mesh):
        svc = ShardedFilterService(_params(), streams=2, mesh=mesh, beams=128)
        outs = svc.submit([_scan(1), None])
        assert outs[0] is not None and outs[1] is None
        snap = svc.snapshot()
        assert snap["cursor"][0] == snap["cursor"][1] == 1

    def test_wrong_stream_count_rejected(self, mesh):
        svc = ShardedFilterService(_params(), streams=2, mesh=mesh, beams=128)
        with pytest.raises(ValueError):
            svc.submit([_scan(1)])

    def test_capacity_overflow_rejected(self, mesh):
        svc = ShardedFilterService(_params(), streams=2, mesh=mesh, beams=128, capacity=256)
        with pytest.raises(ValueError, match="stream 0"):
            svc.submit([_scan(1, points=300), None])

    def test_precompile_leaves_the_fresh_state_untouched(self, jmesh, mesh):
        jsvc, svc = pair(jmesh, mesh, 2)
        fresh = svc.snapshot()
        svc.precompile()
        jsvc.precompile()
        assert_same_snapshot(svc.snapshot(), fresh)
        assert_same_snapshot(svc.snapshot(), jsvc.snapshot())
        svc.submit([_scan(1), _scan(2)])
        svc.precompile()  # a state that absorbed scans skips the warmup
        assert svc.snapshot()["filled"].tolist() == [1, 1]

    def test_snapshot_restore_across_packages(self, jmesh, mesh):
        """JAX -> port (under another median backend: the sorted window
        is recomputed) -> JAX, each continued byte-equal."""
        jsvc, svc = pair(jmesh, mesh, 2)
        for k in range(3):
            scans = [_scan(k), _scan(10 + k)]
            jsvc.submit(scans)
            svc.submit(scans)
        jsnap = {k: np.array(v) for k, v in jsvc.snapshot().items()}
        assert_same_snapshot(svc.snapshot(), jsnap)
        port = ShardedFilterService(_params(median_backend="inc"), streams=2, mesh=mesh,
                                    beams=128)
        assert port.restore(jsnap)
        jsnap["range_window"][:] = 0.0  # the restore copied what it uploaded
        assert np.isinf(port.snapshot()["range_window"]).any()
        for k in range(3, 6):
            scans = [_scan(k), None if k == 4 else _scan(10 + k)]
            for j, t in zip(jsvc.submit(scans), port.submit(scans)):
                assert_same_output(j, t, f"continued tick {k}")
        back = JService(_params("jax"), streams=2, mesh=jmesh, beams=128)
        assert back.restore(port.snapshot())
        scans = [_scan(7), _scan(8)]
        for j, t in zip(back.submit(scans), port.submit(scans)):
            assert_same_output(j, t, "back in JAX")

    def test_restore_rejects_wrong_geometry(self, jax_two, mesh):
        jsnap = jax_two["snapshot"]
        other = ShardedFilterService(_params(filter_window=8), streams=2, mesh=mesh, beams=128)
        before = other.snapshot()
        assert not other.restore(jsnap)
        assert_same_snapshot(other.snapshot(), before)
        assert not ShardedFilterService(_params(), streams=3, mesh=mesh,
                                        beams=128).restore(jsnap)
        assert not other.restore(None)  # a cold reset is not a restore

    def test_submit_pipelined_is_submit_shifted_by_one_tick(self):
        """The pipelined tick returns submit's outputs one tick late
        (all-None first), flush drains the final tick, and idle slots
        follow each tick's OWN live mask; mesh=None picks the service's
        own mesh on the filter_backend's device."""
        svc_p = ShardedFilterService(_params(), streams=4, beams=128)
        jsvc = JService(_params("jax"), streams=4, mesh=None, beams=128)
        assert svc_p.mesh.shape == {"stream": 1, "beam": 1} and svc_p.device.type == "cpu"
        ticks = [
            [_scan(1), None, _scan(3), _scan(4)],
            [None, _scan(5), _scan(6), None],
            [_scan(7), _scan(8), None, _scan(9)],
        ]
        outs_s = [jsvc.submit(t) for t in ticks]
        outs_p = [svc_p.submit_pipelined(t) for t in ticks]
        assert outs_p[0] == [None, None, None, None]
        for k in range(1, len(ticks)):
            for a, b in zip(outs_p[k], outs_s[k - 1]):
                assert_same_output(b, a, f"tick {k}")
        tail = svc_p.flush_pipelined()
        for a, b in zip(tail, outs_s[-1]):
            assert_same_output(b, a, "flush")
        assert svc_p.flush_pipelined() is None

    def test_submit_pipelined_restore_clears_pending(self, mesh):
        svc = ShardedFilterService(_params(), streams=2, mesh=mesh, beams=128)
        svc.submit_pipelined([_scan(1), _scan(2)])
        svc.restore(None)
        assert svc.flush_pipelined() is None

    def test_submit_pipelined_restore_drops_next_tick_output(self, jax_two, mesh):
        svc = ShardedFilterService(_params(), streams=2, mesh=mesh, beams=128)
        svc.submit_pipelined([_scan(1), _scan(2)])
        svc.restore(None)
        assert svc.submit_pipelined([_scan(3), _scan(4)]) == [None, None]
        ref_out = jax_two["submit_after_reset"]
        out = svc.submit_pipelined([_scan(5), _scan(6)])
        assert_same_output(ref_out[0], out[0])

    def test_submit_pipelined_dispatch_failure_keeps_pending(self, jax_two, mesh):
        svc = ShardedFilterService(_params(), streams=2, mesh=mesh, beams=128)
        svc.submit_pipelined([_scan(1), _scan(2)])
        ref_out = jax_two["submit"]
        step, svc._step = svc._step, None  # next tick: TypeError
        with pytest.raises(TypeError):
            svc.submit_pipelined([_scan(3), _scan(4)])
        svc._step = step
        tail = svc.flush_pipelined()
        assert tail is not None
        assert_same_output(ref_out[0], tail[0])

    def test_submit_pipelined_fetch_failure_keeps_pending(self, jax_two, mesh):
        svc = ShardedFilterService(_params(), streams=2, mesh=mesh, beams=128)
        svc.submit_pipelined([_scan(1), _scan(2)])
        ref_out = jax_two["submit"]

        def boom(*a, **k):
            raise RuntimeError("fetch died")

        materialize = svc._materialize
        svc._materialize = boom
        with pytest.raises(RuntimeError):
            svc.submit_pipelined([_scan(3), _scan(4)])
        svc._materialize = materialize
        tail = svc.flush_pipelined()
        assert tail is not None
        assert_same_output(ref_out[0], tail[0])

    def test_submit_local_pipelined_matches_submit_local_shifted(self, jax_two, mesh):
        svc_p = ShardedFilterService(_params(), streams=2, mesh=mesh, beams=128)
        ticks = [[_scan(2 * k), _scan(2 * k + 1)] for k in range(4)]
        outs_s = jax_two["local"]
        outs_p = [svc_p.submit_local_pipelined(t) for t in ticks]
        assert outs_p[0] == [None, None]
        for k in range(1, len(ticks)):
            for a, b in zip(outs_p[k], outs_s[k - 1]):
                assert_same_output(b, a, f"tick {k}")
        tail = svc_p.flush_pipelined()
        for a, b in zip(tail, outs_s[-1]):
            assert_same_output(b, a, "flush")
        assert svc_p.flush_pipelined() is None

    def test_submit_local_pipelined_collect_failure_drops_not_raises(self, jax_two, mesh):
        svc = ShardedFilterService(_params(), streams=2, mesh=mesh, beams=128)
        svc.submit_local_pipelined([_scan(1), _scan(2)])

        def boom(*a, **k):
            raise RuntimeError("fetch died")

        materialize = svc._materialize
        svc._materialize = boom
        out = svc.submit_local_pipelined([_scan(3), _scan(4)])
        svc._materialize = materialize
        assert out == [None, None]  # tick 1 dropped, no exception
        ref_out2 = jax_two["local2"][1]  # the second of two submit_local ticks
        out3 = svc.submit_local_pipelined([_scan(5), _scan(6)])
        assert_same_output(ref_out2[0], out3[0])

    def test_submit_local_pipelined_dispatch_failure_keeps_collected_tick(self, jax_two, mesh):
        svc = ShardedFilterService(_params(), streams=2, mesh=mesh, beams=128)
        svc.submit_local_pipelined([_scan(1), _scan(2)])
        ref_out = jax_two["local2"][0]
        step, svc._step = svc._step, None
        with pytest.raises(TypeError):
            svc.submit_local_pipelined([_scan(3), _scan(4)])
        svc._step = step
        tail = svc.flush_pipelined()
        assert tail is not None
        assert_same_output(ref_out[0], tail[0])

    def test_submit_local_truncates_oversized_scan(self, jmesh, mesh):
        cap = 256
        jsvc, svc = pair(jmesh, mesh, 4, capacity=cap)
        big = _scan(7, points=cap + 50)
        big["ts0"] = 1.5  # scalar metadata (assembler-shaped dicts carry it)
        small_1, small_3 = _scan(1, points=200), _scan(3, points=200)
        out = svc.submit_local([big, small_1, None, small_3])
        jout = jsvc.submit_local([big, small_1, None, small_3])
        for a, b in zip(out, jout):
            assert_same_output(b, a)

    def test_submit_local_degrades_malformed_scan_to_idle(self, jmesh, mesh, caplog):
        jsvc, svc = pair(jmesh, mesh, 2)
        bad = _scan(5)
        bad["dist_q2"] = bad["dist_q2"][:-7]  # truncated capture
        good = _scan(9)
        with caplog.at_level("WARNING", logger="rplidar_tpu.service"):
            out = svc.submit_local([bad, good])
        assert any("malformed" in r.message for r in caplog.records)
        jout = jsvc.submit_local([bad, good])
        for a, b in zip(out, jout):
            assert_same_output(b, a)
        no_quality = {k: v for k, v in _scan(6).items() if k != "quality"}
        over_bad = _scan(4, points=svc.capacity + 50)
        over_bad["dist_q2"] = over_bad["dist_q2"][:-6]
        for row in ([no_quality, _scan(8)], [over_bad, _scan(10)]):
            for a, b in zip(svc.submit_local(row), jsvc.submit_local(row)):
                assert_same_output(b, a)
        assert_same_snapshot(svc.snapshot(), jsvc.snapshot())


# ---------------------------------------------------------------------------
# the byte seams at config 10's smoke geometry
# ---------------------------------------------------------------------------

# bench.py bench_fleet_ingest(smoke=True): W 8, 512 beams, 64^2 grid,
# 800 points/rev, 8 revs, capacity 1024, one revolution of frames a tick
WINDOW, BEAMS, GRID, PPR, REVS, CAP = 8, 512, 64, 800, 8, 1024
RUN = PPR // 40


def denseboost_frames(revs: int, ppr: int) -> list[bytes]:
    """bench.py ``_denseboost_wire_frames``: a 2 m +/- 0.5 m ring."""
    return scenes.wire_frames(revs, ppr)


def byte_ticks(n: int, idle=()) -> list:
    """bench.py ``make_ticks``: per tick one revolution of frames per
    stream on its own timestamp lane; (tick, stream) pairs in ``idle``
    deliver nothing."""
    frames = denseboost_frames(REVS, PPR)
    t = [1000.0 + 7.0 * s for s in range(n)]
    ticks = []
    for k, i in enumerate(range(0, len(frames), RUN)):
        tick = []
        for s in range(n):
            batch = []
            for f in frames[i : i + RUN]:
                t[s] += 1.25e-3
                batch.append((f, t[s]))
            tick.append(None if (k, s) in idle else (DENSE, batch))
        ticks.append(tick)
    return ticks


def byte_params(pkg: str, backend: str, **over):
    return _params(pkg, **{**dict(filter_window=WINDOW, voxel_grid_size=GRID, voxel_cell_m=0.25,
                                  fleet_ingest_backend=backend, median_backend="xla"), **over})


def byte_pair(backend: str, n: int, **over):
    kw = dict(beams=BEAMS, capacity=CAP)
    if backend == "fused":
        kw["fleet_ingest_buckets"] = (RUN,)
    return (JService(byte_params("jax", backend, **over), n, mesh=jmake_mesh(1), **kw),
            ShardedFilterService(byte_params("torch", backend, **over), n, **kw))


@pytest.mark.parametrize("pipelined", [False, True])
@pytest.mark.parametrize("backend", ["host", "fused"])
def test_submit_bytes_matches_jax(backend, pipelined):
    """N = 2 streams, stream 1 idle on two ticks: the lockstep host tick
    (one batched step a tick) and the fused engine, each against the JAX
    service's same arm."""
    jsvc, svc = byte_pair(backend, 2)
    assert svc.fleet_ingest_backend == backend
    published = 0
    for k, tick in enumerate(byte_ticks(2, idle={(2, 1), (5, 1)})):
        outs = svc.submit_bytes(tick, pipelined=pipelined)
        jouts = jsvc.submit_bytes(tick, pipelined=pipelined)
        for s, (j, t) in enumerate(zip(jouts, outs)):
            assert_same_output(j, t, f"tick {k} stream {s}")
            published += t is not None
    assert published >= 8
    if backend == "fused":
        assert svc.fleet_ingest.dispatch_count == jsvc.fleet_ingest.dispatch_count
        assert type(svc.fleet_ingest.staging).__name__ == "StagingPool"
        for s, (j, t) in enumerate(zip(jsvc.fleet_ingest.flush(), svc.fleet_ingest.flush())):
            assert len(j) == len(t)
    elif pipelined:
        for j, t in zip(jsvc.flush_pipelined(), svc.flush_pipelined()):
            assert_same_output(j, t, "flush")
    else:
        assert_same_snapshot(svc.snapshot(), jsvc.snapshot())


@pytest.mark.parametrize("backend", ["host", "fused"])
def test_submit_bytes_backlog_matches_jax(backend):
    """A backlog of the config-10 ticks drained in one call (super-steps
    of 4 on the fused arm), against the JAX service's same arm."""
    jsvc, svc = byte_pair(backend, 2, super_tick_max=4)
    ticks = byte_ticks(2, idle={(3, 0)})
    outs, jouts = svc.submit_bytes_backlog(ticks[:6]), jsvc.submit_bytes_backlog(ticks[:6])
    more, jmore = svc.submit_bytes_backlog(ticks[6:]), jsvc.submit_bytes_backlog(ticks[6:])
    for s in range(2):
        assert len(outs[s]) == len(jouts[s]) > 0 and len(more[s]) == len(jmore[s])
        for k, (j, t) in enumerate(zip(jouts[s] + jmore[s], outs[s] + more[s])):
            assert_same_output(j, t, f"stream {s} rev {k}")
    if backend == "fused":
        assert svc.fleet_ingest.super_dispatches == jsvc.fleet_ingest.super_dispatches > 0
    else:
        assert_same_snapshot(svc.snapshot(), jsvc.snapshot())
        with pytest.raises(ValueError, match="fused"):
            svc.submit_bytes_backlog(ticks[:1], rung=2)


def test_fleet_ingest_snapshot_across_packages():
    """FleetFusedIngest snapshots: JAX -> port -> JAX, each continued
    byte-equal against the engine it came from; mismatched snapshots are
    rejected with the state untouched."""
    over = dict(beams=BEAMS, capacity=CAP, buckets=(RUN,))
    jeng = jdi.FleetFusedIngest(byte_params("jax", "fused"), 2, **over)
    ticks = byte_ticks(2, idle={(1, 1)})
    for tick in ticks[:3]:
        jeng.submit(tick)
    jsnap = jeng.snapshot()
    mesh = ts.make_mesh(device="cpu")
    eng = tdi.FleetFusedIngest(byte_params("torch", "fused"), 2, mesh=mesh, **over)
    assert eng.device == mesh.device
    assert eng.restore(jsnap)
    assert_same_snapshot(eng.snapshot(), jsnap)
    for k, tick in enumerate(ticks[3:6]):
        for s, (j, t) in enumerate(zip(jeng.submit(tick), eng.submit(tick))):
            assert len(j) == len(t)
            for (jo, jts, _jd), (to, tts, _td) in zip(j, t):
                assert_same_output(jo, to, f"tick {k} stream {s}")
                assert jts == tts
    back = jdi.FleetFusedIngest(byte_params("jax", "fused"), 2, **over)
    assert back.restore(eng.snapshot())
    for tick in ticks[6:]:
        for j, t in zip(back.submit(tick), eng.submit(tick)):
            assert len(j) == len(t)
            for (jo, _a, _b), (to, _c, _d) in zip(j, t):
                assert_same_output(jo, to)
    before = eng.snapshot()
    three = jdi.FleetFusedIngest(byte_params("jax", "fused"), 3, **over).snapshot()
    deskew = jdi.FleetFusedIngest(byte_params("jax", "fused", deskew_enable=True), 2,
                                  **over).snapshot()
    narrow = jdi.FleetFusedIngest(byte_params("jax", "fused", filter_window=4), 2,
                                  **over).snapshot()
    for bad in (three, deskew, narrow, {"formats": before["formats"]}, {}):
        assert not eng.restore(bad)
    assert_same_snapshot(eng.snapshot(), before)


# ---------------------------------------------------------------------------
# the SLAM seams on config 12's room
# ---------------------------------------------------------------------------

SLAM = dict(filter_window=2, voxel_grid_size=32, map_enable=True, map_grid=64,
            map_cell_m=0.1, map_match_window=0.4, loop_enable=True, loop_submap_revs=2,
            loop_check_revs=2, loop_max_submaps=6, pose_graph_iters=64,
            world_map_enable=True, world_tile_cells=8, world_max_submaps=4,
            world_merge_revs=2)
SLAM_BEAMS = 512


def room_scan(s: int, k: int, beams: int = SLAM_BEAMS) -> dict:
    """One revolution of bench.py's config-12 room (a 5 x 5 m square seen
    from per-stream drifting poses), as wire nodes at the beam centres."""
    return scenes.room_scan(s, k, beams)


def _same_pose(j, t, what):
    assert (j is None) == (t is None), what
    if j is not None:
        assert dataclasses.asdict(j).keys() == dataclasses.asdict(t).keys()
        np.testing.assert_array_equal(t.pose_q, np.asarray(j.pose_q), what)
        assert (t.score, t.matched_points, t.revision) == (j.score, j.matched_points,
                                                          j.revision), what


def _same_loop(j, t, what):
    assert (j is None) == (t is None), what
    if j is not None:
        for f in dataclasses.fields(j):
            np.testing.assert_array_equal(np.asarray(getattr(t, f.name)),
                                          np.asarray(getattr(j, f.name)), f"{what} {f.name}")


SLAM_STREAMS, SLAM_TICKS = 2, 12


def slam_scans(k: int) -> list:
    return [room_scan(s, k) if not (s == 1 and k == 5) else None for s in range(SLAM_STREAMS)]


@pytest.fixture(scope="module")
def jax_slam(jmesh) -> dict:
    """The JAX service (host backends) on its (2, 4) mesh with the mapper,
    loop closure and world map attached, over the 12 room ticks, once per
    module for both of the port's loop backends: per tick the outputs,
    poses, loop statuses and corrected poses; then the world accumulation,
    the world and loop statuses and the loop engine's installs."""
    jsvc = JService(_params("jax", **SLAM, map_backend="host", loop_backend="host"),
                    SLAM_STREAMS, mesh=jmesh, beams=SLAM_BEAMS)
    jsvc.attach_mapper()
    jsvc.attach_loop_closure()
    jsvc.attach_world_map()
    ticks = []
    for k in range(SLAM_TICKS):
        outs = jsvc.submit(slam_scans(k))
        ticks.append((outs, list(jsvc.last_poses), list(jsvc.last_loop),
                      [None if c is None else np.array(c) for c in jsvc.last_corrected_poses]))
    return {"ticks": ticks, "acc": np.array(jsvc.world._acc), "world": jsvc.world_status(),
            "submaps": jsvc.loop_status()["submaps"], "installs": jsvc.loop.installs}


@pytest.mark.parametrize("loop_backend", ["host", "fused"])
def test_slam_seams_match_jax(loop_backend, jax_slam):
    """attach_mapper + attach_loop_closure + attach_world_map on the
    service: poses, loop statuses, corrected poses and the world
    accumulation byte-equal to the JAX service's (host backends there;
    the port's fused loop arm runs its plain PyTorch ops on the CPU)."""
    streams = SLAM_STREAMS
    jrun = jax_slam
    svc = ShardedFilterService(_params(**SLAM, map_backend="host", loop_backend=loop_backend),
                               streams, beams=SLAM_BEAMS)
    svc.attach_mapper()
    svc.attach_loop_closure()
    svc.attach_world_map()
    assert svc.loop.backend == loop_backend and svc.loop.on_install == svc._world_install
    checks = 0
    for k, (jouts, jposes, jloops, jcorrected) in enumerate(jrun["ticks"]):
        for j, t in zip(jouts, svc.submit(slam_scans(k))):
            assert_same_output(j, t, f"tick {k}")
        for i in range(streams):
            _same_pose(jposes[i], svc.last_poses[i], f"tick {k} pose {i}")
            _same_loop(jloops[i], svc.last_loop[i], f"tick {k} loop {i}")
            checks += svc.last_loop[i] is not None
            jc, tc = jcorrected[i], svc.last_corrected_poses[i]
            assert (jc is None) == (tc is None)
            if tc is not None:
                np.testing.assert_array_equal(tc, jc)
    assert checks > 0 and svc.loop.installs == jrun["installs"] > 0
    np.testing.assert_array_equal(svc.world.accumulation(), jrun["acc"])
    js, tst = jrun["world"], svc.world_status()
    assert {k: tst[k] for k in ("merges", "evictions")} == {k: js[k] for k in ("merges",
                                                                              "evictions")}
    assert svc.loop_status()["submaps"] == jrun["submaps"]


def test_world_map_without_a_loop_engine_pulls_row_snapshots(jmesh):
    """Without a loop engine the world merges each stream's map row at its
    world_merge_revs cadence, as the JAX service does."""
    slam = {k: v for k, v in SLAM.items() if not k.startswith(("loop", "pose_graph"))}
    jsvc = JService(_params("jax", **slam, map_backend="host"), 2, mesh=jmesh,
                    beams=SLAM_BEAMS)
    svc = ShardedFilterService(_params(**slam, map_backend="fused"), 2, beams=SLAM_BEAMS)
    for s in (jsvc, svc):
        s.attach_world_map()  # attaches the mapper first
    assert svc.mapper.backend == "fused" and svc.loop is None
    for k in range(7):
        scans = [room_scan(0, k), room_scan(1, k)]
        jsvc.submit_pipelined(scans)
        svc.submit_pipelined(scans)
        for i in range(2):
            _same_pose(jsvc.last_poses[i], svc.last_poses[i], f"tick {k} pose {i}")
    jsvc.flush_pipelined()
    svc.flush_pipelined()
    assert svc.world.status()["merges"] == jsvc.world.status()["merges"] > 0
    np.testing.assert_array_equal(svc.world.accumulation(), np.asarray(jsvc.world._acc))


# ---------------------------------------------------------------------------
# replay_fleet and the CLI
# ---------------------------------------------------------------------------


def _revs(seed: int, n: int) -> list[dict]:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        pts = int(rng.integers(200, 400))
        out.append({
            "angle_q14": np.sort(rng.integers(0, 1 << 16, pts)).astype(np.int32),
            "dist_q2": rng.integers(0, 40_000, pts).astype(np.int32),
            "quality": rng.integers(0, 256, pts).astype(np.int32),
        })
    return out


REPLAY_STATE = ("range_window", "inten_window", "hit_window", "voxel_acc", "cursor", "filled")


def replay_captures() -> list:
    """Three captures of unequal length."""
    return [_revs(1, 11), _revs(2, 9), _revs(3, 14)]


@pytest.fixture(scope="module")
def jax_replay() -> tuple:
    """JAX's sharded replay of the three captures on its own default mesh,
    once per module for both of the port's median backends (JAX's
    ``xla``): the ranges and the final state's fields."""
    jr, jstate = jreplay.replay_fleet(replay_captures(), _params("jax", median_backend="xla"),
                                      beams=256, capacity=512, chunk=4)
    return np.asarray(jr), {k: np.asarray(getattr(jstate, k)) for k in REPLAY_STATE}


@pytest.mark.parametrize("median", ["pallas", "inc"])
def test_replay_fleet_matches_jax(median, jax_replay):
    """Three captures of unequal length (truncated to the shortest),
    chunks of 4: ranges and the final state bit-exact against JAX's
    sharded replay on its own default mesh."""
    jr, jstate = jax_replay
    tr, tstate = treplay.replay_fleet(replay_captures(), _params(median_backend=median),
                                      beams=256, capacity=512, chunk=4)
    assert tr.shape == (3, 9, 256)
    np.testing.assert_array_equal(tr, jr)
    for name in REPLAY_STATE:
        np.testing.assert_array_equal(getattr(tstate, name).numpy(), jstate[name], name)
    empty, none = treplay.replay_fleet([], _params(), beams=256)
    assert empty.shape == (0, 0, 256) and none is None


def test_cli_replay_chain_of_several_captures_prints_the_jax_lines(tmp_path, capsys):
    from rplidar_ros2_driver_tpu.__main__ import main as jmain

    a = write_capture(tmp_path / "a.rplr", dense_frames(3, 4))
    b = write_capture(tmp_path / "b.rplr", dense_frames(4, 6))
    assert jmain(["replay", a, b, "--chain", "--cpu"]) == 0
    jout = capsys.readouterr().out
    assert main(["replay", a, b, "--chain", "--cpu"]) == 0
    out = capsys.readouterr().out

    def stable(text):
        # the timing fields of the chain line differ run to run
        return [re.sub(r" in [0-9.]+ s \([0-9]+ scans/s\)", "", line)
                for line in text.splitlines()]

    assert stable(out) == stable(jout)
    assert "note: recordings differ in length" in out
    assert "through the sharded fleet replay (2 streams)" in out


def test_unported_surfaces_raise_naming_their_roadmap_items(mesh, tmp_path):
    """Every surface of the service is ported: the sharded checkpoints
    (utils/checkpoint_sharded.py) save and restore through the abstract
    template (tests/test_torch_checkpoint_sharded.py holds them to JAX's
    cases); de-skew still needs the fused ingest."""
    svc = ShardedFilterService(_params(), streams=2, mesh=mesh, beams=128)
    svc.submit([_scan(1), _scan(2)])
    svc.save_sharded(str(tmp_path / "ckpt"))
    fresh = ShardedFilterService(_params(), streams=2, mesh=mesh, beams=128)
    assert fresh.load_sharded(str(tmp_path / "ckpt"))
    assert_same_snapshot(fresh.snapshot(), svc.snapshot())
    assert not fresh.load_sharded(str(tmp_path / "absent"))
    with pytest.raises(ValueError, match="deskew_enable requires the fused"):
        ShardedFilterService(_params(deskew_enable=True), streams=2, mesh=mesh,
                             beams=128).submit_bytes([None, None])


def _dense_tick(t0: float, k: int, streams: int = 2) -> list:
    """One byte tick of ``k`` dense-capsule frames a stream (the payloads of
    a 400-point ring, each stream on its own stamp lane)."""
    from rplidar_ros2_driver_tpu_torch.ops import wire as twire
    from rplidar_ros2_driver_tpu_torch.protocol.constants import Ans

    frames = [twire.encode_dense_capsule(int(360.0 * (40 * f % 400) / 400 * 64) & 0x7FFF,
                                         f == 0, np.full(40, 2000, int)) for f in range(k)]
    return [(int(Ans.MEASUREMENT_DENSE_CAPSULED),
             [(fr, t0 + 7.0 * s + 1.25e-3 * f) for f, fr in enumerate(frames)])
            for s in range(streams)]


@pytest.mark.parametrize("surface", ["attach_scheduler", "offer_bytes", "drain_scheduled",
                                     "scheduler_status", "submit_bytes_backlog_rung"])
def test_scheduled_seam_is_served(mesh, surface):
    """The scheduled seam (ROADMAP A.10b) is served: the shaper attaches over
    the fused engine, admission queues what is offered, a drain empties
    them at the shaper's rung, the status carries the engine's counters,
    and a backlog drains at an explicit warmed rung."""
    from rplidar_ros2_driver_tpu_torch.parallel.scheduler import TrafficShaper

    svc = ShardedFilterService(_params(fleet_ingest_backend="fused", sched_rungs=(1, 2, 4),
                                       super_tick_max=4),
                               streams=2, mesh=mesh, beams=128, fleet_ingest_buckets=(4,))
    if surface == "submit_bytes_backlog_rung":
        # the engine's own ladder: 1 and super_tick_max
        outs = svc.submit_bytes_backlog([_dense_tick(10.0 + k, 4) for k in range(3)], rung=4)
        assert len(outs) == 2 and svc.fleet_ingest.rung_dispatches[4] == 1
        with pytest.raises(ValueError, match="not a warmed rung"):
            svc.submit_bytes_backlog([_dense_tick(20.0, 4)], rung=3)
        return
    shaper = svc.attach_scheduler()
    assert isinstance(shaper, TrafficShaper) and svc.scheduler is shaper
    assert svc.fleet_ingest.rungs == (1, 2, 4)
    if surface == "attach_scheduler":
        with pytest.raises(ValueError, match="streams"):
            svc.attach_scheduler(TrafficShaper(3, shaper.cfg))
        return
    svc.offer_bytes([[_dense_tick(10.0 + k, 4)[i] for k in range(3)] for i in range(2)])
    if surface == "offer_bytes":
        assert shaper.backlog_depths() == [3, 3] and svc.fleet_ingest.dispatch_count == 0
        return
    outs = svc.drain_scheduled()
    if surface == "drain_scheduled":
        assert len(outs) == 2 and shaper.backlog_depths() == [0, 0]
        assert svc.fleet_ingest.rung_dispatches == {1: 0, 2: 0, 4: 1}
        return
    st = svc.scheduler_status()
    assert st["backlog"] == [0, 0] and st["rung_dispatches"] == {1: 0, 2: 0, 4: 1}
    assert st["rung_bucket_dispatches"] == {"T4xM4": 1} and st["staging_overlap_hits"] == 0

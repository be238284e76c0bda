"""The fused fleet ingest over a mesh's stream rows, on the CPU.

The JAX package places ``FleetFusedIngest``'s state ``P("stream", None,
...)`` on the service's mesh: on the suite's eight forced devices the
default (2, 4) mesh splits the fleet's streams between two rows.  The port
holds row ``r``'s streams on the row's lead block, computed once
(parallel/sharding.fleet_rows), on ``make_mesh(devices=[cpu] * 8,
stream=2)`` and ``stream=4`` here.  Each case runs the port's rows against
the JAX service or engine on its matching mesh (``jmake_mesh(8)`` and
``jmake_mesh(8, stream=4)``, or the default (2, 4) where one JAX run serves
both row meshes) and against the port's own one-row engine (the de-skew
arm without a map against the one row; the carried route, de-skew in it,
against JAX too):

  * the byte seam, pipelined and not, with idle, straggler and silent
    streams; a ``max_revs`` overflow that drops the same revolutions;
  * the de-skew arm and the carried-map route (ranges, map wires, recons,
    the map snapshot and per-stream rows);
  * a T = 8 ``drain_scheduled`` at a rung and a backlog with
    ``overlap_work``;
  * a health quarantine -> rejoin of a stream on row 1 of (2, 4);
  * ``cold_reset``; snapshots across (2, 4) -> (1, 1) -> (4, 2) and JAX's
    restored onto rows; the engine's ``save_sharded``/``load_sharded``
    across mesh shapes;
  * the placement (each row's lanes on its lead block) and the counters
    (``dispatch_count``/``h2d_transfers`` equal to JAX's).

Every output is bit-exact except ``points_xy``, within 2 ulp (ROADMAP
C.1).  Revolution stamps (``ts0``, durations) and the snapshots' stamp
planes (``bases``, ``ingest.partial_ts``) are exact against JAX's, except
the f32 offsets of the scheduled drain's super-step: 1 ulp at the plane's
magnitude (ROADMAP C.5, ``assert_snapshot_like_jax``).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from rplidar_ros2_driver_tpu.driver import ingest as jdi
from rplidar_ros2_driver_tpu.parallel.service import ShardedFilterService as JService
from rplidar_ros2_driver_tpu.parallel.sharding import make_mesh as jmake_mesh
from rplidar_ros2_driver_tpu_torch.driver import ingest as tdi
from rplidar_ros2_driver_tpu_torch.driver.chaos import ChaosConfig, chaos_ticks
from rplidar_ros2_driver_tpu_torch.parallel import sharding as ts
from rplidar_ros2_driver_tpu_torch.parallel.service import ShardedFilterService
from rplidar_ros2_driver_tpu_torch.utils import rowops

import test_torch_fused_mapping as fm
from test_torch_health import _fleet_ticks, _health
from test_torch_sharded_service import (
    BEAMS,
    CAP,
    DENSE,
    PPR,
    RUN,
    assert_same_output,
    assert_same_snapshot,
    byte_params,
    denseboost_frames,
    ulp_distance,
)
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

CPU = torch.device("cpu")
N = 8                            # streams of the byte cases: rows of 4 or 2
ROWS = {"2x4": 2, "4x2": 4}      # mesh name -> stream extent over eight blocks
# the byte cases' buckets: one revolution, and 64 frames (a burst of more
# than two revolutions in one slice); one set, so the JAX engines of the
# byte cases share their compiled steps
BUCKETS = (RUN, 64)


def rows_mesh(stream: int) -> ts.Mesh:
    return ts.make_mesh(devices=[CPU] * 8, stream=stream)


def one_mesh() -> ts.Mesh:
    return ts.make_mesh(device=CPU)


def ticks_of(streams: int, revs: int, *, idle=(), silent=(), straggle=None, bursts=None,
             t0: float = 1000.0) -> list:
    """One revolution of frames a stream a tick, each stream on its own
    stamp lane.  ``idle`` (tick, stream) pairs deliver nothing; ``silent``
    streams never stream; ``straggle`` = (stream, tick): that tick's frames
    arrive with the next tick's; ``bursts`` maps (tick, stream) to a frame
    count taken from the stream's queue that tick (its later ticks shift)."""
    frames = denseboost_frames(revs, PPR)
    t = [t0 + 7.0 * s for s in range(streams)]
    pos = [0] * streams
    bursts = bursts or {}
    ticks = []
    for k in range(revs):
        tick = []
        for s in range(streams):
            n = bursts.get((k, s), RUN)
            if s in silent or straggle == (s, k):
                n = 0
            elif (k, s) in idle:
                # the tick's frames are lost on the way
                pos[s] += RUN
                t[s] += RUN * 1.25e-3
                n = 0
            elif straggle == (s, k - 1):
                n = 2 * RUN
            batch = []
            for f in frames[pos[s]: pos[s] + n]:
                t[s] += 1.25e-3
                batch.append((f, t[s]))
            pos[s] += n
            tick.append((DENSE, batch) if batch else None)
        ticks.append(tick)
    return ticks


def fused_service(pkg: str, streams: int, stream_rows: int, **over):
    """The fused byte service at config 10's smoke geometry: JAX's on its
    ``(stream_rows, 8 / stream_rows)`` mesh, the port's on blocks of the
    same shape (``stream_rows`` 0: the port's one-row (1, 1) mesh)."""
    kw = dict(beams=BEAMS, capacity=CAP, fleet_ingest_buckets=BUCKETS)
    if pkg == "jax":
        return JService(byte_params("jax", "fused", **over), streams,
                        mesh=jmake_mesh(8, stream=stream_rows), **kw)
    mesh = rows_mesh(stream_rows) if stream_rows else one_mesh()
    return ShardedFilterService(byte_params("torch", "fused", **over), streams, mesh=mesh, **kw)


def _engine(pkg: str, mesh):
    """The fused engine of the byte cases, JAX's or the port's, on ``mesh``."""
    mod = jdi if pkg == "jax" else tdi
    return mod.FleetFusedIngest(byte_params(pkg, "fused"), N, mesh=mesh, beams=BEAMS,
                                capacity=CAP, buckets=BUCKETS)


def assert_rows_placed(eng, stream_rows: int) -> None:
    """Each row's state holds exactly its lanes, on its lead block."""
    per = eng.streams // stream_rows
    assert [(r.block, r.lanes) for r in eng.rows] == [
        ((i, 0), slice(i * per, (i + 1) * per)) for i in range(stream_rows)]
    assert len(eng._states) == stream_rows
    for row, st in zip(eng.rows, eng._states):
        for v in (st.partial, st.filter.range_window, st.filter.voxel_acc):
            assert v.shape[0] == per and v.device == row.device


def assert_within_plane_ulps(got, want, ulps: int, what: str) -> None:
    """``got`` within ``ulps`` units in the last place of the plane's
    largest magnitude of ``want``: the unit of an offset re-based across
    steps, which keeps its absolute error wherever it passes near 0."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, what
    unit = np.spacing(np.max(np.abs(want)).astype(want.dtype)) if want.size else 0
    assert np.all(np.abs(got.astype(np.float64) - want) <= ulps * np.float64(unit)), what


def assert_snapshot_like_jax(got: dict, want: dict, partial_ts_ulps: int = 0) -> None:
    """Every plane of ``got`` byte-equal to JAX's, stamps included; with
    ``partial_ts_ulps`` the f32 offsets ``ingest.partial_ts`` within that
    many ulp at the plane's magnitude."""
    assert set(got) == set(want)
    for k, w in want.items():
        w = np.asarray(w)
        assert got[k].dtype == w.dtype, k
        if partial_ts_ulps and k == "ingest.partial_ts":
            assert_within_plane_ulps(got[k], w, partial_ts_ulps, k)
        else:
            np.testing.assert_array_equal(got[k], w, err_msg=k)


def same_revs(got: list, want: list, what: str) -> None:
    """Per-stream ``[(FilterOutput, ts0, duration), ...]`` lists, stamps
    exact."""
    assert len(got) == len(want), what
    for s, (g, w) in enumerate(zip(got, want)):
        assert len(g) == len(w), f"{what} stream {s}: {len(g)} != {len(w)}"
        for k, ((go, gts, gd), (wo, wts, wd)) in enumerate(zip(g, w)):
            assert_same_output(wo, go, f"{what} stream {s} rev {k}")
            assert gts == wts and gd == wd, (what, s, k, gts - wts, gd - wd)


# ---------------------------------------------------------------------------
# the placement
# ---------------------------------------------------------------------------


def test_fleet_rows_and_the_row_state_round_trip():
    rows = ts.fleet_rows(rows_mesh(2), 8)
    assert [(r.block, r.device, r.lanes) for r in rows] == [
        ((0, 0), CPU, slice(0, 4)), ((1, 0), CPU, slice(4, 8))]
    assert [r.lanes for r in ts.fleet_rows(rows_mesh(4), 8)] == [
        slice(2 * i, 2 * i + 2) for i in range(4)]
    # one block, a (1, C) mesh and one block's view: one row, all streams
    for mesh in (one_mesh(), rows_mesh(1), rows_mesh(2).blocks[5]):
        assert ts.fleet_rows(mesh, 3) == [ts.FleetRow((0, 0), CPU, slice(0, 3))]
    with pytest.raises(ValueError, match="streams=3 not divisible by stream axis 2"):
        ts.fleet_rows(rows_mesh(2), 3)
    with pytest.raises(ValueError, match="not divisible by stream axis 4"):
        tdi.FleetFusedIngest(byte_params("torch", "fused"), 6, mesh=rows_mesh(4),
                             beams=BEAMS, capacity=CAP)
    assert [rowops.lane_of(rows, i) for i in (0, 3, 4, 7)] == [(0, 0), (0, 3), (1, 0), (1, 3)]
    # a global state split onto the rows and gathered back, in stream order
    eng = tdi.FleetFusedIngest(byte_params("torch", "fused", deskew_enable=True), 8,
                               mesh=rows_mesh(4), beams=BEAMS, capacity=CAP)
    assert_rows_placed(eng, 4)
    gen = torch.Generator().manual_seed(5)
    whole = rowops.map_state(ts.gather_fleet_ingest_state(eng._states),
                             lambda v: torch.randint(0, 100, v.shape, generator=gen).to(v.dtype))
    placed = ts.place_fleet_ingest_state(rows_mesh(2), whole)
    assert [st.partial.shape[0] for st in placed] == [4, 4]
    back = ts.gather_fleet_ingest_state(placed)
    rowops.zip_states([whole, back], lambda vs: np.testing.assert_array_equal(vs[0], vs[1]))


# ---------------------------------------------------------------------------
# the byte seam
# ---------------------------------------------------------------------------

BYTE_TICKS = dict(idle={(2, 1), (5, 3), (4, 7)}, silent=(5,), straggle=(6, 3))


@pytest.mark.parametrize("pipelined", [False, True])
@pytest.mark.parametrize("mesh_name", list(ROWS))
def test_submit_bytes_on_rows_matches_jax_and_one_row(mesh_name, pipelined):
    """Config 10's fused byte seam, eight streams: stream 5 silent, idle
    ticks on three streams, stream 6's tick 3 arriving with tick 4 (a
    larger bucket that tick).  Every output equals JAX's service on its
    matching mesh and the port's one-row engine; the counters are JAX's."""
    stream_rows = ROWS[mesh_name]
    ticks = ticks_of(N, 8, **BYTE_TICKS)
    jsvc = fused_service("jax", N, stream_rows)
    svc, one = fused_service("torch", N, stream_rows), fused_service("torch", N, 0)
    published = 0
    for k, tick in enumerate(ticks):
        jouts = jsvc.submit_bytes(tick, pipelined=pipelined)
        outs = svc.submit_bytes(tick, pipelined=pipelined)
        ones = one.submit_bytes(tick, pipelined=pipelined)
        for s in range(N):
            assert_same_output(jouts[s], outs[s], f"tick {k} stream {s}")
            assert_same_output(ones[s], outs[s], f"one row: tick {k} stream {s}")
            published += outs[s] is not None
    assert published >= 36
    eng, jeng = svc.fleet_ingest, jsvc.fleet_ingest
    assert_rows_placed(eng, stream_rows)
    assert eng.dispatch_count == jeng.dispatch_count == one.fleet_ingest.dispatch_count
    assert eng.dispatch_count == len(ticks)
    assert eng.rung_bucket_dispatches == {(1, RUN): len(ticks) - 1, (1, 64): 1}
    assert eng.h2d_transfers == jeng.h2d_transfers == 2 * eng.dispatch_count
    assert eng.card_dispatches == {"cpu": stream_rows * eng.dispatch_count}
    same_revs(eng.flush(), jeng.flush(), "flush")
    assert_same_snapshot(eng.snapshot(), one.fleet_ingest.snapshot())
    assert_snapshot_like_jax(eng.snapshot(), jeng.snapshot())
    for i in (0, 4, 7):
        for k, v in eng.filter_state_of(i).__dict__.items():
            w = getattr(one.fleet_ingest.filter_state_of(i), k)
            assert (v is None) == (w is None) and (v is None or torch.equal(v, w)), (i, k)


def test_max_revs_overflow_drops_what_jax_drops():
    """Stream 3 takes an 80-frame burst (two slices, 64 + 16 frames: the
    whole fleet steps twice that tick) and stream 6 a 64-frame one (3.2
    revolutions in one slice) with ``max_revs = 2``: the rows drop the
    same revolutions as JAX's engine on (2, 4) and the port's one row."""
    ticks = ticks_of(N, 8, bursts={(2, 3): 80, (2, 6): 64})[:6]
    jeng = _engine("jax", jmake_mesh(8))
    engs = {name: _engine("torch", mesh) for name, mesh in (
        ("2x4", rows_mesh(2)), ("4x2", rows_mesh(4)), ("1x1", one_mesh()))}
    for k, tick in enumerate(ticks):
        want = jeng.submit(tick)
        got = {name: eng.submit(tick) for name, eng in engs.items()}
        for name, outs in got.items():
            same_revs(outs, want, f"{name} tick {k}")
            same_revs(outs, got["1x1"], f"{name} against one row, tick {k}")
    for name, eng in engs.items():
        assert eng.revs_dropped == jeng.revs_dropped >= 2, name
        assert eng.dispatch_count == jeng.dispatch_count == len(ticks) + 1, name
    assert_same_snapshot(engs["2x4"].snapshot(), engs["4x2"].snapshot())


# ---------------------------------------------------------------------------
# de-skew and the carried map
# ---------------------------------------------------------------------------

ARMS = {
    # de-skew on, no map: the sub-sweep cache rides each row
    "deskew": dict(map_enable=False),
    # the carried map (config 18's route at fm's smoke geometry)
    "carried": {},
}
_runs: dict = {}


def _run_arm(pkg: str, arm: str, stream_rows: int):
    """fm's four-stream drift ticks through one arm: per tick the outputs,
    every stream's newest recon and map wire, the poses; then the engine
    and map snapshots and every stream's row snapshots."""
    params = fm._params(pkg, "fused", match_backend="xla", **ARMS[arm])
    kw = dict(beams=fm.BEAMS, capacity=1024, fleet_ingest_buckets=(4,))
    if pkg == "jax":
        svc = JService(params, 4, mesh=jmake_mesh(8), **kw)
    else:
        mesh = rows_mesh(stream_rows) if stream_rows else one_mesh()
        svc = ShardedFilterService(params, 4, mesh=mesh, **kw)
    svc._ensure_byte_ingest()
    if arm == "carried":
        svc.attach_mapper()
    eng = svc.fleet_ingest
    ticks = fm.byte_ticks(fm.dense_frames(4), 4)
    for k in (3, 7):
        ticks[k][2] = None  # stream 2 (row 1 of (2, 4)) idle twice
    per_tick = []
    for tick in ticks:
        outs = svc.submit_bytes(tick)
        per_tick.append((
            outs,
            [None if r is None else (np.array(r[0]), np.array(r[1])) for r in eng.last_recon],
            [None if w is None else np.array(w) for w in eng.last_map_wires],
            fm.pose_row(svc) if arm == "carried" else None,
        ))
    rows = [eng.snapshot_stream(i) for i in range(4)]
    maps = (eng.map_snapshot(), [eng.map_snapshot_stream(i) for i in range(4)]) \
        if arm == "carried" else None
    return svc, per_tick, eng.snapshot(), rows, maps


def _arm(pkg: str, arm: str, stream_rows: int = 0):
    key = (pkg, arm, stream_rows)
    if key not in _runs:
        _runs[key] = _run_arm(pkg, arm, stream_rows)
    return _runs[key]


@pytest.mark.parametrize("mesh_name", list(ROWS))
@pytest.mark.parametrize("arm", list(ARMS))
def test_deskew_and_carried_map_on_rows(arm, mesh_name):
    """Outputs, recons, map wires, poses, the map snapshot and each
    stream's rows equal the port's one row, and on the carried route (de-skew
    included) JAX's service on (2, 4)."""
    svc, ticks, snap, rows, maps = _arm("torch", arm, ROWS[mesh_name])
    assert_rows_placed(svc.fleet_ingest, ROWS[mesh_name])
    for pkg, stream_rows in (("jax", 0), ("torch", 0))[arm == "deskew":]:
        _ref, rticks, rsnap, rrows, rmaps = _arm(pkg, arm, stream_rows)
        same = assert_snapshot_like_jax if pkg == "jax" else assert_same_snapshot
        for k, ((outs, recons, wires, poses), (routs, rrecons, rwires, rposes)) in enumerate(
                zip(ticks, rticks)):
            what = f"{pkg} {arm} tick {k}"
            for s in range(4):
                assert_same_output(routs[s], outs[s], f"{what} stream {s}")
                assert (recons[s] is None) == (rrecons[s] is None), (what, s)
                if recons[s] is not None:
                    # the plane exact, the reconstructed xy within 2 ulp of
                    # JAX's (C.1) and exact between the port's layouts
                    np.testing.assert_array_equal(recons[s][0], rrecons[s][0], err_msg=what)
                    ulps = ulp_distance(recons[s][1], rrecons[s][1]).max()
                    assert ulps <= (2 if pkg == "jax" else 0), (what, s, ulps)
                assert (wires[s] is None) == (rwires[s] is None), (what, s)
                if wires[s] is not None:
                    np.testing.assert_array_equal(wires[s], rwires[s], err_msg=what)
            assert poses == rposes, what
        same(snap, rsnap)
        for i in range(4):
            same(rows[i], rrows[i])
        if maps is not None:
            fm.assert_maps_equal(maps[0], rmaps[0], pkg)
            for i in range(4):
                fm.assert_maps_equal(maps[1][i], rmaps[1][i], f"{pkg} stream {i}")
    assert sum(o is not None for outs, *_ in ticks for o in outs) >= 12
    assert any(r is not None for _o, recons, *_ in ticks for r in recons)


def test_carried_map_rows_take_writes_and_reanchors_per_stream():
    """map_restore, map_restore_stream and map_reanchor_stream land in the
    stream's row; the whole map reads back in stream order."""
    svc, *_ = _arm("torch", "carried", 4)
    eng = svc.fleet_ingest
    one = _arm("torch", "carried", 0)[0].fleet_ingest
    core = one.map_snapshot()
    core["log_odds"] = core["log_odds"] + np.arange(4, dtype=np.int32)[:, None, None]
    eng.map_restore(core)
    fm.assert_maps_equal(eng.map_snapshot(), core)
    row = {k: v[1] for k, v in core.items()}
    eng.map_restore_stream(3, row)
    eng.map_reanchor_stream(2, np.asarray([5, -6, 7], np.int32))
    got = eng.map_snapshot()
    np.testing.assert_array_equal(got["log_odds"][3], core["log_odds"][1])
    np.testing.assert_array_equal(got["pose"][2], [5, -6, 7])
    np.testing.assert_array_equal(eng._states[2].map_pose[0].numpy(), [5, -6, 7])
    np.testing.assert_array_equal(got["log_odds"][:2], core["log_odds"][:2])


# ---------------------------------------------------------------------------
# scheduled serving and health
# ---------------------------------------------------------------------------

SCHED = dict(super_tick_max=8, sched_rungs=(1, 2, 8), admission_max_backlog_ticks=16)


def _scheduled(pkg: str, stream_rows: int):
    """A burst of eight ticks drained by ``drain_scheduled`` (the shaper
    picks the rung), then a backlog at rung 8 whose ``overlap_work`` pulls
    stream 3's rows (row 1 on (2, 4)) while the drain runs."""
    svc = fused_service(pkg, 4, stream_rows, **SCHED)
    svc.attach_scheduler()
    ticks = ticks_of(4, 16, idle={(3, 1), (9, 2)})
    svc.offer_bytes([[t[i] for t in ticks[:8] if t[i]] or None for i in range(4)])
    drained = svc.drain_scheduled()
    status = svc.scheduler_status()
    status.pop("latency_model")  # wall-clock measurements
    pulled = []
    backlog = svc.submit_bytes_backlog(
        ticks[8:], rung=8, overlap_work=lambda: pulled.append(svc.fleet_ingest.snapshot_stream(3)))
    eng = svc.fleet_ingest
    counters = {k: getattr(eng, k) for k in ("dispatch_count", "super_dispatches",
                                             "h2d_transfers", "staging_overlap_hits")}
    counters["rung_dispatches"] = dict(eng.rung_dispatches)
    return svc, drained, status, backlog, pulled, counters


@pytest.fixture(scope="module")
def jax_scheduled():
    return _scheduled("jax", 2)


@pytest.mark.parametrize("mesh_name", list(ROWS))
def test_drain_scheduled_on_rows_matches_jax(mesh_name, jax_scheduled):
    svc, drained, status, backlog, pulled, counters = _scheduled("torch", ROWS[mesh_name])
    _j, jdrained, jstatus, jbacklog, jpulled, jcounters = jax_scheduled
    for got, want in ((drained, jdrained), (backlog, jbacklog)):
        for s in range(4):
            assert len(got[s]) == len(want[s]) > 0
            for k, (g, w) in enumerate(zip(got[s], want[s])):
                assert_same_output(w, g, f"stream {s} rev {k}")
    assert status == jstatus and counters == jcounters
    assert counters["rung_dispatches"][8] >= 2
    assert len(pulled) == len(jpulled) == 1
    # the stream's carried f32 offsets after the rung-8 super-step: JAX
    # interpolates each node's stamp ``first + step * i`` in f32 inside the
    # scan, where XLA fuses it into one multiply-add or rounds twice as it
    # chooses; the port rounds the float64 value once (ops/ingest.py).  Up to
    # 1 ulp at the plane's magnitude (1.86e-9 s of 0.0213 s; 576 ulp of an
    # element at -5.0e-6 s, so per-element ulps are the wrong unit)
    assert_snapshot_like_jax(pulled[0], jpulled[0], partial_ts_ulps=1)
    assert set(svc.fleet_ingest.staging._free) >= {("row", 1, "super", 8, RUN)}


def _health_run(pkg: str, stream_rows: int):
    """Stream 4 (row 1 on (2, 4), row 2 on (4, 2)) fed a corruption burst:
    quarantined, checkpointed, rejoined."""
    svc = fused_service(pkg, N, 2 if pkg == "jax" else stream_rows)
    svc._ensure_byte_ingest()
    svc.fleet_ingest.precompile([DENSE])
    fake = {"now": 0.0}
    health = _health(pkg, N, fake, cfg=dict(seed=5), probes={4: lambda: 0}, record_masks=True)
    svc.attach_health(health)
    snaps = []
    orig = svc._quarantine_stream

    def keep(i):
        orig(i)
        snaps.append(dict(svc.stream_checkpoints[i]["ingest"]))

    svc._quarantine_stream = keep
    ticks = chaos_ticks(_fleet_ticks(N, 10), {4: ChaosConfig(seed=3, start_frame=20,
                                                               stop_frame=40, corrupt_rate=0.9,
                                                               truncate_rate=0.5)})
    outs = []
    for tick in ticks:
        outs.append(list(svc.submit_bytes(tick)))
        fake["now"] += 0.1
    return svc, health, outs, snaps


@pytest.fixture(scope="module")
def jax_health():
    return _health_run("jax", 0)


@pytest.mark.parametrize("mesh_name", list(ROWS))
def test_quarantine_and_rejoin_of_a_row_1_stream(mesh_name, jax_health):
    svc, health, outs, snaps = _health_run("torch", ROWS[mesh_name])
    jsvc, jhealth, jouts, jsnaps = jax_health
    walk = [(s, old, new) for (_t, s, old, new) in health.events]
    assert (4, "suspect", "quarantined") in walk and (4, "recovering", "healthy") in walk
    assert {s for s, _old, _new in walk} == {4}
    assert health.events == jhealth.events and health.mask_log == jhealth.mask_log
    assert svc.quarantines == jsvc.quarantines == 1 and svc.rejoins == jsvc.rejoins == 1
    for t, (jrow, row) in enumerate(zip(jouts, outs)):
        for i in range(N):
            assert_same_output(jrow[i], row[i], f"tick {t} stream {i}")
    assert len(snaps) == len(jsnaps) == 1
    assert_snapshot_like_jax(snaps[0], jsnaps[0])
    assert_snapshot_like_jax(svc.fleet_ingest.snapshot(), jsvc.fleet_ingest.snapshot())


# ---------------------------------------------------------------------------
# cold reset, snapshots and checkpoints across mesh shapes
# ---------------------------------------------------------------------------


def test_cold_reset_on_rows_is_a_fresh_engine():
    ticks = ticks_of(N, 6, idle={(1, 6)})
    eng = _engine("torch", rows_mesh(4))
    eng.capture_cold_template()
    fresh = _engine("torch", one_mesh())
    fresh_snap = fresh.snapshot()
    for tick in ticks[:3]:
        eng.submit(tick)
    eng.cold_reset()
    assert_same_snapshot(eng.snapshot(), fresh_snap)
    for k, tick in enumerate(ticks[3:]):
        same_revs(eng.submit(tick), fresh.submit(tick), f"after cold reset tick {k}")
    assert_same_snapshot(eng.snapshot(), fresh.snapshot())


def test_snapshots_and_checkpoints_across_mesh_shapes(tmp_path):
    """(2, 4) rows -> (1, 1) -> (4, 2) rows by snapshot, JAX's (2, 4)
    engine's snapshot onto (2, 4) rows, and the engine's save_sharded
    loaded onto other shapes: each continued equal to JAX's engine."""
    ticks = ticks_of(N, 8, idle={(2, 0), (5, 5)})
    jeng = _engine("jax", jmake_mesh(8))
    a = _engine("torch", rows_mesh(2))
    for tick in ticks[:3]:
        jeng.submit(tick)
        a.submit(tick)
    jsnap = {k: np.array(v) for k, v in jeng.snapshot().items()}
    from_jax = _engine("torch", rows_mesh(2))
    assert from_jax.restore(jsnap)
    assert_same_snapshot(from_jax.snapshot(), jsnap)
    b = _engine("torch", one_mesh())
    assert b.restore(a.snapshot())
    for k, tick in enumerate(ticks[3:5]):
        want = jeng.submit(tick)
        same_revs(b.submit(tick), want, f"(1, 1) tick {k}")
        same_revs(from_jax.submit(tick), want, f"from JAX tick {k}")
    c = _engine("torch", rows_mesh(4))
    assert c.restore(b.snapshot())
    b.save_sharded(str(tmp_path / "ckpt"))
    loaded = {name: _engine("torch", mesh) for name, mesh in (("2x4", rows_mesh(2)),
                                                              ("4x2", rows_mesh(4)))}
    for eng in loaded.values():
        assert eng.load_sharded(str(tmp_path / "ckpt"))
        assert_same_snapshot(eng.snapshot(), b.snapshot())
    for k, tick in enumerate(ticks[5:]):
        want = jeng.submit(tick)
        for name, eng in (("(4, 2)", c), ("from JAX", from_jax), *loaded.items()):
            same_revs(eng.submit(tick), want, f"{name} tick {k}")
    final = jeng.snapshot()
    np.testing.assert_array_equal(c.snapshot()["filter.range_window"],
                                  np.asarray(final["filter.range_window"]))
    assert_same_snapshot(c.snapshot(), loaded["4x2"].snapshot())
    # a checkpoint of another geometry is refused, the state untouched
    other = tdi.FleetFusedIngest(byte_params("torch", "fused", filter_window=4), N,
                                 mesh=rows_mesh(2), beams=BEAMS, capacity=CAP)
    before = other.snapshot()
    assert not other.load_sharded(str(tmp_path / "ckpt"))
    assert not other.load_sharded(str(tmp_path / "absent"))
    assert_same_snapshot(other.snapshot(), before)


def test_stream_rows_move_between_engines_of_other_shapes():
    """snapshot_stream on one layout, restore_stream(restore_decode=True)
    on another: the live stream continues where it left off."""
    ticks = ticks_of(N, 6)
    src, dst, ref = (_engine("torch", rows_mesh(2)), _engine("torch", rows_mesh(4)),
                     _engine("torch", one_mesh()))
    for tick in ticks[:3]:
        src.submit(tick)
        ref.submit(tick)
    for i in range(N):
        assert dst.restore_stream(i, src.snapshot_stream(i), restore_decode=True)
    for k, tick in enumerate(ticks[3:]):
        same_revs(dst.submit(tick), ref.submit(tick), f"moved tick {k}")

"""The PyTorch package's scheduled serving against the JAX package's: the
engine's rung and bucket ladders and its double-buffered staging
(driver/ingest.FleetFusedIngest) and ShardedFilterService's scheduled seam
(``attach_scheduler`` / ``offer_bytes`` / ``drain_scheduled`` /
``scheduler_status`` and ``submit_bytes_backlog(rung=, overlap_work=)``).

JAX's tests/test_scheduler.py engine and service cases and
tests/test_guards.py's rung- and bucket-switch steady states, case for case
at their smoke geometry (256 beams, W = 4, the 32² grid, buckets of 4 and
8).  Each JAX run happens once per module (module-scoped fixtures) and the
port is held to it: every output byte-equal (``points_xy`` within 2 ulp),
the rung, (rung, bucket), staging-overlap and bucket-switch counters equal.
The policy decides when work dispatches, never what: every rung, every
bucket sequence and the double buffer on or off land the same outputs as
the per-tick seam.  On the CPU ``guards.steady_state`` checks only that
nothing is built.
"""

from __future__ import annotations

import numpy as np
import pytest

from rplidar_ros2_driver_tpu.core.config import DriverParams as JParams
from rplidar_ros2_driver_tpu.driver.ingest import FleetFusedIngest as JEngine
from rplidar_ros2_driver_tpu.parallel.service import ShardedFilterService as JService
from rplidar_ros2_driver_tpu_torch.core.config import DriverParams as TParams
from rplidar_ros2_driver_tpu_torch.driver.ingest import FleetFusedIngest as TEngine
from rplidar_ros2_driver_tpu_torch.parallel.service import ShardedFilterService as TService
from rplidar_ros2_driver_tpu_torch.protocol.constants import Ans
from rplidar_ros2_driver_tpu_torch.utils import guards

from test_fleet_fused_ingest import _mk_ticks
from test_live_decode import _make_stream
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

BEAMS = 256
DENSE = int(Ans.MEASUREMENT_DENSE_CAPSULED)
OUT_FIELDS = ("ranges", "intensities", "point_mask", "voxel")
PKG = {"jax": (JParams, JEngine, JService), "torch": (TParams, TEngine, TService)}
COUNTERS = ("dispatch_count", "super_dispatches", "ticks", "staging_overlap_hits",
            "bucket_switches", "active_bucket", "rung_dispatches", "rung_bucket_dispatches")


def _params(pkg, **over):
    base = dict(filter_backend="cpu", filter_chain=("clip", "median", "voxel"), filter_window=4,
                voxel_grid_size=32, median_backend="xla")
    base.update(over)
    return PKG[pkg][0](**base)


def _streams_frames(s, n=64, syncs=(0, 17, 34, 51), seed=40):
    return [(DENSE, _make_stream(DENSE, n, np.random.default_rng(seed + i), syncs=syncs))
            for i in range(s)]


def ulp_distance(a, b) -> np.ndarray:
    def ordered(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)

    return np.abs(ordered(a) - ordered(b))


def _out_equal(a, b, what):
    for f in OUT_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(a, f)), np.asarray(getattr(b, f)),
                                      err_msg=f"{what} {f}")
    assert ulp_distance(np.asarray(a.points_xy), np.asarray(b.points_xy)).max() <= 2, what


def _outs_equal(got, want, what="", ts_tol=0.0):
    """Per-stream lists of FilterOutputs (or ``(out, ts0, dur)`` triples).
    ``ts_tol``: the stamps' tolerance in seconds, exact unless a case
    states its cause."""
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert len(g) == len(w), f"{what} stream {i}: {len(g)} != {len(w)} revolutions"
        for k, (x, y) in enumerate(zip(g, w)):
            if isinstance(x, tuple):
                assert abs(x[1] - y[1]) <= ts_tol, f"{what} stream {i} rev {k} ts0"
                x, y = x[0], y[0]
            _out_equal(x, y, f"{what} stream {i} rev {k}")


def _counters(eng) -> dict:
    out = {k: getattr(eng, k) for k in COUNTERS}
    out["rung_dispatches"] = dict(out["rung_dispatches"])
    out["rung_bucket_dispatches"] = dict(out["rung_bucket_dispatches"])
    return out


# ---------------------------------------------------------------------------
# the engine's rung ladder (JAX test_scheduler.TestEngineRungLadder)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ladder_ticks():
    return _mk_ticks(_streams_frames(2), np.random.default_rng(9), idle_prob=0.0)


def _ladder_engine(pkg, **kw):
    return PKG[pkg][1](_params(pkg), 2, beams=BEAMS, buckets=(4,), max_revs=6,
                       rungs=(1, 2, 4), **kw)


@pytest.fixture(scope="module")
def jax_ladder(ladder_ticks):
    """JAX's engine drained at rungs 1, 2 and 4 (fresh engines)."""
    runs = {}
    for rung in (1, 2, 4):
        eng = _ladder_engine("jax")
        runs[rung] = (eng.submit_backlog(ladder_ticks, rung=rung), _counters(eng))
    return runs


@pytest.fixture(scope="module")
def per_tick_seam(ladder_ticks):
    """The port's per-tick seam over the same ticks (the reference every
    rung is held to)."""
    eng = _ladder_engine("torch")
    outs = [[] for _ in range(2)]
    for tick in ladder_ticks:
        for i, o in enumerate(eng.submit(tick)):
            outs[i].extend(o)
    return outs


@pytest.mark.parametrize("rung", [1, 2, 4])
def test_any_rung_is_byte_equal_to_jax_and_the_per_tick_seam(rung, ladder_ticks, jax_ladder,
                                                            per_tick_seam):
    eng = _ladder_engine("torch")
    outs = eng.submit_backlog(ladder_ticks, rung=rung)
    jouts, jcount = jax_ladder[rung]
    _outs_equal(outs, jouts, f"rung {rung} vs jax")
    _outs_equal(outs, per_tick_seam, f"rung {rung} vs the per-tick seam")
    assert sum(len(o) for o in outs) > 0
    assert _counters(eng) == jcount
    assert sum(eng.rung_dispatches.values()) == eng.dispatch_count
    assert sum(eng.rung_bucket_dispatches.values()) == eng.dispatch_count


def test_rung_dispatch_accounting():
    ticks = _mk_ticks(_streams_frames(2), np.random.default_rng(3), idle_prob=0.0)[:7]
    eng = _ladder_engine("torch")
    eng.submit_backlog(ticks, rung=4)
    # 7 slices at rung 4: one full group of 4 and one of 3 (padded)
    assert eng.rung_dispatches == {1: 0, 2: 0, 4: 2}
    assert eng.super_dispatches == 2 and eng.ticks_super_fused == 7
    assert sum(eng.rung_dispatches.values()) == eng.dispatch_count


def test_unwarmed_rung_refused():
    eng = TEngine(_params("torch"), 1, beams=BEAMS, buckets=(4,), rungs=(1, 2))
    ticks = _mk_ticks(_streams_frames(1), np.random.default_rng(1), idle_prob=0.0)
    with pytest.raises(ValueError, match="not a warmed rung"):
        eng.submit_backlog(ticks, rung=3)


def test_ensure_rungs_union_and_late_refusal():
    eng = TEngine(_params("torch"), 1, beams=BEAMS, buckets=(4,), rungs=(1, 2))
    eng.ensure_rungs((1, 4))
    assert eng.rungs == (1, 2, 4) and eng.rung_dispatches == {1: 0, 2: 0, 4: 0}
    ticks = _mk_ticks(_streams_frames(1), np.random.default_rng(2), idle_prob=0.0)
    eng.submit_backlog(ticks[:1], rung=1)
    eng.ensure_rungs((1, 2))  # a subset: fine after traffic
    with pytest.raises(RuntimeError, match="already ticked"):
        eng.ensure_rungs((1, 8))


def test_ensure_rungs_refused_after_precompile_and_every_pair_warmed():
    eng = TEngine(_params("torch"), 1, beams=BEAMS, buckets=(4, 8), rungs=(1, 2))
    eng.precompile([DENSE])
    # each (rung, bucket) step ran and its second run was timed
    assert set(eng.warmup_costs) == {(1, 4), (2, 4), (1, 8), (2, 8)}
    assert all(v > 0 for v in eng.warmup_costs.values())
    # each staging key's pair was taken from the pool and sits in it
    assert {k: len(v) for k, v in eng.staging._free.items()} == {
        ("tick", 4): 1, ("super", 2, 4): 1, ("tick", 8): 1, ("super", 2, 8): 1}
    eng.ensure_rungs((1, 2))
    with pytest.raises(RuntimeError, match="precompiled"):
        eng.ensure_rungs((1, 4))


@pytest.mark.parametrize("deskew", [False, True])
def test_precompile_leaves_the_outputs_unchanged(deskew, ladder_ticks):
    """precompile runs the fleet step's completed-revolution code
    (ops/ingest._revolution_slots: the de-skew, the slot filter) on a
    throwaway state at the engine's width: a precompiled engine's drains
    are a fresh engine's, byte for byte."""
    over = dict(deskew_enable=True, sweep_reconstruct_window=3, deskew_profile_beams=64,
                deskew_shift_window=4) if deskew else {}

    def engine():
        return TEngine(_params("torch", **over), 2, beams=BEAMS, buckets=(4,), max_revs=6,
                       rungs=(1, 2, 4))

    fresh, warmed = engine(), engine()
    warmed.precompile([DENSE] * 2)
    want = fresh.submit_backlog(ladder_ticks, rung=2)
    assert sum(len(o) for o in want) > 0
    _outs_equal(warmed.submit_backlog(ladder_ticks, rung=2), want, f"deskew={deskew}")


def test_rung_switches_build_nothing(ladder_ticks, per_tick_seam):
    """JAX test_guards.TestAdaptiveRungSteadyState: a precompiled engine
    switching depth drain by drain (shallow, deep, shallow) builds
    nothing, and the outputs are the per-tick seam's."""
    eng = _ladder_engine("torch")
    eng.precompile([DENSE] * 2)
    cut = max(4, len(ladder_ticks) // 3)
    outs = eng.submit_backlog(ladder_ticks[:cut], rung=4)
    before = dict(eng.rung_dispatches)
    with guards.steady_state(tag="adaptive rung switches"):
        pos = cut
        for rung in (1, 4, 2, 4, 1, 2, 4, 4, 4, 4):
            if pos >= len(ladder_ticks):
                break
            step = max(rung, 2)
            got = eng.submit_backlog(ladder_ticks[pos: pos + step], rung=rung)
            for i in range(2):
                outs[i].extend(got[i])
            pos += step
    assert pos >= len(ladder_ticks)
    _outs_equal(outs, per_tick_seam, "rung switches")
    assert len([r for r in eng.rungs if eng.rung_dispatches[r] > before[r]]) >= 2
    assert sum(eng.rung_dispatches.values()) == eng.dispatch_count


# ---------------------------------------------------------------------------
# the bucket ladder and the double buffer (JAX test_guards.
# TestBucketLadderSteadyState)
# ---------------------------------------------------------------------------


BUCKET_PLAN = ((4, 1), (4, 2), (8, 1), (8, 2), (4, 1), (8, 2), (4, 2))


@pytest.fixture(scope="module")
def bucket_ticks():
    streams = [(DENSE, _make_stream(DENSE, 96, np.random.default_rng(40 + i),
                                    syncs=(0, 17, 34, 51, 68, 85))) for i in range(2)]
    return _mk_ticks(streams, np.random.default_rng(9), idle_prob=0.0)


def _bucket_run(pkg, ticks, *, double_buffer=True, guard=False):
    """An engine with buckets (4, 8) and rungs (1, 2), precompiled: a
    warm drain at rung 2, then drains over BUCKET_PLAN, each pulling a
    stream-0 snapshot on the idle half of the double buffer."""
    eng = PKG[pkg][1](_params(pkg, staging_double_buffer=double_buffer), 2, beams=BEAMS,
                      buckets=(4, 8), max_revs=6, rungs=(1, 2))
    eng.precompile([DENSE] * 2)
    cut = max(4, len(ticks) // 3)
    outs = [list(o) for o in eng.submit_backlog(ticks[:cut], rung=2)]
    eng.snapshot_stream(0)
    snaps = []
    counters = [_counters(eng)]
    scope = guards.steady_state(tag="bucket switches + overlap snapshots") if guard else None
    if scope is not None:
        scope.__enter__()
    try:
        pos = cut
        for bucket, rung in BUCKET_PLAN:
            if pos + 2 > len(ticks):
                break
            eng.set_active_bucket(bucket)
            step = max(2 * rung, 2)
            got = eng.submit_backlog(ticks[pos: pos + step], rung=rung,
                                     overlap_work=lambda: snaps.append(eng.snapshot_stream(0)))
            for i in range(2):
                outs[i].extend(got[i])
            pos += step
            counters.append(_counters(eng))
        got = eng.submit_backlog(ticks[pos:], rung=2)
        for i in range(2):
            outs[i].extend(got[i])
    finally:
        if scope is not None:
            scope.__exit__(None, None, None)
    return outs, counters, snaps, eng


@pytest.fixture(scope="module")
def jax_buckets(bucket_ticks):
    outs, counters, snaps, _eng = _bucket_run("jax", bucket_ticks)
    return outs, counters, snaps


def test_bucket_switches_and_overlap_snapshots_match_jax(bucket_ticks, jax_buckets):
    outs, counters, snaps, eng = _bucket_run("torch", bucket_ticks, guard=True)
    jouts, jcounters, jsnaps = jax_buckets
    # one revolution's stamp (stream 1, revolution 2) is JAX's + 2^-28 s:
    # 1 ulp of the f32 offset from its tick's base, under 2^-4 s here
    # (frames 2 ms apart, revolutions of 17 frames).  JAX's offsets come out
    # of XLA's compiled super-step, which may fuse ``first + step*i`` into
    # one rounding or round twice; the port rounds the float64 value once
    # (ops/ingest.py, ROADMAP C.5).  Every other stamp is exact.
    _outs_equal(outs, jouts, "bucket ladder", ts_tol=2.0 ** -28)
    assert counters == jcounters
    assert eng.bucket_switches >= 2 and eng.staging_overlap_hits > counters[0][
        "staging_overlap_hits"]
    assert len(snaps) == len(jsnaps) >= 3
    for k, (a, b) in enumerate(zip(snaps, jsnaps)):
        assert set(a) == set(b)
        for key in a:
            if key.startswith("filter."):
                np.testing.assert_array_equal(a[key], np.asarray(b[key]), err_msg=f"{k} {key}")
    moved = {b for (r, b), n in eng.rung_bucket_dispatches.items()
             if n > counters[0]["rung_bucket_dispatches"].get((r, b), 0)}
    assert 4 in moved
    assert sum(eng.rung_bucket_dispatches.values()) == eng.dispatch_count


def test_double_buffer_off_is_byte_equal_and_never_overlaps(bucket_ticks):
    on, con, _s, _e = _bucket_run("torch", bucket_ticks)
    off, coff, _s2, eng = _bucket_run("torch", bucket_ticks, double_buffer=False)
    _outs_equal(off, on, "double buffer off vs on")
    assert eng.staging_overlap_hits == 0 and con[-1]["staging_overlap_hits"] > 0
    for a, b in zip(con, coff):
        a = dict(a, staging_overlap_hits=0)
        assert a == dict(b, staging_overlap_hits=0)


def test_set_active_bucket_refuses_an_unwarmed_bucket():
    eng = TEngine(_params("torch"), 2, beams=BEAMS, buckets=(4, 8))
    assert eng.slicing_bucket == 8 and eng.active_bucket is None
    eng.set_active_bucket(8)  # the default cap: no switch
    assert eng.bucket_switches == 0
    with pytest.raises(ValueError, match="not a warmed padding bucket"):
        eng.set_active_bucket(16)
    eng.set_active_bucket(4)
    assert eng.slicing_bucket == 4 and eng.bucket_switches == 1


# ---------------------------------------------------------------------------
# the service's scheduled seam (JAX test_scheduler.TestServiceServingSeam)
# ---------------------------------------------------------------------------


def _svc_params(pkg, **over):
    base = dict(fleet_ingest_backend="fused", sched_rungs=(1, 2, 4),
                admission_max_backlog_ticks=8)
    base.update(over)
    return _params(pkg, **base)


@pytest.fixture(scope="module")
def svc_ticks():
    return _mk_ticks(_streams_frames(2), np.random.default_rng(11), idle_prob=0.0)


def _serve(pkg, ticks, bursts):
    """A scheduled service over ``ticks`` delivered as the given burst
    sizes (wall ticks of several data ticks); per-stream outputs, the
    scheduler status after each drain and the engine counters."""
    svc = PKG[pkg][2](_svc_params(pkg, admission_max_backlog_ticks=64), 2, beams=BEAMS,
                      fleet_ingest_buckets=(4,))
    svc.attach_scheduler()
    svc.fleet_ingest.precompile([DENSE] * 2)
    outs = [[] for _ in range(2)]
    statuses = []
    pos = 0
    for n in bursts:
        chunk = ticks[pos: pos + n]
        pos += n
        svc.offer_bytes([[t[i] for t in chunk if t[i]] or None for i in range(2)])
        for i, g in enumerate(svc.drain_scheduled()):
            outs[i].extend(g)
        st = svc.scheduler_status()
        st.pop("latency_model")  # wall-clock measurements
        statuses.append(st)
    return outs, statuses, _counters(svc.fleet_ingest), svc


BURSTS = (64, 1, 0, 3, 2, 0, 0, 1)


@pytest.fixture(scope="module")
def jax_served(svc_ticks):
    outs, statuses, counters, _svc = _serve("jax", svc_ticks, BURSTS)
    ref = JService(_svc_params("jax", admission_max_backlog_ticks=64), 2, beams=BEAMS,
                   fleet_ingest_buckets=(4,))
    return outs, statuses, counters, ref.submit_bytes_backlog(svc_ticks)


def test_offer_drain_matches_jax_and_the_plain_backlog(svc_ticks, jax_served):
    outs, statuses, counters, svc = _serve("torch", svc_ticks, BURSTS)
    jouts, jstatuses, jcounters, jref = jax_served
    _outs_equal(outs, jouts, "scheduled drains vs jax")
    assert statuses == jstatuses
    assert counters == jcounters
    ref = TService(_svc_params("torch", admission_max_backlog_ticks=64), 2, beams=BEAMS,
                   fleet_ingest_buckets=(4,))
    plain = ref.submit_bytes_backlog(svc_ticks)
    _outs_equal(outs, plain, "scheduled drains vs the plain backlog")
    _outs_equal(plain, jref, "plain backlog vs jax")
    # the burst drained above rung 1, the accounting closes
    assert any(n for r, n in svc.fleet_ingest.rung_dispatches.items() if r > 1)
    st = svc.scheduler_status()
    assert st["backlog"] == [0, 0]
    assert st["rung_dispatches"] == dict(svc.fleet_ingest.rung_dispatches)
    assert sum(svc.fleet_ingest.rung_dispatches.values()) == svc.fleet_ingest.dispatch_count


def test_warmup_seeds_the_latency_model():
    svc = TService(_svc_params("torch"), 2, beams=BEAMS, fleet_ingest_buckets=(4, 8))
    svc.attach_scheduler()
    svc.fleet_ingest.precompile([DENSE] * 2)
    assert set(svc.fleet_ingest.warmup_costs) == {(r, b) for r in (1, 2, 4) for b in (4, 8)}
    svc.drain_scheduled()  # even an empty drain consumes the seeds
    assert svc.fleet_ingest.warmup_costs == {}
    assert set(svc.scheduler.model.table_ms()) == {f"T{r}xM{b}" for r in (1, 2, 4)
                                                   for b in (4, 8)}
    assert svc.last_poses == [None, None]


def test_scheduler_status_carries_the_staging_counters():
    svc = TService(_svc_params("torch"), 2, beams=BEAMS, fleet_ingest_buckets=(4,))
    assert svc.scheduler_status() is None
    svc.attach_scheduler()
    st = svc.scheduler_status()
    assert st["rung_bucket_dispatches"] == {} and st["staging_overlap_hits"] == 0
    assert st["latency_model"] == {} and st["rung_dispatches"] == {1: 0, 2: 0, 4: 0}


def test_quarantine_checkpoint_deferral_gate():
    svc = TService(_svc_params("torch"), 2, beams=BEAMS, fleet_ingest_buckets=(4,))
    svc._ensure_byte_ingest()
    svc.fleet_ingest.precompile([DENSE] * 2)
    svc._defer_checkpoints = []
    svc._quarantine_stream(0)
    assert svc._defer_checkpoints == [0]
    assert not svc.stream_checkpoints and svc.quarantines == 0
    svc._defer_checkpoints = None
    svc._quarantine_stream(0)
    assert 0 in svc.stream_checkpoints and svc.quarantines == 1


def test_deferred_checkpoints_ride_the_overlap_or_flush_when_the_drain_raises(svc_ticks):
    """With health attached, a double-buffered drain defers quarantine
    checkpoints to its idle half; a drain that raises before it flushes
    them in its ``finally`` — none is dropped."""
    svc = TService(_svc_params("torch", health_enable=True), 2, beams=BEAMS,
                   fleet_ingest_buckets=(4,))
    svc.attach_scheduler()
    svc.fleet_ingest.precompile([DENSE] * 2)
    seen = []
    real = svc.submit_bytes_backlog

    def quarantine_mid_drain(ticks, **kw):
        # the health hook fires while the drain dispatches
        svc._quarantine_stream(1)
        seen.append(list(svc._defer_checkpoints))
        return real(ticks, **kw)

    svc.submit_bytes_backlog = quarantine_mid_drain
    svc.offer_bytes([svc_ticks[0][0], svc_ticks[0][1]])
    svc.drain_scheduled()
    assert seen == [[1]] and 1 in svc.stream_checkpoints and svc.quarantines == 1
    assert svc._defer_checkpoints is None

    def raising(ticks, **kw):
        svc._quarantine_stream(0)
        raise RuntimeError("device fell off the bus")

    svc.submit_bytes_backlog = raising
    svc.offer_bytes([svc_ticks[1][0], svc_ticks[1][1]])
    with pytest.raises(RuntimeError, match="fell off"):
        svc.drain_scheduled()
    assert 0 in svc.stream_checkpoints and svc.quarantines == 2
    assert svc._defer_checkpoints is None


def test_host_backend_refuses_scheduler_and_rung():
    svc = TService(_params("torch", fleet_ingest_backend="host"), 2, beams=BEAMS)
    with pytest.raises(ValueError, match="fused"):
        svc.attach_scheduler()
    with pytest.raises(ValueError, match="rung"):
        svc.submit_bytes_backlog([[None, None]], rung=2)
    with pytest.raises(ValueError, match="fused"):
        svc.submit_bytes_backlog([[None, None]], overlap_work=lambda: None)


def test_offer_and_drain_require_attach():
    svc = TService(_svc_params("torch"), 2, beams=BEAMS, fleet_ingest_buckets=(4,))
    with pytest.raises(RuntimeError, match="attach_scheduler"):
        svc.offer_bytes([None, None])
    with pytest.raises(RuntimeError, match="attach_scheduler"):
        svc.drain_scheduled()


def test_live_payload_feeds_the_renderer_as_jax_does():
    from rplidar_ros2_driver_tpu.node.diagnostics import DiagnosticsUpdater as JUpd
    from rplidar_ros2_driver_tpu.node.lifecycle import LifecycleState as JLs
    from rplidar_ros2_driver_tpu.node.publisher import CollectingPublisher as JPub
    from rplidar_ros2_driver_tpu_torch.node.diagnostics import DiagnosticsUpdater
    from rplidar_ros2_driver_tpu_torch.node.lifecycle import LifecycleState
    from rplidar_ros2_driver_tpu_torch.node.publisher import CollectingPublisher

    svc = TService(_svc_params("torch"), 2, beams=BEAMS, fleet_ingest_buckets=(4,))
    svc.attach_scheduler()
    payload = svc.scheduler_status()
    got = DiagnosticsUpdater("rig", CollectingPublisher()).update(
        lifecycle=LifecycleState.ACTIVE, fsm_state=None, port="svc", rpm=0, device_info="",
        scheduler=payload).values
    want = JUpd("rig", JPub()).update(
        lifecycle=JLs.ACTIVE, fsm_state=None, port="svc", rpm=0, device_info="",
        scheduler=payload).values
    assert got == want
    assert got["Sched Backlog"] == "0,0" and "Rung Dispatches" in got

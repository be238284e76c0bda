"""The PyTorch package's health supervisor against the JAX package's.

driver/health.py is host-only and copied into the port; the service seam
(``ShardedFilterService.attach_health``, the quarantine checkpoint and the
rejoin restore) is ported.  These cases follow the JAX package's
tests/test_chaos.py classes: the quarantine cycle under a seeded
corruption burst (driver/chaos.chaos_ticks) with every output, every FSM
transition and the final maps equal to the JAX service's under the same
chaos — on the host-route mapper and on the carried map, whose rows ride
the v3 quarantine snapshot — and fault isolation; the per-stream
checkpoints; the FSM walks; ``BackoffPolicy``; the service seam
(``health_enable``, the hook order, backlog masking).
"""

from __future__ import annotations

import numpy as np
import pytest

from rplidar_ros2_driver_tpu.core.config import DriverParams as JParams
from rplidar_ros2_driver_tpu.driver import health as jhealth
from rplidar_ros2_driver_tpu.driver.ingest import FleetFusedIngest as JEngine
from rplidar_ros2_driver_tpu.mapping.mapper import FleetMapper as JFleetMapper
from rplidar_ros2_driver_tpu.ops import wire as jwire
from rplidar_ros2_driver_tpu.parallel.service import ShardedFilterService as JService
from rplidar_ros2_driver_tpu.parallel.sharding import make_mesh as jmake_mesh
from rplidar_ros2_driver_tpu_torch.core.config import DriverParams as TParams
from rplidar_ros2_driver_tpu_torch.driver import health as thealth
from rplidar_ros2_driver_tpu_torch.driver.chaos import ChaosConfig, chaos_ticks
from rplidar_ros2_driver_tpu_torch.driver.ingest import FleetFusedIngest as TEngine
from rplidar_ros2_driver_tpu_torch.mapping.mapper import FleetMapper as TFleetMapper
from rplidar_ros2_driver_tpu_torch.parallel.service import ShardedFilterService as TService
from rplidar_ros2_driver_tpu_torch.parallel.sharding import make_mesh as tmake_mesh
from rplidar_ros2_driver_tpu_torch.protocol.constants import Ans
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

BEAMS = 256
DENSE = int(Ans.MEASUREMENT_DENSE_CAPSULED)
OUT_FIELDS = ("ranges", "intensities", "point_mask", "voxel")
MAP_KEYS = ("log_odds", "pose", "origin_xy", "revision")
PKGS = {"jax": (JParams, jhealth), "torch": (TParams, thealth)}


def _params(pkg: str, **over):
    base = dict(filter_backend="cpu", filter_chain=("clip", "median", "voxel"), filter_window=4,
                voxel_grid_size=32)
    base.update(over)
    return PKGS[pkg][0](**base)


def _map_params(pkg: str, **over):
    return _params(pkg, **{**dict(map_enable=True, map_grid=64, map_cell_m=0.1), **over})


def _carried_params(pkg: str, **over):
    return _params(pkg, **{**dict(
        fleet_ingest_backend="fused", deskew_enable=True, sweep_reconstruct_window=3,
        deskew_profile_beams=64, deskew_shift_window=4, map_enable=True, map_grid=32,
        map_cell_m=0.2, fused_mapping_backend="fused"), **over})


def _denseboost_frames(revs: int, ppr: int = 400) -> list:
    frames, idx, first = [], 0, True
    while idx < revs * ppr:
        theta = 360.0 * (idx % ppr) / ppr
        pts = (np.arange(40) + idx) % ppr
        d = 2000.0 + 500.0 * np.sin(2 * np.pi * pts / ppr)
        frames.append(jwire.encode_dense_capsule(int(theta * 64) & 0x7FFF, first, d.astype(int)))
        idx += 40
        first = False
    return frames


def _fleet_ticks(streams: int, revs: int, per_tick: int = 5) -> list:
    """Lockstep ticks: every stream streams every tick."""
    frames = _denseboost_frames(revs)
    ticks = []
    t = [100.0 + 7.0 * s for s in range(streams)]
    for i in range(0, len(frames), per_tick):
        tick = []
        for s in range(streams):
            batch = []
            for f in frames[i : i + per_tick]:
                t[s] += 1.25e-3
                batch.append((f, t[s]))
            tick.append((DENSE, batch))
        ticks.append(tick)
    return ticks


def _service(pkg: str, params, streams: int, **kw):
    if pkg == "jax":
        return JService(params, streams, beams=BEAMS, mesh=jmake_mesh(1), **kw)
    return TService(params, streams, beams=BEAMS, mesh=tmake_mesh(device="cpu"), **kw)


def _health(pkg: str, streams: int, fake: dict, **kw):
    h = PKGS[pkg][1]
    cfg = dict(window_ticks=3, corrupt_ratio=0.5, starvation_ticks=4, suspect_ticks=2,
               probation_ticks=2, backoff_base_s=0.4, backoff_jitter=0.0)
    cfg.update(kw.pop("cfg", {}))
    return h.FleetHealth(streams, h.HealthConfig(**cfg), clock=lambda: fake["now"], **kw)


def _assert_out_equal(a, b, what):
    assert (a is None) == (b is None), what
    if a is not None:
        for f in OUT_FIELDS:
            np.testing.assert_array_equal(np.asarray(getattr(a, f)), np.asarray(getattr(b, f)),
                                          err_msg=f"{what} {f}")


def _chaos_run(pkg: str, params, cticks, streams: int, *, probes=None, attach_mapper=True):
    svc = _service(pkg, params, streams, fleet_ingest_buckets=(8,))
    svc._ensure_byte_ingest()
    svc.fleet_ingest.precompile([DENSE])
    if attach_mapper:
        svc.attach_mapper()
    fake = {"now": 0.0}
    health = _health(pkg, streams, fake, cfg=dict(seed=5), probes=probes, record_masks=True)
    svc.attach_health(health)
    outs, snaps = [], []
    orig = svc._quarantine_stream

    def keep(i):
        # the attached hook looks the method up at call time: keep a copy
        # of each quarantine checkpoint before the rejoin consumes it
        orig(i)
        snaps.append(dict(svc.stream_checkpoints[i]))

    svc._quarantine_stream = keep
    for tick in cticks:
        outs.append(list(svc.submit_bytes(tick)))
        fake["now"] += 0.1
    return svc, health, outs, snaps


# ---------------------------------------------------------------------------
# the quarantine cycle, against the JAX service under the same chaos
# ---------------------------------------------------------------------------


class TestChaosFleetParity:
    @pytest.mark.parametrize("route", ["mapper", "carried"])
    def test_quarantine_cycle_matches_jax(self, route):
        """Fleet of 4, stream 1 fed a seeded corruption burst: it walks
        HEALTHY -> SUSPECT -> QUARANTINED -> RECOVERING -> HEALTHY with its
        rows checkpointed and restored; the neighbors never leave HEALTHY;
        every published output, every transition and the final maps equal
        the JAX service's under the same chaos.  On the carried route the
        quarantine snapshot carries the ``ingest.map_*`` rows and no
        separate map row."""
        streams = 4
        ticks = _fleet_ticks(streams, 10)
        cticks = chaos_ticks(ticks, {1: ChaosConfig(seed=3, start_frame=20, stop_frame=40,
                                                    corrupt_rate=0.9, truncate_rate=0.5)})
        if route == "mapper":
            mk = lambda pkg: _map_params(pkg, fleet_ingest_backend="fused", map_backend="fused")
        else:
            mk = _carried_params
        runs = {pkg: _chaos_run(pkg, mk(pkg), cticks, streams, probes={1: lambda: 0})
                for pkg in PKGS}
        (jsvc, jh, jouts, jsnaps), (tsvc, th, touts, tsnaps) = runs["jax"], runs["torch"]
        walk = [(s, old, new) for (_t, s, old, new) in th.events]
        for step in (("healthy", "suspect"), ("suspect", "quarantined"),
                     ("quarantined", "recovering"), ("recovering", "healthy")):
            assert (1, *step) in walk
        assert all(s == 1 for (s, _o, _n) in walk)
        assert th.events == jh.events
        assert th.mask_log == jh.mask_log
        assert tsvc.quarantines == jsvc.quarantines == 1
        assert tsvc.rejoins == jsvc.rejoins == 1
        assert not tsvc.stream_checkpoints
        assert sum(1 for m in th.mask_log if not m[1]) >= 1
        published = 0
        for t, (jrow, trow) in enumerate(zip(jouts, touts)):
            for i in range(streams):
                _assert_out_equal(jrow[i], trow[i], f"tick {t} stream {i}")
                published += trow[i] is not None
        assert published >= 2 * streams
        for i in range(streams):
            jr, tr = jsvc.mapper.snapshot_stream(i), tsvc.mapper.snapshot_stream(i)
            for k in MAP_KEYS:
                np.testing.assert_array_equal(tr[k], np.asarray(jr[k]), err_msg=f"{i} {k}")
        assert len(tsnaps) == len(jsnaps) == 1
        assert sorted(tsnaps[0]) == sorted(jsnaps[0])
        ingest_keys = sorted(tsnaps[0]["ingest"])
        assert ingest_keys == sorted(jsnaps[0]["ingest"])
        if route == "carried":
            assert "map" not in tsnaps[0]
            assert {f"ingest.map_{k}" for k in MAP_KEYS} <= set(ingest_keys)
            assert int(tsnaps[0]["ingest"]["version"]) == 3
        else:
            assert "map" in tsnaps[0]
        for k in ingest_keys:
            np.testing.assert_array_equal(tsnaps[0]["ingest"][k],
                                          np.asarray(jsnaps[0]["ingest"][k]), err_msg=k)

    def test_fault_isolation_healthy_streams_unchanged(self):
        """Healthy streams' outputs are byte-identical whether a neighbor is
        clean or quarantined mid-run."""
        streams = 4
        ticks = _fleet_ticks(streams, 6)
        chaos = ChaosConfig(seed=11, start_frame=10, stop_frame=30, corrupt_rate=0.9,
                            truncate_rate=0.5)

        def run(use):
            svc, _h, outs, _s = _chaos_run("torch", _params("torch", fleet_ingest_backend="fused"),
                                           use, streams, attach_mapper=False)
            per = [[np.asarray(r[i].ranges).copy() for r in outs if r[i] is not None]
                   for i in range(streams)]
            return per, svc

        clean, _ = run(ticks)
        faulty, svc = run(chaos_ticks(ticks, {1: chaos}))
        assert svc.quarantines >= 1
        for i in (0, 2, 3):
            assert len(clean[i]) == len(faulty[i]) >= 1
            for a, b in zip(clean[i], faulty[i]):
                np.testing.assert_array_equal(a, b)
        assert len(faulty[1]) < len(clean[1])


# ---------------------------------------------------------------------------
# per-stream checkpoints
# ---------------------------------------------------------------------------


class TestStreamCheckpoints:
    def test_ingest_restore_stream_rolls_back_one_lane(self):
        """restore_stream reinstalls the snapshotted filter window into one
        lane (decode carries reset) with every other lane untouched; the
        snapshot equals the JAX engine's at the same point."""
        streams = 3
        ticks = _fleet_ticks(streams, 8)
        eng = TEngine(_params("torch"), streams, beams=BEAMS, buckets=(8,), max_revs=6)
        jeng = JEngine(_params("jax"), streams, beams=BEAMS, buckets=(8,), max_revs=6)
        cut = len(ticks) // 2
        for tick in ticks[:cut]:
            eng.submit(tick)
            jeng.submit(tick)
        snap, jsnap = eng.snapshot_stream(1), jeng.snapshot_stream(1)
        assert sorted(snap) == sorted(jsnap)
        for k in snap:
            np.testing.assert_array_equal(snap[k], np.asarray(jsnap[k]), err_msg=k)
            assert snap[k].dtype == np.asarray(jsnap[k]).dtype, k
        full_mid = eng.snapshot()
        for tick in ticks[cut:]:
            eng.submit(tick)
        full_end = eng.snapshot()
        assert not np.array_equal(full_mid["filter.range_window"][1],
                                  full_end["filter.range_window"][1])
        assert eng.restore_stream(1, jsnap)  # the JAX package's row
        full_after = eng.snapshot()
        np.testing.assert_array_equal(full_after["filter.range_window"][1],
                                      full_mid["filter.range_window"][1])
        for i in (0, 2):
            np.testing.assert_array_equal(full_after["filter.range_window"][i],
                                          full_end["filter.range_window"][i])
        for k in full_end:
            if k.startswith("ingest."):
                np.testing.assert_array_equal(full_after[k], full_end[k], err_msg=k)
        assert eng._reset_next[1] and not eng._reset_next[0]
        assert eng._bases[1] is None and eng._bases[0] is not None

    def test_restore_stream_recomputes_the_incremental_median_row(self):
        streams = 2
        ticks = _fleet_ticks(streams, 6)
        eng = TEngine(_params("torch", median_backend="inc"), streams, beams=BEAMS, buckets=(8,))
        for tick in ticks[:6]:
            eng.submit(tick)
        snap = eng.snapshot_stream(0)
        for tick in ticks[6:]:
            eng.submit(tick)
        assert eng.restore_stream(0, snap)
        fs = eng._state.filter
        np.testing.assert_array_equal(fs.median_sorted[0].numpy(),
                                      np.sort(snap["filter.range_window"], axis=0))

    def test_ingest_restore_stream_rejects_mismatch(self):
        eng = TEngine(_params("torch"), 2, beams=BEAMS, buckets=(4,))
        snap = eng.snapshot_stream(0)
        before = eng.snapshot()
        assert not eng.restore_stream(0, dict(snap, version=np.asarray(99, np.int32)))
        other = TEngine(_params("torch", filter_window=8), 2, beams=BEAMS, buckets=(4,))
        assert not other.restore_stream(0, snap)
        with pytest.raises(IndexError):
            eng.restore_stream(7, snap)
        with pytest.raises(IndexError):
            eng.snapshot_stream(2)
        after = eng.snapshot()
        for k in before:
            np.testing.assert_array_equal(after[k], before[k], err_msg=k)

    @pytest.mark.parametrize("backend", ["host", "fused"])
    def test_mapper_stream_roundtrip(self, backend):
        m = TFleetMapper(_map_params("torch", map_backend=backend), 3, beams=64)
        jm = JFleetMapper(_map_params("jax", map_backend=backend), 3, beams=64)
        rng = np.random.default_rng(0)
        pts = rng.uniform(-2, 2, (3, 64, 2)).astype(np.float32)
        masks = np.ones((3, 64), bool)
        for mapper in (m, jm):
            mapper.submit_points(pts, masks, np.ones((3,), np.int32))
        snap = m.snapshot_stream(1)
        for k in MAP_KEYS:
            np.testing.assert_array_equal(snap[k], np.asarray(jm.snapshot_stream(1)[k]))
        m.submit_points(pts + 0.5, masks, np.ones((3,), np.int32))
        assert not np.array_equal(snap["log_odds"], m.snapshot_stream(1)["log_odds"])
        assert m.restore_stream(1, snap)
        back = m.snapshot_stream(1)
        for k in MAP_KEYS:
            np.testing.assert_array_equal(back[k], snap[k], err_msg=k)
        assert m.snapshot_stream(0)["revision"] == 2
        assert not m.restore_stream(1, dict(snap, version=np.asarray(-5, np.int32)))


# ---------------------------------------------------------------------------
# the FSM and its backoff, the port's copy against the JAX package's
# ---------------------------------------------------------------------------


class TestBackoffPolicy:
    def test_caps_and_escalates(self):
        bp = thealth.BackoffPolicy(0.5, 4.0, jitter=0.0, seed=1)
        assert [bp.next_delay() for _ in range(6)] == [0.5, 1.0, 2.0, 4.0, 4.0, 4.0]
        bp.reset()
        assert bp.attempt == 0 and bp.next_delay() == 0.5

    def test_jitter_is_seed_deterministic_bounded_and_jax_equal(self):
        a = thealth.BackoffPolicy(1.0, 8.0, jitter=0.25, seed=42)
        b = jhealth.BackoffPolicy(1.0, 8.0, jitter=0.25, seed=42)
        da = [a.next_delay() for _ in range(5)]
        assert da == [b.next_delay() for _ in range(5)]
        for k, d in enumerate(da):
            raw = min(2.0 ** k, 8.0)
            assert raw <= d <= raw * 1.25

    def test_rejects_bad_config(self):
        for args, kw in (((0.0, 1.0), {}), ((2.0, 1.0), {}), ((1.0, 2.0), {"jitter": 1.5})):
            with pytest.raises(ValueError):
                thealth.BackoffPolicy(*args, **kw)

    def test_no_overflow_after_thousands_of_attempts(self):
        bp = thealth.BackoffPolicy(0.5, 30.0, jitter=0.0)
        for _ in range(3000):
            d = bp.next_delay()
        assert d == 30.0 and bp.attempt == 3000

    def test_health_config_validates_domain(self):
        for kw in (dict(window_ticks=0), dict(corrupt_ratio=1.5),
                   dict(backoff_base_s=2.0, backoff_max_s=1.0)):
            with pytest.raises(ValueError):
                thealth.HealthConfig(**kw)

    def test_health_config_from_params_matches_jax(self):
        over = dict(health_window_ticks=5, health_corrupt_ratio=0.3, health_suspect_ticks=3,
                    health_backoff_base_s=0.2, health_backoff_jitter=0.0)
        assert (thealth.HealthConfig.from_params(_params("torch", **over)).__dict__
                == jhealth.HealthConfig.from_params(_params("jax", **over)).__dict__)


def _fsm_cfg(h, **over):
    base = dict(window_ticks=4, corrupt_ratio=0.5, starvation_ticks=3, suspect_ticks=2,
                probation_ticks=2, backoff_base_s=1.0, backoff_jitter=0.0)
    base.update(over)
    return h.HealthConfig(**base)


def _walk(h, script, cfg_over=None, probe=None):
    """Drive one StreamHealth of module ``h`` through ``script``: a list of
    ("obs", frames, malformed, completed), ("now", t), ("poll",) or
    ("probe", value) steps.  Returns the transitions and final counters as
    plain values, comparable across the packages."""
    t = {"now": 0.0}
    sh = h.StreamHealth(_fsm_cfg(h, **(cfg_over or {})), clock=lambda: t["now"], probe=probe)
    out = []
    for step in script:
        if step[0] == "obs":
            tr = sh.observe(*step[1:])
        elif step[0] == "now":
            t["now"] = step[1] if step[1] >= 0 else sh.release_at - step[1]
            continue
        elif step[0] == "probe":
            sh.probe = (lambda v=step[1]: v)
            continue
        else:
            tr = sh.poll_release()
        out.append(None if tr is None else (tr[0].value, tr[1].value))
    return out, dict(state=sh.state.value, quarantines=sh.quarantines,
                     recoveries=sh.recoveries, attempt=sh.backoff.attempt,
                     failures=sh.reconnect_failures, admitted=sh.admitted,
                     reason=sh.last_reason, release_at=sh.release_at)


def _both(script, cfg_over=None, probe=None):
    got = _walk(thealth, script, cfg_over, probe)
    assert got == _walk(jhealth, script, cfg_over, probe)
    return got


class TestStreamHealthFsm:
    def test_corruption_walk_and_recovery(self):
        script = ([("obs", 4, 0, 1)] * 3 + [("obs", 4, 4, 0)] * 4 + [("poll",), ("now", 1.5),
                  ("poll",), ("obs", 4, 0, 1), ("obs", 4, 0, 1)])
        trs, end = _both(script, probe=lambda: 0)
        seen = [tr for tr in trs if tr]
        assert seen[:2] == [("healthy", "suspect"), ("suspect", "quarantined")]
        assert trs[7] is None  # backoff not expired
        assert trs[8] == ("quarantined", "recovering")
        assert trs[-1] == ("recovering", "healthy")
        assert end["recoveries"] == 1 and end["attempt"] == 0 and end["quarantines"] == 1

    def test_suspect_clears_on_probation(self):
        trs, end = _both([("obs", 4, 0, 1)] + [("obs", 4, 4, 0)] * 3 + [("obs", 4, 0, 1)] * 4,
                         cfg_over=dict(suspect_ticks=5))
        assert ("suspect", "healthy") in [tr for tr in trs if tr]
        assert end["state"] == "healthy"

    def test_starvation_of_streaming_stream(self):
        trs, end = _both([("obs", 4, 0, 1)] + [("obs", 0, 0, 0)] * 6,
                         cfg_over=dict(starvation_ticks=2))
        assert any(tr and tr[1] == "quarantined" for tr in trs)
        assert "starved" in end["reason"]

    def test_idle_stream_is_not_sick(self):
        trs, end = _both([("obs", 0, 0, 0)] * 10, cfg_over=dict(starvation_ticks=1))
        assert trs == [None] * 10 and end["state"] == "healthy"

    def test_probe_failure_rearms_escalated_backoff(self):
        script = ([("obs", 4, 0, 1)] + [("obs", 4, 4, 0)] * 4 + [("now", -0.1), ("poll",),
                  ("probe", True), ("now", -0.1), ("poll",)])
        trs, end = _both(script, cfg_over=dict(window_ticks=2, suspect_ticks=1,
                                               starvation_ticks=1), probe=lambda: 2)
        assert trs[5] is None  # the probe answered ERROR
        assert trs[6] == ("quarantined", "recovering")
        assert end["failures"] == 1

    def test_recovering_relapse_requarantines(self):
        script = ([("obs", 4, 0, 1)] + [("obs", 4, 4, 0)] * 3 + [("now", -0.1), ("poll",),
                  ("obs", 4, 4, 0)])
        trs, end = _both(script, cfg_over=dict(window_ticks=2, suspect_ticks=1,
                                               starvation_ticks=9))
        assert trs[4] == ("quarantined", "recovering")
        assert trs[5] == ("recovering", "quarantined")
        assert end["attempt"] >= 2


# ---------------------------------------------------------------------------
# the service seam
# ---------------------------------------------------------------------------


class TestServiceHealthSeam:
    def test_params_auto_attach_and_status(self):
        svc = TService(_params("torch", fleet_ingest_backend="fused", health_enable=True), 2,
                       beams=BEAMS, fleet_ingest_buckets=(8,))
        jsvc = JService(_params("jax", fleet_ingest_backend="fused", health_enable=True), 2,
                        beams=BEAMS, fleet_ingest_buckets=(8,))
        assert svc.health is not None
        st = svc.health_status()
        assert len(st) == 2 and all(s["state"] == "healthy" for s in st)
        assert st == jsvc.health_status()
        assert TService(_params("torch"), 2, beams=BEAMS).health_status() is None

    def test_attach_order_hook_chaining_and_diagnostics(self):
        """attach_health before attach_mapper still warms the mapper's row
        checkpoint (leaving its state as it was); caller hooks are chained
        after the service's; health_status renders through the diagnostics
        updater; every output equals the JAX service's run."""
        from rplidar_ros2_driver_tpu_torch.node.diagnostics import DiagnosticsUpdater
        from rplidar_ros2_driver_tpu_torch.node.lifecycle import LifecycleState
        from rplidar_ros2_driver_tpu_torch.node.publisher import CollectingPublisher

        streams = 2
        ticks = _fleet_ticks(streams, 6)
        runs = {}
        for pkg in PKGS:
            svc = _service(pkg, _map_params(pkg, fleet_ingest_backend="fused",
                                            map_backend="fused"),
                           streams, fleet_ingest_buckets=(8,))
            svc._ensure_byte_ingest()
            svc.fleet_ingest.precompile([DENSE])
            fake = {"now": 0.0}
            fired = []
            health = _health(pkg, streams, fake,
                             cfg=dict(starvation_ticks=2, backoff_base_s=0.3),
                             on_quarantine=lambda i, f=fired: f.append(("q", i)),
                             on_recover=lambda i, f=fired: f.append(("r", i)))
            svc.attach_health(health)
            svc.attach_mapper()
            assert int(np.asarray(svc.mapper.snapshot()["revision"]).sum()) == 0
            outs = []
            for t, tick in enumerate(ticks):
                row = list(tick)
                if t >= 4 and fired.count(("r", 1)) == 0:
                    row[1] = None  # silence until released
                outs.append(svc.submit_bytes(row))
                fake["now"] += 0.2
            runs[pkg] = (svc, fired, outs, health)
        svc, fired, outs, health = runs["torch"]
        assert ("q", 1) in fired and ("r", 1) in fired
        assert svc.quarantines >= 1 and svc.rejoins >= 1
        assert fired == runs["jax"][1]
        for t, (a, b) in enumerate(zip(runs["jax"][2], outs)):
            for i in range(streams):
                _assert_out_equal(a[i], b[i], f"tick {t} stream {i}")
        upd = DiagnosticsUpdater("rig", CollectingPublisher())
        status = upd.update(lifecycle=LifecycleState.ACTIVE, fsm_state=None, port="fleet",
                            rpm=0, device_info="", stream_health=svc.health_status())
        for i in range(streams):
            assert f"Stream {i} Health" in status.values
        with pytest.raises(ValueError):
            svc.attach_health(health, probes={0: lambda: 0})
        with pytest.raises(ValueError, match="streams"):
            svc.attach_health(thealth.FleetHealth(3, thealth.HealthConfig()))

    def test_backlog_drain_masks_quarantined_streams(self):
        ticks = _fleet_ticks(2, 4)
        svc = TService(_params("torch", fleet_ingest_backend="fused"), 2, beams=BEAMS,
                       fleet_ingest_buckets=(8,))
        svc._ensure_byte_ingest()
        health = svc.attach_health(clock=lambda: 0.0)
        health.health[0].state = thealth.StreamState.QUARANTINED
        health.health[0].release_at = 1e9
        results = svc.submit_bytes_backlog(ticks)
        assert results[0] == []
        assert len(results[1]) >= 2

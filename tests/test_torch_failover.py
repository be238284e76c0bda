"""The PyTorch package's failover pod against the JAX package's.

``parallel/service.ElasticFleetService`` (the per-tick seam: placement over
shards, shard supervision, per-stream snapshots, evacuation on shard loss
and re-admission, one dispatch a tick per shard) is run beside the JAX
package's pod on the same ticks, the same chaos schedule and the same fake
clock, at the JAX suite's small geometry (tests/test_failover.py: 256
beams, W = 4, a 64² map at 0.1 m).  For each of JAX's
``TestShardFailoverParity`` cases the events, the replay plan, every
published output, the snapshot store's ticks and every final map row are
byte-equal; the kill cycle runs under the port's ``guards.steady_state``.
Also: the carried map riding the v3 ingest snapshot through a failover
(JAX tests/test_fused_mapping.py), one staging pool per host (JAX
tests/test_super_tick.py), a JAX snapshot store restored into the port's
lanes and continued byte-equal, the service seams, the /diagnostics
payloads and the scheduled surfaces (held to JAX's pod in
tests/test_torch_pod_scaleout.py).
"""

from __future__ import annotations

import numpy as np
import pytest

from rplidar_ros2_driver_tpu.core.config import DriverParams as JParams
from rplidar_ros2_driver_tpu.driver.chaos import ShardChaosConfig as JChaosConfig
from rplidar_ros2_driver_tpu.driver.chaos import ShardChaosSchedule as JChaos
from rplidar_ros2_driver_tpu.ops import wire as jwire
from rplidar_ros2_driver_tpu.parallel.service import ElasticFleetService as JPod
from rplidar_ros2_driver_tpu_torch.core.config import DriverParams as TParams
from rplidar_ros2_driver_tpu_torch.driver.chaos import ShardChaosConfig as TChaosConfig
from rplidar_ros2_driver_tpu_torch.driver.chaos import ShardChaosSchedule as TChaos
from rplidar_ros2_driver_tpu_torch.driver.health import ShardState
from rplidar_ros2_driver_tpu_torch.parallel.service import ElasticFleetService as TPod
from rplidar_ros2_driver_tpu_torch.protocol.constants import Ans
from rplidar_ros2_driver_tpu_torch.utils import guards
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

BEAMS = 256
DENSE = int(Ans.MEASUREMENT_DENSE_CAPSULED)
# byte-equal fields; points_xy comes from the host-rounded trig table and
# sits within 2 ulp of the JAX package's (ROADMAP C.1)
OUT_FIELDS = ("ranges", "intensities", "point_mask", "voxel")
MAP_KEYS = ("log_odds", "pose", "origin_xy", "revision")
PKGS = {"jax": (JParams, JPod, JChaos, JChaosConfig), "torch": (TParams, TPod, TChaos, TChaosConfig)}


def _params(pkg: str, **over):
    base = dict(filter_backend="cpu", filter_chain=("clip", "median", "voxel"), filter_window=4,
                voxel_grid_size=32)
    base.update(over)
    return PKGS[pkg][0](**base)


def _pod_params(pkg: str, **over):
    """tests/test_failover.py's ``_pod_params``: the 64² map at 0.1 m, the
    fused fleet ingest, snapshots every 4 ticks, backoff 0.45 s."""
    base = dict(
        map_enable=True, map_grid=64, map_cell_m=0.1,
        fleet_ingest_backend="fused", map_backend="fused", shard_count=4, shard_lanes=0,
        failover_snapshot_ticks=4, shard_backoff_base_s=0.45, shard_backoff_max_s=2.0,
        shard_backoff_jitter=0.0, shard_starvation_ticks=8, shard_suspect_ticks=4,
        shard_probation_ticks=2,
    )
    base.update(over)
    return _params(pkg, **base)


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
    """Lockstep ticks (two a revolution): every stream streams every tick,
    each on its own stamp lane."""
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


def _pod(pkg: str, params, streams: int, shards: int, fake: dict, **kw):
    return PKGS[pkg][1](params, streams, shards=shards, beams=BEAMS, fleet_ingest_buckets=(8,),
                        clock=lambda: fake["now"], **kw)


def _chaos(pkg: str, kills):
    return PKGS[pkg][2](PKGS[pkg][3](kills=kills))


# the seven cases of JAX's TestShardFailoverParity, as data: fleet, params,
# the chaos schedule (attached before or after precompile), a silenced
# upstream ((streams), start, stop), a raised dispatch (shard, tick), and
# the warm ticks before the guarded loop
CASES = {
    "kill_evacuate_readmit": dict(streams=8, shards=4, revs=12, over={}, kills=((1, 10, 12),),
                                  warm=3),
    "heartbeat_failure": dict(streams=4, shards=2, revs=8,
                              over=dict(shard_count=2, map_enable=False), boom=(1, 4)),
    "starvation_loss": dict(streams=4, shards=2, revs=14,
                            over=dict(shard_count=2, map_enable=False, shard_starvation_ticks=2,
                                      shard_suspect_ticks=2),
                            silence=((1, 3), 6, 12)),
    "double_loss_unhosted": dict(streams=6, shards=3, revs=14,
                                 over=dict(shard_count=3, map_enable=False),
                                 kills=((0, 6, 12), (1, 9, 0))),
    "snapshots_disabled": dict(streams=4, shards=2, revs=8,
                               over=dict(shard_count=2, map_enable=False,
                                         failover_snapshot_ticks=0),
                               kills=((1, 5, 0),), chaos_after_precompile=True),
    "suspect_not_refreshed": dict(streams=4, shards=2, revs=10,
                                  over=dict(shard_count=2, map_enable=False,
                                            failover_snapshot_ticks=2, shard_starvation_ticks=2,
                                            shard_suspect_ticks=50),
                                  silence=((1, 3), 6, 14)),
    "same_tick_double_kill": dict(streams=8, shards=4, revs=8, over=dict(map_enable=False),
                                  kills=((1, 6, 0), (2, 6, 0))),
}


def _run_case(pkg: str, case: dict, stop_at=None) -> dict:
    """One pod of ``pkg`` through a case: outputs, the snapshot store's
    stored ticks after every tick, and the pod.  ``stop_at`` ends the run
    after that many ticks (the store is then copied out as ``store``)."""
    streams, shards = case["streams"], case["shards"]
    ticks = _fleet_ticks(streams, case["revs"])
    fake = {"now": 0.0}
    pod = _pod(pkg, _pod_params(pkg, **case["over"]), streams, shards, fake)
    kills = case.get("kills")
    if kills and not case.get("chaos_after_precompile"):
        pod.attach_shard_chaos(_chaos(pkg, kills))
    pod.precompile([DENSE])
    if kills and case.get("chaos_after_precompile"):
        pod.attach_shard_chaos(_chaos(pkg, kills))
    if "boom" in case:
        shard, boom = case["boom"]
        real = pod.shards[shard].submit_bytes

        def maybe_boom(items, real=real):
            if pod.tick_no == boom:
                raise RuntimeError("device fell off the bus")
            return real(items)

        pod.shards[shard].submit_bytes = maybe_boom
    warm = case.get("warm", len(ticks))
    outs, snap_ticks = [], []

    def advance(t, tick):
        tick = list(tick)
        if "silence" in case:
            quiet, start, stop = case["silence"]
            if start <= t < stop:
                for i in quiet:
                    tick[i] = None
        outs.append(pod.submit_bytes(tick))
        snap_ticks.append({i: e[0] for i, e in pod._snap.items()})
        fake["now"] += 0.1

    n = len(ticks) if stop_at is None else stop_at
    for t in range(min(warm, n)):
        advance(t, ticks[t])
    if pkg == "torch" and warm < n:
        with guards.steady_state(tag="shard kill/evacuate/readmit"):
            for t in range(warm, n):
                advance(t, ticks[t])
    else:
        for t in range(warm, n):
            advance(t, ticks[t])
    rec = {"pod": pod, "outs": outs, "snap_ticks": snap_ticks, "ticks": ticks}
    if stop_at is not None:
        rec["store"] = {i: (tk, {k: {f: np.array(v) for f, v in part.items()}
                                 for k, part in snap.items()})
                        for i, (tk, snap) in pod._snap.items()}
    return rec


_RUNS: dict = {}


def _runs(name: str) -> dict:
    """Both packages' runs of a case, once per module."""
    if name not in _RUNS:
        _RUNS[name] = {pkg: _run_case(pkg, CASES[name]) for pkg in ("jax", "torch")}
    return _RUNS[name]


def ulp_distance(a, b) -> np.ndarray:
    def ordered(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)

    return np.abs(ordered(a) - ordered(b))


def _assert_out_equal(a, b, what):
    assert (a is None) == (b is None), what
    if a is not None:
        for f in OUT_FIELDS:
            np.testing.assert_array_equal(np.asarray(getattr(a, f)), np.asarray(getattr(b, f)),
                                          err_msg=f"{what} {f}")
        assert ulp_distance(np.asarray(a.points_xy), np.asarray(b.points_xy)).max() <= 2, what


def _map_row(pod, stream: int) -> dict:
    s, lane = pod.topology.placement(stream)
    return pod.shards[s].mapper.snapshot_stream(lane)


def _assert_pods_equal(j: dict, t: dict) -> None:
    jp, tp = j["pod"], t["pod"]
    assert tp.events == jp.events
    assert tp.replay_plan() == jp.replay_plan()
    assert t["snap_ticks"] == j["snap_ticks"]
    assert len(t["outs"]) == len(j["outs"])
    for k, (ro, rj) in enumerate(zip(t["outs"], j["outs"])):
        for i, (a, b) in enumerate(zip(ro, rj)):
            _assert_out_equal(a, b, f"tick {k} stream {i}")
    for name in ("evacuations", "migrations", "readmits", "streams_lost_unhosted",
                 "last_migration_tick", "shard_evacuations", "shard_migrations_in",
                 "shard_last_migration_tick"):
        assert getattr(tp, name) == getattr(jp, name), name
    assert tp.topology.unhosted() == jp.topology.unhosted()
    assert [hs.state.name for hs in tp.shard_health] == [hs.state.name for hs in jp.shard_health]
    assert [tp.topology.placement(i) for i in range(tp.streams)] == [
        jp.topology.placement(i) for i in range(jp.streams)]
    if tp.last_evacuation is not None:
        for key in ("tick", "shard", "streams"):
            assert tp.last_evacuation[key] == jp.last_evacuation[key], key
    if tp.shards[0].mapper is not None:
        for i in range(tp.streams):
            if tp.topology.placement(i) is None:
                continue
            a, b = _map_row(tp, i), _map_row(jp, i)
            for k in MAP_KEYS:
                np.testing.assert_array_equal(a[k], np.asarray(b[k]), err_msg=f"stream {i} {k}")


def _check_kill_evacuate_readmit(pod, rec):
    assert pod.topology.lanes == 3  # auto: ceil(8 / (4 - 1))
    assert pod.evacuations == 1 and pod.readmits == 1 and pod.migrations == 4
    assert pod.shard_health[1].state is ShardState.UP and pod.topology.unhosted() == []
    victims = {e[2] for e in pod.events if e[1] == "evacuated"}
    assert victims == {1, 5}
    readmit = next(t for (t, kind, *_r) in pod.events if kind == "readmitting")
    plan = pod.replay_plan()
    for i in range(pod.streams):
        if i in victims:
            assert plan[i] == {"excluded": [8, 9], "resets": [10, readmit]}, i
        else:
            assert plan[i] == {"excluded": [], "resets": []}, i
    ev = pod.last_evacuation
    assert ev["shard"] == 1 and sorted(ev["streams"]) == [1, 5]
    assert ev["restore_scatter_ms"] > 0.0 and ev["first_tick_ms"] > 0.0
    post = sum(rec["outs"][t][i] is not None for t in range(readmit, len(rec["outs"]))
               for i in victims)
    assert post >= 2  # the victims published after migrating back


def _check_heartbeat_failure(pod, rec):
    assert pod.evacuations == 1 and pod.shard_health[1].losses == 1
    lost = next(e for e in pod.events if e[1] == "lost")
    assert lost[2] == 1 and "heartbeat" in lost[3]
    plan = pod.replay_plan()
    for i in (1, 3):
        assert 4 in plan[i]["excluded"] and 4 in plan[i]["resets"], i


def _check_starvation_loss(pod, rec):
    lost = next(e for e in pod.events if e[1] == "lost")
    assert lost[2] == 1 and "starved" in lost[3]
    assert pod.evacuations == 1 and pod.readmits == 1
    assert pod.shard_health[1].state is ShardState.UP
    for i in (1, 3):
        # the t=7 refresh fell in the SUSPECT window: the last trusted
        # snapshot is t=3, so the victims' data ticks 4 and 5 are lost
        assert pod.replay_plan()[i]["excluded"] == [4, 5], i
        assert len(pod.replay_plan()[i]["resets"]) == 2, i


def _check_double_loss_unhosted(pod, rec):
    assert pod.evacuations == 2 and pod.readmits == 1 and pod.topology.unhosted() == []
    readmit = next(t for (t, kind, *_r) in pod.events if kind == "readmitting")
    plan = pod.replay_plan()
    for i in (1, 4, 0):
        assert 8 in plan[i]["excluded"], (i, plan[i])
        assert set(range(9, readmit)) <= set(plan[i]["excluded"]), i
        assert readmit in plan[i]["resets"], i


def _check_snapshots_disabled(pod, rec):
    for i in (1, 3):
        assert pod.replay_plan()[i]["excluded"] == list(range(5)), i


def _check_suspect_not_refreshed(pod, rec):
    st = rec["snap_ticks"]
    assert st[8][1] == 5 and st[13][1] == st[8][1] and st[13][3] == st[8][3]
    assert pod.shard_health[1].state is ShardState.UP
    for i in (1, 3):
        assert pod._snap[i][0] > st[8][i], i
    for i in (0, 2):
        assert pod._snap[i][0] == len(rec["outs"]) - 1, i


def _check_same_tick_double_kill(pod, rec):
    assert pod.evacuations == 2
    evac = [e for e in pod.events if e[1] == "evacuated"]
    assert evac and all(e[4] in (0, 3) for e in evac)
    moved = [e[2] for e in evac]
    assert len(moved) == len(set(moved)) == 2
    assert len(pod.topology.unhosted()) == 2 and pod.migrations == 2


@pytest.mark.parametrize("name", list(CASES))
def test_pod_matches_the_jax_pod(name):
    """Events, replay plan, every output, the snapshot store's ticks and
    the final map rows byte-equal to the JAX pod's; the case's own
    structural claims hold on the port's pod."""
    runs = _runs(name)
    _assert_pods_equal(runs["jax"], runs["torch"])
    globals()[f"_check_{name}"](runs["torch"]["pod"], runs["torch"])


def test_kill_cycle_one_dispatch_a_tick_on_the_survivors():
    """Fault isolation: every surviving shard dispatched once a tick
    through the kill cycle, warm-up ticks included."""
    pod = _runs("kill_evacuate_readmit")["torch"]["pod"]
    n = len(_runs("kill_evacuate_readmit")["torch"]["outs"])
    for s, sh in enumerate(pod.shards):
        if s != 1:
            assert sh.fleet_ingest.dispatch_count == n, s


def test_jax_snapshot_store_continues_byte_equal_in_the_port():
    """A JAX pod's snapshot store (tick 7 of the kill-cycle case) restored
    into fresh pods of both packages with ``_restore_into``, lane for lane,
    then the remaining ticks: every output and final map row equal."""
    case = dict(CASES["kill_evacuate_readmit"], kills=None)
    j = _run_case("jax", case, stop_at=8)
    ticks = j["ticks"]
    conts = {}
    for pkg in ("jax", "torch"):
        fake = {"now": 0.0}
        pod = _pod(pkg, _pod_params(pkg), case["streams"], case["shards"], fake)
        pod.precompile([DENSE])
        for stream, (_tk, snap) in j["store"].items():
            s, lane = pod.topology.placement(stream)
            pod._restore_into(stream, s, lane, {k: dict(v) for k, v in snap.items()})
        outs = [pod.submit_bytes(tick) for tick in ticks[8:]]
        conts[pkg] = (pod, outs)
    (jp, jo), (tp, to) = conts["jax"], conts["torch"]
    assert sum(o is not None for row in to for o in row) >= 8
    for k, (ro, rj) in enumerate(zip(to, jo)):
        for i, (a, b) in enumerate(zip(ro, rj)):
            _assert_out_equal(a, b, f"tick {k} stream {i}")
    for i in range(case["streams"]):
        a, b = _map_row(tp, i), _map_row(jp, i)
        for k in MAP_KEYS:
            np.testing.assert_array_equal(a[k], np.asarray(b[k]), err_msg=f"stream {i} {k}")


# ---------------------------------------------------------------------------
# the carried map rides the v3 ingest snapshot
# ---------------------------------------------------------------------------


def _carried_params(pkg: str, **over):
    """tests/test_fused_mapping.py's fused route (de-skew on, a 32² map at
    0.2 m) with its failover settings."""
    return _params(pkg, **{**dict(
        voxel_grid_size=16, fleet_ingest_backend="fused", deskew_enable=True,
        sweep_reconstruct_window=3, deskew_profile_beams=64, deskew_shift_window=4,
        map_enable=True, map_backend="host", fused_mapping_backend="fused", map_grid=32,
        map_cell_m=0.2, shard_count=2, shard_lanes=2, failover_snapshot_ticks=2,
        shard_backoff_base_s=0.45, shard_backoff_max_s=2.0, shard_backoff_jitter=0.0,
        shard_probation_ticks=2), **over})


def _drift_frames(revs: int, ppr: int = 400, drift_per_rev: float = 40.0, seed: int = 0):
    rng = np.random.default_rng(seed)
    frames, idx, first = [], 0, True
    while idx < revs * ppr:
        theta = 360.0 * (idx % ppr) / ppr
        pts = (np.arange(40) + idx) % ppr
        dists = (2000.0 + 500.0 * np.sin(2 * np.pi * pts / ppr) + drift_per_rev * (idx / ppr)
                 + rng.uniform(0.0, 0.25))
        frames.append(jwire.encode_dense_capsule(int(theta * 64) & 0x7FFF, first,
                                                 dists.astype(int)))
        idx += 40
        first = False
    return frames


def _byte_ticks(frames, streams: int, run: int = 4, t0: float = 100.0):
    ticks = []
    t = [t0 + 5.0 * s for s in range(streams)]
    for i in range(0, len(frames), run):
        tick = []
        for s in range(streams):
            batch = []
            for f in frames[i : i + run]:
                t[s] += 1.25e-3
                batch.append((f, t[s]))
            tick.append((DENSE, batch))
        ticks.append(tick)
    return ticks


def test_failover_transport_carried_map():
    """The pod on the fused mapping route: a chaos kill's victim restores
    onto the survivor WITH its carried map rows — they travel inside the v3
    ingest snapshot (no "map" key in the store) and the revision keeps
    advancing after the migration; events, outputs and final map rows
    equal the JAX pod's."""
    ticks = _byte_ticks(_drift_frames(4), 2)
    runs = {}
    for pkg in ("jax", "torch"):
        fake = {"now": 0.0}
        pod = PKGS[pkg][1](_carried_params(pkg), 2, shards=2, beams=BEAMS, capacity=1024,
                           fleet_ingest_buckets=(4,), clock=lambda f=fake: f["now"])
        pod.attach_shard_chaos(_chaos(pkg, ((1, 8, 10),)))
        pod.precompile([DENSE])
        outs, revs = [], []
        for tick in ticks:
            outs.append(pod.submit_bytes(tick))
            fake["now"] += 0.1
            got = pod.topology.placement(1)
            revs.append(None if got is None else int(np.asarray(
                pod.shards[got[0]].mapper.snapshot_stream(got[1])["revision"])))
        runs[pkg] = (pod, outs, revs)
    (jp, jo, jr), (tp, to, tr) = runs["jax"], runs["torch"]
    assert tp.shards[0].mapper.backend == "carried"
    assert tp.events == jp.events and tp.replay_plan() == jp.replay_plan()
    assert tr == jr
    kinds = [e[1] for e in tp.events]
    assert "lost" in kinds and "evacuated" in kinds
    for _t, snap in tp._snap.values():
        assert "map" not in snap
        assert all(f"ingest.map_{k}" in snap["ingest"] for k in MAP_KEYS)
    # round robin: stream 1 is shard 1's, the victim
    t_move, _kind, victim, *_rest = next(e for e in tp.events if e[1] == "evacuated")
    assert victim == 1
    assert tr[-1] > tr[t_move] > 0  # the revision still advances after migrating
    for k, (ro, rj) in enumerate(zip(to, jo)):
        for i, (a, b) in enumerate(zip(ro, rj)):
            _assert_out_equal(a, b, f"tick {k} stream {i}")
    for i in range(2):
        a, b = _map_row(tp, i), _map_row(jp, i)
        for k in MAP_KEYS:
            np.testing.assert_array_equal(a[k], np.asarray(b[k]), err_msg=f"stream {i} {k}")


# ---------------------------------------------------------------------------
# staging pools, seams, diagnostics
# ---------------------------------------------------------------------------


def test_elastic_pod_shares_one_pool_per_host():
    pod = TPod(_params("torch", fleet_ingest_backend="fused"), 4, shards=2, hosts=2,
               beams=BEAMS, fleet_ingest_buckets=(4,))
    assert len(pod.staging_pools) == 2
    for s, sh in enumerate(pod.shards):
        sh._ensure_byte_ingest()
        assert sh.fleet_ingest.staging is pod.staging_pools[pod.topology.host_of(s)]
    pod1 = TPod(_params("torch", fleet_ingest_backend="fused"), 4, shards=2, beams=BEAMS,
                fleet_ingest_buckets=(4,))
    assert len(pod1.staging_pools) == 1
    for sh in pod1.shards:
        sh._ensure_byte_ingest()
    assert pod1.shards[0].fleet_ingest.staging is pod1.shards[1].fleet_ingest.staging


def test_shared_pool_pairs_return_at_fetch_and_at_cold_reset():
    """Two shards' engines stage through one pool: after each tick the
    pairs are back in it (given back at fetch), and a cold reset with a
    dispatched but unparsed entry gives that entry's pair back too."""
    pod = TPod(_pod_params("torch", shard_count=2, map_enable=False), 4, shards=2, beams=BEAMS,
               fleet_ingest_buckets=(8,))
    pod.precompile([DENSE])
    pool = pod.staging_pools[0]
    ticks = _fleet_ticks(4, 2)
    for tick in ticks[:2]:
        pod.submit_bytes(tick)
    assert sum(len(v) for v in pool._free.values()) == 1  # one pair, reused
    eng = pod.shards[1].fleet_ingest
    eng.submit_pipelined(pod.topology.lane_items(1, ticks[2]))  # one entry left pending
    assert len(eng._pending) == 1 and sum(len(v) for v in pool._free.values()) == 0
    eng.cold_reset()
    assert len(eng._pending) == 0 and sum(len(v) for v in pool._free.values()) == 1


@pytest.mark.parametrize("shards,streams,lanes", [(2, 4, 4), (1, 3, 3)])
def test_auto_lanes_and_single_shard(shards, streams, lanes):
    pod = TPod(_pod_params("torch", shard_count=shards, map_enable=False), streams,
               shards=shards, beams=BEAMS, fleet_ingest_buckets=(8,))
    assert pod.topology.lanes == lanes


def test_host_backend_rejected():
    with pytest.raises(ValueError, match="fused"):
        TPod(_pod_params("torch", shard_count=2, map_enable=False, fleet_ingest_backend="host"),
             4, shards=2, beams=BEAMS)


def test_migration_before_precompile_refused():
    pod = TPod(_pod_params("torch", shard_count=2, map_enable=False), 4, shards=2, beams=BEAMS,
               fleet_ingest_buckets=(8,))
    with pytest.raises(RuntimeError, match="precompile"):
        pod._restore_into(0, 0, 0, None)


def test_wrong_item_count_rejected():
    pod = TPod(_pod_params("torch", shard_count=2, map_enable=False), 4, shards=2, beams=BEAMS,
               fleet_ingest_buckets=(8,))
    with pytest.raises(ValueError, match="per-stream"):
        pod.submit_bytes([None] * 3)


def test_cold_reset_needs_its_template():
    pod = TPod(_pod_params("torch", shard_count=2, map_enable=False), 4, shards=2, beams=BEAMS,
               fleet_ingest_buckets=(8,))
    pod.shards[0]._ensure_byte_ingest()
    with pytest.raises(RuntimeError, match="capture_cold_template"):
        pod.shards[0].fleet_ingest.cold_reset()


@pytest.mark.parametrize("call", ["attach_scheduler", "offer_bytes", "drain_scheduled",
                                  "attach_world_map"])
def test_scheduled_surfaces_are_served(call):
    """The pod's scheduled seam (ROADMAP A.10b) is served: one shaper with a
    ladder per shard, admission on offer, a drain through every hosting
    shard, and the pod world over the shard mappers."""
    pod = TPod(_pod_params("torch", shard_count=2, map_enable=call == "attach_world_map",
                           world_map_enable=call == "attach_world_map", sched_rungs=(1, 2)),
               4, shards=2, beams=BEAMS, fleet_ingest_buckets=(8,))
    assert pod.scheduler_status() is None
    shaper = pod.attach_scheduler()
    assert len(shaper.ladders) == 2 and pod.scheduler_status()["backlog"] == [0] * 4
    assert all(sh.fleet_ingest.rungs == (1, 2) for sh in pod.shards)
    if call == "attach_scheduler":
        return
    pod.precompile([DENSE])
    if call == "attach_world_map":
        world = pod.attach_world_map()
        assert pod.world is world and pod.world_status()["merges"] == 0
        return
    ticks = _fleet_ticks(4, 2)
    pod.offer_bytes([[t[i] for t in ticks[:3]] for i in range(4)])
    assert shaper.backlog_depths() == [3] * 4
    if call == "offer_bytes":
        with pytest.raises(ValueError, match="per-stream items"):
            pod.offer_bytes([None] * 3)
        return
    outs = pod.drain_scheduled()
    assert len(outs) == 4 and shaper.backlog_depths() == [0] * 4
    assert [(t, s, r, d) for t, s, r, d in pod.rung_log] == [(0, 0, 2, 3), (0, 1, 2, 3)]
    assert pod.tick_no == 1


def _render(payload):
    from rplidar_ros2_driver_tpu_torch.node.diagnostics import DiagnosticsUpdater
    from rplidar_ros2_driver_tpu_torch.node.lifecycle import LifecycleState
    from rplidar_ros2_driver_tpu_torch.node.publisher import CollectingPublisher

    return DiagnosticsUpdater("rig", CollectingPublisher()).update(
        lifecycle=LifecycleState.ACTIVE, fsm_state=None, port="pod", rpm=0, device_info="",
        shard_topology=payload,
    )


def test_shard_topology_rendering_pinned():
    payload = {
        "shards": [
            {"state": "up", "streams": [0, 4], "reason": "", "evacuations": 0,
             "migrations_in": 2, "last_migration_tick": 15},
            {"state": "lost", "streams": [], "reason": "chaos: shard killed", "evacuations": 1,
             "migrations_in": 0, "last_migration_tick": None},
        ],
        "evacuations": 1, "migrations": 4, "readmits": 1, "last_migration_tick": 15,
        "unhosted": [],
    }
    status = _render(payload)
    assert status.values["Shard 0"] == "up [0,4]"
    assert status.values["Shard 1"] == "lost [] (chaos: shard killed)"
    assert status.values["Evacuations"] == "1"
    assert status.values["Stream Migrations"] == "4"
    assert status.values["Shard Readmissions"] == "1"
    assert status.values["Last Migration Tick"] == "15"


def test_pod_payloads_feed_the_renderer_as_jax_pods_do():
    """failover_status() renders without adaptation, and after the kill
    cycle both payloads (failover_status, pod_status) equal the JAX pod's."""
    pod = TPod(_pod_params("torch", shard_count=2, map_enable=False), 4, shards=2, beams=BEAMS,
               fleet_ingest_buckets=(8,))
    status = _render(pod.failover_status())
    assert status.values["Shard 0"] == "up [0,2]"
    assert status.values["Shard 1"] == "up [1,3]"
    assert status.values["Last Migration Tick"] == "n/a"
    runs = _runs("kill_evacuate_readmit")
    tp, jp = runs["torch"]["pod"], runs["jax"]["pod"]
    assert tp.failover_status() == jp.failover_status()
    assert tp.pod_status() == jp.pod_status()
    assert _render(tp.failover_status()).values == _render(jp.failover_status()).values

"""The PyTorch package's scheduled serving pod against the JAX package's:
``ElasticFleetService.attach_scheduler`` / ``offer_bytes`` /
``drain_scheduled`` with cross-shard work stealing, the byte-rate autoscaler
(park, shed, unpark), a chaos kill on the scheduled seam and the pod-level
world map (``attach_world_map``).

JAX's tests/test_scheduler.py pod cases (TestPodStealByteEqual,
TestAutoscaleParkShed, the pod diagnostics), tests/test_guards.py's
TestPodScaleoutSteadyState and tests/test_world_map.py's cross-shard pod
merge, at one smoke geometry for all (6 streams over 3 shards, 256 beams,
W = 4, the fused FleetMapper on a 64² map at 0.1 m, buckets of 8, rungs 1,
2, 4), so each package builds its steps once.  Each JAX pod runs once per
module; the port's pod is held to it — every drained output (``points_xy``
within 2 ulp), the events, steal log, scale events, rung log, sheds,
snapshot store ticks, replay plan, final map rows, scheduler and pod
payloads and the world's accumulation and tiles.  The policies decide
where and when a queue drains, never what: the port's stealing and
autoscaling pod is byte-equal to its static pod, under
``guards.steady_state`` (on the CPU: nothing built).
"""

from __future__ import annotations

import numpy as np
import pytest

from rplidar_ros2_driver_tpu.driver.chaos import ShardChaosConfig as JChaosConfig
from rplidar_ros2_driver_tpu.driver.chaos import ShardChaosSchedule as JChaos
from rplidar_ros2_driver_tpu.mapping.tiles import snapshot_grid as jsnapshot_grid
from rplidar_ros2_driver_tpu.parallel.service import ElasticFleetService as JPod
from rplidar_ros2_driver_tpu_torch.driver.chaos import ShardChaosConfig as TChaosConfig
from rplidar_ros2_driver_tpu_torch.driver.chaos import ShardChaosSchedule as TChaos
from rplidar_ros2_driver_tpu_torch.mapping.tiles import snapshot_grid as tsnapshot_grid
from rplidar_ros2_driver_tpu_torch.parallel.service import ElasticFleetService as TPod
from rplidar_ros2_driver_tpu_torch.utils import guards

from test_torch_failover import DENSE, MAP_KEYS, _assert_out_equal, _fleet_ticks, _params
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

BEAMS = 256
STREAMS, SHARDS = 6, 3
PODS = {"jax": (JPod, JChaos, JChaosConfig), "torch": (TPod, TChaos, TChaosConfig)}


def _pod_params(pkg, **over):
    """JAX tests/test_chaos.py's ``_map_params`` with the pod keys of its
    scheduler suite: the fused FleetMapper on 64² at 0.1 m, snapshots every
    4 ticks, starvation out of the way, rungs 1, 2, 4."""
    base = dict(map_enable=True, map_grid=64, map_cell_m=0.1, fleet_ingest_backend="fused",
                map_backend="fused", shard_count=SHARDS, failover_snapshot_ticks=4,
                shard_starvation_ticks=500, sched_rungs=(1, 2, 4))
    base.update(over)
    return _params(pkg, **base)


def _pod(pkg, params, fake=None, kills=None):
    pod_cls, chaos_cls, chaos_cfg = PODS[pkg]
    kw = {} if fake is None else {"clock": lambda: fake["now"]}
    pod = pod_cls(params, STREAMS, shards=SHARDS, beams=BEAMS, fleet_ingest_buckets=(8,), **kw)
    pod.attach_scheduler()
    if kills:
        pod.attach_shard_chaos(chaos_cls(chaos_cfg(kills=kills)))
    pod.precompile([DENSE])
    return pod


def _drive(pod, wall, fake=None, guard_from=None):
    """Offer and drain every wall tick; per-stream outputs and the
    snapshot store's ticks after each drain.  From wall tick
    ``guard_from`` on the loop runs under guards.steady_state."""
    outs = [[] for _ in range(STREAMS)]
    store = []

    def tick(items):
        pod.offer_bytes(items)
        for i, g in enumerate(pod.drain_scheduled()):
            outs[i].extend(g)
        store.append({i: e[0] for i, e in pod._snap.items()})
        if fake is not None:
            fake["now"] += 0.1

    cut = len(wall) if guard_from is None else guard_from
    for items in wall[:cut]:
        tick(items)
    if guard_from is not None:
        with guards.steady_state(tag="scheduled pod"):
            for items in wall[cut:]:
                tick(items)
    return outs, store


def _map_rows(pod) -> list:
    rows = []
    for i in range(pod.streams):
        got = pod.topology.placement(i)
        rows.append(None if got is None else
                    {k: np.asarray(v) for k, v in
                     pod.shards[got[0]].mapper.snapshot_stream(got[1]).items() if k in MAP_KEYS})
    return rows


def _record(pod, outs, store) -> dict:
    sched = pod.scheduler_status()
    sched.pop("latency_model")  # wall-clock measurements
    return {
        "pod": pod, "outs": outs, "store": store, "events": list(pod.events),
        "rung_log": list(pod.rung_log), "scale_events": list(pod.scale_events),
        "steal_log": list(pod.scheduler.steal_log), "plan": pod.replay_plan(),
        "sched": sched, "pod_status": pod.pod_status(), "failover": pod.failover_status(),
        "counters": {k: getattr(pod, k) for k in ("steal_drops", "park_sheds", "evacuations",
                                                  "migrations", "readmits",
                                                  "streams_lost_unhosted")},
        "admission": (list(pod.scheduler.admission_drops), pod.scheduler.shed_total),
        "dispatches": [None if sh.fleet_ingest is None else
                       (sh.fleet_ingest.dispatch_count, dict(sh.fleet_ingest.rung_dispatches))
                       for sh in pod.shards],
        "maps": _map_rows(pod),
    }


def _assert_outs_equal(a, b, what):
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        assert len(x) == len(y), f"{what} stream {i}: {len(x)} != {len(y)}"
        for k, (p, q) in enumerate(zip(x, y)):
            _assert_out_equal(p, q, f"{what} stream {i} rev {k}")


def _assert_records_equal(t: dict, j: dict) -> None:
    _assert_outs_equal(t["outs"], j["outs"], "port vs jax")
    for key in ("store", "events", "rung_log", "scale_events", "steal_log", "plan", "sched",
                "pod_status", "failover", "counters", "admission", "dispatches"):
        assert t[key] == j[key], key
    for i, (a, b) in enumerate(zip(t["maps"], j["maps"])):
        assert (a is None) == (b is None)
        if a is not None:
            for k in MAP_KEYS:
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"stream {i} {k}")


# ---------------------------------------------------------------------------
# steals and a whole autoscale cycle (JAX TestPodScaleoutSteadyState,
# TestPodStealByteEqual)
# ---------------------------------------------------------------------------


def _scaleout_params(pkg, pod_arm: bool):
    return _pod_params(pkg, admission_max_backlog_ticks=16,
                       steal_threshold_ticks=2 if pod_arm else 0, autoscale_enable=pod_arm,
                       autoscale_low_watermark=0.3, autoscale_high_watermark=0.75,
                       autoscale_hysteresis_ticks=3)


@pytest.fixture(scope="module")
def scaleout_wall():
    """Skewed bursts on shard 0's two streams (steals), an idle stretch (a
    park), a full resume (the unpark)."""
    ticks = _fleet_ticks(STREAMS, 24)
    deep = [0, 3]  # shard 0's lanes: round-robin placement
    cursor = [0] * STREAMS

    def take(i, n):
        got = [ticks[t][i] for t in range(cursor[i], min(cursor[i] + n, len(ticks)))]
        cursor[i] += len(got)
        return [g for g in got if g] or None

    wall = [[take(i, 4 if i in deep else 1) for i in range(STREAMS)] for _ in range(6)]
    wall += [[None] * STREAMS for _ in range(8)]
    wall += [[take(i, 1) for i in range(STREAMS)] for _ in range(14)]
    return wall


@pytest.fixture(scope="module")
def jax_scaleout(scaleout_wall):
    pod = _pod("jax", _scaleout_params("jax", True))
    return _record(pod, *_drive(pod, scaleout_wall))


@pytest.fixture(scope="module")
def torch_scaleout(scaleout_wall):
    pod = _pod("torch", _scaleout_params("torch", True))
    return _record(pod, *_drive(pod, scaleout_wall, guard_from=2))


def test_steal_and_scale_cycle_matches_jax(torch_scaleout, jax_scaleout):
    _assert_records_equal(torch_scaleout, jax_scaleout)


def test_steal_and_scale_cycle_happened(torch_scaleout):
    pod = torch_scaleout["pod"]
    assert pod.scheduler.steals > 0 and pod.steal_drops == 0
    assert pod.scheduler.steal_ticks == sum(n for *_, n in pod.scheduler.steal_log)
    # whole queues of shard 0's two bursting streams, borrowed by siblings
    assert all(src == 0 and dst != 0 and stream in (0, 3)
               for dst, src, stream, _n in pod.scheduler.steal_log)
    downs = [e for e in pod.scale_events if e[1] == "down"]
    ups = [e for e in pod.scale_events if e[1] == "up"]
    assert downs and ups and pod.pod_status()["parked"] == []
    assert any(e[1] == "stolen" for e in pod.events)
    assert all(len(o) > 0 for o in torch_scaleout["outs"])


def test_static_pod_is_byte_equal_and_inert(scaleout_wall, torch_scaleout):
    pod = _pod("torch", _scaleout_params("torch", False))
    outs, _store = _drive(pod, scaleout_wall, guard_from=2)
    assert pod.scheduler.steals == 0 and pod.scale_events == [] and pod.autoscaler is None
    _assert_outs_equal(outs, torch_scaleout["outs"], "static vs steal + autoscale")


def test_pod_payloads_render_as_jax_does(torch_scaleout, jax_scaleout):
    from rplidar_ros2_driver_tpu.node.diagnostics import DiagnosticsUpdater as JUpd
    from rplidar_ros2_driver_tpu.node.lifecycle import LifecycleState as JLs
    from rplidar_ros2_driver_tpu.node.publisher import CollectingPublisher as JPub
    from rplidar_ros2_driver_tpu_torch.node.diagnostics import DiagnosticsUpdater
    from rplidar_ros2_driver_tpu_torch.node.lifecycle import LifecycleState
    from rplidar_ros2_driver_tpu_torch.node.publisher import CollectingPublisher

    kw = dict(pod=torch_scaleout["pod_status"], scheduler=torch_scaleout["sched"],
              shard_topology=torch_scaleout["failover"])
    got = DiagnosticsUpdater("rig", CollectingPublisher()).update(
        lifecycle=LifecycleState.ACTIVE, fsm_state=None, port="pod", rpm=0, device_info="",
        **kw).values
    want = JUpd("rig", JPub()).update(
        lifecycle=JLs.ACTIVE, fsm_state=None, port="pod", rpm=0, device_info="",
        pod=jax_scaleout["pod_status"], scheduler=jax_scaleout["sched"],
        shard_topology=jax_scaleout["failover"]).values
    assert got == want
    assert got["Autoscaler"].startswith(("steady", "thin", "pressure"))
    assert int(got["Steals"]) == torch_scaleout["pod"].scheduler.steals


# ---------------------------------------------------------------------------
# park -> shed -> unpark (JAX TestAutoscaleParkShed)
# ---------------------------------------------------------------------------


def _fake_tick(n=1):
    return (DENSE, [(b"\xa5" * 84, 1.0 + 0.001 * k) for k in range(n)])


def _park_cycle(pkg) -> dict:
    pod = _pod(pkg, _pod_params(pkg, autoscale_enable=True))
    trace = []
    for _ in range(2):
        pod.offer_bytes([_fake_tick()] * STREAMS)
        pod.drain_scheduled()
    pod._park_shard(2)
    trace.append(("park2", pod.park_sheds, pod.scheduler.shed_total, pod.topology.unhosted()))
    stranded = sorted(pod.topology.streams_on(1))
    pod.offer_bytes([_fake_tick()] * STREAMS)
    depth = {s: len(pod.scheduler.queues[s]) for s in stranded}
    drops_before = list(pod.scheduler.admission_drops)
    pod._park_shard(1)
    trace.append(("park1", stranded, depth, drops_before, list(pod.scheduler.admission_drops),
                  pod.park_sheds, pod.scheduler.shed_total, pod.topology.unhosted(),
                  pod.streams_lost_unhosted, pod.pod_status(), sorted(pod._snap)))
    pod._unpark_shard(1)
    trace.append(("unpark1", pod.topology.unhosted(), pod.streams_lost_unhosted,
                  pod.pod_status()))
    pod.offer_bytes([_fake_tick()] * STREAMS)
    outs = pod.drain_scheduled()
    trace.append(("drain", [len(o) for o in outs], list(pod.events), pod.replay_plan(),
                  [(hs.state.name, pod.topology.streams_on(s))
                   for s, hs in enumerate(pod.shard_health)]))
    return {"pod": pod, "trace": trace, "stranded": stranded, "depth": depth,
            "drops_before": drops_before}


@pytest.fixture(scope="module")
def jax_park():
    return _park_cycle("jax")["trace"]


def test_park_pre_sheds_stranded_backlog_then_unpark_restores(jax_park):
    run = _park_cycle("torch")
    assert run["trace"] == jax_park
    pod, stranded, depth = run["pod"], run["stranded"], run["depth"]
    park2, park1 = run["trace"][0], run["trace"][1]
    assert park2[1:] == (0, 0, [])  # the first park moved every row live
    assert stranded and all(d > 0 for d in depth.values())
    assert park1[5] == sum(depth.values()) > 0 and park1[6] >= park1[5]
    for s in stranded:
        assert park1[4][s] == run["drops_before"][s] + depth[s]
        assert s in park1[10]
    assert park1[7] == stranded and park1[9]["parked"] == [1, 2]
    assert {e[2] for e in pod.events if e[1] == "park_shed"} == set(stranded)
    assert run["trace"][2][1:3] == ([], 0) and run["trace"][2][3]["parked"] == [2]
    assert len(run["trace"][3][1]) == STREAMS


def test_per_tick_seam_refused_while_parked():
    pod = _pod("torch", _pod_params("torch", autoscale_enable=True))
    pod._park_shard(2)
    with pytest.raises(RuntimeError, match="autoscaled down"):
        pod.submit_bytes([None] * STREAMS)


# ---------------------------------------------------------------------------
# the pod world map across shards, with a chaos kill on the scheduled seam
# (JAX test_world_map.test_pod_world_map_cross_shard_merge_and_publish)
# ---------------------------------------------------------------------------


WORLD_KILL = ((1, 6, 9),)


def _world_run(pkg) -> dict:
    fake = {"now": 0.0}
    params = _pod_params(pkg, world_map_enable=True, world_merge_revs=2, world_tile_cells=8,
                         world_max_submaps=4, world_publish_ticks=1, shard_backoff_base_s=0.3,
                         shard_backoff_max_s=2.0, shard_backoff_jitter=0.0,
                         shard_probation_ticks=2)
    pod = _pod(pkg, params, fake=fake, kills=WORLD_KILL)
    world = pod.attach_world_map()
    ticks = _fleet_ticks(STREAMS, 10)
    rec = _record(pod, *_drive(pod, [list(t) for t in ticks], fake=fake,
                               guard_from=2 if pkg == "torch" else None))
    acc = world.accumulation() if pkg == "torch" else np.asarray(world._acc)
    grid = (tsnapshot_grid if pkg == "torch" else jsnapshot_grid)(world.snapshot())
    rec["world"] = {"acc": np.asarray(acc), "grid": np.asarray(grid),
                    "members": [m.stream for m in world._members], "merges": world.merges,
                    "evictions": world.evictions, "version": world.serving_version,
                    "status": pod.world_status()}
    return rec


@pytest.fixture(scope="module")
def jax_world():
    return _world_run("jax")


def test_pod_world_map_cross_shard_merge_and_kill_match_jax(jax_world):
    t = _world_run("torch")
    _assert_records_equal(t, jax_world)
    tw, jw = t["world"], jax_world["world"]
    np.testing.assert_array_equal(tw["acc"], jw["acc"])
    np.testing.assert_array_equal(tw["grid"], jw["grid"])
    for key in ("members", "merges", "evictions", "version", "status"):
        assert tw[key] == jw[key], key
    # JAX's assertions, on the port
    assert tw["merges"] > 0 and tw["evictions"] == max(0, tw["merges"] - 4)
    assert tw["version"] >= 1 and len(set(tw["members"])) > 1
    assert tw["status"]["merges"] == tw["merges"]
    pod = t["pod"]
    assert pod.evacuations == 1 and pod.readmits == 1
    assert [e[1] for e in pod.events if e[1] in ("lost", "readmitting")] == ["lost",
                                                                            "readmitting"]


def test_attach_world_map_needs_the_shard_mappers():
    pod = TPod(_pod_params("torch"), STREAMS, shards=SHARDS, beams=BEAMS,
               fleet_ingest_buckets=(8,))
    with pytest.raises(RuntimeError, match="precompile"):
        pod.attach_world_map()
    assert pod.world_status() is None


def test_steals_and_autoscale_refused_with_loop_closure():
    for over in (dict(steal_threshold_ticks=2), dict(autoscale_enable=True)):
        pod = TPod(_pod_params("torch", loop_enable=True, **over), STREAMS, shards=SHARDS,
                   beams=BEAMS, fleet_ingest_buckets=(8,))
        with pytest.raises(ValueError, match="loop-closure"):
            pod.attach_scheduler()

"""The port's runtime sentinels (utils/guards.py) on the CPU.

The sentinels keep the JAX package's names and contract (its
tests/test_guards.py): after warm-up a loop builds nothing new and moves
nothing it did not declare.  Here (a) is checked for real — a launch-plan
miss, a kernel-library load or an entry resolution inside
``assert_no_recompile`` raises ``RecompileError``, a warm plan passes, the
``max_compiles`` budget holds — and (b) (new device memory) and (c)
(implicit synchronisation) are shown to be no-ops without a card.  Then the
engines' steady states, as JAX's suite runs them: FusedIngest,
FleetFusedIngest per tick and by super-step, FleetMapper on both matcher
lowerings, and the failover pod's kill -> evacuate -> re-admit cycle.  The
card checks (b) and (c) in chip_smoke.py's ``failover`` phase.
"""

from __future__ import annotations

import itertools

import numpy as np
import pytest
import torch

from rplidar_ros2_driver_tpu_torch.core.config import DriverParams
from rplidar_ros2_driver_tpu_torch.driver.chaos import ShardChaosConfig, ShardChaosSchedule
from rplidar_ros2_driver_tpu_torch.driver.ingest import FleetFusedIngest, FusedIngest
from rplidar_ros2_driver_tpu_torch.mapping.mapper import FleetMapper
from rplidar_ros2_driver_tpu_torch.ops import median_kernels as mk
from rplidar_ros2_driver_tpu_torch.ops import scan_match_kernels as smk
from rplidar_ros2_driver_tpu_torch.parallel.service import ElasticFleetService
from rplidar_ros2_driver_tpu_torch.protocol.constants import Ans
from rplidar_ros2_driver_tpu_torch.utils import cuda_build, guards, launch

from test_fleet_fused_ingest import _mk_ticks
from test_live_decode import _make_stream

BEAMS = 256
DENSE = int(Ans.MEASUREMENT_DENSE_CAPSULED)
_fresh = itertools.count(1000)  # plan arguments no earlier call has used


def _params(**over):
    base = dict(filter_backend="cpu", filter_chain=("clip", "median", "voxel"), filter_window=4,
                voxel_grid_size=32)
    base.update(over)
    return DriverParams(**base)


# ---------------------------------------------------------------------------
# the sentinels themselves
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("plan", ["sliding_plan", "fine_plan", "coarse_plan", "update_plan"])
def test_plan_miss_raises(plan):
    n = next(_fresh)
    call = {
        "sliding_plan": lambda: mk.sliding_plan(n, 7),
        "fine_plan": lambda: smk.fine_plan(1, 3, 4, n),
        "coarse_plan": lambda: smk.coarse_plan(1, 64, 4, 2, 127, 0, n),
        "update_plan": lambda: smk.update_plan(1, 64, n),
    }[plan]
    with pytest.raises(guards.RecompileError, match="unit") as e:
        with guards.assert_no_recompile(tag="unit"):
            call()
    assert plan in str(e.value)


def test_library_load_and_entry_resolution_raise(monkeypatch):
    """A library loaded (no nvcc here: the build and the dlopen are stood
    in for) and a kernel entry resolved inside the scope are build events."""

    class FakeLib:
        def __init__(self, path):
            self.path = path
            self.fake_entry = lambda *a: 0

    monkeypatch.setattr(cuda_build, "_loaded", {})
    monkeypatch.setattr(cuda_build, "build_libraries", lambda names=None: {})
    monkeypatch.setattr(cuda_build.ctypes, "CDLL", FakeLib)
    with pytest.raises(guards.RecompileError, match="load median"):
        with guards.assert_no_recompile():
            cuda_build.load_library("median")
    # loaded now: a second load is a cache hit and passes
    with guards.assert_no_recompile() as rec:
        cuda_build.load_library("median")
    assert rec.compiles == []
    monkeypatch.setattr(launch, "load_library", lambda name: FakeLib(name))
    entry = launch.KernelEntry("median", "fake_entry", [])
    with pytest.raises(guards.RecompileError, match="resolve fake_entry"):
        with guards.assert_no_recompile():
            entry()
    with guards.assert_no_recompile():
        entry()  # resolved once: the call takes the kept function


def test_warm_plan_passes():
    n = next(_fresh)
    smk.update_plan(2, 64, n)
    with guards.assert_no_recompile() as rec:
        smk.update_plan(2, 64, n)
    assert rec.compiles == []


def test_max_compiles_budget():
    n, m = next(_fresh), next(_fresh)
    with guards.assert_no_recompile(max_compiles=2) as rec:
        mk.sliding_plan(n, 3)
        mk.sliding_plan(m, 3)
    assert len(rec.compiles) == 2
    with pytest.raises(guards.RecompileError):
        with guards.assert_no_recompile(max_compiles=1):
            mk.sliding_plan(next(_fresh), 3)
            mk.sliding_plan(next(_fresh), 3)


def test_steady_state_combines_the_checks():
    n = next(_fresh)
    with pytest.raises(guards.RecompileError, match="combo"):
        with guards.steady_state(tag="combo"):
            smk.fine_plan(2, 5, 4, n)
    with guards.steady_state(tag="combo") as rec:
        smk.fine_plan(2, 5, 4, n)
    assert rec.compiles == []


def test_device_memory_and_sync_checks_are_noops_on_the_cpu():
    """(b) and (c) watch the card only: without CUDA a host allocation and
    a host read pass, and declared_sync is free."""
    assert not torch.cuda.is_available()
    with guards.no_new_device_memory(tag="cpu"):
        big = torch.zeros(1 << 20)
    with guards.no_implicit_transfers():
        assert guards._sync_guards == 0
        assert float(big.sum().item()) == 0.0
        with guards.declared_sync():
            big.numpy()
    with guards.steady_state():
        torch.ones(1 << 16).tolist()


# ---------------------------------------------------------------------------
# engine steady states (JAX tests/test_guards.py)
# ---------------------------------------------------------------------------


def _timed(frames, t0=100.0, dt=0.002):
    t, out = t0, []
    for f in frames:
        t += dt
        out.append((f, t))
    return out


def test_fused_ingest_steady_state():
    eng = FusedIngest(_params(), beams=BEAMS, buckets=(4,), max_queue=64)
    eng.precompile(DENSE)
    frames = _make_stream(DENSE, 96, np.random.default_rng(7), syncs=(0, 17, 34, 51, 68, 85))
    items = _timed(frames)
    for i in range(0, 32, 4):
        eng.on_measurement_batch(DENSE, items[i : i + 4])
    eng.flush()
    with guards.steady_state(tag="FusedIngest"):
        for i in range(32, 96, 4):
            eng.on_measurement_batch(DENSE, items[i : i + 4])
        outs = eng.flush()
    assert eng.scans_completed >= 3 and any(outs)


@pytest.mark.parametrize("super_tick_max", [1, 4])
def test_fleet_fused_ingest_steady_state(super_tick_max):
    """Per-tick ticks (T = 1) and backlog drains through the super-step."""
    s = 2
    eng = FleetFusedIngest(_params(), s, beams=BEAMS, buckets=(4,), max_revs=6,
                           super_tick_max=super_tick_max)
    eng.precompile([DENSE] * s)
    streams = [(DENSE, _make_stream(DENSE, 96, np.random.default_rng(10 + i),
                                    syncs=(0, 17, 34, 51, 68, 85))) for i in range(s)]
    ticks = _mk_ticks(streams, np.random.default_rng(5), idle_prob=0.0)
    cut = max(4, len(ticks) // 2)
    if super_tick_max > 1:
        eng.submit_backlog(ticks[:cut])
        before = eng.super_dispatches
        with guards.steady_state(tag="super-tick drain"):
            outs = eng.submit_backlog(ticks[cut:])
        assert eng.super_dispatches > before
        total = sum(len(o) for o in outs)
    else:
        for tick in ticks[:cut]:
            eng.submit(tick)
        with guards.steady_state(tag="FleetFusedIngest"):
            total = sum(len(o) for tick in ticks[cut:] for o in eng.submit(tick))
        assert eng.dispatch_count >= len(ticks)
    assert total >= 1


@pytest.mark.parametrize("match_backend", ["xla", "pallas"])
def test_fleet_mapper_steady_state(match_backend):
    """Both matcher lowerings (``pallas`` takes the kernels' plain versions
    on CPU tensors) hold the contract after one warm tick."""
    p = _params(map_enable=True, map_backend="fused", map_grid=64, map_cell_m=0.1,
                match_backend=match_backend)
    b = 64
    m = FleetMapper(p, 2, beams=b)
    assert m.cfg.match_backend == match_backend
    m.precompile()

    def tick_args(seed):
        r = np.random.default_rng(seed)
        return (r.uniform(-2.0, 2.0, (2, b, 2)).astype(np.float32), np.ones((2, b), bool),
                np.ones((2,), np.int32))

    m.submit_points(*tick_args(0))
    with guards.steady_state(tag="FleetMapper"):
        for k in range(1, 4):
            est = m.submit_points(*tick_args(k))
    assert m.dispatch_count == 4 and all(e is not None for e in est)


def test_pod_kill_cycle_steady_state():
    """The failover pod's whole kill -> evacuate -> re-admit cycle (cold
    reset, snapshot pulls, restores, the migration back) under the
    sentinels after two warm ticks."""
    from test_torch_failover import _fleet_ticks

    params = _params(map_enable=True, map_grid=64, map_cell_m=0.1, fleet_ingest_backend="fused",
                     map_backend="fused", shard_count=2, failover_snapshot_ticks=4,
                     shard_backoff_base_s=0.45, shard_backoff_max_s=2.0,
                     shard_backoff_jitter=0.0, shard_probation_ticks=2)
    fake = {"now": 0.0}
    pod = ElasticFleetService(params, 4, shards=2, beams=BEAMS, fleet_ingest_buckets=(8,),
                              clock=lambda: fake["now"])
    pod.attach_shard_chaos(ShardChaosSchedule(ShardChaosConfig(kills=((1, 6, 8),))))
    pod.precompile([DENSE])
    ticks = _fleet_ticks(4, 8)
    for tick in ticks[:2]:
        pod.submit_bytes(tick)
        fake["now"] += 0.1
    with guards.steady_state(tag="pod kill cycle"):
        for tick in ticks[2:]:
            pod.submit_bytes(tick)
            fake["now"] += 0.1
    assert pod.evacuations == 1 and pod.readmits == 1 and pod.migrations == 4
    assert pod.topology.unhosted() == []

"""The serving pod over several cards, on the CPU: where its shards go and
what carries a stream from one card to another.

``parallel/sharding.pod_groups`` places the port's pod (``ElasticFleetService``
with ``mesh=None``): the JAX pod's grouping rule (``parallel/service.py``:
``per = max(1, devices // shards)``, shard ``s`` on devices ``(s * per + k) %
devices``), held to it for every pod of 1-8 shards over 1-8 cards, and its
one-card case ``shard_card`` (shard ``s`` on card ``s % cards``) to the JAX pod
built with ``mesh=None`` under this suite's eight forced CPU devices.  A stream moves between cards only as
its snapshot rows: after a kill -> evacuate -> re-admit cycle and after steals
and a park/unpark cycle, every value in the pod's snapshot store, its
fresh-lane template and each live snapshot is a host array.  The launch
counters by card and ``chip_smoke.py --pod-cards`` without a card are pinned
too.
"""

from __future__ import annotations

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from rplidar_ros2_driver_tpu.parallel.service import ElasticFleetService as JPod
from rplidar_ros2_driver_tpu_torch.ops import deskew_kernels as dk
from rplidar_ros2_driver_tpu_torch.ops import median_kernels as mk
from rplidar_ros2_driver_tpu_torch.ops import scan_match_kernels as smk
from rplidar_ros2_driver_tpu_torch.parallel.sharding import pod_groups, shard_card
from rplidar_ros2_driver_tpu_torch.utils.launch import count_launch

from test_torch_failover import CASES, _pod_params, _run_case
from test_torch_pod_scaleout import _drive, _pod, _scaleout_params
from test_torch_pod_scaleout import scaleout_wall  # noqa: F401  (module fixture)
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_groups(shards: int, devices: int) -> list:
    """The JAX pod's device groups as its ``mesh=None`` branch writes them:
    ``per = max(1, devices // shards)`` devices a shard, shard ``s`` on
    ``(s * per + k) % devices``."""
    per = max(1, devices // shards)
    return [[(s * per + k) % devices for k in range(per)] for s in range(shards)]


def test_placement_is_the_jax_pods_on_eight_devices():
    """The JAX pod with ``mesh=None`` and 8 shards over the 8 forced CPU
    devices puts shard ``s`` on device ``s``: the port's rule at 8 cards."""
    assert len(jax.devices()) == 8
    params = _pod_params("jax", shard_count=8, map_enable=False)
    jpod = JPod(params, 8, shards=8, beams=256, fleet_ingest_buckets=(8,))
    got = [int(m.devices.flat[0].id) for m in jpod.meshes]
    assert [m.devices.size for m in jpod.meshes] == [1] * 8
    assert got == [shard_card(s, 8) for s in range(8)] == list(range(8))


@pytest.mark.parametrize("cards", range(1, 9))
def test_placement_rule(cards):
    """Shards 1-8 over ``cards`` cards: the port's groups are the JAX pod's.
    Where ``cards <= shards`` each group is one card, round-robin, and
    ``shard_card`` is that card; where ``cards > shards`` shard ``s`` holds
    the ``cards // shards`` cards from ``s * per``.  Either way every card
    of the first ``shards * per`` belongs to a shard's group (a shard
    computes on its group's first card)."""
    for shards in range(1, 9):
        groups = pod_groups(shards, cards)
        assert groups == _jax_groups(shards, cards)
        per = max(1, cards // shards)
        assert all(len(g) == per for g in groups)
        hosting = sorted({c for g in groups for c in g})
        assert hosting == list(range(min(cards, shards * per)))
        if cards <= shards:
            assert [g[0] for g in groups] == [shard_card(s, cards) for s in range(shards)]
            assert hosting == list(range(cards))  # every card hosts


def test_placement_needs_a_card():
    with pytest.raises(ValueError, match="at least one card"):
        shard_card(0, 0)
    with pytest.raises(ValueError, match="at least one card"):
        pod_groups(2, 0)


def _assert_host_snapshot(snap: dict, what: str) -> None:
    """Every part of a pod snapshot ({"ingest"|"map"|"loop": {key: value}})
    holds host arrays only."""
    assert snap, what
    for part, rows in snap.items():
        assert rows, f"{what} {part}"
        for key, value in rows.items():
            assert isinstance(value, np.ndarray) and not isinstance(value, torch.Tensor), (
                f"{what} {part}.{key} is a {type(value).__name__}")


def _assert_pod_snapshots_on_the_host(pod) -> int:
    """The store, the fresh-lane template and a live snapshot of every
    hosted lane: host arrays only.  Returns how many were looked at."""
    seen = 0
    for stream, (_tick, snap) in pod._snap.items():
        _assert_host_snapshot(snap, f"stored snapshot of stream {stream}")
        seen += 1
    _assert_host_snapshot(pod._fresh_snap, "fresh-lane template")
    for s, hs in enumerate(pod.shard_health):
        if not hs.hosting or s in pod._parked:
            continue
        for lane, stream in enumerate(pod.topology.lane_streams(s)):
            if stream is not None:
                _assert_host_snapshot(pod._live_snapshot(s, lane),
                                      f"live snapshot of stream {stream} (shard {s})")
                seen += 1
    return seen


def test_snapshots_after_a_kill_cycle_are_host_arrays():
    rec = _run_case("torch", CASES["kill_evacuate_readmit"])
    pod = rec["pod"]
    assert pod.evacuations == 1 and pod.readmits == 1 and pod.migrations == 4
    assert "map" in pod._fresh_snap  # the map rows travel with the stream
    assert _assert_pod_snapshots_on_the_host(pod) == 2 * pod.streams


def test_snapshots_after_steals_and_a_scale_cycle_are_host_arrays(scaleout_wall):  # noqa: F811
    pod = _pod("torch", _scaleout_params("torch", True))
    _drive(pod, scaleout_wall)
    assert pod.scheduler.steals > 0
    assert [e[1] for e in pod.scale_events] == ["down", "up"]
    assert _assert_pod_snapshots_on_the_host(pod) == 2 * pod.streams


def test_count_launch_by_card():
    totals, by_card = {"k": 0}, {}
    for card in (1, 3, 1):
        count_launch(totals, by_card, "k", card)
    assert totals == {"k": 3}
    assert by_card == {("k", 1): 2, ("k", 3): 1}


@pytest.mark.parametrize("module", [mk, dk, smk], ids=["median", "deskew", "scan_match"])
def test_reset_clears_the_counts_by_card(module):
    name = next(iter(module.launch_counts))
    count_launch(module.launch_counts, module.card_launches, name, 2)
    assert module.card_launches[name, 2] >= 1
    module.reset_launch_counts()
    assert module.card_launches == {} and set(module.launch_counts.values()) == {0}


def test_pod_cards_exits_nonzero_without_its_cards():
    """``chip_smoke.py --pod-cards 4`` without four cards (here: none)
    exits non-zero and prints no result."""
    env = {k: v for k, v in os.environ.items() if k != "CUDA_VISIBLE_DEVICES"}
    got = subprocess.run([sys.executable, "chip_smoke.py", "--pod-cards", "4"], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=300)
    assert got.returncode != 0
    assert '"ok": true' not in got.stdout
    assert "FAIL" in got.stderr


def test_check_cards_holds_each_hosting_card():
    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    hosting = [0, 1, 2, 3]
    full = {c: {k: 1 for k in cs.POD_MAP} for c in hosting}
    cs._check_cards("all", full, hosting, cs.POD_MAP)
    short = {c: dict(v) for c, v in full.items()}
    del short[2]["fine_scores"]
    with pytest.raises(SystemExit):
        cs._check_cards("card 2 without B7", short, hosting, cs.POD_MAP)
    with pytest.raises(SystemExit):
        cs._check_cards("a stray card", {**full, 4: {"temporal_median": 1}}, hosting, cs.POD_B1)
    one = {0: {k: 1 for k in cs.POD_B1}}
    cs._check_cards("one card", one, [0, 0, 0, 0], cs.POD_B1)

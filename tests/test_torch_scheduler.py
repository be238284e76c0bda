"""The PyTorch package's traffic-shaping policy against the JAX package's.

``parallel/scheduler.py`` is a copy (host bookkeeping, no device work):
``SchedulerConfig``, ``ByteRateEwma``, ``LatencyModel``, ``BucketLadder``,
``RungLadder``, ``TrafficShaper`` and ``PodAutoscaler``.  Each of JAX's
tests/test_scheduler.py policy cases runs here on both packages' classes
(``pkg`` = jax | torch) with JAX's assertions, and seeded random call
sequences — admission, drain plans, bucket plans, steal plans, drain
notes, sheds, autoscaler ticks — drive both packages side by side with
every return value and status payload equal.  The scheduler's /diagnostics
rendering is held to the JAX node's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from rplidar_ros2_driver_tpu.core.config import DriverParams as JParams
from rplidar_ros2_driver_tpu.parallel import scheduler as jsched
from rplidar_ros2_driver_tpu_torch.core.config import DriverParams as TParams
from rplidar_ros2_driver_tpu_torch.parallel import scheduler as tsched

DENSE = 0x85  # the dense capsule's answer type (the payload is not decoded)
MODS = {"jax": jsched, "torch": tsched}
PARAMS = {"jax": JParams, "torch": TParams}
PKGS = ("jax", "torch")


def _tick(n=1):
    return (DENSE, [(b"\xa5" * 84, 1.0 + 0.001 * k) for k in range(n)])


def _params(pkg, **over):
    base = dict(filter_backend="cpu", filter_chain=("clip", "median", "voxel"), filter_window=4,
                voxel_grid_size=32)
    base.update(over)
    return PARAMS[pkg](**base)


# ---------------------------------------------------------------------------
# JAX's policy cases, on both packages
# ---------------------------------------------------------------------------


SCHED_PARAMS = dict(
    sched_rungs=(1, 3, 9), sched_hysteresis_ticks=5, sched_deadline_ms=7.5,
    sched_byte_rate_alpha=0.5, admission_max_backlog_ticks=11, bucket_rungs=(4, 16),
    occupancy_alpha=0.4, steal_threshold_ticks=3, steal_headroom_ms=1.5, autoscale_enable=True,
    autoscale_low_watermark=0.2, autoscale_high_watermark=0.8, autoscale_hysteresis_ticks=5,
    autoscale_min_shards=2, autoscale_rate_floor=128.0,
)


def test_config_from_params_reads_the_sched_surface():
    cfgs = [MODS[pkg].SchedulerConfig.from_params(_params(pkg, **SCHED_PARAMS)) for pkg in PKGS]
    assert dataclasses.asdict(cfgs[0]) == dataclasses.asdict(cfgs[1])
    cfg = cfgs[1]
    assert (cfg.rungs, cfg.hysteresis_ticks, cfg.deadline_ms, cfg.byte_rate_alpha,
            cfg.max_backlog_ticks, cfg.bucket_rungs, cfg.occupancy_alpha) == (
        (1, 3, 9), 5, 7.5, 0.5, 11, (4, 16), 0.4)
    assert (cfg.steal_threshold_ticks, cfg.steal_headroom_ms, cfg.autoscale_enable,
            cfg.autoscale_low_watermark, cfg.autoscale_high_watermark,
            cfg.autoscale_hysteresis_ticks, cfg.autoscale_min_shards,
            cfg.autoscale_rate_floor) == (3, 1.5, True, 0.2, 0.8, 5, 2, 128.0)


BAD_CONFIGS = [
    dict(rungs=()), dict(rungs=(2, 4)), dict(rungs=(1, 4, 2)), dict(hysteresis_ticks=0),
    dict(deadline_ms=-1.0), dict(byte_rate_alpha=0.0), dict(byte_rate_alpha=1.5),
    dict(max_backlog_ticks=0), dict(rungs=(1, 128)), dict(bucket_rungs=(0, 4)),
    dict(bucket_rungs=(8, 4)), dict(occupancy_alpha=0.0), dict(occupancy_alpha=1.5),
    dict(steal_threshold_ticks=-1), dict(steal_headroom_ms=-0.5),
    dict(deadline_ms=5.0, steal_headroom_ms=5.0), dict(autoscale_low_watermark=0.0),
    dict(autoscale_low_watermark=0.8, autoscale_high_watermark=0.5),
    dict(autoscale_high_watermark=1.5), dict(autoscale_hysteresis_ticks=0),
    dict(autoscale_min_shards=0), dict(autoscale_rate_floor=0.0),
]


@pytest.mark.parametrize("bad", BAD_CONFIGS, ids=lambda d: ",".join(f"{k}={v}" for k, v in d.items()))
def test_config_rejects_invalid_as_jax_does(bad):
    msgs = []
    for pkg in PKGS:
        with pytest.raises(ValueError) as err:
            MODS[pkg].SchedulerConfig(**bad)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1] or "compiled" in msgs[0]


@pytest.mark.parametrize("pkg", PKGS)
def test_byte_rate_tracks_and_decays(pkg):
    r = MODS[pkg].ByteRateEwma(2, alpha=0.5)
    assert r.rates() == [0.0, 0.0]
    r.note(0, 1000)
    assert r.rates()[0] == 1000.0
    r.note(0, 0)
    assert r.rates()[0] == 500.0
    r.note(1, 100)
    r.note(1, 300)
    assert r.rates()[1] == 200.0


@pytest.mark.parametrize("pkg", PKGS)
def test_rung_ladder_up_immediate_down_hysteresis_no_thrash(pkg):
    m = MODS[pkg]
    lad = m.RungLadder(m.SchedulerConfig(rungs=(1, 2, 4, 8), hysteresis_ticks=2))
    assert [lad.pick(b) for b in (1, 7, 1, 1, 1, 1, 3)] == [1, 8, 8, 4, 4, 2, 4]
    lad = m.RungLadder(m.SchedulerConfig(rungs=(1, 2, 4), hysteresis_ticks=3))
    lad.pick(4)
    assert [lad.pick(1), lad.pick(4), lad.pick(1), lad.pick(4)] == [4, 4, 4, 4]


@pytest.mark.parametrize("pkg", PKGS)
def test_rung_ladder_deadline_cap_and_model(pkg):
    m = MODS[pkg]
    lad = m.RungLadder(m.SchedulerConfig(rungs=(1, 2, 4, 8), hysteresis_ticks=1, deadline_ms=10.0))
    lad.note_drain(4, 0.012)
    assert lad.pick(8) == 2
    lad.tick_cost_ema = 1e-4
    assert lad.pick(8) == 8
    lad = m.RungLadder(m.SchedulerConfig(rungs=(1, 4), hysteresis_ticks=1, deadline_ms=0.001))
    lad.note_drain(1, 10.0)
    assert lad.pick(4) == 1
    model = m.LatencyModel()
    lad = m.RungLadder(m.SchedulerConfig(rungs=(1, 2, 4, 8), hysteresis_ticks=1,
                                         deadline_ms=10.0), model=model)
    lad.note_drain(4, 0.012)
    model.note(8, 4, 0.008)
    assert lad.pick(8, bucket=4) == 8
    assert lad.pick(8, bucket=16) == 2
    model = m.LatencyModel()
    lad = m.RungLadder(m.SchedulerConfig(rungs=(1, 2, 4)), model=model)
    lad.note_drain(7, 0.012, rung=4, bucket=8)
    assert model.cost(4, 8) == pytest.approx(0.006)
    lad.note_drain(2, 0.004, rung=2)
    assert model.cost(2, None) is None and lad.tick_cost_ema is not None


@pytest.mark.parametrize("pkg", PKGS)
def test_latency_model_seed_note_worst_and_table(pkg):
    m = MODS[pkg].LatencyModel()
    m.seed(4, 8, 0.010)
    m.seed(4, 8, 0.999)
    assert m.cost(4, 8) == pytest.approx(0.010)
    m.note(4, 8, 0.002)
    assert m.cost(4, 8) == pytest.approx(0.002)
    m.note(4, 8, 0.004)
    assert m.cost(4, 8) == pytest.approx(0.8 * 0.002 + 0.2 * 0.004)
    m.seed_many({(1, 4): 0.001, (2, 4): 0.0015})
    m.seed(1, 8, 0.0)
    assert m.cost(1, 4) == pytest.approx(0.001) and m.cost(1, 8) is None
    m.note(4, 16, 0.05)
    assert m.cost(4, None) == pytest.approx(0.05) and m.cost(8, None) is None
    m2 = MODS[pkg].LatencyModel()
    m2.note(2, 16, 0.0015)
    m2.note(1, 4, 0.0005)
    assert m2.table_ms() == {"T1xM4": 0.5, "T2xM16": 1.5}


@pytest.mark.parametrize("pkg", PKGS)
def test_bucket_ladder_cases(pkg):
    b = MODS[pkg].BucketLadder
    lad = b((4, 8, 16), hysteresis_ticks=2, alpha=1.0)
    assert lad.bucket == 16 and lad.pick() == 16
    lad = b((4, 8), hysteresis_ticks=2, alpha=1.0)
    lad.note_occupancy(0, 4)
    assert lad.pick() == 4 and lad.switches == 1
    lad.note_occupancy(4, 4)
    assert lad.pick() == 4
    lad.note_occupancy(4, 4)
    assert lad.pick() == 8 and lad.switches == 2
    lad = b((4, 8), hysteresis_ticks=2, alpha=1.0)
    picks = []
    for occ in (0, 4, 0, 4, 4):
        lad.note_occupancy(occ, 4)
        picks.append(lad.pick())
    assert picks == [4, 4, 4, 4, 8]
    lad = b((4, 8), hysteresis_ticks=1, alpha=1.0)
    lad.note_occupancy(2, 4)
    assert lad.pick() == 4
    lad.note_occupancy(3, 4)
    assert lad.pick() == 8
    lad = b((4, 8), hysteresis_ticks=2, alpha=0.2)
    lad.note_occupancy(4, 4)
    lad.pick()
    lad.note_occupancy(0, 4)
    assert lad.occupancy_ema == pytest.approx(0.8) and lad.pick() == 8 and lad.switches == 0
    with pytest.raises(ValueError, match="at least one bucket"):
        b((), hysteresis_ticks=1, alpha=0.5)


@pytest.mark.parametrize("pkg", PKGS)
def test_shaper_admission_sheds_oldest_and_drain_plans(pkg):
    m = MODS[pkg]
    sh = m.TrafficShaper(2, m.SchedulerConfig(max_backlog_ticks=3))
    first = _tick(1)
    sh.offer_tick([first, None])
    sh.offer_tick([[_tick(2), _tick(3), _tick(4)], None])
    assert sh.backlog_depths() == [3, 0]
    assert sh.admission_drops == [1, 0] and sh.shed_total == 1
    assert sh.queues[0][0] is not first
    ticks, _ = sh.drain_plan(0, [0, 1])
    assert len(ticks) == 3
    sh = m.TrafficShaper(2, m.SchedulerConfig(max_backlog_ticks=8))
    sh.offer_tick([[_tick(1), _tick(2), _tick(3)], _tick(4)])
    assert sh.shed_stream(0) == 3 and sh.backlog_depths() == [0, 1]
    assert sh.admission_drops == [3, 0] and sh.shed_total == 3
    assert sh.shed_stream(0) == 0 and sh.shed_total == 3
    sh = m.TrafficShaper(3, m.SchedulerConfig(rungs=(1, 2, 4)))
    sh.offer_tick([[_tick(1), _tick(2)], _tick(3), None])
    ticks, rung = sh.drain_plan(0, [0, 1, None])
    assert rung == 2 and len(ticks) == 2
    assert ticks[0][0] is not None and ticks[0][1] is not None
    assert ticks[1][0] is not None and ticks[1][1] is None and ticks[0][2] is None
    sh = m.TrafficShaper(1, m.SchedulerConfig(rungs=(1, 4), hysteresis_ticks=1))
    sh.offer_tick([[_tick(1)] * 4])
    assert sh.drain_plan(0, [0])[1] == 4
    assert sh.drain_plan(0, [0])[1] == 1
    sh = m.TrafficShaper(2, m.SchedulerConfig())
    sh.offer_tick([_tick(2), None])
    st = sh.status()
    assert st["backlog"] == [1, 0] and st["admission_drops"] == [0, 0] and st["shed_total"] == 0
    assert st["byte_rates"][0] > 0 and st["latency_model"] == {}
    assert "active_buckets" not in st and "bucket_switches" not in st


@pytest.mark.parametrize("pkg", PKGS)
def test_shaper_bucket_ladder(pkg):
    m = MODS[pkg]

    def shaper(streams=4, shards=1):
        return m.TrafficShaper(streams, m.SchedulerConfig(
            rungs=(1, 2), hysteresis_ticks=2, bucket_rungs=(4, 8), occupancy_alpha=1.0),
            shards=shards)

    plain = m.TrafficShaper(2, m.SchedulerConfig())
    assert plain.bucket_ladders is None and plain.bucket_plan(0) is None
    sh = shaper()
    assert sh.bucket_plan(0) == 8
    sh.offer_tick([_tick(1), None, None, None])
    assert len(sh.drain_plan(0, [0, 1, 2, 3])[0]) == 1
    assert sh.bucket_plan(0) == 4 and sh.bucket_ladders[0].switches == 1
    sh = shaper()
    assert sh.drain_plan(0, [0, 1, 2, 3])[0] == [] and sh.bucket_plan(0) == 4
    for pick in (4, 8):
        sh.offer_tick([_tick(1)] * 4)
        sh.drain_plan(0, [0, 1, 2, 3])
        assert sh.bucket_plan(0) == pick
    sh = shaper(shards=2)
    sh.offer_tick([None, None, _tick(1), _tick(1)])
    sh.drain_plan(0, [0, 1])
    sh.drain_plan(1, [2, 3])
    assert (sh.bucket_plan(0), sh.bucket_plan(1)) == (4, 8)
    sh = shaper()
    sh.model.note(1, 4, 0.002)
    sh.drain_plan(0, [0, 1, 2, 3])
    st = sh.status()
    assert st["active_buckets"] == [4] and st["bucket_switches"] == 1
    assert st["latency_model"] == {"T1xM4": 2.0}


STEAL_CASES = {
    # name: (streams, shards, cfg overrides, seeds, offers, hosted, free, want)
    "threshold_off": (2, 2, dict(steal_threshold_ticks=0), {}, [[[0] * 6, None]],
                      {0: [0], 1: [1]}, {0: 1, 1: 1}, {}),
    "at_threshold": (2, 2, {}, {}, [[[0] * 2, None]], {0: [0], 1: [1]}, {0: 1, 1: 1}, {}),
    "deep_to_idle": (4, 2, {}, {}, [[[0] * 4, None, [0], None]], {0: [0, 1], 1: [2, 3]},
                     {0: 1, 1: 1}, {1: [(0, 0)]}),
    "no_idle_lane": (2, 2, {}, {}, [[[0] * 4, None]], {0: [0], 1: [1]}, {0: 0, 1: 0}, {}),
    "deep_takers": (2, 2, {}, {}, [[[0] * 5, [0] * 4]], {0: [0], 1: [1]}, {0: 1, 1: 1}, {}),
    "shallowest": (3, 3, {}, {}, [[[0] * 5, [0], None]], {0: [0], 1: [1], 2: [2]},
                   {0: 1, 1: 1, 2: 1}, {2: [(0, 0)]}),
    "deepest_first": (5, 3, {}, {}, [[[0] * 5, [0] * 4, [0] * 3, None, None]],
                      {0: [0, 1, 2], 1: [3], 2: [4]}, {0: 0, 1: 2, 2: 2},
                      {1: [(0, 0)], 2: [(1, 0), (2, 0)]}),
    "unpriced_veto": (2, 2, dict(steal_headroom_ms=5.0), {}, [[[0] * 4, None]],
                      {0: [0], 1: [1]}, {0: 1, 1: 1}, {}),
    "priced_fits": (2, 2, dict(steal_headroom_ms=5.0), {(4, 8): 0.001}, [[[0] * 4, None]],
                    {0: [0], 1: [1]}, {0: 1, 1: 1}, {1: [(0, 0)]}),
    "overpriced": (2, 2, dict(steal_headroom_ms=5.0), {(4, 8): 0.010}, [[[0] * 4, None]],
                   {0: [0], 1: [1]}, {0: 1, 1: 1}, {}),
    "reserve_over": (2, 2, dict(deadline_ms=3.0, steal_headroom_ms=1.0), {(4, 8): 0.0025},
                     [[[0] * 4, None]], {0: [0], 1: [1]}, {0: 1, 1: 1}, {}),
    "reserve_fits": (2, 2, dict(deadline_ms=3.0, steal_headroom_ms=1.0), {(4, 8): 0.0015},
                     [[[0] * 4, None]], {0: [0], 1: [1]}, {0: 1, 1: 1}, {1: [(0, 0)]}),
}


def _offer(sh, spec):
    """``spec[i]``: None, a list of tick sizes (a burst) or one size."""
    items = []
    for x in spec:
        if x is None:
            items.append(None)
        elif isinstance(x, list):
            items.append([_tick(max(1, n)) for n in x])
        else:
            items.append(_tick(max(1, x)))
    sh.offer_tick(items)


@pytest.mark.parametrize("name", sorted(STEAL_CASES))
def test_steal_planning_matches_jax(name):
    streams, shards, over, seeds, offers, hosted, free, want = STEAL_CASES[name]
    got = []
    for pkg in PKGS:
        m = MODS[pkg]
        cfg = dict(rungs=(1, 2, 4), steal_threshold_ticks=2)
        cfg.update(over)
        sh = m.TrafficShaper(streams, m.SchedulerConfig(**cfg), shards=shards)
        for (r, b), sec in seeds.items():
            sh.model.seed(r, b, sec)
        for spec in offers:
            _offer(sh, spec)
        plan = sh.plan_steals(hosted, free)
        assert plan == want, pkg
        assert sh.steal_ticks == sum(n for *_, n in sh.steal_log)
        st = sh.status()
        got.append((plan, sh.steals, sh.steal_ticks, list(sh.steal_log), st["steals"],
                    st["steal_ticks"], sh.backlog_depths()))
    assert got[0] == got[1]


@pytest.mark.parametrize("pkg", PKGS)
def test_predict_drain_s_prices_with_the_model(pkg):
    m = MODS[pkg]
    sh = m.TrafficShaper(2, m.SchedulerConfig(rungs=(1, 2, 4), steal_threshold_ticks=2), shards=2)
    assert sh.predict_drain_s(0, 0) == 0.0 and sh.predict_drain_s(0, 3) is None
    sh.model.seed(4, 8, 0.002)
    assert sh.predict_drain_s(0, 3) == pytest.approx(0.002)
    assert sh.predict_drain_s(0, 9) == pytest.approx(0.006)


AUTOSCALE_SEQS = {
    # name: [(rates, active shards, can_down, can_up), ...]
    "liveness_and_thin_streak": [([0.0] * 4, 2, True, True)] * 4,
    "pressure_streak": [([1000.0] * 4, 2, True, True)] * 3,
    "dead_zone_resets": [([0.0] * 4, 2, True, True)] * 2
    + [([1000.0, 1000.0, 0.0, 0.0], 2, True, True)] + [([0.0] * 4, 2, True, True)] * 3,
    "gated_side_ticks": [([0.0] * 4, 2, False, True)] * 4 + [([0.0] * 4, 2, True, True)],
    "active_capacity": [([1000.0, 1000.0, 1000.0, 0.0], 2, True, True),
                        ([1000.0, 1000.0, 1000.0, 0.0], 1, True, True)],
}


@pytest.mark.parametrize("name", sorted(AUTOSCALE_SEQS))
def test_autoscaler_matches_jax(name):
    got = []
    for pkg in PKGS:
        m = MODS[pkg]
        auto = m.PodAutoscaler(m.SchedulerConfig(
            autoscale_enable=True, autoscale_low_watermark=0.25, autoscale_high_watermark=0.75,
            autoscale_hysteresis_ticks=3, autoscale_rate_floor=256.0), lanes=2)
        trace = [auto.status(), auto.live_streams([0.0, 100.0, 256.0, 1024.0])]
        for rates, active, down, up in AUTOSCALE_SEQS[name]:
            trace.append((auto.note_tick(rates, active, can_down=down, can_up=up), auto.state,
                          auto.occupancy, auto.status()))
        got.append(trace)
    assert got[0] == got[1]
    # JAX's expectations, on the port
    decisions = [d for d, *_ in got[1][2:]]
    want = {"liveness_and_thin_streak": [None, None, "down", None],
            "pressure_streak": [None, None, "up"],
            "dead_zone_resets": [None, None, None, None, None, "down"],
            "gated_side_ticks": [None] * 4 + ["down"],
            "active_capacity": [None, None]}[name]
    assert decisions == want
    assert got[1][1] == 2
    if name == "active_capacity":
        assert got[1][-1][1] == "pressure 1/3" and got[1][-1][2] == 1.0


# ---------------------------------------------------------------------------
# seeded call sequences through both packages
# ---------------------------------------------------------------------------


def _drive(m, seed: int, streams: int, shards: int, cfg: dict, steps: int) -> list:
    """One seeded random sequence of the serving pod's calls into a shaper
    and a PodAutoscaler; returns every value they returned."""
    rng = np.random.default_rng(seed)
    sc = m.SchedulerConfig(**cfg)
    sh = m.TrafficShaper(streams, sc, shards=shards)
    auto = m.PodAutoscaler(sc, lanes=-(-streams // max(1, shards - 1)))
    lanes = [list(range(s, streams, shards)) for s in range(shards)]
    trace = []
    for _ in range(steps):
        items = []
        for _i in range(streams):
            r = rng.random()
            if r < 0.35:
                items.append(None)
            elif r < 0.75:
                items.append(_tick(int(rng.integers(1, 6))))
            else:
                items.append([_tick(int(rng.integers(1, 6))) for _ in range(int(rng.integers(1, 5)))])
        sh.offer_tick(items)
        trace.append(("offer", sh.backlog_depths(), list(sh.admission_drops), sh.shed_total,
                      [round(x, 9) for x in sh.rates.rates()]))
        if rng.random() < 0.1:
            i = int(rng.integers(streams))
            trace.append(("shed", i, sh.shed_stream(i)))
        if rng.random() < 0.3:
            sh.model.seed(int(rng.choice(cfg.get("rungs", (1, 2, 4, 8)))),
                          int(rng.choice((4, 8, 16))), float(rng.uniform(1e-4, 5e-3)))
        hosted = {s: list(lanes[s]) for s in range(shards)}
        free = {s: int(rng.integers(0, 3)) for s in range(shards)}
        steals = sh.plan_steals(hosted, free)
        trace.append(("steal", steals, sh.steals, sh.steal_ticks))
        away = {st for plans in steals.values() for st, _src in plans}
        for s in range(shards):
            ids = [None if st in away else st for st in lanes[s]]
            extra = [st for st, _src in steals.get(s, [])]
            ticks, rung = sh.drain_plan(s, ids, extra_streams=extra)
            bucket = sh.bucket_plan(s)
            depth = len(ticks)
            trace.append(("drain", s, depth, rung, bucket, sh.predict_drain_s(s, depth)))
            if depth:
                secs = float(rng.uniform(1e-4, 2e-2))
                sh.note_drain(s, depth, secs, rung=rung, bucket=bucket if bucket else 16)
        trace.append(("auto", auto.note_tick(sh.rates.rates(), int(rng.integers(1, shards + 1)),
                                             can_down=bool(rng.random() < 0.7),
                                             can_up=bool(rng.random() < 0.7)),
                      auto.state, auto.occupancy))
        trace.append(("status", sh.status(), auto.status()))
    return trace


SEQ_CONFIGS = {
    "plain": dict(rungs=(1, 2, 4, 8), max_backlog_ticks=6),
    "deadline_buckets": dict(rungs=(1, 2, 4), hysteresis_ticks=3, deadline_ms=12.0,
                             bucket_rungs=(4, 8, 16), occupancy_alpha=0.5,
                             max_backlog_ticks=5),
    "steal_autoscale": dict(rungs=(1, 2, 4), steal_threshold_ticks=2, steal_headroom_ms=6.0,
                            autoscale_enable=True, autoscale_hysteresis_ticks=2,
                            autoscale_rate_floor=64.0, max_backlog_ticks=8,
                            byte_rate_alpha=0.4),
    "steal_deadline": dict(rungs=(1, 4), steal_threshold_ticks=1, deadline_ms=9.0,
                           steal_headroom_ms=2.0, bucket_rungs=(8, 16), max_backlog_ticks=4),
}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", sorted(SEQ_CONFIGS))
def test_call_sequences_match_jax(name, seed):
    streams, shards = 7, 3
    j = _drive(jsched, seed, streams, shards, SEQ_CONFIGS[name], 40)
    t = _drive(tsched, seed, streams, shards, SEQ_CONFIGS[name], 40)
    assert t == j
    # the sequences reach the interesting states
    kinds = {row[0] for row in t}
    assert {"offer", "drain", "steal", "auto", "status"} <= kinds


# ---------------------------------------------------------------------------
# /diagnostics rendering
# ---------------------------------------------------------------------------


def _render(pkg, **payload):
    if pkg == "jax":
        from rplidar_ros2_driver_tpu.node.diagnostics import DiagnosticsUpdater
        from rplidar_ros2_driver_tpu.node.lifecycle import LifecycleState
        from rplidar_ros2_driver_tpu.node.publisher import CollectingPublisher
    else:
        from rplidar_ros2_driver_tpu_torch.node.diagnostics import DiagnosticsUpdater
        from rplidar_ros2_driver_tpu_torch.node.lifecycle import LifecycleState
        from rplidar_ros2_driver_tpu_torch.node.publisher import CollectingPublisher
    return DiagnosticsUpdater("rig", CollectingPublisher()).update(
        lifecycle=LifecycleState.ACTIVE, fsm_state=None, port="pod", rpm=0, device_info="",
        **payload,
    ).values


SCHED_PAYLOADS = {
    "pre_latency_model": {
        "rungs": [4, 1], "backlog": [3, 0, 1], "admission_drops": [2, 0, 0], "shed_total": 2,
        "byte_rates": [512.5, 0.0, 33.1], "rung_dispatches": {1: 7, 4: 2},
        "weights": [2.0, 1.0, 1.25],
    },
    "latency_model_group": {
        "rungs": [2], "backlog": [0, 1], "admission_drops": [0, 0], "shed_total": 0,
        "byte_rates": [10.0, 0.0], "rung_dispatches": {1: 3},
        "latency_model": {"T1xM4": 0.5, "T1xM8": 0.9, "T2xM4": 0.8},
        "active_buckets": [4, 8], "bucket_switches": 3, "staging_overlap_hits": 17,
    },
}


@pytest.mark.parametrize("name", sorted(SCHED_PAYLOADS))
def test_scheduler_rendering_matches_jax(name):
    payload = SCHED_PAYLOADS[name]
    got = _render("torch", scheduler=payload)
    assert got == _render("jax", scheduler=payload)
    if name == "pre_latency_model":
        assert got["Sched Rung"] == "4,1" and got["Rung Dispatches"] == "T1:7 T4:2"
        assert got["Placement Weights"] == "2.00,1.00,1.25"
        assert "Latency Model ms" not in got and "Staging Overlap Hits" not in got
    else:
        assert got["Latency Model ms"] == "T1xM4:0.5 T1xM8:0.9 T2xM4:0.8"
        assert got["Active Bucket"] == "4,8" and got["Staging Overlap Hits"] == "17"


POD_PAYLOADS = {
    "parked_and_autoscaler": {
        "hosts": 2,
        "per_host": [
            {"host": 0, "shards": [{"shard": 0, "state": "UP", "streams": 3},
                                   {"shard": 1, "state": "PARKED", "streams": 0}]},
            {"host": 1, "shards": [{"shard": 2, "state": "UP", "streams": 3}]},
        ],
        "parked": [1], "steals": 12, "steal_ticks": 48, "steal_drops": 0, "scale_downs": 1,
        "scale_ups": 1,
        "autoscaler": {"state": "thin 2/3", "occupancy": 0.167, "scale_downs": 1,
                       "scale_ups": 0},
    },
    "no_autoscaler": {
        "hosts": 1, "per_host": [{"host": 0, "shards": []}], "steals": 0, "steal_ticks": 0,
        "scale_downs": 0, "scale_ups": 0, "autoscaler": None,
    },
    "absent": None,
}


@pytest.mark.parametrize("name", sorted(POD_PAYLOADS))
def test_pod_rendering_matches_jax(name):
    payload = POD_PAYLOADS[name]
    got = _render("torch", pod=payload)
    assert got == _render("jax", pod=payload)
    if name == "parked_and_autoscaler":
        assert got["Pod Host 0"] == "0:UP[3] 1:PARKED[0]"
        assert got["Autoscaler"] == "thin 2/3 (occ 0.167)"
    elif name == "no_autoscaler":
        assert got["Pod Host 0"] == "n/a" and "Autoscaler" not in got
    else:
        assert "Steals" not in got and "Pod Host 0" not in got

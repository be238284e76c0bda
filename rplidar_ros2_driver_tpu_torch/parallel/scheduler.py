"""Traffic-shaping policy layer for the serving pod.

The PyTorch package's copy of the JAX package's ``parallel/scheduler.py``:
the same classes, the same logic, the same numbers on the same call
sequences (tests/test_torch_scheduler.py holds each class to JAX's).  It is
host bookkeeping only — no torch, no device work — and drives the port's
serving seams (``ShardedFilterService.attach_scheduler`` /
``offer_bytes`` / ``drain_scheduled`` and the ``ElasticFleetService``
analogues):

  * **backlog-adaptive super-tick depth** — a ladder of pre-warmed drain
    rungs (``sched_rungs``; every depth is run once per padding bucket at
    ``FleetFusedIngest.precompile``) and a per-shard :class:`RungLadder`
    that picks the rung per drain from measured backlog depth: stepping UP
    is immediate (a burst is swallowed in one deep dispatch), stepping DOWN
    waits out ``sched_hysteresis_ticks`` consecutive shallow drains so a
    sawtooth backlog cannot thrash the choice.  A rung switch builds
    nothing and maps no new device memory (utils/guards.steady_state).
  * **SLO-aware admission** — per-stream BOUNDED backlog queues: past
    ``admission_max_backlog_ticks`` the OLDEST queued tick is shed
    (counted per stream, surfaced on /diagnostics); and a per-shard
    deadline budget (``sched_deadline_ms``) caps the rung so the PREDICTED
    drain wall time stays inside the publish SLO.
  * **measured (rung, bucket) latency model** — a :class:`LatencyModel`
    cost table fit online from timed drains and SEEDED from precompile's
    timed warm-up runs (``FleetFusedIngest.warmup_costs``), so the deadline
    cap prices each rung with its own measured cost.
  * **adaptive padding-bucket ladder** — :class:`BucketLadder`: a live-lane
    occupancy EWMA (``occupancy_alpha``) picks the ACTIVE frame-run bucket
    among ``bucket_rungs`` with hysteresis; a switch only re-slices future
    ticks, never touching stream state.
  * **byte-rate estimation** — a per-stream EWMA of offered bytes per tick
    (``sched_byte_rate_alpha``) feeding byte-rate-weighted placement
    (parallel/sharding.FleetTopology.set_weight).
  * **cross-shard work stealing** — :meth:`TrafficShaper.plan_steals`: a
    sibling with headroom drains whole per-stream QUEUES borrowed from a
    deep shard for one drain; admission and per-stream tick order are
    untouched, so the stolen schedule is byte-equal to the no-steal one.
  * **byte-rate autoscale seam** — :class:`PodAutoscaler`: sustained thin
    occupancy parks a shard, sustained pressure re-admits it, with
    watermark + streak hysteresis.

The policy chooses *when* work dispatches, never *what* it computes: any
rung sequence over the same admitted ticks lands byte-identical
trajectories (the super-step's idle padding is a carry no-op).
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional, Sequence


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """The ``sched_*`` / ``admission_*`` param surface (validated in
    core/config.py; re-checked here so a hand-built config cannot skip
    the contract)."""

    rungs: tuple = (1, 2, 4, 8)
    hysteresis_ticks: int = 2
    deadline_ms: float = 0.0
    byte_rate_alpha: float = 0.2
    max_backlog_ticks: int = 32
    bucket_rungs: tuple = ()
    occupancy_alpha: float = 0.2
    # cross-shard work stealing: a shard whose backlog depth exceeds
    # the threshold donates whole stream queues to a sibling with
    # predicted headroom for this drain only (0 disables the phase).
    # ``steal_headroom_ms`` is the reserve subtracted from
    # ``deadline_ms`` when a deadline is configured, else the absolute
    # predicted-drain budget a taker must stay within (0 = no time
    # gate: idleness + lane capacity alone qualify a taker).
    steal_threshold_ticks: int = 0
    steal_headroom_ms: float = 0.0
    # byte-rate autoscale seam (PodAutoscaler): occupancy watermarks
    # over the live-stream fraction, streak hysteresis, the scale-down
    # floor, and the EWMA bytes/tick at which a stream counts as live
    autoscale_enable: bool = False
    autoscale_low_watermark: float = 0.25
    autoscale_high_watermark: float = 0.75
    autoscale_hysteresis_ticks: int = 8
    autoscale_min_shards: int = 1
    autoscale_rate_floor: float = 256.0

    def __post_init__(self) -> None:
        rungs = tuple(int(r) for r in self.rungs)
        object.__setattr__(self, "rungs", rungs)
        if not rungs or rungs[0] != 1:
            raise ValueError(
                "scheduler rungs must start at 1 (the per-tick program "
                "is the floor the ladder can always fall to)"
            )
        if any(b <= a for a, b in zip(rungs, rungs[1:])):
            raise ValueError("scheduler rungs must be strictly ascending")
        if self.hysteresis_ticks < 1:
            raise ValueError("hysteresis_ticks must be >= 1")
        if self.deadline_ms < 0:
            raise ValueError("deadline_ms must be >= 0 (0 = no cap)")
        if not (0.0 < self.byte_rate_alpha <= 1.0):
            raise ValueError("byte_rate_alpha must be within (0, 1]")
        if rungs[-1] > 64:
            raise ValueError(
                "scheduler rungs must be <= 64 (every rung is one more "
                "warmed super-step per padding bucket — the "
                "core/config.py cap, re-checked for hand-built configs)"
            )
        if self.max_backlog_ticks < 1:
            raise ValueError(
                "max_backlog_ticks must be >= 1 (the backlog is "
                "bounded by contract)"
            )
        buckets = tuple(int(b) for b in self.bucket_rungs)
        object.__setattr__(self, "bucket_rungs", buckets)
        if buckets:
            if min(buckets) < 1:
                raise ValueError("bucket_rungs must be >= 1")
            if any(b <= a for a, b in zip(buckets, buckets[1:])):
                raise ValueError(
                    "bucket_rungs must be strictly ascending (the "
                    "bucket ladder steps between pre-warmed padding "
                    "buckets)"
                )
        if not (0.0 < self.occupancy_alpha <= 1.0):
            raise ValueError("occupancy_alpha must be within (0, 1]")
        if self.steal_threshold_ticks < 0:
            raise ValueError(
                "steal_threshold_ticks must be >= 0 (0 disables "
                "cross-shard work stealing)"
            )
        if self.steal_headroom_ms < 0:
            raise ValueError("steal_headroom_ms must be >= 0")
        if (
            self.deadline_ms > 0
            and self.steal_headroom_ms >= self.deadline_ms
        ):
            raise ValueError(
                "steal_headroom_ms must leave part of sched_deadline_ms "
                "as the taker's budget (reserve >= deadline means no "
                "steal can ever qualify — say so instead of silently "
                "disabling the phase)"
            )
        if not (
            0.0
            < self.autoscale_low_watermark
            < self.autoscale_high_watermark
            <= 1.0
        ):
            raise ValueError(
                "autoscale watermarks must satisfy 0 < low < high <= 1 "
                "(the gap between them is the hysteresis dead zone)"
            )
        if self.autoscale_hysteresis_ticks < 1:
            raise ValueError("autoscale_hysteresis_ticks must be >= 1")
        if self.autoscale_min_shards < 1:
            raise ValueError("autoscale_min_shards must be >= 1")
        if self.autoscale_rate_floor <= 0:
            raise ValueError(
                "autoscale_rate_floor must be > 0 (a zero floor would "
                "count every never-seen stream as live forever — the "
                "byte-rate EWMA decays toward zero but never reaches it)"
            )

    @classmethod
    def from_params(cls, params) -> "SchedulerConfig":
        return cls(
            rungs=tuple(getattr(params, "sched_rungs", (1, 2, 4, 8))),
            hysteresis_ticks=int(
                getattr(params, "sched_hysteresis_ticks", 2)
            ),
            deadline_ms=float(getattr(params, "sched_deadline_ms", 0.0)),
            byte_rate_alpha=float(
                getattr(params, "sched_byte_rate_alpha", 0.2)
            ),
            max_backlog_ticks=int(
                getattr(params, "admission_max_backlog_ticks", 32)
            ),
            bucket_rungs=tuple(getattr(params, "bucket_rungs", ()) or ()),
            occupancy_alpha=float(
                getattr(params, "occupancy_alpha", 0.2)
            ),
            steal_threshold_ticks=int(
                getattr(params, "steal_threshold_ticks", 0)
            ),
            steal_headroom_ms=float(
                getattr(params, "steal_headroom_ms", 0.0)
            ),
            autoscale_enable=bool(
                getattr(params, "autoscale_enable", False)
            ),
            autoscale_low_watermark=float(
                getattr(params, "autoscale_low_watermark", 0.25)
            ),
            autoscale_high_watermark=float(
                getattr(params, "autoscale_high_watermark", 0.75)
            ),
            autoscale_hysteresis_ticks=int(
                getattr(params, "autoscale_hysteresis_ticks", 8)
            ),
            autoscale_min_shards=int(
                getattr(params, "autoscale_min_shards", 1)
            ),
            autoscale_rate_floor=float(
                getattr(params, "autoscale_rate_floor", 256.0)
            ),
        )


class ByteRateEwma:
    """Per-stream EWMA of offered bytes per tick — the load signal
    weighted placement consumes.  ``note`` once per stream per offer
    tick (0 for idle), so the estimate decays while a stream is quiet
    instead of freezing at its last burst."""

    def __init__(self, streams: int, alpha: float) -> None:
        self.alpha = float(alpha)
        self._rate: list = [None] * streams

    def note(self, i: int, nbytes: int) -> None:
        prev = self._rate[i]
        self._rate[i] = (
            float(nbytes) if prev is None
            else (1.0 - self.alpha) * prev + self.alpha * float(nbytes)
        )

    def rates(self) -> list:
        """Per-stream EWMA bytes/tick (0.0 before any observation —
        a never-seen stream weighs nothing, like an idle one)."""
        return [0.0 if r is None else r for r in self._rate]


class LatencyModel:
    """Per-(rung, bucket) measured cost table — the deadline predictor.

    One entry per (drain rung T, active padding bucket M): the EWMA of
    the measured wall seconds ONE dispatch of that (rung, bucket) step
    costs in the port.  Seeded from the precompile warmup timings
    (``FleetFusedIngest.warmup_costs`` — a timed second run of each
    warmed step, its first run excluded) so the first live drain is priced before
    any traffic; live drains then refit each entry online via
    :meth:`note`.  The scalar drain-time EWMA this replaces extrapolated
    one per-tick cost linearly across depths, which mis-prices the
    super-step's amortization (a rung-8 dispatch does NOT cost 8x a
    rung-1 dispatch — that gap is the whole point of the ladder)."""

    # deliberately NOT byte_rate_alpha — see RungLadder.DRAIN_COST_ALPHA
    ALPHA = 0.2

    def __init__(self) -> None:
        self._cost: dict = {}     # (rung, bucket) -> EWMA seconds/dispatch
        self._seeded: set = set()  # keys still holding only their seed

    def seed(self, rung: int, bucket: int, seconds: float) -> None:
        """Install a warmup-timed prior for one (rung, bucket) program.
        A live measurement always outranks a seed; re-seeding an
        already-measured entry is a no-op."""
        key = (int(rung), int(bucket))
        if seconds <= 0 or key in self._cost:
            return
        self._cost[key] = float(seconds)
        self._seeded.add(key)

    def seed_many(self, costs: dict) -> None:
        for (rung, bucket), seconds in costs.items():
            self.seed(rung, bucket, seconds)

    def note(self, rung: int, bucket: int, seconds: float) -> None:
        """Fold one measured dispatch cost into the table (EWMA); the
        first live measurement REPLACES the warmup seed outright — the
        seed exists to price the first drain, not to bias the fit."""
        key = (int(rung), int(bucket))
        if seconds < 0:
            return
        if key not in self._cost or key in self._seeded:
            self._cost[key] = float(seconds)
            self._seeded.discard(key)
            return
        a = self.ALPHA
        self._cost[key] = (1.0 - a) * self._cost[key] + a * float(seconds)

    def cost(self, rung: int, bucket: Optional[int]) -> Optional[float]:
        """Fitted seconds for one dispatch of the (rung, bucket)
        program; with no bucket identity, the worst fitted cost across
        buckets at that rung (a safe deadline bound); None when the
        table holds nothing for the rung."""
        if bucket is not None:
            return self._cost.get((int(rung), int(bucket)))
        costs = [
            c for (r, _b), c in self._cost.items() if r == int(rung)
        ]
        return max(costs) if costs else None

    def table_ms(self) -> dict:
        """The /diagnostics rendering payload: ``"T{rung}xM{bucket}"``
        -> fitted cost in ms, sorted for a stable display."""
        return {
            f"T{r}xM{b}": round(c * 1e3, 3)
            for (r, b), c in sorted(self._cost.items())
        }


class BucketLadder:
    """One shard's frame-run padding-bucket state: the occupancy EWMA
    plus hysteresis that picks the ACTIVE bucket from ``bucket_rungs``.

    Occupancy is the fraction of the shard's hosted lanes that carried
    data in a drain — idle and quarantined/masked lanes both stage m=0
    rows, so both pull the estimate down.  A collapsed fleet pads most
    of the (streams, M) plane with dead rows; dropping the slicing cap
    to a SMALLER pre-warmed bucket trades a couple more dispatches for
    a much cheaper executable each.  Stepping DOWN (collapse) is
    immediate — the waste is being paid NOW; stepping back UP waits out
    ``hysteresis_ticks`` consecutive high-occupancy drains so a
    flapping lane cannot thrash the cap.  Every bucket is pre-warmed
    per rung at precompile, so a switch builds nothing by
    construction — and it never touches stream state (the cap only
    re-slices FUTURE ticks), so per-stream snapshots round-trip across
    a switch exactly like a migration relabel."""

    def __init__(
        self, buckets: tuple, hysteresis_ticks: int, alpha: float
    ) -> None:
        if not buckets:
            raise ValueError("bucket ladder needs at least one bucket")
        self.buckets = tuple(int(b) for b in buckets)
        self.hysteresis_ticks = int(hysteresis_ticks)
        self.alpha = float(alpha)
        self._idx = len(self.buckets) - 1  # start at the full-size cap
        self._high_streak = 0
        self.occupancy_ema: Optional[float] = None
        self.switches = 0

    def note_occupancy(self, live: int, total: int) -> None:
        if total <= 0:
            return
        occ = min(max(live / total, 0.0), 1.0)
        self.occupancy_ema = (
            occ if self.occupancy_ema is None
            else (1.0 - self.alpha) * self.occupancy_ema + self.alpha * occ
        )

    def _target_idx(self) -> int:
        """Evenly spaced occupancy thresholds: bucket index i needs the
        EWMA strictly above i/len — a half-quarantined fleet (EWMA at
        0.5) sits at the floor of a two-bucket ladder."""
        if self.occupancy_ema is None:
            return len(self.buckets) - 1
        n = len(self.buckets)
        return sum(
            1 for k in range(1, n) if self.occupancy_ema > k / n
        )

    def pick(self) -> int:
        """The active bucket for the NEXT drain (called once per
        drain, after :meth:`note_occupancy`)."""
        t = self._target_idx()
        if t < self._idx:
            # collapse: the padding waste is being paid on every
            # dispatch — drop to the cheaper executable NOW
            self._idx = t
            self._high_streak = 0
            self.switches += 1
        elif t > self._idx:
            self._high_streak += 1
            if self._high_streak >= self.hysteresis_ticks:
                # recovered for long enough: step UP one bucket (not
                # to the target — a re-collapse drops back in one pick)
                self._idx += 1
                self._high_streak = 0
                self.switches += 1
        else:
            self._high_streak = 0
        return self.buckets[self._idx]

    @property
    def bucket(self) -> int:
        return self.buckets[self._idx]


class RungLadder:
    """One shard's rung state: hysteresis + the deadline budget.

    ``pick(backlog)`` is called once per drain.  The demand target is
    the smallest rung covering the backlog; moving UP to it is
    immediate, moving DOWN one rung needs ``hysteresis_ticks``
    consecutive drains whose target sat below the current rung.  The
    deadline budget then CAPS (never raises) the picked rung so the
    predicted drain wall time fits ``deadline_ms``; the cap leaves
    the hysteresis state untouched, so demand memory survives a
    temporarily tight budget.

    The predictor prefers the attached :class:`LatencyModel`'s
    per-(rung, bucket) MEASURED dispatch cost (pass the active bucket
    to ``pick``); the scalar per-tick EWMA (``tick_cost_ema``, the
    pre-model predictor) remains the fallback for rungs the table has
    never priced."""

    def __init__(
        self, cfg: SchedulerConfig, model: Optional[LatencyModel] = None
    ) -> None:
        self.cfg = cfg
        self.model = model
        self._idx = 0
        self._low_streak = 0
        self.tick_cost_ema: Optional[float] = None  # seconds/tick

    def _target_idx(self, backlog: int) -> int:
        for j, r in enumerate(self.cfg.rungs):
            if r >= backlog:
                return j
        return len(self.cfg.rungs) - 1

    def _predicted_cost(self, rung: int, bucket: Optional[int]):
        """Predicted wall seconds for ONE dispatch at ``rung``: the
        latency model's measured (rung, bucket) entry when it has one,
        else the scalar extrapolation (per-tick EWMA x depth)."""
        if self.model is not None:
            c = self.model.cost(rung, bucket)
            if c is not None:
                return c
        if self.tick_cost_ema:
            return rung * self.tick_cost_ema
        return None

    def pick(self, backlog: int, bucket: Optional[int] = None) -> int:
        t = self._target_idx(max(int(backlog), 1))
        if t > self._idx:
            # a burst: swallow it in one deep dispatch NOW
            self._idx = t
            self._low_streak = 0
        elif t < self._idx:
            self._low_streak += 1
            if self._low_streak >= self.cfg.hysteresis_ticks:
                # eased for long enough: step down ONE rung (not to the
                # target — a burst echo re-raises in one pick anyway)
                self._idx -= 1
                self._low_streak = 0
        else:
            self._low_streak = 0
        idx = self._idx
        if self.cfg.deadline_ms > 0:
            budget_s = self.cfg.deadline_ms / 1e3
            while idx > 0:
                cost = self._predicted_cost(self.cfg.rungs[idx], bucket)
                if cost is None or cost <= budget_s:
                    break
                idx -= 1
        return self.cfg.rungs[idx]

    # the deadline predictor's own smoothing constant — deliberately
    # NOT cfg.byte_rate_alpha: that knob tunes placement-weight
    # responsiveness, and retuning placement must not silently make
    # the SLO predictor jittery (or vice versa)
    DRAIN_COST_ALPHA = 0.2

    def note_drain(
        self,
        n_ticks: int,
        seconds: float,
        *,
        rung: Optional[int] = None,
        bucket: Optional[int] = None,
    ) -> None:
        """Record a drain's measured cost: the scalar per-tick EWMA
        (the model-less fallback predictor) always updates; with the
        drain's (rung, bucket) identity and an attached model, the
        per-dispatch cost — ``seconds / ceil(n_ticks / rung)`` — also
        refits that executable's table entry."""
        if n_ticks <= 0 or seconds < 0:
            return
        per = seconds / n_ticks
        a = self.DRAIN_COST_ALPHA
        self.tick_cost_ema = (
            per if self.tick_cost_ema is None
            else (1.0 - a) * self.tick_cost_ema + a * per
        )
        if self.model is not None and rung is not None and rung >= 1:
            n_dispatches = -(-n_ticks // int(rung))  # ceil
            if bucket is not None:
                self.model.note(
                    rung, bucket, seconds / n_dispatches
                )

    @property
    def rung(self) -> int:
        """The current demand rung (pre-deadline-cap)."""
        return self.cfg.rungs[self._idx]


class TrafficShaper:
    """The serving-plane policy object: per-stream admission queues +
    byte-rate EWMA + one :class:`RungLadder` per shard.

    ``offer_tick(items)`` admits one wall tick's arrivals (the
    ``submit_bytes`` item layout; an entry may also be a LIST of queued
    data ticks — a reconnect storm flushing a stalled device's buffer
    delivers several at once).  ``drain_plan(shard, lane_streams)``
    pops the hosted streams' queues front-aligned into global tick
    lists and picks the shard's rung; the caller dispatches them via
    ``submit_bytes_backlog(..., rung=...)`` and reports the measured
    wall time back through ``note_drain``.  Shedding happens at ADMIT
    time (bounded queues), so the drained tick sequence — and therefore
    every trajectory — is independent of rung choices by construction.
    """

    def __init__(
        self, streams: int, cfg: SchedulerConfig, *, shards: int = 1
    ) -> None:
        if streams < 1:
            raise ValueError("need at least one stream")
        if shards < 1:
            raise ValueError("need at least one shard")
        self.cfg = cfg
        self.streams = streams
        self.queues: list = [deque() for _ in range(streams)]
        self.admission_drops = [0] * streams
        self.shed_total = 0
        self.admitted_ticks = 0
        self.rates = ByteRateEwma(streams, cfg.byte_rate_alpha)
        # one measured (rung, bucket) cost table for the pod: every
        # shard runs the same steps over the same shapes,
        # so their timings price the same executables — sharing the
        # table means one shard's drains warm the predictor for all
        self.model = LatencyModel()
        self.ladders = [
            RungLadder(cfg, model=self.model) for _ in range(shards)
        ]
        self.last_rungs = [cfg.rungs[0]] * shards
        # the padding-bucket ladder (None when bucket_rungs is empty —
        # the static-bucket behavior), one per shard like the
        # rung ladders: each shard's occupancy tracks its own lanes
        self.bucket_ladders = (
            [
                BucketLadder(
                    cfg.bucket_rungs, cfg.hysteresis_ticks,
                    cfg.occupancy_alpha,
                )
                for _ in range(shards)
            ]
            if cfg.bucket_rungs else None
        )
        # cross-shard steal accounting: borrowed stream queues, the
        # queued ticks they carried, and the per-steal log —
        # ``steal_ticks == sum(n for *_ , n in steal_log)`` is the
        # accounting identity the scale-out benchmark asserts
        self.steals = 0
        self.steal_ticks = 0
        self.steal_log: list = []  # (dst_shard, src_shard, stream, n)

    # -- admission ---------------------------------------------------------

    def _admit(self, i: int, item) -> int:
        """Queue one data tick for stream ``i``; returns its byte
        count.  Past the bound the OLDEST queued tick is shed — the
        freshest data is what the SLO wants served, and the partial
        revolution the gap tears is exactly what the decode resync
        machinery already absorbs (a real device buffer overrunning
        drops the oldest frames the same way)."""
        nbytes = sum(len(p) for p, _ts in item[1])
        q = self.queues[i]
        q.append(item)
        self.admitted_ticks += 1
        if len(q) > self.cfg.max_backlog_ticks:
            q.popleft()
            self.admission_drops[i] += 1
            self.shed_total += 1
        return nbytes

    def shed_stream(self, i: int) -> int:
        """Shed a stream's ENTIRE backlog through the oldest-tick-shed
        counters — the autoscaler's park pre-shed.  A scale-down that
        would strand queued ticks on a parked shard sheds them here
        first, so the shed shows up in the same ``admission_drops`` /
        ``shed_total`` ledger operators already watch (a stranded
        queue silently dying is the failure mode this replaces).
        Returns the number of ticks shed."""
        q = self.queues[i]
        n = len(q)
        if n:
            q.clear()
            self.admission_drops[i] += n
            self.shed_total += n
        return n

    def offer_tick(self, items: Sequence) -> None:
        """Admit one wall tick of arrivals: ``items[i]`` is None (idle),
        one ``(ans_type, [(payload, ts), ...])`` data tick, or a list
        of queued data ticks (a burst arriving at once)."""
        if len(items) != self.streams:
            raise ValueError(
                f"expected {self.streams} per-stream items, "
                f"got {len(items)}"
            )
        for i, item in enumerate(items):
            if not item:
                self.rates.note(i, 0)
                continue
            burst = item if isinstance(item, list) else [item]
            self.rates.note(i, sum(self._admit(i, it) for it in burst))

    def backlog_depths(self) -> list:
        return [len(q) for q in self.queues]

    # -- steal planning ----------------------------------------------------

    def predict_drain_s(self, shard: int, depth: int) -> Optional[float]:
        """Model-priced wall seconds for ``shard`` to drain ``depth``
        queued ticks — the steal planner's headroom predictor.  The
        rung is the deeper of the ladder's current demand rung and the
        depth's target (``pick`` steps UP immediately, never below the
        hysteretic hold), priced per dispatch by the pod-shared latency
        model (scalar EWMA fallback).  None = unpriced: the planner
        treats an unpriced shard as having no headroom EVIDENCE, and
        vetoes the steal rather than gambling the deadline on it.
        Non-mutating — planning must not disturb ladder hysteresis."""
        if depth <= 0:
            return 0.0
        lad = self.ladders[shard]
        rung = max(lad.rung, self.cfg.rungs[lad._target_idx(depth)])
        bucket = (
            self.bucket_ladders[shard].bucket
            if self.bucket_ladders is not None else None
        )
        per = lad._predicted_cost(rung, bucket)
        if per is None:
            return None
        return -(-depth // rung) * per  # ceil(depth / rung) dispatches

    def plan_steals(self, hosted: dict, free_lanes: dict) -> dict:
        """The steal phase, run once per wall tick BEFORE any shard's
        :meth:`drain_plan` (drains pop queues, so the WHERE decision
        must precede every pop).  ``hosted`` maps each draining shard
        to its hosted stream ids, ``free_lanes`` to its idle-lane
        count.  Returns ``{taker_shard: [(stream, donor_shard), ...]}``
        — the caller moves each stream's row onto a taker lane, passes
        the ids as ``drain_plan``'s ``extra_streams``, and moves the
        row back after the drain (placement untouched: a steal is
        reversible by construction and cheaper than a migration).

        Policy: a DONOR's backlog depth exceeds
        ``steal_threshold_ticks``; a TAKER sits at or below it with an
        idle lane (the borrowed stream needs a real lane to stage on);
        with a time budget configured (``deadline_ms`` minus
        ``steal_headroom_ms``, or the headroom alone when no deadline)
        the taker's PREDICTED drain including the borrow must fit it —
        an unpriced model vetoes.  Deepest donors first, each donating
        its deepest queues to the shallowest qualifying taker, until
        the donor's depth sinks to the threshold.  Byte-equality is
        untouched: admission already happened, and each stolen queue
        drains front-aligned in its own per-stream order wherever it
        lands."""
        thr = self.cfg.steal_threshold_ticks
        if thr <= 0 or len(hosted) < 2:
            return {}
        budget_s = None
        if self.cfg.deadline_ms > 0:
            budget_s = (
                self.cfg.deadline_ms - self.cfg.steal_headroom_ms
            ) / 1e3
        elif self.cfg.steal_headroom_ms > 0:
            budget_s = self.cfg.steal_headroom_ms / 1e3
        depths = {
            s: max((len(self.queues[i]) for i in ids), default=0)
            for s, ids in hosted.items()
        }
        cap = {s: int(free_lanes.get(s, 0)) for s in hosted}
        # per-taker planned borrow depth: drain depth is a MAX over
        # queues, so a borrow only deepens a taker past its own depth
        extra = {s: 0 for s in hosted}
        taken: set = set()
        plan: dict = {}
        for src in sorted(hosted, key=lambda s: (-depths[s], s)):
            if depths[src] <= thr:
                break  # sorted: nobody after this donor is deep either
            for i in sorted(
                hosted[src], key=lambda j: (-len(self.queues[j]), j)
            ):
                if depths[src] <= thr:
                    break  # donor no longer deep
                n = len(self.queues[i])
                if n == 0 or i in taken:
                    continue
                best = None
                for dst in sorted(hosted):
                    if dst == src or depths[dst] > thr or cap[dst] <= 0:
                        continue
                    if budget_s is not None:
                        proj = max(depths[dst], extra[dst], n)
                        pred = self.predict_drain_s(dst, proj)
                        if pred is None or pred > budget_s:
                            continue
                    key = (max(depths[dst], extra[dst]), dst)
                    if best is None or key < best[0]:
                        best = (key, dst)
                if best is None:
                    continue  # a shallower queue may still fit a taker
                dst = best[1]
                plan.setdefault(dst, []).append((i, src))
                taken.add(i)
                cap[dst] -= 1
                extra[dst] = max(extra[dst], n)
                self.steals += 1
                self.steal_ticks += n
                self.steal_log.append((dst, src, i, n))
                depths[src] = max(
                    (
                        len(self.queues[j])
                        for j in hosted[src] if j not in taken
                    ),
                    default=0,
                )
        return plan

    # -- drain planning ----------------------------------------------------

    def drain_plan(
        self,
        shard: int,
        stream_ids: Sequence[int],
        extra_streams: Sequence[int] = (),
    ) -> tuple:
        """Pop the given streams' whole queued backlog, front-aligned
        into GLOBAL per-tick item lists (non-listed streams idle), and
        pick the shard's rung for the dispatch grouping.  Returns
        ``(ticks, rung)`` — ``([], rung)`` when nothing is queued (the
        ladder still observes the empty drain, so it can step down).
        The shard's live-lane occupancy is observed here (lanes whose
        queues held data vs all hosted lanes) and the bucket ladder
        picked BEFORE the rung, so the deadline cap prices rungs with
        the bucket the drain will actually dispatch on.

        ``extra_streams`` are queues BORROWED for this drain (the
        :meth:`plan_steals` output): they join the pop set, the depth,
        and the occupancy count — a borrowed stream stages on a real
        lane of this shard — while the donor passes the same ids as
        None in ITS ``stream_ids`` so no queue pops twice."""
        ids = [i for i in stream_ids if i is not None]
        ids += [i for i in extra_streams if i is not None]
        depth = max((len(self.queues[i]) for i in ids), default=0)
        bucket = None
        if self.bucket_ladders is not None and ids:
            bl = self.bucket_ladders[shard]
            bl.note_occupancy(
                sum(1 for i in ids if self.queues[i]), len(ids)
            )
            bucket = bl.pick()
        rung = self.ladders[shard].pick(depth, bucket=bucket)
        self.last_rungs[shard] = rung
        if depth == 0:
            return [], rung
        ticks = []
        for _ in range(depth):
            tick: list = [None] * self.streams
            for i in ids:
                if self.queues[i]:
                    tick[i] = self.queues[i].popleft()
            ticks.append(tick)
        return ticks, rung

    def bucket_plan(self, shard: int) -> Optional[int]:
        """The shard's active padding bucket (None: ladder disabled —
        the engine keeps its static largest-bucket slicing cap)."""
        if self.bucket_ladders is None:
            return None
        return self.bucket_ladders[shard].bucket

    def note_drain(
        self,
        shard: int,
        n_ticks: int,
        seconds: float,
        *,
        rung: Optional[int] = None,
        bucket: Optional[int] = None,
    ) -> None:
        self.ladders[shard].note_drain(
            n_ticks, seconds, rung=rung, bucket=bucket
        )

    # -- observability -----------------------------------------------------

    def status(self) -> dict:
        """The /diagnostics scheduler value group's payload
        (node/diagnostics.py renders it; tests pin the rendering)."""
        status = {
            "rungs": list(self.last_rungs),
            "backlog": self.backlog_depths(),
            "admission_drops": list(self.admission_drops),
            "shed_total": self.shed_total,
            "byte_rates": [round(r, 1) for r in self.rates.rates()],
            "latency_model": self.model.table_ms(),
            "steals": self.steals,
            "steal_ticks": self.steal_ticks,
        }
        if self.bucket_ladders is not None:
            status["active_buckets"] = [
                bl.bucket for bl in self.bucket_ladders
            ]
            status["bucket_switches"] = sum(
                bl.switches for bl in self.bucket_ladders
            )
        return status


class PodAutoscaler:
    """The byte-rate autoscale policy: watermark + streak hysteresis
    over the fleet's live-stream occupancy, deciding when the pod spins
    a shard down (sustained thin traffic) or re-admits one (sustained
    pressure).  Pure policy, like the ladders: the service executes the
    decision (graceful evacuation via the failover relabel machinery for
    DOWN, ``rebalance_into`` for UP), this class only says when.

    The signal is the scheduler's per-stream byte-rate EWMA: a stream
    is LIVE while its EWMA sits at or above ``autoscale_rate_floor``
    bytes/tick (the EWMA decays while a stream is quiet, so liveness
    expires on its own), and occupancy is live streams over the ACTIVE
    fleet's lane capacity.  Hysteresis mirrors the rung/bucket ladders
    twice over: the watermark gap is a dead zone no decision fires in
    (occupancy between low and high resets both streaks), and either
    decision needs ``autoscale_hysteresis_ticks`` CONSECUTIVE ticks on
    its side of the gap — a sawtooth that recrosses the band restarts
    the count, so it can never thrash scale events the way it would a
    threshold comparator."""

    def __init__(self, cfg: SchedulerConfig, lanes: int) -> None:
        if lanes < 1:
            raise ValueError("need at least one lane per shard")
        self.cfg = cfg
        self.lanes = int(lanes)
        self.occupancy: Optional[float] = None
        self.scale_downs = 0
        self.scale_ups = 0
        self._thin_streak = 0
        self._pressure_streak = 0
        self.state = "steady"

    def live_streams(self, rates: Sequence[float]) -> int:
        """Streams whose byte-rate EWMA clears the liveness floor."""
        floor = self.cfg.autoscale_rate_floor
        return sum(1 for r in rates if r >= floor)

    def note_tick(
        self,
        rates: Sequence[float],
        active_shards: int,
        *,
        can_down: bool = True,
        can_up: bool = True,
    ) -> Optional[str]:
        """Observe one wall tick; returns ``"down"``, ``"up"``, or
        None.  ``can_down``/``can_up`` gate what the fleet can execute
        (capacity invariant, ``autoscale_min_shards``, parked shards
        available) — a gated side ticks its streak without firing, so
        the decision lands the moment the gate opens instead of
        restarting the wait."""
        live = self.live_streams(rates)
        cap = max(int(active_shards) * self.lanes, 1)
        occ = min(live / cap, 1.0)
        self.occupancy = occ
        n = self.cfg.autoscale_hysteresis_ticks
        decision = None
        if occ < self.cfg.autoscale_low_watermark:
            self._thin_streak += 1
            self._pressure_streak = 0
            self.state = f"thin {min(self._thin_streak, n)}/{n}"
            if self._thin_streak >= n and can_down:
                decision = "down"
                self._thin_streak = 0
                self.scale_downs += 1
        elif occ > self.cfg.autoscale_high_watermark:
            self._pressure_streak += 1
            self._thin_streak = 0
            self.state = f"pressure {min(self._pressure_streak, n)}/{n}"
            if self._pressure_streak >= n and can_up:
                decision = "up"
                self._pressure_streak = 0
                self.scale_ups += 1
        else:
            self._thin_streak = 0
            self._pressure_streak = 0
            self.state = "steady"
        return decision

    def status(self) -> dict:
        """The /diagnostics Pod value group's autoscaler payload."""
        return {
            "state": self.state,
            "occupancy": (
                None if self.occupancy is None
                else round(self.occupancy, 3)
            ),
            "scale_downs": self.scale_downs,
            "scale_ups": self.scale_ups,
        }

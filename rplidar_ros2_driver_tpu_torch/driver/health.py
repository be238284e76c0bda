"""Per-stream health FSM + capped-backoff primitives.

The single-stream driver already has a fault-tolerant scan loop
(node/fsm.py — the reference's 5-state recovery FSM).  This module is
its FLEET-scale counterpart: one :class:`StreamHealth` state machine per
lidar, driven by the per-tick signals the fleet seams already produce
(frame counts, malformed-frame counts, completed revolutions), so a
single wedged or garbage-spewing stream degrades to an idle padding
lane instead of stalling or poisoning the fleet tick.

::

    HEALTHY ──bad──► SUSPECT ──bad×K──► QUARANTINED
       ▲                │                    │ backoff expires
       │◄──clean×P──────┘                    │ + device-health probe OK
       │                                     ▼
       └────────clean×P────────────── RECOVERING
                                             │ bad (relapse)
                                             └──────► QUARANTINED (escalated)

"bad" is a corrupt-frame ratio over a sliding tick window above
threshold, OR a tick-starvation age (frames arriving, or a previously
streaming stream gone silent, with no completed revolution) above
threshold.  Quarantine release is gated on a capped exponential backoff
with deterministic jitter (:class:`BackoffPolicy`) and, when a probe is
wired, on the device answering ``GET_DEVICE_HEALTH`` with OK/WARNING
(protocol/constants.HealthStatus — the reference's CHECK_HEALTH gate,
applied per stream on re-entry).

:class:`FleetHealth` packages N of these behind the two-call tick API
the service seams use (``begin_tick`` masks quarantined streams onto
the existing idle padding lanes — the same fleet step, unchanged
shapes; ``end_tick`` feeds the observations back), with transition
hooks the service binds to its quarantine-checkpoint / rejoin-restore
machinery (parallel/service.py).

Everything here is host-side bookkeeping: no device work, and a
``clock`` injection point so tests drive the backoff deterministically.
The JAX package's module of the same name, copied (the port imports
nothing of that package).
"""

from __future__ import annotations

import dataclasses
import enum
import logging
import random
import time
from collections import deque
from typing import Callable, Optional

from rplidar_ros2_driver_tpu_torch.protocol.constants import (
    ANS_PAYLOAD_BYTES,
    HealthStatus,
)

log = logging.getLogger("rplidar_tpu.health")


class BackoffPolicy:
    """Capped exponential backoff with jitter — the ONE retry-delay
    helper (reconnects, quarantine release, probe retries), so no loop
    hand-rolls an unbounded ``while True: sleep(k)``.

    ``next_delay()`` returns ``min(base * 2**(attempt-1), max) *
    (1 + jitter * u)`` with ``u ∈ [0, 1)`` from a private RNG —
    seedable for deterministic tests, decorrelated across streams in
    production so a fleet-wide outage does not produce a synchronized
    reconnect storm.
    """

    def __init__(
        self,
        base_s: float = 0.5,
        max_s: float = 30.0,
        jitter: float = 0.1,
        seed: Optional[int] = None,
    ) -> None:
        if base_s <= 0 or max_s < base_s:
            raise ValueError("need 0 < base_s <= max_s")
        if not (0.0 <= jitter <= 1.0):
            raise ValueError("jitter must be within [0, 1]")
        self.base_s = float(base_s)
        self.max_s = float(max_s)
        self.jitter = float(jitter)
        self._rng = random.Random(seed)
        self.attempt = 0
        self.last_delay_s = 0.0

    def next_delay(self) -> float:
        self.attempt += 1
        # exponent clamp BEFORE the cap: 2.0**1024 overflows a Python
        # float, and a device that stays dead for hours walks the
        # attempt counter that far — an OverflowError here would crash
        # the retry loop it exists to pace (fleet tick included)
        raw = min(
            self.base_s * (2.0 ** min(self.attempt - 1, 63)), self.max_s
        )
        self.last_delay_s = raw * (1.0 + self.jitter * self._rng.random())
        return self.last_delay_s

    def reset(self) -> None:
        self.attempt = 0
        self.last_delay_s = 0.0


class StreamState(enum.Enum):
    HEALTHY = "healthy"
    SUSPECT = "suspect"
    QUARANTINED = "quarantined"
    RECOVERING = "recovering"


@dataclasses.dataclass(frozen=True)
class HealthConfig:
    """Thresholds (defaults mirror core/config.DriverParams.health_*)."""

    window_ticks: int = 8        # sliding observation window (ticks)
    corrupt_ratio: float = 0.5   # malformed/total over the window -> bad
    starvation_ticks: int = 16   # ticks w/o a completed revolution -> bad
    suspect_ticks: int = 4       # consecutive bad ticks -> QUARANTINED
    probation_ticks: int = 4     # consecutive clean ticks -> HEALTHY
    backoff_base_s: float = 0.5
    backoff_max_s: float = 30.0
    backoff_jitter: float = 0.1
    seed: int = 0                # jitter seed base (stream id mixed in)

    # minimum window frames before the corrupt ratio means anything (a
    # single malformed frame in an otherwise-quiet window is noise, not
    # a sick cable) — internal, not a deployment knob
    MIN_RATIO_FRAMES = 4

    def __post_init__(self) -> None:
        # the same domain DriverParams.validate() enforces, applied at
        # THIS boundary too: direct construction (bench, tests, any
        # embedder wiring FleetHealth by hand) must not silently
        # disable health signals — window_ticks=0 would make the
        # observation deque discard everything, a >1 corrupt_ratio is
        # unreachable, and BackoffPolicy rejects its own domain below
        if self.window_ticks < 1:
            raise ValueError("window_ticks must be >= 1")
        if not (0.0 < self.corrupt_ratio <= 1.0):
            raise ValueError("corrupt_ratio must be within (0, 1]")
        if self.starvation_ticks < 1:
            raise ValueError("starvation_ticks must be >= 1")
        if self.suspect_ticks < 1:
            raise ValueError("suspect_ticks must be >= 1")
        if self.probation_ticks < 1:
            raise ValueError("probation_ticks must be >= 1")
        if self.backoff_base_s <= 0 or self.backoff_max_s < (
            self.backoff_base_s
        ):
            raise ValueError("need 0 < backoff_base_s <= backoff_max_s")
        if not (0.0 <= self.backoff_jitter <= 1.0):
            raise ValueError("backoff_jitter must be within [0, 1]")

    @classmethod
    def from_params(cls, params) -> "HealthConfig":
        """The one params -> HealthConfig mapping (DriverParams carries
        these as ``health_*`` so the YAML stays the deployment source
        of truth)."""
        g = lambda k, d: getattr(params, k, d)  # noqa: E731 - tiny local
        return cls(
            window_ticks=int(g("health_window_ticks", 8)),
            corrupt_ratio=float(g("health_corrupt_ratio", 0.5)),
            starvation_ticks=int(g("health_starvation_ticks", 16)),
            suspect_ticks=int(g("health_suspect_ticks", 4)),
            probation_ticks=int(g("health_probation_ticks", 4)),
            backoff_base_s=float(g("health_backoff_base_s", 0.5)),
            backoff_max_s=float(g("health_backoff_max_s", 30.0)),
            backoff_jitter=float(g("health_backoff_jitter", 0.1)),
        )


def probe_ok(result) -> bool:
    """Interpret a health probe's answer: bools pass through; enums/ints
    follow the reference's CHECK_HEALTH gate (OK/WARNING pass, ERROR and
    silence fail — node/fsm.py:_do_check_health)."""
    if result is None:
        return False
    if isinstance(result, bool):
        return result
    try:
        return int(result) <= int(HealthStatus.WARNING)
    except (TypeError, ValueError):
        return False


def gated_release(clock, release_at: float, probe, backoff) -> tuple:
    """The ONE backoff+probe re-admission gate, shared by
    :meth:`StreamHealth.poll_release` and
    :meth:`ShardHealth.poll_readmit` so the semantics (probe exceptions
    count as failures, :func:`probe_ok` interpretation, escalated — not
    reset — re-arm on failure) cannot drift between the two FSMs.

    Returns ``("wait", None)`` while the backoff has not expired,
    ``("failed", rearm_at)`` when the probe refused (caller records the
    failure + new release time), or ``("pass", None)``.
    """
    if clock() < release_at:
        return "wait", None
    if probe is not None:
        try:
            result = probe()
        except Exception:
            result = None
        if not probe_ok(result):
            return "failed", clock() + backoff.next_delay()
    return "pass", None


class StreamHealth:
    """One stream's health FSM (see module diagram).

    Drive it with one :meth:`observe` per admitted tick and one
    :meth:`poll_release` per tick while quarantined.  Both return the
    ``(old, new)`` state transition when one fired, else None.
    """

    def __init__(
        self,
        cfg: Optional[HealthConfig] = None,
        stream_id: int = 0,
        *,
        clock: Callable[[], float] = time.monotonic,
        probe: Optional[Callable[[], object]] = None,
    ) -> None:
        self.cfg = cfg or HealthConfig()
        self.stream_id = stream_id
        self._clock = clock
        self.probe = probe
        self.state = StreamState.HEALTHY
        self.backoff = BackoffPolicy(
            self.cfg.backoff_base_s,
            self.cfg.backoff_max_s,
            self.cfg.backoff_jitter,
            seed=self.cfg.seed * 65537 + stream_id,
        )
        self.release_at = 0.0
        self._window: deque = deque(maxlen=self.cfg.window_ticks)
        self._bad_streak = 0
        self._clean_streak = 0
        self._starved = 0
        self._streaming = False  # has this stream ever completed a rev?
        # cumulative counters (diagnostics surface)
        self.frames_seen = 0
        self.frames_malformed = 0
        self.completions = 0
        self.quarantines = 0
        self.recoveries = 0
        self.reconnect_failures = 0
        self.last_reason = ""

    # -- signal evaluation ------------------------------------------------

    def _corrupt_ratio(self) -> float:
        frames = sum(f for f, _ in self._window)
        if frames < self.cfg.MIN_RATIO_FRAMES:
            return 0.0
        return sum(m for _, m in self._window) / frames

    def _evaluate(self, frames: int, malformed: int, completed: int) -> bool:
        """Fold one tick's signals in; returns whether the tick is bad."""
        self.frames_seen += frames
        self.frames_malformed += malformed
        self._window.append((frames, malformed))
        if completed > 0:
            self.completions += completed
            self._starved = 0
            self._streaming = True
        elif frames > 0 or self._streaming:
            # frames without revolutions, or a previously streaming
            # stream gone silent: the starvation age ticks up.  A stream
            # that never streamed and sends nothing is idle, not sick.
            self._starved += 1
        ratio = self._corrupt_ratio()
        if ratio > self.cfg.corrupt_ratio:
            self.last_reason = f"corrupt-frame ratio {ratio:.2f}"
            return True
        if self._starved > self.cfg.starvation_ticks:
            self.last_reason = f"starved {self._starved} ticks"
            return True
        return False

    def _clear_signals(self) -> None:
        self._window.clear()
        self._bad_streak = 0
        self._clean_streak = 0
        self._starved = 0

    # -- transitions ------------------------------------------------------

    def _to(self, new: StreamState) -> tuple:
        old, self.state = self.state, new
        log.info(
            "stream %d health: %s -> %s (%s)",
            self.stream_id, old.value, new.value, self.last_reason or "-",
        )
        return (old, new)

    def _enter_quarantine(self) -> tuple:
        self.quarantines += 1
        self.release_at = self._clock() + self.backoff.next_delay()
        self._clear_signals()
        return self._to(StreamState.QUARANTINED)

    def observe(
        self, frames: int, malformed: int, completed: int
    ) -> Optional[tuple]:
        """One admitted tick's signals (quarantined streams are masked
        upstream and must not be fed here)."""
        if self.state is StreamState.QUARANTINED:
            return None  # masked: nothing reaches a quarantined stream
        bad = self._evaluate(frames, malformed, completed)
        if bad:
            self._bad_streak += 1
            self._clean_streak = 0
        else:
            self._clean_streak += 1
            self._bad_streak = 0
        if self.state is StreamState.HEALTHY:
            if bad:
                return self._to(StreamState.SUSPECT)
        elif self.state is StreamState.SUSPECT:
            if self._bad_streak >= self.cfg.suspect_ticks:
                return self._enter_quarantine()
            if self._clean_streak >= self.cfg.probation_ticks:
                self.last_reason = "probation clean"
                return self._to(StreamState.HEALTHY)
        elif self.state is StreamState.RECOVERING:
            if bad:
                # relapse: straight back, with the backoff ESCALATED
                # (the policy was not reset on release)
                return self._enter_quarantine()
            if self._clean_streak >= self.cfg.probation_ticks:
                self.last_reason = "recovered"
                self.recoveries += 1
                self.backoff.reset()
                return self._to(StreamState.HEALTHY)
        return None

    def poll_release(self) -> Optional[tuple]:
        """Quarantine-release gate, called once per tick while
        quarantined: after the backoff expires, the stream must also
        pass its device-health probe (when wired) before it re-enters as
        RECOVERING.  A failed probe re-arms the (escalated) backoff."""
        if self.state is not StreamState.QUARANTINED:
            return None
        verdict, rearm = gated_release(
            self._clock, self.release_at, self.probe, self.backoff
        )
        if verdict == "wait":
            return None
        if verdict == "failed":
            self.reconnect_failures += 1
            self.release_at = rearm
            self.last_reason = (
                f"health probe failed x{self.reconnect_failures}"
            )
            return None
        self._clear_signals()
        self.last_reason = "backoff expired, probe ok"
        return self._to(StreamState.RECOVERING)

    @property
    def admitted(self) -> bool:
        """Whether this stream's bytes enter the fleet tick (quarantined
        streams ride the padding buckets as idle lanes instead)."""
        return self.state is not StreamState.QUARANTINED

    def status(self) -> dict:
        """Host dict for /diagnostics-style reporting."""
        return {
            "state": self.state.value,
            "frames": self.frames_seen,
            "malformed": self.frames_malformed,
            "completions": self.completions,
            "quarantines": self.quarantines,
            "recoveries": self.recoveries,
            "reconnect_failures": self.reconnect_failures,
            "backoff_attempt": self.backoff.attempt,
            "backoff_s": round(self.backoff.last_delay_s, 3),
            "reason": self.last_reason,
        }


# ---------------------------------------------------------------------------
# shard-level health (the fleet-of-fleets layer above the per-stream FSM)
# ---------------------------------------------------------------------------


class ShardState(enum.Enum):
    UP = "up"
    SUSPECT = "suspect"
    LOST = "lost"
    READMITTING = "readmitting"


@dataclasses.dataclass(frozen=True)
class ShardHealthConfig:
    """Thresholds for one SHARD's FSM (defaults mirror
    core/config.DriverParams.shard_*).  A shard is a whole engine pair
    hosting several streams (parallel/service.ElasticFleetService), so
    its failure signals differ from a stream's: a dead dispatch
    (heartbeat) is LOST immediately — there is no "maybe" about an
    exception out of the compiled tick — while fleet-wide tick
    starvation (zero completions anywhere while bytes are offered on
    its lanes — or while a previously streaming shard sits silent,
    like a sick cable: the upstream going quiet is a loss signal too)
    walks UP -> SUSPECT -> LOST like a sick cable would."""

    starvation_ticks: int = 8    # all-lane dry ticks while offered -> bad
    suspect_ticks: int = 4       # consecutive bad ticks -> LOST
    probation_ticks: int = 4     # clean ticks in READMITTING -> UP
    backoff_base_s: float = 1.0  # re-admission probe backoff
    backoff_max_s: float = 60.0
    backoff_jitter: float = 0.1
    seed: int = 0

    def __post_init__(self) -> None:
        if self.starvation_ticks < 1:
            raise ValueError("starvation_ticks must be >= 1")
        if self.suspect_ticks < 1:
            raise ValueError("suspect_ticks must be >= 1")
        if self.probation_ticks < 1:
            raise ValueError("probation_ticks must be >= 1")
        if self.backoff_base_s <= 0 or self.backoff_max_s < (
            self.backoff_base_s
        ):
            raise ValueError("need 0 < backoff_base_s <= backoff_max_s")
        if not (0.0 <= self.backoff_jitter <= 1.0):
            raise ValueError("backoff_jitter must be within [0, 1]")

    @classmethod
    def from_params(cls, params) -> "ShardHealthConfig":
        """The one params -> ShardHealthConfig mapping (DriverParams
        carries these as ``shard_*``, param/rplidar.yaml is the
        deployment source of truth)."""
        g = lambda k, d: getattr(params, k, d)  # noqa: E731 - tiny local
        return cls(
            starvation_ticks=int(g("shard_starvation_ticks", 8)),
            suspect_ticks=int(g("shard_suspect_ticks", 4)),
            probation_ticks=int(g("shard_probation_ticks", 4)),
            backoff_base_s=float(g("shard_backoff_base_s", 1.0)),
            backoff_max_s=float(g("shard_backoff_max_s", 60.0)),
            backoff_jitter=float(g("shard_backoff_jitter", 0.1)),
        )


class ShardHealth:
    """One shard's health FSM::

        UP ──starved×K──► SUSPECT ──bad×S──► LOST ◄────────┐
        ▲        │ clean                        │ backoff   │ relapse
        │◄───────┘                              │ + probe OK│ (escalated)
        │                                       ▼           │
        └──────────clean×P────────────── READMITTING ───────┘

    plus the hard edge every state except LOST has: ``force_lost`` (a
    heartbeat failure — the shard's dispatch raised, or the chaos
    schedule killed it) goes straight to LOST, no probation.

    Drive it with one :meth:`observe` per tick while hosting streams
    and one :meth:`poll_readmit` per tick while LOST.  Host-side only
    (no device work), ``clock``-injected like :class:`StreamHealth`.
    """

    def __init__(
        self,
        cfg: Optional[ShardHealthConfig] = None,
        shard_id: int = 0,
        *,
        clock: Callable[[], float] = time.monotonic,
        probe: Optional[Callable[[], object]] = None,
    ) -> None:
        self.cfg = cfg or ShardHealthConfig()
        self.shard_id = shard_id
        self._clock = clock
        self.probe = probe
        self.state = ShardState.UP
        self.backoff = BackoffPolicy(
            self.cfg.backoff_base_s,
            self.cfg.backoff_max_s,
            self.cfg.backoff_jitter,
            seed=self.cfg.seed * 131071 + shard_id,
        )
        self.release_at = 0.0
        self._starved = 0
        self._bad_streak = 0
        self._clean_streak = 0
        self._streaming = False  # any lane ever completed a revolution?
        # cumulative counters (diagnostics surface)
        self.losses = 0
        self.readmissions = 0
        self.probe_failures = 0
        self.last_reason = ""

    def _to(self, new: ShardState) -> tuple:
        old, self.state = self.state, new
        log.info(
            "shard %d health: %s -> %s (%s)",
            self.shard_id, old.value, new.value, self.last_reason or "-",
        )
        return (old, new)

    def _enter_lost(self) -> tuple:
        self.losses += 1
        self.release_at = self._clock() + self.backoff.next_delay()
        self._starved = 0
        self._bad_streak = 0
        self._clean_streak = 0
        # the loss wipes the shard's engines (cold_reset): it is
        # factually a fresh shard, so "has it ever streamed" restarts
        # too.  Carrying _streaming across the loss would make an
        # empty re-admitted shard (rebalance found no stream to give
        # it) starve on silence and relapse forever — a permanent
        # LOST/READMITTING flap on healthy hardware
        self._streaming = False
        return self._to(ShardState.LOST)

    def force_lost(self, reason: str = "heartbeat failure") -> Optional[tuple]:
        """Hard kill: dispatch raised / chaos schedule / operator drain.
        No probation — the shard's device state is gone either way."""
        if self.state is ShardState.LOST:
            return None
        self.last_reason = reason
        return self._enter_lost()

    def observe(self, offered: bool, completed: int) -> Optional[tuple]:
        """One hosted tick's aggregate signals: whether any lane was
        offered bytes, and how many revolutions completed across all
        lanes.  LOST shards host nothing and must not be fed here."""
        if self.state is ShardState.LOST:
            return None
        if completed > 0:
            self._starved = 0
            self._streaming = True
            bad = False
        elif offered or self._streaming:
            self._starved += 1
            # READMITTING gets ONE extra starvation window: the
            # migrate-back reset every victim's decode carries, so the
            # first revolution structurally needs up to a full window
            # of dry ticks before silence is evidence of anything — a
            # healthy shard must not be condemned to relapse on every
            # re-admission.  A dead shard still relapses (promotion
            # needs PRODUCTIVE ticks), one window later.
            limit = self.cfg.starvation_ticks * (
                2 if self.state is ShardState.READMITTING else 1
            )
            bad = self._starved > limit
            if bad:
                self.last_reason = f"shard starved {self._starved} ticks"
        else:
            bad = False  # nothing offered, never streamed: idle shard
        if bad:
            self._bad_streak += 1
            self._clean_streak = 0
        elif completed > 0 or not (offered or self._streaming):
            self._clean_streak += 1
            self._bad_streak = 0
        else:
            # offered but dry, below the starvation threshold: neither
            # clean nor bad.  A clean streak must be PRODUCTIVE ticks
            # (or true idle) — otherwise a probe-passing-but-dead shard
            # fills probation_ticks of silence before starvation can
            # fire, gets promoted with its backoff reset, and flaps
            # forever at the base delay with streams migrated onto it
            # each cycle (the relapse edge below would be dead code
            # whenever probation_ticks <= starvation_ticks)
            self._bad_streak = 0
        if self.state is ShardState.UP:
            if bad:
                return self._to(ShardState.SUSPECT)
        elif self.state is ShardState.SUSPECT:
            if self._bad_streak >= self.cfg.suspect_ticks:
                return self._enter_lost()
            if self._clean_streak >= self.cfg.probation_ticks:
                self.last_reason = "probation clean"
                return self._to(ShardState.UP)
        elif self.state is ShardState.READMITTING:
            if bad:
                # relapse: straight back, backoff ESCALATED (not reset)
                return self._enter_lost()
            if self._clean_streak >= self.cfg.probation_ticks:
                self.last_reason = "readmitted"
                self.readmissions += 1
                self.backoff.reset()
                return self._to(ShardState.UP)
        return None

    def poll_readmit(self) -> Optional[tuple]:
        """Re-admission gate, once per tick while LOST: after the
        capped backoff expires the shard must also pass its probe (when
        wired — the pod wires the chaos schedule's liveness there, a
        real deployment wires a device/host health check) before it
        re-enters as READMITTING.  A failed probe re-arms the
        escalated backoff."""
        if self.state is not ShardState.LOST:
            return None
        verdict, rearm = gated_release(
            self._clock, self.release_at, self.probe, self.backoff
        )
        if verdict == "wait":
            return None
        if verdict == "failed":
            self.probe_failures += 1
            self.release_at = rearm
            self.last_reason = (
                f"readmission probe failed x{self.probe_failures}"
            )
            return None
        self._starved = 0
        self._bad_streak = 0
        self._clean_streak = 0
        self.last_reason = "backoff expired, probe ok"
        return self._to(ShardState.READMITTING)

    @property
    def hosting(self) -> bool:
        """Whether this shard can host streams (LOST shards host
        nothing; their lanes were evacuated)."""
        return self.state is not ShardState.LOST

    def status(self) -> dict:
        """Host dict for /diagnostics-style reporting."""
        return {
            "state": self.state.value,
            "losses": self.losses,
            "readmissions": self.readmissions,
            "probe_failures": self.probe_failures,
            "backoff_attempt": self.backoff.attempt,
            "backoff_s": round(self.backoff.last_delay_s, 3),
            "reason": self.last_reason,
        }


def _count_item(item) -> tuple[int, int]:
    """(frames, malformed) of one per-stream tick item — the SAME
    length-based malformed test every ingest backend applies
    (ANS_PAYLOAD_BYTES), so the health view matches what the engines
    will actually drop."""
    if not item:
        return 0, 0
    ans, frames = item
    expect = ANS_PAYLOAD_BYTES.get(ans)
    n = len(frames)
    if expect is None:
        return n, n  # unknown answer type: every frame is garbage
    bad = sum(1 for f, _ts in frames if len(f) != expect)
    return n, bad


def _count_completed(out) -> int:
    """Completions in one per-stream tick result (the seams return
    either one Optional[FilterOutput] or a list of revolutions)."""
    if out is None:
        return 0
    if isinstance(out, (list, tuple)):
        return len(out)
    return 1


class FleetHealth:
    """N per-stream FSMs behind the fleet tick seam.

    Usage (parallel/service.py wires this automatically)::

        masked = health.begin_tick(items)   # release polls + masking
        outs = <dispatch masked tick>
        health.end_tick(outs)               # observations + transitions

    ``on_quarantine(i)`` fires when stream i enters QUARANTINED (the
    service snapshots that stream's filter+map state there);
    ``on_recover(i)`` fires when its backoff+probe gate releases it into
    RECOVERING (the service restores the checkpoint there, BEFORE the
    tick's bytes flow again).  ``mask`` is the observation-free variant
    for backlog drains (catch-up is not steady ticking).
    """

    def __init__(
        self,
        streams: int,
        cfg: Optional[HealthConfig] = None,
        *,
        clock: Callable[[], float] = time.monotonic,
        probes: Optional[dict] = None,
        on_quarantine: Optional[Callable[[int], None]] = None,
        on_recover: Optional[Callable[[int], None]] = None,
        record_masks: bool = False,
    ) -> None:
        if streams < 1:
            raise ValueError("need at least one stream")
        cfg = cfg or HealthConfig()
        probes = probes or {}
        self.cfg = cfg
        self.health = [
            StreamHealth(cfg, i, clock=clock, probe=probes.get(i))
            for i in range(streams)
        ]
        self.on_quarantine = on_quarantine
        self.on_recover = on_recover
        self.tick_no = 0
        # transition log: (tick_no, stream, old.value, new.value)
        self.events: list[tuple] = []
        # per-tick admitted-mask log (opt-in: tests + chaos parity
        # harnesses replay the exact masked stream into the golden path)
        self.mask_log: Optional[list] = [] if record_masks else None
        self._pending_obs: Optional[list] = None

    @property
    def streams(self) -> int:
        return len(self.health)

    def set_probe(self, i: int, probe: Optional[Callable]) -> None:
        self.health[i].probe = probe

    def admitted(self) -> list[bool]:
        return [h.admitted for h in self.health]

    def _record(self, i: int, tr: Optional[tuple]) -> Optional[tuple]:
        if tr is not None:
            self.events.append((self.tick_no, i, tr[0].value, tr[1].value))
        return tr

    def begin_tick(self, items: list) -> list:
        """Release polls, then mask quarantined streams' items to None
        (the idle-lane encoding the padding buckets already compile
        for).  Stashes the admitted streams' (frames, malformed) counts
        for :meth:`end_tick`."""
        if len(items) != self.streams:
            raise ValueError(
                f"expected {self.streams} per-stream items, got {len(items)}"
            )
        for i, h in enumerate(self.health):
            tr = self._record(i, h.poll_release())
            if tr is not None and self.on_recover is not None:
                # restore BEFORE this tick's bytes flow into the engine
                self.on_recover(i)
        masked, obs = [], []
        for i, h in enumerate(self.health):
            if not h.admitted:
                masked.append(None)
                obs.append(None)
            else:
                masked.append(items[i])
                obs.append(_count_item(items[i]))
        self._pending_obs = obs
        if self.mask_log is not None:
            self.mask_log.append([h.admitted for h in self.health])
        return masked

    def end_tick(self, outs: Optional[list]) -> None:
        """Feed the tick's per-stream results back and run transitions.
        ``outs`` follows the seam's shape (Optional[FilterOutput] or a
        revolution list per stream); None means the tick produced no
        result vector (treated as zero completions everywhere)."""
        obs, self._pending_obs = self._pending_obs, None
        if obs is None:
            obs = [
                (0, 0) if h.admitted else None for h in self.health
            ]
        for i, h in enumerate(self.health):
            if obs[i] is None:
                continue  # was quarantined this tick: masked, unobserved
            frames, malformed = obs[i]
            completed = _count_completed(outs[i]) if outs is not None else 0
            tr = self._record(i, h.observe(frames, malformed, completed))
            if (
                tr is not None
                and tr[1] is StreamState.QUARANTINED
                and self.on_quarantine is not None
            ):
                self.on_quarantine(i)
        self.tick_no += 1

    def mask(self, items: list) -> list:
        """Masking WITHOUT observation — the backlog-drain seam's
        variant (a catch-up drain is one event, not len(ticks) of
        steady-state evidence; the FSM advances on live ticks only)."""
        return [
            items[i] if h.admitted else None
            for i, h in enumerate(self.health)
        ]

    def status(self) -> list[dict]:
        return [h.status() for h in self.health]

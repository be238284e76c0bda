"""Deterministic fault injection — the chaos plane of the fleet (a copy
of the JAX package's ``driver/chaos.py``; numpy only).

The reference driver's defining property is surviving a hostile wire:
garbage bytes, torn capsules, yanked cables (README.md's community
stress protocol).  This module makes that property TESTABLE at fleet
scale by generating faults from a seeded, schedule-driven program that
is a pure function of ``(seed, frame_index, payload)`` — so the
host-golden decode path and the fused device path can be handed
byte-for-byte the SAME corrupted stream, and the bit-exact parity
contract (tests/test_fused_ingest.py et al.) extends to degraded input.

Three injection points, one schedule:

  * :class:`ChaosStream` — frame-level applier for the fleet tick
    harnesses (tests, bench --config 13): corrupts/truncates/drops the
    ``(payload, rx_ts)`` runs fed to ``submit_bytes``-shaped seams.
  * :class:`ChaosTransport` — a ``TransceiverLike`` wrapper for the live
    driver stack (protocol/engine.py pump): same fault program applied
    to decoded measurement messages, plus stalls (timeout reads) and
    mid-stream disconnects (ChannelError, exactly what a hot-unplug
    produces).
  * ``SimConfig.chaos`` (driver/sim_device.py) — the emulated firmware
    applies the program to its outgoing wire frames, so the whole stack
    (native/py transport -> decoder resync -> assembler -> FSM) chews
    on the corruption, including mid-capsule severs.

Determinism contract: every decision about frame ``i`` comes from
``np.random.default_rng((seed, i))`` — independent of read chunking,
thread timing, or which consumer asks.  Two appliers built from the
same :class:`ChaosConfig` produce identical fault sequences.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional

import numpy as np

log = logging.getLogger("rplidar_tpu.chaos")

# fault kinds, in the order the schedule resolves them (first hit wins)
FAULT_STALL = "stall"
FAULT_DISCONNECT = "disconnect"
FAULT_DROP = "drop"
FAULT_TRUNCATE = "truncate"
FAULT_CORRUPT = "corrupt"
FAULT_DESYNC = "desync"
FAULT_PASS = "pass"


@dataclasses.dataclass(frozen=True)
class ChaosConfig:
    """One seeded fault program (all rates are per-frame probabilities).

    ``start_frame``/``stop_frame`` bound the active window in GLOBAL
    frame indices (stop 0 = never stops), so a schedule can model
    "clean warmup, then a sick cable, then recovery" in one config.
    """

    seed: int = 0
    start_frame: int = 0
    stop_frame: int = 0
    # byte corruption inside the payload (decoder checksum/CRC fodder)
    corrupt_rate: float = 0.0
    corrupt_bytes: int = 4
    # truncated reads: the frame arrives as a strict prefix (the length
    # filter both ingest backends share drops it identically)
    truncate_rate: float = 0.0
    # frames silently swallowed (radio fade / kernel buffer overrun)
    drop_rate: float = 0.0
    # periodic stalls: every ``stall_period`` frames, the next
    # ``stall_frames`` frames are swallowed (a wedged device window)
    stall_period: int = 0
    stall_frames: int = 0
    # absolute frame indices at which the link severs mid-capsule (the
    # transport raises ChannelError / the sim sends a torn frame then
    # unplugs); small repeated indices per session model reconnect storms
    disconnect_frames: tuple = ()
    # descriptor desync: garbage bytes injected AHEAD of the frame on
    # byte-stream transports (sim/transport level; at the frame-run
    # level this degrades to a malformed frame, same as truncate)
    desync_rate: float = 0.0
    desync_bytes: int = 16

    def __post_init__(self) -> None:
        for name in ("corrupt_rate", "truncate_rate", "drop_rate",
                     "desync_rate"):
            v = getattr(self, name)
            if not (0.0 <= v <= 1.0):
                raise ValueError(f"{name} must be within [0, 1], got {v}")
        if self.stall_period < 0 or self.stall_frames < 0:
            raise ValueError("stall_period/stall_frames must be >= 0")
        if self.stall_frames and self.stall_period <= self.stall_frames:
            raise ValueError(
                "stall_period must exceed stall_frames (the window must "
                "re-open between stalls)"
            )


class ChaosSchedule:
    """Stateless per-index fault resolver (the pure core both appliers
    and the sim share)."""

    def __init__(self, cfg: ChaosConfig) -> None:
        self.cfg = cfg
        self._disconnects = frozenset(int(i) for i in cfg.disconnect_frames)

    def active(self, index: int) -> bool:
        cfg = self.cfg
        return index >= cfg.start_frame and (
            cfg.stop_frame == 0 or index < cfg.stop_frame
        )

    def plan(self, index: int) -> str:
        """The fault kind for frame ``index`` — deterministic, chunking-
        independent, identical for every consumer."""
        cfg = self.cfg
        if index in self._disconnects:
            return FAULT_DISCONNECT
        if not self.active(index):
            return FAULT_PASS
        if cfg.stall_period > 0 and cfg.stall_frames > 0:
            if index % cfg.stall_period < cfg.stall_frames:
                return FAULT_STALL
        u = np.random.default_rng((cfg.seed, index)).random(4)
        if u[0] < cfg.drop_rate:
            return FAULT_DROP
        if u[1] < cfg.truncate_rate:
            return FAULT_TRUNCATE
        if u[2] < cfg.corrupt_rate:
            return FAULT_CORRUPT
        if u[3] < cfg.desync_rate:
            return FAULT_DESYNC
        return FAULT_PASS

    def mutate(self, index: int, payload: bytes) -> tuple[str, Optional[bytes]]:
        """Apply frame ``index``'s fault to ``payload``.  Returns
        ``(kind, bytes-or-None)``; None means the frame never arrives
        (drop/stall) or the link severed (disconnect — the CALLER owns
        what severing means for its transport).  A desync fault returns
        the payload with leading garbage; frame-run consumers should
        treat it like truncation (see :class:`ChaosStream`)."""
        kind = self.plan(index)
        if kind in (FAULT_STALL, FAULT_DROP, FAULT_DISCONNECT):
            return kind, None
        if kind == FAULT_PASS:
            return kind, payload
        rng = np.random.default_rng((self.cfg.seed, index, 1))
        if kind == FAULT_TRUNCATE:
            cut = int(rng.integers(1, max(len(payload), 2)))
            return kind, payload[:cut]
        if kind == FAULT_CORRUPT:
            buf = bytearray(payload)
            n = min(self.cfg.corrupt_bytes, len(buf))
            pos = rng.choice(len(buf), size=n, replace=False)
            for p in pos:
                buf[int(p)] ^= int(rng.integers(1, 256))
            return kind, bytes(buf)
        # FAULT_DESYNC: garbage ahead of the frame (byte-stream framing
        # damage; the decoder's resync machinery eats it)
        garbage = bytes(rng.integers(0, 256, self.cfg.desync_bytes,
                                     dtype=np.uint8))
        return kind, garbage + payload


class ChaosStream:
    """Stateful frame-run applier for tick-shaped consumers: carries the
    global frame index across runs and tallies what it did.

    Desync faults degrade to oversized frames here (the run consumers'
    shared length filter drops them, exactly like a host decoder would
    eventually resync past the garbage) — the byte-level form lives in
    the transport/sim injectors.
    """

    def __init__(self, cfg: ChaosConfig) -> None:
        self.schedule = ChaosSchedule(cfg)
        self.index = 0
        self.faults: dict[str, int] = {}
        self.severed = False

    def _tally(self, kind: str) -> None:
        self.faults[kind] = self.faults.get(kind, 0) + 1

    def apply_frame(self, payload: bytes) -> tuple[str, Optional[bytes]]:
        """One frame through the program: advances the global index,
        tallies, latches ``severed`` on a disconnect fault.  Returns
        ``(kind, bytes-or-None)`` — None means the frame never reaches
        the consumer."""
        i = self.index
        self.index += 1
        if self.severed:
            self._tally("severed")
            return "severed", None
        kind, mutated = self.schedule.mutate(i, payload)
        self._tally(kind)
        if kind == FAULT_DISCONNECT:
            self.severed = True
            return kind, None
        return kind, mutated

    def apply_run(self, frames: list) -> list:
        """Map one ``[(payload, rx_ts), ...]`` run through the program.
        Dropped/stalled frames vanish; after a disconnect fault the
        stream goes silent until :meth:`replug`."""
        out = []
        for payload, ts in frames:
            _kind, mutated = self.apply_frame(payload)
            if mutated is not None:
                out.append((mutated, ts))
        return out

    def replug(self) -> None:
        self.severed = False


class ChaosTransport:
    """``TransceiverLike`` wrapper applying the fault program to the live
    rx plane (protocol/engine.py's pump reads through this unchanged).

    Only loop-mode measurement messages are faulted — the request/answer
    plane passes clean, so chaos degrades the STREAM (the thing the
    health FSM supervises) without just breaking connect.  A disconnect
    fault raises ``ChannelError`` out of ``wait_message``, which is
    byte-for-byte the failure the pump sees on a real hot-unplug.
    """

    def __init__(self, inner, cfg: ChaosConfig) -> None:
        self._tx = inner
        self.chaos = ChaosStream(cfg)

    # -- lifecycle / passthrough ----------------------------------------

    def start(self) -> bool:
        return self._tx.start()

    def stop(self) -> None:
        self._tx.stop()

    def send(self, packet: bytes) -> bool:
        return self._tx.send(packet)

    def reset_decoder(self) -> None:
        self._tx.reset_decoder()

    @property
    def had_error(self) -> bool:
        return self.chaos.severed or self._tx.had_error

    @property
    def channel(self):
        return getattr(self._tx, "channel", None)

    @property
    def rx_priority(self) -> int:
        return int(getattr(self._tx, "rx_priority", -1))

    # -- faulted rx plane ------------------------------------------------

    def _filter(self, m):
        """Apply the program to one received message tuple (either the
        3-tuple wait_message shape or the 4-tuple stamped shape)."""
        from rplidar_ros2_driver_tpu_torch.native.runtime import ChannelError
        from rplidar_ros2_driver_tpu_torch.protocol.constants import SCAN_ANS_TYPES

        if m is None:
            return None
        ans_type, data, is_loop = m[0], m[1], m[2]
        if not (is_loop or ans_type in SCAN_ANS_TYPES):
            return m  # request plane: clean
        if self.chaos.severed:
            raise ChannelError("chaos: link severed")
        got = self.chaos.apply_run([(data, 0.0)])
        if self.chaos.severed:
            raise ChannelError("chaos: mid-capsule disconnect")
        if not got:
            return None  # dropped/stalled: reads as an idle timeout
        return (ans_type, got[0][0], is_loop, *m[3:])

    def wait_message(self, timeout_ms: int = 1000):
        return self._filter(self._tx.wait_message(timeout_ms=timeout_ms))

    def __getattr__(self, name):
        # keep optional extras (wait_message_ts, ...) visible only when
        # the wrapped transport has them, with the fault filter applied
        # to the stamped receive path
        if name == "wait_message_ts":
            inner = getattr(self._tx, "wait_message_ts")

            def wait_message_ts(timeout_ms: int = 1000):
                return self._filter(inner(timeout_ms=timeout_ms))

            return wait_message_ts
        return getattr(self._tx, name)


@dataclasses.dataclass(frozen=True)
class ShardChaosConfig:
    """One seeded SHARD-loss fault program — the chaos plane of the
    elastic fleet (parallel/service.ElasticFleetService).  Where
    :class:`ChaosConfig` damages a stream's bytes, this kills whole
    shards: every hosted stream's engine state vanishes at once (a chip
    falling out of the pod), and the pod must evacuate the victims onto
    surviving shards' idle lanes from their last per-stream snapshots.

    Same one-schedule discipline as the frame program: whether shard
    ``s`` is down at tick ``t`` is a pure function of ``(seed, s, t)``,
    so a kill->evacuate->re-admit cycle replays identically in tests,
    the bench, and the host-golden replay harness.

    ``kills`` holds explicit ``(shard, start_tick, stop_tick)`` outages
    (stop 0 = never recovers); ``kill_rate``/``outage_ticks`` add
    seeded random outages on top (an outage of ``outage_ticks`` ticks
    begins at tick ``t0`` iff the per-index draw fires there).
    """

    seed: int = 0
    kills: tuple = ()
    kill_rate: float = 0.0
    outage_ticks: int = 0

    def __post_init__(self) -> None:
        if not (0.0 <= self.kill_rate <= 1.0):
            raise ValueError(
                f"kill_rate must be within [0, 1], got {self.kill_rate}"
            )
        if self.kill_rate > 0.0 and self.outage_ticks < 1:
            raise ValueError(
                "kill_rate needs outage_ticks >= 1 (a zero-length outage "
                "kills nothing)"
            )
        for k in self.kills:
            if len(k) != 3:
                raise ValueError(
                    "kills entries are (shard, start_tick, stop_tick) "
                    f"triples, got {k!r}"
                )
            shard, start, stop = k
            if shard < 0 or start < 0 or stop < 0:
                raise ValueError(f"kills entry {k!r} has negative fields")
            if stop and stop <= start:
                raise ValueError(
                    f"kills entry {k!r}: stop_tick must exceed start_tick "
                    "(0 = never recovers)"
                )


class ShardChaosSchedule:
    """Stateless per-(shard, tick) outage resolver — the pure core the
    pod service, the failover bench and the replay harness all share."""

    def __init__(self, cfg: ShardChaosConfig) -> None:
        self.cfg = cfg

    def down(self, shard: int, tick: int) -> bool:
        """Whether ``shard`` is dead at ``tick`` — deterministic,
        identical for every consumer (the shard-level analog of
        :meth:`ChaosSchedule.plan`)."""
        cfg = self.cfg
        for s, start, stop in cfg.kills:
            if s == shard and start <= tick and (stop == 0 or tick < stop):
                return True
        if cfg.kill_rate > 0.0:
            lo = max(0, tick - cfg.outage_ticks + 1)
            for t0 in range(lo, tick + 1):
                u = np.random.default_rng(
                    (cfg.seed, shard, t0)
                ).random()
                if u < cfg.kill_rate:
                    return True
        return False

    def down_shards(self, tick: int, shards: int) -> frozenset:
        return frozenset(
            s for s in range(shards) if self.down(s, tick)
        )


def chaos_ticks(ticks: list, stream_cfgs: dict) -> list:
    """Apply per-stream fault programs to a whole fleet tick list (the
    ``submit_bytes`` layout: ``ticks[t][i] = (ans, [(payload, ts), ...])``
    or None).  ``stream_cfgs`` maps stream index -> :class:`ChaosConfig`.
    Returns a NEW tick list; the input is untouched.  Because the
    program is deterministic, feeding the returned ticks to the host
    and fused backends hands both the identical corrupted stream."""
    streams = {i: ChaosStream(cfg) for i, cfg in stream_cfgs.items()}
    out = []
    for tick in ticks:
        row = []
        for i, item in enumerate(tick):
            cs = streams.get(i)
            if item is None or cs is None:
                row.append(item)
                continue
            ans, frames = item
            got = cs.apply_run(list(frames))
            row.append((ans, got) if got else None)
        out.append(row)
    return out

"""Command/response engine over an async transceiver (a copy of the JAX
package's ``protocol/engine.py``).

Equivalent of the reference driver's send paths
(`_sendCommandWithoutResponse` sl_lidar_driver.cpp:1600-1610,
`_sendCommandWithResponse` :1612-1641) and its listener routing
(:1655-1672): measurement (loop-mode) messages flow to the scan handler;
anything else completes the pending request if the answer type matches.

The reference parks the requester on a ``Waiter`` signalled from the decoder
thread; here a pump thread drains the transceiver's message queue and hands
responses over a one-slot queue.  One operation lock serializes requests
(the recursive op-lock of sl_lidar_driver.cpp:401).
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Callable, Optional, Protocol

from rplidar_ros2_driver_tpu_torch.protocol.codec import encode_command
from rplidar_ros2_driver_tpu_torch.protocol.constants import SCAN_ANS_TYPES

log = logging.getLogger("rplidar_tpu.engine")


class TransceiverLike(Protocol):
    """Duck-typed transceiver contract (NativeTransceiver or a test fake)."""

    def start(self) -> bool: ...
    def stop(self) -> None: ...
    def send(self, packet: bytes) -> bool: ...
    def wait_message(self, timeout_ms: int = 1000) -> Optional[tuple[int, bytes, bool]]: ...
    def reset_decoder(self) -> None: ...
    @property
    def had_error(self) -> bool: ...


# measurement callbacks: per-payload (ans_type, payload) or batched
# (ans_type, [(payload, rx_monotonic_ts), ...]) — the batched form is the
# production decode path: the pump drains every already-decoded message in
# one go so the vectorized unpackers see whole frame runs (natural batching,
# zero added latency — nothing ever *waits* for a batch to fill).
MeasurementHandler = Callable[[int, bytes], None]
MeasurementBatchHandler = Callable[[int, list], None]

# Upper bound on one delivered measurement run: bounds decode-batch memory
# and keeps request/response answers flowing between runs under sustained
# streaming.
_MAX_MEASUREMENT_BATCH = 64


class CommandEngine:
    def __init__(
        self,
        transceiver: TransceiverLike,
        on_measurement: Optional[MeasurementHandler] = None,
        on_measurement_batch: Optional[MeasurementBatchHandler] = None,
    ) -> None:
        self._tx = transceiver
        self._on_measurement = on_measurement
        self._on_measurement_batch = on_measurement_batch
        self._op_lock = threading.RLock()
        self._pending_lock = threading.Lock()
        self._pending_ans: Optional[int] = None
        self._pending_q: Optional[queue.Queue] = None
        # answers still owed by timed-out requests, per ans type: a late
        # answer must not complete the NEXT request of the same type (the
        # conf protocol reuses one ans type for every per-mode query, and
        # the echoed key alone cannot distinguish modes).  Maps ans_type ->
        # monotonic expiry; an answer arriving before expiry is dropped
        # once, after expiry flows normally (so a device that stays silent
        # can only cost one extra timeout, never a permanent drop loop).
        self._stale: dict[int, float] = {}
        self._pump: Optional[threading.Thread] = None
        self._running = threading.Event()
        self.link_error = threading.Event()

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> bool:
        if not self._tx.start():
            return False
        self.link_error.clear()
        self._running.set()
        self._pump = threading.Thread(target=self._pump_loop, name="rpl_pump", daemon=True)
        self._pump.start()
        return True

    def stop(self) -> None:
        self._running.clear()
        self._tx.stop()  # unblocks wait_message via channel close
        if self._pump:
            self._pump.join(5.0)
            self._pump = None

    @property
    def healthy(self) -> bool:
        return self._running.is_set() and not self.link_error.is_set()

    @property
    def rx_priority(self) -> int:
        """Scheduling class the rx thread achieved, when the transceiver
        reports it (native: 2 = SCHED_RR, 1 = nice boost, 0 = default);
        -1 for transports without elevation (pure-Python fallback)."""
        return int(getattr(self._tx, "rx_priority", -1))

    @property
    def channel(self):
        """Underlying byte channel, when the transceiver exposes one (the
        raw-access escape hatch for DTR motor control and autobaud)."""
        return getattr(self._tx, "channel", None)

    # -- request API --------------------------------------------------------

    def send_only(self, cmd: int, payload: bytes = b"") -> bool:
        """Fire-and-forget (ref :1600-1610)."""
        with self._op_lock:
            return self._tx.send(encode_command(cmd, payload))

    def request(
        self, cmd: int, ans_type: int, payload: bytes = b"", timeout_s: float = 1.0
    ) -> Optional[bytes]:
        """Send and block for the matching answer; None on timeout/error."""
        with self._op_lock:
            slot: queue.Queue = queue.Queue(maxsize=1)
            with self._pending_lock:
                self._pending_ans = ans_type
                self._pending_q = slot
            try:
                if not self._tx.send(encode_command(cmd, payload)):
                    return None
                try:
                    return slot.get(timeout=timeout_s)
                except queue.Empty:
                    log.debug("request %#x timed out waiting for ans %#x", cmd, ans_type)
                    with self._pending_lock:
                        # the device may still answer later: discard one
                        # message of this type if it lands within another
                        # timeout window
                        self._stale[ans_type] = time.monotonic() + timeout_s
                    return None
            finally:
                with self._pending_lock:
                    self._pending_ans = None
                    self._pending_q = None

    def reset_decoder(self) -> None:
        self._tx.reset_decoder()

    # -- pump ---------------------------------------------------------------

    def _pump_loop(self) -> None:
        from rplidar_ros2_driver_tpu_torch.native.runtime import ChannelError

        # prefer the rx-thread-stamped receive API: frame arrival times then
        # come from the native rx thread (CLOCK_MONOTONIC), immune to the
        # drain latency of this pump — a run of frames popped back-to-back
        # keeps its true inter-frame spacing for timestamp back-dating
        wait_ts = getattr(self._tx, "wait_message_ts", None)

        def recv(timeout_ms: int):
            if wait_ts is not None:
                return wait_ts(timeout_ms=timeout_ms)
            m = self._tx.wait_message(timeout_ms=timeout_ms)
            return None if m is None else (*m, time.monotonic())

        batch_type: Optional[int] = None
        batch: list = []  # [(payload, rx_ts)] of consecutive same-type frames

        def flush() -> None:
            nonlocal batch_type, batch
            if not batch:
                return
            try:
                if self._on_measurement_batch is not None:
                    self._on_measurement_batch(batch_type, batch)
                elif self._on_measurement is not None:
                    for data, _ts in batch:
                        self._on_measurement(batch_type, data)
            except Exception:
                log.exception("measurement handler failed")
            batch_type = None
            batch = []

        while self._running.is_set():
            # first message: block; then drain whatever else is already
            # decoded (timeout 0) so sustained streams deliver in runs
            timeout_ms = 200
            while True:
                try:
                    m = recv(timeout_ms)
                except ChannelError:
                    flush()
                    if self._running.is_set():
                        log.warning("channel error detected by pump (hot-unplug?)")
                        self.link_error.set()
                    return
                if m is None:
                    break  # queue drained (or idle timeout): deliver the run
                timeout_ms = 0
                ans_type, data, is_loop, rx_ts = m
                if is_loop or ans_type in SCAN_ANS_TYPES:
                    if ans_type != batch_type:
                        flush()
                        batch_type = ans_type
                    batch.append((data, rx_ts))
                    if len(batch) >= _MAX_MEASUREMENT_BATCH:
                        flush()
                    continue
                self._route_response(ans_type, data)
            flush()

    def _route_response(self, ans_type: int, data: bytes) -> None:
        with self._pending_lock:
            stale_until = self._stale.pop(ans_type, None)
            # the deadline itself is INSIDE the stale window (<=, not <):
            # an answer landing exactly at the expiry instant still
            # belongs to the timed-out request — delivering it would
            # hand request N-1's answer to request N (the conf protocol
            # reuses one ans type across per-mode queries, so a
            # boundary-delivered answer is silently WRONG data, not
            # just late data)
            if stale_until is not None and time.monotonic() <= stale_until:
                log.debug("dropping stale ans %#x (%d bytes)", ans_type, len(data))
            elif self._pending_ans == ans_type and self._pending_q is not None:
                try:
                    self._pending_q.put_nowait(data)
                except queue.Full:
                    pass
            else:
                log.debug("dropping unexpected ans %#x (%d bytes)", ans_type, len(data))

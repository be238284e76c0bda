"""The 5-state fault-tolerant scan loop FSM.

Behavioral mirror of the reference's ``scan_loop``
(src/rplidar_node.cpp:304-484):

    CONNECTING -> CHECK_HEALTH -> WARMUP -> RUNNING
         ^------------- RESETTING <-- (errors) --'

  * CONNECTING   — (re)create driver (dummy vs real factory), retry connect
    every 1 s, detect model strategy, cache device-info string
  * CHECK_HEALTH — gate on health (OK/WARNING pass; ERROR -> disconnect,
    1 s, back to CONNECTING)
  * WARMUP       — start motor + scan mode; failure -> RESETTING
  * RUNNING      — grab + publish; consecutive failures > max_retries ->
    RESETTING (1 ms between retries)
  * RESETTING    — destroy and recreate the driver object, 2 s backoff

Timings are injected (FsmTimings) so tests run the same logic at speed;
defaults match the reference constants (:336,:438,:468,:479).
"""

from __future__ import annotations

import dataclasses
import enum
import logging
import threading
import time
from typing import Callable, Optional

from rplidar_ros2_driver_tpu_torch.core.results import DeviceHealth
from rplidar_ros2_driver_tpu_torch.driver.interface import LidarDriverInterface

log = logging.getLogger("rplidar_tpu.fsm")


class DriverState(enum.Enum):
    CONNECTING = "connecting"
    CHECK_HEALTH = "check_health"
    WARMUP = "warmup"
    RUNNING = "running"
    RESETTING = "resetting"


@dataclasses.dataclass
class FsmTimings:
    connect_retry_s: float = 1.0
    health_retry_s: float = 1.0
    reset_backoff_s: float = 2.0
    idle_tick_s: float = 0.01
    grab_retry_s: float = 0.001
    grab_timeout_s: float = 2.0
    warmup_motor_s: float = 0.0  # motor warm-up handled inside drivers
    # ceiling of the CONNECTING retry backoff: the flat 1 s retry is the
    # FIRST delay (connect_retry_s = the base), then capped exponential
    # growth via driver/health.BackoffPolicy — a dead port costs
    # seconds-apart probes, not a tight 1 Hz reconnect storm forever
    connect_backoff_max_s: float = 10.0

    @classmethod
    def fast(cls) -> "FsmTimings":
        """Millisecond-scale variant for tests."""
        return cls(0.01, 0.01, 0.02, 0.001, 0.0005, 0.25,
                   connect_backoff_max_s=0.08)


class ScanLoopFsm:
    """Runs the fault-tolerant acquisition loop on a dedicated thread.

    The node supplies the driver factory, the scan consumer callback and
    (optionally) a state-change hook for diagnostics.  The driver mutex
    serializes grabs against dynamic reconfigure, exactly like the
    reference's ``driver_mutex_`` (include/rplidar_node.hpp:322) — and we
    hold it in CONNECTING/WARMUP too, closing the reference's documented
    race (SURVEY.md §5 race notes).
    """

    def __init__(
        self,
        driver_factory: Callable[[], LidarDriverInterface],
        on_scan: Callable[[dict, float, float], None],
        *,
        params,
        timings: Optional[FsmTimings] = None,
        on_state_change: Optional[Callable[[DriverState], None]] = None,
        on_connected: Optional[Callable[[LidarDriverInterface], None]] = None,
        on_filtered: Optional[Callable] = None,
    ) -> None:
        self._factory = driver_factory
        self._on_scan = on_scan
        # fused-ingest consumer (ingest_backend="fused"): called once per
        # completed revolution with (FilterOutput, ts0, duration) — the
        # revolution was decoded, assembled AND filtered on-device, so
        # there is no host scan dict to hand to on_scan
        self._on_filtered = on_filtered
        self._params = params
        self._t = timings or FsmTimings()
        self._on_state_change = on_state_change
        self._on_connected = on_connected

        self.driver: Optional[LidarDriverInterface] = None
        self.driver_mutex = threading.RLock()
        self._state = DriverState.CONNECTING
        self._state_lock = threading.Lock()
        self._running = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.cached_device_info = ""
        self.cached_max_range = 0.0
        self.error_count = 0
        self.reset_count = 0
        # CONNECTING retry discipline: capped exponential backoff
        # (driver/health.BackoffPolicy) instead of the reference's flat
        # 1 s loop, with the attempt count surfaced in /diagnostics
        from rplidar_ros2_driver_tpu_torch.driver.health import BackoffPolicy

        self._connect_backoff = BackoffPolicy(
            self._t.connect_retry_s,
            max(self._t.connect_backoff_max_s, self._t.connect_retry_s),
            jitter=0.1,
        )
        # cumulative connect attempts this session (successes included —
        # the driver-level connect_failures counter carries the failures,
        # so the two diagnostics values read consistently)
        self.connect_attempts = 0

    # -- state accessors ----------------------------------------------------

    @property
    def state(self) -> DriverState:
        with self._state_lock:
            return self._state

    def _set_state(self, s: DriverState) -> None:
        with self._state_lock:
            if s is self._state:
                return
            self._state = s
        log.info("[FSM] -> %s", s.value)
        if self._on_state_change:
            self._on_state_change(s)

    @property
    def is_scanning(self) -> bool:
        return self._running.is_set()

    @property
    def reconnect_backoff_s(self) -> float:
        """The CONNECTING retry delay most recently slept (0 when the
        last connect succeeded) — /diagnostics observability."""
        return self._connect_backoff.last_delay_s

    # -- thread lifecycle ---------------------------------------------------

    def start(self) -> None:
        if self._thread and self._thread.is_alive():
            return
        self._running.set()
        self._thread = threading.Thread(target=self._loop, name="scan_loop", daemon=True)
        self._thread.start()

    def stop(self, join_timeout_s: float = 5.0) -> None:
        self._running.clear()
        if self._thread:
            self._thread.join(join_timeout_s)
            self._thread = None
        with self.driver_mutex:
            if self.driver is not None:
                try:
                    self.driver.stop_motor()
                    self.driver.disconnect()
                except Exception:
                    log.exception("driver shutdown failed")

    # -- the loop -----------------------------------------------------------

    def _interruptible_sleep(self, seconds: float) -> None:
        deadline = time.monotonic() + seconds
        while self._running.is_set():
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return
            time.sleep(min(remaining, 0.05))

    def _loop(self) -> None:
        self._set_state(DriverState.CONNECTING)
        self.error_count = 0
        log.info("[FSM] Scan loop started.")
        while self._running.is_set():
            state = self.state
            try:
                if state is DriverState.CONNECTING:
                    self._do_connecting()
                elif state is DriverState.CHECK_HEALTH:
                    self._do_check_health()
                elif state is DriverState.WARMUP:
                    self._do_warmup()
                elif state is DriverState.RUNNING:
                    self._do_running()
                elif state is DriverState.RESETTING:
                    self._do_resetting()
            except Exception:
                # A raising driver (or factory) must never kill the loop —
                # that would defeat the whole recovery design.  Treat it as a
                # hardware fault and go through RESETTING like any other.
                log.exception("[FSM] Unhandled error in state %s; resetting", state.value)
                if state is DriverState.RESETTING:
                    # factory itself is failing: back off before retrying
                    self._interruptible_sleep(self._t.reset_backoff_s)
                self._set_state(DriverState.RESETTING)
            if self.state is not DriverState.RUNNING:
                self._interruptible_sleep(self._t.idle_tick_s)
        log.info("[FSM] Scan loop terminated.")

    def _do_connecting(self) -> None:
        with self.driver_mutex:
            if self.driver is None:
                self.driver = self._factory()
            if not self.driver.is_connected():
                self.connect_attempts += 1
                ok = self.driver.connect(
                    self._params.serial_port,
                    self._params.serial_baudrate,
                    self._params.angle_compensate,
                )
                if not ok:
                    delay = self._connect_backoff.next_delay()
                    log.warning(
                        "[FSM] Connection failed (attempt %d). Retrying "
                        "in %.2f s...", self.connect_attempts, delay,
                    )
                    self._interruptible_sleep(delay)
                    return
                self._connect_backoff.reset()
                log.info("[FSM] Connection established.")
            self.driver.detect_and_init_strategy()
            self.cached_device_info = self.driver.get_device_info_str()
            log.info("[Hardware Detail] %s", self.cached_device_info)
            if self._on_connected:
                self._on_connected(self.driver)
        self._set_state(DriverState.CHECK_HEALTH)

    def _do_check_health(self) -> None:
        with self.driver_mutex:
            health = self.driver.get_health()
        if health in (DeviceHealth.OK, DeviceHealth.WARNING):
            self._set_state(DriverState.WARMUP)
        else:
            log.error("[FSM] Health error: %d. Disconnecting...", int(health))
            with self.driver_mutex:
                self.driver.disconnect()
            self._interruptible_sleep(self._t.health_retry_s)
            self._set_state(DriverState.CONNECTING)

    def _do_warmup(self) -> None:
        log.info("[FSM] Starting motor...")
        with self.driver_mutex:
            ok = self.driver.start_motor(self._params.scan_mode, self._params.rpm)
            if ok:
                self.driver.print_summary()
                hw_limit = self.driver.get_hw_max_distance()
                if self._params.max_distance > 0.0:
                    self.cached_max_range = min(self._params.max_distance, hw_limit)
                else:
                    self.cached_max_range = hw_limit
        if ok:
            log.info("[Config] Max Range: %.2f m", self.cached_max_range)
            self.error_count = 0
            self._set_state(DriverState.RUNNING)
        else:
            log.error("[FSM] Failed to start motor.")
            self._set_state(DriverState.RESETTING)

    def _do_running(self) -> None:
        # on_filtered is only wired when the node resolved the fused
        # ingest seam (node.on_configure via resolve_ingest_backend) —
        # re-deriving the backend from the raw param string here would
        # diverge the moment "auto" resolves to fused
        if self._on_filtered is not None:
            self._do_running_fused()
            return
        start_time = time.monotonic()
        scan: Optional[dict] = None
        ts0 = duration = None
        with self.driver_mutex:
            if self.driver is not None and self.driver.is_connected():
                # host-native timestamped grab (back-dated revolution begin,
                # grabScanDataHqWithTimeStamp parity): raw numpy arrays, so
                # the consumer controls the one host->device transfer
                got = self.driver.grab_scan_host(self._t.grab_timeout_s)
                if got is not None:
                    scan, ts0, duration = got
        if scan is None:
            self.error_count += 1
            if self.error_count > self._params.max_retries:
                log.error(
                    "[FSM] Hardware unresponsive (Over %d errors). Resetting...",
                    self._params.max_retries,
                )
                self._set_state(DriverState.RESETTING)
            else:
                self._interruptible_sleep(self._t.grab_retry_s)
            return
        self.error_count = 0
        if ts0 is None or duration is None or duration <= 0:
            ts0 = start_time
            duration = time.monotonic() - start_time
        self._on_scan(scan, ts0, duration)

    def _do_running_fused(self) -> None:
        """RUNNING step for the fused ingest backend: one dispatched
        frame batch's completed revolutions per iteration, already
        filtered on-device.  A timeout (None) walks the same
        error-count -> RESETTING path as a failed host grab; an empty
        list (mid-revolution batch) is healthy progress."""
        outs = None
        with self.driver_mutex:
            if self.driver is not None and self.driver.is_connected():
                grab = getattr(self.driver, "grab_filtered", None)
                if grab is not None:
                    outs = grab(self._t.grab_timeout_s)
        if outs is None:
            self.error_count += 1
            if self.error_count > self._params.max_retries:
                log.error(
                    "[FSM] Hardware unresponsive (Over %d errors). Resetting...",
                    self._params.max_retries,
                )
                self._set_state(DriverState.RESETTING)
            else:
                self._interruptible_sleep(self._t.grab_retry_s)
            return
        self.error_count = 0
        for out, ts0, duration in outs:
            self._on_filtered(out, ts0, duration)

    def _do_resetting(self) -> None:
        log.warning("[FSM] Performing hardware reset (recreating driver)...")
        with self.driver_mutex:
            if self.driver is not None:
                try:
                    self.driver.disconnect()
                except Exception:
                    pass
            self.driver = self._factory()
        self.reset_count += 1
        self._interruptible_sleep(self._t.reset_backoff_s)
        self._set_state(DriverState.CONNECTING)
        self.error_count = 0

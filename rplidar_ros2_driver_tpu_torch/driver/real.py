"""RealLidarDriver — hardware backend over the native I/O runtime.

Equivalent of the reference's ``RealLidarDriver`` wrapper plus the driver
core it delegates to (src/lidar_driver_wrapper.cpp:97-405 over
sl_lidar_driver.cpp), re-composed for this framework — a copy of the JAX
package's ``driver/real.py`` on this package's modules:

  * transport: native C++ channel + transceiver (native/src/*.cc) selected
    by ``channel_type`` (serial/tcp/udp — the reference's channel factories,
    sl_lidar_driver.h:260-274)
  * request plane: CommandEngine (protocol/engine.py) + conf protocol
    (protocol/conf.py)
  * scan plane: measurement frames stream off the pump thread in natural
    runs into the vectorized batch decoder (driver/decode.BatchScanDecoder
    over ops/unpack.py on CPU tensors; ops/unpack_ref.py is the scalar
    golden oracle) and assemble into revolutions
    (driver/assembly.ScanAssembler, the ScanDataHolder equivalent)
  * strategy: model detection via models/tables.detect_profile; start_motor
    follows the reference's two strategies (src/lidar_driver_wrapper.cpp:
    193-268): NEW_TYPE = RPM control + mode enumeration with
    user-pref → DenseBoost → Sensitivity fallback + express scan;
    OLD_TYPE = 600 RPM default + startScan(0, 1)'s typical-mode path —
    conf-resolved typical mode when the firmware speaks the conf
    protocol, hardwired EXPRESS fallback when it predates it
    (sl_lidar_driver.cpp:577-580).  Every conf query is gated on
    checkSupportConfigCommands semantics (:1176-1196).
"""

from __future__ import annotations

import logging
import struct
import threading
import time
from typing import Callable, Optional

from rplidar_ros2_driver_tpu_torch.core.results import DeviceHealth
from rplidar_ros2_driver_tpu_torch.core.types import ScanBatch
from rplidar_ros2_driver_tpu_torch.driver.assembly import RawNodeHolder, ScanAssembler
from rplidar_ros2_driver_tpu_torch.driver.decode import BatchScanDecoder
from rplidar_ros2_driver_tpu_torch.driver.interface import LidarDriverInterface
from rplidar_ros2_driver_tpu_torch.models.tables import (
    A2A3_MINUM_MAJOR_ID,
    DeviceInfo,
    DriverProfile,
    MajorType,
    MotorCtrlSupport,
    ProtocolType,
    ScanMode,
    detect_profile,
    has_builtin_motor_ctrl,
    major_type,
    native_baudrate,
    supports_conf_commands,
)
from rplidar_ros2_driver_tpu_torch.protocol import conf as confproto
from rplidar_ros2_driver_tpu_torch.protocol.constants import (
    ACC_BOARD_FLAG_MOTOR_CTRL_SUPPORT_MASK,
    Ans,
    AUTOBAUD_CONFIRM_FLAG,
    AUTOBAUD_MAGICBYTE,
    Cmd,
    SCAN_COMMAND_EXPRESS,
    SCAN_COMMAND_STD,
)
from rplidar_ros2_driver_tpu_torch.protocol import timing as timingmod
from rplidar_ros2_driver_tpu_torch.protocol.engine import CommandEngine, TransceiverLike

log = logging.getLogger("rplidar_tpu.real")

DEFAULT_RPM = 600  # src/lidar_driver_wrapper.cpp:187,262
LEGACY_MAX_DISTANCE = 12.0
NEW_TYPE_MAX_DISTANCE = 40.0


def _default_transceiver_factory(
    channel_type: str, port: str, baudrate: int, host: str, net_port: int
) -> TransceiverLike:
    """Native C++ transport when the library builds/loads; otherwise the
    pure-Python twin (protocol/pytransport.py) with a one-time notice —
    same contracts, no SCHED_RR rx elevation."""
    if channel_type not in ("serial", "tcp", "udp"):
        raise ValueError(f"unsupported channel_type {channel_type!r}")

    def make_channel(channel_cls):
        # NativeChannel and PyChannel are deliberate duck-type twins
        if channel_type == "serial":
            return channel_cls("serial", port, baud=baudrate)
        return channel_cls(channel_type, host, port=net_port)

    try:
        from rplidar_ros2_driver_tpu_torch.native.runtime import NativeChannel, NativeTransceiver

        return NativeTransceiver(make_channel(NativeChannel))
    except Exception as e:
        from rplidar_ros2_driver_tpu_torch.native import NativeUnavailable

        if not isinstance(e, NativeUnavailable):
            raise
        log.warning("native I/O library unavailable (%s); using the "
                    "pure-Python transport fallback", e)
        from rplidar_ros2_driver_tpu_torch.protocol.pytransport import PyChannel, PyTransceiver

        return PyTransceiver(make_channel(PyChannel))


class RealLidarDriver(LidarDriverInterface):
    """Hardware driver: native transport + command engine + scan decode."""

    def __init__(
        self,
        channel_type: str = "serial",
        *,
        tcp_host: str = "192.168.0.7",
        tcp_port: int = 20108,
        udp_host: str = "192.168.11.2",
        udp_port: int = 8089,
        transceiver_factory: Optional[Callable[..., TransceiverLike]] = None,
        motor_warmup_s: float = 1.0,   # ref waits 1 s after setMotorSpeed (:197)
        legacy_warmup_s: float = 0.2,  # ref waits 200 ms on OLD_TYPE (:264)
        ingest_sink=None,
    ) -> None:
        self._channel_type = channel_type
        self._tcp = (tcp_host, tcp_port)
        self._udp = (udp_host, udp_port)
        self._tx_factory = transceiver_factory or _default_transceiver_factory
        self._motor_warmup_s = motor_warmup_s
        self._legacy_warmup_s = legacy_warmup_s

        self._engine: Optional[CommandEngine] = None
        self._assembler = ScanAssembler()
        self._raw_holder = RawNodeHolder()
        # the ingest seam: the measurement-frame consumer wired into the
        # engine pump.  Default: the host golden path (BatchScanDecoder
        # -> ScanAssembler -> grab_scan_host).  A fused sink
        # (driver/ingest.FusedIngest, ingest_backend="fused") implements
        # the same producer interface but runs decode + revolution
        # assembly + the filter step device-resident; revolutions are
        # then consumed via grab_filtered, not grab_scan_*.
        self._scan_decoder = ingest_sink or BatchScanDecoder(
            self._assembler, self._raw_holder
        )
        self._fused_ingest = ingest_sink
        self._lock = threading.RLock()
        self._connected = False
        self._scanning = False
        self._baudrate = 0
        self._angle_compensate = True
        self.device_info: Optional[DeviceInfo] = None
        self.profile = DriverProfile()
        self.scan_modes: list = []
        self.motor_ctrl = MotorCtrlSupport.NONE
        # conf-protocol gate (checkSupportConfigCommands): set on connect;
        # every GET/SET_LIDAR_CONF path checks it so a pre-conf device is
        # never sent a query it would silently time out on
        self.conf_supported = False
        # connect/reconnect observability (/diagnostics): how many
        # connect calls this driver object has made and how many failed.
        # The retry PACING lives in the scan-loop FSM's capped-backoff
        # policy (node/fsm.py); these counters survive only as long as
        # the driver object, so the FSM's cumulative count is the
        # session-level truth
        self.connect_attempts = 0
        self.connect_failures = 0

    # ------------------------------------------------------------------
    # connection
    # ------------------------------------------------------------------

    def connect(self, port: str, baudrate: int, use_geometric_compensation: bool) -> bool:
        with self._lock:
            if self._connected:
                return True
            self.connect_attempts += 1
            ok = self._connect_locked(port, baudrate, use_geometric_compensation)
            if not ok:
                self.connect_failures += 1
            return ok

    def _connect_locked(
        self, port: str, baudrate: int, use_geometric_compensation: bool
    ) -> bool:
        self._angle_compensate = use_geometric_compensation
        self._baudrate = baudrate
        try:
            tx = self._tx_factory(
                self._channel_type, port, baudrate, *self._net_target()
            )
        except Exception as e:
            log.error("channel creation failed: %s", e)
            return False
        engine = CommandEngine(
            tx, on_measurement_batch=self._scan_decoder.on_measurement_batch
        )
        if not engine.start():
            log.warning("could not open %s channel on %s", self._channel_type, port)
            return False
        # quiesce any previous streaming, then identify the device
        engine.send_only(Cmd.STOP)
        time.sleep(0.01)
        engine.reset_decoder()
        info_payload = engine.request(
            Cmd.GET_DEVICE_INFO, Ans.DEVINFO, timeout_s=1.0
        )
        if info_payload is None or len(info_payload) < 20:
            log.warning("device did not answer GET_DEVICE_INFO")
            engine.stop()
            return False
        self.device_info = DeviceInfo.from_payload(info_payload)
        self.conf_supported = supports_conf_commands(self.device_info)
        self._engine = engine
        self._connected = True
        self.motor_ctrl = self._check_motor_ctrl_support()
        log.info(
            "connected: %s (motor ctrl: %s)",
            self.device_info.summary(),
            self.motor_ctrl.value,
        )
        return True

    def _net_target(self) -> tuple[str, int]:
        return self._tcp if self._channel_type == "tcp" else self._udp

    def disconnect(self) -> None:
        with self._lock:
            if self._engine is not None:
                if self._scanning:
                    try:
                        self.stop_motor()
                    except Exception:
                        pass
                self._engine.stop()
                self._engine = None
            self._connected = False
            self._scanning = False
            self._scan_decoder.reset()
            self._assembler.reset()
            self._raw_holder.reset()

    def is_connected(self) -> bool:
        with self._lock:
            if self._engine is not None and not self._engine.healthy:
                return False  # hot-unplug detected by the pump thread
            return self._connected

    # ------------------------------------------------------------------
    # strategy detection (src/lidar_driver_wrapper.cpp:145-178)
    # ------------------------------------------------------------------

    def detect_and_init_strategy(self) -> None:
        with self._lock:
            if self.device_info is None:
                return
            self.profile = detect_profile(self.device_info, self._angle_compensate)

    # ------------------------------------------------------------------
    # motor + scan startup (src/lidar_driver_wrapper.cpp:180-268)
    # ------------------------------------------------------------------

    def start_motor(self, scan_mode: str, rpm: int) -> bool:
        with self._lock:
            if self._engine is None:
                return False
            if self.profile.protocol is ProtocolType.NEW_TYPE:
                return self._start_new_type(scan_mode, rpm)
            return self._start_old_type(rpm)

    def _start_new_type(self, scan_mode: str, rpm: int) -> bool:
        target_rpm = rpm if rpm > 0 else DEFAULT_RPM
        if not self.set_motor_speed(target_rpm):
            return False
        time.sleep(self._motor_warmup_s)
        if not self.conf_supported:
            # cannot happen for a genuine NEW_TYPE unit (ND magic implies
            # conf support) — but if a device misreports, degrade the way
            # a pre-conf triangle would rather than fire doomed queries
            log.warning("device reports no conf support; using the legacy "
                        "Express fallback")
            return self._start_legacy_express(target_rpm)
        self.scan_modes = confproto.enumerate_scan_modes(self._engine)
        mode = self._select_mode(scan_mode)
        if mode is None:
            log.error("no usable scan mode enumerated")
            return False
        return self._start_express(mode, target_rpm)

    def _select_mode(self, preferred: str):
        """user pref -> 'DenseBoost' -> 'Sensitivity' -> typical/first
        (src/lidar_driver_wrapper.cpp:207-245)."""
        if not self.scan_modes:
            return None
        by_name = {m.name: m for m in self.scan_modes}
        if preferred and preferred in by_name:
            return by_name[preferred]
        if preferred:
            log.warning("scan mode %r not supported; falling back to auto", preferred)
        for fallback in ("DenseBoost", "Sensitivity"):
            if fallback in by_name:
                return by_name[fallback]
        typical = confproto.get_typical_mode(self._engine)
        if typical is not None:
            for m in self.scan_modes:
                if m.id == typical:
                    return m
        return self.scan_modes[0]

    def _start_express(
        self, mode, target_rpm: int, *, wire_mode: Optional[int] = None,
        update_hw_max: bool = True,
    ) -> bool:
        # EXPRESS_SCAN payload: u8 mode, u16 flags, u16 reserved
        # (startScanExpress, sl_lidar_driver.cpp:745-758).  working_flags
        # stays 0 like the reference wrapper's startScanExpress(false, id, 0)
        # call (src/lidar_driver_wrapper.cpp:249): the mode id alone selects
        # boost variants; setting EXPRESS_FLAG_BOOST here could make real
        # firmware stream a format that mismatches the enumerated ans_type.
        # ``wire_mode`` overrides the payload mode byte — pre-conf firmware
        # expects 0 there (startScanExpress :748-750) while the metadata
        # mode id stays SCAN_COMMAND_EXPRESS.
        self._update_timing_desc(mode.us_per_sample)
        # warm the decoder (or, with a fused sink, build the card's kernels
        # and warm its step) for this mode's wire format before the stream
        # starts, so the pump thread never stalls on it
        self._scan_decoder.precompile(mode.ans_type)
        self._begin_streaming()
        payload = struct.pack(
            "<BHH", mode.id if wire_mode is None else wire_mode, 0, 0
        )
        if not self._engine.send_only(Cmd.EXPRESS_SCAN, payload):
            return False
        # graftlint: disable=GL012 — helper reached only from start_motor/
        # _start_old_type, whose public entries hold self._lock (RLock)
        self._scanning = True
        self.profile.active_mode = mode.name
        self.profile.active_rpm = target_rpm
        if update_hw_max:
            self.profile.hw_max_distance = mode.max_distance or NEW_TYPE_MAX_DISTANCE
        return True

    def force_scan(self, rpm: int = 0) -> bool:
        """FORCE_SCAN (cmd 0x21): start streaming regardless of the
        device-side health gate (startScan(force=true),
        sl_lidar_driver.cpp:586-616).  Legacy wire format."""
        with self._lock:
            if self._engine is None:
                return False
            target_rpm = rpm if rpm > 0 else DEFAULT_RPM
            self.set_motor_speed(target_rpm)
            time.sleep(self._legacy_warmup_s)
            self._update_timing_desc(self._legacy_sample_durations()[0])
            self._scan_decoder.precompile(Ans.MEASUREMENT)
            self._begin_streaming()
            if not self._engine.send_only(Cmd.FORCE_SCAN):
                return False
            self._scanning = True
            self.profile.active_mode = "Standard (forced)"
            self.profile.active_rpm = target_rpm
            return True

    def _start_old_type(self, rpm: int) -> bool:
        # legacy strategy: fixed 600 RPM, brief spin-up, then the
        # reference wrapper's startScan(0, 1) — useTypicalScan
        # (src/lidar_driver_wrapper.cpp:262-268 -> sl_lidar_driver.cpp:
        # 586-616): the typical mode comes from the conf protocol when the
        # firmware speaks it, and is hardwired to the EXPRESS scan command
        # on pre-conf triangle units (getTypicalScanMode :577-580) — those
        # must never be sent a conf query at all.
        self.set_motor_speed(DEFAULT_RPM)
        time.sleep(self._legacy_warmup_s)
        if not self.conf_supported:
            return self._start_legacy_express(DEFAULT_RPM)
        typical = confproto.get_typical_mode(self._engine)
        if typical is not None and typical != SCAN_COMMAND_STD:
            mode = confproto.get_mode_metadata(self._engine, typical)
            if mode is not None and mode.ans_type != Ans.MEASUREMENT:
                return self._start_express(mode, DEFAULT_RPM, update_hw_max=False)
        # typical resolved to Standard (or its metadata didn't): plain scan
        # (startScanNormal_commonpath redirect, sl_lidar_driver.cpp:732-735)
        return self._start_standard_scan()

    def _start_standard_scan(self) -> bool:
        """Plain SCAN startup with device-queried sample duration
        (startScanNormal_commonpath, sl_lidar_driver.cpp:620-661)."""
        std_us, _ = self._legacy_sample_durations()
        self._update_timing_desc(std_us)
        self._scan_decoder.precompile(Ans.MEASUREMENT)
        self._begin_streaming()
        if not self._engine.send_only(Cmd.SCAN):
            return False
        # graftlint: disable=GL012 — helper reached only from start_motor/
        # _start_old_type, whose public entries hold self._lock (RLock)
        self._scanning = True
        self.profile.active_mode = "Standard"
        self.profile.active_rpm = DEFAULT_RPM
        return True

    def _start_legacy_express(self, target_rpm: int) -> bool:
        """Express startup for pre-conf firmware (startScanExpress legacy
        branch, sl_lidar_driver.cpp:716-729): no conf queries — metadata is
        fixed to the GET_SAMPLERATE express duration, 16 m, the capsule
        stream format, name "Express" — and the EXPRESS_SCAN payload's
        working_mode byte stays 0 (:748-750).  hw_max_distance keeps the
        wrapper's 12 m A-series profile value (the 16 m here is SDK mode
        metadata, not the wrapper profile)."""
        _, express_us = self._legacy_sample_durations()
        mode = ScanMode(
            id=SCAN_COMMAND_EXPRESS,
            us_per_sample=express_us,
            max_distance=16.0,
            ans_type=Ans.MEASUREMENT_CAPSULED,
            name="Express",
        )
        return self._start_express(
            mode, target_rpm, wire_mode=0, update_hw_max=False
        )


    def _update_timing_desc(self, us_per_sample: Optional[float]) -> None:
        """Push link+mode timing into the decoder for timestamp back-dating
        (_updateTimingDesc -> unpacker context, sl_lidar_driver.cpp:1538-1554):
        the device model's NATIVE baud (sl_lidar_driver.cpp:1540) drives the
        transmission-delay model, falling back to the link baud, then to the
        per-format defaults; linkage delay is 0 like the reference (:1547)."""
        native = 0
        if self.device_info is not None:
            native = native_baudrate(
                self.device_info.model, self.device_info.hardware_version
            )
        self._scan_decoder.timing = timingmod.TimingDesc(
            sample_duration_us=us_per_sample or timingmod.LEGACY_SAMPLE_DURATION_US,
            native_baudrate=native or self._baudrate,
            is_serial=self._channel_type == "serial",
        )

    def _legacy_sample_durations(self) -> tuple[float, float]:
        """(std, express) sample durations for legacy (non-conf) scan
        startup, queried from the device via GET_SAMPLERATE (cmd 0x59 ->
        ans 0x15, two u16 LE: std/express µs) — _getLegacySampleDuration_uS,
        sl_lidar_driver.cpp:1556-1599.  Very old A-series firmware
        (< 1.17) predates the command and always gets the 476 µs default
        for both (:1559-1567)."""
        default = timingmod.LEGACY_SAMPLE_DURATION_US
        if self.device_info is not None:
            is_a_series = major_type(self.device_info.model) is MajorType.A_SERIES
            if is_a_series and self.device_info.firmware_version < ((0x1 << 8) | 17):
                return default, default
        ans = self._engine.request(
            Cmd.GET_SAMPLERATE, Ans.SAMPLE_RATE, timeout_s=1.0
        )
        if ans is None or len(ans) < 4:
            return default, default
        std_us, express_us = struct.unpack_from("<HH", ans)
        return float(std_us) or default, float(express_us) or default

    def _begin_streaming(self) -> None:
        self._engine.send_only(Cmd.STOP)
        time.sleep(0.002)
        self._engine.reset_decoder()
        # the decoder first: its reset waits for a run in flight on the
        # pump, whose pushes would otherwise land in the sinks reset here
        self._scan_decoder.reset()
        self._assembler.reset()
        self._raw_holder.reset()

    def stop_motor(self) -> None:
        with self._lock:
            if self._engine is None:
                return
            self._engine.send_only(Cmd.STOP)
            self._scanning = False
            self._engine.reset_decoder()
            # speed 0 stops every motor variant: RPM/PWM command 0, or DTR
            # raised on DTR-driven A-series units
            self.set_motor_speed(0)

    def _check_motor_ctrl_support(self) -> MotorCtrlSupport:
        """3-way capability probe (checkMotorCtrlSupport,
        sl_lidar_driver.cpp:833-878): built-in RPM control for major id
        >= 6; A2/A3-class units ask the accessory board (cmd 0xFF, u32
        reserved payload) and get PWM if bit 0 of the answer is set;
        everything else is DTR-toggled."""
        if self.device_info is None:
            return MotorCtrlSupport.NONE
        if has_builtin_motor_ctrl(self.device_info.model):
            return MotorCtrlSupport.RPM
        major = self.device_info.model >> 4
        if major >= A2A3_MINUM_MAJOR_ID:
            ans = self._engine.request(
                Cmd.GET_ACC_BOARD_FLAG,
                Ans.ACC_BOARD_FLAG,
                struct.pack("<I", 0),
                timeout_s=0.5,
            )
            if ans is not None and len(ans) >= 4:
                flag = struct.unpack_from("<I", ans)[0]
                if flag & ACC_BOARD_FLAG_MOTOR_CTRL_SUPPORT_MASK:
                    return MotorCtrlSupport.PWM
        return MotorCtrlSupport.NONE

    def set_motor_speed(self, rpm: Optional[int] = None) -> bool:
        """3-way motor control (setMotorSpeed, sl_lidar_driver.cpp:968-1021):
        RPM via cmd 0xA8, accessory-board PWM via 0xF0, otherwise the serial
        DTR line (clear = run, set = stop).  ``rpm=None`` asks the device for
        its desired speed (DESIRED_ROT_FREQ), defaulting to 600."""
        with self._lock:
            if self._engine is None:
                return False
            if rpm is None:
                # DTR-driven legacy units can't use a fetched speed (the DTR
                # path only distinguishes stop/run) — skip the blocking conf
                # query there, and on any pre-conf device (the gate).
                desired = (
                    confproto.get_desired_speed(self._engine)
                    if self.conf_supported
                    and self.motor_ctrl is not MotorCtrlSupport.NONE
                    else None
                )
                if desired is not None:
                    rpm_d, pwm_ref = desired
                    rpm = pwm_ref if self.motor_ctrl is MotorCtrlSupport.PWM else rpm_d
                else:
                    rpm = DEFAULT_RPM
            if self.motor_ctrl is MotorCtrlSupport.RPM:
                return self._engine.send_only(
                    Cmd.HQ_MOTOR_SPEED_CTRL, struct.pack("<H", rpm)
                )
            if self.motor_ctrl is MotorCtrlSupport.PWM:
                return self._engine.send_only(
                    Cmd.SET_MOTOR_PWM, struct.pack("<H", rpm)
                )
            # no motor controller: DTR low spins the motor, high stops it
            channel = self._engine.channel
            if channel is not None and getattr(channel, "kind", "") == "serial":
                return bool(channel.set_dtr(rpm == 0))
            return True  # network units have no host-driven motor line

    def _conf_engine(self) -> Optional[CommandEngine]:
        """The engine iff conf queries are allowed — None keeps every
        conf getter a clean miss on pre-conf firmware (the gate)."""
        return self._engine if self.conf_supported else None

    def get_motor_info(self) -> Optional[confproto.MotorInfo]:
        """min/max/desired rotation speed (getMotorInfo :1023-1056)."""
        with self._lock:
            engine = self._conf_engine()
            if engine is None:
                return None
            return confproto.get_motor_info(
                engine, pwm_ctrl=self.motor_ctrl is MotorCtrlSupport.PWM
            )

    def get_mac_addr(self) -> Optional[bytes]:
        with self._lock:
            engine = self._conf_engine()
            return confproto.get_mac_addr(engine) if engine else None

    def get_ip_conf(self) -> Optional[confproto.IpConf]:
        with self._lock:
            engine = self._conf_engine()
            return confproto.get_ip_conf(engine) if engine else None

    def set_ip_conf(self, conf: confproto.IpConf) -> bool:
        with self._lock:
            engine = self._conf_engine()
            return confproto.set_ip_conf(engine, conf) if engine else False

    # ------------------------------------------------------------------
    # serial autobaud negotiation (sl_lidar_driver.cpp:1058-1155)
    # ------------------------------------------------------------------

    def negotiate_serial_baud(self, required_baud: int) -> Optional[int]:
        """Ask the device to measure and switch its UART baud rate.

        Serial-only.  The transceiver is shut down so the raw channel can
        be driven directly: stream 16-byte bursts of the 0x41 magic for up
        to 1.5 s (the device needs >100 B/s to trigger measurement), read
        back the 4-byte detected bps, then restart the transceiver and —
        only when the device measured the ``required_baud`` we are already
        transmitting at — confirm with NEW_BAUDRATE_CONFIRM
        {0x5F5F, required_bps, 0}.  An unconfirmed device reverts, which
        is exactly what we want on a mismatch: confirming a rate different
        from the host channel's would switch the device's UART away from
        the link we keep using.  Returns the detected bps, or None.
        """
        with self._lock:
            if self._engine is None:
                return None
            channel = self._engine.channel
            if channel is None or getattr(channel, "kind", "") != "serial":
                return None
            self._engine.send_only(Cmd.STOP)
            self._scanning = False
            self._engine.stop()  # closes the channel; we reopen it raw
            detected: Optional[int] = None
            try:
                if not channel.open():
                    return None
                magic = bytes([AUTOBAUD_MAGICBYTE]) * 16
                deadline = time.monotonic() + 1.5
                while time.monotonic() < deadline:
                    if channel.write(magic) < 0:
                        break
                    first = channel.read(1, timeout_ms=1)
                    if first:
                        # device replied: collect the 4-byte measured bps
                        raw = bytearray(first)
                        stop_at = time.monotonic() + 0.5
                        while len(raw) < 4 and time.monotonic() < stop_at:
                            more = channel.read(4 - len(raw), timeout_ms=100)
                            if more:
                                raw += more
                        if len(raw) >= 4:
                            detected = struct.unpack_from("<I", raw)[0]
                        break
            finally:
                channel.close()
                restarted = self._engine.start()
            if detected is None or not restarted:
                return None
            if detected == required_baud:
                self._engine.send_only(
                    Cmd.NEW_BAUDRATE_CONFIRM,
                    struct.pack("<HIH", AUTOBAUD_CONFIRM_FLAG, required_baud, 0),
                )
            return detected

    # ------------------------------------------------------------------
    # health / reset / info
    # ------------------------------------------------------------------

    def get_health(self) -> DeviceHealth:
        with self._lock:
            if self._engine is None:
                return DeviceHealth.ERROR
            ans = self._engine.request(Cmd.GET_DEVICE_HEALTH, Ans.DEVHEALTH, timeout_s=1.0)
        if ans is None or len(ans) < 3:
            return DeviceHealth.ERROR
        status = ans[0]
        if status >= 2:
            return DeviceHealth.ERROR
        return DeviceHealth(status)

    def reset(self) -> None:
        with self._lock:
            if self._engine is not None:
                self._engine.send_only(Cmd.RESET)

    def get_device_info_str(self) -> str:
        return self.device_info.summary() if self.device_info else "N/A"

    def rx_scheduling_class(self) -> Optional[int]:
        """Scheduling class the rx thread achieved (2 = SCHED_RR,
        1 = nice boost, 0 = default, -1 = transport without elevation);
        None when disconnected.  Surfaces in /diagnostics and the bench
        artifacts — the observable for the reference's PRIORITY_HIGH
        contract (sl_async_transceiver.cpp:299-409).

        Deliberately lock-free: the driver RLock is held across
        multi-second connect/disconnect/reset sequences, and diagnostics
        must never stall behind them.  One atomic attribute read; a
        mid-teardown engine still answers its (plain-int) property."""
        engine = self._engine
        return engine.rx_priority if engine is not None else None

    def print_summary(self) -> None:
        for line in self.profile.summary_lines():
            log.info("%s", line)

    def get_hw_max_distance(self) -> float:
        return self.profile.hw_max_distance

    def get_frequency(self, node_count: int) -> Optional[float]:
        """Scan rate in Hz derived from the active mode's sample duration
        and the points in one revolution (getFrequency,
        sl_lidar_driver.cpp:880-885).  None before a mode is active."""
        us = self._scan_decoder.timing.sample_duration_us
        if not self._scanning or us <= 0 or node_count <= 0:
            return None
        return 1e6 / (us * node_count)

    def is_new_type(self) -> bool:
        return self.profile.protocol is ProtocolType.NEW_TYPE

    # ------------------------------------------------------------------
    # scan consumption
    # ------------------------------------------------------------------

    def grab_scan_data(self, timeout_s: float = 2.0) -> Optional[ScanBatch]:
        got = self.grab_scan_data_with_timestamp(timeout_s)
        return got[0] if got is not None else None

    def grab_scan_data_with_timestamp(
        self, timeout_s: float = 2.0
    ) -> Optional[tuple[ScanBatch, float, float]]:
        """(batch, back-dated revolution-begin time, measured duration) —
        grabScanDataHqWithTimeStamp parity (sl_lidar_driver.cpp:783-806)."""
        if not self.is_connected() or not self._scanning:
            return None
        got = self._assembler.wait_and_grab_with_timestamp(timeout_s)
        if got is None:
            return None
        batch, ts0, duration = got
        from rplidar_ros2_driver_tpu_torch.ops.ascend import apply_angle_compensation

        return apply_angle_compensation(batch, self._angle_compensate), ts0, duration

    def set_ingest_sink(self, sink) -> None:
        """Install a fused ingest sink BEFORE connect (the engine binds
        the measurement callback at connect time).  The node's seam
        wiring uses this so one FusedIngest (and its rolling filter
        window) survives FSM driver recreation, like the chain does."""
        with self._lock:
            if self._connected:
                raise RuntimeError("ingest sink must be set before connect")
            self._scan_decoder = sink
            self._fused_ingest = sink

    def grab_filtered(self, timeout_s: float = 2.0) -> Optional[list]:
        """Fused-ingest consumer: completed revolutions as
        ``[(FilterOutput, ts0, duration), ...]`` from the next dispatched
        batch (possibly empty — mid-revolution batch), or None on
        timeout / when the host ingest backend is active."""
        if not self.is_connected() or not self._scanning:
            return None
        sink = self._fused_ingest
        if sink is None:
            return None
        return sink.wait_and_grab_outputs(timeout_s)

    def grab_scan_host(
        self, timeout_s: float = 2.0
    ) -> Optional[tuple[dict, float, float]]:
        """Host-native grab: raw numpy arrays straight from the assembler,
        no device work at all.  Angle compensation is NOT applied here —
        the chain's grid resampler is ordering-independent (scatter-min)
        and its clip stage drops invalid nodes, so ascend would only add a
        per-scan device dispatch to the latency path."""
        if not self.is_connected() or not self._scanning:
            return None
        return self._assembler.wait_and_grab_host(timeout_s)

    # ------------------------------------------------------------------
    # capture (replay.py)
    # ------------------------------------------------------------------

    def start_recording(self, path: str) -> None:
        """Tee every measurement frame into a capture file; decode it later
        with replay.decode_recording (batched decoders)."""
        from rplidar_ros2_driver_tpu_torch.replay import FrameRecorder

        self.stop_recording()
        self._scan_decoder.recorder = FrameRecorder(path)

    def stop_recording(self) -> Optional[int]:
        """Returns the number of frames captured, or None if not recording."""
        rec = self._scan_decoder.recorder
        if rec is None:
            return None
        self._scan_decoder.recorder = None
        frames = rec.frames
        rec.close()
        return frames

    def grab_scan_data_with_interval(self, max_nodes: Optional[int] = None):
        """Raw nodes accumulated since the last interval grab, as a (k, 4)
        [angle_q14, dist_q2, quality, flag] array — without waiting for a
        complete revolution (getScanDataWithIntervalHq,
        sl_lidar_driver.cpp:962-966).  None when nothing arrived."""
        if not self.is_connected() or not self._scanning:
            return None
        return self._raw_holder.fetch(max_nodes)

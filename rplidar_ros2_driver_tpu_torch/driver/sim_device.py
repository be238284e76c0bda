"""Protocol-accurate simulated lidar device (software device emulator): a
copy of the JAX package's ``driver/sim_device.py`` that emits the same
bytes for the same SimConfig.

The reference's only hardware-free backend is the node-layer
``DummyLidarDriver`` (src/lidar_driver_wrapper.cpp:417-471), which bypasses
the entire SDK.  This emulator goes further: it speaks the *wire protocol*
over a real TCP socket — request parsing, devinfo/health/conf answers, and
loop-mode measurement streaming built with the ops/wire.py encoders — so
tests (and users without hardware) can exercise the full stack: native
channel -> transceiver -> codec -> command engine -> per-format decoders ->
scan assembly -> FSM -> filter chain.  ``unplug()`` severs the link
mid-stream, automating the reference's manual hot-unplug protocol
(README.md:27-38).

Default identity is an S2-class DTOF unit (model 0x71 -> NEW_TYPE strategy);
pass ``model_id=0x18`` (A1M8) to exercise the legacy path.
"""

from __future__ import annotations

import logging
import math
import os
import select
import socket
import struct
import threading
import time
import tty
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from rplidar_ros2_driver_tpu_torch.models.tables import DeviceInfo
from rplidar_ros2_driver_tpu_torch.ops import unpack_ref, wire
from rplidar_ros2_driver_tpu_torch.protocol.codec import AnsHeader
from rplidar_ros2_driver_tpu_torch.protocol.constants import (
    Ans,
    Cmd,
    CMDFLAG_HAS_PAYLOAD,
    CMD_SYNC_BYTE,
    ConfKey,
    DENSE_CAPSULE_BYTES,
    CAPSULE_BYTES,
    HQ_CAPSULE_BYTES,
    NORMAL_NODE_BYTES,
    ULTRA_CAPSULE_BYTES,
    ULTRA_DENSE_CAPSULE_BYTES,
)

log = logging.getLogger("rplidar_tpu.sim")


@dataclass
class SimScanMode:
    id: int
    name: str
    ans_type: int
    us_per_sample: float
    max_distance: float


DEFAULT_MODES = [
    SimScanMode(0, "Standard", Ans.MEASUREMENT, 476.0, 12.0),
    SimScanMode(1, "DenseBoost", Ans.MEASUREMENT_DENSE_CAPSULED, 31.25, 40.0),
    SimScanMode(2, "Sensitivity", Ans.MEASUREMENT_CAPSULED, 63.0, 25.0),
    SimScanMode(3, "UltraBoost", Ans.MEASUREMENT_CAPSULED_ULTRA, 42.0, 30.0),
    # us_per_sample must keep the implied spin rate (1e6 / (us * points_per_rev))
    # under the unpacker's 100 Hz angle-jump ceiling for a 32-cabin frame
    # (handler_capsules.cpp:968): with 400 pts/rev, 60 us -> ~42 Hz.
    SimScanMode(4, "UltraDense", Ans.MEASUREMENT_ULTRA_DENSE_CAPSULED, 60.0, 40.0),
    SimScanMode(5, "HQ", Ans.MEASUREMENT_HQ, 32.0, 40.0),
]


# SimConfig is the mutable firmware-state holder of the simulated device
# (tests flip health_status live, SET_LIDAR_CONF writes ip_conf)
@dataclass
class SimConfig:
    model_id: int = 0x71           # S2M1 -> NEW_TYPE
    firmware: int = 0x0105
    hardware: int = 0x12
    serial: bytes = bytes(range(1, 17))  # nonzero first byte: "connected" S/N
    health_status: int = 0         # 0 ok / 1 warning / 2 error
    points_per_rev: int = 400
    dist_base_mm: float = 2000.0
    dist_amp_mm: float = 500.0
    frame_rate_hz: float = 0.0     # 0 = stream as fast as possible (tests)
    modes: list = field(default_factory=lambda: list(DEFAULT_MODES))
    # accessory-board / motor metadata (checkMotorCtrlSupport + getMotorInfo)
    acc_board_pwm: bool = False    # A2/A3 acc-board flag bit 0
    min_rpm: int = 200
    max_rpm: int = 1200
    desired_rpm: int = 600
    desired_pwm: int = 660
    # legacy GET_SAMPLERATE answer (std/express µs)
    std_sample_us: int = 476
    express_sample_us: int = 238
    # network identity (MAC / static-IP conf keys)
    mac: bytes = b"\xaa\xbb\xcc\xdd\xee\xff"
    ip_conf: bytes = bytes([192, 168, 11, 2, 255, 255, 255, 0, 192, 168, 11, 1])
    # deterministic fault program (driver/chaos.ChaosConfig): the
    # emulated firmware mutates its OWN outgoing wire frames — corrupt
    # bytes, truncated/garbage-prefixed frames, stall windows, and
    # mid-capsule severs (half a frame, then unplug) — so the full
    # transport->decoder->assembler->FSM stack chews the damage.  A new
    # scan start restarts the program at frame 0, so small
    # disconnect_frames indices model reconnect storms.  None = clean.
    chaos: object = None
    # procedural world provider (scenarios/foundry.FoundryScene or any
    # object with dist_mm(thetas_deg, revs) -> mm ndarray, 0 = no
    # return): replaces the sinusoid ring for ALL six wire formats via
    # the one _scene_dists seam.  None keeps the default ring on the
    # exact per-beam scalar-math path — byte-identical frames to the
    # pre-scene tree (pinned by tests/test_scenarios.py goldens).
    scene: object = None


class SimulatedDevice:
    """One-client TCP server emulating lidar firmware."""

    TARGET = "127.0.0.1"

    def __init__(self, config: Optional[SimConfig] = None) -> None:
        self.cfg = config or SimConfig()
        self._srv: Optional[socket.socket] = None
        self._conn: Optional[socket.socket] = None
        self._conn_lock = threading.Lock()
        # one frame on the wire at a time: the stream thread and the
        # request-answer path (rx thread) share the transport, and real
        # firmware serializes its UART writes — without this, a
        # GET_DEVICE_HEALTH answer issued mid-stream tears into a
        # measurement frame and the host decoder resyncs past it (the
        # health FSM's quarantine-release probe polls exactly there)
        self._tx_lock = threading.Lock()
        self._accept_thread: Optional[threading.Thread] = None
        self._stream_thread: Optional[threading.Thread] = None
        self._streaming = threading.Event()
        self._running = threading.Event()
        self.port = 0
        # observability for tests
        self.motor_rpm = 0
        # wire format of the most recently started stream — NOT reset on
        # stop/unplug (observability for tests asserting what the last
        # scan start selected, not a liveness signal; use _streaming for
        # that)
        self.active_ans_type = 0
        self.commands: list[int] = []
        # points actually delivered by the stream loop (frames _send
        # confirmed written; resets at each scan start) — under host load
        # the absolute-deadline pacer can fall behind nominal rate, so
        # tests that check "did the consumer keep up" compare against
        # this, not wall-clock * nominal rate
        self.points_emitted = 0
        # when the current stream session began, and how many frame sends
        # blocked hard (>100 ms inside _send): a consumer that stops
        # draining the socket fills the kernel buffer and parks sendall
        # for hundreds of ms, while host-load/GIL scheduling delays stay
        # in the single-ms range — tests use this to tell "consumer
        # can't keep up" apart from "CI host is slow"
        self.stream_t0 = 0.0
        self.stream_send_stalls = 0
        # the live ChaosStream of the current scan session (cfg.chaos
        # set): fault tallies for tests; None on a clean stream
        self.chaos_stream = None

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    _RX_THREAD_NAME = "sim_accept"

    def start(self) -> "SimulatedDevice":
        """Shared lifecycle: transports implement _open_listener/_rx_loop."""
        self._open_listener()
        self._running.set()
        self.motor_rpm = 0
        self.commands = []
        self._accept_thread = threading.Thread(
            target=self._rx_loop, name=self._RX_THREAD_NAME, daemon=True
        )
        self._accept_thread.start()
        return self

    def _open_listener(self) -> None:
        self._srv = socket.socket()
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((self.TARGET, 0))
        self._srv.listen(1)
        self.port = self._srv.getsockname()[1]

    def _rx_loop(self) -> None:
        self._accept_loop()

    def stop(self) -> None:
        self._running.clear()
        self._streaming.clear()
        self.unplug()
        self._close_listener()
        for t in (self._accept_thread, self._stream_thread):
            if t is not None:
                t.join(3.0)
        self._accept_thread = self._stream_thread = None

    def _close_listener(self) -> None:
        """Transport hook: tear down the accept endpoint (shut down first:
        on Linux a close alone does not wake the accept thread, and stop()
        would wait out its join timeout)."""
        if self._srv is not None:
            try:
                self._srv.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._srv.close()
            except OSError:
                pass
            self._srv = None

    def unplug(self) -> None:
        """Sever the client link abruptly (hot-unplug fault injection)."""
        self._streaming.clear()
        with self._conn_lock:
            if self._conn is not None:
                try:
                    self._conn.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                try:
                    self._conn.close()
                except OSError:
                    pass
                self._conn = None

    # ------------------------------------------------------------------
    # connection handling
    # ------------------------------------------------------------------

    def _accept_loop(self) -> None:
        while self._running.is_set():
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            # timeout BEFORE publishing: _send's whole-frame retry loop
            # relies on send() timing out at 0.2 s — a send grabbing the
            # conn in the publish-to-_serve window must not block forever
            conn.settimeout(0.2)
            with self._conn_lock:
                self._conn = conn
            try:
                self._serve(conn)
            except (OSError, ConnectionError):
                pass
            finally:
                self._streaming.clear()

    def _serve(self, conn: socket.socket) -> None:
        buf = bytearray()
        while self._running.is_set():  # timeout set before conn was published
            try:
                chunk = conn.recv(256)
            except socket.timeout:
                continue
            except OSError:
                return
            if not chunk:
                return
            self._feed(buf, chunk)

    def _feed(self, buf: bytearray, chunk: bytes) -> None:
        """Shared rx helper: append bytes, parse every complete request."""
        buf += chunk
        while True:
            consumed = self._try_parse_request(bytes(buf))
            if consumed == 0:
                return
            del buf[:consumed]

    def _try_parse_request(self, data: bytes) -> int:
        """Parse one request packet; returns bytes consumed (0 = need more)."""
        # resync to A5
        idx = data.find(bytes([CMD_SYNC_BYTE]))
        if idx < 0:
            return len(data)
        if idx > 0:
            return idx
        if len(data) < 2:
            return 0
        cmd = data[1]
        if cmd & CMDFLAG_HAS_PAYLOAD:
            if len(data) < 3:
                return 0
            size = data[2]
            total = 3 + size + 1
            if len(data) < total:
                return 0
            payload = data[3 : 3 + size]
            checksum = 0
            for b in data[: total - 1]:
                checksum ^= b
            if checksum != data[total - 1]:
                log.warning("sim: bad request checksum for cmd %#x", cmd)
                return total
            self._handle(cmd, payload)
            return total
        self._handle(cmd, b"")
        return 2

    # ------------------------------------------------------------------
    # request handlers
    # ------------------------------------------------------------------

    def _send(self, data: bytes) -> bool:
        """Write the WHOLE frame or report failure.  The conn socket
        carries the 0.2 s rx timeout set in _serve, which also applies
        to sends — a backpressured sendall would abort mid-frame after
        0.2 s and tear the byte stream, so partial progress is tracked
        explicitly and timeouts retry until a deadline (same contract as
        the serial transport's _send)."""
        with self._conn_lock:
            conn = self._conn
        if conn is None:
            return False
        view = memoryview(data)
        deadline = time.monotonic() + 0.5
        with self._tx_lock:  # whole-frame atomicity across threads
            while len(view):
                try:
                    n = conn.send(view)
                except socket.timeout:
                    n = 0
                except OSError:
                    return False
                if n:
                    view = view[n:]
                elif time.monotonic() > deadline:
                    return False  # reader is gone; stream is torn anyway
        return True

    def tx_backlog_bytes(self) -> int:
        """Bytes queued in the kernel TX buffer, not yet drained by the
        consumer (Linux SIOCOUTQ).  This is the timing-insensitive
        "is the consumer keeping up" signal: a drain-limited consumer
        pins this near the socket buffer size, while host-load slowness
        (sim thread starved, GIL contention) leaves it near zero.
        Returns 0 when no client is connected or the query fails."""
        import fcntl
        import termios

        with self._conn_lock:
            conn = self._conn
        if conn is None:
            return 0
        try:
            buf = fcntl.ioctl(conn.fileno(), termios.TIOCOUTQ, b"\x00" * 4)
            return struct.unpack("i", buf)[0]
        except (OSError, AttributeError):
            # AttributeError: termios lacks TIOCOUTQ on non-Linux hosts —
            # same "returns 0 on failure" contract as a failed ioctl.
            return 0

    def _answer(self, ans_type: int, payload: bytes, is_loop: bool = False) -> None:
        hdr = AnsHeader(ans_type=ans_type, payload_len=len(payload), is_loop=is_loop)
        self._send(hdr.encode() + payload)

    def _handle(self, cmd: int, payload: bytes) -> None:
        self.commands.append(cmd)
        if cmd == Cmd.STOP:
            self._streaming.clear()
        elif cmd == Cmd.RESET:
            self._streaming.clear()
            self.motor_rpm = 0
        elif cmd == Cmd.GET_DEVICE_INFO:
            info = DeviceInfo(
                model=self.cfg.model_id,
                firmware_version=self.cfg.firmware,
                hardware_version=self.cfg.hardware,
                serialnum=self.cfg.serial,
            )
            self._answer(Ans.DEVINFO, info.to_payload())
        elif cmd == Cmd.GET_DEVICE_HEALTH:
            self._answer(
                Ans.DEVHEALTH, struct.pack("<BH", self.cfg.health_status, 0)
            )
        elif cmd == Cmd.HQ_MOTOR_SPEED_CTRL:
            if len(payload) >= 2:
                self.motor_rpm = struct.unpack_from("<H", payload)[0]
        elif cmd == Cmd.SET_MOTOR_PWM:
            if len(payload) >= 2:
                self.motor_rpm = struct.unpack_from("<H", payload)[0]
        elif cmd == Cmd.GET_ACC_BOARD_FLAG:
            flag = 0x1 if self.cfg.acc_board_pwm else 0x0
            self._answer(Ans.ACC_BOARD_FLAG, struct.pack("<I", flag))
        elif cmd == Cmd.GET_SAMPLERATE:
            # legacy sample-rate query (cmd 0x59 -> ans 0x15): two u16 LE,
            # std/express µs (sl_lidar_driver.cpp:1556-1599)
            self._answer(
                Ans.SAMPLE_RATE,
                struct.pack(
                    "<HH",
                    int(self.cfg.std_sample_us),
                    int(self.cfg.express_sample_us),
                ),
            )
        elif cmd == Cmd.GET_LIDAR_CONF:
            # pre-conf firmware (old triangle, fw < 1.24) does not know the
            # command at all: no answer, the requester times out — the
            # behavior checkSupportConfigCommands exists to avoid
            # (sl_lidar_driver.cpp:1176-1196)
            if self._conf_capable():
                self._handle_conf(payload)
        elif cmd == Cmd.SET_LIDAR_CONF:
            if self._conf_capable():
                self._handle_set_conf(payload)
        elif cmd in (Cmd.SCAN, Cmd.FORCE_SCAN):
            # FORCE_SCAN streams even when health-gated firmware would
            # refuse SCAN (sl_lidar_driver.cpp startScan force path)
            self._start_stream(self.cfg.modes[0])
        elif cmd == Cmd.EXPRESS_SCAN:
            if not self._conf_capable():
                # pre-conf express: working_mode byte is 0 on the wire and
                # the device streams the classic capsule format
                # (startScanExpress legacy branch, sl_lidar_driver.cpp:
                # 716-729, 748-750)
                self._start_stream(SimScanMode(
                    1, "Express", Ans.MEASUREMENT_CAPSULED,
                    float(self.cfg.express_sample_us), 16.0,
                ))
                return
            mode_id = payload[0] if payload else 0
            mode = next((m for m in self.cfg.modes if m.id == mode_id), None)
            if mode is not None:
                self._start_stream(mode)
        # unknown commands are ignored, like real firmware

    def _conf_capable(self) -> bool:
        """Whether the emulated firmware speaks GET/SET_LIDAR_CONF — the
        device-side truth the host's supports_conf_commands gate predicts
        (ND-magic major id >= 4, or triangle firmware >= 1.24).  The
        comparison logic is deliberately written out rather than calling
        supports_conf_commands: the emulator is the independent oracle the
        gate is tested against."""
        from rplidar_ros2_driver_tpu_torch.models.tables import (
            CONF_MIN_FIRMWARE_VERSION,
            NEWDESIGN_MINUM_MAJOR_ID,
        )

        return (
            (self.cfg.model_id >> 4) >= NEWDESIGN_MINUM_MAJOR_ID
            or self.cfg.firmware >= CONF_MIN_FIRMWARE_VERSION
        )

    def _handle_conf(self, payload: bytes) -> None:
        if len(payload) < 4:
            return
        key = struct.unpack_from("<I", payload)[0]
        extra = payload[4:]
        mode_id = struct.unpack_from("<H", extra)[0] if len(extra) >= 2 else 0
        mode = next((m for m in self.cfg.modes if m.id == mode_id), None)
        echo = struct.pack("<I", key)
        if key == ConfKey.SCAN_MODE_COUNT:
            self._answer(Ans.GET_LIDAR_CONF, echo + struct.pack("<H", len(self.cfg.modes)))
        elif key == ConfKey.SCAN_MODE_TYPICAL:
            dense = next(
                (m for m in self.cfg.modes if m.name == "DenseBoost"), self.cfg.modes[0]
            )
            self._answer(Ans.GET_LIDAR_CONF, echo + struct.pack("<H", dense.id))
        elif key == ConfKey.SCAN_MODE_US_PER_SAMPLE and mode:
            self._answer(
                Ans.GET_LIDAR_CONF, echo + struct.pack("<I", int(mode.us_per_sample * 256))
            )
        elif key == ConfKey.SCAN_MODE_MAX_DISTANCE and mode:
            self._answer(
                Ans.GET_LIDAR_CONF, echo + struct.pack("<I", int(mode.max_distance * 256))
            )
        elif key == ConfKey.SCAN_MODE_ANS_TYPE and mode:
            self._answer(Ans.GET_LIDAR_CONF, echo + bytes([mode.ans_type]))
        elif key == ConfKey.SCAN_MODE_NAME and mode:
            self._answer(Ans.GET_LIDAR_CONF, echo + mode.name.encode() + b"\x00")
        elif key == ConfKey.MIN_ROT_FREQ:
            self._answer(Ans.GET_LIDAR_CONF, echo + struct.pack("<H", self.cfg.min_rpm))
        elif key == ConfKey.MAX_ROT_FREQ:
            self._answer(Ans.GET_LIDAR_CONF, echo + struct.pack("<H", self.cfg.max_rpm))
        elif key == ConfKey.DESIRED_ROT_FREQ:
            self._answer(
                Ans.GET_LIDAR_CONF,
                echo + struct.pack("<HH", self.cfg.desired_rpm, self.cfg.desired_pwm),
            )
        elif key == ConfKey.LIDAR_MAC_ADDR:
            self._answer(Ans.GET_LIDAR_CONF, echo + self.cfg.mac)
        elif key == ConfKey.LIDAR_STATIC_IP_ADDR:
            self._answer(Ans.GET_LIDAR_CONF, echo + self.cfg.ip_conf)
        # unknown keys: no answer (requester times out, like a real device)

    def _handle_set_conf(self, payload: bytes) -> None:
        if len(payload) < 4:
            return
        key = struct.unpack_from("<I", payload)[0]
        data = payload[4:]
        if key == ConfKey.LIDAR_STATIC_IP_ADDR and len(data) >= 12:
            self.cfg.ip_conf = bytes(data[:12])
            self._answer(Ans.SET_LIDAR_CONF, struct.pack("<I", 0))
        else:
            # unsupported key: result code 1 (device rejects the set)
            self._answer(Ans.SET_LIDAR_CONF, struct.pack("<I", 1))

    # ------------------------------------------------------------------
    # measurement streaming
    # ------------------------------------------------------------------

    def _start_stream(self, mode: SimScanMode) -> None:
        self._streaming.clear()
        if self._stream_thread is not None:
            self._stream_thread.join(2.0)
        self.active_ans_type = int(mode.ans_type)  # test observability
        self._streaming.set()
        self._stream_thread = threading.Thread(
            target=self._stream_loop, args=(mode,), name="sim_stream", daemon=True
        )
        self._stream_thread.start()

    def _scene_dist_mm(self, theta_deg: float, rev: int) -> float:
        return self.cfg.dist_base_mm + self.cfg.dist_amp_mm * math.sin(
            math.radians(theta_deg) + 0.1 * rev
        )

    def _scene_dists(self, pts: np.ndarray) -> np.ndarray:
        """Ranges (mm, float) for an array of GLOBAL point indices —
        the ONE beam→(theta, rev) contract for every wire format:

            theta = 360 · (p % points_per_rev) / points_per_rev
            rev   = p // points_per_rev

        Each beam is evaluated at its OWN revolution, even mid-frame —
        a capsule frame that straddles a rev boundary mixes two revs,
        which matters because the default ring's phase advances by
        0.1 rad per rev (and a foundry scene's pose advances per rev).
        Pinned by the golden test in tests/test_scenarios.py so scene
        providers cannot silently disagree with the ring.

        With no scene configured the default sinusoid ring keeps the
        historical per-beam SCALAR math.sin path — vectorized libm can
        differ from scalar libm in the last ulp, and the default wire
        bytes are pinned byte-identical across trees."""
        ppr = self.cfg.points_per_rev
        thetas = 360.0 * (pts % ppr) / ppr
        revs = pts // ppr
        if self.cfg.scene is not None:
            return np.asarray(
                self.cfg.scene.dist_mm(thetas, revs), np.float64
            )
        return np.array(
            [self._scene_dist_mm(t, r) for t, r in zip(thetas, revs)]
        )

    # all six measurement wire formats, (frame bytes, points per frame)
    STREAMABLE = {
        Ans.MEASUREMENT: (NORMAL_NODE_BYTES, 1),
        Ans.MEASUREMENT_DENSE_CAPSULED: (DENSE_CAPSULE_BYTES, 40),
        Ans.MEASUREMENT_CAPSULED: (CAPSULE_BYTES, 32),
        Ans.MEASUREMENT_CAPSULED_ULTRA: (ULTRA_CAPSULE_BYTES, 96),
        Ans.MEASUREMENT_ULTRA_DENSE_CAPSULED: (ULTRA_DENSE_CAPSULE_BYTES, 64),
        Ans.MEASUREMENT_HQ: (HQ_CAPSULE_BYTES, 96),
    }

    def _stream_loop(self, mode: SimScanMode) -> None:
        if mode.ans_type not in self.STREAMABLE:
            log.error(
                "sim: ans type %#x is not streamable; ignoring scan start",
                mode.ans_type,
            )
            self._streaming.clear()
            return
        frame_bytes, pts_per_frame = self.STREAMABLE[mode.ans_type]
        chaos = None
        if self.cfg.chaos is not None:
            from rplidar_ros2_driver_tpu_torch.driver.chaos import ChaosStream

            chaos = ChaosStream(self.cfg.chaos)
            self.chaos_stream = chaos  # test observability (fault tallies)
        self._send(
            AnsHeader(ans_type=mode.ans_type, payload_len=frame_bytes, is_loop=True).encode()
        )
        period = (
            pts_per_frame / (1e6 / mode.us_per_sample)
            if self.cfg.frame_rate_hz == 0
            else 1.0 / self.cfg.frame_rate_hz
        )
        ppr = self.cfg.points_per_rev
        idx = 0  # global point index
        self.points_emitted = 0
        self.stream_send_stalls = 0
        self.stream_t0 = time.monotonic()
        first = True
        # absolute-deadline pacing: per-frame relative sleeps accumulate
        # scheduler overhead (~0.1-1 ms each), which at 800 fps would run
        # ~10-20% slow — pace against a running deadline instead
        pace = min(period, 0.02) if self.cfg.frame_rate_hz == 0 else period
        next_t = time.monotonic()
        while self._streaming.is_set() and self._running.is_set():
            rev, pos = divmod(idx, ppr)
            theta = 360.0 * pos / ppr
            start_q6 = int(theta * 64) & 0x7FFF
            if mode.ans_type == Ans.MEASUREMENT:
                dist = self._scene_dists(np.arange(1) + idx)[0]
                frame = wire.encode_normal_node(
                    int(theta * 64), int(dist * 4), 0x2F, syncbit=(pos == 0)
                )
            elif mode.ans_type == Ans.MEASUREMENT_DENSE_CAPSULED:
                dists = self._scene_dists(np.arange(40) + idx)
                frame = wire.encode_dense_capsule(start_q6, first, dists.astype(int))
            elif mode.ans_type == Ans.MEASUREMENT_CAPSULED:
                # express capsule: 16 cabins x 2 points
                dists = self._scene_dists(np.arange(32) + idx)
                dist_q2 = (dists.astype(int) * 4) & ~0x3
                frame = wire.encode_capsule(
                    start_q6, first, dist_q2.reshape(16, 2), np.zeros((16, 2), int)
                )
            elif mode.ans_type == Ans.MEASUREMENT_CAPSULED_ULTRA:
                # 32 cabins x 3 points.  The decoder's contract
                # (unpack_ref.UltraCapsuleDecoder): major is the mm-domain
                # varbitscale base of point 0; predict1 applies to THIS
                # cabin's decoded base, predict2 to the NEXT cabin's,
                # both shifted left by the base's scale level; -512/511
                # are reserved invalid markers.  Encode quantization-aware
                # against the decoded bases.
                pts = np.arange(97) + idx  # + first point of the NEXT frame
                mm = self._scene_dists(pts).astype(np.int64)
                bases_mm = mm[0::3]  # 33 cabin bases (incl. next frame's)
                majors = np.array(
                    [wire.varbitscale_encode(int(v)) for v in bases_mm]
                )
                dec = [unpack_ref.varbitscale_decode(int(m)) for m in majors]
                p1 = np.empty(32, np.int64)
                p2 = np.empty(32, np.int64)
                for c in range(32):
                    b1, l1 = dec[c]
                    b2, l2 = dec[c + 1]
                    p1[c] = np.clip((mm[3 * c + 1] - b1) >> l1, -511, 510)
                    p2[c] = np.clip((mm[3 * c + 2] - b2) >> l2, -511, 510)
                frame = wire.encode_ultra_capsule(
                    start_q6, first, majors[:32], p1, p2
                )
            elif mode.ans_type == Ans.MEASUREMENT_ULTRA_DENSE_CAPSULED:
                # 32 cabins x 2 points, 20-bit piecewise-scaled samples
                dists = self._scene_dists(np.arange(64) + idx)
                words = np.array(
                    [
                        wire.ultra_dense_encode_sample(int(d), 0x2F)
                        for d in dists
                    ]
                )
                frame = wire.encode_ultra_dense_capsule(start_q6, first, words)
            else:  # HQ capsule: 96 pre-formatted nodes + CRC32
                pts = np.arange(96) + idx
                thetas = 360.0 * (pts % ppr) / ppr
                dq2 = self._scene_dists(pts).astype(np.int64) * 4
                flags = np.where(pts % ppr == 0, 1, 2)  # bit0 sync else !sync
                frame = wire.encode_hq_capsule(
                    (thetas * (65536.0 / 360.0)).astype(int),
                    dq2,
                    np.full(96, 0x2F, int),
                    flags,
                    timestamp=idx,
                )
            if chaos is not None:
                from rplidar_ros2_driver_tpu_torch.driver.chaos import (
                    FAULT_DISCONNECT,
                )

                kind, mutated = chaos.apply_frame(frame)
                if kind == FAULT_DISCONNECT:
                    # mid-capsule sever: half a frame on the wire, then
                    # the cable is yanked — the consumer's decoder is
                    # left holding a torn capsule, exactly the hot-
                    # unplug shape the reference protocol survives
                    self._send(bytes(frame[: len(frame) // 2]))
                    self.unplug()
                    return
                frame = mutated  # None = swallowed (stall/drop)
            sent = False
            if frame is not None:
                t_send = time.monotonic()
                sent = self._send(frame)
                if time.monotonic() - t_send > 0.1:
                    self.stream_send_stalls += 1
            idx += pts_per_frame
            if sent:
                self.points_emitted += pts_per_frame
            first = False
            if pace > 0:
                next_t += pace
                delay = next_t - time.monotonic()
                if delay > 0:
                    time.sleep(delay)
                elif delay < -1.0:
                    next_t = time.monotonic()  # fell far behind: resync


class SerialSimulatedDevice(SimulatedDevice):
    """The same protocol emulator behind a pty: the driver opens the slave
    end as a real serial device (termios2 path in native/src/channel.cc),
    so the SERIAL transport — not just TCP — is exercisable end-to-end.

    ``port_path`` is the /dev/pts/N to hand to ``connect()``.
    ``unplug()`` closes the master, which surfaces as EIO on the slave —
    the same failure a yanked USB adapter produces.  Unlike the TCP
    emulator (whose listener keeps accepting, so the FSM can reconnect),
    an unplugged pty CANNOT be re-plugged: the kernel owns /dev/pts
    naming, so a fresh master would appear at a different path.  Use the
    TCP emulator for reconnect/recovery scenarios.

    fd discipline: the master is nonblocking and every os.read/os.write
    happens under ``_conn_lock`` after re-checking ``self._master`` is
    still the fd we selected on — a closed-and-reused fd number can never
    be touched (unlike sockets, raw fds are silently recycled).
    """

    def __init__(self, config: Optional[SimConfig] = None) -> None:
        super().__init__(config)
        self._master: Optional[int] = None
        self._slave: Optional[int] = None
        self.port_path = ""

    _RX_THREAD_NAME = "sim_serial"

    def _open_listener(self) -> None:
        self._master, self._slave = os.openpty()
        tty.setraw(self._master)  # no echo/line discipline on the device side
        os.set_blocking(self._master, False)
        self.port_path = os.ttyname(self._slave)

    def _rx_loop(self) -> None:
        self._serial_loop()

    def _close_listener(self) -> None:
        if self._slave is not None:
            try:
                os.close(self._slave)
            except OSError:
                pass
            self._slave = None

    def unplug(self) -> None:
        self._streaming.clear()
        with self._conn_lock:
            if self._master is not None:
                try:
                    os.close(self._master)
                except OSError:
                    pass
                self._master = None

    def _serial_loop(self) -> None:
        buf = bytearray()
        while self._running.is_set():
            with self._conn_lock:
                fd = self._master
            if fd is None:
                return
            try:
                r, _, _ = select.select([fd], [], [], 0.2)
            except OSError:
                continue  # fd closed under us; loop re-checks _master
            if not r:
                continue
            with self._conn_lock:
                if self._master != fd:
                    continue  # unplugged (and fd possibly recycled)
                try:
                    chunk = os.read(fd, 256)
                except BlockingIOError:
                    continue
                except OSError:
                    return
            if not chunk:
                return
            self._feed(buf, chunk)

    def _send(self, data: bytes) -> bool:
        """Write the WHOLE frame or (on sustained backpressure) nothing
        past what's already out: a short nonblocking write must not leave
        a torn frame desyncing the byte stream, so the remainder is
        retried with a writability wait until a deadline."""
        view = memoryview(data)
        deadline = time.monotonic() + 0.5
        with self._tx_lock:  # whole-frame atomicity across threads
            while len(view):
                with self._conn_lock:
                    fd = self._master
                    if fd is None:
                        return False
                    try:
                        n = os.write(fd, view)
                    except BlockingIOError:
                        n = 0
                    except OSError:
                        return False
                if n:
                    view = view[n:]
                    continue
                if time.monotonic() > deadline:
                    return False  # reader is gone; stream is torn anyway
                try:
                    select.select([], [fd], [], 0.05)
                except OSError:
                    return False
        return True

    def tx_backlog_bytes(self) -> int:
        """Undrained bytes in the pty slave's input queue (FIONREAD on
        the retained slave fd) — the serial analog of the TCP SIOCOUTQ
        probe: a drain-limited consumer pins this near the pty buffer
        size while a starved sim thread leaves it near zero.  Returns 0
        on any failure, matching the base contract."""
        import fcntl
        import termios

        with self._conn_lock:
            fd = self._slave
        if fd is None:
            return 0
        try:
            buf = fcntl.ioctl(fd, termios.FIONREAD, b"\x00" * 4)
            return struct.unpack("i", buf)[0]
        except (OSError, AttributeError):
            return 0


class UdpSimulatedDevice(SimulatedDevice):
    """The emulator over UDP with connected-pair semantics: the device
    learns its peer from the first request datagram and streams answers
    back to it (the reference's UDP channel connects to a fixed device
    address the same way, sl_udp_channel.cpp:53-58).  ``unplug()`` goes
    silent (drops the peer) — UDP has no connection to sever, so the
    failure mode a dead radio link produces is timeouts, not errors.

    Keep-up counters are weaker here than over TCP/serial: ``sendto``
    never backpressures, so ``points_emitted`` counts datagrams *fired*
    (not delivered), ``stream_send_stalls`` cannot trigger, and
    ``tx_backlog_bytes`` reads 0.  Consumer keep-up tests should drive
    the TCP or serial emulator instead.
    """

    def __init__(self, config: Optional[SimConfig] = None) -> None:
        super().__init__(config)
        self._sock: Optional[socket.socket] = None
        self._peer = None

    _RX_THREAD_NAME = "sim_udp"

    def _open_listener(self) -> None:
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.bind((self.TARGET, 0))
        self._sock.settimeout(0.2)
        self.port = self._sock.getsockname()[1]

    def _rx_loop(self) -> None:
        self._udp_loop()

    def _close_listener(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def unplug(self) -> None:
        self._streaming.clear()
        with self._conn_lock:
            self._peer = None

    def _udp_loop(self) -> None:
        buf = bytearray()
        while self._running.is_set():
            sock = self._sock
            if sock is None:
                return
            try:
                chunk, addr = sock.recvfrom(2048)
            except socket.timeout:
                continue
            except OSError:
                return
            with self._conn_lock:
                if self._peer != addr:
                    self._peer = addr
                    buf.clear()  # new client: drop any half-parsed request
            self._feed(buf, chunk)

    def _send(self, data: bytes) -> bool:
        with self._conn_lock:
            sock, peer = self._sock, self._peer
        if sock is None or peer is None:
            return False
        try:
            sock.sendto(data, peer)
            return True
        except OSError:
            return False

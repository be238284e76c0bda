"""Pure-Python transport fallback: channels + transceiver without the
native library (a copy of the JAX package's ``protocol/pytransport.py``).

The production I/O plane is C++ (native/src/channel.cc + transceiver.cc,
the analog of the reference's arch layer + AsyncTransceiver).  This
module is its dependency-free twin — the same duck-typed contracts
(``NativeChannel`` / ``TransceiverLike``) over ``os``/``socket``/
``termios`` and the pure-Python :class:`~.codec.ResponseDecoder` — so
the real driver still runs where a C++ toolchain is unavailable
(``driver/real.py`` falls back here automatically, with a log notice).

Serial parity notes (vs channel.cc):

  * arbitrary baud uses the same termios2 ``BOTHER`` ioctl
    (``TCGETS2``/``TCSETS2``), raw 8N1, no flow control — 256000 baud
    (A2M7/A3/S1) has no ``Bxxx`` constant, so this is required, not an
    optimization;
  * DTR motor control via ``TIOCMBIS``/``TIOCMBIC``;
  * blocking reads use ``select`` over the fd plus a self-pipe so
    ``cancel()``/``close()`` unblocks a parked reader immediately (the
    reference's self-pipe trick, arch/linux/net_serial.cpp:204-223).

The rx thread runs at default priority (the native transceiver elevates
to SCHED_RR best-effort; Python offers no portable equivalent without
privileges — one more reason the native plane is the default).
"""

from __future__ import annotations

import errno
import fcntl
import logging
import os
import queue
import select
import socket
import struct
import threading
import time
from typing import Optional

from rplidar_ros2_driver_tpu_torch.protocol.codec import ResponseDecoder

# the engine's pump catches exactly this class; importing it does not load
# the shared library (native.runtime only dlopens lazily inside load())
from rplidar_ros2_driver_tpu_torch.native.runtime import ChannelError

log = logging.getLogger("rplidar_tpu.pytransport")


# Linux termios2 (asm-generic/ioctls.h, asm-generic/termbits.h)
_TCGETS2 = 0x802C542A
_TCSETS2 = 0x402C542B
_BOTHER = 0o010000
_CBAUD = 0o010017
_CSIZE = 0o000060
_CS8 = 0o000060
_PARENB = 0o000400
_CSTOPB = 0o000100
_CRTSCTS = 0o20000000000
_CREAD = 0o000200
_CLOCAL = 0o004000
_TCFLSH = 0x540B
_TCIOFLUSH = 2
_TIOCMBIS = 0x5416
_TIOCMBIC = 0x5417
_TIOCM_DTR = 0x002
# struct termios2: 4 tcflag_t, c_line, c_cc[19], 2 speed_t  (44 bytes)
_TERMIOS2_FMT = "<IIII20BII"


def _serial_configure_raw(fd: int, baud: int) -> None:
    """termios2 BOTHER raw-8N1 setup, mirroring rpl_channel::OpenSerial."""
    buf = bytearray(struct.calcsize(_TERMIOS2_FMT))
    fcntl.ioctl(fd, _TCGETS2, buf)
    fields = list(struct.unpack(_TERMIOS2_FMT, buf))
    cflag = fields[2]
    cflag &= ~(_CBAUD | _CSIZE | _PARENB | _CSTOPB | _CRTSCTS)
    cflag |= _BOTHER | _CS8 | _CREAD | _CLOCAL
    fields[0] = 0  # c_iflag
    fields[1] = 0  # c_oflag
    fields[2] = cflag
    fields[3] = 0  # c_lflag
    fields[5 + 6] = 0  # c_cc[VMIN=6]
    fields[5 + 5] = 0  # c_cc[VTIME=5]
    fields[-2] = baud  # c_ispeed
    fields[-1] = baud  # c_ospeed
    fcntl.ioctl(fd, _TCSETS2, struct.pack(_TERMIOS2_FMT, *fields))
    fcntl.ioctl(fd, _TCFLSH, _TCIOFLUSH)


class PyChannel:
    """serial | tcp | udp byte transport (NativeChannel's duck-type twin)."""

    def __init__(self, kind: str, target: str, *, baud: int = 0, port: int = 0) -> None:
        if kind not in ("serial", "tcp", "udp"):
            raise ValueError(f"unknown channel kind {kind!r}")
        self.kind = kind
        self._target = target
        self._baud = baud
        self._port = port
        self._fd: Optional[int] = None       # serial
        self._sock: Optional[socket.socket] = None
        self._cancel_r, self._cancel_w = -1, -1
        self._lock = threading.Lock()

    # -- lifecycle -----------------------------------------------------------

    def open(self) -> bool:
        self.close()
        try:
            if self.kind == "serial":
                fd = os.open(self._target, os.O_RDWR | os.O_NOCTTY | os.O_NONBLOCK)
                try:
                    _serial_configure_raw(fd, self._baud or 115200)
                except OSError:
                    os.close(fd)
                    return False
                self._fd = fd
            elif self.kind == "tcp":
                self._sock = socket.create_connection(
                    (self._target, self._port), timeout=5.0
                )
                # many tiny request packets, each awaited synchronously:
                # Nagle would serialize them behind delayed ACKs
                # (native parity: channel.cc sets TCP_NODELAY too)
                self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                self._sock.setblocking(False)
            else:  # udp: connected pair, like sl_udp_channel.cpp:53-58
                self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
                self._sock.connect((self._target, self._port))
                self._sock.setblocking(False)
        except OSError as e:
            log.debug("open(%s %s) failed: %s", self.kind, self._target, e)
            return False
        self._cancel_r, self._cancel_w = os.pipe()
        return True

    def close(self) -> None:
        with self._lock:
            if self._fd is not None:
                try:
                    os.close(self._fd)
                except OSError:
                    pass
                self._fd = None
            if self._sock is not None:
                try:
                    self._sock.close()
                except OSError:
                    pass
                self._sock = None
            for a in ("_cancel_r", "_cancel_w"):
                fd = getattr(self, a)
                if fd >= 0:
                    try:
                        os.close(fd)
                    except OSError:
                        pass
                    setattr(self, a, -1)

    @property
    def is_open(self) -> bool:
        return self._fd is not None or self._sock is not None

    def _read_fd(self) -> int:
        if self._fd is not None:
            return self._fd
        if self._sock is not None:
            return self._sock.fileno()
        return -1

    # -- I/O -----------------------------------------------------------------

    def write(self, data: bytes) -> int:
        """-1 on error or on 1 s without progress (native parity:
        rpl_channel_write gives up when its 1 s select makes none)."""
        try:
            if self._fd is not None:
                total = 0
                view = memoryview(data)
                while total < len(data):
                    try:
                        total += os.write(self._fd, view[total:])
                    except BlockingIOError:
                        _, w, _ = select.select([], [self._fd], [], 1.0)
                        if not w:
                            return -1  # wedged adapter: no progress in 1 s
                return total
            if self._sock is not None:
                self._sock.settimeout(1.0)
                try:
                    self._sock.sendall(data)
                except socket.timeout:
                    return -1  # stalled peer: no progress in 1 s
                finally:
                    self._sock.setblocking(False)
                return len(data)
        except OSError:
            return -1
        return -1

    def read(self, max_bytes: int = 4096, timeout_ms: int = 1000) -> Optional[bytes]:
        """None on timeout; b'' on closed/cancelled; bytes otherwise."""
        fd = self._read_fd()
        if fd < 0:
            return b""
        try:
            r, _, _ = select.select([fd, self._cancel_r], [], [], timeout_ms / 1000.0)
        except (OSError, ValueError):
            return b""
        if self._cancel_r in r:
            return b""
        if not r:
            return None
        try:
            if self._fd is not None:
                return os.read(self._fd, max_bytes)  # b'' at EOF (unplugged pty)
            assert self._sock is not None
            return self._sock.recv(max_bytes)  # b'' on peer close
        except BlockingIOError:
            return None
        except OSError as e:
            if e.errno in (errno.EAGAIN, errno.EWOULDBLOCK):
                return None
            return b""  # EIO on yanked adapter, ECONNRESET, ...

    def set_dtr(self, level: bool) -> bool:
        if self._fd is None:
            return False
        try:
            fcntl.ioctl(
                self._fd,
                _TIOCMBIS if level else _TIOCMBIC,
                struct.pack("I", _TIOCM_DTR),
            )
            return True
        except OSError:
            return False

    def cancel(self) -> None:
        if self._cancel_w >= 0:
            try:
                os.write(self._cancel_w, b"\x01")
            except OSError:
                pass


class PyTransceiver:
    """rx thread + decoded-message queue over a PyChannel (TransceiverLike).

    Same shape as the native transceiver: one reader thread feeds the
    streaming decoder and enqueues complete messages with their
    rx-thread arrival stamps (the anchor for per-node timestamp
    back-dating); a channel failure surfaces as ChannelError from
    ``wait_message``.
    """

    _SENTINEL = object()

    def __init__(self, channel: PyChannel) -> None:
        self.channel = channel
        self._q: queue.Queue = queue.Queue(maxsize=4096)
        self._dec_lock = threading.Lock()
        self._rx_ts = 0.0
        self._decoder = ResponseDecoder(self._on_message)
        self._thread: Optional[threading.Thread] = None
        self._running = threading.Event()
        self._error = threading.Event()

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> bool:
        if not self.channel.is_open and not self.channel.open():
            return False
        self._error.clear()
        with self._dec_lock:
            self._decoder.reset()
        self._drain_queue()
        self._running.set()
        self._thread = threading.Thread(
            target=self._rx_loop, name="rpl_py_rx", daemon=True
        )
        self._thread.start()
        return True

    def stop(self) -> None:
        self._running.clear()
        self.channel.cancel()
        if self._thread is not None:
            self._thread.join(5.0)
            self._thread = None
        self.channel.close()

    # -- TransceiverLike -----------------------------------------------------

    def send(self, packet: bytes) -> bool:
        return self.channel.write(packet) == len(packet)

    def wait_message(self, timeout_ms: int = 1000) -> Optional[tuple[int, bytes, bool]]:
        got = self.wait_message_ts(timeout_ms)
        return got[:3] if got is not None else None

    def wait_message_ts(
        self, timeout_ms: int = 1000
    ) -> Optional[tuple[int, bytes, bool, float]]:
        try:
            m = self._q.get(timeout=timeout_ms / 1000.0)
        except queue.Empty:
            if self._error.is_set():
                raise ChannelError("channel closed or errored")
            return None
        if m is self._SENTINEL:
            raise ChannelError("channel closed or errored")
        return m

    def reset_decoder(self) -> None:
        with self._dec_lock:
            self._decoder.reset()

    @property
    def had_error(self) -> bool:
        return self._error.is_set()

    # -- internals -----------------------------------------------------------

    def _on_message(self, ans_type: int, payload: bytes, is_loop: bool) -> None:
        try:
            self._q.put_nowait((ans_type, payload, is_loop, self._rx_ts))
        except queue.Full:
            log.warning("rx queue full: dropping ans %#x", ans_type)

    def _drain_queue(self) -> None:
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                return

    def _rx_loop(self) -> None:
        while self._running.is_set():
            data = self.channel.read(4096, timeout_ms=200)
            if data is None:
                continue  # timeout: poll the running flag
            if data == b"":
                if self._running.is_set():
                    self._error.set()
                    try:
                        self._q.put_nowait(self._SENTINEL)
                    except queue.Full:
                        pass
                return
            self._rx_ts = time.monotonic()
            with self._dec_lock:
                self._decoder.feed(data)

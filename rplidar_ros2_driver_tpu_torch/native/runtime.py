"""Object wrappers over the native C API: channels, decoder, transceiver
(a copy of the JAX package's ``native/runtime.py``).

These are thin RAII-style shells — the logic lives in native/src/*.cc.  The
driver layer (driver/real.py) talks to ``NativeTransceiver`` exactly the way
the reference driver talks to its AsyncTransceiver + IChannel pair
(src/sdk/src/sl_lidar_driver.cpp:406-410).
"""

from __future__ import annotations

import ctypes
from typing import Optional

from rplidar_ros2_driver_tpu_torch.native import (
    RPL_CLOSED,
    RPL_OK,
    RPL_TIMEOUT,
    RPL_TOOSMALL,
    load,
)

_MAX_PAYLOAD = 64 * 1024


class NativeChannel:
    """serial | tcp | udp byte transport backed by native/src/channel.cc."""

    def __init__(self, kind: str, target: str, *, baud: int = 0, port: int = 0) -> None:
        lib = load()
        self._lib = lib
        if kind == "serial":
            self._h = lib.rpl_serial_channel_create(target.encode(), baud)
        elif kind == "tcp":
            self._h = lib.rpl_tcp_channel_create(target.encode(), port)
        elif kind == "udp":
            self._h = lib.rpl_udp_channel_create(target.encode(), port)
        else:
            raise ValueError(f"unknown channel kind {kind!r}")
        if not self._h:
            raise RuntimeError("channel allocation failed")
        self.kind = kind

    def open(self) -> bool:
        return self._lib.rpl_channel_open(self._h) == RPL_OK

    def close(self) -> None:
        self._lib.rpl_channel_close(self._h)

    @property
    def is_open(self) -> bool:
        return bool(self._lib.rpl_channel_is_open(self._h))

    def write(self, data: bytes) -> int:
        buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
        return self._lib.rpl_channel_write(self._h, buf, len(data))

    def read(self, max_bytes: int = 4096, timeout_ms: int = 1000) -> Optional[bytes]:
        """None on timeout; b'' on closed/cancelled; bytes otherwise."""
        buf = (ctypes.c_uint8 * max_bytes)()
        n = self._lib.rpl_channel_read(self._h, buf, max_bytes, timeout_ms)
        if n == RPL_TIMEOUT:
            return None
        if n <= 0:
            return b""
        return bytes(buf[:n])

    def set_dtr(self, level: bool) -> bool:
        return self._lib.rpl_channel_set_dtr(self._h, int(level)) == RPL_OK

    def cancel(self) -> None:
        self._lib.rpl_channel_cancel(self._h)

    def __del__(self) -> None:
        h = getattr(self, "_h", None)
        if h:
            self._lib.rpl_channel_destroy(h)
            self._h = None

    # handle for composing with the transceiver
    @property
    def handle(self):
        return self._h


class NativeDecoder:
    """Streaming response decoder (native/src/codec.cc)."""

    def __init__(self) -> None:
        self._lib = load()
        self._h = self._lib.rpl_decoder_create()

    def feed(self, data: bytes) -> None:
        buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
        self._lib.rpl_decoder_feed(self._h, buf, len(data))

    def reset(self) -> None:
        self._lib.rpl_decoder_reset(self._h)

    @property
    def pending(self) -> int:
        return self._lib.rpl_decoder_pending(self._h)

    def pop(self) -> Optional[tuple[int, bytes, bool]]:
        ans_type = ctypes.c_uint8()
        is_loop = ctypes.c_int()
        payload = (ctypes.c_uint8 * _MAX_PAYLOAD)()
        n = self._lib.rpl_decoder_pop(
            self._h, ctypes.byref(ans_type), ctypes.byref(is_loop), payload, _MAX_PAYLOAD
        )
        if n < 0:
            return None
        return int(ans_type.value), bytes(payload[:n]), bool(is_loop.value)

    def drain(self) -> list[tuple[int, bytes, bool]]:
        out = []
        while True:
            m = self.pop()
            if m is None:
                return out
            out.append(m)

    def __del__(self) -> None:
        h = getattr(self, "_h", None)
        if h:
            self._lib.rpl_decoder_destroy(h)
            self._h = None


def encode_command(cmd: int, payload: bytes = b"") -> bytes:
    """Native request encoder (must match protocol.codec.encode_command)."""
    lib = load()
    out = (ctypes.c_uint8 * 300)()
    pl = (ctypes.c_uint8 * max(1, len(payload))).from_buffer_copy(payload or b"\0")
    n = lib.rpl_encode_command(cmd & 0xFF, pl, len(payload), out, 300)
    if n < 0:
        raise ValueError(f"encode failed for cmd {cmd:#x} (rc={n})")
    return bytes(out[:n])


class NativeTransceiver:
    """rx-thread + decoded-message queue (native/src/transceiver.cc)."""

    def __init__(self, channel: NativeChannel) -> None:
        self._lib = load()
        self._channel = channel  # keep alive: transceiver borrows the handle
        self._h = self._lib.rpl_transceiver_create(channel.handle)
        if not self._h:
            raise RuntimeError("transceiver allocation failed")

    def start(self) -> bool:
        return self._lib.rpl_transceiver_start(self._h) == RPL_OK

    def stop(self) -> None:
        self._lib.rpl_transceiver_stop(self._h)

    def send(self, packet: bytes) -> bool:
        buf = (ctypes.c_uint8 * len(packet)).from_buffer_copy(packet)
        return self._lib.rpl_transceiver_send(self._h, buf, len(packet)) == len(packet)

    def wait_message(self, timeout_ms: int = 1000) -> Optional[tuple[int, bytes, bool]]:
        """None on timeout; raises ChannelError if the link died."""
        got = self.wait_message_ts(timeout_ms)
        return got[:3] if got is not None else None

    def wait_message_ts(
        self, timeout_ms: int = 1000
    ) -> Optional[tuple[int, bytes, bool, float]]:
        """Like wait_message plus the frame's rx-thread arrival time
        (CLOCK_MONOTONIC seconds — comparable with time.monotonic()); the
        anchor for per-node timestamp back-dating, immune to consumer
        queue-drain latency."""
        ans_type = ctypes.c_uint8()
        is_loop = ctypes.c_int()
        rx_ts = ctypes.c_double()
        payload = (ctypes.c_uint8 * _MAX_PAYLOAD)()
        n = self._lib.rpl_transceiver_wait_message_ts(
            self._h, timeout_ms, ctypes.byref(ans_type), ctypes.byref(is_loop),
            ctypes.byref(rx_ts), payload, _MAX_PAYLOAD,
        )
        if n == RPL_TIMEOUT:
            return None
        if n == RPL_CLOSED:
            raise ChannelError("channel closed or errored")
        if n == RPL_TOOSMALL or n < 0:
            raise ChannelError(f"receive failed (rc={n})")
        return (
            int(ans_type.value), bytes(payload[:n]), bool(is_loop.value),
            float(rx_ts.value),
        )

    def reset_decoder(self) -> None:
        self._lib.rpl_transceiver_reset_decoder(self._h)

    @property
    def channel(self) -> NativeChannel:
        """The borrowed byte channel (raw access for DTR / autobaud)."""
        return self._channel

    @property
    def had_error(self) -> bool:
        return bool(self._lib.rpl_transceiver_error(self._h))

    @property
    def rx_priority(self) -> int:
        """Scheduling class the rx thread achieved (best-effort
        PRIORITY_HIGH, ref arch/linux/thread.hpp:64-120): 2 = SCHED_RR,
        1 = nice boost, 0 = default policy, -1 = not started yet."""
        return int(self._lib.rpl_transceiver_rx_priority(self._h))

    def __del__(self) -> None:
        h = getattr(self, "_h", None)
        if h:
            self._lib.rpl_transceiver_destroy(h)
            self._h = None


class ChannelError(IOError):
    """The byte transport failed (hot-unplug, peer close, cancellation)."""

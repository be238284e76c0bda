"""The PyTorch package's mirror of tests/test_native.py, over the library
its loader builds into build/native_torch/ (plus the loader's build lock).

Native runtime tests: codec parity vs the Python decoder, channel
loopbacks (TCP/UDP/pty-serial), transceiver streaming + hot-unplug error
propagation.  Skipped wholesale if the toolchain can't build the library."""

import os
import random
import socket
import struct
import threading
import time

import pytest

from rplidar_ros2_driver_tpu_torch import native as native_mod
from rplidar_ros2_driver_tpu_torch.protocol.codec import AnsHeader, ResponseDecoder, encode_command

pytestmark = pytest.mark.skipif(
    not native_mod.available(), reason="native library unavailable"
)


def _frame(ans_type: int, payloads: list[bytes], is_loop: bool = False) -> bytes:
    """One response header + payload(s) (loop mode repeats payloads)."""
    out = AnsHeader(ans_type=ans_type, payload_len=len(payloads[0]), is_loop=is_loop).encode()
    for p in payloads:
        out += p
    return out


class TestCodecParity:
    def test_encode_command_matches_python(self):
        from rplidar_ros2_driver_tpu_torch.native.runtime import encode_command as native_encode

        for cmd, payload in [
            (0x25, b""),
            (0x20, b""),
            (0x50, b""),
            (0x82, bytes(5)),
            (0x84, struct.pack("<I", 0x70)),
            (0xF0, struct.pack("<H", 660)),
            (0xA8, struct.pack("<H", 600)),
        ]:
            assert native_encode(cmd, payload) == encode_command(cmd, payload)

    def test_decoder_parity_fuzz(self):
        """Random non-loop frames with sync-free noise between them, fed in
        random chunk sizes to both decoders — identical message streams.
        (Loop mode swallows subsequent headers by design, so it is covered
        separately in test_loop_mode_and_reset.)"""
        from rplidar_ros2_driver_tpu_torch.native.runtime import NativeDecoder

        rng = random.Random(7)

        def noise(n):  # no 0xA5 -> cannot form a sync pair
            return bytes([rng.randrange(0, 0xA0) for _ in range(n)])

        stream = bytearray(noise(16))
        expect_types = []
        for _ in range(40):
            ans_type = rng.choice([0x04, 0x06, 0x15, 0x20, 0x21])
            n = rng.randrange(0, 24)
            payloads = [bytes([rng.randrange(256) for _ in range(n)])] if n else [b""]
            stream += _frame(ans_type, payloads, is_loop=False)
            expect_types.append(ans_type)
            stream += noise(rng.randrange(0, 6))

        nat = NativeDecoder()
        py = ResponseDecoder()
        data = bytes(stream)
        i = 0
        while i < len(data):
            step = rng.randrange(1, 17)
            nat.feed(data[i : i + step])
            py.feed(data[i : i + step])
            i += step
        nat_msgs = [(t, p) for (t, p, _l) in nat.drain()]
        py_msgs = [(t, p) for (t, p, _l) in py.messages]
        assert nat_msgs == py_msgs
        assert [t for (t, _p) in py_msgs] == expect_types

    def test_loop_mode_and_reset(self):
        from rplidar_ros2_driver_tpu_torch.native.runtime import NativeDecoder

        nat = NativeDecoder()
        nat.feed(_frame(0x82, [bytes(84), bytes(84)], is_loop=True))
        msgs = nat.drain()
        assert len(msgs) == 2
        assert all(t == 0x82 and loop for (t, _p, loop) in msgs)
        # without reset, a new header is swallowed as loop payload bytes
        nat.reset()
        nat.feed(_frame(0x04, [bytes(20)]))
        msgs = nat.drain()
        assert len(msgs) == 1 and msgs[0][0] == 0x04 and not msgs[0][2]

    def test_header_only_packet(self):
        from rplidar_ros2_driver_tpu_torch.native.runtime import NativeDecoder

        nat = NativeDecoder()
        nat.feed(_frame(0x21, [b""]))
        msgs = nat.drain()
        assert msgs == [(0x21, b"", False)]


class TestTcpChannel:
    def _server(self, payload: bytes, accept_then=None):
        srv = socket.socket()
        srv.bind(("127.0.0.1", 0))
        srv.listen(1)
        port = srv.getsockname()[1]

        def run():
            conn, _ = srv.accept()
            conn.sendall(payload)
            if accept_then:
                accept_then(conn)
            else:
                time.sleep(0.2)
                conn.close()
            srv.close()

        t = threading.Thread(target=run, daemon=True)
        t.start()
        return port, t

    def test_tcp_roundtrip(self):
        from rplidar_ros2_driver_tpu_torch.native.runtime import NativeChannel

        echo: list[bytes] = []

        def read_back(conn):
            conn.settimeout(2.0)
            try:
                echo.append(conn.recv(64))
            except socket.timeout:
                echo.append(b"")
            conn.close()

        port, t = self._server(b"hello-lidar", accept_then=read_back)
        ch = NativeChannel("tcp", "127.0.0.1", port=port)
        assert ch.open()
        got = b""
        deadline = time.monotonic() + 2
        while len(got) < 11 and time.monotonic() < deadline:
            chunk = ch.read(64, timeout_ms=500)
            if chunk:
                got += chunk
        assert got == b"hello-lidar"
        assert ch.write(b"pong") == 4
        t.join(3)
        assert echo and echo[0] == b"pong"
        ch.close()

    def test_read_timeout_and_cancel(self):
        from rplidar_ros2_driver_tpu_torch.native.runtime import NativeChannel

        port, t = self._server(b"", accept_then=lambda c: time.sleep(0.5))
        ch = NativeChannel("tcp", "127.0.0.1", port=port)
        assert ch.open()
        t0 = time.monotonic()
        assert ch.read(16, timeout_ms=100) is None  # timeout
        assert 0.05 < time.monotonic() - t0 < 1.0
        canceller = threading.Timer(0.1, ch.cancel)
        canceller.start()
        assert ch.read(16, timeout_ms=5000) == b""  # cancelled -> closed signal
        ch.close()
        t.join(3)

    def test_connect_refused(self):
        from rplidar_ros2_driver_tpu_torch.native.runtime import NativeChannel

        ch = NativeChannel("tcp", "127.0.0.1", port=1)  # nothing listens
        assert not ch.open()


class TestUdpChannel:
    def test_udp_roundtrip(self):
        from rplidar_ros2_driver_tpu_torch.native.runtime import NativeChannel

        srv = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        srv.bind(("127.0.0.1", 0))
        port = srv.getsockname()[1]
        ch = NativeChannel("udp", "127.0.0.1", port=port)
        assert ch.open()
        assert ch.write(b"ping") == 4
        data, addr = srv.recvfrom(64)
        assert data == b"ping"
        srv.sendto(b"pong", addr)
        got = ch.read(64, timeout_ms=1000)
        assert got == b"pong"
        ch.close()
        srv.close()


class TestSerialChannel:
    def test_pty_roundtrip(self):
        from rplidar_ros2_driver_tpu_torch.native.runtime import NativeChannel

        master, slave = os.openpty()
        try:
            ch = NativeChannel("serial", os.ttyname(slave), baud=115200)
            if not ch.open():
                pytest.skip("pty rejects termios2 configuration on this kernel")
            os.write(master, b"\xa5\x5a123")
            got = b""
            deadline = time.monotonic() + 2
            while len(got) < 5 and time.monotonic() < deadline:
                chunk = ch.read(16, timeout_ms=200)
                if chunk:
                    got += chunk
            assert got == b"\xa5\x5a123"
            assert ch.write(b"ok") == 2
            assert os.read(master, 16) == b"ok"
            ch.close()
        finally:
            os.close(master)
            os.close(slave)


class TestTransceiver:
    def _lidar_server(self, frames: bytes, close_after: float = 0.5):
        srv = socket.socket()
        srv.bind(("127.0.0.1", 0))
        srv.listen(1)
        port = srv.getsockname()[1]
        received: list[bytes] = []

        def run():
            conn, _ = srv.accept()
            conn.settimeout(1.0)
            try:
                received.append(conn.recv(64))  # the start-scan command
            except socket.timeout:
                pass
            conn.sendall(frames)
            time.sleep(close_after)
            conn.close()
            srv.close()

        t = threading.Thread(target=run, daemon=True)
        t.start()
        return port, t, received

    def test_stream_and_error_propagation(self):
        from rplidar_ros2_driver_tpu_torch.native.runtime import (
            ChannelError,
            NativeChannel,
            NativeTransceiver,
        )

        payloads = [bytes([i] * 84) for i in range(5)]
        frames = _frame(0x82, payloads, is_loop=True)
        port, t, received = self._lidar_server(frames, close_after=0.3)

        ch = NativeChannel("tcp", "127.0.0.1", port=port)
        tx = NativeTransceiver(ch)
        assert tx.start()
        assert tx.send(encode_command(0x20))
        got = []
        with pytest.raises(ChannelError):
            for _ in range(10):
                m = tx.wait_message(timeout_ms=2000)
                if m is None:
                    continue
                got.append(m)
        # 5 loop payloads arrived before the peer hung up
        assert [p for (_t, p, _l) in got] == payloads
        assert tx.had_error
        tx.stop()
        t.join(3)
        assert received and received[0] == encode_command(0x20)

    def test_rx_thread_priority_elevation_best_effort(self):
        """The rx thread attempts the reference's PRIORITY_HIGH (SCHED_RR,
        arch/linux/thread.hpp:64-120) and must FALL BACK silently when
        unprivileged: after start the reported class is one of
        {0 default, 1 nice, 2 SCHED_RR} — never a failure — and streaming
        still works."""
        from rplidar_ros2_driver_tpu_torch.native.runtime import NativeChannel, NativeTransceiver

        frames = _frame(0x81, [bytes(5)], is_loop=True)
        port, t, _ = self._lidar_server(frames, close_after=0.8)
        ch = NativeChannel("tcp", "127.0.0.1", port=port)
        tx = NativeTransceiver(ch)
        assert tx.rx_priority == -1  # not started yet
        assert tx.start()
        m = tx.wait_message(timeout_ms=2000)
        assert m is not None
        assert tx.rx_priority in (0, 1, 2), tx.rx_priority
        # the engine relays the achieved class (bench artifacts record it)
        from rplidar_ros2_driver_tpu_torch.protocol.engine import CommandEngine

        eng = CommandEngine.__new__(CommandEngine)
        eng._tx = tx
        assert eng.rx_priority == tx.rx_priority
        tx.stop()
        t.join(3)

    def test_rx_no_elevate_knob_forces_default_policy(self, monkeypatch):
        """RPL_RX_NO_ELEVATE=1 (the RR-vs-default A/B knob, read by the
        rx thread at elevation time) must skip elevation entirely —
        reported class exactly 0 — and leave streaming intact."""
        from rplidar_ros2_driver_tpu_torch.native.runtime import (
            NativeChannel,
            NativeTransceiver,
        )

        frames = _frame(0x81, [bytes(5)], is_loop=True)
        port, t, _ = self._lidar_server(frames, close_after=0.8)
        ch = NativeChannel("tcp", "127.0.0.1", port=port)
        tx = NativeTransceiver(ch)
        monkeypatch.setenv("RPL_RX_NO_ELEVATE", "1")
        try:
            assert tx.start()
            m = tx.wait_message(timeout_ms=2000)
            assert m is not None
            assert tx.rx_priority == 0, tx.rx_priority
        finally:
            tx.stop()
            t.join(3)

    def test_reset_decoder_between_modes(self):
        from rplidar_ros2_driver_tpu_torch.native.runtime import NativeChannel, NativeTransceiver

        first = _frame(0x81, [bytes(5)], is_loop=True)
        port, t, _ = self._lidar_server(first, close_after=0.8)
        ch = NativeChannel("tcp", "127.0.0.1", port=port)
        tx = NativeTransceiver(ch)
        assert tx.start()
        m = tx.wait_message(timeout_ms=2000)
        assert m and m[0] == 0x81
        tx.reset_decoder()  # as the driver does on stop/exitLoopMode
        tx.stop()
        t.join(3)


class TestDecoderRobustness:
    def test_corrupted_giant_size_header_resyncs(self):
        """A noise header claiming a ~1 GiB payload must not swallow the
        stream — the decoder resyncs and the next real frame decodes."""
        import struct

        from rplidar_ros2_driver_tpu_torch.native.runtime import NativeDecoder

        d = NativeDecoder()
        d.feed(b"\xa5\x5a" + struct.pack("<I", 0x3FFFFFFF) + b"\x04")
        d.feed(b"\xa5\x5a" + struct.pack("<I", 3) + b"\x06" + b"\x00\x01\x02")
        msgs = d.drain()
        assert len(msgs) == 1
        ans_type, payload, is_loop = msgs[0]
        assert ans_type == 0x06 and payload == b"\x00\x01\x02" and not is_loop

    def test_max_sane_payload_accepted(self):
        import struct

        from rplidar_ros2_driver_tpu_torch.native.runtime import NativeDecoder

        d = NativeDecoder()
        body = bytes(8192)
        d.feed(b"\xa5\x5a" + struct.pack("<I", 8192) + b"\x20" + body)
        msgs = d.drain()
        assert len(msgs) == 1 and len(msgs[0][1]) == 8192


class TestLoaderBuild:
    """The port's loader builds its own library under build/native_torch/,
    under a file lock, and never writes into native/."""

    def test_library_lands_under_build_not_native(self):
        path = native_mod.library_path()
        assert path.parent == native_mod.BUILD_DIR
        assert native_mod.SRC_DIR not in path.parents
        assert native_mod.available() and path.exists()

    def test_two_processes_rebuilding_at_once_both_load(self):
        """Two processes calling load(rebuild=True) at the same moment both
        get a loadable, working library, and no temporary file is left."""
        import subprocess
        import sys

        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        code = (
            "from rplidar_ros2_driver_tpu_torch import native\n"
            "from rplidar_ros2_driver_tpu_torch.native.runtime import encode_command\n"
            "lib = native.load(rebuild=True)\n"
            "assert encode_command(0x25) == bytes([0xA5, 0x25])\n"
            "print('ok')\n"
        )
        procs = [subprocess.Popen([sys.executable, "-c", code], cwd=repo,
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for _ in range(2)]
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0 and out.strip() == "ok", err[-2000:]
        leftovers = [f for f in os.listdir(native_mod.BUILD_DIR) if f.endswith(".tmp")]
        assert not leftovers


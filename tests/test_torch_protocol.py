"""The PyTorch package's mirror of tests/test_protocol.py.

Protocol layer: command encoding, response framing, loop mode, CRC."""

import zlib

import numpy as np
import pytest

from rplidar_ros2_driver_tpu_torch.protocol import (
    Ans,
    AnsHeader,
    Cmd,
    ResponseDecoder,
    crc32_padded,
    encode_command,
)
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)


class TestEncodeCommand:
    def test_simple_command_is_two_bytes(self):
        assert encode_command(Cmd.STOP) == bytes([0xA5, 0x25])
        assert encode_command(Cmd.SCAN) == bytes([0xA5, 0x20])
        assert encode_command(Cmd.RESET) == bytes([0xA5, 0x40])

    def test_payload_command_has_size_and_checksum(self):
        payload = bytes([0x00, 0x01, 0x00, 0x00, 0x00])
        pkt = encode_command(Cmd.EXPRESS_SCAN, payload)
        assert pkt[0] == 0xA5
        assert pkt[1] == 0x82
        assert pkt[2] == len(payload)
        checksum = 0
        for b in pkt[:-1]:
            checksum ^= b
        assert pkt[-1] == checksum

    def test_payload_on_payloadless_command_rejected(self):
        with pytest.raises(ValueError):
            encode_command(Cmd.STOP, b"\x01")


class TestResponseDecoder:
    def _header(self, ans, n, loop=False):
        return AnsHeader(ans_type=int(ans), payload_len=n, is_loop=loop).encode()

    def test_single_response(self):
        dec = ResponseDecoder()
        payload = bytes(range(20))
        dec.feed(self._header(Ans.DEVINFO, 20) + payload)
        assert dec.messages == [(int(Ans.DEVINFO), payload, False)]

    def test_split_across_chunks(self):
        dec = ResponseDecoder()
        buf = self._header(Ans.DEVHEALTH, 3) + b"\x00\x01\x02"
        for i in range(len(buf)):
            dec.feed(buf[i : i + 1])
        assert dec.messages == [(int(Ans.DEVHEALTH), b"\x00\x01\x02", False)]

    def test_loop_mode_reemits_payloads(self):
        dec = ResponseDecoder()
        dec.feed(self._header(Ans.MEASUREMENT, 5, loop=True))
        dec.feed(bytes(15))  # 3 complete 5-byte nodes
        assert len(dec.messages) == 3
        assert all(loop for (_, _, loop) in dec.messages)
        # loop mode persists until reset
        dec.feed(bytes(5))
        assert len(dec.messages) == 4
        dec.exit_loop_mode()
        dec.feed(bytes(5))  # garbage, no header
        assert len(dec.messages) == 4

    def test_garbage_before_sync_is_skipped(self):
        dec = ResponseDecoder()
        dec.feed(b"\xff\x00\xa5" + self._header(Ans.DEVINFO, 1) + b"\x42")
        assert dec.messages == [(int(Ans.DEVINFO), b"\x42", False)]

    def test_lone_sync_byte_straddling_chunks(self):
        dec = ResponseDecoder()
        hdr = self._header(Ans.DEVINFO, 2)
        dec.feed(b"\x00" + hdr[:1])
        dec.feed(hdr[1:] + b"\xaa\xbb")
        assert dec.messages == [(int(Ans.DEVINFO), b"\xaa\xbb", False)]

    def test_zero_payload_header(self):
        dec = ResponseDecoder()
        dec.feed(self._header(Ans.SET_LIDAR_CONF, 0))
        assert dec.messages == [(int(Ans.SET_LIDAR_CONF), b"", False)]

    def test_corrupt_size_resyncs(self):
        """A header claiming an implausibly large payload (wrong-baud noise
        containing A5 5A) must trigger a resync, not swallow the stream.
        Same rejection rule as the native codec (codec.cc kMaxSanePayload);
        this buffered decoder additionally recovers packets that begin
        inside the corrupt header (rescan from sync+1)."""
        import struct

        from rplidar_ros2_driver_tpu_torch.protocol.codec import MAX_SANE_PAYLOAD

        dec = ResponseDecoder()
        corrupt = b"\xa5\x5a" + struct.pack("<I", MAX_SANE_PAYLOAD + 1) + b"\x04"
        good_payload = bytes(range(20))
        dec.feed(corrupt + self._header(Ans.DEVINFO, 20) + good_payload)
        assert dec.messages == [(int(Ans.DEVINFO), good_payload, False)]

    def test_max_sane_payload_accepted(self):
        """The cap itself is a legal size (boundary pins the > comparison)."""
        from rplidar_ros2_driver_tpu_torch.protocol.codec import MAX_SANE_PAYLOAD

        dec = ResponseDecoder()
        payload = bytes(MAX_SANE_PAYLOAD)
        dec.feed(self._header(Ans.DEVINFO, MAX_SANE_PAYLOAD) + payload)
        assert dec.messages == [(int(Ans.DEVINFO), payload, False)]


from conftest import ScriptedTransceiver as _ScriptedTransceiver, wait_for


class TestStaleAnswerGuard:
    """A request that timed out leaves an answer 'owed'; the late answer
    must not complete the NEXT request of the same type (the conf protocol
    reuses one ans type for every per-mode query) — but exactly one is
    dropped, so a silent device costs one extra timeout, never a permanent
    drop loop (protocol/engine.py stale bookkeeping)."""

    def _engine(self):
        from rplidar_ros2_driver_tpu_torch.protocol.engine import CommandEngine

        tx = _ScriptedTransceiver()
        eng = CommandEngine(tx)
        assert eng.start()
        return eng, tx

    def _background_request(self, eng, tx, timeout_s=5.0):
        """Start a request on a thread and wait (via the send the engine
        performs AFTER registering its pending slot) until it is in flight
        — deterministic sequencing, no bare sleeps."""
        import threading

        sends_before = len(tx.sent)
        result = {}

        def req():
            result["ans"] = eng.request(
                Cmd.GET_LIDAR_CONF, Ans.GET_LIDAR_CONF, timeout_s=timeout_s
            )

        t = threading.Thread(target=req)
        t.start()
        assert wait_for(lambda: len(tx.sent) > sends_before, 5.0)
        return t, result

    def test_late_answer_dropped_once(self):
        eng, tx = self._engine()
        try:
            # request 1: device stays silent -> timeout marks the type
            # stale for a window equal to the timeout (generous: 2 s, so
            # CI scheduling jitter cannot expire it mid-test)
            assert eng.request(Cmd.GET_LIDAR_CONF, Ans.GET_LIDAR_CONF,
                               timeout_s=2.0) is None
            # request 2 in flight; the LATE answer to request 1 lands first,
            # then the real answer — the engine must hand back the second
            t, result = self._background_request(eng, tx)
            tx.q.put((int(Ans.GET_LIDAR_CONF), b"LATE", False))   # dropped
            tx.q.put((int(Ans.GET_LIDAR_CONF), b"FRESH", False))  # completes
            t.join(10.0)
            assert result["ans"] == b"FRESH"
        finally:
            eng.stop()

    def test_boundary_answer_is_still_stale(self, monkeypatch):
        """Regression: a late answer arriving EXACTLY at the stale
        deadline used to slip through (`<` vs `<=`) and complete the
        next caller's request with the previous request's data.  Pin
        the boundary by routing a response at a monotonic clock frozen
        to the recorded deadline."""
        import time as time_mod

        eng, tx = self._engine()
        try:
            assert eng.request(Cmd.GET_LIDAR_CONF, Ans.GET_LIDAR_CONF,
                               timeout_s=0.05) is None
            deadline = eng._stale[int(Ans.GET_LIDAR_CONF)]
            # request 2 pending; the late answer lands at t == deadline
            t, result = self._background_request(eng, tx, timeout_s=2.0)
            from rplidar_ros2_driver_tpu_torch.protocol import engine as engine_mod

            real_monotonic = time_mod.monotonic
            monkeypatch.setattr(
                engine_mod.time, "monotonic", lambda: deadline
            )
            try:
                eng._route_response(int(Ans.GET_LIDAR_CONF), b"LATE")
            finally:
                monkeypatch.setattr(
                    engine_mod.time, "monotonic", real_monotonic
                )
            # the boundary answer must have been dropped as stale; the
            # genuine answer then completes request 2
            tx.q.put((int(Ans.GET_LIDAR_CONF), b"FRESH", False))
            t.join(10.0)
            assert result["ans"] == b"FRESH"
        finally:
            eng.stop()

    def test_stale_window_expires(self):
        import time

        eng, tx = self._engine()
        try:
            assert eng.request(Cmd.GET_LIDAR_CONF, Ans.GET_LIDAR_CONF,
                               timeout_s=0.05) is None
            time.sleep(0.2)  # stale window (== timeout, 50 ms) elapses
            # an answer arriving after expiry flows normally
            t, result = self._background_request(eng, tx)
            tx.q.put((int(Ans.GET_LIDAR_CONF), b"OK", False))
            t.join(10.0)
            assert result["ans"] == b"OK"
        finally:
            eng.stop()


class TestCrc:
    def test_matches_zlib_with_device_padding(self):
        rng = np.random.default_rng(0)
        for n in (1, 3, 4, 7, 16, 773):
            data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
            pad = 4 - (n & 3)
            assert crc32_padded(data) == zlib.crc32(data + b"\x00" * pad)

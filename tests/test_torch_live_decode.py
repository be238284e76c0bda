"""The PyTorch package's mirror of tests/test_live_decode.py.

Live batched decode path (driver/decode.BatchScanDecoder).

Parity contract: streaming frames through the live decoder in arbitrary
chunk sizes must produce the exact node stream of the scalar golden
decoders (ops/unpack_ref.py) run frame-by-frame — same values, same order
— for all six wire formats, with the cross-run carries (previous frame,
dense sync edge, ultra-dense smoothing) handled at every chunk boundary.

Timestamp contract: every node is stamped ``cur_frame_rx − delay(idx)``
per the reference's per-sample delay model (protocol/timing.py), exact
through chunk boundaries and multi-revolution batches.

Throughput contract (VERDICT r1 #2): sustained live decode must beat the
S2 DenseBoost device rate (32 kSa/s) with >= 3x margin.
"""

from __future__ import annotations

import time

import numpy as np
import pytest

from rplidar_ros2_driver_tpu_torch.driver.assembly import RawNodeHolder, ScanAssembler
from rplidar_ros2_driver_tpu_torch.driver.decode import BatchScanDecoder
from rplidar_ros2_driver_tpu_torch.ops import unpack_ref, wire
from rplidar_ros2_driver_tpu_torch.protocol import crc as crcmod
from rplidar_ros2_driver_tpu_torch.protocol.constants import Ans
from rplidar_ros2_driver_tpu_torch.protocol.timing import (
    SAMPLES_PER_FRAME,
    TimingDesc,
    sample_delay_us,
)


def _rng():
    return np.random.default_rng(987)


def _angles(rng, m, step_q6=1200):
    inc = rng.integers(step_q6 // 2, step_q6 * 2, m)
    return (np.cumsum(inc) + rng.integers(0, 360 << 6)) % (360 << 6)


def _make_stream(ans_type: int, m: int, rng, syncs=(0,), corrupt=()):
    """Wire-format frame stream via ops/wire.py encoders."""
    frames = []
    if ans_type == Ans.MEASUREMENT:
        for i in range(m):
            frames.append(
                wire.encode_normal_node(
                    int(rng.integers(0, 360 << 6)),
                    int(rng.integers(0, 1 << 16)),
                    int(rng.integers(0, 64)),
                    syncbit=(i in syncs),
                )
            )
        return frames
    if ans_type == Ans.MEASUREMENT_HQ:
        for i in range(m):
            frames.append(
                wire.encode_hq_capsule(
                    rng.integers(0, 1 << 16, 96),
                    rng.integers(0, 1 << 18, 96),
                    rng.integers(0, 256, 96),
                    np.where(np.arange(96) == 0, int(i in syncs), 2),
                    timestamp=1000 * i,
                )
            )
        return frames
    starts = _angles(rng, m)
    for i in range(m):
        if ans_type == Ans.MEASUREMENT_CAPSULED:
            dist = rng.integers(0, 1 << 14, (16, 2)) << 2
            dist[rng.random((16, 2)) < 0.1] = 0
            fr = bytearray(
                wire.encode_capsule(
                    int(starts[i]), i in syncs, dist, rng.integers(0, 64, (16, 2))
                )
            )
        elif ans_type == Ans.MEASUREMENT_CAPSULED_ULTRA:
            fr = bytearray(
                wire.encode_ultra_capsule(
                    int(starts[i]),
                    i in syncs,
                    rng.integers(0, 4096, 32),
                    rng.integers(-512, 512, 32),
                    rng.integers(-512, 512, 32),
                )
            )
        elif ans_type == Ans.MEASUREMENT_DENSE_CAPSULED:
            fr = bytearray(
                wire.encode_dense_capsule(
                    int(starts[i]), i in syncs, rng.integers(0, 25000, 40)
                )
            )
        else:
            base = int(rng.integers(100, 2000))
            dmm = base + rng.integers(-2, 3, 64).cumsum() % 30000
            words = np.array(
                [
                    wire.ultra_dense_encode_sample(int(d), int(q))
                    for d, q in zip(dmm, rng.integers(0, 256, 64))
                ]
            )
            fr = bytearray(
                wire.encode_ultra_dense_capsule(int(starts[i]), i in syncs, words)
            )
        if i in corrupt:
            fr[20] ^= 0x3C
        frames.append(bytes(fr))
    return frames


def _scalar_nodes(ans_type: int, frames) -> list:
    """Expected flat node stream from the scalar golden decoders."""
    if ans_type == Ans.MEASUREMENT:
        return [n for f in frames if (n := unpack_ref.decode_normal_node(f))]
    if ans_type == Ans.MEASUREMENT_HQ:
        out = []
        for f in frames:
            nodes, _ts = unpack_ref.decode_hq_capsule(f)
            out.extend(nodes)
        return out
    dec = {
        Ans.MEASUREMENT_CAPSULED: unpack_ref.CapsuleDecoder,
        Ans.MEASUREMENT_CAPSULED_ULTRA: unpack_ref.UltraCapsuleDecoder,
        Ans.MEASUREMENT_DENSE_CAPSULED: unpack_ref.DenseCapsuleDecoder,
        Ans.MEASUREMENT_ULTRA_DENSE_CAPSULED: unpack_ref.UltraDenseCapsuleDecoder,
    }[ans_type]()
    out = []
    for f in frames:
        nodes, _ = dec.decode(f)
        out.extend(nodes)
    return out


def _drain_live(ans_type: int, frames, chunks_rng, timing=None):
    """Feed frames through BatchScanDecoder in random chunk sizes; return
    the raw-holder node stream (every emitted node, in order)."""
    holder = RawNodeHolder(capacity=1 << 20)
    dec = BatchScanDecoder(ScanAssembler(), holder)
    if timing is not None:
        dec.timing = timing
    i = 0
    t = 1000.0
    while i < len(frames):
        k = int(chunks_rng.integers(1, 8))
        batch = []
        for f in frames[i : i + k]:
            t += 0.002
            batch.append((f, t))
        dec.on_measurement_batch(ans_type, batch)
        i += k
    got = holder.fetch()
    return dec, (np.zeros((0, 4), np.int32) if got is None else got)


ALL_FORMATS = sorted(SAMPLES_PER_FRAME, key=int)


class TestChunkedLiveParity:
    @pytest.mark.parametrize("ans", ALL_FORMATS)
    def test_matches_scalar_stream(self, ans):
        rng = _rng()
        frames = _make_stream(ans, 40, rng, syncs=(0, 17))
        expected = _scalar_nodes(ans, frames)
        _, got = _drain_live(ans, frames, _rng())
        assert len(got) == len(expected), (len(got), len(expected))
        for k, n in enumerate(expected):
            assert got[k, 0] == n.angle_q14, (k, got[k, 0], n.angle_q14)
            assert got[k, 1] == n.dist_q2, (k, got[k, 1], n.dist_q2)
            assert got[k, 2] == n.quality, k
            assert got[k, 3] == n.flag, (k, got[k, 3], n.flag)

    @pytest.mark.parametrize(
        "ans",
        [
            Ans.MEASUREMENT_CAPSULED,
            Ans.MEASUREMENT_CAPSULED_ULTRA,
        ],
    )
    def test_corruption_isolated_to_adjacent_pairs(self, ans):
        """A corrupt frame must drop exactly the pairs it touches — same
        as the scalar decoders — even when the corruption lands next to a
        chunk boundary."""
        rng = _rng()
        frames = _make_stream(ans, 30, rng, syncs=(0,), corrupt=(9, 10, 21))
        expected = _scalar_nodes(ans, frames)
        _, got = _drain_live(ans, frames, _rng())
        assert len(got) == len(expected)
        assert np.array_equal(got[:, 0], [n.angle_q14 for n in expected])
        assert np.array_equal(got[:, 1], [n.dist_q2 for n in expected])

    def test_chunk_boundaries_do_not_matter(self):
        """Same stream, three different chunkings -> identical node stream
        (carries are exact at every boundary)."""
        rng = _rng()
        ans = Ans.MEASUREMENT_ULTRA_DENSE_CAPSULED
        frames = _make_stream(ans, 48, rng, syncs=(0, 20), corrupt=(13,))
        ref = None
        for seed in (1, 2, 3):
            _, got = _drain_live(ans, frames, np.random.default_rng(seed))
            if ref is None:
                ref = got
            else:
                assert np.array_equal(ref, got)

    def test_ans_type_change_resets_stream_state(self):
        holder = RawNodeHolder(capacity=1 << 20)
        dec = BatchScanDecoder(ScanAssembler(), holder)
        rng = _rng()
        caps = _make_stream(Ans.MEASUREMENT_CAPSULED, 6, rng)
        dec.on_measurement_batch(
            Ans.MEASUREMENT_CAPSULED, [(f, 1.0) for f in caps]
        )
        assert dec._prev is not None
        dense = _make_stream(Ans.MEASUREMENT_DENSE_CAPSULED, 6, rng)
        dec.on_measurement_batch(
            Ans.MEASUREMENT_DENSE_CAPSULED, [(f, 2.0) for f in dense]
        )
        # the capsule carry must not leak into the dense stream: output
        # equals a fresh dense-only scalar decode
        expected_dense = _scalar_nodes(Ans.MEASUREMENT_DENSE_CAPSULED, dense)
        got = holder.fetch()
        # first run produced capsule nodes; compare the dense tail
        tail = got[len(got) - len(expected_dense) :]
        assert np.array_equal(tail[:, 0], [n.angle_q14 for n in expected_dense])


class TestLiveTimestamps:
    def test_per_node_backdating_matches_delay_model(self):
        """Nodes of pair (prev, cur) are stamped cur_rx − delay(idx)."""
        ans = Ans.MEASUREMENT_CAPSULED
        rng = _rng()
        frames = _make_stream(ans, 2, rng, syncs=())
        pushed = {}

        class Tap(ScanAssembler):
            def push_nodes(self, angle, dist, quality, flag, ts=None):
                pushed["ts"] = np.asarray(ts)
                pushed["n"] = len(angle)
                return 0

        dec = BatchScanDecoder(Tap())
        timing = TimingDesc(sample_duration_us=65.0, native_baudrate=256000)
        dec.timing = timing
        rx = [100.0, 100.005]
        dec.on_measurement_batch(ans, list(zip(frames, rx)))
        assert pushed["n"] == 32
        for idx in range(32):
            expect = rx[1] - 1e-6 * sample_delay_us(ans, timing, idx)
            assert pushed["ts"][idx] == pytest.approx(expect, abs=1e-9)

    def test_hq_nodes_share_frame_stamp(self):
        """HQ/normal formats have no grouping delay: one stamp per frame."""
        ans = Ans.MEASUREMENT_HQ
        frames = _make_stream(ans, 3, _rng())
        seen = []

        class Tap(ScanAssembler):
            def push_nodes(self, angle, dist, quality, flag, ts=None):
                seen.append(np.asarray(ts))
                return 0

        dec = BatchScanDecoder(Tap())
        timing = TimingDesc(sample_duration_us=32.0, native_baudrate=1_000_000)
        dec.timing = timing
        rx = [50.0, 50.01, 50.02]
        dec.on_measurement_batch(ans, list(zip(frames, rx)))
        ts = np.concatenate(seen)
        assert ts.shape == (3 * 96,)
        d0 = 1e-6 * sample_delay_us(ans, timing, 0)
        for i in range(3):
            frame_ts = ts[i * 96 : (i + 1) * 96]
            assert np.all(frame_ts == frame_ts[0])
            assert frame_ts[0] == pytest.approx(rx[i] - d0, abs=1e-9)

    def test_multi_revolution_batch_gets_distinct_boundaries(self):
        """ADVICE r1: two syncs inside one pushed batch must yield two
        revolutions with their own begin timestamps and nonzero duration."""
        asm = ScanAssembler()
        n = 300
        flag = np.full(n, 2, np.int32)
        flag[0] = flag[100] = flag[200] = 1
        ts = 10.0 + 0.001 * np.arange(n)
        asm.push_nodes(
            ((np.arange(n) * 65536) // n).astype(np.int32),
            np.full(n, 4000, np.int32),
            np.full(n, 200, np.int32),
            flag,
            ts=ts,
        )
        got1 = asm.wait_and_grab_with_timestamp(0.1)
        assert got1 is not None
        _, ts0, dur = got1
        # newest-wins double buffer: the pending scan is the SECOND
        # revolution (100..200), with its own boundary stamps
        assert ts0 == pytest.approx(10.0 + 0.1)
        assert dur == pytest.approx(0.1)
        assert asm.scans_completed == 2
        assert asm.scans_dropped == 1


class TestLiveDecodeRate:
    def test_sustained_rate_beats_denseboost_3x(self):
        """VERDICT r1 done-criterion: live decode >= 3 x 32 kSa/s."""
        ans = Ans.MEASUREMENT_ULTRA_DENSE_CAPSULED
        rng = _rng()
        frames = _make_stream(ans, 512, rng, syncs=(0,))
        holder = RawNodeHolder(capacity=1 << 22)
        asm = ScanAssembler()
        dec = BatchScanDecoder(asm, holder)
        dec.precompile(ans)
        # feed in engine-sized runs (16 frames/run), timing like the pump
        run = 16
        t0 = time.perf_counter()
        t = 0.0
        for i in range(0, len(frames), run):
            batch = [(f, t + k * 0.002) for k, f in enumerate(frames[i : i + run])]
            t += run * 0.002
            dec.on_measurement_batch(ans, batch)
        dt = time.perf_counter() - t0
        rate = dec.nodes_decoded / dt
        assert dec.nodes_decoded > 30000
        assert rate >= 3 * 32000, f"live decode {rate:.0f} Sa/s < 96 kSa/s"


class TestOversizedRuns:
    @pytest.mark.parametrize(
        "ans", [Ans.MEASUREMENT, Ans.MEASUREMENT_ULTRA_DENSE_CAPSULED]
    )
    def test_runs_larger_than_biggest_bucket_decode_exactly(self, ans):
        """A run longer than _BUCKETS[-1] must decode in slices (carries
        make slicing exact), not crash or drop the run."""
        rng = _rng()
        frames = _make_stream(ans, 150, rng, syncs=(0, 70))
        expected = _scalar_nodes(ans, frames)
        holder = RawNodeHolder(capacity=1 << 20)
        dec = BatchScanDecoder(ScanAssembler(), holder)
        # ONE oversized delivery
        dec.on_measurement_batch(ans, [(f, 1.0 + 0.002 * i) for i, f in enumerate(frames)])
        got = holder.fetch()
        assert got is not None and len(got) == len(expected)
        assert np.array_equal(got[:, 0], [n.angle_q14 for n in expected])
        assert np.array_equal(got[:, 1], [n.dist_q2 for n in expected])


class TestRxThreadTimestamps:
    def test_native_rx_timestamps_preserve_interframe_spacing(self):
        """Frames queued by the native rx thread carry arrival stamps taken
        in the rx thread: draining them later (all at once) must still show
        the true spacing, not drain-time compression."""
        import socket
        import struct
        import threading
        import time as _time

        from rplidar_ros2_driver_tpu_torch.native.runtime import NativeChannel, NativeTransceiver

        hdr = b"\xa5\x5a" + struct.pack("<I", (5 & 0x3FFFFFFF) | (0x1 << 30)) + b"\x81"
        srv = socket.socket()
        srv.bind(("127.0.0.1", 0))
        srv.listen(1)
        port = srv.getsockname()[1]

        def server():
            conn, _ = srv.accept()
            with conn:
                conn.sendall(hdr)
                for i in range(4):
                    conn.sendall(bytes([i]) * 5)  # one 5-byte payload
                    _time.sleep(0.05)
                _time.sleep(0.3)

        t = threading.Thread(target=server, daemon=True)
        t.start()
        ch = NativeChannel("tcp", "127.0.0.1", port=port)
        tx = NativeTransceiver(ch)
        assert tx.start()
        _time.sleep(0.35)  # let all 4 frames arrive BEFORE we drain
        got = []
        while len(got) < 4:
            m = tx.wait_message_ts(timeout_ms=2000)
            assert m is not None
            got.append(m)
        tx.stop()
        srv.close()
        t.join(3)
        stamps = [ts for (_a, _p, _l, ts) in got]
        gaps = np.diff(stamps)
        # drained in one go, but the stamps keep the ~50 ms producer spacing
        assert np.all(gaps > 0.02), gaps
        # and they are CLOCK_MONOTONIC (comparable with time.monotonic())
        assert abs(stamps[-1] - _time.monotonic()) < 5.0


class TestHqCrcGate:
    def test_bad_crc_frame_dropped(self):
        frames = _make_stream(Ans.MEASUREMENT_HQ, 2, _rng())
        bad = bytearray(frames[1])
        bad[50] ^= 0xFF
        assert crcmod.crc32_padded(bytes(bad[:-4])) != int.from_bytes(bad[-4:], "little")
        _, got = _drain_live(Ans.MEASUREMENT_HQ, [frames[0], bytes(bad)], _rng())
        assert len(got) == 96  # only the intact frame's nodes

"""The PyTorch package's wire decoders against the JAX package's and the
scalar golden model, bit for bit.

Every field of ``DecodedNodes`` (values, shapes, int32/bool dtypes) must
equal the JAX decoder's on the same frames, and every node a valid pair
emits must equal the scalar reference decoder's (the JAX package's
``ops/unpack_ref.py``).  Fixtures mirror tests/test_unpack_golden.py:
corrupt frames, scan restarts, angle jumps, the ``last_sync_out`` /
``last_dist_q2`` carries, and u32 fields whose top byte is >= 0x80.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from rplidar_ros2_driver_tpu.ops import unpack as junpack
from rplidar_ros2_driver_tpu.ops import unpack_ref
from rplidar_ros2_driver_tpu_torch.ops import unpack as tunpack
from rplidar_ros2_driver_tpu_torch.ops import wire
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

# JAX's scans compiled whole, as its jitted decoders run them: one XLA
# program a shape, not one a primitive and shape (integer arithmetic: the
# same values as an eager call)
jsync_edge = jax.jit(junpack._sync_edge)
jud_smooth = jax.jit(junpack._ud_smooth)


def _rng(seed=1234):
    return np.random.default_rng(seed)


def _array(frames):
    return np.frombuffer(b"".join(frames), np.uint8).reshape(len(frames), -1)


def _angles(rng, m, step_q6=640):
    """Monotonic wrapped start angles with jitter, like a spinning head."""
    inc = rng.integers(step_q6 // 2, step_q6 * 2, m)
    return (np.cumsum(inc) + rng.integers(0, 360 << 6)) % (360 << 6)


def assert_same_as_jax(ours, theirs):
    for field in tunpack.DecodedNodes._fields:
        got = getattr(ours, field)
        want = np.asarray(getattr(theirs, field))
        assert isinstance(got, torch.Tensor), field
        got = got.numpy()
        assert got.dtype == want.dtype, (field, got.dtype, want.dtype)
        assert got.shape == want.shape, (field, got.shape, want.shape)
        np.testing.assert_array_equal(got, want, err_msg=field)


def assert_same_as_reference(dec, frames, decoder, npts):
    """Pair i of the batch decode against the nodes the stateful scalar
    decoder emitted when frame i+1 arrived."""
    per_frame = [decoder.decode(fr)[0] for fr in frames]
    angle, dist = dec.angle_q14.numpy(), dec.dist_q2.numpy()
    qual, flag, valid = dec.quality.numpy(), dec.flag.numpy(), dec.node_valid.numpy()
    for i in range(angle.shape[0]):
        ref = per_frame[i + 1]
        if not ref:
            assert not valid[i].any(), i
            continue
        assert valid[i].all() and len(ref) == npts, i
        for k, n in enumerate(ref):
            assert (angle[i, k], dist[i, k], qual[i, k], flag[i, k]) == (
                n.angle_q14, n.dist_q2, n.quality, n.flag), (i, k)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("width", [1, 2, 3, 7, 8, 82, 168])
def test_xor_reduce_matches_numpy(width):
    x = _rng(width).integers(0, 256, (5, width)).astype(np.int32)
    got = tunpack._xor_reduce(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.bitwise_xor.reduce(x, axis=1))


@pytest.mark.parametrize("carry", [0, 1])
def test_sync_edge_matches_the_scalar_recurrence(carry):
    s = (_rng(carry).random(400) < 0.4).astype(np.int32)
    s[:5] = 1  # a run at k=0 sees the carry
    want, last = [], carry
    for bit in s:
        o = bit & (1 - last)
        want.append(o)
        last = o
    got = tunpack._sync_edge(torch.from_numpy(s), carry).numpy()
    np.testing.assert_array_equal(got, np.array(want, np.int32))
    np.testing.assert_array_equal(
        got, np.asarray(jsync_edge(s, np.int32(carry)))
    )


def test_ud_smooth_matches_jax_scan():
    rng = _rng(9)
    d = (2000 + rng.integers(-6, 7, 300).cumsum()).astype(np.int32)
    sc = rng.integers(0, 2, 300).astype(np.int32) * (rng.random(300) < 0.2)
    sk = rng.random(300) < 0.1
    for last in (0, 2003):
        got = tunpack._ud_smooth(
            torch.from_numpy(d), torch.from_numpy(sc.astype(np.int32)), torch.from_numpy(sk), last
        ).numpy()
        want = np.asarray(jud_smooth(d, sc.astype(np.int32), sk, np.int32(last)))
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the six formats
# ---------------------------------------------------------------------------


def test_normal_nodes():
    rng = _rng()
    frames = [
        wire.encode_normal_node(int(rng.integers(0, 360 << 6)), int(rng.integers(0, 1 << 16)),
                                int(rng.integers(0, 64)), syncbit=(i % 37 == 0))
        for i in range(100)
    ]
    bad = bytearray(wire.encode_normal_node(100, 100, 10, False))
    bad[0] |= 0x3  # sync and inverse both set -> invalid
    frames.append(bytes(bad))
    arr = _array(frames)
    dec = tunpack.unpack_normal_nodes(arr)
    assert_same_as_jax(dec, junpack.unpack_normal_nodes(arr))
    for i, fr in enumerate(frames):
        ref = unpack_ref.decode_normal_node(fr)
        assert dec.node_valid[i, 0].item() == (ref is not None)
        if ref is not None:
            assert (dec.angle_q14[i, 0].item(), dec.dist_q2[i, 0].item(),
                    dec.quality[i, 0].item(), dec.flag[i, 0].item()) == (
                ref.angle_q14, ref.dist_q2, ref.quality, ref.flag)


def _capsule_stream(rng, m=24, corrupt=(), syncs=()):
    starts = _angles(rng, m)
    frames = []
    for i in range(m):
        dist = rng.integers(0, 1 << 14, (16, 2)) << 2
        dist[rng.random((16, 2)) < 0.1] = 0
        fr = bytearray(wire.encode_capsule(int(starts[i]), i in syncs, dist,
                                           rng.integers(0, 64, (16, 2))))
        if i in corrupt:
            fr[10] ^= 0xFF
        frames.append(bytes(fr))
    return frames


@pytest.mark.parametrize("corrupt,syncs", [((), (0,)), ((), (0, 7)), ((5,), (0,)), ((3, 4), (0, 9))])
def test_express_capsules(corrupt, syncs):
    frames = _capsule_stream(_rng(), corrupt=corrupt, syncs=syncs)
    arr = _array(frames)
    dec = tunpack.unpack_capsules(arr)
    assert_same_as_jax(dec, junpack.unpack_capsules(arr))
    assert_same_as_reference(dec, frames, unpack_ref.CapsuleDecoder(), 32)


def _ultra_stream(rng, m=16, syncs=(0,), corrupt=()):
    starts = _angles(rng, m, step_q6=1920)
    frames = []
    for i in range(m):
        # negative predict2 puts bytes >= 0x80 in the u32 cabin's top byte
        fr = bytearray(wire.encode_ultra_capsule(
            int(starts[i]), i in syncs, rng.integers(0, 4096, 32),
            rng.integers(-512, 512, 32), rng.integers(-512, 512, 32)))
        if i in corrupt:
            fr[40] ^= 0x55
        frames.append(bytes(fr))
    return frames


@pytest.mark.parametrize("corrupt,syncs", [((), (0,)), ((6,), (0, 11)), ((2,), (0,))])
def test_ultra_capsules(corrupt, syncs):
    frames = _ultra_stream(_rng(), corrupt=corrupt, syncs=syncs)
    arr = _array(frames)
    assert (arr[:, 7::4] >= 0x80).any()  # some top bytes set
    dec = tunpack.unpack_ultra_capsules(arr)
    assert_same_as_jax(dec, junpack.unpack_ultra_capsules(arr))
    assert_same_as_reference(dec, frames, unpack_ref.UltraCapsuleDecoder(), 96)


def _dense_stream(rng, m=24, syncs=(0,), corrupt=(), jump_at=None):
    starts = _angles(rng, m, step_q6=900)
    if jump_at is not None:
        starts[jump_at] = (starts[jump_at - 1] + (300 << 6)) % (360 << 6)
    frames = []
    for i in range(m):
        dist = rng.integers(0, 1 << 15, 40)
        dist[rng.random(40) < 0.05] = 0
        fr = bytearray(wire.encode_dense_capsule(int(starts[i]), i in syncs, dist))
        if i in corrupt:
            fr[30] ^= 0x0F
        frames.append(bytes(fr))
    return frames


@pytest.mark.parametrize(
    "corrupt,syncs,jump_at", [((), (0,), None), ((4,), (0, 13), None), ((), (0,), 8)]
)
def test_dense_capsules(corrupt, syncs, jump_at):
    frames = _dense_stream(_rng(), corrupt=corrupt, syncs=syncs, jump_at=jump_at)
    arr = _array(frames)
    dec = tunpack.unpack_dense_capsules(arr, 0, 476)
    assert_same_as_jax(dec, junpack.unpack_dense_capsules(arr, 0, 476))
    assert_same_as_reference(dec, frames, unpack_ref.DenseCapsuleDecoder(sample_duration_us=476), 40)


@pytest.mark.parametrize("last_sync_out,duration", [(1, 476), (0, 250), (1, 1000)])
def test_dense_capsules_carry_and_sample_duration(last_sync_out, duration):
    # a stream that starts inside the sync window, so the carry matters
    frames = _dense_stream(_rng(21), m=30, syncs=(0,), jump_at=12)
    arr = _array(frames)
    assert_same_as_jax(
        tunpack.unpack_dense_capsules(arr, last_sync_out, duration),
        junpack.unpack_dense_capsules(arr, last_sync_out, duration),
    )


def _ultra_dense_stream(rng, m=16, syncs=(0,), corrupt=()):
    starts = _angles(rng, m, step_q6=1200)
    frames = []
    for i in range(m):
        base = int(rng.integers(100, 2000))
        dmm = base + rng.integers(-2, 3, 64).cumsum() % 30000
        words = np.array([wire.ultra_dense_encode_sample(int(d), int(q))
                          for d, q in zip(dmm, rng.integers(0, 256, 64))])
        fr = bytearray(wire.encode_ultra_dense_capsule(int(starts[i]), i in syncs, words))
        if i in corrupt:
            fr[60] ^= 0xF0
        frames.append(bytes(fr))
    return frames


@pytest.mark.parametrize("corrupt,syncs", [((), (0,)), ((5,), (0, 9))])
def test_ultra_dense_capsules(corrupt, syncs):
    frames = _ultra_dense_stream(_rng(), corrupt=corrupt, syncs=syncs)
    arr = _array(frames)
    dec = tunpack.unpack_ultra_dense_capsules(arr, 0, 0, 476)
    assert_same_as_jax(dec, junpack.unpack_ultra_dense_capsules(arr, 0, 0, 476))
    assert_same_as_reference(
        dec, frames, unpack_ref.UltraDenseCapsuleDecoder(sample_duration_us=476), 64
    )


@pytest.mark.parametrize("last_sync_out,last_dist_q2", [(1, 0), (0, 4 * 150), (1, 4 * 1999)])
def test_ultra_dense_capsules_carries(last_sync_out, last_dist_q2):
    frames = _ultra_dense_stream(_rng(33), m=20, syncs=(0,), corrupt=(7,))
    arr = _array(frames)
    assert_same_as_jax(
        tunpack.unpack_ultra_dense_capsules(arr, last_sync_out, last_dist_q2, 476),
        junpack.unpack_ultra_dense_capsules(arr, last_sync_out, last_dist_q2, 476),
    )


def _hq_frames(rng, n=8):
    frames = []
    for i in range(n):
        frames.append(wire.encode_hq_capsule(
            rng.integers(0, 1 << 16, 96),
            rng.integers(0, 1 << 32, 96),  # dist bytes >= 0x80: negative int32
            rng.integers(0, 256, 96),
            np.where(np.arange(96) == 0, i % 2, 2),
            timestamp=1000 * i,
        ))
    return frames


def test_hq_capsules():
    frames = _hq_frames(_rng())
    bad = bytearray(frames[3])
    bad[100] ^= 1  # CRC mismatch
    frames[3] = bytes(bad)
    nosync = bytearray(frames[5])
    nosync[0] = 0x00
    frames[5] = bytes(nosync)
    arr = _array(frames)
    crc_ok = np.array([bool(unpack_ref.decode_hq_capsule(fr)[0]) for fr in frames])
    assert not crc_ok[3] and not crc_ok[5]
    for verdict in (None, crc_ok):
        dec = tunpack.unpack_hq_capsules(arr, verdict)
        assert_same_as_jax(dec, junpack.unpack_hq_capsules(arr, verdict))
    assert (dec.dist_q2.numpy() < 0).any()  # the u32 wrap is exercised
    for i, fr in enumerate(frames):
        nodes, _ = unpack_ref.decode_hq_capsule(fr)
        assert dec.node_valid[i].all().item() == bool(nodes)
        for k, n in enumerate(nodes):
            assert (dec.angle_q14[i, k].item(), dec.dist_q2[i, k].item(),
                    dec.quality[i, k].item(), dec.flag[i, k].item()) == (
                n.angle_q14, np.int32(np.uint32(n.dist_q2)), n.quality, n.flag)


def test_hq_crc_verdicts_may_be_a_tensor():
    arr = _array(_hq_frames(_rng(2), 3))
    ok = torch.tensor([True, False, True])
    dec = tunpack.unpack_hq_capsules(torch.from_numpy(arr.copy()), ok)
    np.testing.assert_array_equal(dec.frame_valid.numpy(), [True, False, True])


class TestSyncEdgeDivergence:
    """The streams of tests/test_unpack_golden.py engineered so the
    revolution wrap lands across a dropped capsule: the port equals JAX
    exactly, including the one re-fired flag the batch decoders allow."""

    M, J = 12, 6

    def _starts(self):
        j = self.J
        starts = []
        for i in range(self.M):
            if i < j - 1:
                starts.append(22145 - 900 * (j - 2) + 900 * i)
            elif i <= j + 1:
                starts.append(5 + 2 * (i - (j - 1)))
            else:
                starts.append(909 + 900 * (i - j - 1))
        return [s % (360 << 6) for s in starts]

    @pytest.mark.parametrize("corrupt", [(), (6,)])
    def test_dense(self, corrupt):
        rng = _rng()
        frames = []
        for i, s in enumerate(self._starts()):
            fr = bytearray(wire.encode_dense_capsule(int(s), i == 0, rng.integers(1, 1 << 15, 40)))
            if i in corrupt:
                fr[30] ^= 0x0F
            frames.append(bytes(fr))
        arr = _array(frames)
        dec = tunpack.unpack_dense_capsules(arr, 0, 476)
        assert_same_as_jax(dec, junpack.unpack_dense_capsules(arr, 0, 476))
        if not corrupt:
            assert_same_as_reference(
                dec, frames, unpack_ref.DenseCapsuleDecoder(sample_duration_us=476), 40
            )

    @pytest.mark.parametrize("corrupt", [(), (6,)])
    def test_ultra_dense(self, corrupt):
        rng = _rng()
        frames = []
        for i, s in enumerate(self._starts()):
            words = np.array([wire.ultra_dense_encode_sample(int(d), int(q))
                              for d, q in zip(rng.integers(100, 2000, 64),
                                              rng.integers(0, 256, 64))])
            fr = bytearray(wire.encode_ultra_dense_capsule(s, i == 0, words))
            if i in corrupt:
                fr[60] ^= 0xF0
            frames.append(bytes(fr))
        arr = _array(frames)
        assert_same_as_jax(
            tunpack.unpack_ultra_dense_capsules(arr, 0, 0, 476),
            junpack.unpack_ultra_dense_capsules(arr, 0, 0, 476),
        )


@pytest.mark.parametrize(
    "decode,width",
    [
        (tunpack.unpack_capsules, 84),
        (tunpack.unpack_ultra_capsules, 132),
        (tunpack.unpack_dense_capsules, 84),
        (tunpack.unpack_ultra_dense_capsules, 170),
    ],
)
def test_single_frame_gives_no_pairs_and_wrong_width_raises(decode, width):
    frame = np.zeros((1, width), np.uint8)
    dec = decode(frame)
    assert dec.angle_q14.shape[0] == 0 and dec.frame_valid.shape == (1,)
    with pytest.raises(ValueError, match="bytes"):
        decode(np.zeros((2, width + 1), np.uint8))


def test_the_encoders_are_the_jax_packages():
    """ops/wire.py is a copy: the same arguments give the same bytes."""
    from rplidar_ros2_driver_tpu.ops import wire as jwire

    rng = _rng(4)
    dist = rng.integers(0, 1 << 14, (16, 2)) << 2
    off = rng.integers(0, 64, (16, 2))
    assert wire.encode_capsule(1234, True, dist, off) == jwire.encode_capsule(1234, True, dist, off)
    d40 = rng.integers(0, 1 << 15, 40)
    assert wire.encode_dense_capsule(77, False, d40) == jwire.encode_dense_capsule(77, False, d40)
    args = (5000, False, rng.integers(0, 4096, 32), rng.integers(-512, 512, 32),
            rng.integers(-512, 512, 32))
    assert wire.encode_ultra_capsule(*args) == jwire.encode_ultra_capsule(*args)
    words = np.array([wire.ultra_dense_encode_sample(d, 9) for d in (100, 3000, 9000, 30000)] * 16)
    assert wire.encode_ultra_dense_capsule(9, True, words) == jwire.encode_ultra_dense_capsule(
        9, True, words)
    hq = (rng.integers(0, 1 << 16, 96), rng.integers(0, 1 << 32, 96), rng.integers(0, 256, 96),
          rng.integers(0, 256, 96))
    assert wire.encode_hq_capsule(*hq, timestamp=5) == jwire.encode_hq_capsule(*hq, timestamp=5)
    assert wire.encode_normal_node(3, 4, 5, True) == jwire.encode_normal_node(3, 4, 5, True)

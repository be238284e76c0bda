"""Vectorized decoders for the six measurement wire formats, in PyTorch.

The counterpart of the JAX package's ``ops/unpack.py``, held to it and to
the scalar golden model (its ``ops/unpack_ref.py``) bit for bit by
tests/test_torch_unpack.py.  Every capsule format except HQ is sequential
only through the previous-capsule angle interpolation, so a batch of M
consecutive capsule frames decodes as M-1 independent (prev, cur) pairs:
branch-free int32 math over cabins, on the device of the ``frames``
tensor the caller passes (a numpy array decodes on the CPU).

int32 semantics that must match JAX: ``//`` and ``%`` floor (``torch.div``
with ``rounding_mode="floor"``, ``torch.remainder``), ``>>`` is arithmetic,
and a byte shifted left by 24 wraps to a negative int32 (the little-endian
u32 fields: only the bit pattern is consumed).

The two sequential recurrences:
  * dense / ultra-dense sync-edge detection runs in closed form
    (:func:`_sync_edge`, a running maximum via ``torch.cummax``);
  * the ultra-dense +/-2 mm smoothing (:func:`_ud_smooth`) is a genuine
    recurrence.  As per-element device operations it would be hundreds of
    thousands of launches, so it runs as ONE host loop over the int32
    sample stream, the same on every device (on CUDA its inputs come to
    the host and its output goes back: one synchronisation per call,
    declared with ``guards.declared_sync``).  Only the UltraDense format
    (0x86) reaches it.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from rplidar_ros2_driver_tpu_torch.core.qmath import FULL_TURN_Q16, wrap_angle_q6
from rplidar_ros2_driver_tpu_torch.protocol.constants import (
    CAPSULE_BYTES,
    DENSE_CAPSULE_BYTES,
    EXP_SYNC_1,
    EXP_SYNC_2,
    HQ_CAPSULE_BYTES,
    HQ_NODES_PER_CAPSULE,
    ULTRA_CAPSULE_BYTES,
    ULTRA_DENSE_CAPSULE_BYTES,
    VARBITSCALE_X2_DEST_VAL,
    VARBITSCALE_X2_SRC_BIT,
    VARBITSCALE_X4_DEST_VAL,
    VARBITSCALE_X4_SRC_BIT,
    VARBITSCALE_X8_DEST_VAL,
    VARBITSCALE_X8_SRC_BIT,
    VARBITSCALE_X16_DEST_VAL,
    VARBITSCALE_X16_SRC_BIT,
)
from rplidar_ros2_driver_tpu_torch.utils import guards

_QUAL_VALID = 0x2F << 2  # synthetic quality for formats without one
_I32 = torch.int32


class DecodedNodes(NamedTuple):
    """SoA decode result.  Shapes: (pairs, points) unless noted."""

    angle_q14: torch.Tensor   # int32
    dist_q2: torch.Tensor     # int32
    quality: torch.Tensor     # int32
    flag: torch.Tensor        # int32 (bit0 sync, bit1 = !sync)
    node_valid: torch.Tensor  # bool — node comes from a valid frame pair
    new_scan: torch.Tensor    # bool (M,) — frame i carries the EXP sync bit
    frame_valid: torch.Tensor  # bool (M,) — sync nibbles + checksum OK


# ---------------------------------------------------------------------------
# byte-array field helpers (frames arrive as uint8 (M, B) -> int32)
# ---------------------------------------------------------------------------


def _floordiv(a: torch.Tensor, d: int) -> torch.Tensor:
    return torch.div(a, d, rounding_mode="floor")


def _u16(f: torch.Tensor, off) -> torch.Tensor:
    # ``off``: a byte offset, or a tensor of them (one field per cabin)
    return f[:, off] | (f[:, off + 1] << 8)


def _u32(f: torch.Tensor, off) -> torch.Tensor:
    # graftlint: disable=GL011 — little-endian u32 assembly: byte<<24
    # wraps int32 by design, consumers read the bit pattern only
    return f[:, off] | (f[:, off + 1] << 8) | (f[:, off + 2] << 16) | (f[:, off + 3] << 24)


def _xor_reduce(x: torch.Tensor) -> torch.Tensor:
    """XOR of the columns of (M, C): PyTorch has no XOR reduction, so the
    columns fold in halves (XOR is associative and commutative, so any
    order gives the same bits)."""
    while x.shape[1] > 1:
        half = x.shape[1] // 2
        folded = x[:, :half] ^ x[:, half : 2 * half]
        x = torch.cat([folded, x[:, 2 * half :]], dim=1) if x.shape[1] % 2 else folded
    return x[:, 0]


def _capsule_frame_valid(frames: torch.Tensor, payload_from: int = 2) -> torch.Tensor:
    """Express-style validity: sync nibbles 0xA/0x5 + split XOR checksum
    (handler_capsules.cpp:107-155)."""
    sync_ok = ((frames[:, 0] >> 4) == EXP_SYNC_1) & ((frames[:, 1] >> 4) == EXP_SYNC_2)
    recv = (frames[:, 0] & 0xF) | ((frames[:, 1] & 0xF) << 4)
    calc = _xor_reduce(frames[:, payload_from:])
    return sync_ok & (recv == calc)


def _asi32(frames) -> torch.Tensor:
    if not isinstance(frames, torch.Tensor):
        # a read-only buffer (np.frombuffer) is copied: torch wants writable memory
        frames = torch.from_numpy(np.require(frames, requirements="W"))
    return frames if frames.dtype == _I32 else frames.to(_I32)


def _iota(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, dtype=_I32, device=like.device)


def _pair_diff(start_q6: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Shared (prev, cur) start-angle geometry of consecutive capsule
    frames: (base_q16, diff_q8) for each of the M-1 pairs — the previous
    frame's start angle in Q16 degrees and the pair's angular span in Q8
    degrees, wrapped to one positive turn."""
    cur_q8 = (start_q6[1:] & 0x7FFF) << 2
    prev_q8 = (start_q6[:-1] & 0x7FFF) << 2
    diff_q8 = cur_q8 - prev_q8
    diff_q8 = torch.where(prev_q8 > cur_q8, diff_q8 + (360 << 8), diff_q8)
    return prev_q8 << 8, diff_q8


def _express_increment(diff_q8: torch.Tensor) -> torch.Tensor:
    """Express capsule: 32 samples/pair (handler_capsules.cpp:206-266)."""
    return diff_q8 << 3


def _ultra_increment(diff_q8: torch.Tensor) -> torch.Tensor:
    """Ultra capsule: 96 samples/pair (handler_capsules.cpp:522-529)."""
    return _floordiv(diff_q8 << 3, 3)


def _dense_increment(diff_q8: torch.Tensor) -> torch.Tensor:
    """Dense capsule: 40 samples/pair (handler_capsules.cpp:741-760)."""
    return _floordiv(diff_q8 << 8, 40)


def _ultra_dense_increment(diff_q8: torch.Tensor) -> torch.Tensor:
    """Ultra-dense (DenseBoost) capsule: 64 samples/pair
    (handler_capsules.cpp:949-989)."""
    return _floordiv(diff_q8 << 8, 64)


def _sample_angles(base_q16: torch.Tensor, inc_q16: torch.Tensor, npts: int) -> torch.Tensor:
    """angle_raw at each sample k of each pair."""
    k = _iota(npts, base_q16)
    return base_q16[:, None] + k[None, :] * inc_q16[:, None]


def _sync_raw(raw: torch.Tensor, inc_q16: torch.Tensor, width_shift: int) -> torch.Tensor:
    """Raw sync predicate: the sample lands within ``inc << width_shift``
    past the full-turn wrap."""
    inc = inc_q16[:, None]
    return (torch.remainder(raw + inc, FULL_TURN_Q16) < (inc << width_shift)).to(_I32)


def _flag(sync: torch.Tensor) -> torch.Tensor:
    return sync | ((sync == 0).to(_I32) << 1)


def _finish_nodes(angle_q6, dist_q2, sync):
    angle_q14 = _floordiv(wrap_angle_q6(angle_q6) << 8, 90)
    quality = torch.where(dist_q2 != 0, _QUAL_VALID, 0).to(_I32)
    return angle_q14, quality, _flag(sync)


def _pair_mask(pair_valid: torch.Tensor, npts: int) -> torch.Tensor:
    return pair_valid[:, None].expand(pair_valid.shape[0], npts).contiguous()


# ---------------------------------------------------------------------------
# Normal (legacy) 5-byte nodes
# ---------------------------------------------------------------------------


def unpack_normal_nodes(frames) -> DecodedNodes:
    """Decode (M, 5) legacy nodes (handler_normalnode.cpp:87-133).

    Each frame is independent; ``node_valid`` folds the sync/inverse-sync
    and angle check bits."""
    f = _asi32(frames)
    b0 = f[:, 0]
    sync_ok = (((b0 >> 1) ^ b0) & 0x1) == 1
    angle_field = _u16(f, 1)
    valid = sync_ok & ((angle_field & 0x1) == 1)
    sync = b0 & 0x1
    return DecodedNodes(
        angle_q14=_floordiv((angle_field >> 1) << 8, 90)[:, None],
        dist_q2=_u16(f, 3)[:, None],
        quality=((b0 >> 2) << 2)[:, None],
        flag=sync[:, None],  # legacy path publishes the raw sync bit as the flag
        node_valid=valid[:, None],
        new_scan=sync.bool(),
        frame_valid=valid,
    )


# ---------------------------------------------------------------------------
# Express capsule: 16 cabins x 2 points  (handler_capsules.cpp:206-266)
# ---------------------------------------------------------------------------


def unpack_capsules(frames) -> DecodedNodes:
    """Decode (M, 84) express capsules into (M-1, 32) nodes."""
    f = _asi32(frames)
    if f.shape[1] != CAPSULE_BYTES:
        raise ValueError(f"express capsules are {CAPSULE_BYTES} bytes, got {f.shape[1]}")
    frame_valid = _capsule_frame_valid(f)
    start_q6 = _u16(f, 2)
    new_scan = ((start_q6 & 0x8000) != 0) & frame_valid

    base_q16, diff_q8 = _pair_diff(start_q6)
    inc_q16 = _express_increment(diff_q8)
    raw = _sample_angles(base_q16, inc_q16, 32)  # (M-1, 32)

    # cabin fields from the PREV frame of each pair
    p = f[:-1]
    m = p.shape[0]
    cab_off = 4 + 5 * _iota(16, f)
    da1 = _u16(p, cab_off)
    da2 = _u16(p, cab_off + 2)
    packed = p[:, cab_off + 4]
    dist = torch.stack([da1 & 0xFFFC, da2 & 0xFFFC], -1).reshape(m, 32)
    off_q3 = torch.stack(
        [(packed & 0xF) | ((da1 & 0x3) << 4), (packed >> 4) | ((da2 & 0x3) << 4)], -1
    ).reshape(m, 32)

    angle_q6 = (raw - (off_q3 << 13)) >> 10
    sync = _sync_raw(raw, inc_q16, 0)
    angle_q14, quality, flag = _finish_nodes(angle_q6, dist, sync)

    pair_valid = frame_valid[:-1] & frame_valid[1:] & ~new_scan[1:]
    return DecodedNodes(
        angle_q14, dist, quality, flag, _pair_mask(pair_valid, 32), new_scan, frame_valid
    )


# ---------------------------------------------------------------------------
# Ultra capsule: varbitscale, 32 cabins x 3 points
# ---------------------------------------------------------------------------

# Branch-free varbitscale decode (handler_capsules.cpp:422-458): pick the
# largest base <= scaled.
_VBS_SCALED = np.array(
    [0, VARBITSCALE_X2_DEST_VAL, VARBITSCALE_X4_DEST_VAL, VARBITSCALE_X8_DEST_VAL,
     VARBITSCALE_X16_DEST_VAL], np.int32)
_VBS_TARGET = np.array(
    [0, 1 << VARBITSCALE_X2_SRC_BIT, 1 << VARBITSCALE_X4_SRC_BIT,
     1 << VARBITSCALE_X8_SRC_BIT, 1 << VARBITSCALE_X16_SRC_BIT], np.int32)


_TABLES: dict = {}


def _table(values: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """One of this module's constant tables on ``like``'s device, uploaded
    once per device: an upload per call would synchronise the stream."""
    key = (id(values), like.device)
    cached = _TABLES.get(key)
    if cached is None:
        cached = _TABLES[key] = torch.from_numpy(values).to(like.device)
    return cached


def _varbitscale_decode(scaled: torch.Tensor):
    vbs_scaled = _table(_VBS_SCALED, scaled)
    lvl = ((scaled[..., None] >= vbs_scaled).sum(-1) - 1).to(_I32)
    idx = lvl.long()
    # graftlint: disable=GL011 — lvl in [0, 4] by construction (sum over
    # the 5-entry threshold axis), so the shift is <= 4 bits on a 12-bit
    # residual; the interpreter over-approximates the axis sum
    value = _table(_VBS_TARGET, scaled)[idx] + ((scaled - vbs_scaled[idx]) << lvl)
    return value, lvl


def _build_ultra_corr_lut() -> np.ndarray:
    """k2 -> int(offsetAngleMean_q16 * 180 / pi) lookup.

    The C path (handler_capsules.cpp:547-557) computes the correction in
    double; k2 = 98361 // dist_q2 <= 491 for dist_q2 >= 200, so the whole
    function is a 492-entry table evaluated here in float64."""
    base = int(8 * 3.1415926535 * (1 << 16) / 180)
    k2 = np.arange(492, dtype=np.int64)
    off = base - (k2 << 6) - (k2 * k2 * k2) // 98304
    return np.trunc(off.astype(np.float64) * 180 / 3.14159265).astype(np.int32)


_ULTRA_CORR_LUT = _build_ultra_corr_lut()
_ULTRA_CORR_DEFAULT = int(
    np.trunc(int(7.5 * 3.1415926535 * (1 << 16) / 180.0) * 180 / 3.14159265)
)


def unpack_ultra_capsules(frames) -> DecodedNodes:
    """Decode (M, 132) ultra capsules into (M-1, 96) nodes."""
    f = _asi32(frames)
    if f.shape[1] != ULTRA_CAPSULE_BYTES:
        raise ValueError(f"ultra capsules are {ULTRA_CAPSULE_BYTES} bytes, got {f.shape[1]}")
    frame_valid = _capsule_frame_valid(f)
    start_q6 = _u16(f, 2)
    new_scan = ((start_q6 & 0x8000) != 0) & frame_valid

    base_q16, diff_q8 = _pair_diff(start_q6)
    inc_q16 = _ultra_increment(diff_q8)
    raw = _sample_angles(base_q16, inc_q16, 96)  # (M-1, 96)

    p = f[:-1]
    m = p.shape[0]
    cab_off = 4 + 4 * _iota(32, f)
    w = _u32(p, cab_off)  # may be "negative": the bit pattern is what matters
    major_raw = w & 0xFFF
    # graftlint: disable=GL011 — (w<<10)>>22 is the sign-extending field
    # extract from the C decoder: the left shift wraps deliberately so
    # the arithmetic right shift reproduces the 10-bit two's complement
    predict1 = (w << 10) >> 22
    predict2 = w >> 22
    # next cabin's major: shift within frame; last cabin takes cabin 0 of cur
    next_first = _u32(f, 4)[1:] & 0xFFF
    next_raw = torch.cat([major_raw[:, 1:], next_first[:, None]], dim=1)

    major, lvl1 = _varbitscale_decode(major_raw)
    major2, lvl2 = _varbitscale_decode(next_raw)
    swap = (major == 0) & (major2 != 0)
    base1 = torch.where(swap, major2, major)
    lvl1 = torch.where(swap, lvl2, lvl1)

    zero = torch.zeros((), dtype=_I32, device=f.device)
    d0 = major << 2
    inval1 = (predict1 == -512) | (predict1 == 511)
    # graftlint: disable=GL011 — predict is a 10-bit two's-complement
    # field (|predict| <= 512) and lvl <= 4 by varbitscale construction:
    # (512<<4 + 28656) << 2 < 2^18, but the interpreter cannot see the
    # data-dependent lvl cap
    d1 = torch.where(inval1, zero, ((predict1 << lvl1) + base1) << 2)
    inval2 = (predict2 == -512) | (predict2 == 511)
    # graftlint: disable=GL011 — same 10-bit predict / lvl<=4 argument
    d2 = torch.where(inval2, zero, ((predict2 << lvl2) + major2) << 2)
    # graftlint: disable=GL011 — |dist| <= (512<<4 + 28656) << 2 < 2^18
    # by the predict/varbitscale widths above; clipping here would break
    # bit-parity with unpack_ref.UltraCapsuleDecoder on garbage cabins
    dist = torch.stack([d0, d1, d2], -1).reshape(m, 96)

    k2 = torch.div(
        torch.full((), 98361, dtype=_I32, device=f.device),
        dist.clamp(min=1),
        rounding_mode="floor",
    )
    corr = torch.where(
        dist >= 200,
        _table(_ULTRA_CORR_LUT, f)[k2.clamp(0, 491).long()],
        torch.full((), _ULTRA_CORR_DEFAULT, dtype=_I32, device=f.device),
    )
    angle_q6 = (raw - corr) >> 10
    sync = _sync_raw(raw, inc_q16, 0)
    angle_q14, quality, flag = _finish_nodes(angle_q6, dist, sync)

    pair_valid = frame_valid[:-1] & frame_valid[1:] & ~new_scan[1:]
    return DecodedNodes(
        angle_q14, dist, quality, flag, _pair_mask(pair_valid, 96), new_scan, frame_valid
    )


# ---------------------------------------------------------------------------
# Sync-edge recurrence  o_k = s_k & ~o_{k-1}  in closed form
# ---------------------------------------------------------------------------


def _sync_edge(s: torch.Tensor, carry) -> torch.Tensor:
    """Parallel form of the reference's rising-edge filter
    (``syncBit = (syncBit ^ last) & syncBit``, handler_capsules.cpp:766-767).

    Within a run of raw sync bits the output alternates starting with 1, so
    o_k = s_k & odd(k - last_zero_index); ``carry`` is o_{-1} from the
    previous batch (affects only a run that starts at k=0)."""
    if s.shape[0] == 0:
        return s
    idx = _iota(s.shape[0], s)
    zpos = torch.where(s == 0, idx, torch.full_like(idx, -1))
    last_zero = torch.cummax(zpos, dim=0).values
    adj = torch.where(
        last_zero == -1, torch.as_tensor(carry, device=s.device).to(_I32), 0
    ).to(_I32)
    return s & ((idx - last_zero + adj) & 1)


# ---------------------------------------------------------------------------
# Dense capsule: 40 raw u16 distances
# ---------------------------------------------------------------------------


def unpack_dense_capsules(frames, last_sync_out=0, sample_duration_us: int = 476) -> DecodedNodes:
    """Decode (M, 84) dense capsules into (M-1, 40) nodes.

    ``last_sync_out`` carries the sync edge detector across batches.
    Pairs whose start-angle jump exceeds the 100 Hz threshold are masked
    (the reference discards them, handler_capsules.cpp:750-754)."""
    f = _asi32(frames)
    if f.shape[1] != DENSE_CAPSULE_BYTES:
        raise ValueError(f"dense capsules are {DENSE_CAPSULE_BYTES} bytes, got {f.shape[1]}")
    frame_valid = _capsule_frame_valid(f)
    start_q6 = _u16(f, 2)
    new_scan = ((start_q6 & 0x8000) != 0) & frame_valid

    base_q16, diff_q8 = _pair_diff(start_q6)
    inc_q16 = _dense_increment(diff_q8)
    max_diff_q8 = (360 * 100 * 40 // (1000000 // sample_duration_us)) << 8
    jump_ok = diff_q8 <= max_diff_q8

    raw = _sample_angles(base_q16, inc_q16, 40)
    p = f[:-1]
    off = 4 + 2 * _iota(40, f)
    dist = _u16(p, off) << 2

    pair_valid = frame_valid[:-1] & frame_valid[1:] & ~new_scan[1:] & jump_ok
    angle_q6 = raw >> 10
    # samples of discarded pairs never reach the reference's edge filter;
    # zeroing them keeps the carry chain aligned (the JAX package pins the
    # <= 1 flag per dropped frame divergence this allows)
    s_raw = _sync_raw(raw, inc_q16, 1) * pair_valid[:, None].to(_I32)
    sync = _sync_edge(s_raw.reshape(-1), last_sync_out).reshape(s_raw.shape)
    angle_q14, quality, flag = _finish_nodes(angle_q6, dist, sync)
    return DecodedNodes(
        angle_q14, dist, quality, flag, _pair_mask(pair_valid, 40), new_scan, frame_valid
    )


# ---------------------------------------------------------------------------
# Ultra-dense capsule (DenseBoost): 32 cabins x 2 points, 20-bit words
# ---------------------------------------------------------------------------

_UD_T1, _UD_T2, _UD_T3 = 2046, 8187, 24567


def _select(scale: torch.Tensor, choices: list[torch.Tensor]) -> torch.Tensor:
    """``jnp.select`` on the 2-bit scale: choices[s] where scale == s
    (the last choice is the default)."""
    out = choices[-1]
    for s in range(len(choices) - 2, -1, -1):
        out = torch.where(scale == s, choices[s], out)
    return out


def _ud_decode_words(w20: torch.Tensor):
    """(raw dist_q2, quality) from 20-bit words — branchless 4-level scale
    (handler_capsules.cpp:991-1017)."""
    scale = w20 & 0x3
    dist = _select(scale, [
        (w20 & 0xFFC) * 2,
        (w20 & 0x1FFC) * 3 + (_UD_T1 << 2),
        (w20 & 0x3FFC) * 4 + (_UD_T2 << 2),
        (w20 & 0x7FFC) * 5 + (_UD_T3 << 2),
    ])
    qual = _select(scale, [
        w20 >> 12,
        ((w20 >> 13) << 1) & 0xFF,
        ((w20 >> 14) << 2) & 0xFF,
        ((w20 >> 15) << 3) & 0xFF,
    ])
    return dist, qual, scale


def _ud_smooth(
    dist_raw: torch.Tensor, scale: torch.Tensor, skip: torch.Tensor, last_dist
) -> torch.Tensor:
    """Exact +/-2 mm temporal smoothing (sequential; scale-0 samples only).

    o_k = (d_k + o_{k-1}) >> 1  when scale_k == 0, o_{k-1} != 0 and
    |d_k - o_{k-1}| <= 8, else d_k.  ``skip`` marks samples of discarded
    pairs: they pass through without touching the carry (the reference
    never sees them).  One host loop over the flattened stream (see the
    module note), in Python ints: every value stays far inside int32.
    ``last_dist`` is an int or a 0-d tensor (the fused step's carry); the
    reads of the inputs and the carry are the call's declared
    synchronisation."""
    with guards.declared_sync():
        d = dist_raw.cpu().tolist()
        sc = scale.cpu().tolist()
        sk = skip.cpu().tolist()
        carry = int(last_dist)
    out = [0] * len(d)
    for k, dk in enumerate(d):
        o = (dk + carry) >> 1 if sc[k] == 0 and carry != 0 and abs(dk - carry) <= 8 else dk
        out[k] = o
        if not sk[k]:
            carry = o
    return torch.tensor(out, dtype=_I32).to(dist_raw.device)


def unpack_ultra_dense_capsules(
    frames, last_sync_out=0, last_dist_q2=0, sample_duration_us: int = 476
) -> DecodedNodes:
    """Decode (M, 170) ultra-dense capsules into (M-1, 64) nodes."""
    f = _asi32(frames)
    if f.shape[1] != ULTRA_DENSE_CAPSULE_BYTES:
        raise ValueError(
            f"ultra-dense capsules are {ULTRA_DENSE_CAPSULE_BYTES} bytes, got {f.shape[1]}"
        )
    frame_valid = _capsule_frame_valid(f, payload_from=2)
    start_q6 = _u16(f, 8)
    new_scan = ((start_q6 & 0x8000) != 0) & frame_valid

    base_q16, diff_q8 = _pair_diff(start_q6)
    inc_q16 = _ultra_dense_increment(diff_q8)
    max_diff_q8 = (360 * 100 * 32 // (1000000 // sample_duration_us)) << 8
    jump_ok = diff_q8 <= max_diff_q8
    pair_valid = frame_valid[:-1] & frame_valid[1:] & ~new_scan[1:] & jump_ok

    raw = _sample_angles(base_q16, inc_q16, 64)
    p = f[:-1]
    m = p.shape[0]
    cab_off = 10 + 5 * _iota(32, f)
    w0 = _u16(p, cab_off) | ((p[:, cab_off + 4] & 0x0F) << 16)
    w1 = _u16(p, cab_off + 2) | ((p[:, cab_off + 4] >> 4) << 16)
    words = torch.stack([w0, w1], -1).reshape(m, 64)

    dist_raw, quality, scale = _ud_decode_words(words)
    skip = ~_pair_mask(pair_valid, 64)
    dist = _ud_smooth(
        dist_raw.reshape(-1), scale.reshape(-1), skip.reshape(-1), last_dist_q2
    ).reshape(dist_raw.shape)

    s_raw = _sync_raw(raw, inc_q16, 1) * pair_valid[:, None].to(_I32)
    sync = _sync_edge(s_raw.reshape(-1), last_sync_out).reshape(s_raw.shape)
    angle_q14 = _floordiv(wrap_angle_q6(raw >> 10) << 8, 90)
    return DecodedNodes(
        angle_q14, dist, quality, _flag(sync), _pair_mask(pair_valid, 64), new_scan,
        frame_valid,
    )


# ---------------------------------------------------------------------------
# HQ capsule: 96 pre-formatted nodes (CRC checked host-side)
# ---------------------------------------------------------------------------


def unpack_hq_capsules(frames, crc_ok=None) -> DecodedNodes:
    """Decode (M, 777) HQ capsules into (M, 96) nodes.

    CRC32 runs on the host (protocol/crc.py) — pass the per-frame verdicts
    in ``crc_ok``; the decoder itself only checks the 0xA5 sync byte."""
    f = _asi32(frames)
    if f.shape[1] != HQ_CAPSULE_BYTES:
        raise ValueError(f"HQ capsules are {HQ_CAPSULE_BYTES} bytes, got {f.shape[1]}")
    sync_ok = f[:, 0] == 0xA5
    if crc_ok is None:
        frame_valid = sync_ok
    else:
        frame_valid = sync_ok & torch.as_tensor(crc_ok, dtype=torch.bool, device=f.device)
    off = 9 + 8 * _iota(HQ_NODES_PER_CAPSULE, f)
    angle_q14 = _u16(f, off)
    # graftlint: disable=GL011 — u32 dist field assembly: byte<<24 wraps
    # int32 by design (the wire field is 32-bit little-endian)
    dist = _u32(f, off + 2)
    flag = f[:, off + 7]
    return DecodedNodes(
        angle_q14, dist, f[:, off + 6], flag,
        _pair_mask(frame_valid, HQ_NODES_PER_CAPSULE),
        (flag[:, 0] & 1).bool(), frame_valid,
    )

"""Scalar reference decoders for the six measurement wire formats.

These mirror, sample-for-sample, the C++ unpack arithmetic of the reference
handlers (src/sdk/src/dataunpacker/unpacker/handler_*.cpp) using explicit
C-int32 semantics.  They are the *golden model* the vectorized decoders
(ops/unpack.py) are tested against, and the simulator's (driver/
sim_device.py) — and double as a readable specification of each format.
A copy of the JAX package's ``ops/unpack_ref.py`` (pure Python).  They are
not on the hot path.

Stateful pair logic: every capsule format except HQ interpolates angles
between CONSECUTIVE capsules, so decoders carry the previous capsule and
emit nodes only once its successor arrives (handler_capsules.cpp:206-266).
"""

from __future__ import annotations

import dataclasses
import struct
from typing import List, Optional, Tuple

from rplidar_ros2_driver_tpu_torch.protocol import crc
from rplidar_ros2_driver_tpu_torch.protocol.constants import (
    EXP_SYNC_1,
    EXP_SYNC_2,
    EXP_SYNCBIT,
    HQ_SYNC,
    VARBITSCALE_X2_DEST_VAL,
    VARBITSCALE_X2_SRC_BIT,
    VARBITSCALE_X4_DEST_VAL,
    VARBITSCALE_X4_SRC_BIT,
    VARBITSCALE_X8_DEST_VAL,
    VARBITSCALE_X8_SRC_BIT,
    VARBITSCALE_X16_DEST_VAL,
    VARBITSCALE_X16_SRC_BIT,
)

FULL_TURN_Q6 = 360 << 6
FULL_TURN_Q16 = 360 << 16


def _i32(x: int) -> int:
    """Wrap to C int32 (two's complement)."""
    return ((x + 0x80000000) & 0xFFFFFFFF) - 0x80000000


@dataclasses.dataclass
class HqNode:
    """Decoded HQ node (sl_lidar_cmd.h:272-278)."""

    angle_q14: int
    dist_q2: int
    quality: int
    flag: int


def _wrap_angle_q6(a: int) -> int:
    if a < 0:
        a += FULL_TURN_Q6
    if a >= FULL_TURN_Q6:
        a -= FULL_TURN_Q6
    return a


def _check_capsule_checksum(frame: bytes, payload_from: int = 2) -> bool:
    # low nibble of byte0 = checksum low nibble, low nibble of byte1 = high
    # nibble (sl_lidar_cmd.h capsule struct: s_checksum_1/2 are the :4 low
    # bitfields beside the 0xA/0x5 sync nibbles)
    recv = (frame[0] & 0xF) | ((frame[1] & 0xF) << 4)
    c = 0
    for b in frame[payload_from:]:
        c ^= b
    return recv == c


def _has_exp_sync(frame: bytes) -> bool:
    return (frame[0] >> 4) == EXP_SYNC_1 and (frame[1] >> 4) == EXP_SYNC_2


# ---------------------------------------------------------------------------
# Normal (legacy) 5-byte nodes — handler_normalnode.cpp:87-133
# ---------------------------------------------------------------------------


def decode_normal_node(frame: bytes) -> Optional[HqNode]:
    """Decode one 5-byte node; None if the sync/check bits are invalid."""
    b0 = frame[0]
    if not ((b0 >> 1) ^ b0) & 0x1:
        return None
    angle_field, dist_q2 = struct.unpack_from("<HH", frame, 1)
    if not angle_field & 0x1:
        return None
    return HqNode(
        angle_q14=((angle_field >> 1) << 8) // 90,
        dist_q2=dist_q2,
        quality=(b0 >> 2) << 2,
        flag=b0 & 0x1,
    )


# ---------------------------------------------------------------------------
# Express capsule — handler_capsules.cpp:206-266
# ---------------------------------------------------------------------------


def _start_angle_q6(frame: bytes, offset: int = 2) -> int:
    return struct.unpack_from("<H", frame, offset)[0]


@dataclasses.dataclass
class CapsuleDecoder:
    """Stateful express-capsule (ans 0x82) decoder: 16 cabins x 2 points."""

    prev: Optional[bytes] = None

    def reset(self) -> None:
        self.prev = None

    def decode(self, frame: bytes) -> Tuple[List[HqNode], bool]:
        """Returns (nodes, new_scan_flag).  nodes come from the *previous*
        capsule, interpolated toward this one's start angle."""
        if not _has_exp_sync(frame) or not _check_capsule_checksum(frame):
            self.prev = None
            return [], False
        start = _start_angle_q6(frame)
        new_scan = bool(start & EXP_SYNCBIT)
        if new_scan:
            self.prev = None  # discard cached capsule, scan restarts
        nodes: List[HqNode] = []
        if self.prev is not None:
            nodes = self._decode_pair(self.prev, frame)
        self.prev = frame
        return nodes, new_scan

    @staticmethod
    def _decode_pair(prev: bytes, cur: bytes) -> List[HqNode]:
        cur_q8 = (_start_angle_q6(cur) & 0x7FFF) << 2
        prev_q8 = (_start_angle_q6(prev) & 0x7FFF) << 2
        diff_q8 = cur_q8 - prev_q8
        if prev_q8 > cur_q8:
            diff_q8 += 360 << 8
        angle_inc_q16 = diff_q8 << 3
        angle_raw_q16 = prev_q8 << 8
        nodes = []
        for pos in range(16):
            da1, da2, packed = struct.unpack_from("<HHB", prev, 4 + 5 * pos)
            dist = (da1 & 0xFFFC, da2 & 0xFFFC)
            off_q3 = ((packed & 0xF) | ((da1 & 0x3) << 4), (packed >> 4) | ((da2 & 0x3) << 4))
            for c in range(2):
                angle_q6 = _i32(angle_raw_q16 - (off_q3[c] << 13)) >> 10
                sync = 1 if ((angle_raw_q16 + angle_inc_q16) % FULL_TURN_Q16) < angle_inc_q16 else 0
                angle_raw_q16 += angle_inc_q16
                angle_q6 = _wrap_angle_q6(angle_q6)
                nodes.append(
                    HqNode(
                        angle_q14=(angle_q6 << 8) // 90,
                        dist_q2=dist[c],
                        quality=(0x2F << 2) if dist[c] else 0,
                        flag=sync | ((0 if sync else 1) << 1),
                    )
                )
        return nodes


# ---------------------------------------------------------------------------
# Ultra capsule (varbitscale) — handler_capsules.cpp:422-580
# ---------------------------------------------------------------------------

_VBS = (
    (VARBITSCALE_X16_DEST_VAL, 4, 1 << VARBITSCALE_X16_SRC_BIT),
    (VARBITSCALE_X8_DEST_VAL, 3, 1 << VARBITSCALE_X8_SRC_BIT),
    (VARBITSCALE_X4_DEST_VAL, 2, 1 << VARBITSCALE_X4_SRC_BIT),
    (VARBITSCALE_X2_DEST_VAL, 1, 1 << VARBITSCALE_X2_SRC_BIT),
    (0, 0, 0),
)


def varbitscale_decode(scaled: int) -> Tuple[int, int]:
    """Returns (value, scale_level)."""
    for scaled_base, lvl, target_base in _VBS:
        remain = scaled - scaled_base
        if remain >= 0:
            return target_base + (remain << lvl), lvl
    return 0, 0


# Angle-correction constants (handler_capsules.cpp:547-557).
_ULTRA_OFFSET_DEFAULT_Q16 = int(7.5 * 3.1415926535 * (1 << 16) / 180.0)
_ULTRA_OFFSET_BASE_Q16 = int(8 * 3.1415926535 * (1 << 16) / 180)
_ULTRA_K1 = 98361


def ultra_angle_correction_q16(dist_q2: int) -> int:
    """The distance-dependent angular correction term, in raw-Q16 units."""
    if dist_q2 >= 50 * 4:
        k2 = _ULTRA_K1 // dist_q2
        offset_q16 = _ULTRA_OFFSET_BASE_Q16 - (k2 << 6) - (k2 * k2 * k2) // 98304
    else:
        offset_q16 = _ULTRA_OFFSET_DEFAULT_Q16
    # C: int(offsetAngleMean_q16 * 180 / 3.14159265) — double division then
    # truncation toward zero.
    return int(offset_q16 * 180 / 3.14159265)


@dataclasses.dataclass
class UltraCapsuleDecoder:
    """Stateful ultra-capsule (ans 0x84) decoder: 32 cabins x 3 points."""

    prev: Optional[bytes] = None

    def reset(self) -> None:
        self.prev = None

    def decode(self, frame: bytes) -> Tuple[List[HqNode], bool]:
        if not _has_exp_sync(frame) or not _check_capsule_checksum(frame):
            self.prev = None
            return [], False
        start = _start_angle_q6(frame)
        new_scan = bool(start & EXP_SYNCBIT)
        if new_scan:
            self.prev = None
        nodes: List[HqNode] = []
        if self.prev is not None:
            nodes = self._decode_pair(self.prev, frame)
        self.prev = frame
        return nodes, new_scan

    @staticmethod
    def _decode_pair(prev: bytes, cur: bytes) -> List[HqNode]:
        cur_q8 = (_start_angle_q6(cur) & 0x7FFF) << 2
        prev_q8 = (_start_angle_q6(prev) & 0x7FFF) << 2
        diff_q8 = cur_q8 - prev_q8
        if prev_q8 > cur_q8:
            diff_q8 += 360 << 8
        angle_inc_q16 = (diff_q8 << 3) // 3
        angle_raw_q16 = prev_q8 << 8

        words = list(struct.unpack_from("<32I", prev, 4))
        next_word0 = struct.unpack_from("<I", cur, 4)[0]

        nodes = []
        for pos in range(32):
            w = words[pos]
            dist_major_raw = w & 0xFFF
            # "magic shift" signed extraction of the two 10-bit predicts
            predict1 = _i32((w << 10) & 0xFFFFFFFF) >> 22
            predict2 = _i32(w) >> 22
            next_raw = (words[pos + 1] if pos < 31 else next_word0) & 0xFFF

            dist_major, lvl1 = varbitscale_decode(dist_major_raw)
            dist_major2, lvl2 = varbitscale_decode(next_raw)

            base1, base2 = dist_major, dist_major2
            if (not dist_major) and dist_major2:
                base1, lvl1 = dist_major2, lvl2

            d = [dist_major << 2, 0, 0]
            if predict1 in (-512, 511):
                d[1] = 0
            else:
                d[1] = ((predict1 << lvl1) + base1) << 2
            if predict2 in (-512, 511):
                d[2] = 0
            else:
                d[2] = ((predict2 << lvl2) + base2) << 2

            for c in range(3):
                sync = 1 if ((angle_raw_q16 + angle_inc_q16) % FULL_TURN_Q16) < angle_inc_q16 else 0
                corr = ultra_angle_correction_q16(d[c])
                angle_q6 = _i32(angle_raw_q16 - corr) >> 10
                angle_raw_q16 += angle_inc_q16
                angle_q6 = _wrap_angle_q6(angle_q6)
                nodes.append(
                    HqNode(
                        angle_q14=(angle_q6 << 8) // 90,
                        dist_q2=d[c],
                        quality=(0x2F << 2) if d[c] else 0,
                        flag=sync | ((0 if sync else 1) << 1),
                    )
                )
        return nodes


# ---------------------------------------------------------------------------
# Dense capsule — handler_capsules.cpp:736-791
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DenseCapsuleDecoder:
    """Stateful dense-capsule (ans 0x85) decoder: 40 raw u16 distances.

    Carries the edge-detection sync state across capsules (the reference
    keeps it in a function-static, handler_capsules.cpp:738 — a latent
    cross-instance hazard we scope per-decoder instead).
    """

    sample_duration_us: float = 476.0
    prev: Optional[bytes] = None
    last_sync_out: int = 0

    def reset(self) -> None:
        self.prev = None
        # NB: the reference does NOT reset the static lastNodeSyncBit.

    def decode(self, frame: bytes) -> Tuple[List[HqNode], bool]:
        if not _has_exp_sync(frame) or not _check_capsule_checksum(frame):
            self.prev = None
            return [], False
        start = _start_angle_q6(frame)
        new_scan = bool(start & EXP_SYNCBIT)
        if new_scan:
            self.prev = None
        nodes: List[HqNode] = []
        if self.prev is not None:
            nodes = self._decode_pair(self.prev, frame)
            if nodes is None:
                # angle-jump discard: keep *current* as prev, emit nothing
                self.prev = frame
                return [], new_scan
        self.prev = frame
        return nodes, new_scan

    def _decode_pair(self, prev: bytes, cur: bytes) -> Optional[List[HqNode]]:
        cur_q8 = (_start_angle_q6(cur) & 0x7FFF) << 2
        prev_q8 = (_start_angle_q6(prev) & 0x7FFF) << 2
        diff_q8 = cur_q8 - prev_q8
        if prev_q8 > cur_q8:
            diff_q8 += 360 << 8
        # discard threshold vs 100 Hz rotation (handler_capsules.cpp:750-754)
        max_diff_q8 = (360 * 100 * 40 // int(1000000 / self.sample_duration_us)) << 8
        if diff_q8 > max_diff_q8:
            return None
        angle_inc_q16 = (diff_q8 << 8) // 40
        angle_raw_q16 = prev_q8 << 8
        dists = struct.unpack_from("<40H", prev, 4)
        nodes = []
        for pos in range(40):
            dist_q2 = dists[pos] << 2
            angle_q6 = angle_raw_q16 >> 10
            sync_raw = 1 if ((angle_raw_q16 + angle_inc_q16) % FULL_TURN_Q16) < (angle_inc_q16 << 1) else 0
            sync = (sync_raw ^ self.last_sync_out) & sync_raw  # rising edge only
            angle_raw_q16 += angle_inc_q16
            angle_q6 = _wrap_angle_q6(angle_q6)
            nodes.append(
                HqNode(
                    angle_q14=(angle_q6 << 8) // 90,
                    dist_q2=dist_q2,
                    quality=(0x2F << 2) if dist_q2 else 0,
                    flag=sync | ((0 if sync else 1) << 1),
                )
            )
            self.last_sync_out = sync
        return nodes


# ---------------------------------------------------------------------------
# Ultra-dense capsule — handler_capsules.cpp:951-1047
# ---------------------------------------------------------------------------

UD_THRESH_1 = 2046
UD_THRESH_2 = 8187
UD_THRESH_3 = 24567


def ultra_dense_decode_sample(word20: int) -> Tuple[int, int]:
    """Decode one 20-bit word -> (dist_q2_raw, quality).  Piecewise 4-level
    distance scale (handler_capsules.cpp:991-1017), smoothing NOT applied."""
    scale = word20 & 0x3
    if scale == 0:
        return (word20 & 0xFFC) * 2, word20 >> 12
    if scale == 1:
        return (word20 & 0x1FFC) * 3 + (UD_THRESH_1 << 2), ((word20 >> 13) << 1) & 0xFF
    if scale == 2:
        return (word20 & 0x3FFC) * 4 + (UD_THRESH_2 << 2), ((word20 >> 14) << 2) & 0xFF
    return (word20 & 0x7FFC) * 5 + (UD_THRESH_3 << 2), ((word20 >> 15) << 3) & 0xFF


@dataclasses.dataclass
class UltraDenseCapsuleDecoder:
    """Stateful ultra-dense (ans 0x86, DenseBoost) decoder: 32 cabins x 2.

    Carries both the sync edge detector and the +/-2 mm smoothing history
    across capsules (handler_capsules.cpp:999-1003,1018-1021).
    """

    sample_duration_us: float = 476.0
    prev: Optional[bytes] = None
    last_sync_out: int = 0
    last_dist_q2: int = 0

    def reset(self) -> None:
        self.prev = None
        self.last_sync_out = 0
        self.last_dist_q2 = 0

    def decode(self, frame: bytes) -> Tuple[List[HqNode], bool]:
        if not _has_exp_sync(frame) or not _check_capsule_checksum(frame, payload_from=2):
            self.prev = None
            return [], False
        start = struct.unpack_from("<H", frame, 8)[0]
        new_scan = bool(start & EXP_SYNCBIT)
        if new_scan:
            self.prev = None
        nodes: List[HqNode] = []
        if self.prev is not None:
            nodes = self._decode_pair(self.prev, frame)
            if nodes is None:
                self.prev = frame
                return [], new_scan
        self.prev = frame
        return nodes, new_scan

    def _decode_pair(self, prev: bytes, cur: bytes) -> Optional[List[HqNode]]:
        cur_q8 = (struct.unpack_from("<H", cur, 8)[0] & 0x7FFF) << 2
        prev_q8 = (struct.unpack_from("<H", prev, 8)[0] & 0x7FFF) << 2
        diff_q8 = cur_q8 - prev_q8
        if prev_q8 > cur_q8:
            diff_q8 += 360 << 8
        max_diff_q8 = (360 * 100 * 32 // int(1000000 / self.sample_duration_us)) << 8
        if diff_q8 > max_diff_q8:
            return None
        angle_inc_q16 = (diff_q8 << 8) // 64
        angle_raw_q16 = prev_q8 << 8
        nodes = []
        for pos in range(64):
            cab = pos >> 1
            w0, w1, hi = struct.unpack_from("<HHB", prev, 10 + 5 * cab)
            if not pos & 1:
                word20 = w0 | ((hi & 0x0F) << 16)
            else:
                word20 = w1 | ((hi >> 4) << 16)
            scale = word20 & 0x3
            dist_q2, quality = ultra_dense_decode_sample(word20)
            if scale == 0 and self.last_dist_q2:
                if abs(dist_q2 - self.last_dist_q2) <= 8:  # 2 mm in Q2
                    dist_q2 = (dist_q2 + self.last_dist_q2) >> 1
            self.last_dist_q2 = dist_q2
            angle_q6 = angle_raw_q16 >> 10
            sync_raw = 1 if ((angle_raw_q16 + angle_inc_q16) % FULL_TURN_Q16) < (angle_inc_q16 << 1) else 0
            sync = (sync_raw ^ self.last_sync_out) & sync_raw
            angle_raw_q16 += angle_inc_q16
            angle_q6 = _wrap_angle_q6(angle_q6)
            nodes.append(
                HqNode(
                    angle_q14=(angle_q6 << 8) // 90,
                    dist_q2=dist_q2,
                    quality=quality,
                    flag=sync | ((0 if sync else 1) << 1),
                )
            )
            self.last_sync_out = sync
        return nodes


# ---------------------------------------------------------------------------
# HQ capsule — handler_hqnode.cpp:92-174
# ---------------------------------------------------------------------------


def decode_hq_capsule(frame: bytes) -> Tuple[List[HqNode], int]:
    """Decode one HQ capsule; returns ([], 0) on CRC mismatch, else the 96
    nodes and the device timestamp."""
    if frame[0] != HQ_SYNC:
        return [], 0
    recv_crc = struct.unpack_from("<I", frame, len(frame) - 4)[0]
    if crc.crc32_padded(frame[:-4]) != recv_crc:
        return [], 0
    ts = struct.unpack_from("<Q", frame, 1)[0]
    nodes = []
    for i in range(96):
        angle_q14, dist_q2, quality, flag = struct.unpack_from("<HIBB", frame, 9 + 8 * i)
        nodes.append(HqNode(angle_q14, dist_q2, quality, flag))
    return nodes, ts

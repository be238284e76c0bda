"""Wire-frame builders (encoders) for the six measurement formats.

A copy of the JAX package's ``ops/wire.py`` (numpy only).  The reference
only ever *decodes* these formats (the device firmware is the encoder);
the encoders build byte fixtures for the decoders' tests and seeded
captures for ``chip_smoke.py``'s replay phase.

Layouts follow sl_lidar_cmd.h:189-286; checksums follow the handler
implementations (XOR over bytes after the checksum nibbles,
handler_capsules.cpp:146-153).
"""

from __future__ import annotations

import struct

import numpy as np

from rplidar_ros2_driver_tpu_torch.protocol import crc
from rplidar_ros2_driver_tpu_torch.protocol.constants import (
    CAPSULE_BYTES,
    DENSE_CAPSULE_BYTES,
    EXP_SYNC_1,
    EXP_SYNC_2,
    EXP_SYNCBIT,
    HQ_CAPSULE_BYTES,
    HQ_SYNC,
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


def _finish_capsule(body: bytes) -> bytes:
    """Prepend express sync nibbles + split XOR checksum over ``body``."""
    checksum = 0
    for b in body:
        checksum ^= b
    b0 = (EXP_SYNC_1 << 4) | (checksum & 0xF)
    b1 = (EXP_SYNC_2 << 4) | (checksum >> 4)
    return bytes([b0, b1]) + body


def encode_normal_node(
    angle_q6: int, dist_q2: int, quality6: int, syncbit: bool
) -> bytes:
    """5-byte legacy node (sl_lidar_cmd.h:189-194).

    byte0: sync:1 | sync_inverse:1 | quality:6;  byte1..2: checkbit:1 |
    angle_q6:15;  byte3..4: distance_q2.
    """
    s = 1 if syncbit else 0
    b0 = (quality6 & 0x3F) << 2 | (s ^ 1) << 1 | s
    angle_field = ((angle_q6 & 0x7FFF) << 1) | 0x1  # checkbit always set
    return bytes([b0]) + struct.pack("<HH", angle_field, dist_q2 & 0xFFFF)


def encode_capsule(
    start_angle_q6: int,
    syncbit: bool,
    dist_q2: np.ndarray,      # (16, 2) int, low 2 bits must be 0
    offset_q3: np.ndarray,    # (16, 2) int in [0, 63]
) -> bytes:
    """Express capsule: 16 cabins x 2 points, 84 bytes."""
    dist_q2 = np.asarray(dist_q2, np.int64)
    offset_q3 = np.asarray(offset_q3, np.int64)
    assert dist_q2.shape == (16, 2) and offset_q3.shape == (16, 2)
    angle_field = (start_angle_q6 & 0x7FFF) | (EXP_SYNCBIT if syncbit else 0)
    body = bytearray(struct.pack("<H", angle_field))
    for c in range(16):
        # distance_angle fields: dist in bits 2..15, offset bits 4..5 of the
        # q3 offset in the low 2 bits; low nibbles of both offsets packed in
        # the fifth byte (sl_lidar_cmd.h:200-205, decode at
        # handler_capsules.cpp:227-231).
        da1 = (int(dist_q2[c, 0]) & 0xFFFC) | ((int(offset_q3[c, 0]) >> 4) & 0x3)
        da2 = (int(dist_q2[c, 1]) & 0xFFFC) | ((int(offset_q3[c, 1]) >> 4) & 0x3)
        packed = (int(offset_q3[c, 0]) & 0xF) | ((int(offset_q3[c, 1]) & 0xF) << 4)
        body += struct.pack("<HHB", da1, da2, packed)
    out = _finish_capsule(bytes(body))
    assert len(out) == CAPSULE_BYTES
    return out


def encode_dense_capsule(
    start_angle_q6: int, syncbit: bool, dist_mm: np.ndarray
) -> bytes:
    """Dense capsule: 40 u16 raw millimetre distances, 84 bytes."""
    dist_mm = np.asarray(dist_mm, np.int64)
    assert dist_mm.shape == (40,)
    angle_field = (start_angle_q6 & 0x7FFF) | (EXP_SYNCBIT if syncbit else 0)
    body = struct.pack("<H", angle_field) + struct.pack(
        "<40H", *[int(d) & 0xFFFF for d in dist_mm]
    )
    out = _finish_capsule(body)
    assert len(out) == DENSE_CAPSULE_BYTES
    return out


def varbitscale_encode(value: int) -> int:
    """Inverse of the ultra-capsule varbitscale decode
    (handler_capsules.cpp:422-458): map a 16-bit-ish distance back to the
    12-bit scaled field.  Values are quantized by the scale level, so
    decode(encode(v)) == v only when v is representable."""
    bases = (
        (1 << VARBITSCALE_X16_SRC_BIT, VARBITSCALE_X16_DEST_VAL, 4),
        (1 << VARBITSCALE_X8_SRC_BIT, VARBITSCALE_X8_DEST_VAL, 3),
        (1 << VARBITSCALE_X4_SRC_BIT, VARBITSCALE_X4_DEST_VAL, 2),
        (1 << VARBITSCALE_X2_SRC_BIT, VARBITSCALE_X2_DEST_VAL, 1),
        (0, 0, 0),
    )
    for target_base, scaled_base, lvl in bases:
        if value >= target_base:
            return scaled_base + ((value - target_base) >> lvl)
    return 0


def encode_ultra_capsule(
    start_angle_q6: int,
    syncbit: bool,
    major12: np.ndarray,     # (32,) ints in [0, 4095] (varbitscale domain)
    predict1: np.ndarray,    # (32,) ints in [-512, 511] (10-bit signed)
    predict2: np.ndarray,    # (32,) ints in [-512, 511]
) -> bytes:
    """Ultra capsule: 32 cabins x u32 ``| predict2 10b | predict1 10b | major 12b |``."""
    major12 = np.asarray(major12, np.int64)
    predict1 = np.asarray(predict1, np.int64)
    predict2 = np.asarray(predict2, np.int64)
    assert major12.shape == (32,)
    angle_field = (start_angle_q6 & 0x7FFF) | (EXP_SYNCBIT if syncbit else 0)
    body = bytearray(struct.pack("<H", angle_field))
    for c in range(32):
        word = (
            (int(major12[c]) & 0xFFF)
            | ((int(predict1[c]) & 0x3FF) << 12)
            | ((int(predict2[c]) & 0x3FF) << 22)
        )
        body += struct.pack("<I", word)
    out = _finish_capsule(bytes(body))
    assert len(out) == ULTRA_CAPSULE_BYTES
    return out


# Ultra-dense piecewise scale thresholds (handler_capsules.cpp:973-975), in mm.
UD_THRESH_1 = 2046
UD_THRESH_2 = 8187
UD_THRESH_3 = 24567


def ultra_dense_encode_sample(dist_mm: int, quality: int) -> int:
    """Encode one 20-bit ultra-dense quality/distance/scale word.

    Inverse of the 4-level piecewise decode (handler_capsules.cpp:995-1017).
    Quantized: round-trips exactly only for representable distances.
    """
    dist_q2 = dist_mm * 4
    if dist_mm < UD_THRESH_1:
        field = (dist_q2 // 2) & 0xFFC
        return ((quality & 0xFF) << 12) | field | 0
    if dist_mm < UD_THRESH_2:
        field = ((dist_q2 - (UD_THRESH_1 << 2)) // 3) & 0x1FFC
        return (((quality >> 1) & 0x7F) << 13) | field | 1
    if dist_mm < UD_THRESH_3:
        field = ((dist_q2 - (UD_THRESH_2 << 2)) // 4) & 0x3FFC
        return (((quality >> 2) & 0x3F) << 14) | field | 2
    field = ((dist_q2 - (UD_THRESH_3 << 2)) // 5) & 0x7FFC
    return (((quality >> 3) & 0x1F) << 15) | field | 3


def encode_ultra_dense_capsule(
    start_angle_q6: int,
    syncbit: bool,
    words20: np.ndarray,   # (64,) 20-bit encoded samples (2 per cabin)
    timestamp: int = 0,
    dev_status: int = 0,
) -> bytes:
    """Ultra-dense capsule: u32 ts + u16 status + u16 angle + 32 cabins x 5B."""
    words20 = np.asarray(words20, np.int64)
    assert words20.shape == (64,)
    angle_field = (start_angle_q6 & 0x7FFF) | (EXP_SYNCBIT if syncbit else 0)
    body = bytearray(struct.pack("<IHH", timestamp & 0xFFFFFFFF, dev_status & 0xFFFF, angle_field))
    for c in range(32):
        w0 = int(words20[2 * c])
        w1 = int(words20[2 * c + 1])
        # low 16 bits of each sample in two u16s, high nibbles packed in byte 5
        body += struct.pack(
            "<HHB", w0 & 0xFFFF, w1 & 0xFFFF, ((w0 >> 16) & 0xF) | (((w1 >> 16) & 0xF) << 4)
        )
    out = _finish_capsule(bytes(body))
    assert len(out) == ULTRA_DENSE_CAPSULE_BYTES
    return out


def encode_hq_capsule(
    angle_q14: np.ndarray,   # (96,)
    dist_q2: np.ndarray,     # (96,)
    quality: np.ndarray,     # (96,)
    flags: np.ndarray,       # (96,)
    timestamp: int = 0,
) -> bytes:
    """HQ capsule: sync 0xA5 + u64 ts + 96 pre-formatted HQ nodes + CRC32."""
    angle_q14 = np.asarray(angle_q14, np.int64)
    assert angle_q14.shape == (96,)
    body = bytearray([HQ_SYNC])
    body += struct.pack("<Q", timestamp & 0xFFFFFFFFFFFFFFFF)
    for i in range(96):
        body += struct.pack(
            "<HIBB",
            int(angle_q14[i]) & 0xFFFF,
            int(dist_q2[i]) & 0xFFFFFFFF,
            int(quality[i]) & 0xFF,
            int(flags[i]) & 0xFF,
        )
    body += struct.pack("<I", crc.crc32_padded(bytes(body)))
    assert len(body) == HQ_CAPSULE_BYTES
    return bytes(body)

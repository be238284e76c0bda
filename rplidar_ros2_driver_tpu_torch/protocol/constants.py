"""Slamtec wire-protocol constants used by the measurement decoders,
the frame encoders and the capture replay.

A copy of the JAX package's ``protocol/constants.py``, cut to what those
modules use.  Semantics are documented against the reference headers
(src/sdk/include/sl_lidar_cmd.h); the values are protocol facts fixed by
the device firmware.
"""

from __future__ import annotations

import enum


class Ans(enum.IntEnum):
    """Response type bytes (sl_lidar_cmd.h:141-162)."""

    DEVINFO = 0x04
    DEVHEALTH = 0x06
    SAMPLE_RATE = 0x15
    GET_LIDAR_CONF = 0x20
    SET_LIDAR_CONF = 0x21
    MEASUREMENT = 0x81
    MEASUREMENT_CAPSULED = 0x82
    MEASUREMENT_HQ = 0x83
    MEASUREMENT_CAPSULED_ULTRA = 0x84
    MEASUREMENT_DENSE_CAPSULED = 0x85
    MEASUREMENT_ULTRA_DENSE_CAPSULED = 0x86
    ACC_BOARD_FLAG = 0xFF


# ---- wire frame geometry (sl_lidar_cmd.h struct layouts) ----
# All little-endian, packed.
NORMAL_NODE_BYTES = 5          # sync_quality u8, angle_q6_checkbit u16, distance_q2 u16
CAPSULE_BYTES = 84             # 2 checksum nibbles + u16 start angle + 16 cabins x 5B
DENSE_CAPSULE_BYTES = 84       # 2 + 2 + 40 cabins x u16
ULTRA_CAPSULE_BYTES = 132      # 2 + 2 + 32 cabins x u32
ULTRA_DENSE_CAPSULE_BYTES = 170  # 2 + u32 ts + u16 status + u16 angle + 32 cabins x 5B
HQ_CAPSULE_BYTES = 1 + 8 + 96 * 8 + 4  # sync + u64 ts + 96 HQ nodes + crc32
HQ_NODES_PER_CAPSULE = 96

# Express sync nibbles (sl_lidar_cmd.h:208-211).
EXP_SYNC_1 = 0xA
EXP_SYNC_2 = 0x5
HQ_SYNC = 0xA5
EXP_SYNCBIT = 0x1 << 15

# Varbitscale encoding (sl_lidar_cmd.h:364-372) used by the ultra capsule.
VARBITSCALE_X2_SRC_BIT = 9
VARBITSCALE_X4_SRC_BIT = 11
VARBITSCALE_X8_SRC_BIT = 12
VARBITSCALE_X16_SRC_BIT = 14
VARBITSCALE_X2_DEST_VAL = 512
VARBITSCALE_X4_DEST_VAL = 1280
VARBITSCALE_X8_DEST_VAL = 1792
VARBITSCALE_X16_DEST_VAL = 3328

ANS_PAYLOAD_BYTES = {
    Ans.MEASUREMENT: NORMAL_NODE_BYTES,
    Ans.MEASUREMENT_CAPSULED: CAPSULE_BYTES,
    Ans.MEASUREMENT_HQ: HQ_CAPSULE_BYTES,
    Ans.MEASUREMENT_CAPSULED_ULTRA: ULTRA_CAPSULE_BYTES,
    Ans.MEASUREMENT_DENSE_CAPSULED: DENSE_CAPSULE_BYTES,
    Ans.MEASUREMENT_ULTRA_DENSE_CAPSULED: ULTRA_DENSE_CAPSULE_BYTES,
}

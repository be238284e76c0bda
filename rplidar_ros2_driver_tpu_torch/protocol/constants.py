"""Slamtec wire-protocol constants (a copy of the JAX package's
``protocol/constants.py``).

Semantics documented against the reference headers
(src/sdk/include/sl_lidar_cmd.h, sl_lidar_protocol.h); values are protocol
facts fixed by the device firmware.
"""

from __future__ import annotations

import enum

# ---- request framing (sl_lidar_protocol.h:44-45) ----
CMD_SYNC_BYTE = 0xA5
CMDFLAG_HAS_PAYLOAD = 0x80

# ---- response framing (sl_lidar_protocol.h:47-53) ----
ANS_SYNC_BYTE1 = 0xA5
ANS_SYNC_BYTE2 = 0x5A
ANS_PKTFLAG_LOOP = 0x1
ANS_HEADER_SIZE_MASK = 0x3FFFFFFF
ANS_HEADER_SUBTYPE_SHIFT = 30
ANS_HEADER_LEN = 7  # sync1 + sync2 + u32 size/subtype + type


class Cmd(enum.IntEnum):
    """Request opcodes (sl_lidar_cmd.h:47-74)."""

    STOP = 0x25
    SCAN = 0x20
    FORCE_SCAN = 0x21
    RESET = 0x40
    NEW_BAUDRATE_CONFIRM = 0x90
    GET_DEVICE_INFO = 0x50
    GET_DEVICE_HEALTH = 0x52
    GET_SAMPLERATE = 0x59
    HQ_MOTOR_SPEED_CTRL = 0xA8
    EXPRESS_SCAN = 0x82
    HQ_SCAN = 0x83
    GET_LIDAR_CONF = 0x84
    SET_LIDAR_CONF = 0x85
    SET_MOTOR_PWM = 0xF0
    GET_ACC_BOARD_FLAG = 0xFF


AUTOBAUD_MAGICBYTE = 0x41
# NEW_BAUDRATE_CONFIRM payload flag (sl_lidar_cmd.h:133-137)
AUTOBAUD_CONFIRM_FLAG = 0x5F5F
# ACC_BOARD_FLAG answer bit 0: accessory board drives the motor via PWM
# (sl_lidar_cmd.h acc_board_flag response + checkMotorCtrlSupport,
# sl_lidar_driver.cpp:833-878)
ACC_BOARD_FLAG_MOTOR_CTRL_SUPPORT_MASK = 0x1


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


# Measurement answer types that stream in loop mode.
SCAN_ANS_TYPES = frozenset(
    {
        Ans.MEASUREMENT,
        Ans.MEASUREMENT_CAPSULED,
        Ans.MEASUREMENT_HQ,
        Ans.MEASUREMENT_CAPSULED_ULTRA,
        Ans.MEASUREMENT_DENSE_CAPSULED,
        Ans.MEASUREMENT_ULTRA_DENSE_CAPSULED,
    }
)

# ---- wire frame geometry (sl_lidar_cmd.h struct layouts) ----
# All little-endian, packed.
NORMAL_NODE_BYTES = 5          # sync_quality u8, angle_q6_checkbit u16, distance_q2 u16
CAPSULE_BYTES = 84             # 2 checksum nibbles + u16 start angle + 16 cabins x 5B
CAPSULE_CABINS = 16            # 2 points per cabin -> 32 points
DENSE_CAPSULE_BYTES = 84       # 2 + 2 + 40 cabins x u16
DENSE_CABINS = 40              # 1 point per cabin
ULTRA_CAPSULE_BYTES = 132      # 2 + 2 + 32 cabins x u32
ULTRA_CABINS = 32              # 3 points per cabin -> 96 points
ULTRA_DENSE_CAPSULE_BYTES = 170  # 2 + u32 ts + u16 status + u16 angle + 32 cabins x 5B
ULTRA_DENSE_CABINS = 32        # 2 points per cabin -> 64 points
HQ_CAPSULE_BYTES = 1 + 8 + 96 * 8 + 4  # sync + u64 ts + 96 HQ nodes + crc32
HQ_NODES_PER_CAPSULE = 96
HQ_NODE_BYTES = 8              # u16 angle_z_q14, u32 dist_mm_q2, u8 quality, u8 flag

# Express sync nibbles (sl_lidar_cmd.h:208-211).
EXP_SYNC_1 = 0xA
EXP_SYNC_2 = 0x5
HQ_SYNC = 0xA5
EXP_SYNCBIT = 0x1 << 15

# Measurement node bit fields (sl_lidar_cmd.h:175-181).
MEASUREMENT_SYNCBIT = 0x1
MEASUREMENT_QUALITY_SHIFT = 2
MEASUREMENT_CHECKBIT = 0x1
MEASUREMENT_ANGLE_SHIFT = 1

# Express scan working flags (sl_lidar_cmd.h:86-91).
EXPRESS_FLAG_BOOST = 0x0001
EXPRESS_FLAG_SUNLIGHT_REJECTION = 0x0002

# Varbitscale encoding (sl_lidar_cmd.h:364-372) used by the ultra capsule.
VARBITSCALE_X2_SRC_BIT = 9
VARBITSCALE_X4_SRC_BIT = 11
VARBITSCALE_X8_SRC_BIT = 12
VARBITSCALE_X16_SRC_BIT = 14
VARBITSCALE_X2_DEST_VAL = 512
VARBITSCALE_X4_DEST_VAL = 1280
VARBITSCALE_X8_DEST_VAL = 1792
VARBITSCALE_X16_DEST_VAL = 3328


class ConfKey(enum.IntEnum):
    """GET/SET_LIDAR_CONF key space (sl_lidar_cmd.h:296-317)."""

    ANGLE_RANGE = 0x00000000
    DESIRED_ROT_FREQ = 0x00000001
    SCAN_COMMAND_BITMAP = 0x00000002
    MIN_ROT_FREQ = 0x00000004
    MAX_ROT_FREQ = 0x00000005
    MAX_DISTANCE = 0x00000060
    SCAN_MODE_COUNT = 0x00000070
    SCAN_MODE_US_PER_SAMPLE = 0x00000071
    SCAN_MODE_MAX_DISTANCE = 0x00000074
    SCAN_MODE_ANS_TYPE = 0x00000075
    LIDAR_MAC_ADDR = 0x00000079
    SCAN_MODE_TYPICAL = 0x0000007C
    SCAN_MODE_NAME = 0x0000007F
    MODEL_REVISION_ID = 0x00000080
    MODEL_NAME_ALIAS = 0x00000081
    DETECTED_SERIAL_BPS = 0x000000A1
    LIDAR_STATIC_IP_ADDR = 0x0001CCC0


# Scan-command mode ids shared by the conf protocol and the EXPRESS_SCAN
# request (SL_LIDAR_CONF_SCAN_COMMAND_STD/EXPRESS, sl_lidar_cmd.h:289-290).
# EXPRESS is also the hardwired typical-mode fallback for old triangle
# lidars whose firmware predates the conf protocol (getTypicalScanMode,
# sl_lidar_driver.cpp:577-580).
SCAN_COMMAND_STD = 0
SCAN_COMMAND_EXPRESS = 1


class HealthStatus(enum.IntEnum):
    """Device-side health byte (sl_lidar_cmd.h:171-173)."""

    OK = 0x0
    WARNING = 0x1
    ERROR = 0x2


ANS_PAYLOAD_BYTES = {
    Ans.MEASUREMENT: NORMAL_NODE_BYTES,
    Ans.MEASUREMENT_CAPSULED: CAPSULE_BYTES,
    Ans.MEASUREMENT_HQ: HQ_CAPSULE_BYTES,
    Ans.MEASUREMENT_CAPSULED_ULTRA: ULTRA_CAPSULE_BYTES,
    Ans.MEASUREMENT_DENSE_CAPSULED: DENSE_CAPSULE_BYTES,
    Ans.MEASUREMENT_ULTRA_DENSE_CAPSULED: ULTRA_DENSE_CAPSULE_BYTES,
}

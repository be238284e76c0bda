"""Result / status codes.

The reference threads ``u_result`` codes through every SDK call
(src/sdk/src/hal/types.h:83-130).  We keep an enum-shaped equivalent for the
host-side runtime; array kernels signal failure through masks instead.
"""

from __future__ import annotations

import enum


class Result(enum.IntEnum):
    OK = 0
    FAIL_BIT = 0x80000000
    ALREADY_DONE = 0x20
    INVALID_DATA = 0x8000 | 0x80000000
    OPERATION_FAIL = 0x8001 | 0x80000000
    OPERATION_TIMEOUT = 0x8002 | 0x80000000
    OPERATION_STOP = 0x8003 | 0x80000000
    OPERATION_NOT_SUPPORT = 0x8004 | 0x80000000
    FORMAT_NOT_SUPPORT = 0x8005 | 0x80000000
    INSUFFICIENT_MEMORY = 0x8006 | 0x80000000


def is_ok(res: int) -> bool:
    return (int(res) & 0x80000000) == 0


def is_fail(res: int) -> bool:
    return (int(res) & 0x80000000) != 0


class DeviceHealth(enum.IntEnum):
    """Health levels as the node sees them (src/lidar_driver_wrapper.cpp:390-405)."""

    OK = 0
    WARNING = 1
    ERROR = 2

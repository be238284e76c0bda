"""Device-side configuration protocol (GET/SET_LIDAR_CONF; a copy of the
JAX package's ``protocol/conf.py``).

The typed key space of the reference (sl_lidar_cmd.h:289-317; getLidarConf
sl_lidar_driver.cpp:1261-1304, setLidarConf :1215-1259) and the derived
scan-mode getters (:1199-1379): a GET request carries ``u32 key [+ extra]``
and the answer echoes the key followed by the data; scan-mode metadata is
keyed by ``u16 mode`` appended as the payload.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Optional

from rplidar_ros2_driver_tpu_torch.models.tables import ScanMode
from rplidar_ros2_driver_tpu_torch.protocol.constants import Ans, Cmd, ConfKey
from rplidar_ros2_driver_tpu_torch.protocol.engine import CommandEngine


def get_conf(
    engine: CommandEngine, key: int, extra: bytes = b"", timeout_s: float = 1.0
) -> Optional[bytes]:
    """Raw GET_LIDAR_CONF: returns the data after the echoed key, or None."""
    payload = struct.pack("<I", key) + extra
    ans = engine.request(Cmd.GET_LIDAR_CONF, Ans.GET_LIDAR_CONF, payload, timeout_s)
    if ans is None or len(ans) < 4:
        return None
    echoed = struct.unpack_from("<I", ans)[0]
    if echoed != key:
        return None
    return ans[4:]


def set_conf(
    engine: CommandEngine, key: int, data: bytes = b"", timeout_s: float = 1.0
) -> bool:
    """SET_LIDAR_CONF; answer is ``u32 result`` (0 == ok)."""
    payload = struct.pack("<I", key) + data
    ans = engine.request(Cmd.SET_LIDAR_CONF, Ans.SET_LIDAR_CONF, payload, timeout_s)
    if ans is None or len(ans) < 4:
        return False
    return struct.unpack_from("<I", ans)[0] == 0


def _mode_extra(mode_id: int) -> bytes:
    return struct.pack("<H", mode_id)


def get_scan_mode_count(engine: CommandEngine) -> Optional[int]:
    data = get_conf(engine, ConfKey.SCAN_MODE_COUNT)
    return struct.unpack_from("<H", data)[0] if data and len(data) >= 2 else None


def get_typical_mode(engine: CommandEngine) -> Optional[int]:
    data = get_conf(engine, ConfKey.SCAN_MODE_TYPICAL)
    return struct.unpack_from("<H", data)[0] if data and len(data) >= 2 else None


def get_mode_us_per_sample(engine: CommandEngine, mode_id: int) -> Optional[float]:
    # u32 Q8 fixed point (ref :1317-1331)
    data = get_conf(engine, ConfKey.SCAN_MODE_US_PER_SAMPLE, _mode_extra(mode_id))
    return struct.unpack_from("<I", data)[0] / 256.0 if data and len(data) >= 4 else None


def get_mode_max_distance(engine: CommandEngine, mode_id: int) -> Optional[float]:
    # u32 Q8 metres (ref :1333-1347)
    data = get_conf(engine, ConfKey.SCAN_MODE_MAX_DISTANCE, _mode_extra(mode_id))
    return struct.unpack_from("<I", data)[0] / 256.0 if data and len(data) >= 4 else None


def get_mode_ans_type(engine: CommandEngine, mode_id: int) -> Optional[int]:
    data = get_conf(engine, ConfKey.SCAN_MODE_ANS_TYPE, _mode_extra(mode_id))
    return data[0] if data else None


def get_mode_name(engine: CommandEngine, mode_id: int) -> Optional[str]:
    data = get_conf(engine, ConfKey.SCAN_MODE_NAME, _mode_extra(mode_id))
    return data.split(b"\x00", 1)[0].decode("ascii", "replace") if data else None


# ---------------------------------------------------------------------------
# motor / network conf getters (sl_lidar_driver.cpp:887-955, 1023-1056,
# 1163-1174)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MotorInfo:
    """LidarMotorInfo analog (min/max/desired rotation speed)."""

    min_speed: int
    max_speed: int
    desired_speed: int


@dataclasses.dataclass(frozen=True)
class IpConf:
    """Static-IP configuration triple (sl_lidar_ip_conf_t: 3 x 4 bytes)."""

    ip: tuple[int, int, int, int]
    netmask: tuple[int, int, int, int]
    gateway: tuple[int, int, int, int]

    def to_payload(self) -> bytes:
        return bytes(self.ip) + bytes(self.netmask) + bytes(self.gateway)

    @staticmethod
    def from_payload(data: bytes) -> "IpConf":
        if len(data) < 12:
            raise ValueError(f"ip conf payload too short: {len(data)}")
        return IpConf(tuple(data[0:4]), tuple(data[4:8]), tuple(data[8:12]))


def get_desired_speed(engine: CommandEngine) -> Optional[tuple[int, int]]:
    """(rpm, pwm_ref) from DESIRED_ROT_FREQ (getDesiredSpeed :1163-1174)."""
    data = get_conf(engine, ConfKey.DESIRED_ROT_FREQ)
    if data is None or len(data) < 4:
        return None
    return struct.unpack_from("<HH", data)


def get_motor_info(engine: CommandEngine, pwm_ctrl: bool = False) -> Optional[MotorInfo]:
    """min/max/desired rotation speed (getMotorInfo :1023-1056); the desired
    field is the PWM reference when the motor is PWM-driven."""
    lo = get_conf(engine, ConfKey.MIN_ROT_FREQ)
    hi = get_conf(engine, ConfKey.MAX_ROT_FREQ)
    desired = get_desired_speed(engine)
    if lo is None or hi is None or desired is None or len(lo) < 2 or len(hi) < 2:
        return None
    rpm, pwm_ref = desired
    return MotorInfo(
        min_speed=struct.unpack_from("<H", lo)[0],
        max_speed=struct.unpack_from("<H", hi)[0],
        desired_speed=pwm_ref if pwm_ctrl else rpm,
    )


def get_mac_addr(engine: CommandEngine) -> Optional[bytes]:
    """6-byte MAC (getDeviceMacAddr :937-955)."""
    data = get_conf(engine, ConfKey.LIDAR_MAC_ADDR)
    return data[:6] if data and len(data) >= 6 else None


def get_ip_conf(engine: CommandEngine) -> Optional[IpConf]:
    """Static IP/netmask/gateway; the GET carries a 2-byte reserved extra
    for backward compatibility (getLidarIpConf :896-913)."""
    data = get_conf(engine, ConfKey.LIDAR_STATIC_IP_ADDR, extra=b"\x00\x00")
    if data is None or len(data) < 12:
        return None
    return IpConf.from_payload(data)


def set_ip_conf(engine: CommandEngine, conf: IpConf) -> bool:
    """SET_LIDAR_CONF of the static-IP key (setLidarIpConf :887-894)."""
    return set_conf(engine, ConfKey.LIDAR_STATIC_IP_ADDR, conf.to_payload())


def get_mode_metadata(engine: CommandEngine, mode_id: int) -> Optional[ScanMode]:
    """Full metadata for ONE mode id — the four-getter query block shared
    by getAllSupportedScanModes (sl_lidar_driver.cpp:529-549) and
    startScanExpress's single-mode lookup (:702-715).  None when any
    field is missing."""
    us = get_mode_us_per_sample(engine, mode_id)
    dist = get_mode_max_distance(engine, mode_id)
    ans = get_mode_ans_type(engine, mode_id)
    name = get_mode_name(engine, mode_id)
    if None in (us, dist, ans, name):
        return None
    return ScanMode(
        id=mode_id, us_per_sample=us, max_distance=dist, ans_type=ans, name=name
    )


def enumerate_scan_modes(engine: CommandEngine) -> list[ScanMode]:
    """All supported modes with metadata (ref getAllSupportedScanModes
    sl_lidar_driver.cpp:518-554)."""
    count = get_scan_mode_count(engine)
    if count is None:
        return []
    modes: list[ScanMode] = []
    for mode_id in range(count):
        mode = get_mode_metadata(engine, mode_id)
        if mode is not None:
            modes.append(mode)
    return modes

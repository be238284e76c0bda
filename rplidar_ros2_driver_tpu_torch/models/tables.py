"""Device model detection tables and capability profiles.

The reference derives everything about a lidar from the high nibble of the
model ID byte in the devinfo response (sl_lidar_driver.cpp:1380-1536):
technology (triangulation vs DTOF), major series (A/C/S/T/M), printable
name, native interface, and native baud rate.  The wrapper layer then folds
that into a DriverProfile (include/lidar_driver_wrapper.hpp:90-118,
src/lidar_driver_wrapper.cpp:145-178).
"""

from __future__ import annotations

import dataclasses
import enum

# Major-ID thresholds (sl_lidar_driver.cpp:382-394).
A2A3_MINUM_MAJOR_ID = 2
BUILTIN_MOTORCTL_MINUM_MAJOR_ID = 6
TOF_C_MINUM_MAJOR_ID = 4
TOF_S_MINUM_MAJOR_ID = 6
TOF_T_MINUM_MAJOR_ID = 9
TOF_M_MINUM_MAJOR_ID = 12
NEWDESIGN_MINUM_MAJOR_ID = TOF_C_MINUM_MAJOR_ID


class TechnologyType(enum.Enum):
    TRIANGULATION = "triangulation"
    DTOF = "dtof"


class MajorType(enum.Enum):
    A_SERIES = "A"
    C_SERIES = "C"
    S_SERIES = "S"
    T_SERIES = "T"
    M_SERIES = "M"


class InterfaceType(enum.Enum):
    UART = "uart"
    ETHERNET = "ethernet"
    UNKNOWN = "unknown"


class ProtocolType(enum.Enum):
    """Wrapper-level strategy split (include/lidar_driver_wrapper.hpp:77-82)."""

    OLD_TYPE = "legacy"   # A-series: DTR/PWM motor, startScan
    NEW_TYPE = "hq"       # S/C-series: RPM control, express modes


def technology_type(model_id: int) -> TechnologyType:
    return (
        TechnologyType.TRIANGULATION
        if (model_id >> 4) < NEWDESIGN_MINUM_MAJOR_ID
        else TechnologyType.DTOF
    )


def major_type(model_id: int) -> MajorType:
    major = model_id >> 4
    if major >= TOF_M_MINUM_MAJOR_ID:
        return MajorType.M_SERIES
    if major >= TOF_T_MINUM_MAJOR_ID:
        return MajorType.T_SERIES
    if major >= TOF_S_MINUM_MAJOR_ID:
        return MajorType.S_SERIES
    if major >= TOF_C_MINUM_MAJOR_ID:
        return MajorType.C_SERIES
    return MajorType.A_SERIES


_SERIES_BASE = {
    MajorType.A_SERIES: 0,
    MajorType.C_SERIES: TOF_C_MINUM_MAJOR_ID - 1,
    MajorType.S_SERIES: TOF_S_MINUM_MAJOR_ID - 1,
    MajorType.T_SERIES: TOF_T_MINUM_MAJOR_ID - 1,
    MajorType.M_SERIES: TOF_M_MINUM_MAJOR_ID - 1,
}


def model_name(model_id: int) -> str:
    """Printable model name, e.g. 0x18 -> 'A1M8', 0x61 -> 'S1M1', 0x41 -> 'C1M1'."""
    mt = major_type(model_id)
    series_idx = (model_id >> 4) - _SERIES_BASE[mt]
    return f"{mt.value}{series_idx}M{model_id & 0xF}"


def native_baudrate(model_id: int, hardware_version: int) -> int:
    """Native UART baud (sl_lidar_driver.cpp:1516-1536); 0 if unknown."""
    major = model_id >> 4
    if major in (1, 2, 3):  # A1..A3
        return 256000 if hardware_version >= 6 else 115200
    if major == 4:  # C series
        return 460800
    if major == 6:  # S1
        return 256000
    if major in (7, 8):  # S2 / S3
        return 460800 if model_id == 0x82 else 1000000
    return 0


def native_interface(model_id: int) -> InterfaceType:
    """Interface family by series (sl_lidar_driver.cpp:1475-1514).

    S-series may be either; the real driver disambiguates by probing the MAC
    address — callers with a live connection should prefer that probe.
    """
    mt = major_type(model_id)
    if mt in (MajorType.A_SERIES, MajorType.M_SERIES, MajorType.C_SERIES):
        return InterfaceType.UART
    if mt is MajorType.T_SERIES:
        return InterfaceType.ETHERNET
    if mt is MajorType.S_SERIES:
        return InterfaceType.UART  # default without a MAC probe
    return InterfaceType.UNKNOWN


def has_builtin_motor_ctrl(model_id: int) -> bool:
    return (model_id >> 4) >= BUILTIN_MOTORCTL_MINUM_MAJOR_ID


# conf protocol appears on triangle lidars at firmware 1.24
# (checkSupportConfigCommands, sl_lidar_driver.cpp:1176-1196)
CONF_MIN_FIRMWARE_VERSION = (0x1 << 8) | 24


def supports_conf_commands(info: "DeviceInfo") -> bool:
    """checkSupportConfigCommands (sl_lidar_driver.cpp:1176-1196):
    new-design models (ND magic: major id >= 4, _checkNDMagicNumber
    :1467-1470) always speak GET/SET_LIDAR_CONF; old triangle units only
    from firmware 1.24.  A gated device must never be sent a conf query —
    it would silently time out per query."""
    if (info.model >> 4) >= NEWDESIGN_MINUM_MAJOR_ID:
        return True
    return info.firmware_version >= CONF_MIN_FIRMWARE_VERSION


class MotorCtrlSupport(enum.Enum):
    """How the motor is driven (checkMotorCtrlSupport,
    sl_lidar_driver.cpp:833-878): built-in RPM control for major id >= 6,
    accessory-board PWM for A2/A3-class units that report the acc-board
    flag, serial DTR toggling otherwise."""

    NONE = "dtr"
    PWM = "pwm"
    RPM = "rpm"


@dataclasses.dataclass
class DeviceInfo:
    """Decoded devinfo response (sl_lidar_cmd.h:334-340)."""

    model: int = 0
    firmware_version: int = 0
    hardware_version: int = 0
    serialnum: bytes = b"\x00" * 16

    @classmethod
    def from_payload(cls, payload: bytes) -> "DeviceInfo":
        if len(payload) < 20:
            raise ValueError("devinfo payload must be 20 bytes")
        return cls(
            model=payload[0],
            firmware_version=int.from_bytes(payload[1:3], "little"),
            hardware_version=payload[3],
            serialnum=bytes(payload[4:20]),
        )

    def to_payload(self) -> bytes:
        return (
            bytes([self.model])
            + self.firmware_version.to_bytes(2, "little")
            + bytes([self.hardware_version])
            + self.serialnum[:16].ljust(16, b"\x00")
        )

    @property
    def serial_str(self) -> str:
        return self.serialnum.hex().upper()

    def summary(self) -> str:
        """Mirrors RealLidarDriver::get_device_info_str (lidar_driver_wrapper.cpp:358-380)."""
        if self.serialnum[:1] == b"\x00":
            return "N/A (Not connected or permission denied)"
        return (
            f"S/N: {self.serial_str}"
            f" | FW: {self.firmware_version >> 8}.{self.firmware_version & 0xFF}"
            f" | HW: {self.hardware_version}"
            f" | Type: {model_name(self.model)}"
        )


@dataclasses.dataclass
class ScanMode:
    """One enumerated scan mode (sl_lidar_driver.h:73-88)."""

    id: int
    us_per_sample: float
    max_distance: float
    ans_type: int
    name: str

    @property
    def samples_per_sec(self) -> float:
        return 1e6 / self.us_per_sample if self.us_per_sample else 0.0


@dataclasses.dataclass
class DriverProfile:
    """Detected capability state cached by the wrapper
    (include/lidar_driver_wrapper.hpp:90-118)."""

    protocol: ProtocolType = ProtocolType.OLD_TYPE
    model_name: str = "unknown"
    hw_max_distance: float = 12.0
    active_mode: str = ""
    active_rpm: int = 600
    apply_geometric_correction: bool = True

    def summary_lines(self) -> list[str]:
        return [
            "========================================",
            "      RPLIDAR DRIVER CONFIG REPORT      ",
            "========================================",
            f" Model       : {self.model_name}",
            f" Protocol    : "
            + ("HQ (New-Type)" if self.protocol is ProtocolType.NEW_TYPE else "Legacy (Old-Type)"),
            f" Active Mode : {self.active_mode}",
            f" Target RPM  : {self.active_rpm}",
            f" Max Range   : {self.hw_max_distance} m",
            f" Geo. Comp.  : "
            + ("ON (device ascend/resample)" if self.apply_geometric_correction else "OFF (raw data)"),
            "========================================",
        ]


def detect_profile(info: DeviceInfo, apply_geometric_correction: bool = True) -> DriverProfile:
    """Model-strategy detection (src/lidar_driver_wrapper.cpp:145-178):
    DTOF or S-series -> NEW_TYPE 40 m (C1 = model 65 named explicitly);
    everything else -> legacy A-series 12 m."""
    tech = technology_type(info.model)
    mt = major_type(info.model)
    if tech is TechnologyType.DTOF or mt is MajorType.S_SERIES:
        name = "RPLIDAR C1" if info.model == 65 else f"{model_name(info.model)} (ToF)"
        return DriverProfile(
            protocol=ProtocolType.NEW_TYPE,
            model_name=name,
            hw_max_distance=40.0,
            apply_geometric_correction=apply_geometric_correction,
        )
    return DriverProfile(
        protocol=ProtocolType.OLD_TYPE,
        model_name="A-Series (Triangulation)",
        hw_max_distance=12.0,
        apply_geometric_correction=apply_geometric_correction,
    )

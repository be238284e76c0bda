"""Legacy compatibility shim.

The reference keeps a facade, ``rp::standalone::rplidar::RPlidarDriver``,
that forwards every call to the modern ``sl::ILidarDriver``
(src/sdk/src/rplidar_driver.cpp:47-199), plus alias headers mapping old
``RPLIDAR_*`` macro names onto ``SL_LIDAR_*`` values (rplidar_cmd.h:42-70,
rplidar_protocol.h, rptypes.h).  This module is the same seam for users
migrating old scripts: a camelCase ``RPlidarDriver`` facade over
:class:`~rplidar_ros2_driver_tpu_torch.driver.interface.LidarDriverInterface`,
and the old constant names bound to the modern protocol enums.
"""

from __future__ import annotations

import warnings
from typing import Optional

from rplidar_ros2_driver_tpu_torch.core.results import DeviceHealth
from rplidar_ros2_driver_tpu_torch.core.types import ScanBatch
from rplidar_ros2_driver_tpu_torch.driver.interface import LidarDriverInterface
from rplidar_ros2_driver_tpu_torch.protocol import constants as c

# ---------------------------------------------------------------------------
# RPLIDAR_* aliases (rplidar_cmd.h:42-70, rplidar_protocol.h:44-52)
# ---------------------------------------------------------------------------

RPLIDAR_CMD_SYNC_BYTE = c.CMD_SYNC_BYTE
RPLIDAR_CMDFLAG_HAS_PAYLOAD = c.CMDFLAG_HAS_PAYLOAD
RPLIDAR_ANS_PKTFLAG_LOOP = c.ANS_PKTFLAG_LOOP

RPLIDAR_CMD_STOP = int(c.Cmd.STOP)
RPLIDAR_CMD_SCAN = int(c.Cmd.SCAN)
RPLIDAR_CMD_FORCE_SCAN = int(c.Cmd.FORCE_SCAN)
RPLIDAR_CMD_RESET = int(c.Cmd.RESET)
RPLIDAR_CMD_EXPRESS_SCAN = int(c.Cmd.EXPRESS_SCAN)
RPLIDAR_CMD_HQ_SCAN = int(c.Cmd.HQ_SCAN)
RPLIDAR_CMD_GET_DEVICE_INFO = int(c.Cmd.GET_DEVICE_INFO)
RPLIDAR_CMD_GET_DEVICE_HEALTH = int(c.Cmd.GET_DEVICE_HEALTH)
RPLIDAR_CMD_GET_SAMPLERATE = int(c.Cmd.GET_SAMPLERATE)
RPLIDAR_CMD_HQ_MOTOR_SPEED_CTRL = int(c.Cmd.HQ_MOTOR_SPEED_CTRL)
RPLIDAR_CMD_GET_LIDAR_CONF = int(c.Cmd.GET_LIDAR_CONF)
RPLIDAR_CMD_SET_LIDAR_CONF = int(c.Cmd.SET_LIDAR_CONF)
RPLIDAR_CMD_SET_MOTOR_PWM = int(c.Cmd.SET_MOTOR_PWM)
RPLIDAR_CMD_GET_ACC_BOARD_FLAG = int(c.Cmd.GET_ACC_BOARD_FLAG)

RPLIDAR_ANS_TYPE_DEVINFO = int(c.Ans.DEVINFO)
RPLIDAR_ANS_TYPE_DEVHEALTH = int(c.Ans.DEVHEALTH)
RPLIDAR_ANS_TYPE_SAMPLE_RATE = int(c.Ans.SAMPLE_RATE)
RPLIDAR_ANS_TYPE_MEASUREMENT = int(c.Ans.MEASUREMENT)
RPLIDAR_ANS_TYPE_MEASUREMENT_CAPSULED = int(c.Ans.MEASUREMENT_CAPSULED)
RPLIDAR_ANS_TYPE_MEASUREMENT_HQ = int(c.Ans.MEASUREMENT_HQ)
RPLIDAR_ANS_TYPE_MEASUREMENT_CAPSULED_ULTRA = int(c.Ans.MEASUREMENT_CAPSULED_ULTRA)
RPLIDAR_ANS_TYPE_MEASUREMENT_DENSE_CAPSULED = int(c.Ans.MEASUREMENT_DENSE_CAPSULED)
RPLIDAR_ANS_TYPE_ACC_BOARD_FLAG = int(c.Ans.ACC_BOARD_FLAG)

RPLIDAR_STATUS_OK = int(c.HealthStatus.OK)
RPLIDAR_STATUS_WARNING = int(c.HealthStatus.WARNING)
RPLIDAR_STATUS_ERROR = int(c.HealthStatus.ERROR)

RPLIDAR_CONF_SCAN_MODE_COUNT = int(c.ConfKey.SCAN_MODE_COUNT)
RPLIDAR_CONF_SCAN_MODE_US_PER_SAMPLE = int(c.ConfKey.SCAN_MODE_US_PER_SAMPLE)
RPLIDAR_CONF_SCAN_MODE_MAX_DISTANCE = int(c.ConfKey.SCAN_MODE_MAX_DISTANCE)
RPLIDAR_CONF_SCAN_MODE_ANS_TYPE = int(c.ConfKey.SCAN_MODE_ANS_TYPE)
RPLIDAR_CONF_SCAN_MODE_TYPICAL = int(c.ConfKey.SCAN_MODE_TYPICAL)
RPLIDAR_CONF_SCAN_MODE_NAME = int(c.ConfKey.SCAN_MODE_NAME)

# legacy measurement bit layout (rplidar_cmd.h node struct)
RPLIDAR_RESP_MEASUREMENT_SYNCBIT = c.MEASUREMENT_SYNCBIT
RPLIDAR_RESP_MEASUREMENT_QUALITY_SHIFT = c.MEASUREMENT_QUALITY_SHIFT
RPLIDAR_RESP_MEASUREMENT_CHECKBIT = c.MEASUREMENT_CHECKBIT
RPLIDAR_RESP_MEASUREMENT_ANGLE_SHIFT = c.MEASUREMENT_ANGLE_SHIFT

MAX_SCAN_NODES = 8192  # sl_lidar_driver.cpp:378


def _deprecated(old: str, new: str) -> None:
    warnings.warn(
        f"{old} is the legacy API; prefer {new}", DeprecationWarning, stacklevel=3
    )


class RPlidarDriver:
    """CamelCase facade forwarding to a modern driver instance.

    Mirrors the delegation pattern of rplidar_driver.cpp:67-197: every
    method is a one-line forward.  Construct with :meth:`CreateDriver` (the
    legacy factory name) or wrap an existing driver.
    """

    def __init__(self, impl: Optional[LidarDriverInterface] = None, **real_kwargs) -> None:
        if impl is None:
            from rplidar_ros2_driver_tpu_torch.driver.real import RealLidarDriver

            impl = RealLidarDriver(**real_kwargs)
        self._impl = impl

    # -- legacy factory pair (rplidar_driver.h CreateDriver/DisposeDriver) --
    @classmethod
    def CreateDriver(cls, **kwargs) -> "RPlidarDriver":
        _deprecated("RPlidarDriver.CreateDriver", "RealLidarDriver()")
        return cls(**kwargs)

    @staticmethod
    def DisposeDriver(drv: "RPlidarDriver") -> None:
        drv.disconnect()

    # -- connection ---------------------------------------------------------
    def connect(self, port: str, baudrate: int, flag: int = 0) -> bool:
        if flag:
            # the legacy flag argument was already unused by the reference
            # shim (rplidar_driver.cpp connect forwards it nowhere); modern
            # geometric compensation is always on here
            import warnings

            warnings.warn(
                f"RPlidarDriver.connect flag={flag:#x} is ignored "
                "(use RealLidarDriver.connect(use_geometric_compensation=...))",
                RuntimeWarning,
                stacklevel=2,
            )
        return self._impl.connect(port, baudrate, True)

    def disconnect(self) -> None:
        self._impl.disconnect()

    def isConnected(self) -> bool:
        return self._impl.is_connected()

    def reset(self) -> None:
        self._impl.reset()

    # -- info / health ------------------------------------------------------
    def getDeviceInfo(self) -> str:
        return self._impl.get_device_info_str()

    def getHealth(self) -> DeviceHealth:
        return self._impl.get_health()

    # -- motor --------------------------------------------------------------
    def startMotor(self, rpm: int = 0) -> bool:
        return self._impl.set_motor_speed(rpm if rpm else 600)

    def stopMotor(self) -> None:
        self._impl.stop_motor()

    def setMotorSpeed(self, rpm: int) -> bool:
        return self._impl.set_motor_speed(rpm)

    # -- scanning -----------------------------------------------------------
    def startScan(self, force: bool = False, use_typical: bool = True) -> bool:
        """Legacy auto-start: detect + start in the preferred mode.

        ``force`` maps to FORCE_SCAN 0x21 (scan despite a failed health
        check) on backends that support it (RealLidarDriver.force_scan);
        elsewhere it warns and falls back to the health-gated path.
        """
        if force:
            if self._impl.force_scan():
                return True
            warnings.warn(
                "startScan(force=True): this backend has no FORCE_SCAN; "
                "starting with the normal health-gated path",
                RuntimeWarning,
                stacklevel=2,
            )
        self._impl.detect_and_init_strategy()
        return self._impl.start_motor("", 0)

    def startScanExpress(self, fixed_angle: bool, scan_mode: str, rpm: int = 0) -> bool:
        if fixed_angle:
            warnings.warn(
                "startScanExpress(fixed_angle=True) is not supported and is ignored",
                RuntimeWarning,
                stacklevel=2,
            )
        return self._impl.start_motor(scan_mode, rpm)

    def stop(self) -> None:
        self._impl.stop_motor()

    def grabScanDataHq(self, timeout_ms: int = 2000) -> Optional[ScanBatch]:
        return self._impl.grab_scan_data(timeout_ms / 1000.0)

    def ascendScanData(self, batch: ScanBatch) -> ScanBatch:
        from rplidar_ros2_driver_tpu_torch.ops.ascend import ascend_scan

        out, _ = ascend_scan(batch)
        return out

    # escape hatch, mirroring how the facade exposes the sl driver
    @property
    def impl(self) -> LidarDriverInterface:
        return self._impl

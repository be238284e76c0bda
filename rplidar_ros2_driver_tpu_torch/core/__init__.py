from rplidar_ros2_driver_tpu_torch.core.config import DriverParams
from rplidar_ros2_driver_tpu_torch.core.results import DeviceHealth, Result, is_fail, is_ok
from rplidar_ros2_driver_tpu_torch.core.types import MAX_SCAN_NODES, LaserScanMsg, ScanBatch

__all__ = [
    "DeviceHealth",
    "DriverParams",
    "LaserScanMsg",
    "MAX_SCAN_NODES",
    "Result",
    "ScanBatch",
    "is_fail",
    "is_ok",
]

"""Abstract driver contract — the testability seam.

Mirrors the reference's ``LidarDriverInterface``
(include/lidar_driver_wrapper.hpp:139-267): the node layer depends on this
and nothing below it, so the whole node stack (FSM, conversion, filters,
publishing, diagnostics) runs against the dummy backend without hardware.

Difference from the reference: ``grab_scan_data`` returns a
:class:`ScanBatch` (padded struct-of-arrays torch tensors) instead of an
array-of-structs vector.
"""

from __future__ import annotations

import abc
from typing import Optional

from rplidar_ros2_driver_tpu_torch.core.results import DeviceHealth
from rplidar_ros2_driver_tpu_torch.core.types import ScanBatch


class LidarDriverInterface(abc.ABC):
    """The 12-method driver contract the node layer programs against."""

    @abc.abstractmethod
    def connect(self, port: str, baudrate: int, use_geometric_compensation: bool) -> bool:
        """Open the transport and fetch device info."""

    @abc.abstractmethod
    def disconnect(self) -> None: ...

    @abc.abstractmethod
    def is_connected(self) -> bool: ...

    @abc.abstractmethod
    def start_motor(self, scan_mode: str, rpm: int) -> bool:
        """Spin up and begin streaming (model-specific strategy)."""

    @abc.abstractmethod
    def stop_motor(self) -> None: ...

    @abc.abstractmethod
    def get_health(self) -> DeviceHealth: ...

    @abc.abstractmethod
    def reset(self) -> None:
        """Device soft reset (cmd 0x40)."""

    @abc.abstractmethod
    def grab_scan_data(self, timeout_s: float = 2.0) -> Optional[ScanBatch]:
        """Block for the next complete revolution; None on timeout/failure."""

    def grab_scan_data_with_timestamp(
        self, timeout_s: float = 2.0
    ) -> Optional[tuple[ScanBatch, float, float]]:
        """(batch, revolution-begin time, duration) — hardware-timestamped
        grab (grabScanDataHqWithTimeStamp, sl_lidar_driver.cpp:783-806).
        Backends without hardware timing inherit this default: grab time and
        zero duration, which consumers treat as 'derive times yourself'."""
        import time

        batch = self.grab_scan_data(timeout_s)
        if batch is None:
            return None
        return batch, time.monotonic(), 0.0

    def force_scan(self, rpm: int = 0) -> bool:
        """FORCE_SCAN (cmd 0x21): stream despite a failed device health
        gate.  Default: unsupported — callers fall back to the normal
        health-gated start (startScan force path, sl_lidar_driver.cpp:586)."""
        return False

    def grab_scan_host(
        self, timeout_s: float = 2.0
    ) -> Optional[tuple[dict, float, float]]:
        """(host arrays, begin time, duration): the revolution as numpy
        angle_q14/dist_q2/quality/flag — the transfer-free form the filter
        chain ingests.  Hardware backends override this to avoid touching
        any device in the grab path; the default pulls from the batch."""
        got = self.grab_scan_data_with_timestamp(timeout_s)
        if got is None:
            return None
        batch, ts0, duration = got
        return batch.to_host(), ts0, duration

    @abc.abstractmethod
    def detect_and_init_strategy(self) -> None:
        """Classify the device (A vs S/C series) and cache a DriverProfile."""

    @abc.abstractmethod
    def print_summary(self) -> None: ...

    @abc.abstractmethod
    def get_hw_max_distance(self) -> float: ...

    @abc.abstractmethod
    def set_motor_speed(self, rpm: int) -> bool: ...

    # -- informational helpers used by the node (non-abstract) --

    def is_new_type(self) -> bool:
        """New-protocol devices publish quality unshifted
        (src/rplidar_node.cpp:589-592)."""
        return False

    def get_device_info_str(self) -> str:
        return "[Dummy] Virtual Driver"

    def rx_scheduling_class(self) -> Optional[int]:
        """Scheduling class of the transport's rx thread (2 = SCHED_RR,
        1 = nice boost, 0 = default, -1 = no elevation support); None for
        drivers without an rx thread (dummy) — /diagnostics omits the
        field then."""
        return None

"""Hardware-free simulated driver.

Parity with the reference's ``DummyLidarDriver``
(src/lidar_driver_wrapper.cpp:417-471): always connected and healthy,
synthesizes a 360-point ring at 2 m +/- 0.5 m sine with the phase advancing
0.1 rad per scan, quality 200, ~10 Hz.  The synthesis runs on the host
(CPU tensors): the dummy is a scan *source*, standing where the lidar's
wire bytes would, so the node's one host->device upload per revolution is
the same as with a real device.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Optional

import torch

from rplidar_ros2_driver_tpu_torch.core.results import DeviceHealth
from rplidar_ros2_driver_tpu_torch.core.types import MAX_SCAN_NODES, ScanBatch
from rplidar_ros2_driver_tpu_torch.driver.interface import LidarDriverInterface
from rplidar_ros2_driver_tpu_torch.models.tables import DriverProfile, ProtocolType


def synth_scan(phase: float, count: int = 360, capacity: int = MAX_SCAN_NODES) -> ScanBatch:
    """Synthetic ring scan as a padded CPU ScanBatch, in float32 like the
    JAX package's (f32 ``sin`` may differ by an ulp between the two, so
    ``dist_q2`` agrees to +/-1 q2)."""
    i = torch.arange(capacity, dtype=torch.int32)
    live = i < count
    fi = i.to(torch.float32)
    angle_q14 = (fi * (16384.0 / 90.0)).to(torch.int32) & 0xFFFF
    dist_m = 2.0 + 0.5 * torch.sin(
        fi * (math.pi / 180.0) + torch.tensor(phase, dtype=torch.float32)
    )
    zero = torch.zeros_like(i)
    return ScanBatch(
        angle_q14=torch.where(live, angle_q14, zero),
        dist_q2=torch.where(live, (dist_m * 4000.0).to(torch.int32), zero),
        quality=torch.where(live, torch.full_like(i, 200), zero),
        flag=(i == 0).to(torch.int32),
        valid=live,
        count=torch.tensor(count, dtype=torch.int32),
    )


class DummyLidarDriver(LidarDriverInterface):
    """Simulation/CI backend selected by the ``dummy_mode`` parameter."""

    def __init__(self, scan_rate_hz: float = 10.0, count: int = 360) -> None:
        self._scan_rate_hz = scan_rate_hz
        self._count = count
        self._phase = 0.0
        self._lock = threading.Lock()
        self.profile = DriverProfile(
            protocol=ProtocolType.NEW_TYPE,
            model_name="[Dummy] Virtual RPLIDAR",
            hw_max_distance=40.0,
            active_mode="Simulated",
        )

    # -- trivial lifecycle (dummy is always healthy/connected) --

    def connect(self, port: str, baudrate: int, use_geometric_compensation: bool) -> bool:
        return True

    def disconnect(self) -> None: ...

    def is_connected(self) -> bool:
        return True

    def start_motor(self, scan_mode: str, rpm: int) -> bool:
        return True

    def stop_motor(self) -> None: ...

    def get_health(self) -> DeviceHealth:
        return DeviceHealth.OK

    def reset(self) -> None: ...

    def detect_and_init_strategy(self) -> None: ...

    def print_summary(self) -> None:
        print("[Dummy] Virtual RPLIDAR device ready.")

    def get_hw_max_distance(self) -> float:
        return 40.0

    def set_motor_speed(self, rpm: int) -> bool:
        return True

    def grab_scan_data(self, timeout_s: float = 2.0) -> Optional[ScanBatch]:
        with self._lock:
            self._phase += 0.1
            phase = self._phase
        if self._scan_rate_hz > 0:
            time.sleep(1.0 / self._scan_rate_hz)
        return synth_scan(phase, count=self._count)

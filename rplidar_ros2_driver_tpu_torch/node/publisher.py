"""Publishing seam.

The reference publishes over DDS via rclcpp with configurable QoS
(src/rplidar_node.cpp:154-172).  Here publishing is an interface: the node
calls it, and deployments plug in a ROS 2 bridge, a zero-copy intra-process
queue, or the default in-memory collector (tests / bench).

QoS semantics carried over: ``best_effort`` drops when the subscriber lags
(bounded queue, newest wins), ``reliable`` blocks/keeps all.
"""

from __future__ import annotations

import collections
import threading
from typing import Any, Callable, Optional

from rplidar_ros2_driver_tpu_torch.node.messages import (
    DiagnosticStatus,
    LaserScanHost,
    PointCloudHost,
    PoseHost,
    StaticTransform,
)


class PublisherBase:
    def publish_scan(self, msg: LaserScanHost) -> None: ...

    def publish_cloud(self, msg: PointCloudHost) -> None: ...

    def publish_pose(self, msg: PoseHost) -> None: ...

    def publish_tf_static(self, tf: StaticTransform) -> None: ...

    def publish_diagnostics(self, status: DiagnosticStatus) -> None: ...


class CollectingPublisher(PublisherBase):
    """Default sink: bounded deques, thread-safe; best_effort semantics."""

    def __init__(self, maxlen: int = 64, reliable: bool = False) -> None:
        self._lock = threading.Lock()
        self.reliable = reliable
        self.scans: collections.deque = collections.deque(maxlen=None if reliable else maxlen)
        self.clouds: collections.deque = collections.deque(maxlen=None if reliable else maxlen)
        self.poses: collections.deque = collections.deque(maxlen=None if reliable else maxlen)
        self.tf_static: list[StaticTransform] = []
        self.diagnostics: collections.deque = collections.deque(maxlen=256)
        self.scan_count = 0

    def publish_scan(self, msg: LaserScanHost) -> None:
        with self._lock:
            self.scans.append(msg)
            self.scan_count += 1

    def publish_cloud(self, msg: PointCloudHost) -> None:
        with self._lock:
            self.clouds.append(msg)

    def publish_pose(self, msg: PoseHost) -> None:
        with self._lock:
            self.poses.append(msg)

    def publish_tf_static(self, tf: StaticTransform) -> None:
        with self._lock:
            self.tf_static.append(tf)

    def publish_diagnostics(self, status: DiagnosticStatus) -> None:
        with self._lock:
            self.diagnostics.append(status)


class CallbackPublisher(PublisherBase):
    """Routes messages to user callbacks (ROS bridge adapter point)."""

    def __init__(
        self,
        on_scan: Optional[Callable[[LaserScanHost], Any]] = None,
        on_cloud: Optional[Callable[[PointCloudHost], Any]] = None,
        on_tf: Optional[Callable[[StaticTransform], Any]] = None,
        on_diag: Optional[Callable[[DiagnosticStatus], Any]] = None,
        on_pose: Optional[Callable[[PoseHost], Any]] = None,
    ) -> None:
        self._on_scan = on_scan
        self._on_cloud = on_cloud
        self._on_tf = on_tf
        self._on_diag = on_diag
        self._on_pose = on_pose

    def publish_scan(self, msg: LaserScanHost) -> None:
        if self._on_scan:
            self._on_scan(msg)

    def publish_cloud(self, msg: PointCloudHost) -> None:
        if self._on_cloud:
            self._on_cloud(msg)

    def publish_pose(self, msg: PoseHost) -> None:
        if self._on_pose:
            self._on_pose(msg)

    def publish_tf_static(self, tf: StaticTransform) -> None:
        if self._on_tf:
            self._on_tf(tf)

    def publish_diagnostics(self, status: DiagnosticStatus) -> None:
        if self._on_diag:
            self._on_diag(status)

"""Host-side message types published by the node.

Array analogs of ``sensor_msgs/LaserScan``, ``sensor_msgs/PointCloud2``
(XY subset), ``tf2_msgs/TFMessage`` (static transform), and
``diagnostic_msgs/DiagnosticStatus`` — the four things the reference node
publishes (src/rplidar_node.cpp:154-208,490-545,558-683).  Kept free of any
ROS dependency; a rclpy bridge only needs to map fields 1:1.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np


@dataclasses.dataclass
class LaserScanHost:
    stamp: float
    frame_id: str
    angle_min: float
    angle_max: float
    angle_increment: float
    time_increment: float
    scan_time: float
    range_min: float
    range_max: float
    ranges: np.ndarray       # (beam_count,) float32, +inf = no return
    intensities: np.ndarray  # (beam_count,)


@dataclasses.dataclass
class PointCloudHost:
    stamp: float
    frame_id: str
    points_xy: np.ndarray    # (N, 2) float32 metres
    voxel: Optional[np.ndarray] = None  # (G, G) occupancy counts


@dataclasses.dataclass
class PoseHost:
    """2-D pose estimate from the SLAM front-end — the array analog of
    ``geometry_msgs/PoseStamped`` (yaw-only; a rclpy bridge maps theta
    to a z-axis quaternion)."""

    stamp: float
    frame_id: str          # the map frame ("map")
    child_frame_id: str    # the sensor frame (params.frame_id)
    x_m: float
    y_m: float
    theta_rad: float
    score: int = 0         # raw correlation score (0 = match rejected)
    matched_points: int = 0
    map_revision: int = 0  # revolutions absorbed into the map


@dataclasses.dataclass
class StaticTransform:
    """base_link -> frame_id identity transform
    (src/rplidar_node.cpp:177-201)."""

    parent: str = "base_link"
    child: str = "laser"
    translation: tuple = (0.0, 0.0, 0.0)
    rotation_wxyz: tuple = (1.0, 0.0, 0.0, 0.0)


class DiagLevel(enum.IntEnum):
    OK = 0
    WARN = 1
    ERROR = 2
    STALE = 3


@dataclasses.dataclass
class DiagnosticStatus:
    level: DiagLevel
    name: str
    message: str
    hardware_id: str
    values: dict[str, str] = dataclasses.field(default_factory=dict)

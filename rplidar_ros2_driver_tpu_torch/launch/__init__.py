"""Deployment layer: lifecycle bringup and composition.

The reference ships two launch files:

  * ``launch/rplidar.launch.py`` — starts the lifecycle node, emits
    CONFIGURE on process start and ACTIVATE once the node reaches
    ``inactive`` (launch/rplidar.launch.py:109-141).  Here that is
    :func:`launch_lifecycle`.
  * ``launch/composition.launch.py`` — loads the node as a plugin into a
    ComposableNodeContainer with ``use_intra_process_comms: True`` for
    zero-copy delivery (launch/composition.launch.py:44-78).  Here that is
    :class:`NodeContainer` + :class:`IntraProcessBus`: publishers hand the
    *same Python/numpy objects* to in-process subscribers — no
    serialization, the moral equivalent of rclcpp intra-process comms.
"""

from rplidar_ros2_driver_tpu_torch.launch.bus import BusPublisher, IntraProcessBus
from rplidar_ros2_driver_tpu_torch.launch.container import NodeContainer
from rplidar_ros2_driver_tpu_torch.launch.lifecycle_launch import (
    default_params_path,
    launch_lifecycle,
)

__all__ = [
    "BusPublisher",
    "IntraProcessBus",
    "NodeContainer",
    "default_params_path",
    "launch_lifecycle",
]

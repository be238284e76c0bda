"""Deployment layer: lifecycle bringup.

The reference's ``launch/rplidar.launch.py`` starts the lifecycle node,
emits CONFIGURE on process start and ACTIVATE once the node reaches
``inactive`` (launch/rplidar.launch.py:109-141).  Here that is
:func:`launch_lifecycle`.
"""

from rplidar_ros2_driver_tpu_torch.launch.lifecycle_launch import (
    default_params_path,
    launch_lifecycle,
)

__all__ = ["default_params_path", "launch_lifecycle"]

"""Lifecycle bringup — the ``rplidar.launch.py`` equivalent.

The reference launch file declares a single ``params_file`` argument (YAML
is the single source of truth, launch/rplidar.launch.py:86-93), starts the
lifecycle node, emits CONFIGURE on process start, and emits ACTIVATE when
the node reports ``inactive`` (:109-141).  :func:`launch_lifecycle` does the
same in-process.
"""

from __future__ import annotations

import os
from typing import Optional

from rplidar_ros2_driver_tpu_torch.core.config import DriverParams
from rplidar_ros2_driver_tpu_torch.node.node import RPlidarNode


def default_params_path() -> str:
    """Shipped default parameter file (param/rplidar.yaml)."""
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return os.path.join(here, "param", "rplidar.yaml")


def launch_lifecycle(
    params_file: Optional[str] = None,
    *,
    overrides: Optional[dict] = None,
    auto_activate: bool = True,
    **node_kwargs,
) -> RPlidarNode:
    """Build the node from YAML and drive it to ACTIVE.

    ``overrides`` patches individual parameters after the YAML load (the
    in-process analog of editing the file, since the reference removed
    per-param launch arguments).
    """
    path = params_file or default_params_path()
    params = DriverParams.from_yaml(path) if os.path.exists(path) else DriverParams()
    if overrides:
        import dataclasses

        params = dataclasses.replace(params, **overrides)
        params.validate()
    node = RPlidarNode(params, **node_kwargs)
    # OnProcessStart -> CONFIGURE (launch/rplidar.launch.py:109-122)
    if not node.configure():
        return node
    # OnStateTransition(inactive) -> ACTIVATE (:127-141)
    if auto_activate:
        node.activate()
    return node

"""SLAM back-end: loop-closure detection + pose-graph correction.

The front-end (mapping/mapper.FleetMapper) matches scan to map every
revolution; this package closes the loop — the submap library, batched
candidate matching against it and the fixed-point pose-graph relaxation
(ops/loop_close.py, ops/pose_graph.py).
"""

from rplidar_ros2_driver_tpu_torch.slam.loop import (  # noqa: F401
    LoopClosureEngine,
    LoopStatus,
    loop_config_from_params,
    resolve_loop_backend,
)

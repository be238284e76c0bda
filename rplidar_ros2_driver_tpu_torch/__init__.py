"""rplidar_ros2_driver_tpu_torch — the PyTorch/CUDA package of the RPLIDAR
driver framework.

It does what the JAX package ``rplidar_ros2_driver_tpu`` does, one slice at
a time, on an NVIDIA Hopper card: host runtime (lifecycle, FSM, dummy
driver, publishing) in Python, per-point tensor math in PyTorch, and the
temporal-median kernels of the filter chain written by hand in CUDA C++
(``csrc/``, built with ``nvcc`` at first use).  It never imports JAX or the
JAX package; its tests hold it to the JAX package on the CPU.

Layer map (top to bottom):
  node/      — lifecycle node, 5-state fault-tolerant FSM, publishing
  launch/    — lifecycle launch, intra-process bus, composable-node container
  parallel/  — the (stream, beam) mesh, the sharded fleet service, the pods
  mapping/, slam/ — SLAM front-end mapper, loop closure, the world map
  filters/   — ScanFilterChain (the north-star seam)
  driver/    — driver contract, dummy, real driver, simulator, fused ingest
  protocol/, native/ — wire protocol engine and the native I/O library
  ops/       — tensor ops: filter step, LaserScan conversion, kernel wrappers
  csrc/      — CUDA C++ kernel sources
  scenarios/ — procedural worlds, trajectories and accuracy metrics
  tools/, utils/ — CLI helpers, scenario matrix, checkpoints, build, probes
"""

__version__ = "0.2.0"  # keep in lockstep with pyproject.toml

from rplidar_ros2_driver_tpu_torch.core.config import DriverParams
from rplidar_ros2_driver_tpu_torch.core.types import MAX_SCAN_NODES, LaserScanMsg, ScanBatch

__all__ = ["DriverParams", "LaserScanMsg", "MAX_SCAN_NODES", "ScanBatch", "__version__"]

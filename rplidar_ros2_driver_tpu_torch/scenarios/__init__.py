"""Scenario foundry: seeded procedural worlds, ground-truth robot
trajectories, and accuracy metrics against that ground truth.

- :mod:`foundry` — segment-list worlds (multi-room floorplans,
  feature-starved corridors, loops, specular/dropout regions, moving
  obstacles) with a vectorized 2-D raycaster.  ``FoundryScene.dist_mm``
  is the sim's ``SimConfig.scene`` provider contract: a pure function
  of (seed, rev, beam), byte-deterministic across chunkings.
- :mod:`trajectory` — scripted and organic (seeded velocity-noise)
  robot paths emitting per-revolution ground-truth poses, including
  genuine return-to-start loops.
- :mod:`metrics` — end-pose error in map cells and occupancy-map F1
  against the scene's ground-truth raster, on the mapper's exact
  int32 lattice.
"""

from rplidar_ros2_driver_tpu_torch.scenarios.foundry import (  # noqa: F401
    FoundryScene,
    SceneSpec,
    build_scene,
)
from rplidar_ros2_driver_tpu_torch.scenarios.trajectory import (  # noqa: F401
    Trajectory,
)

"""``python -m rplidar_ros2_driver_tpu_torch.tools.graftlint [--json]``."""

import sys

from rplidar_ros2_driver_tpu_torch.tools.graftlint.runner import main

sys.exit(main())

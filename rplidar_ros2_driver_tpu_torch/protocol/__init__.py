"""Wire protocol: framing codec, command engine, conf protocol, CRC32 and
the timing model — a copy of the JAX package's ``protocol/``, so importing
it never runs the JAX package."""

from rplidar_ros2_driver_tpu_torch.protocol.codec import (
    AnsHeader,
    ResponseDecoder,
    encode_command,
)
from rplidar_ros2_driver_tpu_torch.protocol.constants import Ans, Cmd, ConfKey, HealthStatus
from rplidar_ros2_driver_tpu_torch.protocol.crc import crc32_padded

__all__ = [
    "Ans",
    "AnsHeader",
    "Cmd",
    "ConfKey",
    "HealthStatus",
    "ResponseDecoder",
    "crc32_padded",
    "encode_command",
]

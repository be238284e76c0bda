"""Core array data model of the PyTorch package.

The reference driver moves scans around as
``std::vector<sl_lidar_response_measurement_node_hq_t>`` — an
array-of-structs of ``{angle_z_q14:u16, dist_mm_q2:u32, quality:u8, flag:u8}``
(reference: src/sdk/include/sl_lidar_cmd.h:272-278).  Here the same
information lives as a struct-of-arrays of torch tensors with a *fixed
padded shape*: variable point counts (the reference's ``count``
out-parameter, src/sdk/include/sl_lidar_driver.h:427-435) become a 0-d
``count`` tensor plus a validity mask, so no per-revolution shape ever
reaches the device.

All integer fields are int32, the dtype the JAX package uses, so the two
packages exchange scans as numpy arrays without conversion.  Every
constructor takes an explicit ``device``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# The reference caps a complete scan at 8192 nodes
# (src/sdk/src/sl_lidar_driver.cpp:378, src/lidar_driver_wrapper.cpp:316).
# We keep the same cap as the padded static width of every scan array.
MAX_SCAN_NODES = 8192


@dataclasses.dataclass(frozen=True)
class ScanBatch:
    """A fixed-width batch of measurement nodes (one complete revolution).

    Mirrors the information content of the reference's HQ node vector plus
    its ``count``.  All tensors are ``(MAX_SCAN_NODES,)`` (or the width
    given at construction) on one device; ``valid`` is the padding mask and
    ``count`` the 0-d number of valid nodes (a prefix).
    """

    angle_q14: torch.Tensor  # int32, 0..65535 (Q14 z-angle; 65536 == 360 deg)
    dist_q2: torch.Tensor    # int32, quarter-mm; 0 == invalid measurement
    quality: torch.Tensor    # int32, 0..255
    flag: torch.Tensor       # int32, bit0 = scan-start sync
    valid: torch.Tensor      # bool padding mask
    count: torch.Tensor      # int32 0-d

    @property
    def num_nodes(self) -> int:
        return self.angle_q14.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.angle_q14.device

    @staticmethod
    def from_numpy(
        angle_q14: np.ndarray,
        dist_q2: np.ndarray,
        quality: np.ndarray,
        flag: np.ndarray | None = None,
        n: int = MAX_SCAN_NODES,
        *,
        device,
    ) -> "ScanBatch":
        """Pad host arrays of length ``count <= n`` into a ScanBatch on
        ``device`` (one host->device copy per field)."""
        count = int(np.asarray(angle_q14).shape[0])
        if count > n:
            raise ValueError(f"scan of {count} nodes exceeds capacity {n}")

        def pad(a) -> torch.Tensor:
            out = np.zeros((n,), np.int32)
            out[:count] = np.asarray(a).astype(np.int32)
            return torch.from_numpy(out).to(device)

        if flag is None:
            flag = np.zeros((count,), np.int32)
        valid = np.zeros((n,), bool)
        valid[:count] = True
        return ScanBatch(
            angle_q14=pad(angle_q14),
            dist_q2=pad(dist_q2),
            quality=pad(quality),
            flag=pad(flag),
            valid=torch.from_numpy(valid).to(device),
            count=torch.tensor(count, dtype=torch.int32, device=device),
        )

    def to(self, device) -> "ScanBatch":
        """The same batch on ``device`` (no copy when already there)."""
        return ScanBatch(
            **{f.name: getattr(self, f.name).to(device) for f in dataclasses.fields(self)}
        )

    def to_host(self) -> dict[str, np.ndarray]:
        """Device -> host, trimmed to the valid prefix."""
        c = int(self.count)
        return {
            "angle_q14": self.angle_q14[..., :c].cpu().numpy(),
            "dist_q2": self.dist_q2[..., :c].cpu().numpy(),
            "quality": self.quality[..., :c].cpu().numpy(),
            "flag": self.flag[..., :c].cpu().numpy(),
        }


@dataclasses.dataclass(frozen=True)
class LaserScanMsg:
    """Tensor analog of ``sensor_msgs/LaserScan`` (fixed-width, padded).

    ``ranges``/``intensities`` are padded to a static width; ``beam_count``
    gives the number of live beams.  angle_min/angle_max/range_min/range_max/
    scan_time/time_increment/angle_increment are 0-d float32 tensors,
    matching the message fields filled by the reference
    (src/rplidar_node.cpp:617-643).
    """

    ranges: torch.Tensor           # float32 (n,) padded with +inf
    intensities: torch.Tensor      # float32 (n,)
    beam_count: torch.Tensor       # int32 0-d
    angle_min: torch.Tensor        # float32 0-d
    angle_max: torch.Tensor        # float32 0-d
    angle_increment: torch.Tensor  # float32 0-d
    time_increment: torch.Tensor   # float32 0-d
    scan_time: torch.Tensor        # float32 0-d
    range_min: torch.Tensor        # float32 0-d
    range_max: torch.Tensor        # float32 0-d

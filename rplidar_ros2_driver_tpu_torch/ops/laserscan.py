"""ScanBatch -> LaserScan conversion on tensors.

Tensor reformulation of the reference's ``publish_scan``
(src/rplidar_node.cpp:558-683), bit-identical to the JAX package's
``ops/laserscan.py``: drop zero-distance nodes, Q14->radians, Q2->metres,
quality->intensity (legacy protocol shifts right by 2), wrap angles, sort
by angle (stable, as the reference's std::sort of a vector with distinct
keys and JAX's argsort are), then either

  * Mode A (``scan_processing``): resample onto a fixed angular grid with
    min-range conflict resolution and REP-117 +inf padding (:632-662), or
  * Mode B: raw CW-reversed mapping (:663-680).

Conflict resolution packs ``(dist_q2 << 8) | intensity`` into one int32
so a single ``amin`` scatter picks the winning range *and* its intensity.
Output tensors stay padded at the ScanBatch width; ``beam_count`` gives
the live prefix.  Divisions by a scalar go through 0-d tensors: PyTorch
evaluates ``python_number / tensor`` as a reciprocal times the number,
which is not a correctly rounded division.
"""

from __future__ import annotations

import math

import torch

from rplidar_ros2_driver_tpu_torch.core.types import LaserScanMsg, ScanBatch

TWO_PI = 2.0 * math.pi


def to_laserscan(
    batch: ScanBatch,
    scan_duration_s,
    max_range_m,
    *,
    scan_processing: bool = False,
    inverted: bool = False,
    is_new_type: bool = True,
) -> LaserScanMsg:
    n = batch.num_nodes
    dev = batch.device
    f32 = torch.float32

    def scalar(v) -> torch.Tensor:
        return torch.full((), float(v), dtype=f32, device=dev)

    two_pi = scalar(TWO_PI)
    valid = batch.valid & (batch.dist_q2 != 0)
    count = valid.sum().to(torch.int32)

    angle_deg = batch.angle_q14.to(f32) * (90.0 / 16384.0)
    angle = angle_deg * (math.pi / 180.0)
    angle = torch.where(angle < 0.0, angle + two_pi, angle)
    angle = torch.where(angle >= two_pi, angle - two_pi, angle)
    dist_m = batch.dist_q2.to(f32) * (1.0 / 4000.0)
    quality = batch.quality if is_new_type else (batch.quality >> 2)
    intensity = quality.to(f32)

    # masked stable sort by angle: invalid nodes to the tail
    key = angle.masked_fill(~valid, math.inf)
    order = torch.argsort(key, stable=True)
    angle_s = key[order]
    dist_s = dist_m[order]
    dist_q2_s = batch.dist_q2[order]
    inten_s = intensity[order]
    qual_s = quality[order]
    valid_s = valid[order]

    countf = count.clamp(min=1).to(f32)
    scan_time = scalar(scan_duration_s)

    if scan_processing:
        # Mode A: fixed angular grid, one beam per valid point count
        angle_increment = two_pi / countf
        time_increment = scan_time / countf
        a = angle_s
        if inverted:
            a = two_pi - a
            a = torch.where(a >= two_pi, a - two_pi, a)
        index = (a / angle_increment).to(torch.int32)  # trunc, matches C cast
        in_range = valid_s & (index >= 0) & (index < count)
        index = index.clamp(0, n - 1)
        # pack (dist_q2, intensity byte) for atomic min-conflict resolution
        packed = (dist_q2_s << 8) | qual_s.clamp(0, 255)
        packed = packed.masked_fill(~in_range, 0x7FFFFFFF)
        grid = torch.full((n,), 0x7FFFFFFF, dtype=torch.int32, device=dev)
        grid.scatter_reduce_(0, index.long(), packed, reduce="amin", include_self=True)
        hit = grid != 0x7FFFFFFF
        ranges = ((grid >> 8).to(f32) * (1.0 / 4000.0)).masked_fill(~hit, math.inf)
        intensities = (grid & 0xFF).to(f32).masked_fill(~hit, 0.0)
    else:
        # Mode B: raw mapping, rplidar turns CW so order is reversed unless
        # inverted (src/rplidar_node.cpp:672-678)
        denom = (count - 1).clamp(min=1).to(f32)
        angle_increment = two_pi / denom
        time_increment = scan_time / denom
        i = torch.arange(n, dtype=torch.int32, device=dev)
        idx = i if inverted else count - 1 - i
        # route invalid (padding) points to a spill slot n that is cut off
        idx = torch.where(valid_s, idx, torch.full_like(idx, n)).long()
        ranges = torch.full((n + 1,), math.inf, dtype=f32, device=dev)
        ranges.scatter_(0, idx, dist_s)
        intensities = torch.zeros((n + 1,), dtype=f32, device=dev)
        intensities.scatter_(0, idx, inten_s)
        ranges, intensities = ranges[:n], intensities[:n]

    return LaserScanMsg(
        ranges=ranges,
        intensities=intensities,
        beam_count=count,
        angle_min=scalar(0.0),
        angle_max=two_pi,
        angle_increment=angle_increment,
        time_increment=time_increment,
        scan_time=scan_time,
        range_min=scalar(0.15),
        range_max=scalar(max_range_m),
    )

"""Angle-compensation: synthesize angles for invalid points, then sort.

Equivalent of the reference's ``ascendScanData_``
(sl_lidar_driver.cpp:128-184), applied when ``angle_compensate`` is on
(src/lidar_driver_wrapper.cpp:329), and of the JAX package's
``ops/ascend.py``, bit for bit.

The reference tunes the head backwards from the first valid point, tunes
the tail, then *overwrites every invalid index >= 1* with
``angle[0] + i * inc`` (so only the head-tuned ``angle[0]`` actually
survives), and finally sorts by angle.  The tensor form computes that net
effect:

  * ``angle[0]``   — first-valid angle walked back ``fv`` steps of
    ``360/count`` deg, floor-clamped at 0,
  * invalid ``i``  — ``angle[0] + i*inc`` with a single 360-wrap,
  * stable sort by (quantized) angle; scans with no valid point return
    ``ok=False`` and the batch unchanged.

The synthesized ``angle[0] + i*inc`` is rounded once, as a fused
multiply-add — the JAX package's CPU lowering contracts that one (and not
the head walk-back ``a_fv - fv*inc``), and the parity tests pin which.
Float64 evaluation of a float32 product-plus-sum is exact before its
single rounding to float32.
"""

from __future__ import annotations

import torch

from rplidar_ros2_driver_tpu_torch.core.types import ScanBatch


def _fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a + b*c in float32 with one rounding (b*c is exact in float64)."""
    return (a.double() + b.double() * c.double()).float()


def ascend_scan(batch: ScanBatch) -> tuple[ScanBatch, torch.Tensor]:
    n = batch.num_nodes
    dev = batch.device
    live = batch.valid
    has_range = live & (batch.dist_q2 != 0)
    count = batch.count.clamp(min=1)
    any_valid = has_range.any()

    angle_f = batch.angle_q14.to(torch.float32) * (90.0 / 16384.0)
    inc = torch.full((), 360.0, dtype=torch.float32, device=dev) / count.to(torch.float32)

    idx = torch.arange(n, dtype=torch.int32, device=dev)
    fv = has_range.to(torch.int32).argmax()  # first index with a real measurement
    a_fv = angle_f[fv]

    a0 = torch.where(
        has_range[0], angle_f[0],
        (a_fv - fv.to(torch.float32) * inc).clamp(min=0.0),
    )
    synth = _fma_f32(a0, idx.to(torch.float32), inc)
    synth = torch.where(synth > 360.0, synth - 360.0, synth)
    new_angle_f = torch.where(
        has_range | (idx == 0), torch.where(idx == 0, a0, angle_f), synth
    )
    new_q14 = (new_angle_f * (16384.0 / 90.0)).to(torch.int32)

    # keep original values when compensation cannot run
    q14_out = torch.where(any_valid & live, new_q14, batch.angle_q14)

    sort_key = q14_out.masked_fill(~live, 0x7FFFFFFF)
    order = torch.argsort(sort_key, stable=True)
    out = ScanBatch(
        angle_q14=q14_out[order],
        dist_q2=batch.dist_q2[order],
        quality=batch.quality[order],
        flag=batch.flag[order],
        valid=live[order],
        count=batch.count,
    )
    return out, any_valid


def apply_angle_compensation(batch: ScanBatch, enabled: bool) -> ScanBatch:
    """The single 'ascend if configured' policy point of the raw publish
    path (reference: ascendScanData applied inside grab when
    angle_compensate, src/lidar_driver_wrapper.cpp:329)."""
    if not enabled:
        return batch
    out, _ = ascend_scan(batch)
    return out

"""Wrappers of the temporal-median CUDA kernels (csrc/).

Three kernels replace the JAX package's Pallas TPU kernels:

  * B1 :func:`temporal_median_kernel` (csrc/median.cu) —
    ``temporal_median_pallas`` (streaming step, ``median_backend="pallas"``):
    per-beam lower median of a (W, B) ring.
  * B2 :func:`sorted_replace_kernel` (csrc/median.cu) —
    ``sorted_replace_pallas`` (streaming step, ``"inc_pallas"``):
    delete/insert on the carried sorted window, plus its lower median, in
    one pass.
  * B3 :func:`sliding_median_kernel` (csrc/sliding_median.cu) —
    ``sliding_median_pallas`` (fused K-scan path, ``"pallas"``): the K
    sliding per-beam lower medians of a (W + K, B) history stripe.

Each wrapper checks dtype, shape, contiguity and device.  A tensor on the
CPU runs the kernel's plain PyTorch version (:func:`temporal_median_plain`,
:func:`sorted_replace_plain`, :func:`sliding_median_plain`); a CUDA tensor
launches the kernel (built from the source at first use,
utils/cuda_build.py) or raises — there is no fallback.  ``launch_counts``
counts the launches of each kernel and ``card_launches`` each kernel's on
each card; only a launch adds to them.  What bounds the kernels and how
they are built is in each source's header note.
Each launches through the slim launch path (utils/launch.py: its C entry
resolved once, the raw current stream, the device index handed to C).
"""

from __future__ import annotations

import functools

import torch

from rplidar_ros2_driver_tpu_torch.ops.filters import (
    median_from_sorted,
    sliding_median,
    sorted_replace,
    temporal_median,
)
from rplidar_ros2_driver_tpu_torch.utils.launch import (
    I,
    VP,
    KernelEntry,
    count_launch,
    current_stream,
)

# kernel name -> launches since the last reset_launch_counts()
launch_counts = {"temporal_median": 0, "sorted_replace": 0, "sliding_median": 0}
# (kernel name, card index) -> launches since the last reset_launch_counts()
card_launches: dict = {}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0
    card_launches.clear()


_FLOAT32 = torch.float32
# the C entries: pointers, sizes, the card's index, the stream
_B1 = KernelEntry("median", "temporal_median_f32", [VP] * 2 + [I] * 3 + [VP])
_B2 = KernelEntry("median", "sorted_replace_f32", [VP] * 5 + [I] * 3 + [VP])
_B3 = KernelEntry("sliding_median", "sliding_median_f32", [VP] * 2 + [I] * 6 + [VP])

# B3's launch geometry (csrc/sliding_median.cu kBeams, kQ, kMaxWarps,
# kStageBytes): a block takes SLIDING_BEAMS beams and SLIDING_Q candidate
# rows per thread, up to SLIDING_MAX_WARPS warps, and stages its rows in at
# most SLIDING_STAGE_BYTES of shared memory
SLIDING_BEAMS = 32
SLIDING_Q = 6
SLIDING_MAX_WARPS = 8
SLIDING_STAGE_BYTES = 48 * 1024


def _check(name: str, t: torch.Tensor, shape: tuple, device: torch.device) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")


def temporal_median_plain(window: torch.Tensor) -> torch.Tensor:
    """Plain version of B1: sort the ring, pick the lower median."""
    return temporal_median(window)


def sorted_replace_plain(
    sorted_w: torch.Tensor, old_v: torch.Tensor, new_v: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of B2: :func:`sorted_replace` then
    :func:`median_from_sorted`."""
    out = sorted_replace(sorted_w, old_v, new_v)
    return out, median_from_sorted(out)


def temporal_median_kernel(window: torch.Tensor) -> torch.Tensor:
    """(W, B) float32 ring (+inf = missing) -> (B,) lower medians."""
    if window.ndim != 2 or window.shape[0] < 1:
        raise ValueError(f"window must be (W>=1, B), got {tuple(window.shape)}")
    if window.dtype != _FLOAT32:
        raise TypeError(f"window must be float32, got {window.dtype}")
    if not window.is_contiguous():
        raise ValueError("window must be contiguous")
    if not window.is_cuda:
        if window.device.type == "cpu":
            return temporal_median_plain(window)
        raise RuntimeError(f"no temporal-median kernel for device {window.device}")
    w, b = window.shape
    out = window.new_empty((b,))  # torch.empty with window's dtype and device
    if b == 0:
        return out
    dev = window.get_device()
    _B1(window.data_ptr(), out.data_ptr(), w, b, dev, current_stream(dev))
    count_launch(launch_counts, card_launches, "temporal_median", dev)
    return out


def sorted_replace_kernel(
    sorted_w: torch.Tensor, old_v: torch.Tensor, new_v: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sorted (W, B) window, evicted (B,), inserted (B,) -> (updated
    window (W, B), its lower medians (B,)).  ``old_v`` must be present in
    each column (it came from the same ring)."""
    if sorted_w.ndim != 2 or sorted_w.shape[0] < 1:
        raise ValueError(f"sorted_w must be (W>=1, B), got {tuple(sorted_w.shape)}")
    w, b = sorted_w.shape
    dev = sorted_w.device
    _check("sorted_w", sorted_w, (w, b), dev)
    _check("old_v", old_v, (b,), dev)
    _check("new_v", new_v, (b,), dev)
    if dev.type == "cpu":
        return sorted_replace_plain(sorted_w, old_v, new_v)
    if dev.type != "cuda":
        raise RuntimeError(f"no sorted-replace kernel for device {dev}")
    out = torch.empty((w, b), dtype=torch.float32, device=dev)
    med = torch.empty((b,), dtype=torch.float32, device=dev)
    if b == 0:
        return out, med
    _B2(sorted_w.data_ptr(), old_v.data_ptr(), new_v.data_ptr(), out.data_ptr(),
        med.data_ptr(), w, b, dev.index, current_stream(dev.index))
    count_launch(launch_counts, card_launches, "sorted_replace", dev.index)
    return out, med


def sliding_median_plain(ext: torch.Tensor, window: int) -> torch.Tensor:
    """Plain version of B3: :func:`sliding_median` (unfold the K windows,
    sort each, pick the lower median)."""
    return sliding_median(ext, window)


@functools.lru_cache(maxsize=64)
def sliding_plan(w: int, k: int) -> tuple[int, int]:
    """B3's launch plan for a (w + k, B) stripe: (warps per block, rows a
    block stages), rows 0 for the route that reads device memory directly.
    A block of ``warps`` warps owns R = SLIDING_Q x warps candidate rows
    and reads at most min(R + 2w - 2, w + k - 1) rows; the most warps whose
    rows fit SLIDING_STAGE_BYTES are staged, else the unstaged route runs
    with the most warps."""
    row_bytes = SLIDING_BEAMS * 4
    warps = SLIDING_MAX_WARPS
    while warps >= 1:
        rows = min(SLIDING_Q * warps + 2 * w - 2, w + k - 1)
        if rows * row_bytes <= SLIDING_STAGE_BYTES:
            return warps, rows
        warps //= 2
    return SLIDING_MAX_WARPS, 0


def sliding_median_kernel(ext: torch.Tensor, window: int) -> torch.Tensor:
    """(W + K, B) float32 history stripe (+inf = missing) -> (K, B): row i
    is the per-beam lower median of ``ext[i+1 : i+1+W]``."""
    if not isinstance(window, int) or window < 1:
        raise ValueError(f"window must be an int >= 1, got {window!r}")
    if ext.ndim != 2 or ext.shape[0] < window:
        raise ValueError(f"ext must be (W+K, B) with W={window}, got {tuple(ext.shape)}")
    wk, b = ext.shape
    k = wk - window
    _check("ext", ext, (wk, b), ext.device)
    if ext.device.type == "cpu":
        return sliding_median_plain(ext, window)
    if ext.device.type != "cuda":
        raise RuntimeError(f"no sliding-median kernel for device {ext.device}")
    out = torch.empty((k, b), dtype=torch.float32, device=ext.device)
    if k == 0 or b == 0:
        return out
    dev = ext.device.index
    warps, rows = sliding_plan(window, k)
    _B3(ext.data_ptr(), out.data_ptr(), window, k, b, warps, rows, dev, current_stream(dev))
    count_launch(launch_counts, card_launches, "sliding_median", dev)
    return out

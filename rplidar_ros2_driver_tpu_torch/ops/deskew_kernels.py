"""Wrappers of the de-skew CUDA kernels (csrc/deskew.cu).

Two kernels replace the JAX package's Pallas TPU kernels of
``ops/pallas_deskew.py`` (``deskew_backend="pallas"``):

  * B4 :func:`beam_min_kernel` — ``beam_min_pallas``: per-row, per-beam
    int32 min of node values grouped by beam index (RECON_EMPTY where no
    node landed).  The fused ingest launches it once per tick for the
    sub-sweep rasterizer (all streams' rows) and once per tick that
    completes a revolution for the profiles (all streams' revolution
    slots).
  * B5 :func:`shift_sad_kernel` — ``shift_sad_pallas``: per-row scores of
    the circular-shift candidates of the motion search.  The candidate
    order and the first-min argmin stay in shared code
    (ops/deskew.estimate_motion).

Each wrapper checks dtype, shape, contiguity and device in the same few
steps (``is_cuda``, the card's index as an int, ``new_empty``).  A tensor on the
CPU runs the kernel's plain PyTorch version (:func:`beam_min_plain`,
:func:`shift_sad_plain` — also the ``deskew_backend="xla"`` arm); a CUDA
tensor launches the kernel (built from the source at first use,
utils/cuda_build.py) or raises — there is no fallback.  ``launch_counts``
counts the launches of each kernel and ``card_launches`` each kernel's on
each card; only a launch adds to them.  The kernels' design is in the
source's header note.  Both launch through the slim launch path
(utils/launch.py).
"""

from __future__ import annotations

import torch

from rplidar_ros2_driver_tpu_torch.ops.filters import _INT_INF
from rplidar_ros2_driver_tpu_torch.utils.launch import (
    I,
    VP,
    KernelEntry,
    count_launch,
    current_stream,
)

_EMPTY = _INT_INF
_INT32 = torch.int32

# kernel name -> launches since the last reset_launch_counts()
launch_counts = {"beam_min": 0, "shift_sad": 0}
# (kernel name, card index) -> launches since the last reset_launch_counts()
card_launches: dict = {}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0
    card_launches.clear()


# the C entries: pointers, sizes, the card's index, the stream
_B4 = KernelEntry("deskew", "beam_min_i32", [VP] * 3 + [I] * 4 + [VP])
_B5 = KernelEntry("deskew", "shift_sad_i32", [VP] * 4 + [I] * 6 + [VP])
# B5 stages a row's two profiles in 48 KB of shared memory
# (csrc/deskew.cu kSadMaxBeams)
SHIFT_SAD_MAX_BEAMS = 6 * 1024


# ---------------------------------------------------------------------------
# B4: per-beam min
# ---------------------------------------------------------------------------


def beam_min_plain(beam: torch.Tensor, values: torch.Tensor, nbeams: int,
                   block: int = 256) -> torch.Tensor:
    """Plain version of B4: (R, n) int32 beams and values -> (R, nbeams),
    the JAX ``xla`` arm's dense masked min tiled over beam blocks
    (out[r, b] = min over j of where(beam[r, j] == b, values[r, j], EMPTY))."""
    empty = torch.full((), _EMPTY, dtype=torch.int32, device=values.device)
    outs = []
    for t0 in range(0, nbeams, block):
        bt = torch.arange(t0, min(t0 + block, nbeams), dtype=torch.int32, device=beam.device)
        m = torch.where(beam[:, None, :] == bt[None, :, None], values[:, None, :], empty)
        outs.append(m.amin(dim=2) if m.shape[2] else empty.expand(m.shape[:2]))
    return torch.cat(outs, dim=1)


def beam_min_kernel(beam: torch.Tensor, values: torch.Tensor, nbeams: int) -> torch.Tensor:
    """B4: (R, n) int32 beam indices in [0, nbeams) and int32 values
    (RECON_EMPTY marking dropped nodes) -> (R, nbeams) int32 per-beam
    minima, RECON_EMPTY where no node landed."""
    if beam.ndim != 2:
        raise ValueError(f"beam must be (rows, nodes), got {tuple(beam.shape)}")
    if not 1 <= nbeams <= 8192:
        raise ValueError(f"nbeams must be in [1, 8192], got {nbeams}")
    if beam.dtype != _INT32:
        raise TypeError(f"beam must be int32, got {beam.dtype}")
    if values.dtype != _INT32:
        raise TypeError(f"values must be int32, got {values.dtype}")
    if values.shape != beam.shape:
        raise ValueError(f"values must have shape {tuple(beam.shape)}, got {tuple(values.shape)}")
    if not beam.is_contiguous():
        raise ValueError("beam must be contiguous")
    if not values.is_contiguous():
        raise ValueError("values must be contiguous")
    if not beam.is_cuda:
        if values.device != beam.device:
            raise ValueError(f"values is on {values.device}, expected {beam.device}")
        if beam.device.type == "cpu":
            return beam_min_plain(beam, values, nbeams)
        raise RuntimeError(f"no beam-min kernel for device {beam.device}")
    dev = beam.get_device()
    if values.get_device() != dev:  # -1 off the card
        raise ValueError(f"values is on {values.device}, expected {beam.device}")
    rows, n = beam.shape
    # new_empty: torch.empty with beam's dtype (int32) and device
    out = beam.new_empty((rows, nbeams))
    if rows == 0:
        return out
    _B4(beam.data_ptr(), values.data_ptr(), out.data_ptr(), rows, n, nbeams, dev,
        current_stream(dev))
    count_launch(launch_counts, card_launches, "beam_min", dev)
    return out


# ---------------------------------------------------------------------------
# B5: shift-search scores
# ---------------------------------------------------------------------------


def shift_sad_plain(prev: torch.Tensor, cur: torch.Tensor, shifts: torch.Tensor,
                    min_valid: int, max_trans: int) -> torch.Tensor:
    """Plain version of B5: (R, D) int32 profiles, (C,) int32 shifts ->
    (R, C) scores.  The rolled plane ``roll(cur, s)`` is a gather at
    ``(d - s) mod D`` (no roll by a device value)."""
    d = cur.shape[-1]
    idx = torch.remainder(
        torch.arange(d, dtype=torch.int64, device=cur.device)[None, :] - shifts[:, None].long(), d
    )                                                            # (C, D)
    rolled = cur[:, idx]                                         # (R, C, D)
    p = prev[:, None, :]
    both = (p != _EMPTY) & (rolled != _EMPTY)
    diff = torch.where(both, rolled - p, 0).clamp(-max_trans, max_trans)
    sad = diff.abs().sum(-1, dtype=torch.int32)
    cnt = both.sum(-1, dtype=torch.int32)
    score = torch.div(sad, cnt.clamp(min=1), rounding_mode="floor")
    return torch.where(cnt >= min_valid, score, _EMPTY)


def shift_sad_kernel(prev: torch.Tensor, cur: torch.Tensor, shifts: torch.Tensor,
                     min_valid: int, max_trans: int) -> torch.Tensor:
    """B5: (R, D) int32 previous and current profiles (RECON_EMPTY = no
    return), (C,) int32 circular shifts -> (R, C) int32 clamped mean-|Δ|
    scores, RECON_EMPTY where fewer than ``min_valid`` beams overlap."""
    if prev.ndim != 2 or shifts.ndim != 1:
        raise ValueError(
            f"expected (rows, D) profiles and (C,) shifts, got {tuple(prev.shape)} "
            f"and {tuple(shifts.shape)}"
        )
    rows, d = prev.shape
    if not 1 <= d <= SHIFT_SAD_MAX_BEAMS:
        raise ValueError(f"profiles must have 1 to {SHIFT_SAD_MAX_BEAMS} beams, got {d}")
    if prev.dtype != _INT32:
        raise TypeError(f"prev must be int32, got {prev.dtype}")
    if cur.dtype != _INT32:
        raise TypeError(f"cur must be int32, got {cur.dtype}")
    if shifts.dtype != _INT32:
        raise TypeError(f"shifts must be int32, got {shifts.dtype}")
    if cur.shape != prev.shape:
        raise ValueError(f"cur must have shape {(rows, d)}, got {tuple(cur.shape)}")
    if not (prev.is_contiguous() and cur.is_contiguous() and shifts.is_contiguous()):
        raise ValueError("prev, cur and shifts must be contiguous")
    if not prev.is_cuda:
        if cur.device != prev.device or shifts.device != prev.device:
            raise ValueError(f"cur and shifts must be on {prev.device}, got {cur.device} and "
                             f"{shifts.device}")
        if prev.device.type == "cpu":
            return shift_sad_plain(prev, cur, shifts, min_valid, max_trans)
        raise RuntimeError(f"no shift-search kernel for device {prev.device}")
    dev = prev.get_device()
    if cur.get_device() != dev or shifts.get_device() != dev:  # -1 off the card
        raise ValueError(f"cur and shifts must be on {prev.device}, got {cur.device} and "
                         f"{shifts.device}")
    c = shifts.shape[0]
    # new_empty: torch.empty with prev's dtype (int32) and device
    out = prev.new_empty((rows, c))
    if rows == 0 or c == 0:
        return out
    _B5(prev.data_ptr(), cur.data_ptr(), shifts.data_ptr(), out.data_ptr(), rows, c, d,
        min_valid, max_trans, dev, current_stream(dev))
    count_launch(launch_counts, card_launches, "shift_sad", dev)
    return out

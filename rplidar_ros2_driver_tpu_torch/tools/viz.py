"""Scan and map rendering — the rviz-config analog, numpy only.

A copy of the JAX package's ``tools/viz.py``: LaserScan -> top-down image,
a Q10 log-odds map -> image with a trajectory overlay, binary PGM output
and a terminal preview.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

from rplidar_ros2_driver_tpu_torch.node.messages import LaserScanHost


def scan_to_image(
    scan: LaserScanHost,
    *,
    size_px: int = 256,
    view_range_m: Optional[float] = None,
    point_weight: int = 255,
) -> np.ndarray:
    """Rasterize a LaserScan to a top-down (size_px, size_px) uint8 image:
    sensor at the centre, +x right, +y up; out-of-range and non-finite
    returns are dropped."""
    rng = view_range_m or (scan.range_max if math.isfinite(scan.range_max) else 40.0)
    n = scan.ranges.shape[0]
    angles = scan.angle_min + np.arange(n) * scan.angle_increment
    r = np.asarray(scan.ranges, np.float64)
    ok = np.isfinite(r) & (r >= scan.range_min) & (r <= rng)
    x = r[ok] * np.cos(angles[ok])
    y = r[ok] * np.sin(angles[ok])
    half = size_px / 2.0
    scale = half / rng
    col = np.clip((x * scale + half).astype(np.int64), 0, size_px - 1)
    row = np.clip((half - y * scale).astype(np.int64), 0, size_px - 1)
    img = np.zeros((size_px, size_px), np.uint8)
    img[row, col] = point_weight
    return img


def map_to_image(
    log_odds: np.ndarray, clamp_q: int, *, flip_y: bool = True
) -> np.ndarray:
    """Render a Q10 log-odds grid to uint8: 0 certainly free, 255
    certainly occupied, 128 unknown; [ix, iy] becomes +x right, +y up."""
    lo = np.asarray(log_odds, np.int64)
    img = np.clip((lo + clamp_q) * 255 // (2 * clamp_q), 0, 255).astype(np.uint8)
    img = img.T  # [ix, iy] -> [row=y, col=x]
    return img[::-1] if flip_y else img


def draw_trajectory(
    img: np.ndarray,
    traj_xy_m,
    cell_m: float,
    *,
    value: int = 255,
    flip_y: bool = True,
) -> np.ndarray:
    """Overlay an (K, 2) metric trajectory onto a :func:`map_to_image`
    image (same conventions).  Returns a copy; out-of-map poses are
    clipped to the border."""
    out = np.asarray(img).copy()
    size = out.shape[0]
    half = size // 2
    traj = np.asarray(traj_xy_m, np.float64).reshape(-1, 2)
    if traj.size == 0:
        return out
    col = np.clip(np.floor(traj[:, 0] / cell_m).astype(np.int64) + half, 0, size - 1)
    row = np.clip(np.floor(traj[:, 1] / cell_m).astype(np.int64) + half, 0, size - 1)
    if flip_y:
        row = size - 1 - row
    out[row, col] = value
    return out


def save_pgm(img: np.ndarray, path: str) -> None:
    """Write a binary PGM."""
    h, w = img.shape
    with open(path, "wb") as f:
        f.write(b"P5\n%d %d\n255\n" % (w, h))
        f.write(np.ascontiguousarray(img, np.uint8).tobytes())


def ascii_preview(img: np.ndarray, width: int = 64) -> str:
    """Downsample to a terminal-sized ASCII view."""
    h, w = img.shape
    step = max(1, w // width)
    rows = []
    for r0 in range(0, h - step + 1, step * 2):  # chars are ~2x tall
        line = []
        for c0 in range(0, w - step + 1, step):
            block = img[r0 : r0 + step * 2, c0 : c0 + step]
            line.append("#" if block.any() else ".")
        rows.append("".join(line))
    return "\n".join(rows)

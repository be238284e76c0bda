"""Ground-truth accuracy metrics on the mapper's exact int32 lattice.

Two numbers per scenario cell (ISSUE 19 / ROADMAP item 4):

- **end-pose error in cells** — Euclidean distance between the
  mapper's final pose and the ground-truth pose, both expressed in the
  pose lattice (sub-cell units, ``SUB`` per cell), divided by ``SUB``
  so the unit is map cells.  A truth pose offset by exactly ``k * SUB``
  sub-units therefore scores exactly ``k`` cells.
- **map F1** — harmonic precision/recall of ``log_odds > 0`` against a
  ground-truth occupancy raster.  A byte-equal raster scores 1.0; an
  all-empty prediction against a non-empty truth scores 0.0.

The truth raster for F1 is built from the scene's *visible* geometry:
clean ground-truth raycast endpoints quantized through the SAME
``quantize_points_np`` / rotation-table arithmetic the mapper uses —
so a perfect mapper really can reach F1 1.0, and the score is not
diluted by walls the sensor never saw.
"""

from __future__ import annotations

import math

import numpy as np

from rplidar_ros2_driver_tpu_torch.ops.scan_match import (
    SUB,
    SUB_BITS,
    MapConfig,
    rotation_table,
)
from rplidar_ros2_driver_tpu_torch.ops.scan_match_ref import (
    quantize_points_np,
    rotate_points_np,
)


def pose_to_lattice(x_m: float, y_m: float, heading_rad: float,
                    cfg: MapConfig) -> np.ndarray:
    """Quantize a metric pose (relative to the map origin / start pose)
    onto the mapper's (3,) int32 pose lattice: sub-cell translation and
    theta-division heading."""
    px = int(round(x_m / cfg.cell_m * SUB))
    py = int(round(y_m / cfg.cell_m * SUB))
    pth = int(round(heading_rad / (2.0 * math.pi) * cfg.theta_divisions))
    return np.asarray([px, py, pth % cfg.theta_divisions], np.int32)


def end_pose_error_cells(pose_q: np.ndarray, truth_q: np.ndarray) -> float:
    """Euclidean end-pose error in map cells between two lattice poses."""
    dx = float(pose_q[0]) - float(truth_q[0])
    dy = float(pose_q[1]) - float(truth_q[1])
    return math.hypot(dx, dy) / SUB


def scan_points_xy(thetas_deg: np.ndarray, dists_mm: np.ndarray):
    """Sensor-frame Cartesian points + validity mask from one
    revolution of (theta, range) returns; range 0 marks no-return."""
    th = np.radians(np.asarray(thetas_deg, np.float64))
    d_m = np.asarray(dists_mm, np.float64) / 1000.0
    xy = np.stack([d_m * np.cos(th), d_m * np.sin(th)], axis=1)
    return xy.astype(np.float32), np.asarray(dists_mm, np.float64) > 0.0


def visible_truth_occupancy(
    scene, thetas_deg: np.ndarray, revs, truth_poses_q: np.ndarray,
    cfg: MapConfig,
) -> np.ndarray:
    """(grid, grid) bool raster of every cell a perfect mapper would
    mark occupied: clean ground-truth raycast endpoints per revolution,
    pushed through the mapper's own quantize/rotate/shift arithmetic at
    the ground-truth lattice poses."""
    g = cfg.grid
    center = (g // 2) * SUB
    table = rotation_table(cfg.theta_divisions)
    occ = np.zeros((g, g), bool)
    for i, rev in enumerate(revs):
        dists = scene.truth_dist_mm(
            thetas_deg, np.full(len(thetas_deg), int(rev), np.int64)
        )
        xy, mask = scan_points_xy(thetas_deg, dists)
        pq, ok = quantize_points_np(xy, mask, cfg)
        pose = truth_poses_q[i]
        cos_q, sin_q = table[pose[2], 0], table[pose[2], 1]
        wx, wy = rotate_points_np(pq, cos_q, sin_q)
        wx, wy = wx + pose[0] + center, wy + pose[1] + center
        cx, cy = wx >> SUB_BITS, wy >> SUB_BITS
        inb = ok & (cx >= 0) & (cx < g) & (cy >= 0) & (cy < g)
        occ[cx[inb], cy[inb]] = True
    return occ


def map_f1(log_odds: np.ndarray, truth_occ: np.ndarray,
           thresh_q: int = 0) -> float:
    """F1 of the occupancy prediction ``log_odds > thresh_q`` against a
    bool truth raster.  Empty-vs-empty is a perfect 1.0; a prediction
    with no true positives scores 0.0."""
    pred = np.asarray(log_odds) > thresh_q
    truth = np.asarray(truth_occ, bool)
    tp = int(np.sum(pred & truth))
    fp = int(np.sum(pred & ~truth))
    fn = int(np.sum(~pred & truth))
    if tp == 0:
        return 1.0 if (fp == 0 and fn == 0) else 0.0
    return 2.0 * tp / (2.0 * tp + fp + fn)

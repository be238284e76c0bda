"""NumPy golden reference for the pose-graph solver (ops/pose_graph.py).

A copy of the JAX package's ``ops/pose_graph_ref.py`` with its imports
pointed at this package: a literal numpy transcription of the relaxation,
step for step.  The datapath is integer end to end, so it is bit-exact
against the port's batched solver and the JAX package's
(tests/test_torch_pose_graph.py).
"""

from __future__ import annotations

import numpy as np

from rplidar_ros2_driver_tpu_torch.ops.pose_graph import PoseGraphConfig
from rplidar_ros2_driver_tpu_torch.ops.scan_match import rotation_table
from rplidar_ros2_driver_tpu_torch.ops.scan_match_ref import rotate_points_np


def _rotate_np(x, y, cos_q, sin_q):
    """rotate_rows on split planes (the ref twin keeps the packed-point
    helper; restate it here for split coordinates)."""
    pq = np.stack([x, y], axis=-1)
    return rotate_points_np(pq, cos_q, sin_q)


def wrap_steps_np(d, div: int):
    half = div // 2
    return np.mod(d + half, div) - half


def pose_compose_np(p, z, table, div: int):
    p = np.asarray(p)
    z = np.asarray(z)
    cos_q = table[:, 0][p[..., 2]]
    sin_q = table[:, 1][p[..., 2]]
    rx, ry = _rotate_np(z[..., 0], z[..., 1], cos_q, sin_q)
    return np.stack(
        [p[..., 0] + rx, p[..., 1] + ry, np.mod(p[..., 2] + z[..., 2], div)],
        axis=-1,
    ).astype(np.int32)


def pose_relative_np(a, b, table, div: int):
    a = np.asarray(a)
    b = np.asarray(b)
    cos_q = table[:, 0][a[..., 2]]
    sin_q = table[:, 1][a[..., 2]]
    rx, ry = _rotate_np(
        b[..., 0] - a[..., 0], b[..., 1] - a[..., 1], cos_q, -sin_q
    )
    return np.stack(
        [rx, ry, np.mod(b[..., 2] - a[..., 2], div)], axis=-1
    ).astype(np.int32)


def rel_inverse_np(z, table, div: int):
    z = np.asarray(z)
    inv_th = np.mod(-z[..., 2], div)
    cos_q = table[:, 0][inv_th]
    sin_q = table[:, 1][inv_th]
    rx, ry = _rotate_np(z[..., 0], z[..., 1], cos_q, sin_q)
    return np.stack([-rx, -ry, inv_th], axis=-1).astype(np.int32)


def solve_pose_graph_np(nodes0, cons, cfg: PoseGraphConfig):
    """The literal twin of ops/pose_graph.solve_pose_graph_impl."""
    m, div = cfg.max_nodes, cfg.theta_divisions
    table = rotation_table(div)
    lim = cfg.t_limit_sub
    cons = np.asarray(cons, np.int32)
    ci = np.clip(cons[:, 0], 0, m - 1)
    cj = np.clip(cons[:, 1], 0, m - 1)
    wgt = np.clip(cons[:, 5], 0, cfg.weight_max)
    zx = np.clip(cons[:, 2], -2 * lim, 2 * lim)
    zy = np.clip(cons[:, 3], -2 * lim, 2 * lim)
    zth = cons[:, 4]
    movable = (np.arange(m, dtype=np.int32) > 0)[:, None]

    nodes = np.asarray(nodes0, np.int32).copy()
    for _ in range(cfg.iters):
        pi = nodes[ci]
        pj = nodes[cj]
        cos_q = table[:, 0][pi[:, 2]]
        sin_q = table[:, 1][pi[:, 2]]
        rx, ry = _rotate_np(zx, zy, cos_q, sin_q)
        res = np.stack([
            (pi[:, 0] + rx - pj[:, 0]) * wgt,
            (pi[:, 1] + ry - pj[:, 1]) * wgt,
            wrap_steps_np(pi[:, 2] + zth - pj[:, 2], div) * wgt,
        ], axis=1).astype(np.int32)
        acc = np.zeros((m, 3), dtype=np.int32)
        np.add.at(acc, cj, res)
        np.add.at(acc, ci, -res)
        deg = np.zeros((m,), dtype=np.int32)
        np.add.at(deg, cj, wgt)
        np.add.at(deg, ci, wgt)
        den = 2 * np.maximum(deg, 1)
        corr = (np.sign(acc) * (np.abs(acc) // den[:, None])).astype(
            np.int32
        )
        nodes = np.where(movable, nodes + corr, nodes)
        nodes = np.stack([
            np.clip(nodes[:, 0], -lim, lim),
            np.clip(nodes[:, 1], -lim, lim),
            np.mod(nodes[:, 2], div),
        ], axis=1).astype(np.int32)
    return nodes

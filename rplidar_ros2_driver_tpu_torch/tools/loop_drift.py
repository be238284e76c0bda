"""A scripted drifting SLAM front-end and its return-to-start trace.

The port's copy of ``bench.py``'s ``_DriftingFrontEnd`` and
``_loop_drift_trace`` (config 17, the SLAM back-end A/B), built on this
package's ``ops/scan_match_ref``.  A clean synthetic scene cannot make a
correlative matcher drift (it re-corrects any nudge against its own map),
so the drift enters as data: :class:`DriftingFrontEnd` rasterizes each
revolution at a caller-supplied, drift-injected pose with no matching, and
resets its grid at each submap epoch so that every finalized plane carries
only its own epoch's frame.  It has the mapper surface
``slam/loop.LoopClosureEngine`` reads (``cfg``, ``streams``, ``device``,
``last_inputs``, ``snapshot_stream``, ``reanchor_stream``).

Used by ``chip_smoke.py``'s loop phase and tests/test_torch_loop_close.py.
"""

from __future__ import annotations

import numpy as np

from rplidar_ros2_driver_tpu_torch.mapping.mapper import PoseEstimate, map_config_from_params
from rplidar_ros2_driver_tpu_torch.ops.scan_match import SUB, pose_to_metric
from rplidar_ros2_driver_tpu_torch.ops.scan_match_ref import quantize_points_np, update_map_np


class DriftingFrontEnd:
    """Maps rasterized at the poses the caller gives, one numpy update per
    stream a revolution; the grid resets every ``window_revs``."""

    def __init__(self, params, streams: int, beams: int, window_revs: int) -> None:
        self.cfg = map_config_from_params(params, beams)
        self.streams = streams
        self.device = None
        self.window_revs = window_revs
        g = self.cfg.grid
        self.log_odds = np.zeros((streams, g, g), np.int32)
        self.pose = np.zeros((streams, 3), np.int32)
        self.rev = np.zeros(streams, np.int64)
        self.last_inputs = None

    def submit(self, pts, masks, poses_q) -> list:
        live = np.ones(self.streams, np.int32)
        self.last_inputs = (pts, masks, live)
        ests = []
        for i in range(self.streams):
            if self.rev[i] % self.window_revs == 0:
                self.log_odds[i] = 0  # windowed submap epoch
            self.pose[i] = poses_q[i]
            self.rev[i] += 1
            pq, ok = quantize_points_np(pts[i], masks[i], self.cfg)
            self.log_odds[i] = update_map_np(self.log_odds[i], self.pose[i], pq, ok, self.cfg)
            x, y, th = pose_to_metric(self.pose[i], self.cfg)
            ests.append(PoseEstimate(
                x_m=x, y_m=y, theta_rad=th, score=1, matched_points=int(ok.sum()),
                revision=int(self.rev[i]), pose_q=self.pose[i].copy(),
            ))
        return ests

    def snapshot_stream(self, i: int) -> dict:
        return {"log_odds": self.log_odds[i].copy(), "pose": self.pose[i].copy()}

    def reanchor_stream(self, i: int, pose_q) -> None:
        self.pose[i] = np.asarray(pose_q, np.int32)


def loop_drift_trace(streams: int, beams: int, n_revs: int, drift_sub: int, cell: float):
    """The return-to-start trace: a 5 x 5 m square room seen from true
    poses that go out along x and come back (the last revolution exactly at
    the start), with the front-end's pose drifting ``drift_sub`` subcells a
    revolution along x.  Returns ``(revs, masks, true_end)``: a list of
    per-revolution ((S, B, 2) float32 points, (S, 3) int32 drifted poses),
    the (S, B) masks and the (S, 3) true end poses."""
    half_room = 2.5
    t = np.linspace(0, 2 * np.pi, beams, endpoint=False)
    dx, dy = np.cos(t), np.sin(t)
    with np.errstate(divide="ignore"):
        r_wall = np.minimum(
            np.where(np.abs(dx) > 1e-12, half_room / np.abs(dx), np.inf),
            np.where(np.abs(dy) > 1e-12, half_room / np.abs(dy), np.inf),
        )
    wx, wy = dx * r_wall, dy * r_wall
    sub_per_m = SUB / cell
    h = n_revs // 2

    def true_x(s: int, k: int) -> float:
        out = 0.8 * (1 + 0.1 * s)
        return out * (k / h if k <= h else max(n_revs - 1 - k, 0) / h)

    revs = []
    for k in range(n_revs):
        pts = np.zeros((streams, beams, 2), np.float32)
        drifted = np.zeros((streams, 3), np.int32)
        for s in range(streams):
            x0 = true_x(s, k)
            pts[s, :, 0] = wx - x0
            pts[s, :, 1] = wy
            drifted[s] = (int(round(x0 * sub_per_m)) + drift_sub * (k + 1), 0, 0)
        revs.append((pts, drifted))
    masks = np.ones((streams, beams), bool)
    true_end = np.zeros((streams, 3), np.int32)
    return revs, masks, true_end


def end_error_cells(pose_q, true_q) -> float:
    """L1 translation error in map cells."""
    return (abs(int(pose_q[0]) - int(true_q[0])) + abs(int(pose_q[1]) - int(true_q[1]))) / SUB

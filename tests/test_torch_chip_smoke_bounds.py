"""``chip_smoke.fine_cells``: the cells of ``mq`` that B7 reads, which set
B7's byte bound in the smoke run's kernels line, counted against a
corner-by-corner enumeration of the plain version's gathers."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import chip_smoke
from rplidar_ros2_driver_tpu_torch.ops import scan_match as tsm
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)


def _gathered_cells(pq, ok, posec, cos_q, sin_q, uv, cfg) -> int:
    """Every in-map corner of every valid beam, θ candidate and fine offset,
    one set a stream (fine_scores_plain's indices, walked one by one)."""
    rx, ry = tsm.rotate_rows(pq[:, None, :, 0], pq[:, None, :, 1],
                             cos_q[..., None], sin_q[..., None])
    csub = cfg.coarse * tsm.SUB
    fx = ((rx + (posec[:, 0] + uv[:, 0] * csub)[:, None, None]) >> tsm.SUB_BITS).numpy()
    fy = ((ry + (posec[:, 1] + uv[:, 1] * csub)[:, None, None]) >> tsm.SUB_BITS).numpy()
    g, r = cfg.grid, cfg.fine_radius
    total = 0
    for i in range(pq.shape[0]):
        seen = set()
        xs, ys = fx[i][:, ok[i].numpy()].ravel(), fy[i][:, ok[i].numpy()].ravel()
        for dx in range(-r, r + 1):
            for dy in range(-r, r + 1):
                for cx, cy in ((0, 0), (1, 0), (0, 1), (1, 1)):
                    x, y = xs + dx + cx, ys + dy + cy
                    inside = (x >= 0) & (x < g) & (y >= 0) & (y < g)
                    seen.update(zip(x[inside].tolist(), y[inside].tolist()))
        total += len(seen)
    return total


@pytest.mark.parametrize("grid,streams,beams,seed", [(32, 2, 40, 1), (64, 3, 100, 2)])
def test_fine_cells_counts_the_gathered_corners(grid, streams, beams, seed):
    rng = np.random.default_rng(seed)
    cfg = tsm.MapConfig(grid=grid, cell_m=0.1, beams=beams)
    pts = torch.from_numpy(rng.uniform(-grid * 0.06, grid * 0.06,
                                       (streams, beams, 2)).astype(np.float32))
    pq, ok = tsm.quantize_points(pts, torch.from_numpy(rng.random((streams, beams)) < 0.8), cfg)
    # poses near the map's edges too, so corners fall off the map
    posec = torch.from_numpy(rng.integers(0, grid * tsm.SUB, (streams, 2)).astype(np.int32))
    theta = rng.integers(0, cfg.theta_divisions, (streams, 1)).astype(np.int32)
    cos_q, sin_q = tsm._theta_trig(torch.cat([posec, torch.from_numpy(theta)], 1), cfg)
    uv = torch.from_numpy(rng.integers(-2, 3, (streams, 2)).astype(np.int32))
    fine = (pq, ok, posec, cos_q, sin_q, uv)
    cells = chip_smoke.fine_cells(fine, cfg)
    assert cells == _gathered_cells(*fine, cfg)
    assert 0 < cells < streams * grid * grid

"""The node path's points, across the two packages, on the CPU.

With ``map_enable`` the node hands each revolution's ``points_xy`` and
``point_mask`` to the mapper, which quantizes them to subcells
(``quantize_points``).  The port's ``points_xy`` come from a correctly
rounded trig table and may sit up to 2 ulp from the JAX package's (f32
cos/sin); every other output is byte-equal.  This holds the whole node
feed at config 5's geometry (3200-point DenseBoost revolutions, W=64,
2048 beams, capacity 4096, both voxel cell sizes): ``points_xy`` within
2 ulp, the rest byte-equal, and the quantized points (``pq`` and ``ok``)
of both packages identical — so the ulps never move a point the mapper
sees.  (At this seed about 2.5% of the valid points differ by an ulp or
two: 15,400 of 614,312 per cell size.)
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rplidar_ros2_driver_tpu.core.config import DriverParams as JParams
from rplidar_ros2_driver_tpu.filters import chain as jchain
from rplidar_ros2_driver_tpu.mapping.mapper import map_config_from_params as jmap_config
from rplidar_ros2_driver_tpu.ops import scan_match as jsm
from rplidar_ros2_driver_tpu_torch.core.config import DriverParams as TParams
from rplidar_ros2_driver_tpu_torch.filters import chain as tchain
from rplidar_ros2_driver_tpu_torch.mapping.mapper import map_config_from_params
from rplidar_ros2_driver_tpu_torch.ops import scan_match as tsm
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

POINTS, BEAMS, WINDOW, GRID, CAPACITY = 3200, 2048, 64, 256, 4096
REVS = 300  # the window fills at 64; the rest slide it (the one-off check's count)


def ulp_distance(a, b) -> np.ndarray:
    def ordered(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)

    return np.abs(ordered(a) - ordered(b))


def dense_revolutions(seed: int, n: int):
    """Seeded DenseBoost-shaped revolutions: a 2 m +/- 0.5 m ring with
    noise, angle jitter, drop-outs and points beyond and below range."""
    rng = np.random.default_rng(seed)
    i = np.arange(POINTS)
    out = []
    for k in range(n):
        angle = ((i * 65536) // POINTS + rng.integers(-8, 9, POINTS)).clip(0, 65535)
        dist_m = 2.0 + 0.5 * np.sin(i * (2 * np.pi / POINTS) + 0.1 * k)
        dist = ((dist_m + rng.normal(0.0, 0.01, POINTS)) * 4000.0).astype(np.int32)
        dist[rng.random(POINTS) < 0.05] = 0
        dist[rng.random(POINTS) < 0.02] = 50 * 4000
        dist[rng.random(POINTS) < 0.01] = int(0.05 * 4000)
        qual = rng.integers(0, 256, POINTS).astype(np.int32)
        out.append((angle.astype(np.int32), dist, qual, (i == 0).astype(np.int32)))
    return out


@pytest.mark.parametrize("cell_m", [0.25, 0.1])
def test_node_points_quantize_identically_across_packages(cell_m):
    common = dict(filter_backend="cpu", filter_window=WINDOW, voxel_grid_size=GRID,
                  filter_chain=("clip", "polar", "median", "voxel"), voxel_cell_m=cell_m,
                  map_enable=True)
    jc = jchain.ScanFilterChain(JParams(**common), beams=BEAMS, capacity=CAPACITY)
    tc = tchain.ScanFilterChain(TParams(**common), beams=BEAMS, capacity=CAPACITY)
    # the node's mapper: one stream at the params' map geometry, each
    # package deriving it from its own params; they agree bar the backends
    tcfg = map_config_from_params(TParams(**common), beams=BEAMS, platform="cpu")
    jcfg = dataclasses.replace(jmap_config(JParams(**common), beams=BEAMS, platform="cpu"),
                               match_backend="xla")
    backends = {"voxel_backend", "match_backend"}
    jfields, tfields = dataclasses.asdict(jcfg), dataclasses.asdict(tcfg)
    assert jfields.keys() == tfields.keys()
    assert {k: v for k, v in jfields.items() if k not in backends} == \
        {k: v for k, v in tfields.items() if k not in backends}
    points = 0
    for rev in dense_revolutions(5, REVS):
        jo, to = jc.process_raw(*rev), tc.process_raw(*rev)
        for f in ("ranges", "intensities", "point_mask", "voxel"):
            a, b = np.asarray(getattr(jo, f)), np.asarray(getattr(to, f))
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
        jxy, txy = np.asarray(jo.points_xy), np.asarray(to.points_xy)
        assert jxy.dtype == txy.dtype == np.float32
        ulps = ulp_distance(jxy, txy)
        assert ulps.max() <= 2
        mask = np.asarray(to.point_mask)
        points += int(mask.sum())
        jpq, jok = jsm.quantize_points(jnp.asarray(jxy), jnp.asarray(mask), jcfg)
        tpq, tok = tsm.quantize_points(torch.from_numpy(txy), torch.from_numpy(mask), tcfg)
        np.testing.assert_array_equal(np.asarray(jpq), tpq.numpy())
        np.testing.assert_array_equal(np.asarray(jok), tok.numpy())
    assert points > REVS * BEAMS // 2

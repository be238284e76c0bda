"""The carried mapper's feed, across the two packages, on the CPU.

On the fused mapping route each tick's reconstructed sweep goes straight
into the matcher: ``recon_pts`` (ops/deskew.recon_points, the chain's
polar projection) is quantized to subcells (``quantize_points``) and
matched against the carried map.  The port's ``recon_pts`` come from a
correctly rounded trig table and may sit up to 2 ulp from the JAX
package's; a point on a half-subcell boundary would then quantize to
another cell and move a pose.  This holds that feed at bench config 18's
geometry (DenseBoost, 3200 points a revolution, 16 frames a tick, 2048
beams, capacity 4096, the sweep over 4 sub-sweeps, 128 profile beams, a
128² map at 0.1 m; the filter chain, which the feed does not read, at a
short window) through both packages' fused fleet ingest
with the carried mapper, tick by tick: ``recon_pts`` within 2 ulp, their
quantized points (``pq`` and ``ok``) identical, and the map wires and the
carried MapState byte-equal after every tick, on config 18's own scene
(the static 2 m ± 0.5 m ring).  (11,703 of the 489,018 valid points'
coordinates differ by an ulp or two over the 300 ticks; none quantizes
differently.)
"""

import jax.numpy as jnp
import numpy as np
import torch

from rplidar_ros2_driver_tpu.core.config import DriverParams as JParams
from rplidar_ros2_driver_tpu.driver.ingest import FleetFusedIngest as JEngine
from rplidar_ros2_driver_tpu.ops import scan_match as jsm
from rplidar_ros2_driver_tpu.ops import wire as jwire
from rplidar_ros2_driver_tpu_torch.core.config import DriverParams as TParams
from rplidar_ros2_driver_tpu_torch.driver.ingest import FleetFusedIngest as TEngine
from rplidar_ros2_driver_tpu_torch.ops import scan_match as tsm
from rplidar_ros2_driver_tpu_torch.protocol.constants import Ans
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

POINTS, RUN, BEAMS, CAPACITY = 3200, 16, 2048, 4096
TICKS = 300
DENSE = int(Ans.MEASUREMENT_DENSE_CAPSULED)
MAP_KEYS = ("log_odds", "pose", "origin_xy", "revision")


def ulp_distance(a, b) -> np.ndarray:
    def ordered(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)

    return np.abs(ordered(a) - ordered(b))


def ring_frames(revs: int):
    """Config 18's dense-capsule bytes (bench.py ``_denseboost_wire_frames``):
    the static 2 m ± 0.5 m ring."""
    frames, idx, first = [], 0, True
    while idx < revs * POINTS:
        theta = 360.0 * (idx % POINTS) / POINTS
        pts = (np.arange(40) + idx) % POINTS
        dists = 2000.0 + 500.0 * np.sin(2 * np.pi * pts / POINTS)
        frames.append(jwire.encode_dense_capsule(int(theta * 64) & 0x7FFF, first,
                                                 dists.astype(int)))
        idx += 40
        first = False
    return frames


def paced_ticks(frames, streams: int):
    """bench.py ``_paced_fleet_byte_ticks``: RUN frames a stream a tick,
    every stream the same frames on its own stamp lane."""
    ticks = []
    t = [1000.0 + 7.0 * s for s in range(streams)]
    for i in range(0, len(frames), RUN):
        tick = []
        for s in range(streams):
            batch = []
            for f in frames[i : i + RUN]:
                t[s] += 1.25e-3
                batch.append((f, t[s]))
            tick.append((DENSE, batch))
        ticks.append(tick)
    return ticks


def _engine(pkg: str, streams: int):
    params = (JParams if pkg == "jax" else TParams)(
        # the feed reads no filter plane: a short window and a small voxel
        # grid keep the test's time down without touching what it pins
        filter_backend="cpu", filter_chain=("clip", "median", "voxel"), filter_window=4,
        voxel_grid_size=16, voxel_cell_m=0.25, fleet_ingest_backend="fused",
        deskew_enable=True, sweep_reconstruct_window=4, deskew_profile_beams=128,
        deskew_shift_window=4, map_enable=True, fused_mapping_backend="fused",
        map_grid=128, map_cell_m=0.1,
    )
    eng = (JEngine if pkg == "jax" else TEngine)(params, streams, beams=BEAMS, capacity=CAPACITY,
                                                 buckets=(RUN,))
    eng.recon_log = True
    return eng


def test_recon_points_quantize_identically_across_packages():
    # config 18 feeds every stream the same frames: one stream sees them all
    streams = 1
    ticks = paced_ticks(ring_frames(TICKS * RUN * 40 // POINTS + 1), streams)[:TICKS]
    assert len(ticks) == TICKS
    jeng, teng = _engine("jax", streams), _engine("torch", streams)
    mcfg = teng._mapping
    jcfg = jeng._mapping
    pushed = points = 0
    for n, tick in enumerate(ticks):
        jeng.submit(tick)
        teng.submit(tick)
        jw, tw = jeng.take_map_wires(), teng.take_map_wires()
        jr, tr = jeng.take_recon(), teng.take_recon()
        for i in range(streams):
            np.testing.assert_array_equal(tw[i], jw[i], err_msg=f"tick {n} stream {i}")
            assert (jr[i] is None) == (tr[i] is None)
            if tr[i] is None:
                continue
            pushed += 1
            jplane, jpts = jr[i]
            tplane, tpts = tr[i]
            np.testing.assert_array_equal(tplane, jplane)
            ulps = ulp_distance(jpts[:, :2], tpts[:, :2])
            assert ulps.max() <= 2, (n, i)
            np.testing.assert_array_equal(tpts[:, 2], jpts[:, 2])
            mask = tpts[:, 2] > 0.5
            points += int(mask.sum())
            jpq, jok = jsm.quantize_points(jnp.asarray(jpts[:, :2]), jnp.asarray(mask), jcfg)
            tpq, tok = tsm.quantize_points(torch.from_numpy(tpts[:, :2].copy()),
                                           torch.from_numpy(mask), mcfg)
            np.testing.assert_array_equal(tpq.numpy(), np.asarray(jpq), err_msg=f"tick {n}")
            np.testing.assert_array_equal(tok.numpy(), np.asarray(jok), err_msg=f"tick {n}")
        jmap, tmap = jeng.map_snapshot(), teng.map_snapshot()
        for k in MAP_KEYS:
            np.testing.assert_array_equal(tmap[k], np.asarray(jmap[k]), err_msg=f"tick {n} {k}")
    assert pushed == TICKS * streams
    assert points > pushed * BEAMS // 2
    assert int(teng.map_snapshot()["revision"].min()) == TICKS

"""The PyTorch package's scenario foundry and matrix against the JAX package's.

``scenarios/`` (the foundry, the trajectories, the metrics) is copied into
the port with its imports pointed at the port's ``ops/scan_match`` and
``ops/scan_match_ref``: every scene, trajectory, raster and metric is held
byte-equal to JAX's on the JAX suite's cases (tests/test_scenarios.py), a
foundry scene streams through the port's simulator as through JAX's, and
the port's ``tools/scenario_matrix`` (bench config 23 over the port) gives
``bench.py``'s records at its smoke geometry (64² at 0.1 m, 256 beams, 16
revolutions; the loop cells and probe 128² at 0.05 m): one matrix cell of
each scene and one loop probe, the timing keys dropped.  The matrix's own
check on the port — the fused FleetMapper arm equal to the host matcher —
runs here on one cell (the plain versions); on the card it runs on all
twelve (chip_smoke.py ``scenarios``).
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

import bench
from rplidar_ros2_driver_tpu.core.config import DriverParams as JParams
from rplidar_ros2_driver_tpu.mapping.mapper import map_config_from_params as jmap_config
from rplidar_ros2_driver_tpu.ops.scan_match import MapConfig as JMapConfig
from rplidar_ros2_driver_tpu.scenarios import foundry as jf
from rplidar_ros2_driver_tpu.scenarios import metrics as jm
from rplidar_ros2_driver_tpu.scenarios import trajectory as jt
from rplidar_ros2_driver_tpu_torch.core.config import DriverParams
from rplidar_ros2_driver_tpu_torch.mapping.mapper import map_config_from_params
from rplidar_ros2_driver_tpu_torch.ops import scan_match as tsm
from rplidar_ros2_driver_tpu_torch.ops.scan_match import SUB, MapConfig
from rplidar_ros2_driver_tpu_torch.ops.scan_match_ref import (
    create_map_state_np,
    quantize_points_np,
    update_map_np,
)
from rplidar_ros2_driver_tpu_torch.scenarios import foundry as tf
from rplidar_ros2_driver_tpu_torch.scenarios import metrics as tm
from rplidar_ros2_driver_tpu_torch.scenarios import trajectory as tt
from rplidar_ros2_driver_tpu_torch.tools import scenario_matrix as smx
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

TIMING = ("scans_per_sec", "clamped", "_dt_s")

# ---------------------------------------------------------------------------
# the foundry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", tf.SCENE_KINDS)
def test_foundry_streams_equal_jax_across_chunkings(kind):
    """Same spec => byte-equal streams in both packages, however the
    queries are chunked; the scene's segments and trajectory equal too."""
    spec = dict(kind=kind, seed=77, n_revs=8, dropout_rate=0.1)
    a, j = tf.build_scene(tf.SceneSpec(**spec)), jf.build_scene(jf.SceneSpec(**spec))
    thetas = np.tile(np.linspace(0.0, 360.0, 200, endpoint=False), 2)
    revs = np.repeat(np.arange(2, dtype=np.int64), 200)
    whole = a.dist_mm(thetas, revs)
    assert whole.tobytes() == j.dist_mm(thetas, revs).tobytes()
    b = tf.build_scene(tf.SceneSpec(**spec))
    parts = [b.dist_mm(thetas[i:i + 63], revs[i:i + 63]) for i in range(0, len(thetas), 63)]
    assert whole.tobytes() == np.concatenate(parts).tobytes()
    assert a.segments.tobytes() == j.segments.tobytes()
    assert a.traj.poses.tobytes() == j.traj.poses.tobytes()
    assert a.truth_dist_mm(thetas, revs).tobytes() == j.truth_dist_mm(thetas, revs).tobytes()
    assert np.any(a.dist_mm(thetas[:200], np.zeros(200, np.int64)) > 0)


def test_scene_spec_rejects_malformed():
    for bad in (dict(kind="escher"), dict(kind="rooms", n_revs=2),
                dict(kind="rooms", dropout_rate=0.9), dict(kind="rooms", max_range_m=0.1),
                dict(kind="rooms", theta_table=1000)):
        with pytest.raises(ValueError):
            tf.SceneSpec(**bad)
        with pytest.raises(ValueError):
            jf.SceneSpec(**bad)


def test_raycast_matches_the_scalar_twin_and_jax():
    """The vectorized raycaster equals the scalar per-segment loop ray by
    ray (moving-box overlays included) and JAX's raycaster."""
    for kind in ("rooms", "decay"):
        spec = dict(kind=kind, seed=11, n_revs=8)
        scene, jscene = tf.build_scene(tf.SceneSpec(**spec)), jf.build_scene(jf.SceneSpec(**spec))
        x0, y0 = scene.traj.x_m[0], scene.traj.y_m[0]
        angs = np.linspace(0.0, 2.0 * math.pi, 64, endpoint=False)
        dx, dy = np.cos(angs), np.sin(angs)
        for rev in (0, scene.traj.n_revs - 1):
            args = (np.full(64, x0), np.full(64, y0), dx, dy, np.full(64, rev, np.int64))
            t_vec, m_vec = scene.raycast(*args)
            jt_vec, jm_vec = jscene.raycast(*args)
            assert t_vec.tobytes() == jt_vec.tobytes() and np.array_equal(m_vec, jm_vec)
            for i in range(0, 64, 4):
                t_ref, m_ref = tf.raycast_brute(scene, x0, y0, float(dx[i]), float(dy[i]), rev)
                assert float(t_vec[i]) == t_ref and int(m_vec[i]) == m_ref, (kind, rev, i)


# ---------------------------------------------------------------------------
# the metrics
# ---------------------------------------------------------------------------


def test_metric_units_equal_jax():
    cfg, jcfg = MapConfig(grid=64, cell_m=0.1, beams=128), JMapConfig(grid=64, cell_m=0.1,
                                                                       beams=128)
    truth = tm.pose_to_lattice(0.0, 0.0, 0.0, cfg)
    for k in (1, 3, 7):
        est = tm.pose_to_lattice(k * cfg.cell_m, 0.0, 0.0, cfg)
        assert est[0] == k * SUB and tm.end_pose_error_cells(est, truth) == float(k)
    est = tm.pose_to_lattice(3 * cfg.cell_m, 4 * cfg.cell_m, 0.0, cfg)
    assert tm.end_pose_error_cells(est, truth) == 5.0
    for pose in ((0.31, -0.17, 0.4), (-1.2, 2.5, -2.9), (0.0, 0.05, 3.1)):
        assert np.array_equal(tm.pose_to_lattice(*pose, cfg), jm.pose_to_lattice(*pose, jcfg))
    truth = np.zeros((16, 16), bool)
    truth[4:8, 4:8] = True
    perfect = np.where(truth, 1000, -1000).astype(np.int32)
    empty = np.full((16, 16), -1000, np.int32)
    assert tm.map_f1(perfect, truth) == 1.0 and tm.map_f1(empty, truth) == 0.0
    assert tm.map_f1(empty, np.zeros((16, 16), bool)) == 1.0
    noisy = np.random.default_rng(3).integers(-2000, 2000, (16, 16)).astype(np.int32)
    assert tm.map_f1(noisy, truth) == jm.map_f1(noisy, truth)
    th = np.linspace(0.0, 360.0, 90, endpoint=False)
    d = np.random.default_rng(4).uniform(0, 5000, 90)
    for a, b in zip(tm.scan_points_xy(th, d), jm.scan_points_xy(th, d)):
        assert a.tobytes() == b.tobytes()


def test_visible_truth_occupancy_equals_jax_and_is_reachable():
    """F1 against the visible raster is attainable: the clean truth scans
    through the mapper's own update at the truth poses score 1.0; the
    raster is JAX's."""
    cfg = MapConfig(grid=64, cell_m=0.1, beams=180, free_samples=0)
    jcfg = JMapConfig(grid=64, cell_m=0.1, beams=180, free_samples=0)
    scene = tf.build_scene(tf.SceneSpec(kind="rooms", seed=5, n_revs=6))
    jscene = jf.build_scene(jf.SceneSpec(kind="rooms", seed=5, n_revs=6))
    thetas = np.linspace(0.0, 360.0, cfg.beams, endpoint=False)
    rel = scene.traj.relative_poses()
    revs = list(range(scene.traj.n_revs))
    truth_q = np.stack([tm.pose_to_lattice(rel[k, 0], rel[k, 1], rel[k, 2], cfg) for k in revs])
    occ = tm.visible_truth_occupancy(scene, thetas, revs, truth_q, cfg)
    assert occ.any()
    assert np.array_equal(occ, jm.visible_truth_occupancy(jscene, thetas, revs, truth_q, jcfg))
    log_odds = create_map_state_np(cfg)["log_odds"]
    for i, rev in enumerate(revs):
        d = scene.truth_dist_mm(thetas, np.full(cfg.beams, rev, np.int64))
        xy, mask = tm.scan_points_xy(thetas, d)
        pq, ok = quantize_points_np(xy, mask, cfg)
        log_odds = update_map_np(log_odds, truth_q[i], pq, ok, cfg)
    assert tm.map_f1(log_odds, occ) == 1.0


# ---------------------------------------------------------------------------
# the trajectories
# ---------------------------------------------------------------------------


def test_trajectories_equal_jax():
    pairs = [
        (tt.scripted_loop(24, center_xy=(0.5, -0.25), radius_m=1.5),
         jt.scripted_loop(24, center_xy=(0.5, -0.25), radius_m=1.5)),
        (tt.scripted_line(10, start_xy=(1.0, 2.0), speed_m=0.25),
         jt.scripted_line(10, start_xy=(1.0, 2.0), speed_m=0.25)),
        (tt.scripted_waypoints([(0.0, 0.0), (1.0, 0.0)], [3, 3], speed_m=0.5),
         jt.scripted_waypoints([(0.0, 0.0), (1.0, 0.0)], [3, 3], speed_m=0.5)),
        (tt.organic(200, seed=9, speed_m=0.1, bounds=(-1.0, 1.0, -1.0, 1.0)),
         jt.organic(200, seed=9, speed_m=0.1, bounds=(-1.0, 1.0, -1.0, 1.0))),
    ]
    for a, b in pairs:
        assert a.poses.tobytes() == b.poses.tobytes()
        assert a.relative_poses().tobytes() == b.relative_poses().tobytes()
        assert a.is_loop() == b.is_loop()
    loop = pairs[0][0]
    assert loop.is_loop() and loop.relative_poses()[-1, :2].tolist() == [0.0, 0.0]
    assert float(np.abs(np.diff(pairs[3][0].heading)).max()) <= 0.05 + 1e-12
    with pytest.raises(ValueError):
        tt.scripted_loop(4)
    with pytest.raises(ValueError):
        tt.scripted_waypoints([(0.0, 0.0)], [1, 2])


# ---------------------------------------------------------------------------
# log-odds decay through the port's mapper seam
# ---------------------------------------------------------------------------


def test_decay_validation_and_twins_agree():
    with pytest.raises(ValueError):
        MapConfig(decay_q=-1)
    with pytest.raises(ValueError):
        MapConfig(decay_q=9000)
    chain = ("clip", "median", "voxel")
    for bad in (-0.1, 99.0):
        with pytest.raises(ValueError):
            DriverParams(map_enable=True, filter_chain=chain, map_decay=bad).validate()
    for decay in (0.0, 0.4):
        p = dict(map_enable=True, filter_chain=chain, map_decay=decay)
        assert (map_config_from_params(DriverParams(**p)).decay_q
                == jmap_config(JParams(**p)).decay_q == round(decay * 1024))
    rng = np.random.default_rng(4)
    lo = rng.integers(-8192, 8193, (32, 32), dtype=np.int32)
    pose = np.zeros((3,), np.int32)
    pq = np.zeros((64, 2), np.int32)
    ok = np.zeros((64,), bool)  # no rays: isolate the decay term
    for decay_q in (410, 0):
        cfg = MapConfig(grid=32, cell_m=0.1, beams=64, decay_q=decay_q)
        ref = update_map_np(lo, pose, pq, ok, cfg)
        want = np.sign(lo) * np.maximum(np.abs(lo) - decay_q, 0)
        assert np.array_equal(ref, want.astype(np.int32))
        got = tsm.update_map(*(torch.from_numpy(a)[None] for a in (lo, pose, pq, ok)), cfg)
        assert np.array_equal(got[0].numpy(), ref)  # the port's map update is stream-batched


# ---------------------------------------------------------------------------
# the simulator's scene seam
# ---------------------------------------------------------------------------


def _capture_frames(dev, mode, n):
    """Run the stream loop in-thread against a fake transport until n
    measurement frames land (header frame skipped)."""
    frames = []

    def fake_send(data):
        frames.append(bytes(data))
        if len(frames) >= n + 1:
            dev._streaming.clear()
        return True

    dev._send = fake_send
    dev._streaming.set()
    dev._running.set()
    dev._stream_loop(mode)
    return frames[1:]


def test_a_foundry_scene_streams_through_the_port_sim_as_through_jax():
    """A port FoundryScene is the port simulator's scene provider: on every
    wire format its frames equal the JAX simulator's with JAX's scene, and
    differ from the default ring."""
    from rplidar_ros2_driver_tpu.driver import sim_device as jsim
    from rplidar_ros2_driver_tpu_torch.driver import sim_device as tsim

    spec = dict(kind="rooms", seed=21, n_revs=8, dropout_rate=0.05)
    for mode, jmode in zip(tsim.DEFAULT_MODES, jsim.DEFAULT_MODES):
        dev = tsim.SimulatedDevice(tsim.SimConfig(points_per_rev=50, frame_rate_hz=1e6,
                                                  scene=tf.build_scene(tf.SceneSpec(**spec))))
        jdev = jsim.SimulatedDevice(jsim.SimConfig(points_per_rev=50, frame_rate_hz=1e6,
                                                   scene=jf.build_scene(jf.SceneSpec(**spec))))
        got = _capture_frames(dev, mode, 3)
        assert got == _capture_frames(jdev, jmode, 3), mode.name
        ring = _capture_frames(tsim.SimulatedDevice(tsim.SimConfig(
            points_per_rev=50, frame_rate_hz=1e6)), mode, 3)
        assert got != ring, mode.name


# ---------------------------------------------------------------------------
# the matrix (bench config 23) over the port, at the bench's smoke geometry
# ---------------------------------------------------------------------------


def test_determinism_deskew_and_decay_probes_equal_bench():
    smx.determinism_check(smx.SEED)
    assert smx.SEED == bench._SCENARIO_SEED
    assert smx.deskew_probe(smx.SEED) == bench._scenario_deskew_probe(bench._SCENARIO_SEED)
    g = smx.geometry(smoke=True)
    assert (smx.decay_probe(g["grid"], g["cell"], g["beams"], smx.SEED)
            == bench._scenario_decay_probe(g["grid"], g["cell"], g["beams"], smx.SEED))
    for chaos in smx.CHAOS:
        for rev in range(12):
            for salt in (0, 37):
                a = smx.chaos_mask(chaos, rev, 256, salt)
                b = bench._scenario_chaos_mask(chaos, rev, 256, salt)
                assert np.array_equal(a[0], b[0]) and a[1] == b[1]


@pytest.mark.parametrize("kind,chaos", [("rooms", "clean"), ("corridor", "faulty"),
                                        ("loop", "faulty")])
def test_matrix_cell_equals_bench(kind, chaos):
    g = smx.geometry(smoke=True)
    loop = kind == "loop"
    args = (kind, chaos, 1, smx.SEED, g["loop_revs"] if loop else g["n_revs"],
            g["loop_grid"] if loop else g["grid"], g["loop_cell"] if loop else g["cell"],
            g["beams"])
    # the fused arm (the plain versions here) on the short cells; the loop
    # cell's 128 revolutions through the host arm only
    got = smx.host_arm(*args)[0] if loop else smx.matrix_cell(*args)
    want = bench._scenario_cell(*args)
    assert {k: v for k, v in got.items() if k not in TIMING and not k.startswith("fused")} \
        == {k: v for k, v in want.items() if k not in TIMING}
    assert got.get("fused_equal", False) is (not loop)


def test_loop_probe_equals_bench():
    g = smx.geometry(smoke=True)
    args = ("faulty", g["fleets"][-1], g["probe_revs"], g["loop_grid"], g["loop_cell"],
            g["beams"], smx.SEED)
    got = smx.loop_probe(*args)
    want = bench._scenario_loop_probe(*args)
    assert {k: v for k, v in got.items() if k in want} == want
    assert got["checks"] > 0 and len(got["corrected_poses"]) == g["fleets"][-1]


def test_floors_hold_and_refuse():
    cells = [dict(scene="rooms", chaos="clean", fleet=1, revs=16, cell_m=0.1,
                  end_pose_err_cells=1.0, map_f1=0.7),
             dict(scene="corridor", chaos="clean", fleet=1, revs=16, cell_m=0.1,
                  end_pose_err_cells=20.0, map_f1=0.9)]
    smx.check_floors(cells)
    assert cells[0]["match_ok"] and not cells[1]["match_ok"]
    cells[1]["end_pose_err_cells"] = 1.0  # the corridor stopped degrading
    with pytest.raises(RuntimeError, match="hallucinating"):
        smx.check_floors(cells)
    cells[1]["end_pose_err_cells"] = 20.0
    cells[0]["map_f1"] = 0.1
    with pytest.raises(RuntimeError, match="map F1"):
        smx.check_floors(cells)

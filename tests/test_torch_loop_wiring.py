"""The SLAM back-end through the port's entry points, against the JAX
package's: the node's ``loop_enable`` through its lifecycle, the combined
checkpoint's ``loop.*`` keys in both directions, ``replay_with_loop_closure``
and ``replay --map --loop-close`` on a short seeded capture.  Byte equality
of every pose, score, trajectory and state array.
"""

import numpy as np
import pytest

from conftest import wait_for
from rplidar_ros2_driver_tpu import replay as jreplay
from rplidar_ros2_driver_tpu.core.config import DriverParams as JParams
from rplidar_ros2_driver_tpu_torch import replay as treplay
from rplidar_ros2_driver_tpu_torch.__main__ import main
from rplidar_ros2_driver_tpu_torch.core.config import DriverParams
from rplidar_ros2_driver_tpu_torch.driver.dummy import DummyLidarDriver
from rplidar_ros2_driver_tpu_torch.node.fsm import FsmTimings
from rplidar_ros2_driver_tpu_torch.node.node import RPlidarNode
from rplidar_ros2_driver_tpu_torch.ops.filters import FilterOutput
from test_torch_replay import dense_frames, write_capture
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

CHAIN = ("clip", "median", "voxel")
LOOP = dict(filter_backend="cpu", filter_chain=CHAIN, filter_window=2, voxel_grid_size=32,
            map_enable=True, map_grid=64, map_cell_m=0.1, map_match_window=0.4,
            loop_enable=True, loop_submap_revs=2, loop_check_revs=2, loop_max_submaps=6,
            pose_graph_iters=64)


def assert_same_arrays(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k


def room_output(k: int, beams: int = 2048):
    """A chain output of a 5 x 5 m room seen from a pose that walks along
    x (the same numpy arrays go to both packages' nodes)."""
    t = np.linspace(0, 2 * np.pi, beams, endpoint=False)
    dx, dy = np.cos(t), np.sin(t)
    with np.errstate(divide="ignore"):
        r = np.minimum(np.where(np.abs(dx) > 1e-12, 2.5 / np.abs(dx), np.inf),
                       np.where(np.abs(dy) > 1e-12, 2.5 / np.abs(dy), np.inf))
    x0 = 0.04 * k
    pts = np.stack([dx * r - x0, dy * r], 1).astype(np.float32)
    return dict(ranges=np.linalg.norm(pts, axis=1).astype(np.float32),
                intensities=np.full(beams, 47.0, np.float32), points_xy=pts,
                point_mask=np.ones(beams, bool), voxel=np.zeros((32, 32), np.int32))


def poses_of(pub):
    return [(p.x_m, p.y_m, p.theta_rad, p.score, p.matched_points, p.map_revision)
            for p in pub.poses]


@pytest.fixture(scope="module")
def jax_node(tmp_path_factory):
    """The JAX node (host mapper and loop engine) fed the ten room outputs,
    once per module for both of the port's loop backends: its published
    poses, its loop and map snapshots and its checkpoint file."""
    from rplidar_ros2_driver_tpu.node.node import RPlidarNode as JNode
    from rplidar_ros2_driver_tpu.ops.filters import FilterOutput as JOutput

    jnode = JNode(JParams(**LOOP, map_backend="host", loop_backend="host"))
    try:
        assert jnode.configure()
        for k in range(10):
            jnode._publish_chain_output(JOutput(**room_output(k)), 1.0 + k, 0.1, 8.0)
        jpath = str(tmp_path_factory.mktemp("jax_node") / "jax.npz")
        assert jnode.save_checkpoint(jpath)
        return {"poses": poses_of(jnode.publisher), "checkpoint": jpath,
                "loop": {k: np.array(v) for k, v in jnode.loop.snapshot().items()},
                "map": {k: np.array(v) for k, v in jnode.mapper.snapshot().items()}}
    finally:
        jnode.shutdown()


@pytest.mark.parametrize("loop_backend", ["host", "fused"])
def test_node_loop_matches_the_jax_node(loop_backend, tmp_path, jax_node):
    """Both nodes fed the same chain outputs publish the same corrected
    poses and hold the same library; the port's checkpoint carries
    ``loop.*`` keys a JAX node restores, and the reverse."""
    from rplidar_ros2_driver_tpu.node.node import RPlidarNode as JNode

    node = RPlidarNode(DriverParams(**LOOP, map_backend="fused", loop_backend=loop_backend))
    try:
        assert node.configure()
        assert node.loop is not None and node.loop.backend == loop_backend
        for k in range(10):
            node._publish_chain_output(FilterOutput(**room_output(k)), 1.0 + k, 0.1, 8.0)
        assert poses_of(node.publisher) == jax_node["poses"]
        assert_same_arrays(node.loop.snapshot(), jax_node["loop"])
        assert node.loop.checks > 0 and sum(node.loop.status()["submaps"]) > 0
        node._update_diagnostics()
        values = node.publisher.diagnostics[-1].values
        for key in ("Loop Closures", "Loop Submaps", "Loop Constraints", "Pose Correction"):
            assert key in values, key

        # port -> JAX
        path = str(tmp_path / "port.npz")
        assert node.save_checkpoint(path)
        other = JNode(JParams(**LOOP, map_backend="host", loop_backend="host"))
        assert other.load_checkpoint(path) and other.configure()
        assert_same_arrays(other.loop.snapshot(), node.loop.snapshot())
        other.shutdown()
        # JAX -> port, staged for the next configure and restored live
        jpath = jax_node["checkpoint"]
        fresh = RPlidarNode(DriverParams(**LOOP, map_backend="fused", loop_backend=loop_backend))
        assert fresh.load_checkpoint(jpath) and fresh.configure()
        assert_same_arrays(fresh.loop.snapshot(), jax_node["loop"])
        assert_same_arrays(fresh.mapper.snapshot(), jax_node["map"])
        assert fresh.load_checkpoint(jpath)
        assert_same_arrays(fresh.loop.snapshot(), jax_node["loop"])
        fresh.shutdown()
        # a library of another geometry is dropped, the chain and map kept
        small = RPlidarNode(DriverParams(**{**LOOP, "loop_max_submaps": 4}, map_backend="fused",
                                         loop_backend=loop_backend))
        assert small.load_checkpoint(jpath) and small.configure()
        assert int(small.loop.snapshot()["count"].sum()) == 0
        assert_same_arrays(small.mapper.snapshot(), jax_node["map"])
        small.shutdown()
    finally:
        node.shutdown()


def test_node_lifecycle_with_loop_enable():
    """launch with the dummy driver: corrected poses publish, the library
    survives deactivate/activate and keeps growing, cleanup keeps the
    snapshot for the next configure."""
    node = RPlidarNode(DriverParams(dummy_mode=True, **LOOP),
                       driver_factory=lambda: DummyLidarDriver(scan_rate_hz=200.0),
                       fsm_timings=FsmTimings.fast())
    try:
        assert node.configure() and node.activate()
        assert node.loop.backend == "host" and node.mapper.backend == "host"  # filter_backend cpu
        assert wait_for(lambda: node.loop.installs >= 2)
        assert node.deactivate()
        installs = int(node.loop.snapshot()["count"][0])
        assert node.activate()
        assert wait_for(lambda: int(node.loop.snapshot()["count"][0]) > installs)
        assert node.deactivate() and node.cleanup()
        assert node.loop is None and node._loop_snapshot is not None
        assert node.configure()
        assert int(node.loop.snapshot()["count"][0]) >= installs
        assert node.publisher.poses and node.publisher.poses[-1].map_revision > 0
        node.discard_checkpoint()
        assert node._loop_snapshot is None
    finally:
        node.shutdown()


# ---------------------------------------------------------------------------
# replay --map --loop-close
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    return write_capture(tmp_path_factory.mktemp("loopcap") / "dense.rplr", dense_frames(9, 14))


def test_replay_with_loop_closure_matches_jax(capture):
    revs = treplay.decode_recording(capture, device="cpu").revolutions()
    jrevs = jreplay.decode_recording(capture).revolutions()
    kw = dict(beams=256, capacity=512, chunk=5)
    geom = {**LOOP, "voxel_cell_m": 0.25, "filter_window": 8}
    jtraj, jcorr, jscores, jm, jeng = jreplay.replay_with_loop_closure(
        jrevs, JParams(**geom, map_backend="host", loop_backend="host"), **kw)
    assert jeng.checks > 0
    for backend in ("host", "fused"):
        traj, corr, scores, m, eng = treplay.replay_with_loop_closure(
            revs, DriverParams(**geom, map_backend=backend, loop_backend=backend), **kw)
        assert eng.backend == backend and eng.ticks == len(revs)
        assert traj.tobytes() == np.asarray(jtraj).tobytes()
        assert corr.dtype == np.float64 and corr.tobytes() == np.asarray(jcorr).tobytes()
        assert np.array_equal(scores, jscores)
        assert {**eng.status(), "backend": "host"} == jeng.status()
        assert_same_arrays(eng.snapshot(), jeng.snapshot())
        assert_same_arrays(m.snapshot(), jm.snapshot())
        # the raw trajectory is replay_with_map's
        t2, s2, _ = treplay.replay_with_map(revs, DriverParams(**geom, map_backend=backend), **kw)
        assert t2.tobytes() == traj.tobytes() and np.array_equal(s2, scores)


def test_cli_replay_loop_close_prints_the_jax_lines(capture, tmp_path, capsys):
    from rplidar_ros2_driver_tpu.__main__ import main as jmain

    lines = {}
    for name, entry in (("port", main), ("jax", jmain)):
        pgm = str(tmp_path / f"{name}.pgm")
        assert entry(["replay", capture, "--loop-close", "--cpu", "--map-pgm", pgm]) == 0
        out = capsys.readouterr().out
        lines[name] = [ln for ln in out.splitlines() if "mapped" in ln or "loop closure" in ln]
    assert len(lines["port"]) == 2 and "loop closure (host backend)" in lines["port"][1]
    assert lines["port"] == lines["jax"]
    port_pgm, jax_pgm = (open(tmp_path / f"{n}.pgm", "rb").read() for n in ("port", "jax"))
    assert port_pgm == jax_pgm

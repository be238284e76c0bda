"""The PyTorch package's SLAM front-end mapper against the JAX package, bit
for bit, on the CPU: ``FleetMapper`` (host reference and the fused torch
arm, both matcher lowerings) at fleet sizes 1/3/8 over a drifting-room
sequence, its checkpoint surface (including snapshots carried across the
two packages), ``replay_with_map``, ``replay --map`` and the node's
``map_enable``.  Tolerance is exact equality: poses, scores, wires and
every snapshot key (``origin_xy`` float32 bit-equal).
"""

from __future__ import annotations

import dataclasses
import os
import types

import numpy as np
import pytest
import torch

from conftest import wait_for
from rplidar_ros2_driver_tpu import replay as jreplay
from rplidar_ros2_driver_tpu.core.config import DriverParams as JParams
from rplidar_ros2_driver_tpu.mapping import mapper as jmapper
from rplidar_ros2_driver_tpu_torch import replay as treplay
from rplidar_ros2_driver_tpu_torch.__main__ import main
from rplidar_ros2_driver_tpu_torch.core.config import DriverParams
from rplidar_ros2_driver_tpu_torch.driver.dummy import DummyLidarDriver
from rplidar_ros2_driver_tpu_torch.mapping import mapper as tmapper
from rplidar_ros2_driver_tpu_torch.node.fsm import FsmTimings
from rplidar_ros2_driver_tpu_torch.node.lifecycle import LifecycleState
from rplidar_ros2_driver_tpu_torch.node.node import RPlidarNode
from rplidar_ros2_driver_tpu_torch.ops import scan_match_kernels as smk
from test_torch_replay import dense_frames, write_capture

BEAMS = 128
MAP = dict(map_enable=True, map_grid=64, map_cell_m=0.1, map_match_window=0.4)
CHAIN = ("clip", "median", "voxel")


def port_params(**kw) -> DriverParams:
    return DriverParams(**{**dict(dummy_mode=True, filter_backend="cpu", filter_chain=CHAIN,
                                  **MAP), **kw})


def jax_params(**kw) -> JParams:
    return JParams(**{**dict(dummy_mode=True, filter_backend="cpu", filter_chain=CHAIN, **MAP),
                      **kw})


def room_ticks(streams: int, beams: int, n_ticks: int):
    """The config-12/14 scene (bench.py ``_room_fleet_ticks``): a 5×5 m
    square room seen from per-stream drifting poses, one (N, B, 2) float32
    plane per tick; here every fourth (tick + stream) is idle."""
    half_room = 2.5
    t = np.linspace(0, 2 * np.pi, beams, endpoint=False)
    dx, dy = np.cos(t), np.sin(t)
    with np.errstate(divide="ignore"):
        r_wall = np.minimum(
            np.where(np.abs(dx) > 1e-12, half_room / np.abs(dx), np.inf),
            np.where(np.abs(dy) > 1e-12, half_room / np.abs(dy), np.inf),
        )
    wx, wy = dx * r_wall, dy * r_wall
    ticks = []
    for k in range(n_ticks):
        pts = np.zeros((streams, beams, 2), np.float32)
        masks = np.ones((streams, beams), bool)
        live = np.ones((streams,), np.int32)
        for s in range(streams):
            x0, y0, th = 0.03 * k * (1 + 0.1 * s), -0.02 * k * (1 + 0.2 * s), 0.004 * k
            c, si = np.cos(-th), np.sin(-th)
            pts[s, :, 0] = c * (wx - x0) - si * (wy - y0)
            pts[s, :, 1] = si * (wx - x0) + c * (wy - y0)
            masks[s] &= np.random.default_rng(100 * s + k).uniform(size=beams) > 0.1
            if k > 0 and (k + s) % 4 == 3:
                live[s] = 0
        ticks.append((pts, masks, live))
    return ticks


def run(mapper, ticks):
    """Per tick and stream: (pose_q, score, matched, revision) or None."""
    out = []
    for pts, masks, live in ticks:
        ests = mapper.submit_points(pts, masks, live)
        out.append([None if e is None else (tuple(e.pose_q.tolist()), e.score,
                                            e.matched_points, e.revision) for e in ests])
    return out


def assert_same_snapshot(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert x.tobytes() == y.tobytes(), k


PORT_ARMS = {
    "host": dict(map_backend="host"),
    "fused-xla": dict(map_backend="fused", match_backend="xla"),
    "fused-pallas": dict(map_backend="fused", match_backend="pallas"),
    "fused-matmul": dict(map_backend="fused", voxel_backend="matmul"),
}


@pytest.mark.parametrize("streams", [1, 3, 8])
def test_fleet_matches_jax_host_and_fused(streams):
    ticks = room_ticks(streams, BEAMS, 6)
    jhost = jmapper.FleetMapper(jax_params(map_backend="host"), streams, beams=BEAMS)
    want = run(jhost, ticks)
    want_snap = jhost.snapshot()
    assert any(e is not None and e[1] > 0 for row in want for e in row)  # matches accept
    jfused = jmapper.FleetMapper(jax_params(map_backend="fused"), streams, beams=BEAMS)
    assert run(jfused, ticks) == want
    assert_same_snapshot(jfused.snapshot(), want_snap)
    for name, over in PORT_ARMS.items():
        mapper = tmapper.FleetMapper(port_params(**over), streams, beams=BEAMS)
        assert mapper.backend == over["map_backend"], name
        assert run(mapper, ticks) == want, name
        assert_same_snapshot(mapper.snapshot(), want_snap)
        assert mapper.ticks == len(ticks)
        assert mapper.dispatch_count == (len(ticks) if mapper.backend == "fused" else 0)


def test_fused_pallas_arm_goes_through_the_kernel_wrappers(monkeypatch):
    calls = []
    for name in ("coarse_scores_kernel", "fine_scores_kernel", "log_odds_update_kernel"):
        real = getattr(smk, name)

        def spy(*a, _real=real, _name=name, **k):
            calls.append((_name, tuple(a[0].shape)))
            return _real(*a, **k)

        monkeypatch.setattr(smk, name, spy)
    mapper = tmapper.FleetMapper(port_params(map_backend="fused", match_backend="pallas"), 3,
                                 beams=BEAMS)
    run(mapper, room_ticks(3, BEAMS, 2))
    # once per fleet tick, all three streams in one call
    assert calls == [("coarse_scores_kernel", (3, 64, 64)), ("fine_scores_kernel", (3, 64, 64)),
                     ("log_odds_update_kernel", (3, 64, 64))] * 2
    calls.clear()
    xla = tmapper.FleetMapper(port_params(map_backend="fused", match_backend="xla"), 3,
                              beams=BEAMS)
    run(xla, room_ticks(3, BEAMS, 1))
    assert calls == []


def test_snapshot_restore_mid_run():
    ticks = room_ticks(3, BEAMS, 6)
    whole = tmapper.FleetMapper(port_params(map_backend="fused"), 3, beams=BEAMS)
    want = run(whole, ticks)
    first = tmapper.FleetMapper(port_params(map_backend="fused"), 3, beams=BEAMS)
    assert run(first, ticks[:3]) == want[:3]
    snap = first.snapshot()
    for backend in ("fused", "host"):
        resumed = tmapper.FleetMapper(port_params(map_backend=backend), 3, beams=BEAMS)
        assert resumed.restore(snap) is True
        assert run(resumed, ticks[3:]) == want[3:]
        assert_same_snapshot(resumed.snapshot(), whole.snapshot())
    # a snapshot of another geometry or schema is refused, state untouched
    other = tmapper.FleetMapper(port_params(map_backend="fused", map_grid=32), 3, beams=BEAMS)
    before = other.snapshot()
    assert other.restore(snap) is False
    assert other.restore({**snap, "version": np.asarray(2, np.int32)}) is False
    assert_same_snapshot(other.snapshot(), before)
    assert tmapper.FleetMapper.snapshot_compatible(port_params(), {
        k: v[:1] if k != "version" else v for k, v in snap.items()})
    assert not tmapper.FleetMapper.snapshot_compatible(port_params(map_grid=32), snap, 3)
    assert other.restore(None) is False  # cold reset
    assert int(other.snapshot()["revision"].sum()) == 0


@pytest.mark.parametrize("port_backend", ["fused", "host"])
def test_snapshots_carry_across_the_packages(port_backend):
    """A map built by the JAX package continues in the port, and back,
    byte-equal to either package running alone."""
    ticks = room_ticks(3, BEAMS, 6)
    jwhole = jmapper.FleetMapper(jax_params(map_backend="host"), 3, beams=BEAMS)
    want = run(jwhole, ticks)

    jfirst = jmapper.FleetMapper(jax_params(map_backend="host"), 3, beams=BEAMS)
    run(jfirst, ticks[:2])
    port = tmapper.FleetMapper(port_params(map_backend=port_backend), 3, beams=BEAMS)
    assert port.restore(jfirst.snapshot())
    assert run(port, ticks[2:4]) == want[2:4]
    back = jmapper.FleetMapper(jax_params(map_backend="fused"), 3, beams=BEAMS)
    assert back.restore(port.snapshot())
    assert run(back, ticks[4:]) == want[4:]
    assert_same_snapshot(back.snapshot(), jwhole.snapshot())


@pytest.mark.parametrize("backend", ["fused", "host"])
def test_stream_checkpoint_surface_matches_jax(backend):
    ticks = room_ticks(3, BEAMS, 4)
    port = tmapper.FleetMapper(port_params(map_backend=backend), 3, beams=BEAMS)
    jax_m = jmapper.FleetMapper(jax_params(map_backend="host"), 3, beams=BEAMS)
    run(port, ticks[:3])
    run(jax_m, ticks[:3])
    for i in range(3):
        assert_same_snapshot(port.snapshot_stream(i), jax_m.snapshot_stream(i))
    # move stream 0's row onto stream 2, re-anchor stream 1 (clipped, wrapped)
    row = jax_m.snapshot_stream(0)
    assert port.restore_stream(2, row) and jax_m.restore_stream(2, row)
    for m in (port, jax_m):
        m.reanchor_stream(1, [10**6, -37, -5])
    assert_same_snapshot(port.snapshot(), jax_m.snapshot())
    np.testing.assert_array_equal(port.snapshot()["pose"][1],
                                  [port.cfg.t_limit_sub, -37, port.cfg.theta_divisions - 5])
    assert run(port, ticks[3:]) == run(jax_m, ticks[3:])
    assert_same_snapshot(port.snapshot(), jax_m.snapshot())
    # rejections leave the state untouched
    before = port.snapshot()
    assert not port.restore_stream(0, {**row, "version": np.asarray(0, np.int32)})
    assert not port.restore_stream(0, {**row, "log_odds": np.zeros((8, 8), np.int32)})
    assert_same_snapshot(port.snapshot(), before)
    with pytest.raises(IndexError):
        port.snapshot_stream(3)
    with pytest.raises(IndexError):
        port.reanchor_stream(-1, [0, 0, 0])


@pytest.mark.parametrize("backend", ["fused", "host"])
def test_idle_streams_pass_through(backend):
    mapper = tmapper.FleetMapper(port_params(map_backend=backend), 2, beams=BEAMS)
    pts, masks, _ = room_ticks(2, BEAMS, 1)[0]
    mapper.submit_points(pts, masks, np.ones(2, np.int32))
    before = mapper.snapshot()
    ests = mapper.submit_points(pts + 0.3, masks, np.asarray([0, 1], np.int32))
    after = mapper.snapshot()
    assert ests[0] is None and ests[1] is not None
    for k in ("log_odds", "pose", "revision"):
        np.testing.assert_array_equal(after[k][0], before[k][0])
    assert int(after["revision"][1]) == 2 and mapper.last_estimates[0].revision == 1


def test_submit_from_chain_outputs():
    class Out:
        def __init__(self, xy, mask):
            self.points_xy, self.point_mask = xy, mask

    pts, masks, _ = room_ticks(2, BEAMS, 1)[0]
    a = tmapper.FleetMapper(port_params(map_backend="fused"), 2, beams=BEAMS)
    b = tmapper.FleetMapper(port_params(map_backend="host"), 2, beams=BEAMS)
    ea = a.submit([Out(pts[0], masks[0]), None])
    eb = b.submit_points(pts, masks, np.asarray([1, 0], np.int32))
    assert ea[1] is None and np.array_equal(ea[0].pose_q, eb[0].pose_q)
    assert ea[0].score == eb[0].score and a.last_inputs[2].tolist() == [1, 0]
    with pytest.raises(ValueError, match="expected 2 outputs"):
        a.submit([None])
    with pytest.raises(ValueError, match="beam grid"):
        a.submit([Out(pts[0][:5], masks[0][:5]), None])


def test_recon_input_planes_and_clamp_pose_match_jax():
    rng = np.random.default_rng(5)
    recons = [None, (None, rng.normal(size=(BEAMS, 3)).astype(np.float32)), None]
    for a, b in zip(tmapper.recon_input_planes(recons, 3, BEAMS),
                    jmapper.recon_input_planes(recons, 3, BEAMS)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    cfg = tmapper.map_config_from_params(port_params(), BEAMS)
    jcfg = jmapper.map_config_from_params(jax_params(), BEAMS)
    for pose in ([0, 0, 0], [10**6, -10**6, 721], [5, -5, -1]):
        np.testing.assert_array_equal(tmapper.clamp_pose_q(pose, cfg),
                                      jmapper.clamp_pose_q(pose, jcfg))


# ---------------------------------------------------------------------------
# configuration and resolvers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("over", [
    {}, dict(map_grid=256, map_cell_m=0.05), dict(map_decay=0.4, map_log_odds_clamp=16.0),
    dict(map_match_window=1.3, map_log_odds_hit=1.2, map_log_odds_miss=-0.7),
    dict(voxel_backend="matmul", match_backend="pallas"),
])
def test_map_config_from_params_matches_jax(over):
    for beams in (1, 2048):
        ours = tmapper.map_config_from_params(port_params(**over), beams, platform="cpu")
        theirs = jmapper.map_config_from_params(jax_params(**over), beams, platform="cpu")
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)


def test_resolvers_follow_the_device():
    assert tmapper.resolve_map_backend("auto", "cuda") == "fused"
    assert tmapper.resolve_map_backend("auto", "cpu") == "host"
    assert tmapper.resolve_map_backend("auto", None) == "host"
    assert tmapper.resolve_map_backend("host", "cuda") == "host"
    assert tmapper.resolve_match_backend("auto", "cuda") == "pallas"
    assert tmapper.resolve_match_backend("auto", "cpu") == "xla"
    assert tmapper.resolve_match_backend("xla", "cuda") == "xla"
    assert tmapper.resolve_fused_mapping_backend("auto", "cuda") == "host"
    assert tmapper.resolve_fused_mapping_backend("fused") == "fused"
    cfg = tmapper.map_config_from_params(port_params(), 2048, platform="cuda")
    assert cfg.match_backend == "pallas" and cfg.voxel_backend == "scatter"
    # auto on the CPU is the host reference with the plain arm
    m = tmapper.FleetMapper(port_params(), 1, beams=BEAMS)
    assert m.backend == "host" and m.device is None and m.cfg.match_backend == "xla"
    m = tmapper.FleetMapper(port_params(map_backend="fused"), 1, beams=BEAMS)
    assert m.device == torch.device("cpu") and m.cfg.match_backend == "xla"


def test_no_card_means_no_mapper(monkeypatch):
    """The default filter_backend is the card: without one the fused
    mapper raises, never falls back to the host; only an explicit host
    backend or filter_backend cpu runs without a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for backend in ("auto", "fused"):
        with pytest.raises(RuntimeError, match="CUDA"):
            tmapper.FleetMapper(DriverParams(filter_chain=CHAIN, map_backend=backend, **MAP), 1)
    assert tmapper.FleetMapper(DriverParams(filter_chain=CHAIN, map_backend="host", **MAP),
                               1).backend == "host"


def test_unported_mapper_faces_raise():
    # the carried face is ported: it refuses an engine without the route
    with pytest.raises(ValueError, match="fused mapping route"):
        tmapper.CarriedFleetMapper(port_params(), types.SimpleNamespace(_mapping=None))
    m = tmapper.FleetMapper(port_params(map_backend="fused"), 1, beams=BEAMS)
    with pytest.raises(NotImplementedError, match="A.11"):
        m.save_sharded("/nonexistent")
    with pytest.raises(NotImplementedError, match="A.11"):
        m.load_sharded("/nonexistent")
    m.precompile()  # a warm tick on a throwaway state leaves the map alone
    assert int(m.snapshot()["revision"][0]) == 0 and m.ticks == 0


# ---------------------------------------------------------------------------
# replay --map
# ---------------------------------------------------------------------------

REPLAY_GEOM = dict(filter_window=8, voxel_grid_size=32, voxel_cell_m=0.25)


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    return write_capture(tmp_path_factory.mktemp("cap") / "dense.rplr", dense_frames(4, 14))


def test_replay_with_map_matches_jax(capture):
    revs = treplay.decode_recording(capture, device="cpu").revolutions()
    jrevs = jreplay.decode_recording(capture).revolutions()
    kw = dict(beams=256, capacity=512, chunk=5)
    jtraj, jscores, jm = jreplay.replay_with_map(
        jrevs, jax_params(map_backend="host", **REPLAY_GEOM), **kw)
    assert int(np.sum(jscores > 0)) > 0
    for backend in ("host", "fused"):
        traj, scores, m = treplay.replay_with_map(
            revs, port_params(map_backend=backend, **REPLAY_GEOM), **kw)
        assert m.backend == backend
        assert traj.dtype == np.float64 and traj.tobytes() == np.asarray(jtraj).tobytes()
        assert scores.dtype == np.int32 and np.array_equal(scores, jscores)
        assert_same_snapshot(m.snapshot(), jm.snapshot())
    # the loop-closure replay (A.9) is ported: its raw trajectory is this one
    ltraj, _corr, lscores, _m, engine = treplay.replay_with_loop_closure(
        revs, port_params(map_backend="host", loop_enable=True, **REPLAY_GEOM), **kw)
    assert ltraj.tobytes() == np.asarray(jtraj).tobytes() and np.array_equal(lscores, jscores)
    assert engine.backend == "host" and engine.ticks == len(revs)


def test_cli_replay_map_on_the_cpu_prints_jax_lines(capture, tmp_path, capsys):
    from rplidar_ros2_driver_tpu.__main__ import main as jmain

    lines = {}
    for name, entry in (("port", main), ("jax", jmain)):
        pgm = str(tmp_path / f"{name}.pgm")
        assert entry(["replay", capture, "--map", "--cpu", "--map-pgm", pgm]) == 0
        out = capsys.readouterr().out
        lines[name] = [ln for ln in out.splitlines() if "mapped" in ln or "wrote" in ln]
    assert len(lines["port"]) == 2 and "(host backend)" in lines["port"][0]
    assert lines["port"][0] == lines["jax"][0]
    assert "matched" in lines["port"][0] and "occupied cells" in lines["port"][0]
    port_pgm, jax_pgm = (open(tmp_path / f"{n}.pgm", "rb").read() for n in ("port", "jax"))
    assert port_pgm.startswith(b"P5\n256 256\n255\n") and port_pgm == jax_pgm
    # the ASCII preview too
    assert main(["replay", capture, "--map", "--cpu", "--map-backend", "fused"]) == 0
    out = capsys.readouterr().out
    assert "(fused backend)" in out and "#" in out


def test_cli_replay_loop_close_raises(capture, monkeypatch, capsys):
    # --loop-close (A.9) is ported: it runs, and prints the loop-closure line
    assert main(["replay", capture, "--map", "--loop-close", "--cpu"]) == 0
    assert "loop closure (host backend)" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["replay", capture, "--map"])  # the card by default


# ---------------------------------------------------------------------------
# the node with map_enable
# ---------------------------------------------------------------------------

NODE_GEOM = dict(filter_chain=CHAIN, filter_window=4, voxel_grid_size=32, **MAP)


def make_node(**kw) -> RPlidarNode:
    return RPlidarNode(
        DriverParams(dummy_mode=True, filter_backend="cpu", **{**NODE_GEOM, **kw}),
        driver_factory=lambda: DummyLidarDriver(scan_rate_hz=200.0),
        fsm_timings=FsmTimings.fast(),
    )


@pytest.mark.parametrize("backend", ["fused", "host"])
def test_node_publishes_poses_and_keeps_its_map(backend, tmp_path):
    node = make_node(map_backend=backend)
    try:
        assert node.configure() and node.activate()
        pub = node.publisher
        assert node.mapper.backend == backend
        assert wait_for(lambda: len(pub.poses) >= 3)
        pose = pub.poses[-1]
        assert pose.frame_id == "map" and pose.child_frame_id == node.params.frame_id
        assert pose.matched_points > 0 and pose.map_revision >= 3
        node._update_diagnostics()
        values = node.diagnostics.last.values
        assert values["Map Backend"] == backend and "Map Revision" in values
        assert node.tracer.percentile("map", 99.0) > 0
        assert node.deactivate()
        rev = int(node.mapper.snapshot()["revision"][0])
        assert node.activate()
        assert wait_for(lambda: pub.poses[-1].map_revision > rev)
        assert node.deactivate()
        path = str(tmp_path / "node.npz")
        assert node.save_checkpoint(path)
        snap = node.mapper.snapshot()
    finally:
        node.shutdown()
    assert node.lifecycle_state is LifecycleState.FINALIZED

    other = make_node(map_backend=backend)
    assert other.load_checkpoint(path)  # staged: restored on configure
    try:
        assert other.configure()
        assert_same_snapshot(other.mapper.snapshot(), snap)
        assert other.cleanup() and other.configure()  # survives cleanup too
        assert_same_snapshot(other.mapper.snapshot(), snap)
    finally:
        other.shutdown()


def test_jax_node_checkpoint_with_a_map_loads_into_the_port(tmp_path):
    from rplidar_ros2_driver_tpu.driver.dummy import DummyLidarDriver as JDummy
    from rplidar_ros2_driver_tpu.node.fsm import FsmTimings as JTimings
    from rplidar_ros2_driver_tpu.node.node import RPlidarNode as JNode

    jnode = JNode(JParams(dummy_mode=True, filter_backend="cpu", map_backend="host",
                          **NODE_GEOM),
                  driver_factory=lambda: JDummy(scan_rate_hz=200.0), fsm_timings=JTimings.fast())
    try:
        assert jnode.configure() and jnode.activate()
        assert wait_for(lambda: len(jnode.publisher.poses) >= 2)
        assert jnode.deactivate()
        path = str(tmp_path / "jax.npz")
        assert jnode.save_checkpoint(path)
        want = jnode.mapper.snapshot()
    finally:
        jnode.shutdown()
    assert int(want["revision"][0]) >= 2

    node = make_node(map_backend="fused")
    try:
        assert node.configure() and node.load_checkpoint(path)  # live restore
        assert_same_snapshot(node.mapper.snapshot(), want)
        back = str(tmp_path / "port.npz")
        assert node.save_checkpoint(back)
    finally:
        node.shutdown()
    from rplidar_ros2_driver_tpu.utils.checkpoint import load_checkpoint

    saved, _meta = load_checkpoint(back)
    assert_same_snapshot({k[len("mapper."):]: v for k, v in saved.items()
                          if k.startswith("mapper.")}, want)
    # a map of another geometry is dropped, the chain still restored
    small = make_node(map_grid=32)
    try:
        assert small.configure() and small.load_checkpoint(path)
        assert int(small.mapper.snapshot()["revision"][0]) == 0
    finally:
        small.shutdown()


def test_loop_enable_raises():
    # loop_enable (A.9) is ported: the node builds its loop engine beside the
    # mapper (the host reference with filter_backend cpu)
    node = make_node(loop_enable=True)
    try:
        assert node.configure() and node.loop.backend == "host"
        assert node.loop.mapper is node.mapper
    finally:
        node.shutdown()


def test_cli_replay_map_skips_a_capture_without_revolutions(capture, capsys):
    empty = os.path.join(os.path.dirname(capture), "empty.rplr")
    write_capture(empty, [])
    assert main(["replay", empty, "--map", "--cpu"]) == 0
    assert "--map skipped (no complete revolutions)" in capsys.readouterr().out

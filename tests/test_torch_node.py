"""The PyTorch package's node and raw publish path on the CPU, against the
JAX package where the two must agree.

Dummy-mode nodes run with ``filter_backend: cpu`` (the only setting that
keeps the port off the card).  The raw path's ``ascend_scan`` and
``to_laserscan`` are held bit-exact to the JAX package; the dummy's
float32 ``sin`` may differ by an ulp between the two packages, so its
``dist_q2`` is held to +/-1 q2.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from conftest import wait_for
from rplidar_ros2_driver_tpu.core.types import ScanBatch as JB
from rplidar_ros2_driver_tpu.ops.ascend import ascend_scan as j_ascend
from rplidar_ros2_driver_tpu.ops.laserscan import to_laserscan as j_ls
from rplidar_ros2_driver_tpu_torch.core.config import DriverParams
from rplidar_ros2_driver_tpu_torch.core.types import ScanBatch as TB
from rplidar_ros2_driver_tpu_torch.driver.dummy import DummyLidarDriver, synth_scan
from rplidar_ros2_driver_tpu_torch.node.fsm import FsmTimings
from rplidar_ros2_driver_tpu_torch.node.lifecycle import LifecycleState
from rplidar_ros2_driver_tpu_torch.node.node import RPlidarNode
from rplidar_ros2_driver_tpu_torch.ops.ascend import apply_angle_compensation, ascend_scan
from rplidar_ros2_driver_tpu_torch.ops.laserscan import to_laserscan
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHAIN = ("clip", "polar", "median", "voxel")


def make_node(**kw) -> RPlidarNode:
    params = DriverParams(dummy_mode=True, filter_backend="cpu", **kw)
    return RPlidarNode(
        params,
        driver_factory=lambda: DummyLidarDriver(scan_rate_hz=200.0),
        fsm_timings=FsmTimings.fast(),
    )


def test_dummy_node_streams_filtered_scans_and_keeps_its_window():
    node = make_node(filter_chain=CHAIN, filter_window=8, voxel_grid_size=64)
    try:
        assert node.configure() and node.activate()
        pub = node.publisher
        assert wait_for(lambda: pub.scan_count >= 10)
        node._update_diagnostics()
        assert node.diagnostics.last.message == "Scanning"
        scan = pub.scans[-1]
        assert scan.ranges.shape == (2048,)
        fin = np.isfinite(scan.ranges)
        assert fin.sum() > 0 and np.abs(scan.ranges[fin] - 2.0).max() < 0.6
        assert pub.clouds[-1].voxel.sum() > 0
        assert node.deactivate()
        filled = int(node.chain.state.filled)
        assert filled == 8
        snap = node._chain_snapshot
        assert node.cleanup() and node.configure()  # a NEW chain restores the window
        np.testing.assert_array_equal(node.chain.snapshot()["range_window"], snap["range_window"])
        assert node.activate()
        n = pub.scan_count
        assert wait_for(lambda: pub.scan_count >= n + 5)
    finally:
        node.shutdown()
    assert node.lifecycle_state is LifecycleState.FINALIZED


def test_pipelined_node_publishes():
    node = make_node(filter_chain=CHAIN, filter_window=4, voxel_grid_size=32, pipelined_publish=True)
    try:
        assert node.configure() and node.activate()
        assert wait_for(lambda: node.publisher.scan_count >= 5)
    finally:
        node.shutdown()


def test_raw_path_node_publishes_laserscans():
    node = make_node(filter_chain=(), scan_processing=True)
    try:
        assert node.configure() and node.activate()
        assert node.chain is None and node.raw_device.type == "cpu"
        pub = node.publisher
        assert wait_for(lambda: pub.scan_count >= 3)
        scan = pub.scans[-1]
        assert scan.ranges.shape == (360,)
        fin = np.isfinite(scan.ranges)  # Mode A may leave a grid cell empty
        assert fin.sum() >= 350 and np.abs(scan.ranges[fin] - 2.0).max() < 0.6
    finally:
        node.shutdown()


def test_jax_node_checkpoint_loads_into_port_node(tmp_path):
    from rplidar_ros2_driver_tpu.core.config import DriverParams as JParams
    from rplidar_ros2_driver_tpu.driver.dummy import DummyLidarDriver as JDummy
    from rplidar_ros2_driver_tpu.node.fsm import FsmTimings as JTimings
    from rplidar_ros2_driver_tpu.node.node import RPlidarNode as JNode

    geom = dict(filter_chain=CHAIN, filter_window=4, voxel_grid_size=32)
    jnode = JNode(JParams(dummy_mode=True, filter_backend="cpu", **geom),
                  driver_factory=lambda: JDummy(scan_rate_hz=200.0), fsm_timings=JTimings.fast())
    try:
        assert jnode.configure() and jnode.activate()
        assert wait_for(lambda: jnode.publisher.scan_count >= 6)
        assert jnode.deactivate()
        path = str(tmp_path / "jax_node.npz")
        assert jnode.save_checkpoint(path)
        want = jnode.chain.snapshot()
    finally:
        jnode.shutdown()

    node = make_node(**geom)
    assert node.load_checkpoint(path)  # staged for the next configure
    try:
        assert node.configure()
        got = node.chain.snapshot()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        # and the port writes the same format back
        back = str(tmp_path / "port_node.npz")
        assert node.save_checkpoint(back)
        other = make_node(**geom)
        assert other.configure() and other.load_checkpoint(back)
        np.testing.assert_array_equal(other.chain.snapshot()["hit_window"], want["hit_window"])
        other.shutdown()
        # a checkpoint of another geometry is refused, touching nothing
        small = make_node(filter_chain=CHAIN, filter_window=2, voxel_grid_size=32)
        assert not small.load_checkpoint(path)
    finally:
        node.shutdown()


def test_unported_branches_raise():
    # loop closure (A.9) is ported: loop_enable builds the engine
    looped = make_node(filter_chain=CHAIN, map_enable=True, loop_enable=True)
    try:
        assert looped.configure() and looped.loop is not None
    finally:
        looped.shutdown()
    # the real driver (A.4) is ported: without dummy_mode the default
    # factory builds it (configure connects nothing)
    from rplidar_ros2_driver_tpu_torch.driver.real import RealLidarDriver

    real = RPlidarNode(DriverParams(filter_backend="cpu"))
    try:
        assert real.configure()
        assert isinstance(real._default_factory(), RealLidarDriver)
    finally:
        real.shutdown()
    # the fused seam (A.4) is ported too; a driver without it is refused
    # with one clear error when the FSM builds it
    fused = RPlidarNode(
        DriverParams(filter_backend="cpu", filter_chain=CHAIN, ingest_backend="fused"),
        driver_factory=lambda: DummyLidarDriver(scan_rate_hz=200.0),
    )
    try:
        assert fused.configure() and fused.fused_ingest is not None and fused.chain is None
        with pytest.raises(RuntimeError, match="set_ingest_sink"):
            fused.fsm._factory()
    finally:
        fused.shutdown()
    # dummy mode with fused ingest falls back to the host path, as the
    # JAX package does
    node = RPlidarNode(DriverParams(dummy_mode=True, filter_backend="cpu", filter_chain=CHAIN,
                                    ingest_backend="fused"))
    assert node._resolve_fused_ingest() is False


def test_synth_scan_within_one_q2_of_jax():
    from rplidar_ros2_driver_tpu.driver.dummy import synth_scan as j_synth

    for phase in (0.1, 0.7, 3.3):
        j = j_synth(jnp.float32(phase), count=360, capacity=1024)
        t = synth_scan(phase, count=360, capacity=1024)
        for f in ("angle_q14", "quality", "flag", "valid", "count"):
            np.testing.assert_array_equal(np.asarray(getattr(j, f)), getattr(t, f).numpy(), err_msg=f)
        diff = np.abs(np.asarray(j.dist_q2).astype(np.int64) - t.dist_q2.numpy())
        assert diff.max() <= 1


def raw_scan(rng, n):
    angle = np.sort(rng.integers(0, 65536, n)).astype(np.int32)
    angle = (angle + rng.integers(-300, 300, n)).clip(0, 65535).astype(np.int32)
    dist = rng.integers(1, 160_000, n).astype(np.int32)
    dist[rng.random(n) < 0.3] = 0
    if n % 3 == 0:
        dist[: int(rng.integers(1, n))] = 0  # leading drop-outs: head walk-back
    qual = rng.integers(0, 256, n).astype(np.int32)
    return angle, dist, qual


def test_ascend_scan_matches_jax():
    rng = np.random.default_rng(21)
    for _ in range(40):
        n = int(rng.integers(2, 900))
        a, d, q = raw_scan(rng, n)
        jo, jok = j_ascend(JB.from_numpy(a, d, q, n=1024))
        to, tok = ascend_scan(TB.from_numpy(a, d, q, n=1024, device="cpu"))
        assert bool(jok) == bool(tok)
        for f in ("angle_q14", "dist_q2", "quality", "flag", "valid"):
            np.testing.assert_array_equal(np.asarray(getattr(jo, f)), getattr(to, f).numpy(), err_msg=f)
    z = np.zeros(5, np.int32)
    out, ok = ascend_scan(TB.from_numpy(z + 7, z, z, n=16, device="cpu"))
    assert not bool(ok)
    assert apply_angle_compensation(TB.from_numpy(z, z, z, n=16, device="cpu"), False).count == 5


@pytest.mark.parametrize("is_new", [True, False])
@pytest.mark.parametrize("inverted", [False, True])
@pytest.mark.parametrize("scan_processing", [False, True])
def test_to_laserscan_matches_jax(scan_processing, inverted, is_new):
    rng = np.random.default_rng(int(scan_processing) * 4 + int(inverted) * 2 + int(is_new))
    for _ in range(8):
        n = int(rng.integers(0, 900))
        a, d, q = raw_scan(rng, n)
        jb, _ = j_ascend(JB.from_numpy(a, d, q, n=1024))
        tb, _ = ascend_scan(TB.from_numpy(a, d, q, n=1024, device="cpu"))
        kw = dict(scan_processing=scan_processing, inverted=inverted, is_new_type=is_new)
        jl = j_ls(jb, 0.1, 12.0, **kw)
        tl = to_laserscan(tb, 0.1, 12.0, **kw)
        for f in ("ranges", "intensities", "beam_count", "angle_min", "angle_max",
                  "angle_increment", "time_increment", "scan_time", "range_min", "range_max"):
            np.testing.assert_array_equal(np.asarray(getattr(jl, f)), getattr(tl, f).numpy(), err_msg=f)


def test_run_dummy_cli_on_the_cpu(tmp_path):
    params = tmp_path / "cpu.yaml"
    params.write_text(
        "rplidar_node:\n  ros__parameters:\n"
        "    filter_backend: cpu\n"
        "    filter_chain: [clip, polar, median, voxel]\n"
        "    filter_window: 8\n"
        "    voxel_grid_size: 64\n"
    )
    proc = subprocess.run(
        [sys.executable, "-m", "rplidar_ros2_driver_tpu_torch", "run", "--dummy",
         "--duration", "2", "--params", str(params)],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    counts = [int(line.split("scans=")[1].split()[0]) for line in proc.stdout.splitlines() if "scans=" in line]
    assert counts and counts[-1] > 0
    assert "state=Scanning" in proc.stdout


def test_scanbatch_host_roundtrip_matches_jax():
    rng = np.random.default_rng(30)
    a, d, q = raw_scan(rng, 100)
    j = JB.from_numpy(a, d, q, n=256).to_host()
    t = TB.from_numpy(a, d, q, n=256, device="cpu").to_host()
    for k in j:
        np.testing.assert_array_equal(np.asarray(j[k]), t[k], err_msg=k)
    with pytest.raises(ValueError):
        TB.from_numpy(a, d, q, n=50, device="cpu")


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    from rplidar_ros2_driver_tpu_torch.utils.tracing import profile_trace

    with profile_trace(str(tmp_path)) as prof:
        ascend_scan(TB.from_numpy(*raw_scan(np.random.default_rng(31), 50), n=64, device="cpu"))
    assert (tmp_path / "trace.json").stat().st_size > 0
    assert any("argsort" in ev.key or "sort" in ev.key for ev in prof.key_averages())

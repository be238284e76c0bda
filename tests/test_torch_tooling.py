"""The PyTorch package's tooling against the JAX package's.

The intra-process bus and the composable-node container (launch/), the udev
rules (tools/udev.py), the legacy compat shim (compat.py), the rclpy bridge
(tools/ros_bridge.py), the torch backend probe (utils/backend.py) and the
CLI's ``view``/``udev``/``doctor``, held to the JAX suite's cases
(tests/test_launch_deploy.py, test_compat.py, test_ros_bridge.py) and, where
the two packages print or render the same thing, to the JAX package's own
output.  The CLI runs in process (``main([..., "--cpu"])``), not in
subprocesses.
"""

from __future__ import annotations

import hashlib
import os
import re
import time

import numpy as np
import pytest

import chip_smoke
from rplidar_ros2_driver_tpu import compat as jcompat
from rplidar_ros2_driver_tpu.__main__ import main as jmain
from rplidar_ros2_driver_tpu.tools import udev as judev
from rplidar_ros2_driver_tpu.tools import viz as jviz
from rplidar_ros2_driver_tpu_torch import compat
from rplidar_ros2_driver_tpu_torch.__main__ import main
from rplidar_ros2_driver_tpu_torch.core.config import DriverParams
from rplidar_ros2_driver_tpu_torch.core.results import DeviceHealth
from rplidar_ros2_driver_tpu_torch.driver.dummy import DummyLidarDriver
from rplidar_ros2_driver_tpu_torch.launch import IntraProcessBus, NodeContainer
from rplidar_ros2_driver_tpu_torch.launch.bus import _Subscription
from rplidar_ros2_driver_tpu_torch.protocol import constants as c
from rplidar_ros2_driver_tpu_torch.tools import ros_bridge, udev, viz
from rplidar_ros2_driver_tpu_torch.utils import backend
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

# ---------------------------------------------------------------------------
# the intra-process bus (JAX TestIntraProcessBus)
# ---------------------------------------------------------------------------


def test_zero_copy_delivery():
    bus = IntraProcessBus()
    got = []
    bus.subscribe("/scan", got.append)
    msg = object()
    assert bus.publish("/scan", msg) == 1
    assert got[0] is msg  # same object, no serialization


@pytest.mark.parametrize("reliable,want", [(False, [3, 4]), (True, [0, 1, 2, 3, 4])])
def test_bounded_best_effort_and_reliable_queues(reliable, want):
    bus = IntraProcessBus()
    sub = bus.subscribe("/scan", reliable=reliable, maxlen=2)
    for k in range(5):
        bus.publish("/scan", k)
    assert sub.drain() == want


def test_latched_topic_replays_to_late_subscriber_and_may_reenter():
    bus = IntraProcessBus()
    bus.publish("/tf_static", "tf0", latched=True)
    assert bus.subscribe("/tf_static").drain() == ["tf0"]
    got = []

    def reenter(msg):
        got.append(msg)
        bus.publish("/echo", msg)  # re-enters the bus outside its lock
        bus.topic_names()

    echo = bus.subscribe("/echo")
    bus.subscribe("/tf_static", reenter)
    assert got == ["tf0"] and echo.drain() == ["tf0"]


def test_replay_ordering_against_live_publishes():
    sub = _Subscription(None, reliable=True, maxlen=8)
    sub.deliver("m2", 2)               # live publish won the race
    sub.deliver("m1", 1, replay=True)  # stale replay arrives late: dropped
    assert sub.drain() == ["m2"]
    sub.deliver("m2", 2)
    sub.deliver("m1", 1)  # out-of-order live delivery: kept (reliable)
    assert sub.drain() == ["m2", "m1"]


def test_raising_callback_does_not_wedge_subscription_or_publisher():
    bus = IntraProcessBus()
    got, calls = [], {"n": 0}

    def flaky(msg):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("boom")
        got.append(msg)

    bus.subscribe("/t", flaky)
    bus.publish("/t", "m1")  # contained, logged
    bus.publish("/t", "m2")
    assert calls["n"] == 2 and got == ["m2"]


# ---------------------------------------------------------------------------
# the container
# ---------------------------------------------------------------------------


def test_container_composition_end_to_end():
    """Two composed nodes publish on namespaced topics over one bus."""
    with NodeContainer() as cont:
        for name in ("lidar_a", "lidar_b"):
            cont.add_node(name, DriverParams(dummy_mode=True, filter_backend="cpu"))
        sub_a = cont.bus.subscribe("/lidar_a/scan")
        sub_b = cont.bus.subscribe("/lidar_b/scan")
        assert cont.configure_all() and cont.activate_all()
        deadline = time.monotonic() + 10
        got_a = got_b = False
        while time.monotonic() < deadline and not (got_a and got_b):
            got_a = got_a or bool(sub_a.drain())
            got_b = got_b or bool(sub_b.drain())
            time.sleep(0.02)
        assert got_a and got_b, "composed nodes did not both publish"
    assert not cont.nodes  # shutdown_all unloaded them


def test_container_duplicate_name_rejected():
    cont = NodeContainer()
    cont.add_node("x", DriverParams(dummy_mode=True, filter_backend="cpu"))
    with pytest.raises(ValueError):
        cont.add_node("x", DriverParams(dummy_mode=True, filter_backend="cpu"))
    cont.shutdown_all()


# ---------------------------------------------------------------------------
# udev and the viz renderer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("symlink", ["rplidar", "lidar2"])
def test_udev_rules_text_equals_jax(symlink):
    text = udev.udev_rules_text(symlink=symlink)
    assert text == judev.udev_rules_text(symlink=symlink)
    assert '"10c4"' in text and '"ea60"' in text and f'SYMLINK+="{symlink}"' in text
    assert 'MODE:="0666"' in text and 'GROUP:="dialout"' in text


def test_udev_install_requires_root(tmp_path):
    if os.geteuid() == 0:
        path = tmp_path / "99-rplidar.rules"
        udev.install(str(path), symlink="lidar2", reload_udev=False)
        assert 'SYMLINK+="lidar2"' in path.read_text()
    else:
        with pytest.raises(PermissionError):
            udev.install(str(tmp_path / "r.rules"), reload_udev=False)


def test_cli_udev_prints_the_jax_text(capsys):
    assert main(["udev"]) == 0
    out = capsys.readouterr().out
    assert jmain(["udev"]) == 0
    assert out == capsys.readouterr().out
    # the digest chip_smoke.py's tooling phase holds the card's output to
    assert hashlib.sha256(out.encode()).hexdigest() == chip_smoke.UDEV_SHA256


def test_cli_view_renders_a_scan(tmp_path, capsys):
    """``view`` end to end in process: an ASCII preview, and a PGM whose
    header and size are the JAX renderer's."""
    assert main(["view", "--scans", "1", "--cpu"]) == 0
    assert "#" in capsys.readouterr().out
    pgm = tmp_path / "v.pgm"
    assert main(["view", "--scans", "1", "--cpu", "--pgm", str(pgm)]) == 0
    assert f"wrote {pgm}" in capsys.readouterr().out
    assert pgm.read_bytes().startswith(b"P5\n256 256\n255")


def test_viz_is_the_jax_renderer():
    from rplidar_ros2_driver_tpu.node.messages import LaserScanHost as JScan
    from rplidar_ros2_driver_tpu_torch.node.messages import LaserScanHost

    n = 360
    inc = 2 * np.pi / n
    kw = dict(stamp=0.0, frame_id="laser", angle_min=-np.pi, angle_max=np.pi - inc,
              angle_increment=inc, time_increment=0.0, scan_time=0.1, range_min=0.15,
              range_max=12.0, ranges=np.full(n, 2.0, np.float32),
              intensities=np.full(n, 47.0, np.float32))
    kw["ranges"][:180] = np.inf
    img = viz.scan_to_image(LaserScanHost(**kw), size_px=128, view_range_m=4.0)
    assert np.array_equal(img, jviz.scan_to_image(JScan(**kw), size_px=128, view_range_m=4.0))
    assert viz.ascii_preview(img, width=32) == jviz.ascii_preview(img, width=32)


# ---------------------------------------------------------------------------
# the doctor and the torch backend probe
# ---------------------------------------------------------------------------


def _rows(text: str) -> list[tuple[str, str]]:
    return re.findall(r"^\[(\w+)\s*\] ([^:]+):", text, re.M)


def test_cli_doctor_has_the_jax_rows(capsys):
    """Every probe runs, the loopback round trip passes, a missing serial
    port is a WARN (exit 0); the rows are JAX's, with the torch backend in
    place of the JAX one."""
    args = ["doctor", "--cpu", "--port", "/dev/definitely_not_a_lidar"]
    assert main(args) == 0
    out = capsys.readouterr().out
    assert "[PASS] loopback protocol round-trip" in out
    assert "[WARN] serial port" in out and "[PASS] torch backend: cpu" in out
    assert jmain(args) == 0
    jrows = [(lvl, name.replace("jax backend", "torch backend"))
             for lvl, name in _rows(capsys.readouterr().out)]
    assert _rows(out) == jrows
    # the rows chip_smoke.py's tooling phase holds the doctor on the card to
    assert [name for _lvl, name in jrows] == chip_smoke.DOCTOR_ROWS


def test_doctor_fails_on_a_failed_probe_and_skips_the_round_trip(monkeypatch, capsys):
    monkeypatch.setattr(backend, "probe_torch_backend_subprocess",
                        lambda timeout_s: (False, "CUDA not available"))
    assert main(["doctor", "--port", "/dev/definitely_not_a_lidar"]) == 1
    out = capsys.readouterr().out
    assert "[FAIL] torch backend: CUDA not available" in out
    assert "[SKIP] loopback protocol round-trip" in out


def test_probe_reports_the_missing_card_and_bad_timeouts():
    ok, detail = backend.probe_torch_backend(30.0)
    assert not ok and "CUDA not available" in detail
    ok, detail = backend.probe_torch_backend_subprocess(60.0)
    assert not ok and "CUDA not available" in detail
    for bad in (0, -1, None):
        for probe in (backend.probe_torch_backend, backend.probe_torch_backend_subprocess):
            ok, detail = probe(bad)
            assert not ok and "non-positive probe timeout" in detail
    assert backend.probe_torch_backend(30.0, device="cpu")[0]


def test_probe_retry_and_deadlines():
    calls = []

    def flaky(timeout_s):
        calls.append(timeout_s)
        return (len(calls) == 2), f"attempt {len(calls)}"

    logs = []
    assert backend.probe_torch_backend_with_retry(
        total_budget_s=5.0, per_probe_s=1.0, interval_s=0.01, log=logs.append,
        _probe=flaky) == (True, "attempt 2")
    assert len(logs) == 1 and "backend probe 1 failed" in logs[0]
    ok, detail = backend.probe_torch_backend_with_retry(
        total_budget_s=0.05, per_probe_s=1.0, interval_s=0.1, _probe=lambda t: (False, "down"))
    assert not ok and "backend unreachable after 1 probes" in detail
    assert backend.run_with_deadline(lambda: 7, 5.0) == 7
    with pytest.raises(backend.MeasurementWedgedError):
        backend.run_with_deadline(lambda: time.sleep(2), 0.05)
    with pytest.raises(KeyError):
        backend.run_with_deadline(lambda: {}["x"], 5.0)
    with pytest.raises(ValueError, match="positive deadline"):
        backend.run_with_deadline(lambda: 1, 0)


def test_build_cache_follows_the_parameter(tmp_path, monkeypatch):
    from rplidar_ros2_driver_tpu_torch.utils import cuda_build

    monkeypatch.setattr(cuda_build, "BUILD_DIR", cuda_build.BUILD_DIR)
    monkeypatch.setattr(backend, "_cache_enabled_dir", None)
    assert not backend.maybe_enable_compilation_cache(None)
    assert backend.compilation_cache_status() == {"enabled": False}
    cache = tmp_path / "kernels"
    assert backend.maybe_enable_compilation_cache(str(cache))
    assert cuda_build.BUILD_DIR == cache.resolve()
    assert cuda_build.library_path("median").parent == cache.resolve()
    assert backend.compilation_cache_status() == {"enabled": True, "dir": str(cache),
                                                  "entries": 0, "cold": True}


# ---------------------------------------------------------------------------
# the compat shim (JAX tests/test_compat.py)
# ---------------------------------------------------------------------------


def test_alias_values_match_jax():
    names = [n for n in dir(jcompat) if n.startswith("RPLIDAR_")] + ["MAX_SCAN_NODES"]
    assert len(names) > 20
    for n in names:
        assert int(getattr(compat, n)) == int(getattr(jcompat, n)), n
    assert compat.RPLIDAR_CMD_FORCE_SCAN == 0x21
    assert compat.RPLIDAR_ANS_TYPE_MEASUREMENT == int(c.Ans.MEASUREMENT)


def test_facade_forwards_to_impl():
    drv = compat.RPlidarDriver(DummyLidarDriver())
    assert drv.connect("/dev/fake", 115200)
    assert drv.isConnected()
    assert drv.getHealth() == DeviceHealth.OK
    assert drv.startScan()
    batch = drv.grabScanDataHq(2000)
    assert batch is not None
    assert batch.to_host()["angle_q14"].shape[0] > 0
    asc = drv.ascendScanData(batch)
    ang = np.asarray(asc.angle_q14)[: int(asc.count)]
    assert (np.diff(ang.astype(np.int64)) >= 0).all()
    drv.stop()
    drv.stopMotor()
    compat.RPlidarDriver.DisposeDriver(drv)


def test_deprecations_and_unsupported_legacy_args_warn():
    with pytest.warns(DeprecationWarning):
        compat.RPlidarDriver.CreateDriver(impl=DummyLidarDriver())
    drv = compat.RPlidarDriver(DummyLidarDriver())
    with pytest.warns(RuntimeWarning, match="FORCE_SCAN"):
        drv.startScan(force=True)
    with pytest.warns(RuntimeWarning, match="fixed_angle"):
        drv.startScanExpress(True, "Standard")


def test_force_scan_against_sim():
    """startScan(force=True) sends FORCE_SCAN 0x21 and streams."""
    from rplidar_ros2_driver_tpu_torch.driver.real import RealLidarDriver
    from rplidar_ros2_driver_tpu_torch.driver.sim_device import SimulatedDevice

    sim = SimulatedDevice().start()
    try:
        drv = RealLidarDriver(channel_type="tcp", tcp_host="127.0.0.1", tcp_port=sim.port,
                              motor_warmup_s=0.0, legacy_warmup_s=0.0)
        facade = compat.RPlidarDriver(drv)
        assert facade.connect("sim", 0)
        assert facade.startScan(force=True)  # no warning on the real backend
        batch = facade.grabScanDataHq(5000)
        assert batch is not None and int(batch.count) > 0
        assert drv.profile.active_mode == "Standard (forced)"
        facade.stop()
        facade.disconnect()
    finally:
        sim.stop()


# ---------------------------------------------------------------------------
# the rclpy bridge's gating (JAX tests/test_ros_bridge.py)
# ---------------------------------------------------------------------------


def test_ros_bridge_gating():
    from rplidar_ros2_driver_tpu_torch.node.publisher import PublisherBase

    assert isinstance(ros_bridge.rclpy_available(), bool)
    assert issubclass(ros_bridge.RclpyPublisher, PublisherBase)
    # the QoS vocabulary check precedes any ROS import
    with pytest.raises(ValueError, match="qos_reliability"):
        ros_bridge.RclpyPublisher(qos_reliability="RELIABLE")
    if not ros_bridge.rclpy_available():
        with pytest.raises(ImportError):
            ros_bridge.RclpyPublisher()

"""The PyTorch package's mirror of tests/test_hot_swap.py.

Dynamic scan_mode hot-swap against the live protocol simulator.

The reference's most involved reconfigure path (parameters_callback
"scan_mode": stop motor -> 500 ms -> start_motor(new) -> fall back to
auto on failure, src/rplidar_node.cpp:740-770).  Everything else about
reconfigure is covered elsewhere; this exercises the swap end-to-end:
the device actually changes wire format mid-session and streaming
resumes, and an unknown mode lands on the driver's preference fallback
(DenseBoost) instead of killing the stream.
"""

import time

from rplidar_ros2_driver_tpu_torch.core.config import DriverParams
from rplidar_ros2_driver_tpu_torch.driver.real import RealLidarDriver
from rplidar_ros2_driver_tpu_torch.driver.sim_device import SimulatedDevice
from rplidar_ros2_driver_tpu_torch.node.fsm import FsmTimings
from rplidar_ros2_driver_tpu_torch.node.node import RPlidarNode
from rplidar_ros2_driver_tpu_torch.protocol.constants import Ans
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)


def _wait_scans(node, n, timeout=20.0):
    base = node.publisher.scan_count
    t0 = time.monotonic()
    while node.publisher.scan_count < base + n:
        assert time.monotonic() - t0 < timeout, "stream stalled"
        time.sleep(0.05)


def _wait_ans_type(sim, ans, timeout=10.0):
    """Scan starts are fire-and-forget on the wire (send_only, like the
    reference), so the sim's rx thread observes the command a beat after
    start_motor returns — poll instead of racing it."""
    from conftest import wait_for

    assert wait_for(lambda: sim.active_ans_type == ans, timeout), (
        f"sim never switched to ans {ans} (at {sim.active_ans_type})"
    )


def test_scan_mode_hot_swap_and_fallback():
    sim = SimulatedDevice().start()
    node = None
    try:
        params = DriverParams(
            dummy_mode=False, channel_type="tcp", scan_mode="DenseBoost",
            filter_backend="cpu", filter_chain=(),
        )
        node = RPlidarNode(
            params,
            driver_factory=lambda: RealLidarDriver(
                channel_type="tcp", tcp_host="127.0.0.1", tcp_port=sim.port,
                motor_warmup_s=0.0),
            fsm_timings=FsmTimings(idle_tick_s=0.01),
        )
        assert node.configure()
        assert node.activate()
        _wait_scans(node, 2)
        assert node.fsm.driver.profile.active_mode == "DenseBoost"
        _wait_ans_type(sim, Ans.MEASUREMENT_DENSE_CAPSULED)

        # hot-swap to Standard: device switches wire format, stream resumes
        ok, msg = node.set_parameters({"scan_mode": "Standard"})
        assert ok, msg
        assert node.params.scan_mode == "Standard"
        _wait_scans(node, 2)
        assert node.fsm.driver.profile.active_mode == "Standard"
        _wait_ans_type(sim, Ans.MEASUREMENT)

        # a mode the device does not advertise: the DRIVER's preference
        # fallback kicks in (user pref -> DenseBoost -> Sensitivity,
        # src/lidar_driver_wrapper.cpp:207-245), so the swap still
        # succeeds and streaming resumes in the fallback mode
        ok, msg = node.set_parameters({"scan_mode": "NoSuchMode"})
        assert ok, msg
        _wait_scans(node, 2)
        assert node.fsm.driver.profile.active_mode == "DenseBoost"
        _wait_ans_type(sim, Ans.MEASUREMENT_DENSE_CAPSULED)
        assert node.fsm.reset_count == 0
    finally:
        if node is not None:
            node.shutdown()
        sim.stop()

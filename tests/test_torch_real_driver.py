"""The PyTorch package's mirror of tests/test_real_driver.py: its
RealLidarDriver against its own SimulatedDevice over TCP:
the full stack — native channel + transceiver -> codec -> command engine ->
conf protocol -> per-format decode -> scan assembly — without hardware.
Also drives the whole node FSM over it, including automated hot-unplug."""

import time

import numpy as np
import pytest

from rplidar_ros2_driver_tpu_torch import native as native_mod
from rplidar_ros2_driver_tpu_torch.core.config import DriverParams
from rplidar_ros2_driver_tpu_torch.core.results import DeviceHealth
from rplidar_ros2_driver_tpu_torch.driver.real import RealLidarDriver
from rplidar_ros2_driver_tpu_torch.driver.sim_device import SimConfig, SimulatedDevice
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

pytestmark = pytest.mark.skipif(
    not native_mod.available(), reason="native library unavailable"
)


from conftest import wait_for


def _wait(predicate, timeout=10.0, interval=0.01):
    return wait_for(predicate, timeout, interval)


def make_driver(sim: SimulatedDevice, **kw) -> RealLidarDriver:
    return RealLidarDriver(
        channel_type="tcp",
        tcp_host=SimulatedDevice.TARGET,
        tcp_port=sim.port,
        motor_warmup_s=0.0,
        legacy_warmup_s=0.0,
        **kw,
    )


@pytest.fixture
def sim():
    dev = SimulatedDevice().start()
    yield dev
    dev.stop()


class TestConnect:
    def test_connect_and_identify(self, sim):
        drv = make_driver(sim)
        assert drv.connect("ignored", 0, True)
        assert drv.is_connected()
        info = drv.device_info
        assert info.model == 0x71
        assert "S7M1" not in info.summary()
        drv.detect_and_init_strategy()
        assert drv.is_new_type()
        assert drv.get_hw_max_distance() == 40.0
        drv.disconnect()
        assert not drv.is_connected()

    def test_connect_failure_no_server(self):
        drv = RealLidarDriver(channel_type="tcp", tcp_host="127.0.0.1", tcp_port=1)
        assert not drv.connect("ignored", 0, True)

    def test_health(self, sim):
        drv = make_driver(sim)
        assert drv.connect("ignored", 0, True)
        assert drv.get_health() is DeviceHealth.OK
        sim.cfg.health_status = 2
        assert drv.get_health() is DeviceHealth.ERROR
        drv.disconnect()

    def test_legacy_model_profile(self):
        dev = SimulatedDevice(SimConfig(model_id=0x18)).start()  # A1M8
        try:
            drv = make_driver(dev)
            assert drv.connect("ignored", 0, True)
            drv.detect_and_init_strategy()
            assert not drv.is_new_type()
            assert drv.get_hw_max_distance() == 12.0
            drv.print_summary()  # smoke: the SDK summary table renders
            drv.disconnect()
        finally:
            dev.stop()

    def test_legacy_samplerate_queried_from_device(self):
        """OLD_TYPE startup on firmware >= 1.17 must ask the device for its
        sample duration (GET_SAMPLERATE, sl_lidar_driver.cpp:1556-1599)
        instead of assuming the 476 us legacy default.  Pre-conf firmware
        takes the Express fallback, so the EXPRESS duration is the one
        that lands in the timing model (startScanExpress legacy branch,
        :722)."""
        from rplidar_ros2_driver_tpu_torch.protocol.constants import Cmd

        # firmware exactly 1.17 (0x0111): the boundary itself must query —
        # pins the `< 1.17` comparison direction in real.py
        dev = SimulatedDevice(SimConfig(
            model_id=0x18, firmware=0x0111,
            std_sample_us=500, express_sample_us=250,
        )).start()
        try:
            drv = make_driver(dev)
            assert drv.connect("ignored", 0, True)
            drv.detect_and_init_strategy()
            assert drv.start_motor("", 600)
            assert Cmd.GET_SAMPLERATE in dev.commands
            assert drv._scan_decoder.timing.sample_duration_us == 250.0
            drv.stop_motor()
            drv.disconnect()
        finally:
            dev.stop()

    def test_legacy_samplerate_default_on_old_firmware(self):
        """Firmware < 1.17 predates GET_SAMPLERATE: the command must not be
        sent and timing falls back to the 476 us table value."""
        from rplidar_ros2_driver_tpu_torch.protocol.constants import Cmd
        from rplidar_ros2_driver_tpu_torch.protocol.timing import LEGACY_SAMPLE_DURATION_US

        dev = SimulatedDevice(SimConfig(
            model_id=0x18, firmware=0x0105, std_sample_us=500,
        )).start()
        try:
            drv = make_driver(dev)
            assert drv.connect("ignored", 0, True)
            drv.detect_and_init_strategy()
            assert drv.start_motor("", 600)
            assert Cmd.GET_SAMPLERATE not in dev.commands
            assert drv._scan_decoder.timing.sample_duration_us == (
                LEGACY_SAMPLE_DURATION_US
            )
            drv.stop_motor()
            drv.disconnect()
        finally:
            dev.stop()


class TestScanStreaming:
    def _grab_scans(self, drv, n=2, timeout=3.0):
        scans = []
        deadline = time.monotonic() + 10
        while len(scans) < n and time.monotonic() < deadline:
            b = drv.grab_scan_data(timeout)
            if b is not None:
                scans.append(b)
        return scans

    def test_denseboost_auto_selection_and_scan(self, sim):
        drv = make_driver(sim)
        assert drv.connect("ignored", 0, False)
        drv.detect_and_init_strategy()
        assert drv.start_motor("", 720)
        assert drv.profile.active_mode == "DenseBoost"
        assert sim.motor_rpm == 720
        scans = self._grab_scans(drv, 2)
        assert len(scans) == 2
        batch = scans[-1]
        count = int(batch.count)
        # 400 points per simulated revolution (exact: frame-aligned assembly)
        assert 320 <= count <= 440
        dist_m = np.asarray(batch.dist_q2)[:count] / 4000.0
        assert dist_m.min() > 1.2 and dist_m.max() < 2.8  # 2m +/- 0.5m scene
        drv.stop_motor()
        drv.disconnect()

    def test_user_mode_preference(self, sim):
        drv = make_driver(sim)
        assert drv.connect("ignored", 0, False)
        drv.detect_and_init_strategy()
        assert drv.start_motor("Sensitivity", 0)
        assert drv.profile.active_mode == "Sensitivity"
        scans = self._grab_scans(drv, 1)
        assert scans and int(scans[0].count) > 100
        drv.stop_motor()
        drv.disconnect()

    def test_unknown_mode_falls_back(self, sim):
        drv = make_driver(sim)
        assert drv.connect("ignored", 0, False)
        drv.detect_and_init_strategy()
        assert drv.start_motor("NoSuchMode", 0)
        assert drv.profile.active_mode == "DenseBoost"
        drv.stop_motor()
        drv.disconnect()

    def test_legacy_scan_path(self):
        """A pre-conf A1M8 starts via the typical-mode EXPRESS fallback:
        capsule stream, working_mode 0 on the wire, zero conf queries
        (the reference wrapper's startScan(0, 1) through getTypicalScanMode
        sl_lidar_driver.cpp:577-580)."""
        from rplidar_ros2_driver_tpu_torch.protocol.constants import Ans, Cmd

        dev = SimulatedDevice(SimConfig(model_id=0x18, points_per_rev=80)).start()
        try:
            drv = make_driver(dev)
            assert drv.connect("ignored", 0, False)
            drv.detect_and_init_strategy()
            assert not drv.conf_supported
            assert drv.start_motor("", 0)
            assert drv.profile.active_mode == "Express"
            # start_motor is fire-and-forget on the wire (send_only, like
            # the reference): poll until the sim's rx thread has observed
            # the EXPRESS_SCAN rather than racing it (load-flaky otherwise)
            assert wait_for(
                lambda: dev.active_ans_type == Ans.MEASUREMENT_CAPSULED, 10.0
            ), dev.active_ans_type
            # the wrapper profile keeps the A-series 12 m limit; 16 m is
            # SDK mode metadata only
            assert drv.get_hw_max_distance() == 12.0
            scans = self._grab_scans(drv, 1)
            assert scans and 40 <= int(scans[0].count) <= 90
            assert Cmd.GET_LIDAR_CONF not in dev.commands
            drv.stop_motor()
            drv.disconnect()
        finally:
            dev.stop()

    def test_conf_capable_old_triangle_uses_typical_mode(self):
        """An A-series unit with firmware >= 1.24 speaks the conf protocol:
        OLD_TYPE startup resolves the typical mode via conf and starts the
        express stream for it (startScan(0,1) -> getTypicalScanMode conf
        branch, sl_lidar_driver.cpp:562-575)."""
        from rplidar_ros2_driver_tpu_torch.protocol.constants import Cmd

        dev = SimulatedDevice(SimConfig(
            model_id=0x18, firmware=(0x1 << 8) | 24,
        )).start()
        try:
            drv = make_driver(dev)
            assert drv.connect("ignored", 0, True)
            drv.detect_and_init_strategy()
            assert not drv.is_new_type()
            assert drv.conf_supported
            assert drv.start_motor("", 0)
            # the sim's typical mode is DenseBoost
            assert drv.profile.active_mode == "DenseBoost"
            assert Cmd.GET_LIDAR_CONF in dev.commands
            drv.stop_motor()
            drv.disconnect()
        finally:
            dev.stop()

    def test_angle_compensation_sorts_angles(self, sim):
        drv = make_driver(sim)
        assert drv.connect("ignored", 0, True)  # compensation on
        drv.detect_and_init_strategy()
        assert drv.start_motor("", 0)
        scans = self._grab_scans(drv, 2)
        assert scans
        b = scans[-1]
        c = int(b.count)
        ang = np.asarray(b.angle_q14)[:c]
        # ascend_scan interpolates invalid + returns monotone-ish angles
        assert (np.diff(ang.astype(np.int64)) >= 0).mean() > 0.95
        drv.stop_motor()
        drv.disconnect()


class TestHotUnplug:
    def test_unplug_detected_and_grab_fails(self, sim):
        drv = make_driver(sim)
        assert drv.connect("ignored", 0, False)
        drv.detect_and_init_strategy()
        assert drv.start_motor("", 0)
        assert drv.grab_scan_data(3.0) is not None
        sim.unplug()
        assert _wait(lambda: not drv.is_connected(), timeout=5.0)
        assert drv.grab_scan_data(0.3) is None
        drv.disconnect()

    def test_fsm_recovers_after_unplug(self, sim):
        """Full node stack over the simulated device: hot-unplug mid-scan,
        FSM resets, reconnects to the (re-listening) device, scans resume —
        the automated version of the reference's unplug protocol."""
        from rplidar_ros2_driver_tpu_torch.node.fsm import FsmTimings
        from rplidar_ros2_driver_tpu_torch.node.node import RPlidarNode, launch
        from rplidar_ros2_driver_tpu_torch.node.publisher import CollectingPublisher

        params = DriverParams(channel_type="tcp", max_retries=2, filter_backend="cpu")
        pub = CollectingPublisher()
        node = RPlidarNode(
            params,
            pub,
            driver_factory=lambda: make_driver(sim),
            fsm_timings=FsmTimings.fast(),
        )
        launch(node)
        assert _wait(lambda: pub.scan_count >= 2, timeout=10.0)
        sim.unplug()
        assert _wait(lambda: node.fsm.reset_count >= 1, timeout=10.0)
        before = pub.scan_count
        assert _wait(lambda: pub.scan_count > before + 1, timeout=10.0)
        node.shutdown()


class TestSerialTransportE2E:
    """Full protocol over a pty: the driver's SERIAL channel (termios2)
    against the emulator — devinfo, mode start, streaming, hot-unplug."""

    def test_serial_connect_stream_unplug(self):
        from rplidar_ros2_driver_tpu_torch.driver.real import RealLidarDriver
        from rplidar_ros2_driver_tpu_torch.driver.sim_device import SerialSimulatedDevice

        sim = SerialSimulatedDevice().start()
        try:
            drv = RealLidarDriver(channel_type="serial", motor_warmup_s=0.0)
            assert drv.connect(sim.port_path, 115200, True)
            drv.detect_and_init_strategy()
            assert drv.start_motor("", 600)
            got = None
            deadline = time.monotonic() + 15
            while got is None and time.monotonic() < deadline:
                got = drv.grab_scan_host(2.0)
            assert got is not None
            scan, ts0, dur = got
            assert len(scan["angle_q14"]) > 0
            assert dur > 0
            # serial link: timing desc carries the device model's NATIVE
            # baud for back-dating (sl_lidar_driver.cpp:1540 — not the
            # negotiated link baud); the sim's S2 model id maps to 1 Mbaud
            assert drv._scan_decoder.timing.is_serial
            assert drv._scan_decoder.timing.native_baudrate == 1_000_000
            sim.unplug()  # EIO on the slave, like a yanked USB adapter
            t0 = time.monotonic()
            while drv.grab_scan_host(0.5) is not None:
                assert time.monotonic() - t0 < 10
            drv.disconnect()
        finally:
            sim.stop()


class TestUdpTransportE2E:
    """Full protocol over UDP datagrams through the native UDP channel."""

    def test_udp_connect_stream_silence(self):
        from rplidar_ros2_driver_tpu_torch.driver.real import RealLidarDriver
        from rplidar_ros2_driver_tpu_torch.driver.sim_device import UdpSimulatedDevice

        sim = UdpSimulatedDevice().start()
        try:
            drv = RealLidarDriver(
                channel_type="udp", udp_host="127.0.0.1", udp_port=sim.port,
                motor_warmup_s=0.0,
            )
            assert drv.connect("udp", 0, True)
            drv.detect_and_init_strategy()
            assert drv.start_motor("", 600)
            got = None
            deadline = time.monotonic() + 15
            while got is None and time.monotonic() < deadline:
                got = drv.grab_scan_host(2.0)
            assert got is not None
            assert len(got[0]["angle_q14"]) > 0
            assert not drv._scan_decoder.timing.is_serial
            sim.unplug()  # radio dies: silence, grabs must time out
            t0 = time.monotonic()
            while drv.grab_scan_host(0.5) is not None:
                assert time.monotonic() - t0 < 10
            drv.disconnect()
        finally:
            sim.stop()

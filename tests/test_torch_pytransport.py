"""The PyTorch package's mirror of tests/test_pytransport.py.

Pure-Python transport fallback (protocol/pytransport.py).

The same end-to-end drives test_real_driver.py runs over the native C++
transport, run over PyChannel/PyTransceiver instead: the fallback must be
behaviorally identical (connect, mode start, streaming, hot-unplug), not
just importable.
"""

import time
from unittest import mock


from rplidar_ros2_driver_tpu_torch.driver.real import RealLidarDriver
from rplidar_ros2_driver_tpu_torch.driver.sim_device import (
    SerialSimulatedDevice,
    SimulatedDevice,
)
from rplidar_ros2_driver_tpu_torch.protocol.pytransport import PyChannel, PyTransceiver
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)


def _py_factory(channel_type, port, baudrate, host, net_port):
    if channel_type == "serial":
        ch = PyChannel("serial", port, baud=baudrate)
    elif channel_type == "tcp":
        ch = PyChannel("tcp", host, port=net_port)
    else:
        ch = PyChannel("udp", host, port=net_port)
    return PyTransceiver(ch)


class TestPyTcp:
    def test_connect_stream_unplug(self):
        sim = SimulatedDevice().start()
        try:
            drv = RealLidarDriver(
                channel_type="tcp", tcp_host="127.0.0.1", tcp_port=sim.port,
                motor_warmup_s=0.0, transceiver_factory=_py_factory,
            )
            assert drv.connect("sim", 0, False)
            assert drv.device_info is not None
            drv.detect_and_init_strategy()
            assert drv.start_motor("DenseBoost", 600)
            got = None
            deadline = time.monotonic() + 15
            while got is None and time.monotonic() < deadline:
                got = drv.grab_scan_host(2.0)
            assert got is not None
            scan, ts0, dur = got
            assert len(scan["angle_q14"]) > 100
            assert dur > 0
            # hot-unplug: the rx thread must surface the dead link
            sim.unplug()
            t0 = time.monotonic()
            while drv.grab_scan_host(0.5) is not None:
                assert time.monotonic() - t0 < 10
            assert not drv._engine.healthy
            drv.disconnect()
        finally:
            sim.stop()

    def test_conf_protocol_round_trips(self):
        """Request/response (non-loop) answers flow through the same
        decoder: health + scan-mode enumeration over the fallback."""
        sim = SimulatedDevice().start()
        try:
            drv = RealLidarDriver(
                channel_type="tcp", tcp_host="127.0.0.1", tcp_port=sim.port,
                motor_warmup_s=0.0, transceiver_factory=_py_factory,
            )
            assert drv.connect("sim", 0, False)
            assert drv.get_health() is not None
            drv.detect_and_init_strategy()
            assert drv.start_motor("DenseBoost", 600)
            assert any(m.name == "DenseBoost" for m in drv.scan_modes)
            drv.stop_motor()
            drv.disconnect()
        finally:
            sim.stop()


class TestPySerial:
    def test_serial_pty_stream(self):
        """termios2 BOTHER + raw-8N1 against the pty emulator."""
        sim = SerialSimulatedDevice().start()
        try:
            drv = RealLidarDriver(
                channel_type="serial", motor_warmup_s=0.0,
                transceiver_factory=_py_factory,
            )
            assert drv.connect(sim.port_path, 115200, True)
            drv.detect_and_init_strategy()
            assert drv.start_motor("", 600)
            got = None
            deadline = time.monotonic() + 15
            while got is None and time.monotonic() < deadline:
                got = drv.grab_scan_host(2.0)
            assert got is not None
            assert len(got[0]["angle_q14"]) > 0
            sim.unplug()
            t0 = time.monotonic()
            while drv.grab_scan_host(0.5) is not None:
                assert time.monotonic() - t0 < 10
            drv.disconnect()
        finally:
            sim.stop()


class TestPyUdp:
    def test_udp_connect_stream_silence(self):
        """Connected-pair UDP datagrams through the Python channel; an
        unplugged radio is silence (datagrams just stop), not an error."""
        from rplidar_ros2_driver_tpu_torch.driver.sim_device import UdpSimulatedDevice

        sim = UdpSimulatedDevice().start()
        try:
            drv = RealLidarDriver(
                channel_type="udp", udp_host="127.0.0.1", udp_port=sim.port,
                motor_warmup_s=0.0, transceiver_factory=_py_factory,
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
            sim.unplug()
            t0 = time.monotonic()
            while drv.grab_scan_host(0.5) is not None:
                assert time.monotonic() - t0 < 10
            drv.disconnect()
        finally:
            sim.stop()


class TestFallbackSelection:
    def test_factory_falls_back_when_native_unavailable(self):
        """_default_transceiver_factory must hand out the Python transport
        when the native library cannot load (and only then)."""
        from rplidar_ros2_driver_tpu_torch.driver.real import _default_transceiver_factory
        from rplidar_ros2_driver_tpu_torch.native import NativeUnavailable

        with mock.patch(
            "rplidar_ros2_driver_tpu_torch.native.runtime.load",
            side_effect=NativeUnavailable("forced by test"),
        ):
            tx = _default_transceiver_factory("tcp", "", 0, "127.0.0.1", 1)
            assert isinstance(tx, PyTransceiver)

    def test_channel_errors_are_the_engines_class(self):
        """The pump catches native.runtime.ChannelError; the fallback must
        raise exactly that class."""
        from rplidar_ros2_driver_tpu_torch.native.runtime import ChannelError
        from rplidar_ros2_driver_tpu_torch.protocol import pytransport

        assert pytransport.ChannelError is ChannelError

    def test_cancel_unblocks_parked_reader(self):
        """close/cancel must unblock a reader parked in select (self-pipe)."""
        import socket as socketmod
        import threading

        srv = socketmod.socket()
        srv.bind(("127.0.0.1", 0))
        srv.listen(1)
        ch = PyChannel("tcp", "127.0.0.1", port=srv.getsockname()[1])
        assert ch.open()
        srv.accept()
        out = {}

        def reader():
            out["r"] = ch.read(64, timeout_ms=10_000)

        t = threading.Thread(target=reader)
        t.start()
        time.sleep(0.2)
        ch.cancel()
        t.join(2.0)
        assert not t.is_alive()
        assert out["r"] == b""
        ch.close()
        srv.close()

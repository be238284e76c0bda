"""The PyTorch package's mirror of tests/test_motor_and_conf.py.

Motor-control strategy, motor info, MAC/IP conf, and autobaud negotiation.

Covers the 3-way motor dispatch (checkMotorCtrlSupport / setMotorSpeed,
sl_lidar_driver.cpp:833-878, 968-1021), getMotorInfo (:1023-1056), the
MAC / static-IP conf keys (:887-955), and negotiateSerialBaudRate
(:1058-1155) against a raw fake serial channel.
"""

import struct
import time

import pytest

from rplidar_ros2_driver_tpu_torch import native as native_mod
from rplidar_ros2_driver_tpu_torch.driver.real import RealLidarDriver
from rplidar_ros2_driver_tpu_torch.driver.sim_device import SimConfig, SimulatedDevice
from rplidar_ros2_driver_tpu_torch.models.tables import MotorCtrlSupport
from rplidar_ros2_driver_tpu_torch.protocol.conf import IpConf
from rplidar_ros2_driver_tpu_torch.protocol.constants import (
    AUTOBAUD_MAGICBYTE,
    Cmd,
)
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

pytestmark = pytest.mark.skipif(
    not native_mod.available(), reason="native library unavailable"
)


def make_driver(sim: SimulatedDevice) -> RealLidarDriver:
    return RealLidarDriver(
        channel_type="tcp",
        tcp_host=SimulatedDevice.TARGET,
        tcp_port=sim.port,
        motor_warmup_s=0.0,
        legacy_warmup_s=0.0,
    )


def connected(cfg=None):
    dev = SimulatedDevice(cfg or SimConfig()).start()
    drv = make_driver(dev)
    assert drv.connect("ignored", 0, True)
    return dev, drv


class TestMotorCtrlSupport:
    def test_s_series_builtin_rpm(self):
        dev, drv = connected(SimConfig(model_id=0x71))  # major 7 >= 6
        try:
            assert drv.motor_ctrl is MotorCtrlSupport.RPM
        finally:
            drv.disconnect(); dev.stop()

    def test_a2_with_acc_board_is_pwm(self):
        dev, drv = connected(SimConfig(model_id=0x28, acc_board_pwm=True))
        try:
            assert drv.motor_ctrl is MotorCtrlSupport.PWM
            assert drv.set_motor_speed(660)
            time.sleep(0.2)
            assert Cmd.SET_MOTOR_PWM in dev.commands
        finally:
            drv.disconnect(); dev.stop()

    def test_a2_without_acc_board_is_none(self):
        dev, drv = connected(SimConfig(model_id=0x28, acc_board_pwm=False))
        try:
            assert drv.motor_ctrl is MotorCtrlSupport.NONE
        finally:
            drv.disconnect(); dev.stop()

    def test_a1_is_none_without_probe(self):
        dev, drv = connected(SimConfig(model_id=0x18))  # major 1 < 2
        try:
            assert drv.motor_ctrl is MotorCtrlSupport.NONE
            # the acc-board probe must not even be sent for major id < 2
            assert Cmd.GET_ACC_BOARD_FLAG not in dev.commands
        finally:
            drv.disconnect(); dev.stop()

    def test_default_speed_queries_desired(self):
        dev, drv = connected(SimConfig(model_id=0x71, desired_rpm=720))
        try:
            assert drv.set_motor_speed(None)
            assert _wait(lambda: dev.motor_rpm == 720)
        finally:
            drv.disconnect(); dev.stop()


class TestConfSupportGate:
    """checkSupportConfigCommands semantics (sl_lidar_driver.cpp:1176-1196):
    a device whose firmware predates the conf protocol must never be sent
    a GET/SET_LIDAR_CONF query — each one would silently time out."""

    def test_pre_conf_device_never_queried(self):
        # A2 with acc-board PWM: the PWM motor path would otherwise fetch
        # DESIRED_ROT_FREQ on set_motor_speed(None)
        dev, drv = connected(SimConfig(
            model_id=0x28, firmware=0x0117, acc_board_pwm=True,
        ))
        try:
            assert not drv.conf_supported
            assert drv.get_motor_info() is None
            assert drv.get_mac_addr() is None
            assert drv.get_ip_conf() is None
            assert not drv.set_ip_conf(IpConf(
                (192, 168, 0, 7), (255, 255, 255, 0), (192, 168, 0, 1)
            ))
            assert drv.set_motor_speed(None)  # falls back to 600 default
            assert _wait(lambda: dev.motor_rpm == 600)
            assert Cmd.GET_LIDAR_CONF not in dev.commands
            assert Cmd.SET_LIDAR_CONF not in dev.commands
        finally:
            drv.disconnect(); dev.stop()

    def test_firmware_1_24_boundary_enables_conf(self):
        # exactly 1.24 on a triangle unit: the boundary itself qualifies —
        # pins the `>=` comparison direction
        dev, drv = connected(SimConfig(
            model_id=0x28, firmware=(0x1 << 8) | 24, acc_board_pwm=True,
        ))
        try:
            assert drv.conf_supported
            info = drv.get_motor_info()
            assert info is not None and info.max_speed == 1200
        finally:
            drv.disconnect(); dev.stop()


def _wait(pred, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return False


class TestMotorInfoAndNetworkConf:
    def test_get_motor_info(self):
        dev, drv = connected(SimConfig(min_rpm=180, max_rpm=1100, desired_rpm=650))
        try:
            info = drv.get_motor_info()
            assert info is not None
            assert (info.min_speed, info.max_speed, info.desired_speed) == (180, 1100, 650)
        finally:
            drv.disconnect(); dev.stop()

    def test_mac_addr(self):
        dev, drv = connected()
        try:
            assert drv.get_mac_addr() == b"\xaa\xbb\xcc\xdd\xee\xff"
        finally:
            drv.disconnect(); dev.stop()

    def test_ip_conf_roundtrip(self):
        dev, drv = connected()
        try:
            conf = drv.get_ip_conf()
            assert conf is not None and conf.ip == (192, 168, 11, 2)
            new = IpConf((10, 0, 0, 5), (255, 255, 0, 0), (10, 0, 0, 1))
            assert drv.set_ip_conf(new)
            assert drv.get_ip_conf() == new
        finally:
            drv.disconnect(); dev.stop()


# ---------------------------------------------------------------------------
# autobaud against a fake raw serial channel
# ---------------------------------------------------------------------------


class FakeSerialChannel:
    """Raw-channel fake emulating device-side baud measurement firmware."""

    kind = "serial"

    def __init__(self, detected_baud=460800, magic_threshold=32):
        self.detected_baud = detected_baud
        self.magic_threshold = magic_threshold
        self._magic_seen = 0
        self._reply = b""
        self.opened = False
        self.writes = []

    def open(self):
        self.opened = True
        return True

    def close(self):
        self.opened = False

    def write(self, data: bytes) -> int:
        self.writes.append(bytes(data))
        n_magic = sum(1 for b in data if b == AUTOBAUD_MAGICBYTE)
        self._magic_seen += n_magic
        if self._magic_seen >= self.magic_threshold and not self._reply:
            self._reply = struct.pack("<I", self.detected_baud)
        return len(data)

    def read(self, max_bytes: int, timeout_ms: int = 0):
        if not self._reply:
            return None  # timeout
        out, self._reply = self._reply[:max_bytes], self._reply[max_bytes:]
        return out

    def set_dtr(self, level):
        return True


from conftest import ScriptedTransceiver as FakeTransceiver  # noqa: E402


def test_autobaud_negotiation_flow():
    ch = FakeSerialChannel(detected_baud=256000)
    tx = FakeTransceiver(ch)
    drv = RealLidarDriver(transceiver_factory=lambda *a, **k: tx)
    # hand-wire a started engine (connect() would need a devinfo answer)
    from rplidar_ros2_driver_tpu_torch.protocol.engine import CommandEngine

    drv._engine = CommandEngine(tx)
    assert drv._engine.start()
    drv._connected = True

    detected = drv.negotiate_serial_baud(256000)
    assert detected == 256000
    # confirmation packet went out with flag 0x5F5F + required bps
    confirm = [p for p in tx.sent if len(p) > 2 and p[1] == Cmd.NEW_BAUDRATE_CONFIRM]
    assert confirm, f"no NEW_BAUDRATE_CONFIRM among {tx.sent!r}"
    payload = confirm[-1][3:-1]  # strip A5 cmd size ... checksum
    flag, bps, _ = struct.unpack("<HIH", payload)
    assert flag == 0x5F5F and bps == 256000
    # transceiver restarted after raw-mode negotiation
    assert tx.running
    drv._engine.stop()


def test_autobaud_mismatch_not_confirmed():
    """A detected rate != required must NOT be confirmed: confirming would
    switch the device's UART away from the link the host keeps using."""
    ch = FakeSerialChannel(detected_baud=115200)
    tx = FakeTransceiver(ch)
    drv = RealLidarDriver(transceiver_factory=lambda *a, **k: tx)
    from rplidar_ros2_driver_tpu_torch.protocol.engine import CommandEngine

    drv._engine = CommandEngine(tx)
    assert drv._engine.start()
    drv._connected = True

    detected = drv.negotiate_serial_baud(256000)
    assert detected == 115200  # measurement still reported to the caller
    confirm = [p for p in tx.sent if len(p) > 2 and p[1] == Cmd.NEW_BAUDRATE_CONFIRM]
    assert not confirm, "mismatched baud must not be confirmed"
    assert tx.running
    drv._engine.stop()


def test_autobaud_rejected_on_non_serial():
    class TcpChannel(FakeSerialChannel):
        kind = "tcp"

    tx = FakeTransceiver(TcpChannel())
    drv = RealLidarDriver(transceiver_factory=lambda *a, **k: tx)
    from rplidar_ros2_driver_tpu_torch.protocol.engine import CommandEngine

    drv._engine = CommandEngine(tx)
    assert drv._engine.start()
    drv._connected = True
    assert drv.negotiate_serial_baud(256000) is None
    drv._engine.stop()


def test_supports_conf_commands_boundaries():
    """Table-level pin of the gate the driver tests above exercise
    end-to-end: ND magic starts at major id 4, triangle firmware at
    exactly 1.24 (sl_lidar_driver.cpp:1176-1196, 1467-1470)."""
    from rplidar_ros2_driver_tpu_torch.models.tables import (
        DeviceInfo,
        supports_conf_commands,
    )

    assert supports_conf_commands(DeviceInfo(model=0x40, firmware_version=0))
    assert not supports_conf_commands(DeviceInfo(model=0x3F, firmware_version=0))
    assert supports_conf_commands(
        DeviceInfo(model=0x18, firmware_version=(1 << 8) | 24)
    )
    assert not supports_conf_commands(
        DeviceInfo(model=0x18, firmware_version=(1 << 8) | 23)
    )

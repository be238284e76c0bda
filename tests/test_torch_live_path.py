"""The live wire path of the PyTorch package against the JAX package, on the
CPU: simulator -> native channel -> protocol engine -> RealLidarDriver ->
host or fused ingest -> /scan.

  * both simulators put the same bytes on the wire for the same SimConfig,
    in all six formats (and under one seeded fault program);
  * ``encode_command``, ``ResponseDecoder`` and the conf-protocol parsers
    give the same results in both packages on seeded byte streams;
  * a capture recorded live by the port's driver, replayed through both
    packages' host decode + chain and through both FusedIngest engines,
    gives equal outputs: ranges, intensities, masks and voxel grids exact,
    ``points_xy`` within 2 ulp (ROADMAP C.1), stamps exact on the host
    path and within 1 ulp at their magnitude on the fused one;
  * the node publishes over the live path with ``filter_backend: cpu``,
    host and fused ingest, and what it publishes equals the port's CPU
    replay of its own recording, stamps exact: the host replay runs the
    revolutions the FSM grabbed under the stamps it handed on (a
    revolution read at once lasts 0 s and goes out under the FSM's clock,
    tests/test_torch_live_stamps.py), the fused one the runs the node's
    engine was handed;
  * ``run`` without ``--dummy`` against the port's simulator exits 0 with
    scans published.

Every socket read and wait has its own bound.
"""

from __future__ import annotations

import dataclasses
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from rplidar_ros2_driver_tpu.core.config import DriverParams as JParams
from rplidar_ros2_driver_tpu.driver import assembly as jasm
from rplidar_ros2_driver_tpu.driver import decode as jdec
from rplidar_ros2_driver_tpu.driver import ingest as jdi
from rplidar_ros2_driver_tpu.driver import sim_device as jsim
from rplidar_ros2_driver_tpu.driver.chaos import ChaosConfig as JChaos
from rplidar_ros2_driver_tpu.filters.chain import ScanFilterChain as JChain
from rplidar_ros2_driver_tpu.protocol import codec as jcodec
from rplidar_ros2_driver_tpu.protocol import conf as jconf
from rplidar_ros2_driver_tpu.protocol import timing as jtiming
from rplidar_ros2_driver_tpu_torch import native
from rplidar_ros2_driver_tpu_torch.core.config import DriverParams as TParams
from rplidar_ros2_driver_tpu_torch.driver import assembly as tasm
from rplidar_ros2_driver_tpu_torch.driver import decode as tdec
from rplidar_ros2_driver_tpu_torch.driver import ingest as tdi
from rplidar_ros2_driver_tpu_torch.driver import sim_device as tsim
from rplidar_ros2_driver_tpu_torch.driver.chaos import ChaosConfig as TChaos
from rplidar_ros2_driver_tpu_torch.driver.dummy import DummyLidarDriver
from rplidar_ros2_driver_tpu_torch.driver.real import RealLidarDriver
from rplidar_ros2_driver_tpu_torch.filters.chain import DEFAULT_BEAMS
from rplidar_ros2_driver_tpu_torch.filters.chain import ScanFilterChain as TChain
from rplidar_ros2_driver_tpu_torch.node.fsm import FsmTimings
from rplidar_ros2_driver_tpu_torch.node.node import RPlidarNode, launch
from rplidar_ros2_driver_tpu_torch.node.publisher import CollectingPublisher
from rplidar_ros2_driver_tpu_torch.protocol import codec as tcodec
from rplidar_ros2_driver_tpu_torch.protocol import conf as tconf
from rplidar_ros2_driver_tpu_torch.protocol import timing as ttiming
from rplidar_ros2_driver_tpu_torch.protocol.constants import Ans, Cmd, ConfKey
from rplidar_ros2_driver_tpu_torch.replay import read_frames

from conftest import wait_for
from test_torch_fused_ingest import _assert_output_equal, _stamps_close
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

pytestmark = pytest.mark.skipif(not native.available(), reason="native library unavailable")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DENSE = int(Ans.MEASUREMENT_DENSE_CAPSULED)
BEAMS = 256
PPR = 800          # points per revolution of the recorded stream
RUN = 8            # frames per replayed run (< one revolution's 20 frames)
SOCK_TIMEOUT_S = 5.0

def _params(pkg, **over):
    base = dict(filter_backend="cpu", filter_chain=("clip", "median", "voxel"),
                filter_window=8, voxel_grid_size=32, median_backend="xla")
    base.update(over)
    return (JParams if pkg == "jax" else TParams)(**base)

# ---------------------------------------------------------------------------
# the simulators' wire bytes
# ---------------------------------------------------------------------------

# (mode name, scan command, EXPRESS_SCAN mode id) for each wire format
_FORMATS = [
    ("Standard", Cmd.SCAN, None),
    ("DenseBoost", Cmd.EXPRESS_SCAN, 1),
    ("Sensitivity", Cmd.EXPRESS_SCAN, 2),
    ("UltraBoost", Cmd.EXPRESS_SCAN, 3),
    ("UltraDense", Cmd.EXPRESS_SCAN, 4),
    ("HQ", Cmd.EXPRESS_SCAN, 5),
]

def _read_stream(sim_mod, cfg, cmd, mode_id, nbytes: int) -> bytes:
    """The first ``nbytes`` the simulator sends after one scan command on a
    raw TCP connection."""
    sim = sim_mod.SimulatedDevice(cfg).start()
    try:
        with socket.create_connection(("127.0.0.1", sim.port), timeout=SOCK_TIMEOUT_S) as s:
            s.settimeout(SOCK_TIMEOUT_S)
            payload = b"" if mode_id is None else bytes([mode_id, 0, 0, 0, 0])
            s.sendall(tcodec.encode_command(int(cmd), payload))
            got = bytearray()
            deadline = time.monotonic() + 20.0
            while len(got) < nbytes and time.monotonic() < deadline:
                chunk = s.recv(nbytes - len(got))
                if not chunk:
                    break
                got += chunk
            return bytes(got)
    finally:
        sim.stop()

@pytest.mark.parametrize("mode,cmd,mode_id", _FORMATS, ids=[f[0] for f in _FORMATS])
def test_simulators_put_the_same_bytes_on_the_wire(mode, cmd, mode_id):
    """Header + 60 frames of each format: byte-equal between packages."""
    ans = next(m.ans_type for m in tsim.DEFAULT_MODES if m.name == mode)
    frame_bytes, _ = tsim.SimulatedDevice.STREAMABLE[ans]
    nbytes = 7 + 60 * frame_bytes
    want = _read_stream(jsim, jsim.SimConfig(points_per_rev=400), cmd, mode_id, nbytes)
    got = _read_stream(tsim, tsim.SimConfig(points_per_rev=400), cmd, mode_id, nbytes)
    assert len(want) == nbytes
    assert got == want

def test_simulators_apply_the_same_fault_program():
    """A seeded corrupt/truncate program on the dense stream: the same
    damaged bytes from both packages' firmware."""
    chaos = dict(seed=7, start_frame=5, corrupt_rate=0.4, truncate_rate=0.3)
    frame_bytes, _ = tsim.SimulatedDevice.STREAMABLE[DENSE]
    nbytes = 7 + 80 * frame_bytes // 2
    want = _read_stream(jsim, jsim.SimConfig(chaos=JChaos(**chaos)), Cmd.EXPRESS_SCAN, 1, nbytes)
    got = _read_stream(tsim, tsim.SimConfig(chaos=TChaos(**chaos)), Cmd.EXPRESS_SCAN, 1, nbytes)
    assert len(want) == nbytes
    assert got == want

# ---------------------------------------------------------------------------
# codec and conf parsing on seeded byte streams
# ---------------------------------------------------------------------------

def _encoded(codec, cmd: int, payload: bytes):
    try:
        return codec.encode_command(cmd, payload)
    except ValueError as e:
        return ("ValueError", str(e))

def test_encode_command_matches_jax():
    """Seeded commands and payloads (a payload on a command without the
    payload flag, and one over 255 bytes, refused alike)."""
    rng = np.random.default_rng(0)
    for _ in range(300):
        cmd = int(rng.integers(0, 256))
        n = int(rng.choice([0, int(rng.integers(1, 40)), 256]))
        payload = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert _encoded(tcodec, cmd, payload) == _encoded(jcodec, cmd, payload)

def _seeded_answer_stream(seed: int) -> bytes:
    """Answers of every framing (single, loop, long payloads) with garbage
    and torn headers between them."""
    rng = np.random.default_rng(seed)
    out = bytearray()
    for _ in range(60):
        r = rng.random()
        if r < 0.15:
            out += rng.integers(0, 256, int(rng.integers(1, 12)), dtype=np.uint8).tobytes()
            continue
        if r < 0.2:
            out += b"\xa5\x5a"  # a torn header
            continue
        n = int(rng.integers(0, 90))
        hdr = tcodec.AnsHeader(ans_type=int(rng.integers(0, 256)), payload_len=n,
                               is_loop=bool(rng.random() < 0.3))
        out += hdr.encode() + rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    return bytes(out)

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_response_decoder_matches_jax(seed):
    """The same byte stream fed in the same seeded chunks: the same
    messages, in order, from both packages' decoders."""
    data = _seeded_answer_stream(seed)
    got, want = [], []
    tdecoder = tcodec.ResponseDecoder(lambda *m: got.append(m))
    jdecoder = jcodec.ResponseDecoder(lambda *m: want.append(m))
    rng = np.random.default_rng(seed + 100)
    pos = 0
    while pos < len(data):
        step = int(rng.integers(1, 64))
        tdecoder.feed(data[pos : pos + step])
        jdecoder.feed(data[pos : pos + step])
        pos += step
    assert got == want and len(want) > 10

class _SeededConfEngine:
    """Answers each conf request with bytes derived from the request alone
    (so both packages see the same answer): usually the echoed key and a
    seeded tail, sometimes a wrong key, a short answer or silence."""

    def __init__(self, seed: int) -> None:
        self.seed = seed

    def request(self, cmd, ans, payload=b"", timeout_s=1.0):
        rng = np.random.default_rng([self.seed, int(cmd), *payload])
        r = rng.random()
        if r < 0.05:
            return None
        if r < 0.1:
            return bytes(rng.integers(0, 256, int(rng.integers(0, 4)), dtype=np.uint8))
        key = payload[:4] if r < 0.95 else bytes(rng.integers(0, 256, 4, dtype=np.uint8))
        tail = rng.integers(0, 256, int(rng.integers(0, 24)), dtype=np.uint8)
        if rng.random() < 0.3:
            tail[: min(3, tail.size)] = [ord(c) for c in "Den"[: min(3, tail.size)]]
        if payload[:4] == int(ConfKey.SCAN_MODE_COUNT).to_bytes(4, "little"):
            tail = np.array([int(rng.integers(1, 6)), 0], np.uint8)  # a small mode count
        return bytes(key) + tail.tobytes()

def _as_tuple(v):
    if v is None or isinstance(v, (int, float, bytes, str, tuple, bool)):
        return v
    if isinstance(v, list):
        return [_as_tuple(x) for x in v]
    return tuple((f.name, getattr(v, f.name)) for f in dataclasses.fields(v))

@pytest.mark.parametrize("seed", range(6))
def test_conf_parsing_matches_jax(seed):
    eng = _SeededConfEngine(seed)
    for fn in ("enumerate_scan_modes", "get_typical_mode", "get_scan_mode_count",
               "get_desired_speed", "get_mac_addr", "get_ip_conf"):
        got = getattr(tconf, fn)(eng)
        want = getattr(jconf, fn)(eng)
        assert _as_tuple(got) == _as_tuple(want), fn
    for pwm in (False, True):
        assert _as_tuple(tconf.get_motor_info(eng, pwm_ctrl=pwm)) == _as_tuple(
            jconf.get_motor_info(eng, pwm_ctrl=pwm))
    ip = tconf.IpConf((10, 0, 0, seed), (255, 255, 255, 0), (10, 0, 0, 1))
    jip = jconf.IpConf(ip.ip, ip.netmask, ip.gateway)
    assert tconf.set_ip_conf(eng, ip) == jconf.set_ip_conf(eng, jip)
    assert ip.to_payload() == jip.to_payload()

# ---------------------------------------------------------------------------
# a live-recorded capture through both packages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def live_capture(tmp_path_factory):
    """~16 revolutions of DenseBoost (800 points a turn) streamed by the
    port's simulator to the port's RealLidarDriver and recorded with
    ``start_recording``; returns (path, the live TimingDesc's fields)."""
    path = str(tmp_path_factory.mktemp("live") / "live.rplr")
    sim = tsim.SimulatedDevice(tsim.SimConfig(points_per_rev=PPR)).start()
    drv = RealLidarDriver(channel_type="tcp", tcp_host="127.0.0.1", tcp_port=sim.port,
                          motor_warmup_s=0.0)
    try:
        assert drv.connect("sim", 0, False)
        drv.detect_and_init_strategy()
        drv.start_recording(path)
        assert drv.start_motor("DenseBoost", 600)
        assert wait_for(lambda: drv._scan_decoder.recorder.frames >= 340, 20.0)
        timing = dataclasses.asdict(drv._scan_decoder.timing)
        frames = drv.stop_recording()
        drv.stop_motor()
    finally:
        drv.disconnect()
        sim.stop()
    assert frames >= 340
    return path, timing

def _runs(path: str):
    """The capture's measurement frames in runs of RUN, as the engine's pump
    would deliver them."""
    items = [(payload, ts) for ans, ts, payload in read_frames(path) if ans == DENSE]
    return [items[i : i + RUN] for i in range(0, len(items), RUN)]

def _host_replay(pkg: str, path: str, timing: dict, beams: int = BEAMS, tap=None):
    """Host decode + chain of one package over the capture: every
    revolution's (FilterOutput, ts0, duration), in order.  With a node's
    ``tap`` (:class:`_NodeTap`) the chain runs what the node ran: the
    revolutions the FSM grabbed, in its order, each as (FilterOutput, the
    stamp the FSM handed on, duration)."""
    asm_mod, dec_mod, tim_mod = (jasm, jdec, jtiming) if pkg == "jax" else (tasm, tdec, ttiming)
    revs = []
    dec = dec_mod.BatchScanDecoder(asm_mod.ScanAssembler(on_complete=revs.append))
    dec.timing = tim_mod.TimingDesc(**timing)
    for run in _runs(path):
        dec.on_measurement_batch(DENSE, run)
    picks = [(r, r["ts0"]) for r in revs]
    if tap is not None:
        picks = []
        for k, ts0, duration, stamp in tap.grabs:
            r = revs[k] if 0 <= k < len(revs) else None
            assert r is not None and (r["ts0"], r["duration"]) == (ts0, duration), (
                f"grabbed revolution {k} (ts0 {ts0}, duration {duration}) is not the "
                f"replay's: {len(revs)} replayed, decoder resets at {tap.resets} "
                f"(frames recorded, grabs), {tap.restamped} restamped")
            # the FSM's clock fallback (node/fsm.py): a revolution goes out
            # under another stamp than its ts0 only when it lasted <= 0 s
            assert stamp == ts0 or r["duration"] <= 0, (
                f"revolution {k} (ts0 {ts0}, duration {r['duration']}) handed on at {stamp}, "
                f"{tap.restamped} restamped")
            picks.append((r, stamp))
    chain = (JChain if pkg == "jax" else TChain)(_params(pkg), beams=beams)
    return [(chain.process_raw(r["angle_q14"], r["dist_q2"], r["quality"], r["flag"]), stamp,
             r["duration"]) for r, stamp in picks]

def _fused_replay(pkg: str, path: str, timing: dict, beams: int = BEAMS, capacity=2048, **over):
    mod = jdi if pkg == "jax" else tdi
    eng = mod.FusedIngest(_params(pkg, ingest_backend="fused", **over), beams=beams,
                          capacity=capacity, max_revs=2, max_queue=1 << 30, buckets=(RUN,))
    eng.timing = (jtiming if pkg == "jax" else ttiming).TimingDesc(**timing)
    for run in _runs(path):
        eng.on_measurement_batch(DENSE, run)
    return eng.flush()

def _fused_replay_as_fed(path: str, timing: dict, fed: list, beams: int):
    """The port's CPU fused replay of a node's recording, fed in the runs
    the node's engine was handed (``fed``: (answer type, frame count) per
    call) and at its engine's geometry, so every dispatch — and every
    revolution dropped beyond ``max_revs`` inside one — is the node's."""
    eng = tdi.FusedIngest(_params("torch", ingest_backend="fused"), beams=beams,
                          max_queue=1 << 30)
    eng.timing = ttiming.TimingDesc(**timing)
    frames = [(ans, (payload, ts)) for ans, ts, payload in read_frames(path)]
    off = 0
    for ans, n in fed:
        run = frames[off : off + n]
        if len(run) < n:
            break  # handed over after the recording stopped
        assert all(a == ans for a, _f in run)
        eng.on_measurement_batch(ans, [f for _a, f in run])
        off += n
    return eng.flush()

def test_live_capture_host_path_matches_jax(live_capture):
    path, timing = live_capture
    got = _host_replay("torch", path, timing)
    want = _host_replay("jax", path, timing)
    assert len(got) == len(want) >= 14
    for k, ((o, ts0, dur), (j, jts0, jdur)) in enumerate(zip(got, want)):
        _assert_output_equal(j, o, f"rev {k}")
        assert ts0 == jts0 and dur == jdur

@pytest.mark.parametrize("deskew", [False, True], ids=["plain", "deskew"])
def test_live_capture_fused_path_matches_jax(live_capture, deskew):
    path, timing = live_capture
    over = dict(deskew_enable=True, sweep_reconstruct_window=3, deskew_profile_beams=64,
                deskew_shift_window=4) if deskew else {}
    got = _fused_replay("torch", path, timing, **over)
    want = _fused_replay("jax", path, timing, **over)
    assert len(got) == len(want) >= 14
    for k, ((o, ts0, dur), (j, jts0, jdur)) in enumerate(zip(got, want)):
        _assert_output_equal(j, o, f"rev {k}")
        assert _stamps_close([ts0 - got[0][1]], [jts0 - got[0][1]])
        assert abs(dur - jdur) < 1e-6
    if not deskew:
        # without de-skew the fused engine and the host path agree
        host = _host_replay("torch", path, timing)
        for k, ((o, _t, _d), (h, _ht, _hd)) in enumerate(zip(got, host)):
            _assert_output_equal(h, o, f"host rev {k}")

def test_fused_ingest_live_surface(live_capture):
    """collect_pipelined holds back the newest batch, collect_nowait takes
    one, reset_filter starts a cold window, the max_queue drop recycles
    its staging pairs: against a plain flush of the same capture."""
    path, timing = live_capture
    runs = _runs(path)
    ref = _fused_replay("torch", path, timing)
    eng = tdi.FusedIngest(_params("torch", ingest_backend="fused"), beams=BEAMS,
                          capacity=2048, max_revs=2, buckets=(RUN,))
    eng.timing = ttiming.TimingDesc(**timing)
    got = []
    for run in runs:
        eng.on_measurement_batch(DENSE, run)
        got.extend(eng.collect_pipelined())
        assert len(eng._pending) == 1
    assert eng.collect_nowait() is not None and eng.collect_nowait() is None
    assert eng.dispatch_count == len(runs) and eng.dispatch_s > 0
    assert len(got) >= len(ref) - 1
    for (o, ts0, _d), (r, rts0, _rd) in zip(got, ref):
        _assert_output_equal(r, o, "pipelined")
        assert ts0 == rts0
    # reset_filter: the next revolutions run on a cold window, like a
    # fresh engine fed the same frames from the same point
    eng.reset_filter()
    fresh = tdi.FusedIngest(_params("torch", ingest_backend="fused"), beams=BEAMS,
                            capacity=2048, max_revs=2, buckets=(RUN,))
    fresh.timing = eng.timing
    eng.reset()
    for run in runs[:8]:
        eng.on_measurement_batch(DENSE, run)
        fresh.on_measurement_batch(DENSE, run)
    a, b = eng.flush(), fresh.flush()
    assert len(a) == len(b) >= 2
    for (o, _t, _d), (r, _rt, _rd) in zip(a, b):
        _assert_output_equal(r, o, "after reset_filter")
    # a lagging consumer: results dropped past max_queue, their staging
    # pairs recycled at once (three pairs in all: two pending, one free)
    lag = tdi.FusedIngest(_params("torch", ingest_backend="fused"), beams=BEAMS,
                          capacity=2048, max_revs=2, max_queue=2, buckets=(RUN,))
    lag.timing = eng.timing
    for run in runs:
        lag.on_measurement_batch(DENSE, run)
    assert lag.wires_dropped == len(runs) - 2 and not lag._retiring

    def pooled():
        return sum(len(v) for v in lag.staging._free.values())

    assert pooled() == 1
    assert len(lag.flush()) <= 2 and pooled() == 3

def test_fused_ingest_producer_and_consumer_threads(live_capture):
    """The live shape of FusedIngest: a producer thread (the pump) feeds
    the capture while a consumer thread (the FSM) grabs, with a short
    interpreter switch interval: every revolution arrives once, in order,
    equal to a plain flush."""
    path, timing = live_capture
    ref = _fused_replay("torch", path, timing)
    eng = tdi.FusedIngest(_params("torch", ingest_backend="fused"), beams=BEAMS,
                          capacity=2048, max_revs=2, max_queue=1 << 30, buckets=(RUN,))
    eng.timing = ttiming.TimingDesc(**timing)
    got, done = [], threading.Event()

    def produce():
        for run in _runs(path):
            eng.on_measurement_batch(DENSE, run)
        done.set()

    def consume():
        while not (done.is_set() and not eng._pending):
            out = eng.wait_and_grab_outputs(0.05)
            if out:
                got.extend(out)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=f) for f in (produce, consume)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120.0)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert len(got) == len(ref) >= 14
    for (o, ts0, _d), (r, rts0, _rd) in zip(got, ref):
        _assert_output_equal(r, o, "threaded")
        assert ts0 == rts0

# ---------------------------------------------------------------------------
# the node on the live path
# ---------------------------------------------------------------------------

class _NodeTap:
    """What the node did on the live path, recorded as it ran, so that the
    replay does the same: every revolution the driver's assembler completed,
    in order (``completed``, filled by :func:`_recording_driver`); every grab
    the FSM handed to ``_on_scan`` as (its index among those revolutions,
    ts0, duration, the stamp handed on); every reset of the driver's decoder
    as (frames recorded, grabs so far); every run a FusedIngest was handed,
    as (answer type, frames).  A revolution whose frames came in one read
    lasts 0 s, and the FSM hands it on under its grab clock
    (tests/test_torch_live_stamps.py)."""

    def __init__(self, monkeypatch) -> None:
        self.completed, self.grabs, self.resets, self.fed = [], [], [], []
        on_scan, reset = RPlidarNode._on_scan, tdec.BatchScanDecoder.reset
        handed = tdi.FusedIngest.on_measurement_batch

        def tap_on_scan(node, scan, stamp, duration):
            k = next((i for i in range(len(self.completed) - 1, -1, -1)
                      if self.completed[i] is scan), -1)
            self.grabs.append((k, scan["ts0"], scan["duration"], stamp))
            return on_scan(node, scan, stamp, duration)

        def tap_reset(dec):
            rec = dec.recorder
            self.resets.append((None if rec is None else rec.frames, len(self.grabs)))
            return reset(dec)

        def record_run(eng, ans_type, items):
            self.fed.append((ans_type, len(items)))
            return handed(eng, ans_type, items)

        monkeypatch.setattr(RPlidarNode, "_on_scan", tap_on_scan)
        monkeypatch.setattr(tdec.BatchScanDecoder, "reset", tap_reset)
        monkeypatch.setattr(tdi.FusedIngest, "on_measurement_batch", record_run)

    @property
    def restamped(self) -> int:
        return sum(stamp != ts0 for _k, ts0, _d, stamp in self.grabs)


def _recording_driver(port: int, path: str, tap: _NodeTap):
    """A factory of RealLidarDrivers that start recording once connected
    (before any measurement frame) and hand every revolution their
    assembler completes to ``tap``."""

    class RecordingDriver(RealLidarDriver):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self._assembler._on_complete = tap.completed.append

        def connect(self, *a, **kw):
            ok = super().connect(*a, **kw)
            if ok and self._scan_decoder.recorder is None:
                self.start_recording(path)
            return ok

    made = []

    def factory():
        made.append(RecordingDriver(channel_type="tcp", tcp_host="127.0.0.1", tcp_port=port,
                                    motor_warmup_s=0.0))
        return made[-1]

    return factory, made

@pytest.mark.parametrize("ingest", ["host", "fused"])
def test_node_publishes_over_the_live_path(ingest, tmp_path, monkeypatch):
    """ingest_backend host and fused end to end on the CPU: sim wire frames
    -> RealLidarDriver -> the seam -> FSM -> publisher; every published
    revolution equals the port's CPU replay of the node's own recording
    (host: the revolutions the FSM grabbed, under the stamps it handed on;
    fused: replayed in the runs the node's engine was handed — under load
    the pump hands over longer runs, and a run completing more than
    ``max_revs`` revolutions keeps the newest, as the replay then does)."""
    tap = _NodeTap(monkeypatch)
    path = str(tmp_path / "node.rplr")
    sim = tsim.SimulatedDevice(tsim.SimConfig(points_per_rev=PPR, frame_rate_hz=800.0)).start()
    factory, made = _recording_driver(sim.port, path, tap)
    params = _params("torch", channel_type="tcp", tcp_host="127.0.0.1", tcp_port=sim.port,
                     ingest_backend=ingest, scan_mode="DenseBoost", pipelined_publish=True)
    pub = CollectingPublisher(reliable=True)  # keep every message
    node = RPlidarNode(params, pub, driver_factory=factory, fsm_timings=FsmTimings.fast())
    try:
        launch(node)
        assert (node.fused_ingest is not None) == (ingest == "fused")
        assert (node.chain is None) == (ingest == "fused")
        assert wait_for(lambda: pub.scan_count >= 12, 60.0), (
            f"no scans over the live path: {pub.scan_count} scans in 60 s, "
            f"{node.fsm.reset_count} resets, {len(made)} drivers, FSM {node.fsm.state.name}, "
            f"{tap.restamped} restamped")
        node.deactivate()
        resets = node.fsm.reset_count
        timing = dataclasses.asdict(made[-1]._scan_decoder.timing)
        made[-1].stop_recording()
    finally:
        node.shutdown()
        sim.stop()
    assert len(made) == 1 and resets == 0, (
        f"{len(made)} drivers made, {resets} resets, {tap.restamped} restamped")
    if ingest == "host":
        # the node runs exactly the revolutions the FSM grabs and publishes
        # them (the pipelined seam's last one drains at deactivate) under the
        # stamps the FSM handed on; any the FSM missed (the assembler's
        # newest-wins buffer) stay out of the replay's chain
        replay = _host_replay("torch", path, timing, beams=DEFAULT_BEAMS, tap=tap)
    else:
        replay = _fused_replay_as_fed(path, timing, tap.fed, beams=DEFAULT_BEAMS)
    # host: the same float64 sums live and replayed, or the FSM's clock;
    # fused: float32 offsets from each dispatch's base, and the replay is fed
    # the node's runs, so its bases are the node's.  Matched in order: the
    # fused arm hands on a revolution read at once and the next one under
    # one stamp
    stamps = np.array([ts0 for _o, ts0, _d in replay])
    k = -1
    for msg, cloud in zip(pub.scans, pub.clouds):
        after = np.flatnonzero(stamps[k + 1 :] == msg.stamp)
        assert after.size, (
            f"revolution {msg.stamp} not in the replay after its revolution {k}: nearest "
            f"{stamps[int(np.argmin(np.abs(stamps - msg.stamp)))]}, {len(stamps)} replayed "
            f"for {len(pub.scans)} published, {tap.restamped} restamped")
        k += 1 + int(after[0])
        o = replay[k][0]
        at = f"revolution {msg.stamp} of {len(pub.scans)}"
        np.testing.assert_array_equal(msg.ranges, o.ranges, err_msg=f"{at}: ranges")
        np.testing.assert_array_equal(msg.intensities, o.intensities,
                                      err_msg=f"{at}: intensities")
        np.testing.assert_array_equal(cloud.voxel, o.voxel, err_msg=f"{at}: voxel")
        np.testing.assert_array_equal(cloud.points_xy, o.points_xy[o.point_mask],
                                      err_msg=f"{at}: points_xy")
    assert len(pub.scans) == len(pub.clouds) >= 12, (
        f"{len(pub.scans)} scans and {len(pub.clouds)} clouds published, "
        f"{tap.restamped} restamped")

def test_dummy_mode_falls_back_to_host():
    """The dummy driver synthesizes scans above the protocol layer: fused
    falls back to the host path with the chain in place."""
    node = RPlidarNode(_params("torch", dummy_mode=True, ingest_backend="fused"),
                       CollectingPublisher())
    try:
        assert node.configure()
        assert node.fused_ingest is None and node.chain is not None
    finally:
        node.shutdown()

def test_fused_seam_refuses_a_driver_without_it():
    """A driver factory without set_ingest_sink gets one clear error."""
    node = RPlidarNode(_params("torch", ingest_backend="fused"), CollectingPublisher(),
                       driver_factory=DummyLidarDriver)
    try:
        assert node.configure()
        with pytest.raises(RuntimeError, match="set_ingest_sink"):
            node.fsm._factory()
    finally:
        node.shutdown()

def test_run_without_dummy_publishes_from_the_simulator(tmp_path):
    """``python -m rplidar_ros2_driver_tpu_torch run --params P --cpu`` on
    a TCP simulator: exits 0 with scans published."""
    sim = tsim.SimulatedDevice(tsim.SimConfig(points_per_rev=PPR, frame_rate_hz=800.0)).start()
    params = tmp_path / "sim.yaml"
    params.write_text(
        "rplidar_node:\n  ros__parameters:\n"
        "    channel_type: tcp\n    tcp_host: 127.0.0.1\n"
        f"    tcp_port: {sim.port}\n"
        "    scan_mode: DenseBoost\n"
        "    filter_chain: [clip, median, voxel]\n"
        "    filter_window: 8\n    voxel_grid_size: 32\n"
    )
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "rplidar_ros2_driver_tpu_torch", "run", "--params",
             str(params), "--cpu", "--duration", "3"],
            cwd=REPO, capture_output=True, text=True, timeout=120,
        )
    finally:
        sim.stop()
    assert proc.returncode == 0, proc.stderr[-2000:]
    counts = [int(line.split("scans=")[1].split()[0])
              for line in proc.stdout.splitlines() if "scans=" in line]
    assert counts and counts[-1] > 0, proc.stdout

@pytest.mark.parametrize("ingest", ["host", "fused"])
def test_the_card_or_nothing(ingest):
    """With the default filter_backend (the card) and no CUDA device, the
    live node refuses to configure: no fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device: the refusal cannot show")
    params = TParams(filter_chain=("clip", "median", "voxel"), ingest_backend=ingest,
                     channel_type="tcp", tcp_host="127.0.0.1")
    node = RPlidarNode(params, CollectingPublisher())
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        node.configure()

"""How the live path stamps a revolution whose frames came in one read, in
both packages, on the CPU and without load.

The native transceiver takes one arrival stamp per ``read()`` and gives it
to every frame that read completes (native/src/transceiver.cc); the Python
transceiver does the same (protocol/pytransport.py).  When the host falls
behind, one read can hold a whole revolution and the next revolution's
first frame.  Then:

  * the decoder back-dates each sample from its frame's shared stamp, so
    the revolution's first node and the next revolution's sync node get the
    same stamp (their sample index is the same), and the assembler clips the
    revolution's duration to 0.0 (driver/assembly.py); the next revolution
    starts at that same stamp, so ``ts0`` does not tell the two apart;
  * the FSM's RUNNING step hands such a revolution on under its own grab
    clock, not under its ``ts0`` (node/fsm.py, ``duration <= 0``).

Both packages do exactly this: the same revolutions, ``ts0`` and durations
bit for bit, and the same stamp handed to ``on_scan``.  A replay of a live
recording therefore has to take the stamps the FSM handed on from the node
(tests/test_torch_live_path.py and chip_smoke.py's ``e2e`` phase do).
"""

from __future__ import annotations

import types

import numpy as np
import pytest

from rplidar_ros2_driver_tpu.core.config import DriverParams as JParams
from rplidar_ros2_driver_tpu.driver import assembly as jasm
from rplidar_ros2_driver_tpu.driver import decode as jdec
from rplidar_ros2_driver_tpu.node import fsm as jfsm
from rplidar_ros2_driver_tpu_torch.core.config import DriverParams as TParams
from rplidar_ros2_driver_tpu_torch.driver import assembly as tasm
from rplidar_ros2_driver_tpu_torch.driver import decode as tdec
from rplidar_ros2_driver_tpu_torch.node import fsm as tfsm
from rplidar_ros2_driver_tpu_torch.ops import wire
from rplidar_ros2_driver_tpu_torch.protocol.constants import Ans

from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

DENSE = int(Ans.MEASUREMENT_DENSE_CAPSULED)
PPR = 400                  # points a revolution: 10 dense frames
FRAME_S = 0.01             # one frame every 10 ms (10 revolutions a second)
REVS = 6
# frames 21..31 arrive in one read: the pairs anchored at them carry
# revolution 2 from its first node to the next revolution's sync node
ONE_READ = (21, 31)
SHARED = 2                 # the revolution whose frames share one stamp
CLOCK = 4321.0             # the FSM's grab clock, fixed
PKGS = {"jax": (jasm, jdec, jfsm, JParams), "torch": (tasm, tdec, tfsm, TParams)}


def _frames(seed: int = 22) -> list:
    """REVS revolutions of a seeded dense-capsule room."""
    rng = np.random.default_rng(seed)
    frames = []
    for idx in range(0, REVS * PPR, 40):
        pts = (np.arange(40) + idx) % PPR
        dists = 1500.0 + 400.0 * np.sin(2 * np.pi * pts / PPR) + rng.integers(0, 40, 40)
        frames.append(wire.encode_dense_capsule(int(360.0 * (idx % PPR) / PPR * 64) & 0x7FFF,
                                                idx == 0, dists.astype(int)))
    return frames


def _reads(frames: list) -> list:
    """The frames as the transceiver hands them on: one read for each frame,
    but ONE_READ's frames in one read, under the stamp of its last frame."""
    rx = 100.0 + FRAME_S * np.arange(len(frames))
    a, b = ONE_READ
    reads = [[(f, float(t))] for f, t in zip(frames[:a], rx[:a])]
    reads.append([(f, float(rx[b])) for f in frames[a : b + 1]])
    reads += [[(f, float(t))] for f, t in zip(frames[b + 1 :], rx[b + 1 :])]
    return reads


def _revolutions(pkg: str, runs: list) -> list:
    asm_mod, dec_mod, _fsm, _p = PKGS[pkg]
    revs = []
    dec = dec_mod.BatchScanDecoder(asm_mod.ScanAssembler(on_complete=revs.append))
    for run in runs:
        dec.on_measurement_batch(DENSE, run)
    return revs


def _runs(frames: list, split: str) -> list:
    reads = _reads(frames)
    if split == "reads":
        return reads
    flat = [item for read in reads for item in read]
    return [flat[i : i + 3] for i in range(0, len(flat), 3)]


@pytest.fixture(scope="module")
def frames():
    return _frames()


@pytest.mark.parametrize("split", ["reads", "runs_of_3"])
def test_a_revolution_in_one_read_gets_duration_zero_in_both_packages(frames, split):
    """The same revolutions, ts0, durations and node stamps from both
    packages' decoder and assembler, bit for bit, whether the pump hands the
    frames on read by read or in runs of three; the revolution read at once
    lasts 0.0 s and shares its ts0 with the next one."""
    runs = _runs(frames, split)
    got, want = _revolutions("torch", runs), _revolutions("jax", runs)
    assert len(got) == len(want) == REVS - 1
    for k, (t, j) in enumerate(zip(got, want)):
        for key in ("angle_q14", "dist_q2", "quality", "flag", "node_ts"):
            np.testing.assert_array_equal(t[key], j[key], err_msg=f"rev {k} {key}")
        assert (t["ts0"], t["duration"]) == (j["ts0"], j["duration"]), f"rev {k}"
    durations = [r["duration"] for r in got]
    assert durations[SHARED] == 0.0, durations
    assert all(d > 0.0 for k, d in enumerate(durations) if k != SHARED), durations
    assert got[SHARED + 1]["ts0"] == got[SHARED]["ts0"]
    assert len({r["ts0"] for r in got}) == len(got) - 1


class _StubDriver:
    """Hands the FSM one revolution, as ``grab_scan_host`` does."""

    def __init__(self, rev: dict) -> None:
        self.rev = rev

    def is_connected(self) -> bool:
        return True

    def grab_scan_host(self, timeout_s: float):
        return self.rev, self.rev["ts0"], self.rev["duration"]


def _handed(pkg: str, rev: dict, monkeypatch) -> list:
    """What one RUNNING step of the package's FSM hands to ``on_scan`` for
    ``rev``, with the module's clock fixed at CLOCK."""
    _asm, _dec, fsm_mod, params = PKGS[pkg]
    handed = []
    fsm = fsm_mod.ScanLoopFsm(lambda: None, lambda *a: handed.append(a), params=params(),
                              timings=fsm_mod.FsmTimings.fast())
    fsm.driver = _StubDriver(rev)
    monkeypatch.setattr(fsm_mod, "time", types.SimpleNamespace(monotonic=lambda: CLOCK))
    fsm._do_running()
    assert fsm.error_count == 0
    return handed


@pytest.mark.parametrize("which", ["read_at_once", "read_frame_by_frame"])
def test_the_fsm_hands_on_its_clock_for_a_zero_duration_revolution(frames, which, monkeypatch):
    """Both FSMs hand a revolution of duration 0.0 on under the grab clock
    (duration: the clock's own difference, 0.0 here), and any other under
    its own ts0 and duration."""
    k = SHARED if which == "read_at_once" else SHARED - 1
    revs = {pkg: _revolutions(pkg, _reads(frames)) for pkg in PKGS}
    handed = {pkg: _handed(pkg, revs[pkg][k], monkeypatch) for pkg in PKGS}
    for pkg, calls in handed.items():
        assert len(calls) == 1, pkg
        scan, stamp, duration = calls[0]
        assert scan is revs[pkg][k]
        if which == "read_at_once":
            assert scan["duration"] == 0.0 and (stamp, duration) == (CLOCK, 0.0), pkg
        else:
            assert (stamp, duration) == (scan["ts0"], scan["duration"]) and duration > 0, pkg
    assert handed["torch"][0][1:] == handed["jax"][0][1:]

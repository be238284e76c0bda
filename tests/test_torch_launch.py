"""The slim launch path (utils/launch.py) and the kernels' C interface.

No nvcc here: the C prototypes are read from csrc/ as text and held to the
wrappers' ctypes signatures, and the launch path runs against a stand-in
library.  The wrappers' checks and their CPU arms run as they are.
"""

import ctypes
import re

import pytest
import torch

from rplidar_ros2_driver_tpu_torch.ops import deskew_kernels as dk
from rplidar_ros2_driver_tpu_torch.ops import median_kernels as mk
from rplidar_ros2_driver_tpu_torch.ops import scan_match_kernels as smk
from rplidar_ros2_driver_tpu_torch.utils import cuda_build, launch
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

_PROTO = re.compile(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)', re.S)


def c_prototypes() -> dict:
    """Exported entry -> ctypes type of each argument, from csrc/*.cu."""
    out = {}
    for src in sorted(cuda_build.SOURCES.values()):
        text = (cuda_build.CSRC_DIR / src).read_text()
        for name, args in _PROTO.findall(text):
            kinds = []
            for arg in args.split(","):
                arg = " ".join(arg.split())
                if "*" in arg:
                    kinds.append(ctypes.c_void_p)
                elif re.fullmatch(r"(const )?int \w+", arg):
                    kinds.append(ctypes.c_int)
                else:
                    raise AssertionError(f"{src}: {name} has an argument ctypes cannot take: {arg}")
            out[name] = kinds
    return out


def kernel_entries() -> dict:
    """Exported entry -> its KernelEntry, over every wrapper module."""
    return {
        v.name: v
        for m in (mk, dk, smk)
        for v in vars(m).values()
        if isinstance(v, launch.KernelEntry)
    }


def test_every_c_entry_has_the_wrappers_signature():
    protos = c_prototypes()
    entries = kernel_entries()
    assert len(protos) == 8 and set(protos) == set(entries)
    for name, kinds in protos.items():
        assert list(entries[name].argtypes) == kinds, name
        src = cuda_build.CSRC_DIR / cuda_build.SOURCES[entries[name].library]
        assert f"int {name}(" in src.read_text(), name


def test_slim_entries_take_the_device_index_before_the_stream():
    for name, kinds in c_prototypes().items():
        assert kinds[-2:] == [ctypes.c_int, ctypes.c_void_p], name
    for src in cuda_build.SOURCES.values():
        text = (cuda_build.CSRC_DIR / src).read_text()
        assert '#include "device_guard.cuh"' in text, src
        # every entry makes the card current before it launches
        assert text.count("DeviceGuard guard(device);") == len(_PROTO.findall(text)), src


def test_prototype_parser_sees_a_missing_argument():
    text = 'extern "C" int f_i32(const int* a, int* out, int n, void* stream) {'
    name, args = _PROTO.findall(text)[0]
    assert name == "f_i32" and len(args.split(",")) == 4


class _FakeLib:
    """A stand-in for the ctypes library: one entry that records its calls
    and returns the error code it is given."""

    def __init__(self, rc):
        def entry(*args):
            entry.calls.append(args)
            return rc

        entry.calls = []
        self.k_i32 = entry


def test_kernel_entry_resolves_once_and_raises_on_an_error(monkeypatch):
    loads = []
    lib = _FakeLib(0)
    monkeypatch.setattr(launch, "load_library", lambda name: loads.append(name) or lib)
    e = launch.KernelEntry("median", "k_i32", [launch.VP, launch.I, launch.VP])
    assert e.fn is None  # nothing is built or loaded before the first call
    e(1, 2, 3)
    e(4, 5, 6)
    assert loads == ["median"] and lib.k_i32.calls == [(1, 2, 3), (4, 5, 6)]
    assert lib.k_i32.argtypes == [launch.VP, launch.I, launch.VP]
    assert lib.k_i32.restype is launch.I

    bad = launch.KernelEntry("median", "k_i32", [])
    monkeypatch.setattr(launch, "load_library", lambda name: _FakeLib(700))
    with pytest.raises(RuntimeError, match="k_i32 kernel launch failed: cudaError 700"):
        bad()


def test_library_hash_follows_the_shared_headers(monkeypatch, tmp_path):
    for src in cuda_build.SOURCES.values():
        (tmp_path / src).write_text((cuda_build.CSRC_DIR / src).read_text())
    header = tmp_path / "device_guard.cuh"
    header.write_text((cuda_build.CSRC_DIR / "device_guard.cuh").read_text())
    monkeypatch.setattr(cuda_build, "CSRC_DIR", tmp_path)
    before = cuda_build.library_path("deskew")
    header.write_text(header.read_text() + "\n// edited\n")
    assert cuda_build.library_path("deskew") != before


_F, _I32 = torch.float32, torch.int32


@pytest.mark.parametrize(
    "call, exc",
    [
        (lambda: mk.temporal_median_kernel(torch.zeros(4, 8, dtype=torch.float64)), TypeError),
        (lambda: mk.temporal_median_kernel(torch.zeros(4, 8, dtype=torch.int32)), TypeError),
        (lambda: mk.temporal_median_kernel(torch.zeros(8)), ValueError),
        (lambda: mk.temporal_median_kernel(torch.zeros(2, 4, 8)), ValueError),
        (lambda: mk.temporal_median_kernel(torch.zeros(0, 8)), ValueError),
        (lambda: mk.temporal_median_kernel(torch.zeros(8, 4).T), ValueError),
        (lambda: mk.temporal_median_kernel(torch.zeros(4, 8, device="meta")), RuntimeError),
        (lambda: dk.beam_min_kernel(torch.zeros(1, 4, dtype=torch.int64),
                                    torch.zeros(1, 4, dtype=_I32), 8), TypeError),
        (lambda: dk.beam_min_kernel(torch.zeros(1, 4, dtype=_I32), torch.zeros(1, 4), 8), TypeError),
        (lambda: dk.beam_min_kernel(torch.zeros(4, dtype=_I32), torch.zeros(4, dtype=_I32), 8),
         ValueError),
        (lambda: dk.beam_min_kernel(torch.zeros(1, 4, dtype=_I32), torch.zeros(1, 3, dtype=_I32), 8),
         ValueError),
        (lambda: dk.beam_min_kernel(torch.zeros(1, 4, dtype=_I32), torch.zeros(1, 4, dtype=_I32), 0),
         ValueError),
        (lambda: dk.beam_min_kernel(torch.zeros(1, 4, dtype=_I32), torch.zeros(1, 4, dtype=_I32),
                                    8193), ValueError),
        (lambda: dk.beam_min_kernel(torch.zeros(4, 2, dtype=_I32).T, torch.zeros(2, 4, dtype=_I32),
                                    8), ValueError),
        (lambda: dk.beam_min_kernel(torch.zeros(2, 4, dtype=_I32), torch.zeros(4, 2, dtype=_I32).T,
                                    8), ValueError),
        (lambda: dk.beam_min_kernel(torch.zeros(1, 4, dtype=_I32),
                                    torch.zeros(1, 4, dtype=_I32, device="meta"), 8), ValueError),
        (lambda: dk.beam_min_kernel(torch.zeros(1, 4, dtype=_I32, device="meta"),
                                    torch.zeros(1, 4, dtype=_I32, device="meta"), 8), RuntimeError),
    ],
)
def test_slim_wrappers_check_their_inputs(call, exc):
    mk.reset_launch_counts()
    dk.reset_launch_counts()
    with pytest.raises(exc):
        call()
    assert mk.launch_counts["temporal_median"] == 0 and dk.launch_counts["beam_min"] == 0


def test_slim_wrapper_messages_name_the_fault():
    with pytest.raises(TypeError, match="window must be float32, got torch.float64"):
        mk.temporal_median_kernel(torch.zeros(4, 8, dtype=torch.float64))
    with pytest.raises(ValueError, match="window must be contiguous"):
        mk.temporal_median_kernel(torch.zeros(8, 4).T)
    with pytest.raises(RuntimeError, match="no temporal-median kernel for device meta"):
        mk.temporal_median_kernel(torch.zeros(4, 8, device="meta"))
    b = torch.zeros(1, 4, dtype=_I32)
    with pytest.raises(TypeError, match="values must be int32, got torch.float32"):
        dk.beam_min_kernel(b, torch.zeros(1, 4), 8)
    with pytest.raises(ValueError, match=r"values must have shape \(1, 4\), got \(1, 3\)"):
        dk.beam_min_kernel(b, b[:, :3], 8)
    with pytest.raises(ValueError, match="beam must be contiguous"):
        dk.beam_min_kernel(torch.zeros(4, 2, dtype=_I32).T, torch.zeros(2, 4, dtype=_I32), 8)
    with pytest.raises(RuntimeError, match="no beam-min kernel for device meta"):
        dk.beam_min_kernel(b.to("meta"), b.to("meta"), 8)


def test_slim_wrappers_on_cpu_run_the_plain_version_and_count_no_launch():
    mk.reset_launch_counts()
    dk.reset_launch_counts()
    win = torch.tensor([[1.0, float("inf")], [3.0, float("inf")], [2.0, 5.0]])
    assert torch.equal(mk.temporal_median_kernel(win), torch.tensor([2.0, 5.0]))
    beam = torch.tensor([[0, 2, 2, 7, -1]], dtype=_I32)
    vals = torch.tensor([[9, 4, 3, 1, 0]], dtype=_I32)
    got = dk.beam_min_kernel(beam, vals, 4)
    assert got.tolist() == [[9, dk._EMPTY, 3, dk._EMPTY]]
    assert torch.equal(got, dk.beam_min_plain(beam, vals, 4))
    assert mk.launch_counts["temporal_median"] == 0 and dk.launch_counts["beam_min"] == 0
    # empty shapes stay on the plain version too
    assert mk.temporal_median_kernel(torch.zeros(3, 0)).shape == (0,)
    assert dk.beam_min_kernel(torch.zeros(0, 5, dtype=_I32), torch.zeros(0, 5, dtype=_I32),
                              16).shape == (0, 16)
    assert mk.launch_counts["temporal_median"] == 0 and dk.launch_counts["beam_min"] == 0

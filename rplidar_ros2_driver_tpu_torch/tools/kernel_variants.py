"""B3's and B5's design variants on one card, side by side.

    python3 -m rplidar_ros2_driver_tpu_torch.tools.kernel_variants [--rounds 3]

Needs one CUDA card.  Builds, from this checkout's csrc/sliding_median.cu
(B3) and csrc/deskew.cu (B5), variants that differ from the shipped
kernels in one constant or one step (``B3_VARIANTS``, ``B5_VARIANTS``: the
text each replaces), and an empty kernel, the launch floor: one ``nvcc``
each, all started together, into ``build/variants/`` (git-ignored).  The
kernels before their redesign are timed against these by
``tools/fleet_ab.py --baseline``.  Each variant is held equal to the plain
version at its
path's shape — B3 at the replay's W=64, K=512, B=2048 stripe and its K=7
tail, B5 at the de-skew path's 8 slots x 17 shifts x 256 beams — except
the ``diagnostic`` ones, which leave out a step on purpose.  Then each is
timed over ``--rounds`` rounds whose order alternates: CUDA events ms per
call, then device ms from torch.profiler.  Prints one JSON line (per
variant: its registers from ``-Xptxas -v``, the medians), then the card's
name and power limit.  The variants launch their C entries directly and
count nothing.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import re
import statistics
import subprocess
from pathlib import Path

import numpy as np
import torch

from rplidar_ros2_driver_tpu_torch.ops import deskew_kernels as dk
from rplidar_ros2_driver_tpu_torch.ops import median_kernels as mk
from rplidar_ros2_driver_tpu_torch.utils import cuda_build
from rplidar_ros2_driver_tpu_torch.utils.launch import current_stream

ROOT = Path(__file__).resolve().parents[2]
OUT = ROOT / "build" / "variants"
VP, I = ctypes.c_void_p, ctypes.c_int

# name -> (text of csrc/sliding_median.cu replaced, its replacement, kQ)
B3_VARIANTS = {
    "shipped": ("", "", mk.SLIDING_Q),
    "rows_per_thread_3": ("constexpr int kQ = 6; ", "constexpr int kQ = 3; ", 3),
    "rows_per_thread_4": ("constexpr int kQ = 6; ", "constexpr int kQ = 4; ", 4),
    "rows_per_thread_8": ("constexpr int kQ = 6; ", "constexpr int kQ = 8; ", 8),
}
_B5_LOOP = "  int sad = 0, cnt = 0;\n  for (int d = lane;"
# name -> (text of csrc/deskew.cu replaced, its replacement, diagnostic)
B5_VARIANTS = {
    "shipped": ("", "", False),
    "warps_1": ("constexpr int kSadWarps = 4; ", "constexpr int kSadWarps = 1; ", False),
    "warps_2": ("constexpr int kSadWarps = 4; ", "constexpr int kSadWarps = 2; ", False),
    "warps_8": ("constexpr int kSadWarps = 4; ", "constexpr int kSadWarps = 8; ", False),
    # one block per row: all 17 candidates of a row in one block
    "block_per_row": ("constexpr int kSadWarps = 4; ", "constexpr int kSadWarps = 32; ", False),
    # the staging alone: no loop over the beams
    "stage_only": (_B5_LOOP, "  int sad = sp[lane % D] + sc[(lane + sh) % D], cnt = 1;\n"
                   "  for (int d = D;", True),
    # no staging: the loop over shared memory never written
    "no_stage": ("  stage_pair(sp, prev + row * D, sc, cur + row * D, D, t, blockDim.x);\n", "",
                 True),
}
_EMPTY = """#include <cuda_runtime.h>
__global__ void empty_kernel(int* out) {
  if (out != nullptr && threadIdx.x == 1 << 30) out[0] = 1;
}
extern "C" int empty_i32(int* out, int blocks, int threads, void* stream) {
  empty_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(out);
  return static_cast<int>(cudaGetLastError());
}
"""
_PROTO = re.compile(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)', re.S)


def write_sources() -> dict:
    """Every variant's source under OUT: name -> (source path, kernel)."""
    OUT.mkdir(parents=True, exist_ok=True)
    for header in cuda_build.CSRC_DIR.glob("*.cuh"):
        (OUT / header.name).write_text(header.read_text())
    srcs = {}
    for kernel, file, variants in (("b3", "sliding_median.cu", B3_VARIANTS),
                                   ("b5", "deskew.cu", B5_VARIANTS)):
        text = (cuda_build.CSRC_DIR / file).read_text()
        for name, (old, new, _) in variants.items():
            if old and old not in text:
                raise SystemExit(f"kernel_variants: {file} no longer holds {old!r}")
            path = OUT / f"{kernel}_{name}.cu"
            path.write_text(text.replace(old, new, 1) if old else text)
            srcs[f"{kernel}_{name}"] = (path, kernel)
    (OUT / "empty.cu").write_text(_EMPTY)
    srcs["empty"] = (OUT / "empty.cu", "empty")
    return srcs


def build(srcs: dict) -> dict:
    """nvcc for every source at once; name -> (library, registers per kernel)."""
    nvcc = cuda_build.find_nvcc()
    procs = {name: subprocess.Popen(
        [nvcc, *cuda_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(path.with_suffix(".so")),
         str(path)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, (path, _) in srcs.items()}
    out = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"kernel_variants: nvcc failed for {name}:\n{log}")
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
        out[name] = (ctypes.CDLL(str(srcs[name][0].with_suffix(".so"))), regs)
    return out


def entry(lib, name: str, path: Path):
    """The C entry ``name`` of ``lib`` with the argument types of its
    prototype in ``path``."""
    args = dict(_PROTO.findall(path.read_text()))[name].split(",")
    fn = getattr(lib, name)
    fn.argtypes = [VP if "*" in a else I for a in args]
    fn.restype = I
    return fn


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_variants: no CUDA device")
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    srcs = write_sources()
    libs = build(srcs)
    dev, idx = torch.device("cuda", 0), 0
    rng = np.random.default_rng(0)

    w = cs.REPLAY["window"]
    stripes = {k: torch.from_numpy(cs._median_fixtures(rng, w + k, cs.REPLAY["beams"])
                                   ["ties_1mm"]).to(dev) for k in (cs.REPLAY["chunk"], 7)}
    prev, cur, cands = cs._b5_path_inputs(rng, dev)
    want5 = dk.shift_sad_plain(prev, cur, cands, 16, 2048)
    calls = {}
    for name, (path, kernel) in srcs.items():
        lib = libs[name][0]
        if kernel == "b3":
            fn = entry(lib, "sliding_median_f32", path)
            q = B3_VARIANTS[name[3:]][2]
            for k, ext in stripes.items():
                out = torch.empty(k, ext.shape[1], device=dev)
                for warps in (8, 4):
                    rows = min(q * warps + 2 * w - 2, w + k - 1)
                    calls[f"{name}_k{k}_warps{warps}"] = (
                        lambda fn=fn, ext=ext, out=out, k=k, warps=warps, rows=rows: fn(
                            ext.data_ptr(), out.data_ptr(), w, k, ext.shape[1], warps, rows, idx,
                            current_stream(idx)),
                        out, mk.sliding_median_plain(ext, w), False)
        elif kernel == "b5":
            fn = entry(lib, "shift_sad_i32", path)
            out = torch.empty_like(want5)
            diagnostic = B5_VARIANTS[name[3:]][2]
            calls[name] = (lambda fn=fn, out=out: fn(
                prev.data_ptr(), cur.data_ptr(), cands.data_ptr(), out.data_ptr(), prev.shape[0],
                cands.shape[0], prev.shape[1], 16, 2048, idx, current_stream(idx)),
                out, want5, diagnostic)
        else:
            fn = entry(lib, "empty_i32", path)
            out = torch.empty(1, dtype=torch.int32, device=dev)
            calls[name] = (lambda fn=fn, out=out: fn(out.data_ptr(), 40, 128, current_stream(idx)),
                           out, None, True)
    rows = {}
    for name, (call, out, want, diagnostic) in calls.items():
        rc = call()
        torch.cuda.synchronize()
        if rc:
            raise SystemExit(f"kernel_variants: {name} failed to launch: cudaError {rc}")
        if not diagnostic and not torch.equal(out, want):
            raise SystemExit(f"kernel_variants: {name} differs from the plain version")
        lib_name = name if name in libs else name.split("_k")[0]
        rows[name] = {"registers": libs[lib_name][1], "held_equal": not diagnostic, "ms": []}
    order = list(calls)
    for r in range(args.rounds):
        for name in (order if r % 2 == 0 else order[::-1]):
            rows[name]["ms"].append(cs.cuda_ms(calls[name][0], iters=50))
    for name in order:
        rows[name]["ms"] = statistics.median(rows[name]["ms"])
        rows[name]["device_ms"] = cs.device_ms(calls[name][0], iters=20)
    print(json.dumps({"tool": "kernel_variants", "device": torch.cuda.get_device_name(0),
                      "rounds": args.rounds, "variants": rows}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

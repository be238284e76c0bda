"""Host time per call of the slim launch path, split piece by piece.

    python3 -m rplidar_ros2_driver_tpu_torch.tools.launch_cost [--iters N]

Needs one CUDA card; prints one JSON line.  For B1 (temporal median, W=64,
B=2048) and B4 (beam min, 1 x 2560 -> 2048 beams and 8 x 4096 -> 256) it
times, each alone and with ``perf_counter`` around ``iters`` calls and no
synchronisation between them: the whole wrapper; the output's
``torch.empty``; the raw current-stream read; the ctypes entry with its
launch (arguments made beforehand).  What is left is the wrapper's own
Python.  Beside B4 it times the library call with a fresh output per call,
as the kernel hands one back (``torch.full`` then ``scatter_reduce_``
"amin"), by host µs and CUDA events.  B5 (shift-search scores, 8 x 17
shifts x 256 beams) is split as B1 and B4 are.  The matcher kernels B6, B7 and B8
(launched in clusters through ``cudaLaunchKernelEx``, with a launch plan
looked up per call) are split the same way at config 12's fleet tick (N=4,
256x256, 2048 beams), with their plan lookup apart, and their entries
also timed by CUDA events.
The data are seeded random values at the path's shapes: host times do not
depend on them.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from rplidar_ros2_driver_tpu_torch.ops import deskew_kernels as dk
from rplidar_ros2_driver_tpu_torch.ops import median_kernels as mk
from rplidar_ros2_driver_tpu_torch.ops import scan_match_kernels as smk
from rplidar_ros2_driver_tpu_torch.ops.scan_match import SUB, MapConfig
from rplidar_ros2_driver_tpu_torch.utils.launch import current_stream


def host_us(fn, iters: int) -> float:
    """Host µs per call over ``iters`` unsynchronised calls, after a warm-up."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e6


def events_ms(fn, iters: int) -> float:
    """Milliseconds per call from CUDA events around ``iters`` calls."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def split(wrapper, alloc, entry, idx: int, iters: int, plan=None) -> dict:
    parts = {"wrapper": host_us(wrapper, iters), "alloc": host_us(alloc, iters),
             "stream": host_us(lambda: current_stream(idx), iters),
             "entry": host_us(entry, iters)}
    if plan is not None:
        parts["plan"] = host_us(plan, iters)
    parts["python_rest"] = parts["wrapper"] - sum(v for k, v in parts.items() if k != "wrapper")
    if plan is not None:
        # whether the card, not the host, sets the entry's rate here
        parts["entry_events_ms"] = events_ms(entry, iters)
    return parts


def matcher_split(rng, dev, idx: int, stream: int, it: int) -> dict:
    """B6, B7, B8 at config 12's fleet tick."""
    cfg = MapConfig(match_backend="pallas")
    n, g, b = 4, cfg.grid, cfg.beams
    t, u, f = 2 * cfg.theta_window + 1, 2 * cfg.window_cells + 1, 2 * cfg.fine_radius + 1

    def i32(*shape, hi=1 << 12):
        return torch.from_numpy(rng.integers(-hi, hi, shape, dtype=np.int32)).to(dev)

    lo, pq, posec, trig, cos_q, sin_q = i32(n, g, g), i32(n, b, 2), i32(n, 2), i32(n, 2), \
        i32(n, t), i32(n, t)
    ok = torch.ones((n, b), dtype=torch.bool, device=dev)
    uv = torch.zeros((n, 2), dtype=torch.int32, device=dev)
    mq, score_c = torch.empty_like(lo), torch.empty((n, u, u), dtype=torch.int32, device=dev)
    score_f = torch.empty((n, t, f, f), dtype=torch.int32, device=dev)
    sms = smk._sm_count(idx)
    p6 = smk.coarse_plan(n, g, cfg.coarse, cfg.window_cells, cfg.clamp_q, cfg.quant_shift, sms)
    p7 = smk.fine_plan(n, t, cfg.fine_radius, sms)
    p8 = smk.update_plan(n, g, sms)
    clog = cfg.coarse.bit_length() - 1
    return {
        "coarse_scores": split(
            lambda: smk.coarse_scores_kernel(lo, pq, ok, posec, trig, cfg),
            lambda: (torch.empty_like(lo), torch.empty((n, u, u), dtype=torch.int32, device=dev)),
            # graftlint: disable=GL010 — timing tool: the raw C entry on a CUDA
            # tensor, measured beside its wrapper (never on a CPU tensor)
            lambda: smk._B6(lo.data_ptr(), pq.data_ptr(), ok.data_ptr(), posec.data_ptr(),
                            trig.data_ptr(), mq.data_ptr(), score_c.data_ptr(), n, g, b,
                            cfg.coarse, clog, cfg.clamp_q, cfg.quant_shift, cfg.window_cells,
                            *p6, idx, stream),
            idx, it,
            plan=lambda: smk.coarse_plan(n, g, cfg.coarse, cfg.window_cells, cfg.clamp_q,
                                         cfg.quant_shift, smk._sm_count(idx))),
        "fine_scores": split(
            lambda: smk.fine_scores_kernel(mq, pq, ok, posec, cos_q, sin_q, uv, cfg),
            lambda: torch.empty((n, t, f, f), dtype=torch.int32, device=dev),
            # graftlint: disable=GL010 — timing tool: the raw C entry on a CUDA
            # tensor, measured beside its wrapper (never on a CPU tensor)
            lambda: smk._B7(mq.data_ptr(), pq.data_ptr(), ok.data_ptr(), posec.data_ptr(),
                            cos_q.data_ptr(), sin_q.data_ptr(), uv.data_ptr(),
                            score_f.data_ptr(), n, g, b, t, cfg.coarse * SUB, cfg.fine_radius,
                            *p7, idx, stream),
            idx, it, plan=lambda: smk.fine_plan(n, t, cfg.fine_radius, smk._sm_count(idx))),
        "log_odds_update": split(
            lambda: smk.log_odds_update_kernel(lo, pq, ok, posec, trig, cfg),
            lambda: torch.empty_like(lo),
            # graftlint: disable=GL010 — timing tool: the raw C entry on a CUDA
            # tensor, measured beside its wrapper (never on a CPU tensor)
            lambda: smk._B8(lo.data_ptr(), pq.data_ptr(), ok.data_ptr(), posec.data_ptr(),
                            trig.data_ptr(), mq.data_ptr(), n, g, b, cfg.hit_q, cfg.miss_q,
                            cfg.clamp_q, cfg.free_samples, *p8, idx, stream),
            idx, it, plan=lambda: smk.update_plan(n, g, smk._sm_count(idx))),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("launch_cost: no CUDA device")
    dev, idx, it = torch.device("cuda", 0), 0, args.iters
    rng = np.random.default_rng(args.seed)
    stream = current_stream(idx)
    rows = {}

    w, b = 64, 2048
    win = torch.from_numpy(rng.uniform(0.1, 40.0, (w, b)).astype(np.float32)).to(dev)
    med = torch.empty(b, device=dev)
    rows["temporal_median"] = split(
        lambda: mk.temporal_median_kernel(win), lambda: win.new_empty((b,)),
        # graftlint: disable=GL010 — timing tool: the raw C entry on a CUDA
        # tensor, measured beside its wrapper (never on a CPU tensor)
        lambda: mk._B1(win.data_ptr(), med.data_ptr(), w, b, idx, stream), idx, it)

    for name, rows_n, n, nb in (("beam_min_raster", 1, 2560, 2048),
                                ("beam_min_profile", 8, 4096, 256)):
        beam = torch.from_numpy(rng.integers(0, nb, (rows_n, n), dtype=np.int32)).to(dev)
        vals = torch.from_numpy(rng.integers(0, 1 << 26, (rows_n, n), dtype=np.int32)).to(dev)
        out = torch.empty(rows_n, nb, dtype=torch.int32, device=dev)
        rows[name] = split(
            lambda: dk.beam_min_kernel(beam, vals, nb), lambda: beam.new_empty((rows_n, nb)),
            # graftlint: disable=GL010 — timing tool: the raw C entry on a CUDA
            # tensor, measured beside its wrapper (never on a CPU tensor)
            lambda: dk._B4(beam.data_ptr(), vals.data_ptr(), out.data_ptr(), rows_n, n, nb,
                           idx, stream), idx, it)
        index = beam.long()

        def fresh():
            return torch.full((rows_n, nb), dk._EMPTY, dtype=torch.int32, device=dev
                              ).scatter_reduce_(1, index, vals, reduce="amin", include_self=True)

        rows[name]["fresh_library_host_us"] = host_us(fresh, it)
        rows[name]["fresh_library_ms"] = events_ms(fresh, it)
    # B5 at the shift search: 8 revolution slots x 17 shifts x 256 beams
    rows_n, c, d = 8, 17, 256
    prev = torch.from_numpy(rng.integers(0, 6000, (rows_n, d), dtype=np.int32)).to(dev)
    cur = torch.from_numpy(rng.integers(0, 6000, (rows_n, d), dtype=np.int32)).to(dev)
    shifts = torch.from_numpy(rng.integers(-8, 9, c, dtype=np.int32)).to(dev)
    scores = torch.empty(rows_n, c, dtype=torch.int32, device=dev)
    rows["shift_sad"] = split(
        lambda: dk.shift_sad_kernel(prev, cur, shifts, 16, 2048),
        lambda: prev.new_empty((rows_n, c)),
        # graftlint: disable=GL010 — timing tool: the raw C entry on a CUDA
        # tensor, measured beside its wrapper (never on a CPU tensor)
        lambda: dk._B5(prev.data_ptr(), cur.data_ptr(), shifts.data_ptr(), scores.data_ptr(),
                       rows_n, c, d, 16, 2048, idx, stream), idx, it)
    rows.update(matcher_split(rng, dev, idx, stream, it))
    print(json.dumps({"tool": "launch_cost", "device": torch.cuda.get_device_name(0),
                      "iters": it, "host_us": rows}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

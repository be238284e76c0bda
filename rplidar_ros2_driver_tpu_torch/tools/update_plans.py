"""The log-odds update (B8) on launch plans of the caller's choosing.

    python3 -m rplidar_ros2_driver_tpu_torch.tools.update_plans [--rounds 5]

``stripe_edge_fixture`` builds B8's stripe-edge inputs (numpy only);
``chip_smoke.py`` holds the CUDA kernel and ``tests/test_torch_scan_match.py``
the plain version to the JAX package on them.  ``launch_update`` launches
B8 on a plan ``(local, cluster, threads, rows, shared bytes)`` as
``scan_match_kernels.update_plan`` returns one, and counts nothing: the
path's entry is ``log_odds_update_kernel``, which always takes its own plan.

``main`` needs one CUDA card.  On ``chip_smoke.match_tick``'s inputs at
config 12's fleet tick (N=4) and the map replay's (N=1) it holds each of
these plans bit-equal to the plain version: the wrapper's own, the local
route at half its cluster, and the remote route at its cluster.  Then, in
``--rounds`` rounds whose order of plans alternates, it times each plan's
raw entry (arguments made beforehand): host µs per call over unsynchronised
calls, and CUDA events ms per call.  Device ms from torch.profiler come
last, since a profiler session slows the host for the rest of the process.
Prints one JSON line (per shape and plan: the plan, the median and range of
each measure), then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import subprocess
from pathlib import Path

import numpy as np
import torch

from rplidar_ros2_driver_tpu_torch.ops import scan_match_kernels as smk
from rplidar_ros2_driver_tpu_torch.ops.scan_match import SUB, MapConfig, min_quant_shift
from rplidar_ros2_driver_tpu_torch.utils.launch import current_stream

ROOT = Path(__file__).resolve().parents[2]


def stripe_edge_fixture(rng, grid: int, n: int, rows: int, samples: int, saturated: bool,
                        coarse: int = 4):
    """B8's stripe edges for a plan whose blocks own ``rows`` rows each:
    ``(name, MapConfig, log_odds, pose, pq, ok)``, numpy arrays.  Each
    stream's sensor sits on a stripe-boundary row (at subcell 0 or 31 of
    its cell) with the identity rotation; its endpoints fall on the first
    and last row of every stripe, one row and one column off each side of
    the map, and at the sensor itself (hit and free in one cell); rays
    along the sensor's row put the samples o + (w-o)·k // S on stripe
    boundaries.  Every seventh beam is invalid.  A ``saturated`` map holds
    ±clamp_q in a checkerboard, else ``rng`` fills it."""
    g = grid
    edges = sorted({r for k in range(0, g, rows) for r in (k - 1, k, k + rows - 1)} | {g})
    cols = (-1, 0, g // 2, g - 1, g)
    pose = np.zeros((n, 3), np.int32)
    pq = []
    for s in range(n):
        rb = rows * ((s + 1) % -(-g // rows))        # a stripe's first row
        sub = 31 * (s % 2)
        pose[s, :2] = [(rb - g // 2) * SUB + sub, s * SUB]
        ox, oy = rb * SUB + sub, (g // 2 + s) * SUB
        pts = [(r * SUB + e - ox, c * SUB + e - oy) for r in edges for c in cols for e in (0, 31)]
        step = max(samples, 1) * rows * SUB
        pts += [(t * step + e, 0) for t in (-2, -1, 1, 2) for e in (-1, 0, 1)]
        pts.append((0, 0))
        pq.append(pts)
    pq = np.asarray(pq, np.int32)
    beams = pq.shape[1]
    ok = np.ones((n, beams), bool)
    ok[:, 3::7] = False
    clamp_q = 8192
    cfg = MapConfig(grid=g, cell_m=0.1, beams=beams, clamp_q=clamp_q, coarse=coarse,
                    free_samples=samples, quant_shift=min_quant_shift(clamp_q, beams))
    if saturated:
        lo = np.where(np.add.outer(np.arange(g), np.arange(g)) % 2 == 0, clamp_q, -clamp_q)
        lo = np.repeat(lo[None].astype(np.int32), n, 0)
    else:
        lo = rng.integers(-clamp_q, clamp_q + 1, (n, g, g), np.int32)
    name = f"stripe_edges_g{g}_n{n}_rows{rows}_s{samples}" + ("_saturated" if saturated else "")
    return name, cfg, lo, pose, pq, ok


def plan_for(local: int, cluster: int, g: int) -> tuple:
    """A B8 plan on ``cluster`` blocks of the kernel's threads, stripes of
    ceil(G / cluster) rows."""
    rows = -(-g // cluster)
    return local, cluster, smk.UPDATE_THREADS, rows, smk.update_bytes(local, rows, g)


def _entry(log_odds, pq, ok, posec, trig, out, cfg: MapConfig, plan):
    """The raw C entry on ``plan`` with its arguments made now."""
    dev = log_odds.device.index
    args = (log_odds.data_ptr(), pq.data_ptr(), ok.data_ptr(), posec.data_ptr(),
            trig.data_ptr(), out.data_ptr(), log_odds.shape[0], cfg.grid, pq.shape[1],
            cfg.hit_q, cfg.miss_q, cfg.clamp_q, cfg.free_samples, *plan, dev,
            current_stream(dev))
    # graftlint: disable=GL010 — timing tool: the raw C entry on a CUDA
    # tensor, measured beside its wrapper (never on a CPU tensor)
    return lambda: smk._B8(*args)


def launch_update(log_odds, pq, ok, posec, trig, out, cfg: MapConfig, plan) -> None:
    """Launch B8 on ``plan`` into ``out`` (contiguous CUDA tensors of the
    wrapper's dtypes and shapes); counts nothing."""
    _entry(log_odds, pq, ok, posec, trig, out, cfg, plan)()


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def _summary(xs: list) -> dict:
    return {"median": statistics.median(xs), "min": min(xs), "max": max(xs)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--iters", type=int, default=200)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("update_plans: no CUDA device")
    cs = _chip_smoke()
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    calls = {}
    for n in (4, 1):
        cfg, coarse, _fine, _mq = cs.match_tick(dev, n)
        want = smk.log_odds_update_plain(*coarse, cfg)
        own = smk.update_plan(n, cfg.grid, sms)
        plans = {"plan": own, "local_half": plan_for(1, max(1, own[1] // 2), cfg.grid),
                 "remote": plan_for(0, own[1], cfg.grid)}
        for what, plan in plans.items():
            out = torch.empty_like(coarse[0])
            fn = _entry(*coarse, out, cfg, plan)
            fn()
            if not torch.equal(out, want):
                raise SystemExit(f"update_plans: plan {plan} differs from the plain version")
            calls[(f"N{n}", what)] = (plan, fn)
    host = {k: [] for k in calls}
    events = {k: [] for k in calls}
    keys = list(calls)
    for r in range(args.rounds):
        for k in (keys if r % 2 == 0 else keys[::-1]):
            fn = calls[k][1]
            host[k].append(cs.host_us(fn, iters=args.iters))
            events[k].append(cs.cuda_ms(fn, iters=args.iters))
    rows = {}
    for (shape, what), (plan, fn) in calls.items():
        dms = [x for x in (cs.device_ms(fn) for _ in range(3)) if x is not None]
        rows.setdefault(shape, {})[what] = {
            "plan": plan, "host_us": _summary(host[(shape, what)]),
            "events_ms": _summary(events[(shape, what)]),
            "device_ms": _summary(dms) if dms else None,
        }
    print(json.dumps({"tool": "update_plans", "device": torch.cuda.get_device_name(0),
                      "rounds": args.rounds, "iters": args.iters, "plans": rows}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

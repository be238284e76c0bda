"""Fleet ticks/s of two checkouts of the repository, in alternating pairs.

    python3 rplidar_ros2_driver_tpu_torch/tools/fleet_ab.py \
        --baseline DIR [--pairs 20] [--ticks 200]

Needs one CUDA card.  ``DIR`` is another checkout of the repository, for
example the parent commit unpacked with ``git archive`` into ``build/``
(git-ignored).  One worker process per checkout imports that checkout's
package (its ``csrc/`` built into that checkout's ``build/``) and sets up
the fused ``FleetMapper`` on the card at config 12's geometry (256x256 at
0.05 m, 2048 beams) for N=4 streams (config 12's fleet tick) and N=1 (the
map replay's tick), fed config 12's drifting room from this checkout's
``chip_smoke.room_fleet_ticks``; each worker runs one turn of each shape to
warm up.  Then the workers take turns, both alive throughout: a turn is
``--ticks`` ticks of one shape through ``submit_points`` (the host feed,
the step, the closing device-to-host copy), timed on the host.  A pair is
one turn of each checkout back to back, the first alternating from pair
to pair.  After the pairs (a profiler session would slow the host for the
rest of the process) each worker times its matcher kernels B6
(``coarse_scores_kernel``), B7 (``fine_scores_kernel``) and B8
(``log_odds_update_kernel``) at both shapes on ``chip_smoke.match_tick``'s
inputs, its B2 (``sorted_replace_kernel``) at the chain's W=64, B=2048 on
a seeded window, its B3 (``sliding_median_kernel``) at the replay's W=64,
K=512, B=2048 stripe and its K=7 tail chunk, and its B5
(``shift_sad_kernel``) at the de-skew path's 8 slots x 17 shifts x 256
beams (``chip_smoke._b5_path_inputs``) with its host µs beside B4's (the
rasterizer, ``beam_min_kernel``) over 5 alternating rounds, each held
equal to its plain version: CUDA events ms per call, then device ms from
torch.profiler.  Prints one
JSON line per pair and shape, then one line with, per shape, the pairs
each checkout won, the medians of ticks/s and of ms per tick and the
distance between the quartiles of the baseline's ticks/s (its own
spread), and each checkout's kernel times, then the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SHAPES = (4, 1)


def worker(tree: str, ticks: int) -> None:
    """One checkout's mapper, answering one turn per line of stdin (the
    number of streams) with one JSON line."""
    sys.path.insert(0, tree)
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import numpy as np
    import torch

    import rplidar_ros2_driver_tpu_torch as pkg
    from rplidar_ros2_driver_tpu_torch.mapping.mapper import FleetMapper

    if not torch.cuda.is_available():
        raise SystemExit("fleet_ab: no CUDA device")
    here = Path(pkg.__file__).resolve().parents[1]
    if here != Path(tree).resolve():
        raise SystemExit(f"fleet_ab: imported the package from {here}, not {tree}")
    b = cs.MAPPING["beams"]
    runs = {}
    for n in SHAPES:
        room = cs.room_fleet_ticks(n, b, cs.MAPPING["ticks"])[0]
        mapper = FleetMapper(cs._map_params("cuda"), n, beams=b)
        mapper.precompile()
        runs[n] = (mapper, [room[k % len(room)] for k in range(ticks)],
                   np.ones((n, b), bool), np.ones((n,), np.int32))

    def turn(n: int) -> dict:
        mapper, feed, masks, live = runs[n]
        torch.cuda.synchronize()
        lat = []
        for pts in feed:
            t0 = time.perf_counter()
            mapper.submit_points(pts, masks, live)
            lat.append(time.perf_counter() - t0)
        return {"ticks_per_s": len(lat) / sum(lat), "p50_ms": statistics.median(lat) * 1e3}

    def kernels() -> dict:
        from rplidar_ros2_driver_tpu_torch.ops import deskew_kernels as dk
        from rplidar_ros2_driver_tpu_torch.ops import median_kernels as mk
        from rplidar_ros2_driver_tpu_torch.ops import scan_match_kernels as smk

        dev = torch.device("cuda", 0)
        out = {}
        for n in SHAPES:
            cfg, coarse, fine, mq = cs.match_tick(dev, n)
            b6 = (lambda c=coarse, g=cfg: smk.coarse_scores_kernel(*c, g))
            b7 = (lambda m=mq, f=fine, g=cfg: smk.fine_scores_kernel(m, *f, g))
            b8 = (lambda c=coarse, g=cfg: smk.log_odds_update_kernel(*c, g))
            mq_k, sc_k = b6()
            mq_p, sc_p = smk.coarse_scores_plain(*coarse, cfg)
            if not (torch.equal(mq_k, mq_p) and torch.equal(sc_k, sc_p)
                    and torch.equal(b7(), smk.fine_scores_plain(mq, *fine, cfg))
                    and torch.equal(b8(), smk.log_odds_update_plain(*coarse, cfg))):
                raise SystemExit(f"fleet_ab: a kernel differs from its plain version, N={n}")
            out[f"N{n}"] = {k: {"ms": cs.cuda_ms(fn), "device_ms": cs.device_ms(fn)}
                            for k, fn in (("coarse_scores", b6), ("fine_scores", b7),
                                          ("log_odds_update", b8))}
        w, b = cs.GEOMETRY["window"], cs.GEOMETRY["beams"]
        win = torch.from_numpy(cs._median_fixtures(np.random.default_rng(0), w, b)["random_inf"])
        win = win.to(dev)
        sor, old, new = torch.sort(win, dim=0).values, win[5].clone(), win[9].clone()
        b2 = (lambda: mk.sorted_replace_kernel(sor, old, new))
        if not all(torch.equal(x, y) for x, y in zip(b2(), mk.sorted_replace_plain(sor, old, new))):
            raise SystemExit("fleet_ab: B2 differs from its plain version")
        out["chain"] = {"sorted_replace": {"ms": cs.cuda_ms(b2), "device_ms": cs.device_ms(b2)}}
        # B3 at the replay's stripe and its K=7 tail chunk
        w3, k3, b3 = cs.REPLAY["window"], cs.REPLAY["chunk"], cs.REPLAY["beams"]
        rng = np.random.default_rng(1)
        for name, k in (("sliding_median", k3), ("sliding_median_tail_k7", 7)):
            ext = torch.from_numpy(cs._median_fixtures(rng, w3 + k, b3)["ties_1mm"]).to(dev)
            fn = (lambda e=ext: mk.sliding_median_kernel(e, w3))
            if not torch.equal(fn(), mk.sliding_median_plain(ext, w3)):
                raise SystemExit(f"fleet_ab: B3 differs from its plain version, K={k}")
            out["chain"][name] = {"ms": cs.cuda_ms(fn, iters=50),
                                  "device_ms": cs.device_ms(fn, iters=20)}
        # B5 at the de-skew path's shift search, its host µs beside B4's
        # (the rasterizer) in alternating rounds
        prev, cur, cands = cs._b5_path_inputs(rng, dev)
        rb, rv, nb = cs._b4_path_inputs(rng, dev)["raster"]
        b5 = (lambda: dk.shift_sad_kernel(prev, cur, cands, 16, 2048))
        b4 = (lambda: dk.beam_min_kernel(rb, rv, nb))
        if not torch.equal(b5(), dk.shift_sad_plain(prev, cur, cands, 16, 2048)):
            raise SystemExit("fleet_ab: B5 differs from its plain version")
        host = {"shift_sad": [], "beam_min_raster": []}
        for r in range(5):
            for name, fn in (("shift_sad", b5), ("beam_min_raster", b4))[:: 1 if r % 2 == 0 else -1]:
                host[name].append(cs.host_us(fn))
        out["deskew"] = {name: {"ms": cs.cuda_ms(fn), "host_us": statistics.median(host[name])}
                         for name, fn in (("shift_sad", b5), ("beam_min_raster", b4))}
        for name, fn in (("shift_sad", b5), ("beam_min_raster", b4)):
            out["deskew"][name]["device_ms"] = cs.device_ms(fn)
        return out

    for n in SHAPES:
        turn(n)
    print("ready", flush=True)
    for line in iter(sys.stdin.readline, ""):
        got = kernels() if line.strip() == "kernels" else turn(int(line))
        print(json.dumps(got), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", help="the other checkout's root")
    ap.add_argument("--pairs", type=int, default=20)
    ap.add_argument("--ticks", type=int, default=200, help="ticks per turn")
    ap.add_argument("--worker", help=argparse.SUPPRESS)  # one checkout, in a child process
    args = ap.parse_args(argv)
    if args.worker:
        worker(args.worker, args.ticks)
        return 0
    if not args.baseline:
        ap.error("--baseline is required")
    trees = {"baseline": str(Path(args.baseline).resolve()), "this": str(ROOT)}
    procs = {}
    try:
        for which, tree in trees.items():
            procs[which] = subprocess.Popen(
                [sys.executable, __file__, "--worker", tree, "--ticks", str(args.ticks)],
                stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        for which, proc in procs.items():
            if proc.stdout.readline().strip() != "ready":
                raise SystemExit(f"fleet_ab: the {which} worker did not start")

        def turn(which: str, n) -> dict:
            proc = procs[which]
            proc.stdin.write(f"{n}\n")
            proc.stdin.flush()
            line = proc.stdout.readline()
            if not line:
                raise SystemExit(f"fleet_ab: the {which} worker stopped")
            return json.loads(line)

        rows = {n: [] for n in SHAPES}
        for k in range(args.pairs):
            order = ("baseline", "this") if k % 2 == 0 else ("this", "baseline")
            for n in SHAPES:
                pair = {which: turn(which, n) for which in order}
                pair.update(pair=k, streams=n, first=order[0])
                rows[n].append(pair)
                print(json.dumps(pair), flush=True)
        kernel_ms = {which: turn(which, "kernels") for which in trees}
    finally:
        for proc in procs.values():
            if proc.stdin:
                proc.stdin.close()
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
    summary = {}
    for n, pairs in rows.items():
        won = sum(p["this"]["ticks_per_s"] > p["baseline"]["ticks_per_s"] for p in pairs)
        q1, _, q3 = statistics.quantiles([p["baseline"]["ticks_per_s"] for p in pairs], n=4)
        summary[f"N{n}"] = {
            "pairs": len(pairs), "this_won": won, "baseline_won": len(pairs) - won,
            "baseline_quartile_spread": q3 - q1,
            **{f"{which}_{f}": statistics.median(p[which][f] for p in pairs)
               for which in trees for f in ("ticks_per_s", "p50_ms")},
        }
    print(json.dumps({"summary": summary, "ticks_per_turn": args.ticks, "kernels": kernel_ms}),
          flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

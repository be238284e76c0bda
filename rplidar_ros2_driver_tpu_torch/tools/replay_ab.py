"""Config-7 replay times of two checkouts of the repository, in alternating pairs.

    python3 rplidar_ros2_driver_tpu_torch/tools/replay_ab.py \
        --baseline DIR [--pairs 10] [--reps 5]

Needs one CUDA card.  ``DIR`` is another checkout of the repository, for
example the parent commit unpacked with ``git archive`` into ``build/``
(git-ignored).  One worker process per checkout imports that checkout's
package (its ``csrc/`` built into that checkout's ``build/``) and runs the
offline replay at config 7's geometry (``chip_smoke.REPLAY``: W=64, 2048
beams, 256x256 at 0.25 m, chunks of 512) on 519 seeded 3200-point
revolutions (``chip_smoke.make_revolutions``): one full chunk and a 7-scan
tail, both packed and uploaded once.  A turn is ``--reps`` replays, each
from a fresh state through ``ops.filters.compact_filter_scan`` (B3 once a
chunk), timed with CUDA events per chunk; then one ``replay_through_chain``
(host packing, upload and the closing copy included) timed on the host.
A pair is one turn of each checkout back to back, the first alternating
from pair to pair; the two checkouts' ranges and final states must be
equal.  Prints one JSON line per pair, then one line with the pairs each
checkout won and the medians of each time, then the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FIELDS = ("chunk_ms", "tail_ms", "replay_ms", "through_chain_ms")


def worker(tree: str, reps: int) -> None:
    """One checkout's replay, answering one turn per line of stdin with
    one JSON line."""
    sys.path.insert(0, tree)
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import numpy as np
    import torch

    import rplidar_ros2_driver_tpu_torch as pkg
    from rplidar_ros2_driver_tpu_torch.filters.chain import config_from_params
    from rplidar_ros2_driver_tpu_torch.ops import filters as tf
    from rplidar_ros2_driver_tpu_torch.replay import replay_through_chain

    if not torch.cuda.is_available():
        raise SystemExit("replay_ab: no CUDA device")
    here = Path(pkg.__file__).resolve().parents[1]
    if here != Path(tree).resolve():
        raise SystemExit(f"replay_ab: imported the package from {here}, not {tree}")
    rp = cs.REPLAY
    dev = torch.device("cuda", 0)
    params = cs._replay_params("cuda")
    cfg = config_from_params(params, rp["beams"], platform="cuda")
    revs = cs.make_revolutions(7, rp["revs"] - 1, rp["points"])
    chunks = []
    for i in range(0, len(revs), rp["chunk"]):
        seq, counts = tf.pack_host_scans_compact(revs[i : i + rp["chunk"]], rp["capacity"])
        chunks.append((torch.from_numpy(seq.view(np.int16)).to(dev),
                       torch.from_numpy(counts).to(dev)))
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in chunks]

    def replay():
        state, outs = tf.FilterState.for_config(cfg, device=dev), []
        for (seq, counts), (ev0, ev1) in zip(chunks, events):
            ev0.record()
            state, ranges = tf.compact_filter_scan(state, seq, counts, cfg)
            ev1.record()
            outs.append(ranges)
        return state, outs

    def turn() -> dict:
        torch.cuda.synchronize()
        per_chunk = [[] for _ in chunks]
        for _ in range(reps):
            state, outs = replay()
            torch.cuda.synchronize()
            for i, (ev0, ev1) in enumerate(events):
                per_chunk[i].append(ev0.elapsed_time(ev1))
        digest = hashlib.sha256(torch.cat(outs).cpu().numpy().tobytes())
        for v in state.to_numpy().values():
            digest.update(np.ascontiguousarray(v).tobytes())
        t0 = time.perf_counter()
        replay_through_chain(revs, params, beams=rp["beams"], capacity=rp["capacity"],
                             chunk=rp["chunk"])
        through = (time.perf_counter() - t0) * 1e3
        chunk_ms = statistics.median(per_chunk[0])
        tail_ms = statistics.median(per_chunk[-1])
        return {"chunk_ms": chunk_ms, "tail_ms": tail_ms, "replay_ms": chunk_ms + tail_ms,
                "through_chain_ms": through, "digest": digest.hexdigest()}

    turn()
    print("ready", flush=True)
    for _ in iter(sys.stdin.readline, ""):
        print(json.dumps(turn()), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", help="the other checkout's root")
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--reps", type=int, default=5, help="replays per turn")
    ap.add_argument("--worker", help=argparse.SUPPRESS)  # one checkout, in a child process
    args = ap.parse_args(argv)
    if args.worker:
        worker(args.worker, args.reps)
        return 0
    if not args.baseline:
        ap.error("--baseline is required")
    trees = {"baseline": str(Path(args.baseline).resolve()), "this": str(ROOT)}
    procs = {}
    rows = []
    try:
        for which, tree in trees.items():
            procs[which] = subprocess.Popen(
                [sys.executable, __file__, "--worker", tree, "--reps", str(args.reps)],
                stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        for which, proc in procs.items():
            if proc.stdout.readline().strip() != "ready":
                raise SystemExit(f"replay_ab: the {which} worker did not start")

        def turn(which: str) -> dict:
            proc = procs[which]
            proc.stdin.write("turn\n")
            proc.stdin.flush()
            line = proc.stdout.readline()
            if not line:
                raise SystemExit(f"replay_ab: the {which} worker stopped")
            return json.loads(line)

        for k in range(args.pairs):
            order = ("baseline", "this") if k % 2 == 0 else ("this", "baseline")
            pair = {which: turn(which) for which in order}
            if pair["this"]["digest"] != pair["baseline"]["digest"]:
                raise SystemExit("replay_ab: the two checkouts' replays differ")
            pair.update(pair=k, first=order[0])
            rows.append(pair)
            print(json.dumps(pair), flush=True)
    finally:
        for proc in procs.values():
            if proc.stdin:
                proc.stdin.close()
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
    summary = {"pairs": len(rows), "reps": args.reps}
    for f in FIELDS:
        summary[f"this_faster_{f}"] = sum(p["this"][f] < p["baseline"][f] for p in rows)
        for which in trees:
            summary[f"{which}_{f}"] = statistics.median(p[which][f] for p in rows)
    print(json.dumps({"summary": summary}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""``chip_smoke.py``'s default run timed phase by phase, in one checkout or two.

    python3 rplidar_ros2_driver_tpu_torch/tools/smoke_phases.py \
        [--baseline DIR] [--order bc] [--out build/smoke_phases]

Needs one CUDA card.  Runs the default ``python3 chip_smoke.py`` of this
checkout (``c``) and of ``--baseline DIR`` (``b``: another checkout, for
example the parent commit unpacked with ``git archive`` into ``build/``,
git-ignored) one after the other in the order of ``--order``, each in a
fresh process from its checkout's root, and writes each run's standard
output and error to ``OUT/<n>_<side>.out`` / ``.err``.

Per run it records the exit code, the process's wall seconds, the
script's own seconds (the kernels line's ``seconds``: from the device
phase to the kernels line) and, per phase name, two figures:

* ``span_s``: the seconds from the previous phase line to each of this
  phase's lines, stamped as the lines arrive, summed.  Any checkout has
  them.  A phase that prints its line only after a later phase's work
  leaves its earlier time in the span of the line printed before its own;
* ``seconds`` / ``cpu_seconds`` / ``refs_pending``: the last of the
  phase's lines' own, where its checkout's phase lines carry them.

Then one JSON line per run, one line with the change's script seconds over
the baseline's for each adjacent pair, and the card's name and power
limit (nvidia-smi) as the last line.  The full tables go to
``OUT/summary.json``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
OWN = ("seconds", "cpu_seconds", "refs_pending")


def phase_table(stamped) -> tuple:
    """(script seconds, {phase: figures}) from a run's (seconds since its
    start, line) pairs; the kernels line counts as the phase ``kernels_line``."""
    script_s, table, last = None, {}, 0.0
    for t, line in stamped:
        try:
            obj = json.loads(line)
        except ValueError:
            continue
        if not isinstance(obj, dict):
            continue
        if "kernels" in obj and "phase" not in obj:
            script_s, name = obj.get("seconds"), "kernels_line"
        elif "phase" in obj:
            name = obj["phase"]
        else:
            continue
        row = table.setdefault(name, {"span_s": 0.0})
        row["span_s"] += t - last
        last = t
        if name != "kernels_line":
            row.update({k: obj[k] for k in OWN if k in obj})
    return script_s, table


def run_side(tree: Path, stem: Path) -> dict:
    """One default run of ``tree``'s chip_smoke.py; its record."""
    t0 = time.perf_counter()
    stamped = []
    with open(stem.with_suffix(".out"), "wb") as out, open(stem.with_suffix(".err"), "wb") as err:
        proc = subprocess.Popen([sys.executable, "chip_smoke.py"], cwd=tree,
                                stdout=subprocess.PIPE, stderr=err)
        for line in iter(proc.stdout.readline, b""):
            stamped.append((time.perf_counter() - t0, line.decode(errors="replace")))
            out.write(line)
        rc = proc.wait()
    script_s, phases = phase_table(stamped)
    return {"tree": str(tree), "rc": rc, "wall_s": time.perf_counter() - t0,
            "script_s": script_s, "phases": phases}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", default=None, help="another checkout (side b)")
    ap.add_argument("--order", default="c", help="the sides in turn: b and c, e.g. bc or bccb")
    ap.add_argument("--out", default="build/smoke_phases")
    args = ap.parse_args(argv)
    if "b" in args.order and not args.baseline:
        ap.error("--order with b needs --baseline")
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    trees = {"b": Path(args.baseline or ROOT).resolve(), "c": ROOT}
    runs = []
    for n, side in enumerate(args.order):
        rec = run_side(trees[side], out / f"{n}_{side}")
        rec["side"] = side
        runs.append(rec)
        print(json.dumps({k: rec[k] for k in ("side", "rc", "wall_s", "script_s")}), flush=True)
    pairs = []
    for a, b in zip(runs, runs[1:]):
        if {a["side"], b["side"]} == {"b", "c"} and a["script_s"] and b["script_s"]:
            c, base = (a, b) if a["side"] == "c" else (b, a)
            pairs.append({"change_over_baseline": c["script_s"] / base["script_s"],
                          "change_s": c["script_s"], "baseline_s": base["script_s"]})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()
    summary = {"card": smi[0] if smi else None, "runs": runs, "pairs": pairs}
    (out / "summary.json").write_text(json.dumps(summary, indent=1))
    print(json.dumps({"pairs": pairs}), flush=True)
    print(summary["card"], flush=True)
    return 0 if all(r["rc"] == 0 for r in runs) else 1


if __name__ == "__main__":
    raise SystemExit(main())

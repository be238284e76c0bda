"""Runner + baseline reconciliation + CLI entry."""

from __future__ import annotations

import argparse
import json
import os
import sys

from rplidar_ros2_driver_tpu_torch.tools.graftlint.config import (
    LintConfig,
    load_baseline,
    load_config,
)
from rplidar_ros2_driver_tpu_torch.tools.graftlint.model import Finding, RepoIndex
from rplidar_ros2_driver_tpu_torch.tools.graftlint.rules import ALL_RULES, RULES_BY_ID


def repo_root() -> str:
    """Default root: the repo this package is installed from (three
    levels above this file), overridable with --root."""
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.dirname(os.path.dirname(os.path.dirname(here)))


def run_lint(
    root: str | None = None,
    cfg: LintConfig | None = None,
    jobs: int = 0,
) -> tuple[list[Finding], list[Finding], list[dict]]:
    """Run every rule.  Returns ``(all_findings, new, stale)`` where
    ``new`` are findings absent from the baseline and ``stale`` are
    baseline entries that no longer fire (both fail the run — a
    baseline must describe the tree exactly).  ``jobs > 1`` parses
    modules in a process pool; the rules themselves (cross-module) run
    after that barrier and their output is identical either way."""
    root = root or repo_root()
    cfg = cfg or load_config(root)
    index = RepoIndex(cfg, jobs=jobs)
    findings: list[Finding] = []
    for rule in ALL_RULES:
        findings.extend(rule(index))
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    baseline = load_baseline(root, cfg)
    base_keys = {(e["rule"], e["path"], e["message"]) for e in baseline}
    new = [f for f in findings if f.key() not in base_keys]
    seen = {f.key() for f in findings}
    stale = [
        e for e in baseline
        if (e["rule"], e["path"], e["message"]) not in seen
    ]
    return findings, new, stale


def _jobs_arg(value: str) -> int:
    if value == "auto":
        return os.cpu_count() or 1
    return int(value)


def explain(rule_id: str, root: str, jobs: int = 0) -> int:
    """``--explain GLxxx``: print the rule's rationale (its docstring)
    and, for every current finding of that rule, the concrete witness —
    the interval trace, the unlocked write pair, or the call path that
    proves the finding.  Informational: exit 0 regardless (the gating
    run is the flagless one)."""
    rule_id = rule_id.upper()
    fn = RULES_BY_ID.get(rule_id)
    if fn is None:
        print(f"unknown rule {rule_id!r} (known: {', '.join(RULES_BY_ID)})")
        return 2
    print(fn.__doc__.strip())
    print()
    findings, _new, _stale = run_lint(root, jobs=jobs)
    mine = [f for f in findings if f.rule == rule_id]
    if not mine:
        print(f"{rule_id}: no findings on this tree.")
        return 0
    for f in mine:
        print(f"{f.path}:{f.line}: {f.message}")
        if f.witness:
            print(f"    witness: {f.witness}")
    print(f"\n{rule_id}: {len(mine)} finding(s).")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m rplidar_ros2_driver_tpu_torch.tools.graftlint",
        description="repo-native static analysis of the PyTorch package: "
        "host syncs, bit-exactness, the no-fallback kernel rule, overflow/"
        "lock/read-path proofs and structural invariants (declarations in "
        "tools/graftlint/graftlint.toml)",
    )
    p.add_argument("--json", action="store_true", help="machine output")
    p.add_argument(
        "--json-out", default=None, metavar="PATH",
        help="also write the machine output to PATH (CI artifact)",
    )
    p.add_argument(
        "--github", action="store_true",
        help="emit GitHub workflow annotations (::error file=...,line=...)"
        " for new findings, so they land inline on PRs",
    )
    p.add_argument(
        "--explain", default=None, metavar="GLXXX",
        help="print a rule's rationale plus the concrete witness "
        "(interval trace / unlocked write pair / call path) for each of "
        "its current findings, then exit 0",
    )
    p.add_argument(
        "--jobs", default="0", type=_jobs_arg, metavar="N|auto",
        help="parse modules with N worker processes (auto = cpu count); "
        "default serial",
    )
    p.add_argument("--root", default=None, help="repo root (default: auto)")
    args = p.parse_args(argv)

    root = args.root or repo_root()
    if args.explain:
        return explain(args.explain, root, jobs=args.jobs)
    findings, new, stale = run_lint(root, jobs=args.jobs)
    doc = {
        "findings": [vars(f) for f in findings],
        "new": [vars(f) for f in new],
        "stale_baseline": stale,
        "ok": not new and not stale,
    }
    if args.json_out:
        with open(args.json_out, "w", encoding="utf-8") as fh:
            json.dump(doc, fh, indent=2)
    if args.json:
        print(json.dumps(doc, indent=2))
    else:
        for f in new:
            print(f"{f.path}:{f.line}: {f.rule} {f.message}")
        for e in stale:
            print(
                f"stale baseline entry (no longer fires, remove it): "
                f"{e['rule']} {e['path']}: {e['message']}"
            )
        if args.github:
            for f in new:
                print(
                    f"::error file={f.path},line={f.line}::"
                    f"{f.rule} {f.message}"
                )
            for e in stale:
                print(
                    f"::error file={e['path']}::stale graftlint baseline "
                    f"entry: {e['rule']} {e['message']}"
                )
        n_base = len(findings) - len(new)
        print(
            f"graftlint: {len(findings)} finding(s), {n_base} baselined, "
            f"{len(new)} new, {len(stale)} stale"
        )
    return 1 if (new or stale) else 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())

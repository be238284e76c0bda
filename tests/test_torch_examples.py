"""The PyTorch package's examples (examples/torch/) keep running end to end.

Each runs on the CPU at the lengths of the JAX suite's tests/test_examples.py,
in process through its ``main(argv)`` (``multihost_fleet.py`` launches its
two gloo workers as subprocesses, as it does for a user).  Each must print
its outcome lines and return 0; the fleet gateway's sharded checkpoint must
restore into a fresh service that continues byte-equal.
"""

from __future__ import annotations

import importlib.util
import os

import pytest

from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "examples", "torch")


def _load(script: str):
    spec = importlib.util.spec_from_file_location(f"torch_example_{script[:-3]}",
                                                  os.path.join(EXAMPLES, script))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize(
    "script,extra,expect",
    [
        ("single_lidar.py", ["--seconds", "3"], "resumed: restore=True"),
        ("fleet_gateway.py", ["--ticks", "3"],
         "sharded checkpoint restore into a fresh service: ok (next tick equal: True)"),
        ("record_replay.py", ["--seconds", "2"], "chain replay: per-rev range images"),
        ("multihost_fleet.py", ["--ticks", "2"], "proc 1: done"),
    ],
    ids=lambda v: v[:-3] if isinstance(v, str) and v.endswith(".py") else "",
)
def test_example_runs(script, extra, expect, capsys):
    assert _load(script).main(["--cpu", *extra]) == 0
    out = capsys.readouterr().out
    assert expect in out, out


def test_examples_readme_lists_every_example():
    text = open(os.path.join(EXAMPLES, "README.md")).read()
    scripts = sorted(f for f in os.listdir(EXAMPLES) if f.endswith(".py"))
    assert scripts == ["fleet_gateway.py", "multihost_fleet.py", "record_replay.py",
                       "single_lidar.py"]
    for f in scripts:
        assert f"`{f}`" in text, f


def test_multihost_demo_backend_follows_the_cards(monkeypatch):
    import torch

    mod = _load("multihost_fleet.py")
    assert mod.demo_backend(cpu=True) == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert mod.demo_backend(cpu=False) == "gloo"  # two ranks on one card: gloo
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert mod.demo_backend(cpu=False) == "nccl"

"""graftlint of the PyTorch package: every rule fires on its positive
fixture and stays quiet on its negative twin, markers and suppressions
behave, baseline reconciliation is exact, the CLI's machine output does
not depend on ``--jobs``, the machinery shared with the JAX package's
linter gives identical findings on the same source — and the package's
real tree lints clean against its own declarations and baseline."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest

from rplidar_ros2_driver_tpu.tools.graftlint import run_lint as jax_run_lint
from rplidar_ros2_driver_tpu_torch.tools.graftlint import load_config, run_lint
from rplidar_ros2_driver_tpu_torch.tools.graftlint.config import DEFAULT_CONFIG
from rplidar_ros2_driver_tpu_torch.tools.graftlint.model import in_package
from rplidar_ros2_driver_tpu_torch.tools.graftlint.rules import ALL_RULES, RULES_BY_ID
from rplidar_ros2_driver_tpu_torch.tools.graftlint.runner import main, repo_root
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

PORT = "rplidar_ros2_driver_tpu_torch"
JAX = "rplidar_ros2_driver_tpu"

BASE_CONFIG = """
[tool.graftlint]
paths = ["pkg"]
static_params = ["cfg", "config", "self", ".*_h"]
host_annotations = ["Mode"]

[tool.graftlint.gl004]
zones = ["pkg/zone.py"]
int_returning = ["int_fn"]
int_names = ["counts_i", "d_q2", "rate_q8", "acc"]
float_names = ["fx", "meta"]
bool_names = ["ok"]

[tool.graftlint.gl007]
files = ["pkg/hot.py"]

[tool.graftlint.gl008]
params_module = "pkg/config.py"
params_yaml = "param.yaml"
unvalidated_params_ok = ["name"]
precompile_exempt = []

[tool.graftlint.gl011]
zones = ["pkg/fx.py", "pkg/fx_ok.py"]
sum_elems_default = 16384

[tool.graftlint.gl011.sum_elems]
"pkg/fx_ok.py" = 1024

[tool.graftlint.gl011.bounds]
d_q2 = [0, 262143]
rate_q8 = [-32768, 32767]
"""


# the same with one declared device step (GL001-GL003, GL008's reach)
DEV_CONFIG = BASE_CONFIG.replace(
    'host_annotations = ["Mode"]\n',
    'host_annotations = ["Mode"]\ndevice_roots = ["pkg/dev.py::step"]\n',
)


def _write(root, files: dict, config: str) -> str:
    """The fixture tree under ``root``, its declarations where the CLI
    looks for them (``--root`` alone points it at the tree)."""
    cfg_path = os.path.join(str(root), DEFAULT_CONFIG)
    os.makedirs(os.path.dirname(cfg_path), exist_ok=True)
    with open(cfg_path, "w") as f:
        f.write(config)
    for rel, src in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))
    return cfg_path


def _run(tmp_path, files: dict, config: str = BASE_CONFIG, jobs: int = 0):
    cfg_path = _write(tmp_path, files, config)
    return run_lint(str(tmp_path), cfg=load_config(str(tmp_path), cfg_path), jobs=jobs)


def _lint(tmp_path, files: dict, config: str = BASE_CONFIG):
    return _run(tmp_path, files, config)[0]


def _msgs(findings, rule):
    return [f.message for f in findings if f.rule == rule]


# ---------------------------------------------------------------------------
# every rule: a positive fixture and its negative twin
# ---------------------------------------------------------------------------

_KERNELS_OK = """
    import torch
    from rplidar_ros2_driver_tpu_torch.utils.launch import KernelEntry

    _B1 = KernelEntry("lib", "entry", [])

    def median_plain(x):
        return x.sort(0).values[0]

    def _launch_device(dev, what):
        if dev.type != "cuda":
            raise RuntimeError(f"no {what} kernel for device {dev}")

    def median_kernel(x):
        if not x.is_cuda:
            if x.device.type == "cpu":
                return median_plain(x)
            raise RuntimeError("no kernel for this device")
        out = x.new_empty(x.shape[1:])
        _B1(x.data_ptr(), out.data_ptr())
        return out

    def other_kernel(x):
        dev = x.device
        if dev.type == "cpu":
            return median_plain(x)
        _launch_device(dev, "other")
        _B1(x.data_ptr())
        return x
"""

# (rule, case id, files, substrings that must appear in the rule's
# messages — an empty tuple means the rule must stay quiet)
CASES = [
    ("GL001", "syncs", {"pkg/dev.py": """
        import torch

        def helper(x):
            return x.sum().item()

        def step(state, x):
            y = helper(x)
            torch.cuda.synchronize()
            return state + float(x) + y
    """}, (".item() in device-step-reachable helper", "torch.cuda.synchronize",
           "float(x) on a tensor argument of step")),
    ("GL001", "declared-and-host", {"pkg/dev.py": """
        import numpy as np
        from pkg.utils import guards

        def host_only(x):
            return x.cpu().numpy()  # not reachable from a device step

        def step(state, x, n: int, aux_h):
            with guards.declared_sync():
                k = x.sum().item()
            idx = np.flatnonzero(aux_h > 0).tolist()
            return state + k + int(n) + len(idx)
    """}, ()),
    ("GL002", "tensor-branch", {"pkg/dev.py": """
        def step(state, x):
            if x.sum() > 0:
                return state + x
            return state
    """}, ("Python `if` on tensor value `x.sum() > 0` in step",)),
    ("GL002", "host-branches", {"pkg/dev.py": """
        def step(state, x, mode: Mode, cfg, ms, counts_h):
            if cfg.enable and x.shape[0] > 4 and not x.is_cuda:
                x = x[:4]
            if ms is None or mode == Mode.FAST or counts_h.any():
                return state
            n = x.sum().item()
            if n > 3:
                return state + n
            return state + x
    """}, ()),
    ("GL003", "stale-alias", {"pkg/dev.py": """
        def step(state, x):
            state.ring.copy_(x)
            return state

        def use(state, x):
            old = state.ring
            step(state, x)
            return old + 1
    """}, ("`old` aliases `state` before step",)),
    ("GL003", "cloned-snapshot", {"pkg/dev.py": """
        def step(state, x):
            state.ring.copy_(x)
            return state

        def use(state, x):
            old = state.ring.clone()
            before = state.ring
            total = before.sum()
            before = None
            step(state, x)
            return old + total
    """}, ()),
    ("GL004", "float-reduce-and-cast", {"pkg/zone.py": """
        import torch

        def score(fx):
            total = torch.sum(fx) + (fx @ fx)
            return total.to(torch.int32) + fx.long()
    """}, ("float reduction `sum`", "float reduction `@`",
           "float→int cast `total.to(torch.int32)`", "float→int cast `fx.long()`")),
    ("GL004", "int-reduce-and-policed", {"pkg/zone.py": """
        import math
        import torch

        i32 = torch.int32

        def score(fx, ok):
            n = ok.to(torch.int32).sum()
            v = torch.sum(int_fn(fx), dim=0)
            w = fx.sum(dtype=i32) + math.prod(fx.shape)
            # graftlint: policed — fixture clamps fx upstream
            q = fx.to(torch.int32)
            return n + v + w + q

        def int_fn(fx):
            return (fx > 0).to(torch.int32)
    """}, ()),
    ("GL005", "float-into-int", {"pkg/zone.py": """
        def scale(counts_i):
            return counts_i * 0.5
    """}, ("bare Python float scalar `0.5` mixed into int tensor `counts_i`",)),
    ("GL005", "explicit-conversion", {"pkg/zone.py": """
        import torch

        def scale(fx, counts_i):
            return fx * 0.5 + counts_i.to(torch.float32) * 0.25 + counts_i * 2
    """}, ()),
    ("GL006", "unfrozen-config", {"pkg/m.py": """
        import dataclasses

        @dataclasses.dataclass
        class StepConfig:
            n: int = 4
    """}, ("dataclass StepConfig",)),
    ("GL006", "frozen-config", {"pkg/m.py": """
        import dataclasses

        @dataclasses.dataclass(frozen=True)
        class StepConfig:
            n: int = 4

        # graftlint: disable=GL006 — fixture: mutable device state, no step key
        @dataclasses.dataclass
        class SimConfig:
            health: int = 0
    """}, ()),
    ("GL007", "hot-alloc", {"pkg/hot.py": """
        import numpy as np
        import torch

        # graftlint: hot-loop
        def dispatch(self, m, ref):
            a = torch.zeros((m, 4), dtype=torch.uint8)
            b = np.full((m,), 0, np.uint8)
            c = ref.new_empty((m,))
            d = torch.from_numpy(b)
            return a, b, c, d

        def cold_setup(m):
            return torch.zeros((m, 4))
    """}, ("torch.zeros() inside", "np.full() inside", "x.new_empty() inside",
           "torch.from_numpy() inside")),
    ("GL007", "recycled-staging", {"pkg/hot.py": """
        import numpy as np
        import torch

        def dispatch(self, m, raw):
            # graftlint: hot-loop
            pair = self.staging.take(m)
            view = np.frombuffer(raw, np.uint8)
            pair[0][:m] = torch.frombuffer(raw, dtype=torch.uint8)
            # graftlint: end-hot-loop
            scratch = torch.zeros((m,))
            return view, scratch
    """}, ()),
    ("GL008", "drift", {
        "pkg/config.py": """
            import dataclasses

            @dataclasses.dataclass
            class DriverParams:
                name: str = "x"
                rate: int = 7
                ghost: int = 1

                def validate(self):
                    if self.rate < 0:
                        raise ValueError("rate")
        """,
        "param.yaml": """
            name: x
            rate: 7
            stale_key: true
        """,
        "pkg/dev.py": """
            def step(state, x):
                return state + x
        """,
    }, ("DriverParams.ghost is missing", "DriverParams.ghost is never validated",
        "`stale_key`", "device step step is not reachable from any precompile()")),
    ("GL008", "consistent", {
        "pkg/config.py": """
            import dataclasses

            @dataclasses.dataclass
            class DriverParams:
                name: str = "x"
                rate: int = 7

                def validate(self):
                    if self.rate < 0:
                        raise ValueError("rate")
        """,
        "param.yaml": """
            rplidar_node:
              ros__parameters:
                name: x
                rate: 7
        """,
        "pkg/dev.py": """
            def step(state, x):
                return state + x

            class Engine:
                def precompile(self):
                    step(0, 0)
        """,
    }, ()),
    ("GL009", "constant-retry", {"pkg/m.py": """
        import time

        def reconnect(dev):
            while True:
                if dev.connect():
                    break
                time.sleep(1.0)
    """}, ("unbounded retry loop in reconnect",)),
    ("GL009", "capped-and-backoff", {"pkg/m.py": """
        import time

        def capped(dev):
            attempt = 0
            while True:
                if dev.connect():
                    break
                attempt += 1
                if attempt >= 5:
                    raise RuntimeError("gave up")
                time.sleep(1.0)

        def backoff(dev, policy):
            while True:
                if dev.connect():
                    break
                time.sleep(policy.next_delay())
    """}, ()),
    ("GL010", "no-fallback-violations", {
        "pkg/tools/timing.py": """
            from rplidar_ros2_driver_tpu_torch.utils.launch import KernelEntry

            _RAW = KernelEntry("lib", "entry", [])

            def time_raw(x):
                _RAW(x.data_ptr())
        """,
        "pkg/ops/bad_kernels.py": """
            from rplidar_ros2_driver_tpu_torch.utils.launch import KernelEntry

            _B1 = KernelEntry("lib", "entry", [])

            def bad_plain(x):
                return x

            def no_cpu_kernel(x):
                if x.device.type != "cuda":
                    raise RuntimeError("cuda only")
                _B1(x.data_ptr())

            def no_raise_kernel(x):
                if x.device.type == "cpu":
                    return bad_plain(x)
                _B1(x.data_ptr())

            def fallback(x):
                try:
                    return no_raise_kernel(x)
                except RuntimeError:
                    return bad_plain(x)
        """,
    }, ("compiled binding `_RAW` called in time_raw outside an ops/*_kernels.py",
        "kernel wrapper no_cpu_kernel launches `_B1` without a preceding CPU branch",
        "kernel wrapper no_raise_kernel launches `_B1` without a preceding non-CUDA",
        "except handler in fallback falls back to bad_plain")),
    ("GL010", "sanctioned-wrappers", {"pkg/ops/median_kernels.py": _KERNELS_OK},
     ()),
    ("GL011", "unprovable", {"pkg/fx.py": """
        def scale(d_q2, rate_q8, acc, idx):
            total = d_q2 * rate_q8
            acc.index_add_(0, idx, d_q2)
            return total
    """}, ("product `d_q2 * rate_q8` in scale is not provably inside int32",
           "scatter-add `acc.index_add_(0, idx, d_q2)`")),
    ("GL011", "proved", {"pkg/fx_ok.py": """
        import torch

        def scale(d_q2, rate_q8, idx):
            r = torch.clamp(rate_q8, -128, 127)
            s = rate_q8.clamp(min=-64, max=64)
            acc = torch.zeros((4,), dtype=torch.int32)
            acc.index_add_(0, idx, d_q2)
            return d_q2 * r + d_q2 * s + torch.div(d_q2, 4, rounding_mode="floor") * 8
    """}, ()),
    ("GL012", "send-tear", {"pkg/dev.py": """
        import threading

        class SimDevice:
            def __init__(self):
                self._tx_lock = threading.Lock()
                self._tx_buf = b""

            def start(self):
                threading.Thread(target=self._rx_loop, daemon=True).start()
                threading.Thread(target=self._stream_loop, daemon=True).start()

            def _send(self, payload):
                self._tx_buf = payload

            def _rx_loop(self):
                self._send(b"descriptor")

            def _stream_loop(self):
                self._send(b"scan")
    """}, ("self._tx_buf of SimDevice is written from 2 execution contexts",)),
    ("GL012", "single-context", {"pkg/dev.py": """
        import threading

        class Dev:
            def __init__(self):
                self._t = None

            def start(self):
                self._t = threading.Thread(target=self._loop)
                self._t.start()

            def _loop(self):
                pass
    """}, ()),
    ("GL013", "dispatching-read", {"pkg/serve.py": """
        import torch

        # graftlint: read-path
        def read_grid(snap):
            return helper(snap) + snap.counts.to("cpu")

        def helper(snap):
            return torch.as_tensor(snap.grid)
    """}, ("dispatching call `torch.as_tensor` in helper", "dispatching call `snap.counts.to`")),
    ("GL013", "pure-host-read", {"pkg/serve.py": """
        import numpy as np
        import torch

        # graftlint: read-path
        def read_grid(snap):
            if torch.cuda.is_available():
                pass
            return np.repeat(snap.values, snap.runs)

        def hot_path(x):
            return torch.as_tensor(x)  # not on a read path
    """}, ()),
]


@pytest.mark.parametrize(
    "rule,files,expect", [(r, f, e) for r, _i, f, e in CASES],
    ids=[f"{r}-{i}" for r, i, _f, _e in CASES],
)
def test_rule_fixture(tmp_path, rule, files, expect):
    config = DEV_CONFIG if "pkg/dev.py" in files else BASE_CONFIG
    msgs = _msgs(_lint(tmp_path, files, config), rule)
    if not expect:
        assert msgs == [], msgs
    for want in expect:
        assert any(want in m for m in msgs), (want, msgs)


def test_every_code_has_a_positive_and_a_negative_fixture():
    codes = {r for r, *_ in CASES}
    assert codes == set(RULES_BY_ID) and len(ALL_RULES) == 13
    for code in codes:
        kinds = {bool(e) for r, _i, _f, e in CASES if r == code}
        assert kinds == {True, False}, code


# ---------------------------------------------------------------------------
# markers
# ---------------------------------------------------------------------------

_TIMED = """
    import time

    def watchdog(dev):
        {marker}
        while True:
            dev.kick()
            time.sleep(5.0)
"""


@pytest.mark.parametrize("marker,suppressed", [
    ("# graftlint: disable=GL009 — fixture-sanctioned daemon poll", True),
    ("# graftlint: disable=GL001, GL009 - several codes, ascii dash", True),
    ("# graftlint: disable=GL009", False),          # no reason: ignored
    ("# graftlint: disable=GL001 — another rule", False),
])
def test_suppression_needs_its_code_and_a_reason(tmp_path, marker, suppressed):
    fs = _lint(tmp_path, {"pkg/m.py": _TIMED.format(marker=marker)})
    assert (not _msgs(fs, "GL009")) is suppressed


@pytest.mark.parametrize("marker,quiet", [
    ("# graftlint: policed — fixture: fx clamped upstream", True),
    ("# graftlint: policed", False),
])
def test_policed_marker_blesses_a_cast(tmp_path, marker, quiet):
    fs = _lint(tmp_path, {"pkg/zone.py": f"""
        import torch

        def q(fx):
            {marker}
            return fx.to(torch.int32)
    """})
    assert (not _msgs(fs, "GL004")) is quiet


def test_hot_loop_def_marker_does_not_absorb_a_later_pair(tmp_path):
    fs = _lint(tmp_path, {"pkg/hot.py": """
        import numpy as np

        # graftlint: hot-loop
        def dispatch(self, m):
            return m + 1

        def unrelated(m):
            return np.zeros((m,), np.uint8)  # NOT hot: must stay quiet

        def other(self, m, raw):
            # graftlint: hot-loop
            view = np.frombuffer(raw, np.uint8)
            # graftlint: end-hot-loop
            return view
    """})
    assert _msgs(fs, "GL007") == []


def test_read_path_marker_names_the_next_def(tmp_path):
    cfg_path = _write(tmp_path, {"pkg/serve.py": """
        class Map:
            # graftlint: read-path
            @property
            def status(self):
                return {}

            def write(self):
                pass
    """}, BASE_CONFIG)
    from rplidar_ros2_driver_tpu_torch.tools.graftlint import RepoIndex

    index = RepoIndex(load_config(str(tmp_path), cfg_path))
    assert index.modules["pkg/serve.py"].read_path_funcs == ("Map.status",)


# ---------------------------------------------------------------------------
# baseline reconciliation and the CLI
# ---------------------------------------------------------------------------

_RETRY = {"pkg/m.py": """
    import time

    def reconnect(dev):
        while True:
            if dev.connect():
                break
            time.sleep(1.0)
"""}


def _baseline(tmp_path, entries):
    path = tmp_path / os.path.dirname(DEFAULT_CONFIG) / "graftlint.baseline.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps({"findings": entries}))


def test_baseline_new_and_stale_both_fail(tmp_path):
    findings, new, stale = _run(tmp_path, _RETRY)
    target = [f for f in findings if f.rule == "GL009"][0]
    assert new == findings
    _baseline(tmp_path, [
        {"rule": target.rule, "path": target.path, "message": target.message,
         "justification": "fixture: legacy loop, fix queued"},
        {"rule": "GL009", "path": "pkg/gone.py", "message": "no longer fires",
         "justification": "stale entry"},
    ])
    findings, new, stale = _run(tmp_path, _RETRY)
    assert new == [] and [e["path"] for e in stale] == ["pkg/gone.py"]
    args = ["--root", str(tmp_path)]
    assert main(args) == 1  # the stale entry fails the gate
    _baseline(tmp_path, [
        {"rule": target.rule, "path": target.path, "message": target.message,
         "justification": "fixture: legacy loop, fix queued"},
    ])
    assert main(args) == 0
    (tmp_path / "pkg" / "m.py").write_text("x = 1\n")  # fixed: entry goes stale
    assert main(args) == 1


def test_baseline_entry_requires_justification(tmp_path):
    _baseline(tmp_path, [{"rule": "GL001", "path": "a", "message": "b"}])
    with pytest.raises(ValueError, match="justification"):
        _run(tmp_path, {"pkg/m.py": "x = 1\n"})


def test_baseline_sits_beside_its_config(tmp_path):
    cfg = load_config(str(tmp_path), str(tmp_path / "sub" / "lint.toml"))
    assert cfg.baseline == str(tmp_path / "sub" / "graftlint.baseline.json")
    real = load_config(repo_root())
    assert real.baseline.endswith(
        f"{PORT}/tools/graftlint/graftlint.baseline.json"
    )


def test_json_output_is_identical_with_jobs(tmp_path, capsys):
    files = dict(_RETRY)
    files["pkg/dev.py"] = CASES[0][2]["pkg/dev.py"]
    files["pkg/fx.py"] = """
        def scale(d_q2, rate_q8):
            return d_q2 * rate_q8
    """
    _write(tmp_path, files, DEV_CONFIG)
    args = ["--json", "--root", str(tmp_path)]
    outs = []
    for extra in ([], ["--jobs", "2"]):
        rc = main(args + extra)
        outs.append((rc, capsys.readouterr().out))
    assert outs[0] == outs[1]
    assert outs[0][0] == 1
    doc = json.loads(outs[0][1])
    assert {f["rule"] for f in doc["new"]} == {"GL001", "GL008", "GL009", "GL011"}
    out_path = tmp_path / "out.json"
    main(args + ["--json-out", str(out_path)])
    capsys.readouterr()
    assert json.loads(out_path.read_text()) == doc


def test_github_annotations(tmp_path, capsys):
    _write(tmp_path, _RETRY, BASE_CONFIG)
    assert main(["--github", "--root", str(tmp_path)]) == 1
    out = capsys.readouterr().out
    assert "::error file=pkg/m.py,line=5::GL009 unbounded retry loop" in out


_EXPLAIN_WORDS = {
    "GL003": "no PyTorch counterpart",
    "GL006": "has no PyTorch form",
    "GL008": "they yield nothing here",
}


@pytest.mark.parametrize("code", sorted(RULES_BY_ID))
def test_explain_every_code(tmp_path, capsys, code):
    _write(tmp_path, {"pkg/m.py": "x = 1\n"}, BASE_CONFIG)
    rc = main(["--explain", code, "--root", str(tmp_path)])
    out = capsys.readouterr().out
    assert rc == 0
    assert out.startswith(code) and f"{code}: no findings on this tree." in out
    assert _EXPLAIN_WORDS.get(code, code) in " ".join(out.split())


def test_explain_prints_witnesses_and_rejects_unknown(tmp_path, capsys):
    _write(tmp_path, {"pkg/fx.py": """
        def scale(d_q2, rate_q8):
            return d_q2 * rate_q8
    """}, BASE_CONFIG)
    args = ["--root", str(tmp_path)]
    assert main(["--explain", "gl011"] + args) == 0
    out = capsys.readouterr().out
    assert "witness:" in out and "∈" in out and "1 finding(s)" in out
    assert main(["--explain", "GL999"] + args) == 2


# ---------------------------------------------------------------------------
# the package-name pitfall: whole dotted segments
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dotted,inside", [
    (PORT, True),
    (f"{PORT}.ops.filters", True),
    (JAX, False),
    (f"{JAX}.ops.filters", False),
    (f"{PORT}x.ops", False),
    (f"{PORT}_extra", False),
    ("pkg.ops", False),
])
def test_in_package_matches_whole_segments(dotted, inside):
    assert in_package(dotted) is inside


@pytest.mark.parametrize("source,fires", [
    (f"from {PORT}.ops.grid import build", True),
    (f"from {JAX}.ops.grid import build", False),
    (f"from {PORT}x.ops.grid import build", False),
])
def test_imports_resolve_only_into_this_package(tmp_path, source, fires):
    """Three modules of the same name in three packages, all linted: a
    read path calling ``build`` reaches the dispatching body only through
    an import of THIS package."""
    body = """
        import torch

        def build(x):
            return torch.as_tensor(x)
    """
    config = BASE_CONFIG.replace('paths = ["pkg"]',
                                 f'paths = ["{PORT}", "{JAX}", "{PORT}x"]')
    fs = _lint(tmp_path, {
        f"{PORT}/ops/grid.py": body,
        f"{JAX}/ops/grid.py": body,
        f"{PORT}x/ops/grid.py": body,
        f"{PORT}/serve.py": f"""
            {source}

            # graftlint: read-path
            def read(x):
                return build(x)
        """,
    }, config)
    assert bool(_msgs(fs, "GL013")) is fires


# ---------------------------------------------------------------------------
# cross-package parity: the shared machinery, the same source
# ---------------------------------------------------------------------------

_PARITY_CONFIG = """
[tool.graftlint]
paths = ["{pkg}"]
static_params = ["cfg", "config", "self"]

[tool.graftlint.gl004]
zones = []
int_names = ["d_q2", "rate_q8", "steps", "acc_q"]

[tool.graftlint.gl007]
files = ["{pkg}/driver/hot.py"]

[tool.graftlint.gl011]
zones = ["{pkg}/ops/fx.py"]
sum_elems_default = 16384

[tool.graftlint.gl011.bounds]
d_q2 = [0, 262143]
rate_q8 = [-32768, 32767]

[tool.graftlint.locks.SimDevice]
_tx_lock = ["_tx_buf"]
"""

_PARITY_FILES = {
    "driver/cfg.py": """
        import dataclasses

        @dataclasses.dataclass
        class StepConfig:
            n: int = 4

        @dataclasses.dataclass(frozen=True)
        class FrozenConfig:
            n: int = 4

        # graftlint: disable=GL006 — fixture: mutable holder
        @dataclasses.dataclass
        class HolderConfig:
            n: int = 4
    """,
    "driver/hot.py": """
        import numpy as np

        # graftlint: hot-loop
        def dispatch(self, m):
            buf = np.zeros((m, 4), np.uint8)
            return buf, np.full((m,), 1, np.int32)

        def other(self, m, raw):
            # graftlint: hot-loop
            view = np.frombuffer(raw, np.uint8)
            tmp = np.empty((m,), np.uint8)
            # graftlint: end-hot-loop
            return view, tmp, np.ones((m,))
    """,
    "driver/retry.py": """
        import time

        def reconnect(dev):
            while True:
                if dev.connect():
                    break
                time.sleep(1.0)

        class Node:
            def start(self, dev):
                def worker():
                    while True:
                        dev.kick()
                        time.sleep(0.5)
                return worker

        def capped(dev, deadline):
            while True:
                if time.monotonic() > deadline:
                    return False
                time.sleep(1.0)
    """,
    "ops/fx.py": """
        import numpy as np

        def scale(d_q2, rate_q8):
            r = np.clip(rate_q8, -128, 127)
            return d_q2 * rate_q8 + d_q2 * r

        def advance(steps, acc_q):
            return (steps << 3) + acc_q

        def rebind(d_q2, rate_q8):
            rate_q8 = d_q2 * 64
            return np.sum(d_q2) + rate_q8

        def wrap(d_q2):
            # graftlint: disable=GL011 — fixture-sanctioned wrap
            return d_q2 << 20
    """,
    "driver/dev.py": """
        import threading

        class SimDevice:
            def __init__(self):
                self._tx_lock = threading.Lock()
                self._tx_buf = b""
                self._seq = 0

            def start(self):
                threading.Thread(target=self._rx_loop, daemon=True).start()
                threading.Thread(target=self._stream_loop, daemon=True).start()

            def _send(self, payload):
                self._tx_buf = payload
                self._seq += 1

            def _send_locked(self, payload):
                with self._tx_lock:
                    self._tx_buf = payload

            def _rx_loop(self):
                self._send(b"descriptor")
                self._send_locked(b"x")

            def _stream_loop(self):
                self._send(b"scan")

        class AB:
            def __init__(self):
                self._a = threading.Lock()
                self._b = threading.Lock()

            def f(self):
                with self._a:
                    with self._b:
                        pass

            def g(self):
                with self._b:
                    with self._a:
                        pass
    """,
}


def _tree(root, pkg: str, config_name: str, baseline_name: str, entries):
    for rel, src in _PARITY_FILES.items():
        p = root / pkg / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src).replace("{pkg}", pkg))
    (root / config_name).write_text(_PARITY_CONFIG.format(pkg=pkg))
    (root / baseline_name).write_text(json.dumps({"findings": [
        dict(e, path=e["path"].format(pkg=pkg)) for e in entries
    ]}))


def _strip(pkg: str, findings):
    return sorted(
        (f.rule, f.path.removeprefix(pkg + "/"), f.line, f.message)
        for f in findings
    )


_PARITY_RULES = ("GL006", "GL007", "GL009", "GL011", "GL012")

_PARITY_BASELINE = [
    {"rule": "GL009", "path": "{pkg}/driver/retry.py",
     "message": "unbounded retry loop in reconnect: `while True` sleeping a constant "
                "delay with no attempt cap, deadline check, or computed backoff — "
                "route the wait through driver/health.BackoffPolicy (capped "
                "exponential + jitter) or gate an escape on an attempt/deadline bound",
     "justification": "fixture: known loop"},
    {"rule": "GL011", "path": "{pkg}/ops/gone.py", "message": "no longer fires",
     "justification": "fixture: stale"},
]


@pytest.fixture(scope="module")
def parity(tmp_path_factory):
    """The same fixture tree under each package's name, linted by each
    package's linter against its own config and baseline."""
    jroot = tmp_path_factory.mktemp("jax_tree")
    proot = tmp_path_factory.mktemp("port_tree")
    _tree(jroot, JAX, "pyproject.toml", "graftlint.baseline.json", _PARITY_BASELINE)
    _tree(proot, PORT, "graftlint.toml", "graftlint.baseline.json", _PARITY_BASELINE)
    jout = jax_run_lint(str(jroot))
    pout = run_lint(str(proot), cfg=load_config(str(proot), str(proot / "graftlint.toml")))
    return jout, pout


@pytest.mark.parametrize("rule", _PARITY_RULES)
def test_parity_with_the_jax_linter(parity, rule):
    (jf, _jn, _js), (pf, _pn, _ps) = parity
    want = _strip(JAX, [f for f in jf if f.rule == rule])
    got = _strip(PORT, [f for f in pf if f.rule == rule])
    assert want, f"the fixture must exercise {rule}"
    assert got == want


def test_parity_of_the_baseline_machinery(parity):
    (jf, jn, js), (pf, pn, ps) = parity
    assert _strip(PORT, [f for f in pn if f.rule in _PARITY_RULES]) == _strip(
        JAX, [f for f in jn if f.rule in _PARITY_RULES]
    )
    assert len([f for f in pf if f.rule == "GL009"]) == 2
    assert not any(f.rule == "GL009" and "reconnect" in f.message for f in pn)
    strip = [(e["rule"], e["path"].split("/", 1)[1], e["message"]) for e in ps]
    assert strip == [(e["rule"], e["path"].split("/", 1)[1], e["message"]) for e in js]
    assert strip == [("GL011", "ops/gone.py", "no longer fires")]


# ---------------------------------------------------------------------------
# the live path's locks: the fault GL012 found, and its repair
# ---------------------------------------------------------------------------

_PUMP_CONFIG = BASE_CONFIG + """
[tool.graftlint.gl012]
extra_roots = ["pkg/decode.py::Decoder.on_batch@rpl_pump"]

[tool.graftlint.locks.Decoder]
_lock = ["_prev", "_carry"]
"""

_DECODER = """
    import threading

    class Decoder:
        def __init__(self):
            self._lock = threading.RLock()
            self._prev = None
            self._carry = 0

        def reset(self):
            {reset}

        def on_batch(self, items):
            {batch}
"""


@pytest.mark.parametrize("locked", [False, True])
def test_gl012_sees_a_reset_racing_the_pump(tmp_path, locked):
    """The distilled shape of the port's BatchScanDecoder before its
    repair: reset() on the scan loop's thread and the decode of a run on
    the engine's pump thread both write the carries."""
    if locked:
        reset = "with self._lock:\n                self._prev = None\n                self._carry = 0"
        batch = "with self._lock:\n                self._prev = items[-1]\n                self._carry = 1"
    else:
        reset = "self._prev = None\n            self._carry = 0"
        batch = "self._prev = items[-1]\n            self._carry = 1"
    fs = _lint(tmp_path, {"pkg/decode.py": _DECODER.format(reset=reset, batch=batch)},
               _PUMP_CONFIG)
    msgs = _msgs(fs, "GL012")
    if locked:
        assert msgs == []
    else:
        assert any("write to self._prev in Decoder.reset without holding _lock" in m
                   for m in msgs)
        assert any("contexts (main, rpl_pump)" in m for m in msgs)


def test_decoder_reset_waits_for_the_run_in_flight():
    """BatchScanDecoder.reset() (the scan loop) against a run decoded on
    the pump: the reset waits for the run and nothing of the run lands
    after it — the carries, the assembler and the raw holder are clean
    once reset() returns."""
    from rplidar_ros2_driver_tpu_torch.driver.decode import _BUCKETS, BatchScanDecoder
    from rplidar_ros2_driver_tpu_torch.protocol.constants import ANS_PAYLOAD_BYTES, Ans

    entered, release = threading.Event(), threading.Event()
    events = []

    class _BlockingAssembler:
        def reset(self):
            events.append("assembler.reset")

        def push_nodes(self, *args, **kwargs):
            events.append("assembler.push")
            entered.set()
            release.wait(10.0)
            return 0

    class _Holder:
        def reset(self):
            events.append("holder.reset")

        def push(self, stacked):
            events.append("holder.push")

    ans = Ans.MEASUREMENT_CAPSULED
    size = ANS_PAYLOAD_BYTES[ans]
    rng = np.random.default_rng(7)
    # valid-looking capsules (sync nibbles 0xA/0x5, XOR checksum) so the
    # first chunk emits nodes and blocks in push_nodes; the second chunk
    # would then write the carries again
    frames = []
    for _ in range(_BUCKETS[-1] + 3):
        body = rng.integers(0, 256, size=size, dtype=np.uint8)
        body[0] = 0xA0
        body[1] = 0x50
        chk = int(np.bitwise_xor.reduce(body[2:]))
        body[0] |= chk & 0xF
        body[1] |= chk >> 4
        body[3] &= 0x7F  # no new-scan flag
        frames.append((body.tobytes(), time.monotonic()))
    dec = BatchScanDecoder(_BlockingAssembler(), _Holder())
    pump = threading.Thread(target=dec.on_measurement_batch, args=(int(ans), frames))
    pump.start()
    assert entered.wait(10.0), "the run never reached the assembler"
    resetter = threading.Thread(target=dec.reset)
    resetter.start()
    resetter.join(0.3)
    assert resetter.is_alive(), "reset() ran inside the pump's run"
    release.set()
    pump.join(10.0)
    resetter.join(10.0)
    assert not pump.is_alive() and not resetter.is_alive()
    assert dec._prev is None and dec._active_ans is None
    assert dec._sync_carry == 0 and dec._dist_carry == 0
    # the run pushed both chunks before the reset cleared both sinks
    assert events.count("assembler.push") == 2 and events.count("holder.push") == 2
    for sink in ("assembler", "holder"):
        last_reset = max(i for i, e in enumerate(events) if e == f"{sink}.reset")
        assert all(e != f"{sink}.push" for e in events[last_reset:]), events


# ---------------------------------------------------------------------------
# the package's own tree
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def real_tree():
    return run_lint(repo_root())


def test_real_tree_lints_clean(real_tree):
    findings, new, stale = real_tree
    assert new == [], [f"{f.path}:{f.line} {f.rule} {f.message}" for f in new]
    assert stale == []
    assert all(f.path.startswith(PORT + "/") for f in findings)


def test_real_declarations_are_armed():
    from rplidar_ros2_driver_tpu_torch.tools.graftlint import RepoIndex

    cfg = load_config(repo_root())
    index = RepoIndex(cfg)
    assert cfg.paths == (PORT,)
    assert not any("tools/graftlint" in rel for rel in index.modules)
    # the seven device steps and the step of a mesh held in one process
    # (sharding.step_blocks)
    assert len(index.device_roots()) == len(cfg.device_roots) == 8
    assert any(z.endswith("ops/scan_match.py") for z in cfg.zones)
    assert cfg.gl011_bound_map()["motion"] == (-8192, 8192)
    locks = cfg.lock_map()
    for cls in ("RealLidarDriver", "SimulatedDevice", "ScanLoopFsm", "CommandEngine",
                "BatchScanDecoder"):
        assert cls in locks, cls
    roots = {qn for m in index.modules.values() for qn in m.read_path_funcs}
    assert {"DiagnosticsUpdater.update", "snapshot_grid", "WorldMap.snapshot",
            "WorldMap.status"} <= roots
    hot = index.modules[f"{PORT}/driver/ingest.py"].hot_regions
    assert len(hot) == 5


def test_cli_runs_without_jax_and_exits_zero():
    """The port's linter, run as its users run it, in a fresh process:
    exit 0 on the tree, and neither jax nor the JAX package imported."""
    code = (
        "import sys\n"
        "from rplidar_ros2_driver_tpu_torch.tools.graftlint.runner import main\n"
        "rc = main([])\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'rplidar_ros2_driver_tpu' or m.startswith('rplidar_ros2_driver_tpu.'))\n"
        "print('LEAKED', bad)\n"
        "sys.exit(rc or (3 if bad else 0))\n"
    )
    env = dict(os.environ, PYTHONPATH=repo_root())
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=repo_root(), env=env, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "LEAKED []" in out.stdout and " 0 new, 0 stale" in out.stdout

"""``[tool.graftlint]`` — the per-module invariant declarations.

The analyzer is repo-native: which files are bit-exact fixed-point
zones, which host files carry hot-loop regions, which functions are the
device steps, and which naming conventions imply a dtype are all REPO
facts, so they are declared in a TOML file beside the tool
(``graftlint.toml``, with the baseline ``graftlint.baseline.json`` next
to it) rather than hard-coded in the tool.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re

try:  # py311+: stdlib; 3.10 ships tomli
    import tomllib as _toml
except ImportError:  # pragma: no cover - depends on interpreter version
    import tomli as _toml

# where the package's own declarations live, relative to the repo root
DEFAULT_CONFIG = "rplidar_ros2_driver_tpu_torch/tools/graftlint/graftlint.toml"


@dataclasses.dataclass(frozen=True)
class LintConfig:
    """Parsed ``[tool.graftlint]`` tables (all paths repo-relative, the
    baseline may be absolute)."""

    root: str
    paths: tuple = ("rplidar_ros2_driver_tpu_torch",)
    baseline: str = "graftlint.baseline.json"
    # param names that are host values wherever they appear (configs,
    # backend selectors) — GL001/GL002 never treat them as tensors
    static_params: tuple = ()
    # GL001/GL002/GL003: the device steps, "relpath::qualname"
    device_roots: tuple = ()
    # annotation names that promise a host value (enums, plain records)
    host_annotations: tuple = ()
    # GL004: bit-exact zones + the naming-convention dtype declarations
    zones: tuple = ()
    int_returning: tuple = ()       # calls whose results are integer
    int_names: tuple = ()           # regexes: names carrying integer data
    float_names: tuple = ()         # regexes: names carrying float data
    bool_names: tuple = ()          # regexes: names carrying masks
    # GL007 hot-loop files
    hot_files: tuple = ()
    # GL011: fixed-point overflow prover — the declared input ranges.
    # bounds/call_bounds are ((name, lo, hi), ...); sum_elems is
    # ((zone relpath, element-count cap), ...) for reductions.
    gl011_zones: tuple = ()
    gl011_bounds: tuple = ()
    gl011_call_bounds: tuple = ()
    gl011_sum_elems: tuple = ()
    gl011_sum_elems_default: int = 4096
    gl011_pass_calls: tuple = ()    # ((call leaf, argument index), ...)
    # GL012: lock discipline — ((class, lock attr, (guarded fields...)),
    # ...) plus extra thread roots ("relpath::Class.method") for
    # callback entry points static analysis can't see registered
    locks: tuple = ()
    gl012_extra_roots: tuple = ()
    # GL013: what counts as "dispatching" on a read path
    gl013_dispatch_calls: tuple = ("to", "cuda", "cpu", "item", "synchronize")
    gl013_dispatch_prefixes: tuple = ("submit_",)
    gl013_dispatch_heads: tuple = ("torch",)
    # GL008 structural-consistency inputs
    params_module: str = "rplidar_ros2_driver_tpu_torch/core/config.py"
    params_yaml: str = "param/rplidar.yaml"
    unvalidated_params_ok: tuple = ()
    precompile_exempt: tuple = ()

    def zone_patterns(self) -> tuple:
        return tuple(re.compile(p) for p in self.int_names), tuple(
            re.compile(p) for p in self.float_names
        ), tuple(re.compile(p) for p in self.bool_names)

    # tuple-of-tuples storage keeps the dataclass frozen; the rules want
    # dict views
    def gl011_bound_map(self) -> dict:
        return {n: (lo, hi) for n, lo, hi in self.gl011_bounds}

    def gl011_call_bound_map(self) -> dict:
        return {n: (lo, hi) for n, lo, hi in self.gl011_call_bounds}

    def gl011_sum_elems_map(self) -> dict:
        return {rel: n for rel, n in self.gl011_sum_elems}

    def lock_map(self) -> dict:
        """{class: {lock attr: frozenset(guarded fields)}}"""
        out: dict = {}
        for cls, lock, fields in self.locks:
            out.setdefault(cls, {})[lock] = frozenset(fields)
        return out


def load_config(root: str, path: str | None = None) -> LintConfig:
    """Read ``[tool.graftlint]`` from ``path`` (default: the package's
    ``graftlint.toml`` under ``root``).  Every key is optional — missing
    tables mean the defaults above.  A relative ``baseline`` is resolved
    beside the TOML file."""
    path = path or os.path.join(root, DEFAULT_CONFIG)
    data: dict = {}
    if os.path.exists(path):
        with open(path, "rb") as f:
            data = _toml.load(f)
    t = data.get("tool", {}).get("graftlint", {})
    g4 = t.get("gl004", {})
    g7 = t.get("gl007", {})
    g8 = t.get("gl008", {})
    g11 = t.get("gl011", {})
    g12 = t.get("gl012", {})
    g13 = t.get("gl013", {})
    locks_t = t.get("locks", {})
    locks = tuple(
        (cls, lock, tuple(fields))
        for cls, table in sorted(locks_t.items())
        for lock, fields in sorted(table.items())
    )
    baseline = os.path.join(
        os.path.dirname(os.path.abspath(path)),
        t.get("baseline", "graftlint.baseline.json"),
    )
    dflt = LintConfig(root=root)
    return LintConfig(
        root=root,
        paths=tuple(t.get("paths", dflt.paths)),
        baseline=baseline,
        static_params=tuple(t.get("static_params", ())),
        device_roots=tuple(t.get("device_roots", ())),
        host_annotations=tuple(t.get("host_annotations", ())),
        zones=tuple(g4.get("zones", ())),
        int_returning=tuple(g4.get("int_returning", ())),
        int_names=tuple(g4.get("int_names", ())),
        float_names=tuple(g4.get("float_names", ())),
        bool_names=tuple(g4.get("bool_names", ())),
        hot_files=tuple(g7.get("files", ())),
        params_module=g8.get("params_module", dflt.params_module),
        params_yaml=g8.get("params_yaml", dflt.params_yaml),
        unvalidated_params_ok=tuple(g8.get("unvalidated_params_ok", ())),
        precompile_exempt=tuple(g8.get("precompile_exempt", ())),
        gl011_zones=tuple(g11.get("zones", ())),
        gl011_bounds=tuple(
            (n, lo, hi) for n, (lo, hi) in sorted(
                g11.get("bounds", {}).items()
            )
        ),
        gl011_call_bounds=tuple(
            (n, lo, hi) for n, (lo, hi) in sorted(
                g11.get("call_bounds", {}).items()
            )
        ),
        gl011_sum_elems=tuple(sorted(g11.get("sum_elems", {}).items())),
        gl011_sum_elems_default=g11.get("sum_elems_default", 4096),
        gl011_pass_calls=tuple(sorted(g11.get("pass_calls", {}).items())),
        locks=locks,
        gl012_extra_roots=tuple(g12.get("extra_roots", ())),
        gl013_dispatch_calls=tuple(
            g13.get("dispatch_calls", dflt.gl013_dispatch_calls)
        ),
        gl013_dispatch_prefixes=tuple(
            g13.get("dispatch_prefixes", dflt.gl013_dispatch_prefixes)
        ),
        gl013_dispatch_heads=tuple(
            g13.get("dispatch_heads", dflt.gl013_dispatch_heads)
        ),
    )


def load_baseline(root: str, cfg: LintConfig) -> list[dict]:
    """The checked-in baseline: a list of findings that are KNOWN and
    individually justified.  The runner fails on any finding not in it
    AND on any stale entry no longer firing (a baseline that outlives its
    findings stops meaning anything)."""
    path = os.path.join(root, cfg.baseline)
    if not os.path.exists(path):
        return []
    with open(path) as f:
        doc = json.load(f)
    entries = doc.get("findings", [])
    for e in entries:
        if not e.get("justification"):
            raise ValueError(
                f"baseline entry without a justification: {e!r} — every "
                "baselined finding must say why it is allowed to stand"
            )
    return entries

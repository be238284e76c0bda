"""Repo model: parsed modules, suppressions, call graph, and the
lightweight expression dtype lattice the bit-exactness rules use.

Everything is plain ``ast`` — the tool never imports the code it
analyzes (a lint of a module with a broken import must still run), and
it imports neither torch nor the package it lints.
"""

from __future__ import annotations

import ast
import dataclasses
import io
import os
import re
import tokenize

from rplidar_ros2_driver_tpu_torch.tools.graftlint.config import LintConfig

_PKG = "rplidar_ros2_driver_tpu_torch"

# expression dtype lattice (GL004/GL005): order matters only for join
INT, FLOAT, BOOL, UNKNOWN = "int", "float", "bool", "unknown"

_SUPPRESS_RE = re.compile(
    r"#\s*graftlint:\s*disable=([A-Z0-9, ]+?)\s*[—–-]\s*\S"
)
_POLICED_RE = re.compile(r"#\s*graftlint:\s*policed\s*[—–-]\s*\S")
_HOT_RE = re.compile(r"#\s*graftlint:\s*hot-loop\b")
_HOT_END_RE = re.compile(r"#\s*graftlint:\s*end-hot-loop\b")
_READ_PATH_RE = re.compile(r"#\s*graftlint:\s*read-path\b")


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str       # repo-relative
    line: int
    message: str
    # the proof artifact behind the finding (an interval trace, an
    # unlocked write pair, a call path) — shown by `--explain`, NOT part
    # of key(): witnesses carry line numbers and interval endpoints that
    # churn with unrelated edits, and baseline identity must not
    witness: str = ""

    def key(self) -> tuple:
        # line numbers churn with unrelated edits; identity is
        # (rule, file, message) — messages name the construct
        return (self.rule, self.path, self.message)


@dataclasses.dataclass
class FunctionInfo:
    module: "ModuleFile"
    qualname: str                  # dotted: Class.method / outer.inner
    node: ast.AST                  # FunctionDef / AsyncFunctionDef
    params: tuple = ()
    cls: str | None = None         # enclosing class name, if a method


class ModuleFile:
    """One parsed source file plus its comment-driven annotations."""

    def __init__(self, root: str, relpath: str) -> None:
        self.root = root
        self.relpath = relpath
        with open(os.path.join(root, relpath), encoding="utf-8") as f:
            self.source = f.read()
        self.tree = ast.parse(self.source, filename=relpath)
        self.comments: dict[int, str] = {}
        self.standalone: set[int] = set()  # comment-only lines
        try:
            for tok in tokenize.generate_tokens(
                io.StringIO(self.source).readline
            ):
                if tok.type == tokenize.COMMENT:
                    line = tok.start[0]
                    self.comments[line] = tok.string
                    if tok.string.strip() == tok.line.strip():
                        self.standalone.add(line)
        except tokenize.TokenizeError:  # pragma: no cover - parse caught it
            pass
        self.functions: dict[str, FunctionInfo] = {}
        self.imports: dict[str, str] = {}        # alias -> module relpath
        self.from_imports: dict[str, tuple] = {} # name -> (relpath, orig)
        self.hot_regions: list[tuple] = []
        self._index_imports(self.tree)
        self._index_functions()
        self._index_hot_regions()
        self.read_path_funcs: tuple = self._index_read_paths()

    # -- suppression / marker surface ------------------------------------

    def _marker_lines(self, line: int):
        """The flagged line itself plus the contiguous standalone-comment
        block directly above it (markers read best with the directive
        first and the rationale continuing below, so the whole block
        counts)."""
        yield line
        ln = line - 1
        while ln in self.standalone:
            yield ln
            ln -= 1

    def suppressed(self, rule: str, line: int) -> bool:
        """``# graftlint: disable=GLxxx — reason`` on the line or in the
        comment block directly above.  A reason is REQUIRED — a bare
        disable does not suppress (an unexplained exception is exactly
        what this tool exists to prevent)."""
        for ln in self._marker_lines(line):
            c = self.comments.get(ln)
            if c is None:
                continue
            m = _SUPPRESS_RE.search(c)
            if m and rule in {r.strip() for r in m.group(1).split(",")}:
                return True
        return False

    def policed(self, line: int) -> bool:
        """``# graftlint: policed — reason`` blesses a float→int cast on
        this line or in the comment block directly above (the GL004
        cast escape hatch)."""
        return any(
            _POLICED_RE.search(self.comments.get(ln, ""))
            for ln in self._marker_lines(line)
        )

    def in_hot_region(self, line: int) -> bool:
        return any(a <= line <= b for a, b in self.hot_regions)

    def _index_hot_regions(self) -> None:
        """A ``# graftlint: hot-loop`` marker opens a region: to the
        matching ``end-hot-loop`` if one follows, else over the next
        ``def``'s whole body (the common shape: mark a dispatch/staging
        method hot)."""
        defs = sorted(
            (n.lineno, getattr(n, "end_lineno", n.lineno))
            for n in ast.walk(self.tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        )
        ends = sorted(
            ln for ln, c in self.comments.items() if _HOT_END_RE.search(c)
        )
        starts = sorted(
            ln for ln, c in self.comments.items()
            if _HOT_RE.search(c) and not _HOT_END_RE.search(c)
        )
        for i, ln in enumerate(starts):
            # an end marker only pairs with THIS start if no other start
            # opens in between — otherwise a def-scoped marker earlier in
            # the file would absorb a later begin/end pair's end marker
            # and fuse everything between into one bogus region
            nxt_start = starts[i + 1] if i + 1 < len(starts) else float("inf")
            end = next((e for e in ends if ln < e < nxt_start), None)
            if end is not None:
                self.hot_regions.append((ln, end))
                continue
            nxt = next((d for d in defs if d[0] > ln), None)
            if nxt is not None:
                self.hot_regions.append((nxt[0], nxt[1]))

    def _index_read_paths(self) -> tuple:
        """``# graftlint: read-path`` on a standalone comment line marks
        the NEXT ``def`` as a zero-dispatch read-path root (GL013): the
        function and everything it can reach must never dispatch.  The
        marker is a contract, not documentation — the prover starts
        here."""
        marks = sorted(
            ln for ln, c in self.comments.items() if _READ_PATH_RE.search(c)
        )
        if not marks:
            return ()
        defs = sorted(
            (
                f.node.decorator_list[0].lineno
                if f.node.decorator_list else f.node.lineno,
                qn,
            )
            for qn, f in self.functions.items()
        )
        out = []
        for ln in marks:
            nxt = next((qn for d, qn in defs if d > ln), None)
            if nxt is not None:
                out.append(nxt)
        return tuple(out)

    # -- imports ----------------------------------------------------------

    def _index_imports(self, scope: ast.AST) -> None:
        for n in ast.walk(scope):
            if isinstance(n, ast.Import):
                for a in n.names:
                    if in_package(a.name):
                        alias = a.asname or a.name.split(".")[-1]
                        self.imports[alias] = _mod_to_path(a.name)
            elif isinstance(n, ast.ImportFrom) and n.module:
                if not in_package(n.module):
                    continue
                for a in n.names:
                    sub = f"{n.module}.{a.name}"
                    if _looks_module(self.root, sub):
                        # "from pkg.ops import unpack" — a module alias
                        self.imports[a.asname or a.name] = _mod_to_path(sub)
                    self.from_imports[a.asname or a.name] = (
                        _mod_to_path(n.module), a.name
                    )

    # -- functions ---------------------------------------------------------

    def _index_functions(self) -> None:
        def visit(node, prefix, cls):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.ClassDef):
                    visit(child, f"{prefix}{child.name}.", child.name)
                elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    qn = f"{prefix}{child.name}"
                    self.functions[qn] = FunctionInfo(
                        module=self,
                        qualname=qn,
                        node=child,
                        params=tuple(
                            a.arg for a in (
                                child.args.posonlyargs + child.args.args
                            )
                        ),
                        cls=cls,
                    )
                    visit(child, f"{qn}.", cls)

        visit(self.tree, "", None)


def in_package(dotted: str) -> bool:
    """Is ``dotted`` the package or one of its modules?  Matched by whole
    dotted segment: the JAX package's name is a prefix of this one, so a
    plain ``startswith`` would take ``rplidar_ros2_driver_tpu_torchx``
    for this package, and a name-prefix test written the other way would
    take this package for the JAX one."""
    return dotted == _PKG or dotted.startswith(_PKG + ".")


def _looks_module(root: str, dotted: str) -> bool:
    """Is ``dotted`` a module (or package) of the tree under ``root``?"""
    cand = os.path.join(root, *dotted.split("."))
    return os.path.isfile(cand + ".py") or os.path.isdir(cand)


def _mod_to_path(dotted: str) -> str:
    return dotted.replace(".", "/") + ".py"


def _name_of(node: ast.AST) -> str:
    """Best-effort dotted name of an expression (``torch.cuda.synchronize``
    -> "torch.cuda.synchronize"); "" when it isn't a plain dotted path."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = _name_of(node.value)
        return f"{base}.{node.attr}" if base else ""
    return ""


def _parse_one(root: str, rel: str):
    """Pool worker: parse one file (module-level so it pickles).
    Returns ``(rel, ModuleFile | None)`` — parse failures stay CI's
    problem, exactly as in the serial path."""
    try:
        return rel.replace(os.sep, "/"), ModuleFile(root, rel)
    except (SyntaxError, UnicodeDecodeError):
        return rel.replace(os.sep, "/"), None


class RepoIndex:
    """All scanned modules + the cross-module call graph.

    ``jobs > 1`` parses modules in a process pool — the per-file
    parse/tokenize phase is embarrassingly parallel, while everything
    cross-module (call graph, rules) runs after the pool joins, so the
    barrier is the constructor returning.  Any pool failure falls back
    to the serial path: parallelism is a speedup, never a behavior."""

    def __init__(self, cfg: LintConfig, jobs: int = 0) -> None:
        self.cfg = cfg
        self.modules: dict[str, ModuleFile] = {}
        rels: list[str] = []
        for top in cfg.paths:
            full = os.path.join(cfg.root, top)
            if os.path.isfile(full) and top.endswith(".py"):
                rels.append(top)
                continue
            for dirpath, _dirs, files in os.walk(full):
                for f in sorted(files):
                    if f.endswith(".py"):
                        rels.append(
                            os.path.relpath(os.path.join(dirpath, f), cfg.root)
                        )
        rels = [
            r for r in rels
            # the linter does not lint itself (fixtures live in tests)
            if "tools/graftlint" not in r.replace(os.sep, "/")
        ]
        if jobs and jobs > 1:
            try:
                import concurrent.futures

                with concurrent.futures.ProcessPoolExecutor(
                    max_workers=jobs
                ) as pool:
                    for rel, mod in pool.map(
                        _parse_one, [cfg.root] * len(rels), rels,
                        chunksize=max(1, len(rels) // (jobs * 4)),
                    ):
                        if mod is not None:
                            self.modules[rel] = mod
                return
            except Exception:  # pragma: no cover - platform-dependent
                self.modules.clear()
        for rel in rels:
            self._load(rel)

    def _load(self, rel: str) -> None:
        try:
            self.modules[rel.replace(os.sep, "/")] = ModuleFile(cfg_root(self), rel)
        except (SyntaxError, UnicodeDecodeError):
            pass  # unparsable files are CI's problem, not this tool's

    # -- function resolution ----------------------------------------------

    def resolve_call(self, mod: ModuleFile, call: ast.AST):
        """Resolve a Call/Name reference to a FunctionInfo, chasing
        module aliases and from-imports one hop (package-internal only).
        Returns None for anything unresolvable (builtins, methods on
        values, third-party calls)."""
        name = _name_of(call)
        if not name:
            return None
        if "." in name:
            head, _, tail = name.partition(".")
            target = mod.imports.get(head)
            if target in self.modules and "." not in tail:
                return self.modules[target].functions.get(tail)
            return None
        if name in mod.functions:
            return mod.functions[name]
        if name in mod.from_imports:
            src, orig = mod.from_imports[name]
            if src in self.modules:
                return self.modules[src].functions.get(orig)
        return None

    def resolve_method(self, fn: FunctionInfo, attr: str):
        """``self.X`` inside a method resolves to a sibling method, or to
        the method an attribute is bound to (``self._step =
        self._step_packed`` in any method of the class)."""
        if fn.cls is None:
            return None
        got = fn.module.functions.get(f"{fn.cls}.{attr}")
        if got is not None:
            return got
        bound = self._bound_methods(fn.module, fn.cls)
        return fn.module.functions.get(f"{fn.cls}.{bound[attr]}") if (
            attr in bound
        ) else None

    def _bound_methods(self, mod, cls) -> dict:
        key = (mod.relpath, cls)
        cache = self.__dict__.setdefault("_bound_cache", {})
        if key in cache:
            return cache[key]
        out: dict = {}
        for qn, f in mod.functions.items():
            if f.cls != cls:
                continue
            for n in ast.walk(f.node):
                if not (isinstance(n, ast.Assign) and len(n.targets) == 1):
                    continue
                t, v = n.targets[0], n.value
                if (
                    isinstance(t, ast.Attribute)
                    and isinstance(t.value, ast.Name) and t.value.id == "self"
                    and isinstance(v, ast.Attribute)
                    and isinstance(v.value, ast.Name) and v.value.id == "self"
                    and f"{cls}.{v.attr}" in mod.functions
                ):
                    out.setdefault(t.attr, v.attr)
        cache[key] = out
        return out

    def reachable_from(self, roots, stop=()) -> set:
        """Closure over the call graph: every FunctionInfo reachable
        from ``roots`` by call OR bare function reference (references
        cover indirect dispatch — kernel tables, functools.partial).

        ``stop`` is a set of ``(relpath, qualname)`` keys the closure
        must not expand INTO: GL012 passes the other thread entry
        points, because ``Thread(target=self._loop)`` is a reference
        the walk would otherwise follow — the spawner does not execute
        the spawned body in its own context."""
        seen: set = set()
        frontier = list(roots)
        while frontier:
            fn = frontier.pop()
            key = (fn.module.relpath, fn.qualname)
            if key in seen or key in stop:
                continue
            seen.add(key)
            # function-local lazy imports participate in resolution
            fn.module._index_imports(fn.node)
            for n in ast.walk(fn.node):
                tgt = None
                if isinstance(n, (ast.Name, ast.Attribute)) and isinstance(
                    getattr(n, "ctx", None), ast.Load
                ):
                    if (
                        isinstance(n, ast.Attribute)
                        and isinstance(n.value, ast.Name)
                        and n.value.id == "self"
                    ):
                        tgt = self.resolve_method(fn, n.attr)
                    else:
                        tgt = self.resolve_call(fn.module, n)
                if tgt is not None and not isinstance(
                    tgt.node, ast.ClassDef
                ):
                    frontier.append(tgt)
        return seen

    def reachable_paths(self, roots) -> dict:
        """Like ``reachable_from`` but each reached function also gets
        ONE witness call path back to a root: ``{key: (root_key, ...,
        key)}``.  The path is what ``--explain`` prints — a reachability
        finding without the chain that proves it is unactionable."""
        paths: dict = {}
        frontier = []
        for fn in roots:
            key = (fn.module.relpath, fn.qualname)
            if key not in paths:
                paths[key] = (key,)
                frontier.append(fn)
        while frontier:
            fn = frontier.pop(0)
            base = paths[(fn.module.relpath, fn.qualname)]
            fn.module._index_imports(fn.node)
            for n in ast.walk(fn.node):
                tgt = None
                if isinstance(n, (ast.Name, ast.Attribute)) and isinstance(
                    getattr(n, "ctx", None), ast.Load
                ):
                    if (
                        isinstance(n, ast.Attribute)
                        and isinstance(n.value, ast.Name)
                        and n.value.id == "self"
                    ):
                        tgt = self.resolve_method(fn, n.attr)
                    else:
                        tgt = self.resolve_call(fn.module, n)
                if tgt is None or isinstance(tgt.node, ast.ClassDef):
                    continue
                key = (tgt.module.relpath, tgt.qualname)
                if key not in paths:
                    paths[key] = base + (key,)
                    frontier.append(tgt)
        return paths

    def device_roots(self):
        """The declared device steps (``device_roots``, each
        "relpath::qualname"), resolved to FunctionInfos; a declaration
        naming nothing is skipped here and reported by GL008."""
        out = []
        for spec in self.cfg.device_roots:
            rel, _, qn = spec.partition("::")
            mod = self.modules.get(rel)
            fn = mod.functions.get(qn) if mod is not None else None
            if fn is not None:
                out.append(fn)
        return out

    def functions_by_key(self) -> dict:
        return {
            (m.relpath, f.qualname): f
            for m in self.modules.values()
            for f in m.functions.values()
        }


def cfg_root(index: RepoIndex) -> str:
    return index.cfg.root


# ---------------------------------------------------------------------------
# expression dtype lattice
# ---------------------------------------------------------------------------

_INT_CALLS = {
    "argmax", "argmin", "argsort", "searchsorted", "count_nonzero",
    "bucketize", "bincount", "nonzero",
}
_BOOL_CALLS = {
    "isfinite", "isnan", "isinf", "logical_and", "logical_or",
    "logical_not", "any", "all", "frame_crc_ok", "eq", "ne", "lt", "le",
    "gt", "ge", "isin",
}
_FLOAT_CALLS = {"floor", "ceil", "round", "rint", "sqrt", "cos", "sin", "exp",
                "atan2", "hypot"}
_PASS_CALLS = {
    "clip", "clamp", "minimum", "maximum", "abs", "roll", "take",
    "take_along_dim", "take_along_axis", "gather", "index_select", "pad",
    "broadcast_to", "expand", "expand_as", "sort", "flip", "transpose",
    "permute", "squeeze", "unsqueeze", "copy", "clone", "contiguous",
    "asarray", "as_tensor", "reshape", "view", "ravel", "flatten", "tile",
    "repeat", "repeat_interleave", "max", "min", "amax", "amin", "mod",
    "remainder", "fmod", "narrow", "detach",
}
_REDUCE_CALLS = {"sum", "cumsum", "mean", "prod", "cumprod"}
_DTYPE_CTORS_INT = {"int8", "int16", "int32", "int64", "uint8", "uint16",
                    "uint32", "uint64", "int", "long", "short", "intc"}
_DTYPE_CTORS_FLOAT = {"float16", "float32", "float64", "bfloat16", "float",
                      "double", "half"}
# tensor methods that convert to a fixed dtype kind
_METHOD_INT = {"int", "long", "short", "byte", "char"}
_METHOD_FLOAT = {"float", "double", "half", "bfloat16"}


def dtype_aliases(tree) -> dict:
    """``{name: kind}`` for every name bound to a dtype anywhere in the
    module (``i32 = torch.int32``, ``_FLOAT32 = torch.float32``)."""
    out = {}
    for n in ast.walk(tree):
        if not (isinstance(n, ast.Assign) and len(n.targets) == 1):
            continue
        t, v = n.targets[0], n.value
        pairs = [(t, v)]
        if isinstance(t, ast.Tuple) and isinstance(v, ast.Tuple) and len(
            t.elts
        ) == len(v.elts):
            pairs = list(zip(t.elts, v.elts))  # _I32, _F32 = torch.int32, ...
        for te, ve in pairs:
            if isinstance(te, ast.Name) and isinstance(ve, ast.Attribute):
                kind = dtype_kind(ve)
                if kind != UNKNOWN:
                    out[te.id] = kind
    return out


def dtype_kind(node, aliases=None) -> str:
    """INT/FLOAT/BOOL/UNKNOWN for a dtype expression (``torch.int32``,
    ``np.float32``, ``bool``, ``"int32"``, or a name in ``aliases``)."""
    if aliases and isinstance(node, ast.Name) and node.id in aliases:
        return aliases[node.id]
    name = _name_of(node)
    leaf = name.rsplit(".", 1)[-1] if name else ""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        leaf = node.value
    if leaf in _DTYPE_CTORS_INT:
        return INT
    if leaf in _DTYPE_CTORS_FLOAT:
        return FLOAT
    if leaf == "bool" or leaf == "bool_":
        return BOOL
    return UNKNOWN


_MODULE_HEADS = {"torch", "np", "numpy", "math", "F"}


def cast_target(node: ast.Call, aliases=None):
    """``(kind, source)`` when the call converts a tensor/array to a dtype:
    ``x.to(torch.int32)``, ``x.to(dtype=...)``, ``x.to(dev)`` (kind
    UNKNOWN: the dtype stays), ``x.int()``/``x.long()``/``x.float()``/
    ``x.bool()``, ``x.type(torch.int32)``, ``x.astype(np.int32)``;
    ``torch.tensor/as_tensor(x, dtype=...)`` and ``np.asarray(x, dt)``.
    None for any other call."""
    f = node.func
    if isinstance(f, ast.Attribute) and _name_of(f.value).split(".", 1)[0] not in (
        _MODULE_HEADS
    ):
        src = f.value
        if f.attr in ("to", "type", "astype"):
            dt = next((kw.value for kw in node.keywords if kw.arg == "dtype"), None)
            if dt is None:
                kinds = [dtype_kind(a, aliases) for a in node.args]
                known = [k for k in kinds if k != UNKNOWN]
                if known:
                    return known[0], src
                return UNKNOWN, src if f.attr == "to" else None
            return dtype_kind(dt, aliases), src
        if f.attr in _METHOD_INT and not node.args:
            return INT, src
        if f.attr in _METHOD_FLOAT and not node.args:
            return FLOAT, src
        if f.attr == "bool" and not node.args:
            return BOOL, src
        return None
    name = _name_of(f)
    head, _, leaf = name.rpartition(".")
    if head in ("torch",) and leaf in ("tensor", "as_tensor") and node.args:
        dt = next((kw.value for kw in node.keywords if kw.arg == "dtype"), None)
        if dt is not None:
            return dtype_kind(dt, aliases), node.args[0]
    if head in ("np", "numpy") and leaf in ("asarray", "array") and node.args:
        dt = next((kw.value for kw in node.keywords if kw.arg == "dtype"), None)
        if dt is None and len(node.args) >= 2:
            dt = node.args[1]
        if dt is not None:
            return dtype_kind(dt, aliases), node.args[0]
    return None


def _join(*kinds) -> str:
    if FLOAT in kinds:
        return FLOAT
    if UNKNOWN in kinds:
        return UNKNOWN
    return INT


class ExprTyper:
    """Best-effort dtype inference for GL004: local assignment tracking
    first, the repo's declared naming conventions as the fallback.  The
    goal is not a type system — it is to make the zones' float-vs-int
    story EXPLICIT, with ``graftlint.toml`` declaring what the names
    mean and the linter holding code to it."""

    def __init__(self, cfg: LintConfig, module_env: dict | None = None,
                 aliases: dict | None = None):
        self.int_pat, self.float_pat, self.bool_pat = cfg.zone_patterns()
        self.int_returning = set(cfg.int_returning)
        self.module_env = module_env or {}
        self.aliases = aliases or {}

    def dtype_kind(self, node) -> str:
        return dtype_kind(node, self.aliases)

    def name_kind(self, name: str) -> str:
        for pats, kind in (
            (self.bool_pat, BOOL), (self.int_pat, INT),
            (self.float_pat, FLOAT),
        ):
            if any(p.fullmatch(name) for p in pats):
                return kind
        return UNKNOWN

    def build_env(self, fn_node) -> dict:
        """One forward pass over the function's assignments."""
        env = dict(self.module_env)
        for n in ast.walk(fn_node):
            if isinstance(n, ast.Assign) and len(n.targets) == 1:
                t = n.targets[0]
                if isinstance(t, ast.Name):
                    env[t.id] = self.etype(n.value, env)
                elif isinstance(t, ast.Tuple) and isinstance(
                    n.value, ast.Tuple
                ) and len(t.elts) == len(n.value.elts):
                    for te, ve in zip(t.elts, n.value.elts):
                        if isinstance(te, ast.Name):
                            env[te.id] = self.etype(ve, env)
        return env

    def etype(self, node, env) -> str:  # noqa: C901 - a lattice is a switch
        if isinstance(node, ast.Constant):
            if isinstance(node.value, bool):
                return BOOL
            if isinstance(node.value, int):
                return INT
            if isinstance(node.value, float):
                return FLOAT
            return UNKNOWN
        if isinstance(node, (ast.Compare, ast.BoolOp)):
            return BOOL
        if isinstance(node, ast.UnaryOp):
            if isinstance(node.op, ast.Not):
                return BOOL
            if isinstance(node.op, ast.Invert):
                return self.etype(node.operand, env)
            return self.etype(node.operand, env)
        if isinstance(node, ast.BinOp):
            if isinstance(
                node.op,
                (ast.BitAnd, ast.BitOr, ast.BitXor, ast.LShift, ast.RShift),
            ):
                lk = self.etype(node.left, env)
                rk = self.etype(node.right, env)
                return BOOL if lk == rk == BOOL else INT
            if isinstance(node.op, ast.Div):
                return FLOAT
            return _join(
                self.etype(node.left, env), self.etype(node.right, env)
            )
        if isinstance(node, ast.IfExp):
            return _join(
                self.etype(node.body, env), self.etype(node.orelse, env)
            )
        if isinstance(node, ast.Subscript):
            return self.etype(node.value, env)
        if isinstance(node, ast.Name):
            kind = env.get(node.id, UNKNOWN)
            return kind if kind != UNKNOWN else self.name_kind(node.id)
        if isinstance(node, ast.Attribute):
            return self.name_kind(node.attr) if node.attr not in (
                "pi", "inf", "e", "nan"
            ) else FLOAT
        if isinstance(node, ast.Call):
            return self._call_type(node, env)
        return UNKNOWN

    def _call_type(self, node: ast.Call, env) -> str:
        cast = cast_target(node, self.aliases)
        if cast is not None:
            kind, src = cast
            if kind != UNKNOWN or src is None:
                return kind
            return self.etype(src, env)  # x.to(device): dtype unchanged
        name = _name_of(node.func)
        leaf = name.rsplit(".", 1)[-1] if name else ""
        dt = next(
            (kw.value for kw in node.keywords
             if kw.arg in ("dtype", "preferred_element_type")),
            None,
        )
        if dt is not None:
            return self.dtype_kind(dt)
        if leaf in _DTYPE_CTORS_INT or leaf == "len":
            return INT
        if leaf in _DTYPE_CTORS_FLOAT:
            return FLOAT
        if leaf in self.int_returning or leaf in _INT_CALLS:
            return INT
        if leaf in _BOOL_CALLS:
            return BOOL
        if leaf in _FLOAT_CALLS:
            return FLOAT
        if leaf == "where" and len(node.args) == 3:
            return _join(
                self.etype(node.args[1], env), self.etype(node.args[2], env)
            )
        if leaf in ("concatenate", "stack", "hstack", "vstack") and node.args:
            arg = node.args[0]
            if isinstance(arg, (ast.List, ast.Tuple)):
                return _join(*(self.etype(e, env) for e in arg.elts))
            return self.etype(arg, env)
        if leaf in _REDUCE_CALLS and node.args:
            k = self.etype(node.args[0], env)
            return INT if k == BOOL else k
        if leaf in ("arange", "zeros", "ones", "full", "empty"):
            return FLOAT if leaf != "arange" else INT
        if leaf == "div" and any(
            kw.arg == "rounding_mode" for kw in node.keywords
        ) and len(node.args) == 2:
            return _join(
                self.etype(node.args[0], env), self.etype(node.args[1], env)
            )
        if isinstance(node.func, ast.Attribute) and leaf in _PASS_CALLS and (
            _name_of(node.func.value).split(".", 1)[0] not in _MODULE_HEADS
        ):
            return self.etype(node.func.value, env)  # x.clamp(...) keeps x's
        if leaf in _PASS_CALLS and node.args:
            return self.etype(node.args[0], env)
        return UNKNOWN


# ---------------------------------------------------------------------------
# taint: does an expression depend on traced (array) values?
# ---------------------------------------------------------------------------

# tensor metadata: host values whatever the tensor holds
_CLEAN_ATTRS = {
    "shape", "ndim", "dtype", "size", "device", "is_cuda", "is_contiguous",
    "get_device", "dim", "numel", "stride", "data_ptr", "is_floating_point",
    "is_pinned", "layout", "element_size", "nbytes", "itemsize",
}
# methods whose result lives on the host
_HOST_RESULT_METHODS = {"tolist", "item", "numpy"}
_SCALAR_WRAPPERS = _DTYPE_CTORS_INT | _DTYPE_CTORS_FLOAT | {
    "len", "bool", "range", "log2", "isinstance",
}


class StaticNames(frozenset):
    """The declared host-value names: exact names, or regexes (fullmatch)
    for naming conventions such as ``.*_h`` (a host mirror)."""

    def __new__(cls, names=()):
        self = super().__new__(cls, names)
        self._pats = tuple(
            re.compile(n) for n in names if not n.isidentifier()
        )
        return self

    def __contains__(self, name) -> bool:
        return frozenset.__contains__(self, name) or any(
            p.fullmatch(name) for p in self._pats
        )


def is_static_name(name: str, statics: set) -> bool:
    return name in statics or "cfg" in name or "config" in name


def expr_mentions_tainted(node, tainted: set, statics: set) -> bool:
    """Any Name in the expression that carries traced data, skipping
    subtrees that collapse to host scalars (``x.shape``, ``len(x)``,
    ``int(x)``) and compile-time-static names."""
    if isinstance(node, ast.Attribute) and node.attr in _CLEAN_ATTRS:
        return False
    if isinstance(node, ast.Compare) and all(
        isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops
    ):
        return False  # `x is None` checks structure, not values
    if isinstance(node, ast.Call):
        leaf = _name_of(node.func).rsplit(".", 1)[-1]
        if leaf in _SCALAR_WRAPPERS:
            return False
        if isinstance(node.func, ast.Attribute) and node.func.attr in (
            _HOST_RESULT_METHODS
        ):
            return False  # the value is on the host (the read is GL001's)
    if isinstance(node, ast.Name):
        return node.id in tainted and not is_static_name(node.id, statics)
    return any(
        expr_mentions_tainted(c, tainted, statics)
        for c in ast.iter_child_nodes(node)
    )


_SCALAR_ANNOTATIONS = {
    "int", "float", "bool", "str", "bytes", "tuple", "torch.device",
    "torch.dtype", "np.dtype",
}


def _host_annotation(ann, extra) -> bool:
    """Does the annotation promise a host value?  ``int``, ``tuple``,
    ``torch.device`` ... and the declared ``host_annotations``;
    ``Optional[X]``/``X | None``/``tuple[X, ...]`` when X is one."""
    if ann is None:
        return False
    if isinstance(ann, ast.Constant):
        if ann.value is None or ann.value is Ellipsis:
            return True
        if isinstance(ann.value, str):
            try:
                return _host_annotation(
                    ast.parse(ann.value, mode="eval").body, extra
                )
            except SyntaxError:
                return False
        return False
    name = _name_of(ann)
    if name:
        return name in _SCALAR_ANNOTATIONS or name in extra
    if isinstance(ann, ast.BinOp) and isinstance(ann.op, ast.BitOr):
        return _host_annotation(ann.left, extra) and _host_annotation(
            ann.right, extra
        )
    if isinstance(ann, ast.Subscript):
        head = _name_of(ann.value).rsplit(".", 1)[-1]
        inner = ann.slice
        elts = inner.elts if isinstance(inner, ast.Tuple) else [inner]
        if head in ("Optional", "tuple", "Tuple", "Union"):
            return all(_host_annotation(e, extra) for e in elts)
    return False


def scalar_annotated(fn_node, extra=()) -> set:
    """Params annotated as host values (``n: int``, ``dev:
    torch.device``, ``at: Ans`` when ``Ans`` is a declared
    ``host_annotations`` name) — annotations are a repo-enforceable
    contract that a value is never a tensor."""
    out = set()
    for a in fn_node.args.posonlyargs + fn_node.args.args + (
        fn_node.args.kwonlyargs
    ):
        if _host_annotation(a.annotation, set(extra)):
            out.add(a.arg)
    return out


def build_taint(fn: FunctionInfo, statics: set, extra=()) -> set:
    """Tensor-name set for one function: non-static params seed it, and
    assignments propagate it forward (best effort, flow-insensitive)."""
    scalars = scalar_annotated(fn.node, extra)
    tainted = {
        p for p in fn.params
        if p not in scalars
        and not is_static_name(p, statics)
    }
    for n in ast.walk(fn.node):
        if isinstance(n, ast.Assign):
            if expr_mentions_tainted(n.value, tainted, statics):
                for t in n.targets:
                    for leaf in ast.walk(t):
                        if isinstance(leaf, ast.Name):
                            tainted.add(leaf.id)
    return tainted


_TENSOR_METHODS = {
    "to", "astype", "reshape", "view", "ravel", "flatten", "take", "sum",
    "copy", "clone", "int", "long", "float", "double", "gather",
    "index_select", "clamp", "contiguous",
}


def is_array_producing(node) -> bool:
    """Does the expression CONSTRUCT tensors/arrays (``torch.arange``
    etc.) even without touching a tensor input?  Used by GL005: a bare
    float scalar against an int tensor is a promotion site, built or
    passed in.  Scalar dtype wrappers (``np.float32(c)``) do not count."""
    for n in ast.walk(node):
        if isinstance(n, ast.Call):
            if isinstance(n.func, ast.Attribute) and n.func.attr in (
                _TENSOR_METHODS
            ) and _name_of(n.func.value).split(".", 1)[0] not in _MODULE_HEADS:
                return True  # tensor methods return tensors
            name = _name_of(n.func)
            head, _, leaf = name.rpartition(".")
            if head in ("torch", "np", "numpy") and (
                leaf not in _SCALAR_WRAPPERS
            ):
                return True
    return False


# ---------------------------------------------------------------------------
# integer-interval abstract domain (GL011)
# ---------------------------------------------------------------------------
#
# One layer below the dtype lattice: once ExprTyper says an expression is
# INT, the interval interpreter asks HOW BIG.  Values are abstracted to
# [lo, hi] over the extended integers (±inf = "unbounded"); every
# transfer function is conservative — the concrete value is always
# inside the computed interval, so "fits in int32" is a proof, while a
# blown interval is only a *may*-overflow (the finding invites a
# declared bound, a clamp the interpreter can see, or a suppression
# explaining the wrap).

_INF = float("inf")
_I32_MIN, _I32_MAX = -(2 ** 31), 2 ** 31 - 1


def _gmul(a: float, b: float) -> float:
    # extended-integer product where 0 * inf = 0 (an empty stack of
    # unbounded values is still empty), not NaN
    if a == 0 or b == 0:
        return 0
    return a * b


@dataclasses.dataclass(frozen=True)
class Interval:
    lo: float
    hi: float

    def __post_init__(self):
        if self.lo > self.hi:  # pragma: no cover - transfer fns keep order
            raise ValueError(f"inverted interval [{self.lo}, {self.hi}]")

    # -- lattice ---------------------------------------------------------
    def join(self, other: "Interval") -> "Interval":
        return Interval(min(self.lo, other.lo), max(self.hi, other.hi))

    def fits_int32(self) -> bool:
        return self.lo >= _I32_MIN and self.hi <= _I32_MAX

    def __str__(self) -> str:
        def f(v):
            if v == _INF:
                return "+inf"
            if v == -_INF:
                return "-inf"
            return str(int(v))
        return f"[{f(self.lo)}, {f(self.hi)}]"

    # -- arithmetic transfer functions -----------------------------------
    def add(self, o: "Interval") -> "Interval":
        return Interval(self.lo + o.lo, self.hi + o.hi)

    def sub(self, o: "Interval") -> "Interval":
        return Interval(self.lo - o.hi, self.hi - o.lo)

    def neg(self) -> "Interval":
        return Interval(-self.hi, -self.lo)

    def abs(self) -> "Interval":
        if self.lo >= 0:
            return self
        if self.hi <= 0:
            return self.neg()
        return Interval(0, max(-self.lo, self.hi))

    def invert(self) -> "Interval":
        # ~x == -x - 1
        return self.neg().sub(Interval(1, 1))

    def mul(self, o: "Interval") -> "Interval":
        c = [_gmul(a, b) for a in (self.lo, self.hi) for b in (o.lo, o.hi)]
        return Interval(min(c), max(c))

    def floordiv(self, o: "Interval") -> "Interval":
        import math

        def fd(a, b):
            # a/b is monotone in each variable while b keeps one sign,
            # so the 4 corners bound it; floor is monotone too.  The
            # infinite-divisor corner rounds toward 0, which can only
            # WIDEN the result (a/±inf limits to ±0 and the finite
            # corners dominate the other side).
            if a in (_INF, -_INF):
                return a if b > 0 else -a
            if b in (_INF, -_INF):
                return 0
            return math.floor(a / b)

        if o.lo > 0 or o.hi < 0:
            c = [fd(a, b) for a in (self.lo, self.hi) for b in (o.lo, o.hi)]
            return Interval(min(c), max(c))
        return TOP  # divisor may be 0 — nothing provable

    def truncdiv(self, o: "Interval") -> "Interval":
        """C division (toward zero): between the floor and the ceiling of
        the exact quotient, so the floor interval widened by one on the
        side that rounds toward zero."""
        f = self.floordiv(o)
        if f == TOP:
            return TOP
        return Interval(f.lo, f.hi + 1)

    def fmod(self, o: "Interval") -> "Interval":
        # C semantics: the result takes the dividend's sign, |r| < |o|
        m = o.abs()
        if m.lo <= 0 or m.hi == _INF:
            return TOP
        return Interval(-(m.hi - 1) if self.lo < 0 else 0,
                        (m.hi - 1) if self.hi > 0 else 0)

    def mod(self, o: "Interval") -> "Interval":
        # Python/NumPy semantics: result sign follows the divisor
        if o.lo > 0 and o.hi < _INF:
            return Interval(0, o.hi - 1)
        if o.hi < 0 and o.lo > -_INF:
            return Interval(o.lo + 1, 0)
        return TOP

    def lshift(self, o: "Interval") -> "Interval":
        if o.lo < 0 or o.hi > 63:
            return TOP  # silly shift counts prove nothing
        return self.mul(Interval(2 ** int(o.lo), 2 ** int(o.hi)))

    def rshift(self, o: "Interval") -> "Interval":
        if o.lo < 0 or o.hi > 63:
            return TOP
        return self.floordiv(Interval(2 ** int(o.lo), 2 ** int(o.hi)))

    def band(self, o: "Interval") -> "Interval":
        # x & m with m >= 0 lands in [0, m] regardless of x's sign
        # (two's complement); take the tightest non-negative side
        caps = [s.hi for s in (self, o) if s.lo >= 0 and s.hi < _INF]
        if caps:
            return Interval(0, min(caps))
        return TOP

    def bor(self, o: "Interval") -> "Interval":
        # for non-negative x, y: x | y <= x + y (and x ^ y <= x | y)
        if self.lo >= 0 and o.lo >= 0:
            return Interval(0, self.hi + o.hi)
        return TOP

    def imin(self, o: "Interval") -> "Interval":
        return Interval(min(self.lo, o.lo), min(self.hi, o.hi))

    def imax(self, o: "Interval") -> "Interval":
        return Interval(max(self.lo, o.lo), max(self.hi, o.hi))

    def clip(self, lo: "Interval", hi: "Interval") -> "Interval":
        # clip(x, a, b) == min(max(x, a), b)
        return self.imax(lo).imin(hi)

    def summed(self, count: int) -> "Interval":
        """Sum of up to ``count`` elements each in this interval (the
        empty reduction is 0, so 0 is always included)."""
        return Interval(
            min(0, _gmul(count, self.lo)), max(0, _gmul(count, self.hi))
        )


TOP = Interval(-_INF, _INF)
_UNIT = Interval(0, 1)


def _is_true(node) -> bool:
    return isinstance(node, ast.Constant) and node.value is True


def _is_none(node) -> bool:
    return isinstance(node, ast.Constant) and node.value is None


_IVL_PASS_CALLS = {
    "take", "take_along_dim", "take_along_axis", "gather", "index_select",
    "roll", "reshape", "view", "ravel", "broadcast_to", "expand",
    "expand_as", "transpose", "permute", "flip", "squeeze", "unsqueeze",
    "sort", "copy", "clone", "contiguous", "detach", "narrow", "asarray",
    "as_tensor", "tensor", "from_numpy", "array", "require", "tile",
    "repeat",
    "repeat_interleave", "floor", "ceil", "round", "rint", "flatten",
    "astype", "to", "int", "long", "short", "max", "min", "amax", "amin",
}
_IVL_INDEX_CALLS = {"argmax", "argmin", "argsort", "searchsorted",
                    "count_nonzero", "bucketize", "nonzero"}
_IVL_MODULE_ALIASES = {"torch", "np", "numpy", "math", "F"}
# in-place/functional accumulating scatters: x.index_add_(dim, idx, src),
# x.scatter_add_(dim, idx, src) — the source is the third argument
_SCATTER_ADD = {"index_add_", "index_add", "scatter_add_", "scatter_add"}
# overwriting scatters: the result joins the base and the written values
_SCATTER_SET = {
    "index_put_": 1, "index_put": 1, "index_copy_": 2, "index_copy": 2,
    "scatter_": 2, "scatter": 2, "index_fill_": 2, "index_fill": 2,
    "masked_fill_": 1, "masked_fill": 1, "masked_scatter_": 1,
}


def _kwarg(node: ast.Call, name: str):
    return next((kw.value for kw in node.keywords if kw.arg == name), None)


class IntervalEvaluator:
    """Forward interval propagation over one function body.

    Seeds come from three places, in priority order: local assignments
    (tracked flow-insensitively, same compromise as ExprTyper), the
    declared ``[tool.graftlint.gl011.bounds]`` name bounds (parameters
    AND ``cfg.<attr>`` leaves), and ``call_bounds`` for calls whose
    result range is a contract of their own parity tests.  Reductions
    use the per-zone ``sum_elems`` element-count cap.  Anything else is
    TOP = [-inf, +inf]: unprovable, which for a checked op means a
    finding — the fix is a declaration, not a shrug."""

    def __init__(
        self,
        bounds: dict,
        call_bounds: dict,
        sum_elems: int,
        module_env: dict | None = None,
        is_bool=None,
        pass_calls: dict | None = None,
    ) -> None:
        self.bounds = bounds
        self.call_bounds = call_bounds
        # helpers whose result carries one argument's interval ({leaf:
        # argument index}: a cached upload of a constant table, a select)
        self.pass_calls = pass_calls or {}
        self.sum_elems = sum_elems
        self.module_env = dict(module_env or {})
        # naming-convention bool names (masks, validity planes) are
        # [0, 1] once cast to int — the typer's patterns decide
        self.is_bool = is_bool or (lambda _n: False)

    # -- environment ------------------------------------------------------

    def build_env(self, fn_node, params) -> dict:
        env = dict(self.module_env)
        for p in params:
            if p in self.bounds:
                env[p] = self.bounds[p]
        for n in ast.walk(fn_node):
            if isinstance(n, ast.Assign) and len(n.targets) == 1:
                t = n.targets[0]
                if isinstance(t, ast.Name):
                    env[t.id] = self.eval(n.value, env)
                elif isinstance(t, ast.Tuple):
                    self._unpack(t, n.value, env)
            elif isinstance(n, ast.AugAssign) and isinstance(
                n.target, ast.Name
            ):
                cur = env.get(n.target.id, self._name_ivl(n.target.id))
                env[n.target.id] = self._binop(
                    n.op, cur, self.eval(n.value, env)
                )
            elif isinstance(n, ast.For) and isinstance(n.target, ast.Name):
                env[n.target.id] = self._loop_ivl(n.iter, env)
        return env

    def _unpack(self, tgt: ast.Tuple, value, env) -> None:
        if isinstance(value, ast.Tuple) and len(value.elts) == len(tgt.elts):
            for te, ve in zip(tgt.elts, value.elts):
                if isinstance(te, ast.Name):
                    env[te.id] = self.eval(ve, env)
            return
        # `a, b = f(...)` — a call contract bounds every element
        ivl = self.eval(value, env)
        for te in tgt.elts:
            if isinstance(te, ast.Name):
                env[te.id] = ivl

    def _loop_ivl(self, it, env) -> Interval:
        if isinstance(it, ast.Call) and _name_of(it.func).rsplit(
            ".", 1
        )[-1] == "range":
            args = [self.eval(a, env) for a in it.args]
            if len(args) == 1 and args[0].hi > -_INF:
                return Interval(0, max(0, args[0].hi - 1))
            if len(args) >= 2:
                return Interval(min(args[0].lo, args[1].hi - 1), max(
                    args[0].lo, args[1].hi - 1
                ))
        return TOP

    def _name_ivl(self, name: str) -> Interval:
        if name in self.bounds:
            return self.bounds[name]
        if self.is_bool(name):
            return _UNIT
        return TOP

    # -- expression evaluation --------------------------------------------

    def eval(self, node, env) -> Interval:  # noqa: C901 - a domain is a switch
        if isinstance(node, ast.Constant):
            if isinstance(node.value, bool):
                return _UNIT
            if isinstance(node.value, (int, float)):
                return Interval(node.value, node.value)
            return TOP
        if isinstance(node, ast.Name):
            # a derived env entry that collapsed to TOP must not shadow
            # a DECLARED bound (or the bool [0,1] convention): declared
            # bounds are contracts, and assignments that violate them
            # are flagged separately by the GL011 escape check — so the
            # contract stays usable even where derivation gives up
            v = env.get(node.id)
            if v is not None and v != TOP:
                return v
            return self._name_ivl(node.id)
        if isinstance(node, ast.Attribute):
            # cfg.clamp_q — the declared bounds speak for config leaves
            return self.bounds.get(node.attr, TOP)
        if isinstance(node, ast.UnaryOp):
            v = self.eval(node.operand, env)
            if isinstance(node.op, ast.USub):
                return v.neg()
            if isinstance(node.op, ast.Invert):
                return v.invert()
            if isinstance(node.op, ast.Not):
                return _UNIT
            return v
        if isinstance(node, (ast.Compare, ast.BoolOp)):
            return _UNIT
        if isinstance(node, ast.BinOp):
            return self._binop(
                node.op, self.eval(node.left, env), self.eval(node.right, env)
            )
        if isinstance(node, ast.IfExp):
            return self.eval(node.body, env).join(
                self.eval(node.orelse, env)
            )
        if isinstance(node, ast.Subscript):
            return self.eval(node.value, env)
        if isinstance(node, (ast.Tuple, ast.List)):
            out = None
            for e in node.elts:
                v = self.eval(e, env)
                out = v if out is None else out.join(v)
            return out if out is not None else TOP
        if isinstance(node, ast.Starred):
            return self.eval(node.value, env)
        if isinstance(node, ast.Call):
            return self._call(node, env)
        return TOP

    def _clamp(self, base: Interval, args, node, env) -> Interval:
        """``clamp(x, lo, hi)`` / ``x.clamp(lo, hi)`` / ``min=``/``max=``
        keywords; an absent side leaves that end of ``x`` as it is."""
        lo = args[0] if len(args) >= 1 else _kwarg(node, "min")
        hi = args[1] if len(args) >= 2 else _kwarg(node, "max")
        if lo is not None and not _is_none(lo):
            base = base.imax(self.eval(lo, env))
        if hi is not None and not _is_none(hi):
            base = base.imin(self.eval(hi, env))
        return base

    def _binop(self, op, lv: Interval, rv: Interval) -> Interval:
        if isinstance(op, ast.Add):
            return lv.add(rv)
        if isinstance(op, ast.Sub):
            return lv.sub(rv)
        if isinstance(op, ast.Mult):
            return lv.mul(rv)
        if isinstance(op, ast.FloorDiv):
            return lv.floordiv(rv)
        if isinstance(op, ast.Mod):
            return lv.mod(rv)
        if isinstance(op, ast.LShift):
            return lv.lshift(rv)
        if isinstance(op, ast.RShift):
            return lv.rshift(rv)
        if isinstance(op, ast.BitAnd):
            return lv.band(rv)
        if isinstance(op, (ast.BitOr, ast.BitXor)):
            return lv.bor(rv)
        return TOP  # Div (float), Pow, MatMult: outside the int32 story

    def _call(self, node: ast.Call, env) -> Interval:  # noqa: C901
        name = _name_of(node.func)
        # the leaf must come from the Attribute itself, not the dotted
        # path: `torch.stack(...).reshape(...)` has no plain dotted name
        # (the receiver is a Call), but its leaf is still `reshape`
        if isinstance(node.func, ast.Attribute):
            leaf = node.func.attr
        else:
            leaf = name.rsplit(".", 1)[-1] if name else ""
        if leaf in self.call_bounds:
            return self.call_bounds[leaf]
        if leaf in self.pass_calls:
            i = self.pass_calls[leaf]
            return self.eval(node.args[i], env) if len(node.args) > i else TOP
        # `x.clip(a, b)` / `x.sum()` are method forms whose receiver
        # carries the interval — but `torch.clamp(x, a, b)` spells the same
        # leaf with a MODULE receiver and the array in args[0]; treating
        # `torch` as the receiver would hand every such call TOP (or worse,
        # shift the clip bounds by one argument), so module-qualified
        # calls fall through to the free-function transfers below.
        recv_root = (
            _name_of(node.func.value).split(".", 1)[0]
            if isinstance(node.func, ast.Attribute) else ""
        )
        is_method = (
            isinstance(node.func, ast.Attribute)
            and recv_root not in _IVL_MODULE_ALIASES
        )
        if is_method and leaf in _SCATTER_ADD:
            base = self.eval(node.func.value, env)
            src = node.args[2] if len(node.args) >= 3 else _kwarg(node, "source")
            val = self.eval(src, env) if src is not None else TOP
            return base.add(val.summed(self.sum_elems))
        if is_method and leaf in _SCATTER_SET:
            base = self.eval(node.func.value, env)
            i = _SCATTER_SET[leaf]
            val = node.args[i] if len(node.args) > i else None
            v = self.eval(val, env) if val is not None else TOP
            if leaf.startswith("index_put") and _is_true(
                _kwarg(node, "accumulate")
            ):
                return base.add(v.summed(self.sum_elems))
            return base.join(v)
        if is_method and leaf in (
            "clip", "clamp", "clamp_min", "clamp_max", "sum", "cumsum",
            "remainder", "abs",
        ) or is_method and leaf in _IVL_PASS_CALLS:
            base = self.eval(node.func.value, env)
            if leaf in ("clip", "clamp"):
                return self._clamp(base, node.args, node, env)
            if leaf == "clamp_min" and node.args:
                return base.imax(self.eval(node.args[0], env))
            if leaf == "clamp_max" and node.args:
                return base.imin(self.eval(node.args[0], env))
            if leaf in ("sum", "cumsum"):
                return base.summed(self.sum_elems)
            if leaf == "remainder" and node.args:
                return base.mod(self.eval(node.args[0], env))
            if leaf == "abs":
                return base.abs()
            return base
        if leaf in ("clip", "clamp") and node.args:
            return self._clamp(
                self.eval(node.args[0], env), node.args[1:], node, env
            )
        if leaf == "div" and len(node.args) == 2:
            mode = _kwarg(node, "rounding_mode")
            a, b = self.eval(node.args[0], env), self.eval(node.args[1], env)
            if isinstance(mode, ast.Constant) and mode.value == "floor":
                return a.floordiv(b)
            if isinstance(mode, ast.Constant) and mode.value == "trunc":
                return a.truncdiv(b)
            return TOP
        if leaf in ("remainder", "fmod") and len(node.args) == 2:
            a, b = self.eval(node.args[0], env), self.eval(node.args[1], env)
            if leaf == "remainder":
                return a.mod(b)
            return a.fmod(b)
        if leaf in ("bitwise_and", "bitwise_or", "bitwise_xor",
                    "bitwise_left_shift", "bitwise_right_shift") and (
            len(node.args) == 2
        ):
            a, b = self.eval(node.args[0], env), self.eval(node.args[1], env)
            return {
                "bitwise_and": a.band, "bitwise_or": a.bor,
                "bitwise_xor": a.bor, "bitwise_left_shift": a.lshift,
                "bitwise_right_shift": a.rshift,
            }[leaf](b)
        if leaf in ("sum", "cumsum") and node.args:
            return self.eval(node.args[0], env).summed(self.sum_elems)
        if leaf == "where" and len(node.args) == 3:
            return self.eval(node.args[1], env).join(
                self.eval(node.args[2], env)
            )
        if leaf == "select" and len(node.args) == 3:
            return self.eval(node.args[1], env).join(
                self.eval(node.args[2], env)
            )
        if leaf in ("abs", "absolute"):
            return self.eval(node.args[0], env).abs() if node.args else TOP
        if leaf in ("minimum", "min") and len(node.args) == 2 and (
            not is_method
        ):
            return self.eval(node.args[0], env).imin(
                self.eval(node.args[1], env)
            )
        if leaf in ("maximum", "max") and len(node.args) == 2 and (
            not is_method
        ):
            return self.eval(node.args[0], env).imax(
                self.eval(node.args[1], env)
            )
        if leaf == "mod" and len(node.args) == 2:
            return self.eval(node.args[0], env).mod(
                self.eval(node.args[1], env)
            )
        if leaf in ("zeros", "zeros_like", "empty", "empty_like"):
            return Interval(0, 0)
        if leaf in ("ones", "ones_like"):
            return Interval(1, 1)
        if leaf in ("full", "full_like", "new_full"):
            v = node.args[1] if len(node.args) >= 2 else _kwarg(
                node, "fill_value"
            )
            return self.eval(v, env) if v is not None else TOP
        if leaf in ("new_zeros", "new_empty"):
            return Interval(0, 0)
        if leaf == "new_ones":
            return Interval(1, 1)
        if leaf == "arange":
            args = [self.eval(a, env) for a in node.args]
            if len(args) == 1 and args[0].hi < _INF:
                return Interval(0, max(0, args[0].hi - 1))
            if len(args) >= 2 and args[1].hi < _INF:
                return Interval(min(args[0].lo, 0), max(args[1].hi - 1, 0))
            return TOP
        if leaf == "sign":
            return Interval(-1, 1)
        if leaf in _IVL_INDEX_CALLS:
            return Interval(0, max(0, self.sum_elems))
        if leaf == "pad" and node.args:
            return self.eval(node.args[0], env).join(Interval(0, 0))
        if leaf in ("concatenate", "cat", "stack", "hstack", "vstack") and (
            node.args
        ):
            return self.eval(node.args[0], env)
        if leaf in ("int32", "int16", "int8", "int64", "int",
                    "uint8", "uint16", "uint32",
                    "float32", "float64", "float16", "bfloat16", "float"):
            return self.eval(node.args[0], env) if node.args else TOP
        if leaf == "len":
            return Interval(0, _INF)
        if leaf in _IVL_PASS_CALLS and node.args:
            return self.eval(node.args[0], env)
        return TOP


# ---------------------------------------------------------------------------
# thread-entry points + lock discovery (GL012)
# ---------------------------------------------------------------------------

_LOCK_CTORS = {"Lock", "RLock", "Condition", "Semaphore", "BoundedSemaphore"}


def thread_roots(mod: ModuleFile) -> list:
    """Every function this module hands to a thread: the ``target=`` of
    a ``threading.Thread`` and the callback of a ``threading.Timer``,
    resolved to a FunctionInfo when the target is ``self.X`` (a sibling
    method) or a bare module-level name.  Each is the entry point of a
    distinct execution context."""
    out = []
    for fn in mod.functions.values():
        for n in ast.walk(fn.node):
            if not isinstance(n, ast.Call):
                continue
            leaf = _name_of(n.func).rsplit(".", 1)[-1]
            tgt_expr = None
            if leaf == "Thread":
                tgt_expr = next(
                    (kw.value for kw in n.keywords if kw.arg == "target"),
                    None,
                )
            elif leaf == "Timer":
                tgt_expr = next(
                    (kw.value for kw in n.keywords if kw.arg == "function"),
                    n.args[1] if len(n.args) >= 2 else None,
                )
            if tgt_expr is None:
                continue
            tgt = None
            if (
                isinstance(tgt_expr, ast.Attribute)
                and isinstance(tgt_expr.value, ast.Name)
                and tgt_expr.value.id == "self"
                and fn.cls is not None
            ):
                tgt = mod.functions.get(f"{fn.cls}.{tgt_expr.attr}")
            elif isinstance(tgt_expr, ast.Name):
                tgt = mod.functions.get(tgt_expr.id)
            if tgt is not None and tgt not in out:
                out.append(tgt)
    return out


def class_locks(mod: ModuleFile) -> dict:
    """``{class name: {attrs assigned threading.Lock()/RLock()/
    Condition()/Semaphore()}}`` — the lock inventory GL012's
    acquisition-order graph is built over (the guarded-field map itself
    is declared in graftlint.toml, but which attributes ARE locks is a code
    fact)."""
    out: dict = {}
    for n in ast.walk(mod.tree):
        if not isinstance(n, ast.ClassDef):
            continue
        attrs = set()
        for a in ast.walk(n):
            if isinstance(a, ast.Assign) and isinstance(a.value, ast.Call):
                leaf = _name_of(a.value.func).rsplit(".", 1)[-1]
                if leaf in _LOCK_CTORS:
                    for t in a.targets:
                        if (
                            isinstance(t, ast.Attribute)
                            and isinstance(t.value, ast.Name)
                            and t.value.id == "self"
                        ):
                            attrs.add(t.attr)
        if attrs:
            out[n.name] = attrs
    return out


def locks_held_at(fn_node, line: int, lock_attrs: set) -> set:
    """The set of ``self.<lock>`` attributes held at ``line``: every
    ``with self.L:`` (or ``with self.L1, self.L2:``) whose body spans
    the line.  Purely lexical — helper-acquired locks don't count, which
    is the right bias for a race DETECTOR (claiming a lock is held when
    it isn't would hide races)."""
    held = set()
    for w in ast.walk(fn_node):
        if not isinstance(w, ast.With):
            continue
        if not (w.lineno <= line <= (w.end_lineno or w.lineno)):
            continue
        for item in w.items:
            e = item.context_expr
            if (
                isinstance(e, ast.Attribute)
                and isinstance(e.value, ast.Name)
                and e.value.id == "self"
                and e.attr in lock_attrs
            ):
                held.add(e.attr)
    return held


def self_attr_writes(fn_node):
    """Yield ``(attr, lineno)`` for every ``self.X = ...`` /
    ``self.X += ...`` in the function (nested defs included — a closure
    still runs on its thread)."""
    for n in ast.walk(fn_node):
        targets = ()
        if isinstance(n, ast.Assign):
            targets = n.targets
        elif isinstance(n, (ast.AugAssign, ast.AnnAssign)):
            targets = (n.target,) if n.target is not None else ()
        for t in targets:
            for leaf in ast.walk(t):
                if (
                    isinstance(leaf, ast.Attribute)
                    and isinstance(leaf.value, ast.Name)
                    and leaf.value.id == "self"
                    and isinstance(leaf.ctx, ast.Store)
                ):
                    yield leaf.attr, n.lineno

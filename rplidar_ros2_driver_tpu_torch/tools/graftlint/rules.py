"""The thirteen graftlint rules.  Each takes the RepoIndex and yields
Findings; suppression/baseline handling lives in the runner.  Rule
docstrings double as the rationale text ``--explain GLxxx`` prints.

The rules keep their codes and the meaning of every marker; each speaks
PyTorch's idiom: the device steps are declared (``device_roots``), a host
sync is ``.item()``/``.tolist()``/``.cpu()``/``.numpy()``/
``torch.cuda.synchronize``, a compiled binding is a ``KernelEntry`` (or a
``load_library`` call), dispatch on a read path is any tensor-producing
``torch.*`` call.  Where a JAX idiom has no PyTorch form (donated
buffers, ``static_argnames``, the bench pins), the rule says so in its
rationale and yields nothing for that half."""

from __future__ import annotations

import ast
import os
import re

from rplidar_ros2_driver_tpu_torch.tools.graftlint.model import (
    BOOL,
    FLOAT,
    INT,
    UNKNOWN,
    ExprTyper,
    Finding,
    Interval,
    IntervalEvaluator,
    RepoIndex,
    StaticNames,
    _name_of,
    build_taint,
    cast_target,
    class_locks,
    dtype_aliases,
    expr_mentions_tainted,
    is_array_producing,
    is_static_name,
    locks_held_at,
    scalar_annotated,
    self_attr_writes,
    thread_roots,
)

_NP_HEADS = {"np", "numpy"}
_ARRAY_HEADS = {"np", "numpy", "torch"}
_KERNELS_RE = re.compile(r"(^|/)ops/[^/]*_kernels\.py$")
# GL010: the compiled-binding layer (its own modules define the bindings),
# the constructor whose instances are kernel entries, and the loader
_BINDING_MODULES = ("utils/cuda_build.py", "utils/launch.py")
_BINDING_CTOR = "KernelEntry"
_BINDING_LOADER = "load_library"
# GL013: torch.* calls that make no tensor and touch no device
_HOST_TORCH_CALLS = {
    "torch.device", "torch.is_tensor", "torch.cuda.is_available",
    "torch.cuda.device_count", "torch.get_num_threads",
    "torch.get_default_dtype", "torch.no_grad", "torch.inference_mode",
}


def _head_leaf(call: ast.Call) -> tuple:
    name = _name_of(call.func)
    head, _, leaf = name.rpartition(".")
    return head, leaf


def _statics(index: RepoIndex) -> set:
    return StaticNames(index.cfg.static_params)


def _module_aliases(index: RepoIndex, mod) -> dict:
    """The module's dtype aliases, with those it imports by name."""
    out = {}
    for name, (src, orig) in mod.from_imports.items():
        other = index.modules.get(src)
        if other is not None:
            got = dtype_aliases(other.tree).get(orig)
            if got is not None:
                out[name] = got
    out.update(dtype_aliases(mod.tree))
    return out


def _hosts(index: RepoIndex) -> tuple:
    return index.cfg.host_annotations


def _reachable_functions(index: RepoIndex):
    keys = index.reachable_from(index.device_roots())
    by_key = index.functions_by_key()
    return [by_key[k] for k in sorted(keys) if k in by_key]


def _top_functions(mod):
    """Module functions minus nested defs (a nested def rides its
    IMMEDIATE parent's walk, so closures inside methods are skipped too
    and never double-reported)."""
    for fn in mod.functions.values():
        if "." in fn.qualname and fn.qualname.rsplit(".", 1)[0] in (
            mod.functions
        ):
            continue
        yield fn


def _first_line(fn) -> int:
    return (
        fn.node.decorator_list[0].lineno
        if fn.node.decorator_list else fn.node.lineno
    )


def _is_module_receiver(func) -> bool:
    return isinstance(func, ast.Attribute) and _name_of(func.value).split(
        ".", 1
    )[0] in _ARRAY_HEADS | {"math", "F"}


# ---------------------------------------------------------------------------
# GL001 — host syncs reachable from the device steps
# ---------------------------------------------------------------------------

_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}


def _declared_sync_spans(fn_node) -> list:
    """Line spans of ``with guards.declared_sync():`` blocks — the one
    sanctioned scope of a synchronising transfer (utils/guards.py)."""
    spans = []
    for w in ast.walk(fn_node):
        if not isinstance(w, (ast.With, ast.AsyncWith)):
            continue
        for item in w.items:
            e = item.context_expr
            if isinstance(e, ast.Call) and _name_of(e.func).rsplit(
                ".", 1
            )[-1] == "declared_sync":
                spans.append((w.lineno, w.end_lineno or w.lineno))
    return spans


def _tensor_receiver(node, tainted, statics) -> bool:
    """May ``node`` be a tensor?  It mentions a tensor name, or it is
    built by a ``torch.*`` call; a NumPy value or a host name is not."""
    if expr_mentions_tainted(node, tainted, statics):
        return True
    return any(
        isinstance(c, ast.Call) and _name_of(c.func).split(".", 1)[0] == "torch"
        for c in ast.walk(node)
    )


def rule_gl001(index: RepoIndex):
    """GL001 — host syncs reachable from a device step.

    The declared device steps (``device_roots`` in graftlint.toml: the
    filter step, the fleet tick and super-step, the fleet matcher, the
    loop-closure check, the pose-graph solver, the sharded step) are the
    code whose launches the host must only ever queue.  Anything they
    reach that waits on the card — ``.item()``, ``.tolist()``,
    ``.cpu()``, ``.numpy()``, ``torch.cuda.synchronize``, or
    ``int``/``float``/``bool`` of a tensor argument — stalls the host
    behind the queue, and at runtime only ``guards.steady_state`` on the
    paths a smoke run drives would notice.  A transfer that must block is
    declared: it sits inside ``with guards.declared_sync():``, which this
    rule accepts (as the runtime guard does)."""
    statics = _statics(index)
    for fn in _reachable_functions(index):
        mod = fn.module
        scalars = scalar_annotated(fn.node, _hosts(index))
        tensors = {
            p for p in fn.params
            if p not in scalars and not is_static_name(p, statics)
        }
        tainted = build_taint(fn, statics, _hosts(index))
        spans = _declared_sync_spans(fn.node)
        for n in ast.walk(fn.node):
            if not isinstance(n, ast.Call):
                continue
            if any(a <= n.lineno <= b for a, b in spans):
                continue
            msg = None
            name = _name_of(n.func)
            if (
                isinstance(n.func, ast.Attribute)
                and n.func.attr in _SYNC_METHODS
                and not _is_module_receiver(n.func)
                and _tensor_receiver(n.func.value, tainted, statics)
            ):
                msg = (f".{n.func.attr}() in device-step-reachable "
                       f"{fn.qualname} forces a device->host sync")
            elif name in ("torch.cuda.synchronize", "cuda.synchronize"):
                msg = (f"torch.cuda.synchronize in device-step-reachable "
                       f"{fn.qualname} waits for the whole queue")
            elif (
                isinstance(n.func, ast.Name)
                and n.func.id in ("int", "float", "bool")
                and len(n.args) == 1
                and isinstance(n.args[0], ast.Name)
                and n.args[0].id in tensors
            ):
                msg = (f"{n.func.id}({n.args[0].id}) on a tensor argument "
                       f"of {fn.qualname} forces a host sync")
            if msg and not mod.suppressed("GL001", n.lineno):
                yield Finding("GL001", mod.relpath, n.lineno, msg)


# ---------------------------------------------------------------------------
# GL002 — Python branching on tensor values in the device steps
# ---------------------------------------------------------------------------

def _is_none_check(test: ast.AST) -> bool:
    return isinstance(test, ast.Compare) and all(
        isinstance(op, (ast.Is, ast.IsNot)) for op in test.ops
    )


def rule_gl002(index: RepoIndex):
    """GL002 — Python ``if``/``while`` on tensor values in code a device
    step reaches.

    ``if t > 0:`` on a tensor calls ``bool(t)``: on the card that is a
    blocking read of the queue's tail, hidden in a branch.  The test is
    the JAX rule's taint walk over the same roots as GL001: parameters
    that are not declared host values (``static_params``, ``cfg``-like
    names, scalar annotations) and the names assigned from them are
    tensors; ``x.shape``/``len(x)``/``int(...)`` collapse to host
    scalars; ``x is None`` checks structure, not values.  Use
    ``torch.where`` or keep the decision on the host."""
    statics = _statics(index)
    for fn in _reachable_functions(index):
        mod = fn.module
        tainted = build_taint(fn, statics, _hosts(index))
        for inner in ast.walk(fn.node):
            if isinstance(inner, (ast.FunctionDef, ast.AsyncFunctionDef)):
                scalars = scalar_annotated(inner, _hosts(index))
                for a in inner.args.posonlyargs + inner.args.args:
                    if a.arg not in scalars and not is_static_name(
                        a.arg, statics
                    ):
                        tainted.add(a.arg)
        for n in ast.walk(fn.node):
            if not isinstance(n, (ast.If, ast.While)):
                continue
            if _is_none_check(n.test):
                continue
            if expr_mentions_tainted(n.test, tainted, statics):
                if not mod.suppressed("GL002", n.lineno):
                    kind = "while" if isinstance(n, ast.While) else "if"
                    yield Finding(
                        "GL002", mod.relpath, n.lineno,
                        f"Python `{kind}` on tensor value "
                        f"`{ast.unparse(n.test)}` in {fn.qualname} — use "
                        "torch.where (branching on a tensor is a hidden "
                        "device->host sync)",
                    )


# ---------------------------------------------------------------------------
# GL003 — in-place carried state read through a stale alias
# ---------------------------------------------------------------------------

_INPLACE_RE = re.compile(r"^[a-z][a-z0-9_]*[a-z0-9]_$")


def _root_of(node) -> str | None:
    """The Name an attribute/subscript chain hangs from (``s.ring[0]`` ->
    "s")."""
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def _mutated_params(fn) -> set:
    """Parameters the function updates IN PLACE: a store through an
    attribute or subscript hanging from the parameter, or an in-place
    tensor method (``copy_``, ``index_put_``, ``add_`` ...) called on it."""
    params = set(fn.params)
    out = set()
    for n in ast.walk(fn.node):
        targets = ()
        if isinstance(n, ast.Assign):
            targets = n.targets
        elif isinstance(n, ast.AugAssign):
            targets = (n.target,)
        for t in targets:
            if isinstance(t, (ast.Attribute, ast.Subscript)):
                r = _root_of(t)
                if r in params:
                    out.add(r)
        if (
            isinstance(n, ast.Call)
            and isinstance(n.func, ast.Attribute)
            and _INPLACE_RE.match(n.func.attr)
        ):
            r = _root_of(n.func.value)
            if r in params:
                out.add(r)
    return out - {"self"}


def rule_gl003(index: RepoIndex):
    """GL003 — a carried state a device step updates in place, read
    through an alias taken before the call.

    JAX's form (a donated buffer read after its call) has no PyTorch
    counterpart: nothing is donated, and a tensor the step writes in
    place stays valid.  The hazard that remains is the mirror image: an
    alias taken BEFORE the call (``old = state.ring``) is the same
    storage the step then overwrites, so reading it afterwards sees the
    post-step values, not the snapshot its name promises.  For every
    declared device step that updates a parameter in place (a store
    through ``p.x``/``p[i]`` or an in-place method ``p.x.copy_(...)``),
    each call site is checked: a name bound to that argument (or to an
    attribute/subscript of it) before the call and loaded after it is a
    finding.  Clone the snapshot, or read it before the step."""
    roots = {
        (f.module.relpath, f.qualname): f for f in index.device_roots()
    }
    mutated = {k: _mutated_params(f) for k, f in roots.items()}
    mutated = {k: v for k, v in mutated.items() if v}
    if not mutated:
        return
    for rel, mod in sorted(index.modules.items()):
        for fn in _top_functions(mod):
            for call in ast.walk(fn.node):
                if not isinstance(call, ast.Call):
                    continue
                tgt = index.resolve_call(mod, call.func)
                if tgt is None:
                    continue
                key = (tgt.module.relpath, tgt.qualname)
                if key not in mutated:
                    continue
                args = {}
                for i, p in enumerate(tgt.params):
                    if i < len(call.args):
                        args[p] = call.args[i]
                for kw in call.keywords:
                    if kw.arg:
                        args[kw.arg] = kw.value
                for p in sorted(mutated[key]):
                    a = args.get(p)
                    if a is None:
                        continue
                    yield from _gl003_stale_alias(mod, fn, call, tgt, a)


def _gl003_stale_alias(mod, fn, call, tgt, arg):
    text = ast.unparse(arg)
    aliases = {}
    for n in ast.walk(fn.node):
        if (
            isinstance(n, ast.Assign) and len(n.targets) == 1
            and isinstance(n.targets[0], ast.Name)
            and n.lineno < call.lineno
            and isinstance(n.value, (ast.Name, ast.Attribute, ast.Subscript))
        ):
            v = ast.unparse(n.value)
            if v == text or v.startswith(text + ".") or v.startswith(
                text + "["
            ):
                aliases[n.targets[0].id] = n.lineno
    end = call.end_lineno or call.lineno
    for name, bound in sorted(aliases.items()):
        rebound = any(
            isinstance(x, ast.Name) and x.id == name
            and isinstance(x.ctx, ast.Store) and bound < x.lineno <= end
            for x in ast.walk(fn.node)
        )
        if rebound:
            continue
        later = sorted(
            x.lineno for x in ast.walk(fn.node)
            if isinstance(x, ast.Name) and x.id == name
            and isinstance(x.ctx, ast.Load) and x.lineno > end
        )
        if later and not mod.suppressed("GL003", later[0]) and not (
            mod.suppressed("GL003", call.lineno)
        ):
            yield Finding(
                "GL003", mod.relpath, later[0],
                f"`{name}` aliases `{text}` before {tgt.qualname} (line "
                f"{call.lineno}) updates it in place and is read "
                "afterwards — it sees the post-step values; clone the "
                "snapshot or read it before the step",
            )


# ---------------------------------------------------------------------------
# GL004 — bit-exact zones: float reductions / unpoliced casts
# ---------------------------------------------------------------------------

_REDUCTIONS = {
    "sum", "mean", "dot", "einsum", "matmul", "tensordot", "vdot",
    "inner", "cumsum", "prod", "cumprod", "mm", "bmm", "mv", "nansum",
}
_METHOD_REDUCTIONS = {
    "sum", "mean", "dot", "cumsum", "prod", "matmul", "mm", "bmm", "mv",
    "nansum",
}


def _zone_env(index, mod, typer):
    module_env = {}
    for n in mod.tree.body:
        if isinstance(n, ast.Assign) and len(n.targets) == 1 and (
            isinstance(n.targets[0], ast.Name)
        ):
            module_env[n.targets[0].id] = typer.etype(n.value, module_env)
    return module_env


def rule_gl004(index: RepoIndex):
    """GL004 — bit-exact zones: float reductions and unpoliced float→int
    casts.

    The zones (``[tool.graftlint.gl004] zones``) are held byte-equal to
    the JAX package and between the card and the CPU.  A float
    reduction — ``torch.sum``/``.sum()``/``.mean()``/``matmul``/``@``/
    ``einsum``/``cumsum`` over float data — re-associates differently
    per backend and per launch geometry, so f32 accumulation breaks that
    parity by ulps.  A float→int cast (``.to(torch.int32)``, ``.int()``,
    ``.long()``, ``torch.as_tensor(x, dtype=int)``) of an unpoliced
    value is undefined at NaN/inf and out of range; mark the clamp that
    makes it safe with ``# graftlint: policed — <why>``."""
    for rel in index.cfg.zones:
        mod = index.modules.get(rel)
        if mod is None:
            continue
        aliases = _module_aliases(index, mod)
        typer = ExprTyper(index.cfg, aliases=aliases)
        module_env = _zone_env(index, mod, typer)
        typer = ExprTyper(index.cfg, module_env, aliases)
        for fn in mod.functions.values():
            if "." in fn.qualname and fn.qualname.split(".")[0] in (
                mod.functions
            ):
                continue  # nested defs ride their parent's walk
            env = typer.build_env(fn.node)
            for n in ast.walk(fn.node):
                if isinstance(n, ast.BinOp) and isinstance(n.op, ast.MatMult):
                    yield from _gl004_matmul_op(mod, fn, n, typer, env)
                if not isinstance(n, ast.Call):
                    continue
                yield from _gl004_reduction(mod, fn, n, typer, env)
                yield from _gl004_cast(mod, fn, n, typer, env)


def _gl004_finding(mod, fn, n, leaf, kind):
    if kind in (FLOAT, UNKNOWN) and not mod.suppressed("GL004", n.lineno):
        yield Finding(
            "GL004", mod.relpath, n.lineno,
            f"float{'' if kind == FLOAT else '-or-unknown'} reduction "
            f"`{leaf}` in bit-exact zone function {fn.qualname} — "
            "reduction order differs between the card, the CPU and NumPy, "
            "so f32 accumulation breaks byte parity",
        )


def _gl004_matmul_op(mod, fn, n, typer, env):
    kind = _join_kinds(typer.etype(n.left, env), typer.etype(n.right, env))
    yield from _gl004_finding(mod, fn, n, "@", kind)


def _join_kinds(*kinds) -> str:
    if FLOAT in kinds:
        return FLOAT
    if UNKNOWN in kinds:
        return UNKNOWN
    return INT


def _gl004_reduction(mod, fn, n, typer, env):
    head, leaf = _head_leaf(n)
    if isinstance(n.func, ast.Attribute):
        leaf = n.func.attr
    if leaf not in _REDUCTIONS:
        return
    is_mod_call = head in _ARRAY_HEADS
    is_method = (
        isinstance(n.func, ast.Attribute)
        and not _is_module_receiver(n.func)
        and leaf in _METHOD_REDUCTIONS
    )
    if not (is_mod_call or is_method):
        return
    dt = next((kw.value for kw in n.keywords if kw.arg == "dtype"), None)
    if dt is not None:
        kind = typer.dtype_kind(dt)
    elif leaf == "einsum":
        kind = _join_kinds(*(typer.etype(a, env) for a in n.args[1:]))
    elif is_method:
        kind = typer.etype(n.func.value, env)
        if leaf in ("dot", "matmul", "mm", "bmm", "mv") and n.args:
            kind = _join_kinds(kind, typer.etype(n.args[0], env))
    elif leaf in ("dot", "matmul", "mm", "bmm", "mv", "tensordot", "vdot",
                  "inner") and len(n.args) >= 2:
        kind = _join_kinds(
            typer.etype(n.args[0], env), typer.etype(n.args[1], env)
        )
    else:
        kind = typer.etype(n.args[0], env) if n.args else UNKNOWN
    if kind == BOOL:
        kind = INT  # sums of masks accumulate exactly
    yield from _gl004_finding(mod, fn, n, leaf, kind)


def _gl004_cast(mod, fn, n, typer, env):
    cast = cast_target(n, typer.aliases)
    if cast is None:
        return
    kind_to, src = cast
    if kind_to != INT or src is None:
        return
    if typer.etype(src, env) == FLOAT:
        if not mod.policed(n.lineno) and not mod.suppressed(
            "GL004", n.lineno
        ):
            yield Finding(
                "GL004", mod.relpath, n.lineno,
                f"float→int cast `{ast.unparse(n)[:60]}` in bit-exact "
                f"zone function {fn.qualname} without a policing marker — "
                "out-of-range/NaN float→int conversion is implementation-"
                "defined and the card, the CPU and NumPy disagree (mark "
                "the clamp with `# graftlint: policed — <why the value is "
                "in range>`)",
            )


# ---------------------------------------------------------------------------
# GL005 — float scalars mixed into int tensors in bit-exact zones
# ---------------------------------------------------------------------------

_GL005_OPS = (ast.Add, ast.Sub, ast.Mult, ast.Div, ast.FloorDiv, ast.Mod,
              ast.Pow)
_FLOAT_WRAPPERS = {"float16", "float32", "float64", "bfloat16"}


def rule_gl005(index: RepoIndex):
    """GL005 — a bare Python float scalar mixed into an int tensor in a
    bit-exact zone.

    ``int_tensor * 0.5`` silently promotes to the default float dtype:
    the int32 fixed-point story of the zone ends at that operator, and
    whether the result is exact depends on magnitudes nobody checked.
    (A Python float against a float tensor is computed in the tensor's
    dtype in PyTorch, as JAX's weak types do, so only the int side is a
    promotion site.)  Convert explicitly — ``x.to(torch.float32)`` — or
    stay in integers."""
    statics = _statics(index)
    for rel in index.cfg.zones:
        mod = index.modules.get(rel)
        if mod is None:
            continue
        aliases = _module_aliases(index, mod)
        module_env = _zone_env(index, mod, ExprTyper(index.cfg, aliases=aliases))
        for fn in mod.functions.values():
            if "." in fn.qualname and fn.qualname.split(".")[0] in (
                mod.functions
            ):
                continue
            tainted = build_taint(fn, statics, _hosts(index))
            ftyper = ExprTyper(index.cfg, module_env, aliases)
            env = ftyper.build_env(fn.node)
            for n in ast.walk(fn.node):
                if not (
                    isinstance(n, ast.BinOp)
                    and isinstance(n.op, _GL005_OPS)
                ):
                    continue
                yield from _gl005_binop(
                    mod, fn, n, tainted, statics, ftyper, env
                )


def _gl005_binop(mod, fn, n, tainted, statics, typer, env):
    def arrayish(x):
        return expr_mentions_tainted(x, tainted, statics) or (
            is_array_producing(x)
        )

    for scalar, array in ((n.left, n.right), (n.right, n.left)):
        if arrayish(scalar) or not arrayish(array):
            continue
        if isinstance(scalar, ast.Call):
            _, leaf = _head_leaf(scalar)
            if leaf in _FLOAT_WRAPPERS:
                break
        if typer.etype(scalar, env) == FLOAT and typer.etype(
            array, env
        ) in (INT, BOOL):
            if not mod.suppressed("GL005", n.lineno):
                yield Finding(
                    "GL005", mod.relpath, n.lineno,
                    f"bare Python float scalar `{ast.unparse(scalar)[:40]}`"
                    f" mixed into int tensor `{ast.unparse(array)[:40]}` in "
                    f"bit-exact zone function {fn.qualname} — the result "
                    "silently promotes to the default float dtype; convert "
                    "explicitly or stay in integers",
                )
        break


# ---------------------------------------------------------------------------
# GL006 — config hygiene
# ---------------------------------------------------------------------------


def rule_gl006(index: RepoIndex):
    """GL006 — non-frozen ``*Config`` dataclasses.

    The configs key the port's step caches and plans and ride across
    threads (the FSM's, the pump's); a mutable one lets a live update
    change a step mid-flight and cannot be hashed.  Every ``*Config``
    dataclass must be ``frozen=True``.  The JAX rule's other half —
    mutable values bound to ``static_argnames`` — has no PyTorch form:
    nothing is traced, so no argument is static, and that half yields
    nothing here."""
    for rel, mod in sorted(index.modules.items()):
        for n in ast.walk(mod.tree):
            if isinstance(n, ast.ClassDef) and n.name.endswith("Config"):
                deco = _dataclass_decorator(n)
                first_line = (
                    n.decorator_list[0].lineno
                    if n.decorator_list else n.lineno
                )
                if deco is not None and not _has_frozen(deco):
                    if not mod.suppressed(
                        "GL006", n.lineno
                    ) and not mod.suppressed("GL006", first_line):
                        yield Finding(
                            "GL006", rel, n.lineno,
                            f"dataclass {n.name} is a static jit config "
                            "but not frozen=True — unhashable/mutable "
                            "static args defeat the jit cache",
                        )


def _dataclass_decorator(n: ast.ClassDef):
    for dec in n.decorator_list:
        name = _name_of(dec if not isinstance(dec, ast.Call) else dec.func)
        if name in ("dataclasses.dataclass", "dataclass"):
            return dec
    return None


def _has_frozen(dec) -> bool:
    return isinstance(dec, ast.Call) and any(
        kw.arg == "frozen"
        and isinstance(kw.value, ast.Constant)
        and kw.value.value is True
        for kw in dec.keywords
    )


# ---------------------------------------------------------------------------
# GL007 — allocations inside hot-loop regions
# ---------------------------------------------------------------------------

_ALLOC_LEAVES = {
    "zeros", "ones", "empty", "full", "zeros_like", "ones_like",
    "empty_like", "full_like", "array",
}
_TORCH_ALLOC_LEAVES = _ALLOC_LEAVES - {"array"} | {
    "tensor", "as_tensor", "from_numpy", "empty_strided",
}
_NEW_ALLOC_METHODS = {"new_empty", "new_zeros", "new_ones", "new_full",
                      "new_tensor"}


def rule_gl007(index: RepoIndex):
    """GL007 — allocations inside ``# graftlint: hot-loop`` regions.

    The staging loops of the host ingest and the sharded service recycle
    pinned staging buffers so that a tick allocates nothing: a fresh
    ``torch.empty/zeros/full/tensor/as_tensor/from_numpy`` (or a
    ``x.new_*``) or a NumPy allocation there is per-tick churn in the
    caching allocator or the heap, and on the card a new segment breaks
    ``guards.no_new_device_memory``.  The marked regions are declared in
    the code; the files in ``[tool.graftlint.gl007] files``."""
    for rel in index.cfg.hot_files:
        mod = index.modules.get(rel)
        if mod is None:
            continue
        for n in ast.walk(mod.tree):
            if not isinstance(n, ast.Call) or not mod.in_hot_region(n.lineno):
                continue
            head, leaf = _head_leaf(n)
            bad = head in _NP_HEADS and leaf in _ALLOC_LEAVES
            bad = bad or (head == "torch" and leaf in _TORCH_ALLOC_LEAVES)
            label = f"{head}.{leaf}"
            if (
                not bad and isinstance(n.func, ast.Attribute)
                and n.func.attr in _NEW_ALLOC_METHODS
            ):
                bad, label = True, f"x.{n.func.attr}"
            if bad and not mod.suppressed("GL007", n.lineno):
                yield Finding(
                    "GL007", rel, n.lineno,
                    f"{label}() inside a `# graftlint: hot-loop` "
                    "region — per-tick allocation churn; use the recycled "
                    "staging pairs (the fetch is the completion barrier)",
                )


# ---------------------------------------------------------------------------
# GL008 — structural consistency
# ---------------------------------------------------------------------------

def rule_gl008(index: RepoIndex):
    """GL008 — structural consistency.

    Params: every ``DriverParams`` field of the package's
    ``core/config.py`` is in ``param/rplidar.yaml`` (the deployment's
    source of truth) and is checked in ``validate()`` unless declared
    free-form (``unvalidated_params_ok``); no key of the file is unknown.
    Precompile: every declared device step is reached from some
    ``precompile*()`` (its first live call would otherwise build kernels
    and grow the allocator inside the hot loop), unless exempt with a
    reason (``precompile_exempt``); a ``device_roots`` entry that names
    no function is stale.  The JAX rule's bench halves (every
    ``bench.py --config N`` pinned in its meta test, headline scans/s
    through ``TimedWindow.rate()``) wait for the port's own benchmark:
    ``bench.py`` measures the JAX package, so they yield nothing here."""
    yield from _gl008_precompile(index)
    yield from _gl008_params(index)


def _gl008_precompile(index: RepoIndex):
    declared = {}
    for spec in index.cfg.device_roots:
        rel, _, qn = spec.partition("::")
        mod = index.modules.get(rel)
        fn = mod.functions.get(qn) if mod is not None else None
        if fn is None:
            yield Finding(
                "GL008", rel or spec, 1,
                f"device_roots entry `{spec}` names no function — a stale "
                "declaration silently disarms GL001-GL003 for that step",
            )
            continue
        declared[(rel, qn)] = fn
    roots = [
        f
        for m in index.modules.values()
        for f in m.functions.values()
        if f.qualname.split(".")[-1].startswith("precompile")
    ]
    covered = index.reachable_from(roots)
    exempt = set(index.cfg.precompile_exempt)
    for (rel, qn), fn in sorted(declared.items()):
        if qn in exempt or (rel, qn) in covered:
            continue
        if not fn.module.suppressed("GL008", fn.node.lineno):
            yield Finding(
                "GL008", rel, fn.node.lineno,
                f"device step {qn} is not reachable from any precompile() "
                "— its first live call builds kernels and grows the "
                "allocator inside the hot loop (warm it, or exempt it in "
                "[tool.graftlint.gl008] with a reason)",
            )


def _gl008_params(index: RepoIndex):
    import yaml

    mod_path = os.path.join(index.cfg.root, index.cfg.params_module)
    yaml_path = os.path.join(index.cfg.root, index.cfg.params_yaml)
    if not (os.path.exists(mod_path) and os.path.exists(yaml_path)):
        return
    with open(mod_path, encoding="utf-8") as f:
        tree = ast.parse(f.read())
    fields: list[str] = []
    validated: set = set()
    for n in ast.walk(tree):
        if isinstance(n, ast.ClassDef) and n.name == "DriverParams":
            for item in n.body:
                if isinstance(item, ast.AnnAssign) and isinstance(
                    item.target, ast.Name
                ):
                    fields.append(item.target.id)
                if isinstance(item, ast.FunctionDef) and (
                    item.name == "validate"
                ):
                    for a in ast.walk(item):
                        if isinstance(a, ast.Attribute) and isinstance(
                            a.value, ast.Name
                        ) and a.value.id == "self":
                            validated.add(a.attr)
    with open(yaml_path, encoding="utf-8") as f:
        doc = yaml.safe_load(f)
    if isinstance(doc, dict) and len(doc) == 1:
        (inner,) = doc.values()
        if isinstance(inner, dict) and "ros__parameters" in inner:
            doc = inner["ros__parameters"]
    yaml_keys = set(doc or {})
    ok_unvalidated = set(index.cfg.unvalidated_params_ok)
    for name in fields:
        if name not in yaml_keys:
            yield Finding(
                "GL008", index.cfg.params_yaml, 1,
                f"DriverParams.{name} is missing from "
                f"{index.cfg.params_yaml} — the param file is the "
                "deployment source of truth and must carry every field",
            )
        if name not in validated and name not in ok_unvalidated:
            yield Finding(
                "GL008", index.cfg.params_module, 1,
                f"DriverParams.{name} is never validated in validate() "
                "and not declared exempt in [tool.graftlint.gl008] "
                "unvalidated_params_ok",
            )
    for key in sorted(yaml_keys - set(fields)):
        yield Finding(
            "GL008", index.cfg.params_yaml, 1,
            f"param file key `{key}` does not exist on DriverParams — "
            "from_yaml would reject this file",
        )


# ---------------------------------------------------------------------------
# GL009 — unbounded retry loops (no attempt cap, no backoff ceiling)
# ---------------------------------------------------------------------------

def _is_while_forever(loop: ast.While) -> bool:
    return isinstance(loop.test, ast.Constant) and bool(loop.test.value)


def _gl009_bounded_escape(loop: ast.While) -> bool:
    """An escape (break/return/raise) inside an `if` whose test is a
    comparison/boolean test counts as a cap — an attempt counter or a
    deadline check gating the exit is exactly the bound this rule
    demands."""
    for n in ast.walk(loop):
        if isinstance(n, ast.If) and isinstance(
            n.test, (ast.Compare, ast.BoolOp)
        ):
            for e in ast.walk(n):
                if isinstance(e, (ast.Break, ast.Return, ast.Raise)):
                    return True
    return False


def rule_gl009(index: RepoIndex):
    """GL009 — unbounded retry loops.

    `while True` loops sleeping a CONSTANT delay are retry loops with
    no backoff and no bound: a dead device turns them into a permanent
    fixed-rate reconnect storm (and N of them into a synchronized one).
    A computed sleep argument (a BackoffPolicy delay, a derived
    remaining-budget) or a comparison-gated escape (attempt cap,
    deadline) absolves the loop; anything else must justify itself with
    a suppression."""
    for rel, mod in sorted(index.modules.items()):
        for fn in mod.functions.values():
            # nested defs ride their parent's walk — the IMMEDIATE
            # parent (rsplit), so a closure inside a method
            # ("Cls.method.inner") is skipped too; the split('.')[0]
            # form would double-report it, once per qualname
            if "." in fn.qualname and fn.qualname.rsplit(".", 1)[0] in (
                mod.functions
            ):
                continue
            for loop in ast.walk(fn.node):
                if not isinstance(loop, ast.While) or not _is_while_forever(
                    loop
                ):
                    continue
                const_sleep = None
                for n in ast.walk(loop):
                    if not isinstance(n, ast.Call):
                        continue
                    _, leaf = _head_leaf(n)
                    if leaf == "sleep" and n.args and isinstance(
                        n.args[0], ast.Constant
                    ):
                        const_sleep = n
                        break
                if const_sleep is None:
                    continue
                if _gl009_bounded_escape(loop):
                    continue
                if not mod.suppressed("GL009", loop.lineno) and not (
                    mod.suppressed("GL009", const_sleep.lineno)
                ):
                    yield Finding(
                        "GL009", rel, loop.lineno,
                        f"unbounded retry loop in {fn.qualname}: `while "
                        "True` sleeping a constant delay with no attempt "
                        "cap, deadline check, or computed backoff — route "
                        "the wait through driver/health.BackoffPolicy "
                        "(capped exponential + jitter) or gate an escape "
                        "on an attempt/deadline bound",
                    )


# ---------------------------------------------------------------------------
# GL010 — the no-fallback rule for compiled kernels
# ---------------------------------------------------------------------------


def _binding_names(index: RepoIndex) -> dict:
    """``{relpath: {module-level names bound to a kernel entry}}`` — every
    ``X = KernelEntry(...)`` (the declared binding constructors)."""
    out: dict = {}
    for rel, mod in index.modules.items():
        for n in mod.tree.body:
            if isinstance(n, ast.Assign) and isinstance(n.value, ast.Call) and (
                _name_of(n.value.func).rsplit(".", 1)[-1] == _BINDING_CTOR
            ):
                for t in n.targets:
                    if isinstance(t, ast.Name):
                        out.setdefault(rel, set()).add(t.id)
    return out


def _binding_call(index, mod, call, bindings) -> str | None:
    """The binding a call enters, or None: a kernel entry of this module
    (``_B1(...)``), one reached through a module alias (``mk._B1(...)``)
    or a from-import, or a library loader (``load_library(...)``)."""
    name = _name_of(call.func)
    if not name:
        return None
    leaf = name.rsplit(".", 1)[-1]
    if leaf == _BINDING_LOADER:
        return name
    if "." not in name:
        if name in bindings.get(mod.relpath, ()):
            return name
        src = mod.from_imports.get(name)
        if src is not None and src[1] in bindings.get(src[0], ()):
            return name
        return None
    head, _, tail = name.partition(".")
    target = mod.imports.get(head)
    if target is not None and tail in bindings.get(target, ()):
        return name
    return None


def _mentions(test, *words) -> bool:
    text = ast.unparse(test)
    return any(w in text for w in words)


def _calls_plain(node) -> bool:
    return any(
        isinstance(c, ast.Call)
        and _name_of(c.func).rsplit(".", 1)[-1].endswith("_plain")
        for c in ast.walk(node)
    )


def _raises(node) -> bool:
    return any(isinstance(r, ast.Raise) for r in ast.walk(node))


def _guard_lines(index, fn) -> tuple:
    """(line of the CPU branch calling a ``*_plain`` twin, line of the
    non-CUDA raise) in the wrapper, either None when absent.  The raise
    may sit in a same-module helper the wrapper calls (one hop)."""
    cpu_line = raise_line = None
    for n in ast.walk(fn.node):
        if isinstance(n, ast.If):
            if _mentions(n.test, '"cpu"', "'cpu'") and _calls_plain(
                ast.Module(body=n.body, type_ignores=[])
            ):
                cpu_line = n.lineno if cpu_line is None else min(
                    cpu_line, n.lineno
                )
            if _mentions(n.test, "cuda") and _raises(n):
                raise_line = n.lineno if raise_line is None else min(
                    raise_line, n.lineno
                )
            if cpu_line is not None and n.lineno == cpu_line and any(
                isinstance(s, ast.Raise) for s in n.orelse
            ):
                raise_line = n.lineno
        elif isinstance(n, ast.Call) and raise_line is None:
            tgt = index.resolve_call(fn.module, n.func)
            if tgt is not None and tgt.module is fn.module and any(
                isinstance(i, ast.If) and _mentions(i.test, "cuda")
                and _raises(i) for i in ast.walk(tgt.node)
            ):
                raise_line = n.lineno
    # `if not x.is_cuda: if cpu: return plain(...) / raise` — the raise
    # after the CPU branch inside a non-CUDA guard
    for n in ast.walk(fn.node):
        if isinstance(n, ast.If) and _mentions(n.test, "is_cuda") and any(
            isinstance(s, ast.Raise) for s in n.body
        ):
            raise_line = n.lineno if raise_line is None else min(
                raise_line, n.lineno
            )
    return cpu_line, raise_line


def rule_gl010(index: RepoIndex):
    """GL010 — the no-fallback rule: a compiled kernel launches only from
    its ``ops/*_kernels.py`` wrapper, and a CUDA tensor launches the
    kernel or raises.

    The port's parity contract (ROADMAP "Parity contract") is that each
    Hopper kernel's wrapper takes its plain PyTorch twin only for a CPU
    tensor; on the card it launches or raises, so a broken build or an
    unsupported shape can never hide behind a slow-but-right fallback.
    The JAX rule policed ``pallas_call`` through the
    ``_lowering_dispatch`` selector; its counterpart here checks, by AST:

      * a call into a compiled binding (a name bound to a
        ``KernelEntry``, or ``load_library``; ``utils/launch.py`` and
        ``utils/cuda_build.py`` are the binding layer itself) lies only
        in an ``ops/*_kernels.py`` wrapper;
      * that wrapper has a branch testing for ``"cpu"`` that calls a
        ``*_plain`` function and a non-CUDA branch that raises (or calls
        a same-module helper that does), both before the launch (the
        pattern of ``median_kernels.temporal_median_kernel``);
      * no ``except`` handler whose ``try`` reaches a launching wrapper
        reaches a ``*_plain`` function (a fallback on failure)."""
    bindings = _binding_names(index)
    launchers = set()
    for rel, mod in sorted(index.modules.items()):
        if rel.endswith(_BINDING_MODULES):
            continue
        for fn in _top_functions(mod):
            sites = [
                (n, b) for n in ast.walk(fn.node)
                if isinstance(n, ast.Call)
                for b in [_binding_call(index, mod, n, bindings)]
                if b is not None
            ]
            if not sites:
                continue
            if not _KERNELS_RE.search(rel):
                for n, b in sites:
                    if not mod.suppressed("GL010", n.lineno):
                        yield Finding(
                            "GL010", rel, n.lineno,
                            f"compiled binding `{b}` called in "
                            f"{fn.qualname} outside an ops/*_kernels.py "
                            "wrapper — nothing there routes a CPU tensor "
                            "to the plain twin or refuses another device",
                        )
                continue
            launchers.add((rel, fn.qualname))
            cpu_line, raise_line = _guard_lines(index, fn)
            first = min(n.lineno for n, _ in sites)
            msg = None
            if cpu_line is None or cpu_line > first:
                msg = (
                    f"kernel wrapper {fn.qualname} launches `{sites[0][1]}` "
                    "without a preceding CPU branch that calls its *_plain "
                    "twin"
                )
            elif raise_line is None or raise_line > first:
                msg = (
                    f"kernel wrapper {fn.qualname} launches `{sites[0][1]}` "
                    "without a preceding non-CUDA branch that raises — "
                    "another device would reach the launch"
                )
            if msg and not mod.suppressed("GL010", fn.node.lineno) and not (
                mod.suppressed("GL010", _first_line(fn))
            ):
                yield Finding("GL010", rel, fn.node.lineno, msg)
    yield from _gl010_fallbacks(index, launchers)


def _calls_in(index, fn, nodes) -> list:
    out = []
    for node in nodes:
        for n in ast.walk(node):
            if not isinstance(n, (ast.Name, ast.Attribute)) or not isinstance(
                getattr(n, "ctx", None), ast.Load
            ):
                continue
            if (
                isinstance(n, ast.Attribute) and isinstance(n.value, ast.Name)
                and n.value.id == "self"
            ):
                tgt = index.resolve_method(fn, n.attr)
            else:
                tgt = index.resolve_call(fn.module, n)
            if tgt is not None:
                out.append(tgt)
    return out


def _gl010_fallbacks(index, launchers):
    if not launchers:
        return
    by_key = index.functions_by_key()
    for rel, mod in sorted(index.modules.items()):
        for fn in _top_functions(mod):
            for t in ast.walk(fn.node):
                if not isinstance(t, ast.Try) or not t.handlers:
                    continue
                reach = index.reachable_from(_calls_in(index, fn, t.body))
                if not reach & launchers:
                    continue
                for h in t.handlers:
                    reached = index.reachable_from(
                        _calls_in(index, fn, h.body)
                    )
                    plain = sorted(
                        k for k in reached
                        if k[1].rsplit(".", 1)[-1].endswith("_plain")
                        and k in by_key
                    )
                    direct = _calls_plain(ast.Module(body=h.body,
                                                     type_ignores=[]))
                    if (plain or direct) and not mod.suppressed(
                        "GL010", h.lineno
                    ):
                        what = plain[0][1] if plain else "a *_plain twin"
                        yield Finding(
                            "GL010", rel, h.lineno,
                            f"except handler in {fn.qualname} falls back "
                            f"to {what} after a kernel launch path fails — "
                            "a CUDA tensor must launch the kernel or raise",
                        )


# ---------------------------------------------------------------------------
# GL011 — fixed-point overflow prover
# ---------------------------------------------------------------------------

_GL011_SUM_LEAVES = {"sum", "cumsum"}
_GL011_SCATTER_ADD = {"index_add_", "index_add", "scatter_add_",
                      "scatter_add"}


def _gl011_check_sites(fn_node, typer, tenv):
    """Yield ``(kind, node, operands)`` for every site GL011 must
    prove: integer products, left shifts, integer sum-reductions, and
    accumulating scatters (``index_add_``, ``scatter_add_``,
    ``index_put_(..., accumulate=True)``)."""
    for n in ast.walk(fn_node):
        if isinstance(n, ast.BinOp) and isinstance(n.op, ast.Mult):
            if typer.etype(n, tenv) == INT:
                yield "product", n, (n.left, n.right)
        elif isinstance(n, ast.BinOp) and isinstance(n.op, ast.LShift):
            yield "left shift", n, (n.left, n.right)
        elif isinstance(n, ast.Call):
            name = _name_of(n.func)
            leaf = (
                n.func.attr if isinstance(n.func, ast.Attribute)
                else name.rsplit(".", 1)[-1] if name else ""
            )
            method = isinstance(n.func, ast.Attribute) and not (
                _is_module_receiver(n.func)
            )
            if method and (
                leaf in _GL011_SCATTER_ADD or (
                    leaf == "index_put_" and any(
                        kw.arg == "accumulate"
                        and isinstance(kw.value, ast.Constant)
                        and kw.value.value is True
                        for kw in n.keywords
                    )
                )
            ):
                base = n.func.value
                src = n.args[2] if leaf != "index_put_" and len(n.args) >= 3 \
                    else n.args[1] if leaf == "index_put_" and len(n.args) >= 2 \
                    else None
                if typer.etype(base, tenv) == INT:
                    yield "scatter-add", n, (base,) + (
                        (src,) if src is not None else ()
                    )
            elif leaf in _GL011_SUM_LEAVES:
                operand = None
                head, _, _tail = name.rpartition(".")
                if head in _ARRAY_HEADS and n.args:
                    operand = n.args[0]
                elif method:
                    operand = n.func.value
                if operand is not None and typer.etype(
                    operand, tenv
                ) == INT:
                    yield "sum-reduce", n, (operand,)


def rule_gl011(index: RepoIndex):
    """GL011 — fixed-point overflow prover.

    The bit-exact zones do all arithmetic in int32: quantized
    millimeters, Q-format trig, log-odds counts.  Every multiply, shift
    and reduction there was hand-argued to stay inside ±2^31 in a
    comment — and a comment cannot fail CI.  This rule runs an interval
    abstract interpreter over the zones: input ranges are declared once
    in [tool.graftlint.gl011.bounds] (parameters and cfg.<attr> leaves)
    and [tool.graftlint.gl011.call_bounds] (calls whose result range is
    a contract of their own parity tests), transfer functions propagate
    them through +, -, *, //, %, shifts, masks, clips, where/select and
    reductions (capped by the per-zone sum_elems element count), and any
    product / left shift / sum-reduce / scatter-add whose result
    interval escapes int32 is a finding.  An int-typed parameter of a
    zone entry point with no declared bound is itself a finding: an
    undeclared input is an unproved theorem.  And because a declared
    bound is a contract other functions' proofs consume, an assignment
    to a declared name whose derivable interval is wider than the
    declaration is ALSO a finding — declaring ``motion ∈ ±2^13`` while
    computing an unclamped ``dth`` up to ±2^17 is how a fixed-point
    overflow hides behind a true-looking comment.  The witness is the
    interval trace — the machine-checked version of the old comment."""
    cfg = index.cfg
    statics = _statics(index)
    bounds = {
        n: Interval(lo, hi) for n, (lo, hi) in cfg.gl011_bound_map().items()
    }
    call_bounds = {
        n: Interval(lo, hi)
        for n, (lo, hi) in cfg.gl011_call_bound_map().items()
    }
    sum_map = cfg.gl011_sum_elems_map()
    for rel in cfg.gl011_zones:
        mod = index.modules.get(rel)
        if mod is None:
            continue
        elems = sum_map.get(rel, cfg.gl011_sum_elems_default)
        passes = dict(cfg.gl011_pass_calls)
        ev = IntervalEvaluator(bounds, call_bounds, elems, pass_calls=passes)
        aliases = _module_aliases(index, mod)
        base_typer = ExprTyper(cfg, aliases=aliases)
        module_tenv: dict = {}
        module_ienv: dict = {}
        for n in mod.tree.body:
            if not isinstance(n, ast.Assign) or len(n.targets) != 1:
                continue
            t = n.targets[0]
            if isinstance(t, ast.Name):
                module_tenv[t.id] = base_typer.etype(n.value, module_tenv)
                module_ienv[t.id] = ev.eval(n.value, module_ienv)
            elif isinstance(t, ast.Tuple) and isinstance(
                n.value, ast.Tuple
            ) and len(t.elts) == len(n.value.elts):
                # _UD_T1, _UD_T2, _UD_T3 = 2046, 8187, 24567
                for te, ve in zip(t.elts, n.value.elts):
                    if isinstance(te, ast.Name):
                        module_tenv[te.id] = base_typer.etype(
                            ve, module_tenv
                        )
                        module_ienv[te.id] = ev.eval(ve, module_ienv)
        typer = ExprTyper(cfg, module_tenv, aliases)
        ev = IntervalEvaluator(
            bounds, call_bounds, elems, module_ienv,
            is_bool=lambda n: typer.name_kind(n) == BOOL,
            pass_calls=passes,
        )
        for fn in _top_functions(mod):
            first_line = (
                fn.node.decorator_list[0].lineno
                if fn.node.decorator_list else fn.node.lineno
            )
            scalars = scalar_annotated(fn.node, _hosts(index))
            for p in fn.params:
                if (
                    p in bounds
                    or p in scalars
                    or is_static_name(p, statics)
                    or typer.name_kind(p) != INT
                ):
                    continue
                if not mod.suppressed(
                    "GL011", fn.node.lineno
                ) and not mod.suppressed("GL011", first_line):
                    yield Finding(
                        "GL011", rel, fn.node.lineno,
                        f"zone entry-point parameter `{p}` of "
                        f"{fn.qualname} is int-typed but has no declared "
                        "bound in [tool.graftlint.gl011.bounds] — the "
                        "overflow prover cannot see its range, so nothing "
                        "downstream of it is proved",
                        witness=f"`{p}`: int by naming convention, "
                        "no [lo, hi] declaration",
                    )
            params = set(fn.params)
            for inner in ast.walk(fn.node):
                if isinstance(inner, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    params.update(
                        a.arg for a in inner.args.posonlyargs
                        + inner.args.args + inner.args.kwonlyargs
                    )
            env = ev.build_env(fn.node, sorted(params))
            tenv = typer.build_env(fn.node)
            for kind, n, operands in _gl011_check_sites(
                fn.node, typer, tenv
            ):
                ivl = ev.eval(n, env)
                if ivl.fits_int32():
                    continue
                if mod.suppressed("GL011", n.lineno):
                    continue
                opw = ", ".join(
                    f"`{ast.unparse(o)[:40]}` ∈ {ev.eval(o, env)}"
                    for o in operands
                )
                yield Finding(
                    "GL011", rel, n.lineno,
                    f"{kind} `{ast.unparse(n)[:70]}` in {fn.qualname} is "
                    "not provably inside int32 — declare tighter bounds, "
                    "clamp where the interpreter can see it, or suppress "
                    "with the wrap rationale",
                    witness=f"{opw} → result ∈ {ivl}"
                    + (f" (sum over ≤{elems} elements)"
                       if kind in ("sum-reduce", "scatter-add") else ""),
                )
            # A declared bound is a CONTRACT, not just an assumption: a
            # local assignment to a declared name must provably stay
            # inside its bound, or the declaration proves theorems from
            # a false premise everywhere else the name is consumed.
            # (This is exactly how an unclamped `dth` slips an
            # over-range θ-rate into apply_deskew's proved ±8192 chain.)
            for n in ast.walk(fn.node):
                if not (
                    isinstance(n, ast.Assign) and len(n.targets) == 1
                    and isinstance(n.targets[0], ast.Name)
                    and n.targets[0].id in bounds
                ):
                    continue
                declared = bounds[n.targets[0].id]
                got = ev.eval(n.value, env)
                if got.lo >= declared.lo and got.hi <= declared.hi:
                    continue
                if mod.suppressed("GL011", n.lineno):
                    continue
                yield Finding(
                    "GL011", rel, n.lineno,
                    f"assignment to `{n.targets[0].id}` in {fn.qualname} "
                    "escapes its declared bound — the interval the prover "
                    "can derive is wider than the contract every other "
                    "use of the name relies on; clamp the value where "
                    "the interpreter can see it or widen the declaration",
                    witness=f"declared {declared}, assigned "
                    f"`{ast.unparse(n.value)[:60]}` ∈ {got}",
                )


# ---------------------------------------------------------------------------
# GL012 — lock-discipline race detector
# ---------------------------------------------------------------------------

def _gl012_class_roots(index: RepoIndex, rel, mod):
    """Thread entry points per class, as ``{cls: [(context, fn), ...]}``:
    Thread/Timer targets found in the module (each spawn target is its
    own context, named after the method) plus the configured extra_roots
    (callback methods that run on another component's thread —
    registration is a runtime fact the analyzer cannot see, so it is
    declared).  An extra_root ``relpath::Class.method@ctx`` assigns the
    method to the named context: several entry points invoked by the
    SAME foreign thread (e.g. every driver method the scan-loop FSM
    calls) share one context instead of inflating the count."""
    by_cls: dict = {}
    for r in thread_roots(mod):
        if r.cls is not None:
            by_cls.setdefault(r.cls, []).append((r.qualname.split(".")[-1], r))
    for spec in index.cfg.gl012_extra_roots:
        srel, _, qn = spec.partition("::")
        if srel != rel:
            continue
        qn, _, ctx = qn.partition("@")
        fn = mod.functions.get(qn)
        if fn is not None and fn.cls is not None:
            lst = by_cls.setdefault(fn.cls, [])
            entry = (ctx or qn.split(".")[-1], fn)
            if entry not in lst:
                lst.append(entry)
    return by_cls


def rule_gl012(index: RepoIndex):
    """GL012 — lock-discipline race detector.

    The driver layer is genuinely threaded: reader/scan loops in the sim
    device, the protocol engine's pump thread, timer callbacks, the
    ingest producer/consumer pair.  The simulator once shipped a real
    interleaved-write tear (`sim_device._send` answering two clients at
    once) that only a live-wire drive caught.  This rule makes the locking story
    declarative: [tool.graftlint.locks] maps class → lock attribute →
    the fields it guards.  Every `self._x = ...` write in a method
    reachable from two or more execution contexts (each
    threading.Thread/Timer target is a context; everything not reachable
    from one is the caller context "main") must hold a declared guarding
    lock at the write — lexically, via `with self.<lock>:`.  A shared
    field with no declared lock at all is its own finding.  Separately,
    nested `with self.<lock>` acquisitions (direct or one call deep)
    build a global acquisition-order graph; a cycle is a potential
    deadlock and is flagged wherever one of its edges is taken."""
    lock_decl = index.cfg.lock_map()
    for rel, mod in sorted(index.modules.items()):
        locksets = class_locks(mod)
        by_cls = _gl012_class_roots(index, rel, mod)
        for cls, roots in sorted(by_cls.items()):
            methods = {
                qn: f for qn, f in mod.functions.items()
                if f.cls == cls and qn.count(".") == 1
            }
            # Each context's closure must not expand INTO another context's
            # entry points: `Thread(target=self._loop)` is a reference the
            # generic walk follows, but spawning a thread does not run
            # its body in the spawner's context — without the stop set,
            # "main" (which calls start()) would leak into every thread
            # body and every field would look multi-context.
            by_ctx: dict = {}
            for ctx, r in roots:
                by_ctx.setdefault(ctx, []).append(r)
            root_keys = {(rel, r.qualname) for _, r in roots}
            reach = {}
            for ctx, fns in by_ctx.items():
                own = {(rel, f.qualname) for f in fns}
                reach[ctx] = index.reachable_from(
                    fns, stop=root_keys - own
                )
            thread_reached = set().union(*reach.values()) if reach else set()
            main_roots = [
                f for qn, f in methods.items()
                if (rel, qn) not in root_keys
                and (rel, qn) not in thread_reached
                and not qn.endswith("__init__")
            ]
            main_reach = (
                index.reachable_from(main_roots, stop=root_keys)
                if main_roots else set()
            )

            def contexts(key):
                ctxs = {c for c, r in reach.items() if key in r}
                if key in main_reach:
                    ctxs.add("main")
                return ctxs

            lock_attrs = set(locksets.get(cls, set())) | set(
                lock_decl.get(cls, {})
            )
            writes: dict = {}
            for qn, f in sorted(methods.items()):
                ctxs = contexts((rel, qn))
                if not ctxs:
                    continue  # __init__ / pre-thread setup / unused
                for attr, line in self_attr_writes(f.node):
                    if attr in lock_attrs:
                        continue
                    writes.setdefault(attr, []).append(
                        (qn, line, locks_held_at(f.node, line, lock_attrs),
                         ctxs)
                    )
            declared = lock_decl.get(cls, {})
            for attr, ws in sorted(writes.items()):
                all_ctxs = sorted(set().union(*(w[3] for w in ws)))
                if len(all_ctxs) < 2:
                    continue
                guarding = {
                    lock for lock, fields in declared.items()
                    if attr in fields
                }
                pair = "; ".join(
                    f"{qn}:{line} holds {sorted(held) or 'no lock'} "
                    f"(contexts: {', '.join(sorted(ctxs))})"
                    for qn, line, held, ctxs in ws[:4]
                )
                if not guarding:
                    line0 = ws[0][1]
                    if not mod.suppressed("GL012", line0):
                        yield Finding(
                            "GL012", rel, line0,
                            f"self.{attr} of {cls} is written from "
                            f"{len(all_ctxs)} execution contexts "
                            f"({', '.join(all_ctxs)}) but no declared lock "
                            "guards it — declare the guarding lock in "
                            f"[tool.graftlint.locks.{cls}] (or fix the "
                            "race)",
                            witness=pair,
                        )
                    continue
                for qn, line, held, _ctxs in ws:
                    if held & guarding:
                        continue
                    if not mod.suppressed("GL012", line):
                        yield Finding(
                            "GL012", rel, line,
                            f"write to self.{attr} in {cls}."
                            f"{qn.split('.')[-1]} without holding "
                            f"{'/'.join(sorted(guarding))} — the field is "
                            f"shared across contexts "
                            f"({', '.join(all_ctxs)}) and every write "
                            "must take the declared lock",
                            witness=pair,
                        )
    yield from _gl012_lock_order(index)


def _gl012_lock_order(index: RepoIndex):
    edges: dict = {}  # (cls, l1) -> {(cls, l2): (rel, line)}
    for rel, mod in sorted(index.modules.items()):
        locksets = class_locks(mod)
        for qn, f in sorted(mod.functions.items()):
            if f.cls is None:
                continue
            lock_attrs = locksets.get(f.cls, set())
            if not lock_attrs:
                continue
            for w in ast.walk(f.node):
                if not isinstance(w, ast.With):
                    continue
                outer = [
                    item.context_expr.attr for item in w.items
                    if isinstance(item.context_expr, ast.Attribute)
                    and isinstance(item.context_expr.value, ast.Name)
                    and item.context_expr.value.id == "self"
                    and item.context_expr.attr in lock_attrs
                ]
                if not outer:
                    continue
                # multi-item `with self.a, self.b:` acquires in order
                for a, b in zip(outer, outer[1:]):
                    if a != b:
                        edges.setdefault((f.cls, a), {}).setdefault(
                            (f.cls, b), (rel, w.lineno)
                        )
                held = outer[-1]
                for inner in ast.walk(w):
                    if inner is w:
                        continue
                    if isinstance(inner, ast.With):
                        for item in inner.items:
                            e = item.context_expr
                            if (
                                isinstance(e, ast.Attribute)
                                and isinstance(e.value, ast.Name)
                                and e.value.id == "self"
                                and e.attr in lock_attrs
                                # re-acquiring the same (R)Lock is the
                                # reentrant idiom, not an order edge
                                and e.attr != held
                            ):
                                edges.setdefault(
                                    (f.cls, held), {}
                                ).setdefault(
                                    (f.cls, e.attr), (rel, inner.lineno)
                                )
                    elif isinstance(inner, ast.Call):
                        # one hop: a sibling method acquiring its own lock
                        name = _name_of(inner.func)
                        if name.startswith("self."):
                            tgt = index.resolve_method(
                                f, name.split(".", 1)[1]
                            )
                            if tgt is not None:
                                for w2 in ast.walk(tgt.node):
                                    if isinstance(w2, ast.With):
                                        for it2 in w2.items:
                                            e2 = it2.context_expr
                                            if (
                                                isinstance(e2, ast.Attribute)
                                                and isinstance(
                                                    e2.value, ast.Name
                                                )
                                                and e2.value.id == "self"
                                                and e2.attr in lock_attrs
                                                and e2.attr != held
                                            ):
                                                edges.setdefault(
                                                    (f.cls, held), {}
                                                ).setdefault(
                                                    (f.cls, e2.attr),
                                                    (rel, inner.lineno),
                                                )
    # cycle detection (DFS, deterministic order)
    seen_cycles = set()
    for start in sorted(edges):
        stack = [(start, (start,))]
        while stack:
            node, path = stack.pop()
            for nxt in sorted(edges.get(node, {})):
                if nxt == path[0]:
                    cyc = frozenset(path)
                    if cyc in seen_cycles:
                        continue
                    seen_cycles.add(cyc)
                    rel, line = edges[node][nxt]
                    mod = index.modules.get(rel)
                    if mod is not None and mod.suppressed("GL012", line):
                        continue
                    desc = " -> ".join(
                        f"{c}.{l}" for c, l in path + (nxt,)
                    )
                    yield Finding(
                        "GL012", rel, line,
                        f"lock acquisition-order cycle {desc} — two "
                        "threads taking these locks in opposite orders "
                        "can deadlock; pick one global order",
                        witness=desc,
                    )
                elif nxt not in path and len(path) < 8:
                    stack.append((nxt, path + (nxt,)))


# ---------------------------------------------------------------------------
# GL013 — zero-dispatch read-path prover
# ---------------------------------------------------------------------------

def rule_gl013(index: RepoIndex):
    """GL013 — zero-dispatch read-path prover.

    The tile-serving and diagnostics design promise is that a read
    touches only host snapshots — no kernel, no transfer, no tensor
    work, ever.  A standalone ``# graftlint: read-path`` comment above a
    def marks a read-path root (TileSnapshot readers, world-map tile
    reads, /diagnostics rendering).  The call graph is closed over from
    the roots — calls, bare references, self-method resolution, lazy
    imports — and reaching anything that dispatches is a finding: a
    tensor-producing ``torch.*`` call (a short list names the few that
    make no tensor), ``.to(``/``.cuda(``/``.cpu(``/
    ``.item(``/``synchronize``, a kernel wrapper of ``ops/*_kernels.py``,
    or an engine ``submit_*`` method.  The witness is the call path from
    the marked root to the offender."""
    cfg = index.cfg
    roots = []
    for _rel, mod in sorted(index.modules.items()):
        for qn in mod.read_path_funcs:
            fn = mod.functions.get(qn)
            if fn is not None:
                roots.append(fn)
    if not roots:
        return
    paths = index.reachable_paths(roots)
    by_key = index.functions_by_key()
    heads = set(cfg.gl013_dispatch_heads)
    calls = set(cfg.gl013_dispatch_calls)
    prefixes = tuple(cfg.gl013_dispatch_prefixes)
    for key in sorted(paths):
        fn = by_key.get(key)
        if fn is None:
            continue
        mod = fn.module
        chain = " -> ".join(q for _r, q in paths[key])
        if _KERNELS_RE.search(mod.relpath) and fn.qualname.endswith(
            "_kernel"
        ):
            if not mod.suppressed(
                "GL013", fn.node.lineno
            ) and not mod.suppressed("GL013", _first_line(fn)):
                yield Finding(
                    "GL013", mod.relpath, fn.node.lineno,
                    f"kernel wrapper {fn.qualname} is reachable from a "
                    "`# graftlint: read-path` root — a marked read path "
                    "must never launch a kernel",
                    witness=chain,
                )
            continue
        for n in ast.walk(fn.node):
            if not isinstance(n, ast.Call):
                continue
            name = _name_of(n.func)
            if isinstance(n.func, ast.Attribute) and not name:
                leaf, head = n.func.attr, ""
            else:
                head, _, leaf = name.rpartition(".")
            offender = None
            if name in _HOST_TORCH_CALLS:
                continue
            if isinstance(n.func, ast.Attribute) and leaf in calls:
                offender = name or f".{leaf}"
            elif head and head.split(".")[0] in heads:
                offender = name
            elif any(
                leaf.startswith(p) or (not head and name.startswith(p))
                for p in prefixes
            ):
                offender = name or leaf
            if offender is None:
                continue
            if not mod.suppressed("GL013", n.lineno):
                yield Finding(
                    "GL013", mod.relpath, n.lineno,
                    f"dispatching call `{offender}` in {fn.qualname} is "
                    "reachable from a `# graftlint: read-path` root — "
                    "the read path must be pure host work on the "
                    "immutable snapshot",
                    witness=f"{chain} -> {offender}()",
                )


ALL_RULES = (
    rule_gl001, rule_gl002, rule_gl003, rule_gl004, rule_gl005,
    rule_gl006, rule_gl007, rule_gl008, rule_gl009, rule_gl010,
    rule_gl011, rule_gl012, rule_gl013,
)

# rule id ("GL011") -> the rule function; --explain uses the docstrings
RULES_BY_ID = {
    fn.__name__.removeprefix("rule_").upper(): fn for fn in ALL_RULES
}

"""Runtime sentinels — turn "never happens in steady state" into raises.

The PyTorch counterpart of the JAX package's ``utils/guards.py``, with the
same names and the same contract: after warm-up, the live loop builds
nothing new and moves nothing it did not declare.  In this package that is
three checks:

  (a) nothing new is built or loaded (:func:`assert_no_recompile`): no
      kernel library is compiled or loaded (utils/cuda_build.py), no kernel
      entry is resolved (utils/launch.KernelEntry.resolve) and no launch
      plan is created — a miss in the ``functools.lru_cache`` plan functions
      of ops/median_kernels.py and ops/scan_match_kernels.py.  A violation
      raises :class:`RecompileError`;
  (b) no new device memory (:func:`no_new_device_memory`): the caching
      allocator maps no new segment (``segment.all.allocated`` of
      ``torch.cuda.memory_stats`` does not move);
  (c) no implicit synchronisation (:func:`no_implicit_transfers`): the
      scope runs under ``torch.cuda.set_sync_debug_mode("error")``, so a
      blocking copy, ``.item()`` or stream synchronisation raises.  The
      engines' own fetches — the device->host result copies, the row
      snapshot pulls and restores, the fleet step's one read of the
      completed counts — run inside :func:`declared_sync`, which the
      engines enter themselves: the port's form of the JAX package's
      declared ``device_put``/``device_get``.

On the CPU (no CUDA device), (b) and (c) have nothing to watch and are
no-ops: only (a) applies.  :func:`steady_state` combines all three.
"""

from __future__ import annotations

import contextlib
import threading

import torch

# depth of the active no_implicit_transfers scopes (process-wide, as the
# sync debug mode is): declared_sync costs nothing when no scope is active
_guard_lock = threading.Lock()
_sync_guards = 0


class RecompileError(AssertionError):
    """Something was built or loaded inside an assert_no_recompile scope."""


def _plan_functions() -> dict:
    """The launch-plan caches whose misses count as a new build."""
    from rplidar_ros2_driver_tpu_torch.ops import median_kernels as mk
    from rplidar_ros2_driver_tpu_torch.ops import scan_match_kernels as smk

    return {
        "median_kernels.sliding_plan": mk.sliding_plan,
        "scan_match_kernels.fine_plan": smk.fine_plan,
        "scan_match_kernels.coarse_plan": smk.coarse_plan,
        "scan_match_kernels.update_plan": smk.update_plan,
        "scan_match_kernels._sm_count": smk._sm_count,
    }


def _build_counts() -> dict:
    """Cumulative build events by name: library compiles and loads, kernel
    entry resolutions, plan-cache misses."""
    from rplidar_ros2_driver_tpu_torch.utils import cuda_build, launch

    counts = {f"nvcc {k}": v for k, v in cuda_build.compiles.items()}
    counts.update({f"load {k}": v for k, v in cuda_build.loads.items()})
    counts.update({f"resolve {k}": v for k, v in launch.resolves.items()})
    for name, fn in _plan_functions().items():
        counts[f"plan {name}"] = fn.cache_info().misses
    return counts


class BuildRecorder:
    """What an :func:`assert_no_recompile` scope built: ``compiles`` lists
    one name per build event, filled when the scope exits."""

    def __init__(self) -> None:
        self.compiles: list[str] = []
        self._start = _build_counts()

    def _finish(self) -> None:
        for name, n in _build_counts().items():
            self.compiles += [name] * max(0, n - self._start.get(name, 0))


@contextlib.contextmanager
def assert_no_recompile(max_compiles: int = 0, tag: str = ""):
    """Raise :class:`RecompileError` if more than ``max_compiles`` build
    events (a kernel library compiled or loaded, a kernel entry resolved,
    a launch plan created) happen inside the context.  The recorder is
    yielded; its ``compiles`` are filled when the context exits."""
    rec = BuildRecorder()
    try:
        yield rec
    finally:
        rec._finish()
    if len(rec.compiles) > max_compiles:
        where = f" in {tag}" if tag else ""
        raise RecompileError(
            f"{len(rec.compiles)} build event(s){where} after warmup "
            f"(allowed {max_compiles}): {', '.join(rec.compiles[:8])} — a "
            "precompile() is missing a kernel, a plan or a shape"
        )


def _cuda_devices() -> list:
    if not torch.cuda.is_available():
        return []
    return list(range(torch.cuda.device_count()))


def _segments(devices: list) -> dict:
    return {d: torch.cuda.memory_stats(d).get("segment.all.allocated", 0) for d in devices}


@contextlib.contextmanager
def no_new_device_memory(tag: str = ""):
    """Raise if the CUDA caching allocator maps a new segment on any card
    inside the context (the live loop allocates only from blocks its
    warm-up left cached).  A no-op without CUDA."""
    devices = _cuda_devices()
    before = _segments(devices)
    yield
    if devices:
        after = _segments(devices)
        grown = {d: after[d] - before[d] for d in devices if after[d] != before[d]}
        if grown:
            where = f" in {tag}" if tag else ""
            raise AssertionError(
                f"new device memory segments{where} after warmup: {grown} "
                "(card -> segments mapped)"
            )


@contextlib.contextmanager
def no_implicit_transfers():
    """``torch.cuda.set_sync_debug_mode("error")`` for the scope: a
    synchronising operation that is not inside :func:`declared_sync` —
    a blocking host<->device copy, ``.item()``, a stream synchronisation
    — raises.  A no-op without CUDA."""
    global _sync_guards
    if not _cuda_devices():
        yield
        return
    with _guard_lock:
        prev = torch.cuda.get_sync_debug_mode()
        _sync_guards += 1
        torch.cuda.set_sync_debug_mode(2)
    try:
        yield
    finally:
        with _guard_lock:
            _sync_guards -= 1
            torch.cuda.set_sync_debug_mode(prev)


@contextlib.contextmanager
def declared_sync():
    """The scope of one declared synchronising transfer (an engine's result
    fetch, a row snapshot pull or restore): inside an active
    :func:`no_implicit_transfers` the sync debug mode is lifted for it.
    Costs nothing when no guard is active."""
    if not _sync_guards:
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(0)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


@contextlib.contextmanager
def steady_state(max_compiles: int = 0, tag: str = ""):
    """The post-warmup invariant, whole: nothing built (a), no new device
    memory (b) and no implicit synchronisation (c).  Wrap the steady-state
    part of an engine loop — after precompile()/warm-up ticks — and every
    violation becomes a raised error instead of a silent stall."""
    with assert_no_recompile(max_compiles, tag=tag) as rec:
        with no_new_device_memory(tag):
            with no_implicit_transfers():
                yield rec

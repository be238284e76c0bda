"""PyTorch backend probe with a hang guard, and the kernel build cache.

The port's counterpart of the JAX package's ``utils/backend.py``, with a
torch probe in place of the JAX one.  A card that has dropped off the bus
(or a driver that has wedged) can make the first CUDA call block for a long
time; probing from a daemon thread with a bounded wait turns that failure
into a reportable result.  The ``doctor`` CLI uses this single
implementation.  The probe checks that CUDA is available, reads the
device's name and compute capability, and makes one small device round
trip.

The compilation cache here is where utils/cuda_build.py keeps the built
kernel libraries (``DriverParams.compilation_cache_dir``; ``None`` keeps
``build/torch_kernels/`` beside the package).  A restart that finds the
libraries there loads them instead of running ``nvcc``.
"""

from __future__ import annotations

import subprocess
import sys
import time

# ---------------------------------------------------------------------------
# the kernel build cache
# ---------------------------------------------------------------------------

_cache_enabled_dir: str | None = None
_cache_was_cold: bool = True  # dir empty/missing when the cache was enabled


def enable_compilation_cache(cache_dir: str) -> bool:
    """Build and load the package's CUDA kernels under ``cache_dir``
    (utils/cuda_build.BUILD_DIR) from now on.

    Restart latency: each kernel library costs seconds of ``nvcc``, paid
    again by every fresh checkout or container; a persistent directory
    turns a warm restart's builds into library loads (the libraries are
    keyed on their source text and flags, so a stale one is never
    loaded).  A library already loaded by this process stays loaded.
    Idempotent.  Returns whether the directory is in use — False when it
    cannot be created (the feature is downgraded, the caller never
    broken)."""
    global _cache_enabled_dir, _cache_was_cold
    import os
    from pathlib import Path

    from rplidar_ros2_driver_tpu_torch.utils import cuda_build

    try:
        was_cold = not os.path.isdir(cache_dir) or not os.listdir(cache_dir)
        os.makedirs(cache_dir, exist_ok=True)
    except OSError:
        return False
    cuda_build.BUILD_DIR = Path(cache_dir).resolve()
    if _cache_enabled_dir != str(cache_dir):
        _cache_was_cold = was_cold
    _cache_enabled_dir = str(cache_dir)
    return True


def maybe_enable_compilation_cache(cache_dir: str | None) -> bool:
    """Config-flag seam: use ``cache_dir`` for the kernel libraries when the
    parameter (``DriverParams.compilation_cache_dir``) is set, no-op when
    None/empty.  Every engine that builds hot-path kernels calls this at
    init."""
    if not cache_dir:
        return False
    return enable_compilation_cache(cache_dir)


def compilation_cache_status() -> dict:
    """Whether the build cache is on, where, how many entries it holds,
    and whether THIS run found it cold (empty or missing at enable time)."""
    import os

    if _cache_enabled_dir is None:
        return {"enabled": False}
    try:
        entries = len(os.listdir(_cache_enabled_dir))
    except OSError:
        entries = 0
    return {
        "enabled": True,
        "dir": _cache_enabled_dir,
        "entries": entries,
        "cold": _cache_was_cold,
    }


# ---------------------------------------------------------------------------
# the backend probe
# ---------------------------------------------------------------------------

# The probe as a program of its own, so that the subprocess flavour needs
# nothing of this package on the child's path; the in-process flavour runs
# the same ``probe()``.  A failed check raises RuntimeError.
_PROBE_CODE = """
import torch


def probe():
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA not available (torch %s, built for CUDA %s)"
                           % (torch.__version__, torch.version.cuda))
    n = torch.cuda.device_count()
    name = torch.cuda.get_device_name(0)
    major, minor = torch.cuda.get_device_capability(0)
    x = torch.arange(4096, dtype=torch.int32, device="cuda:0")
    back = (x * 3 + 1).cpu()
    if not torch.equal(back, torch.arange(4096, dtype=torch.int32) * 3 + 1):
        raise RuntimeError("device round trip returned wrong values")
    return ("cuda:0 %s (sm_%d%d), %d device(s), torch %s / CUDA %s, round trip ok"
            % (name, major, minor, n, torch.__version__, torch.version.cuda))


if __name__ == "__main__":
    print(probe())
"""


def _nonpositive_timeout_detail(timeout_s: float) -> str | None:
    """Probe timeouts arrive through flags, where 0 is one typo away.  Both
    probe flavours validate up front and report a timeout-style failure
    detail, not :func:`run_with_deadline`'s ValueError."""
    try:
        bad = not (timeout_s > 0)
    except TypeError:
        bad = True
    if bad:
        return (f"torch backend init not attempted: non-positive probe "
                f"timeout {timeout_s!r}")
    return None


def _probe_in_process(device: str) -> str:
    import torch

    if device == "cpu":
        x = torch.arange(4096, dtype=torch.int32)
        if not torch.equal(x * 3 + 1, torch.arange(1, 3 * 4096 + 1, 3, dtype=torch.int32)):
            raise RuntimeError("host round trip returned wrong values")
        return f"cpu (torch {torch.__version__}; the card not requested)"
    namespace: dict = {"__name__": "rplidar_torch_probe"}
    exec(compile(_PROBE_CODE, "<torch probe>", "exec"), namespace)  # noqa: S102
    return namespace["probe"]()


def probe_torch_backend(timeout_s: float, device: str = "cuda") -> tuple[bool, str]:
    """(ok, detail) — in this process, under a deadline: CUDA available,
    the device's name and compute capability, one small round trip
    (``device="cpu"``: a host round trip only).  On failure the detail
    tells a hang from an init error; a daemon probe thread means a hung
    init never blocks process exit."""
    bad = _nonpositive_timeout_detail(timeout_s)
    if bad is not None:
        return False, bad
    try:
        detail = run_with_deadline(lambda: _probe_in_process(device), timeout_s,
                                   what="torch backend init")
    except MeasurementWedgedError:
        return False, f"torch backend init timed out after {timeout_s:.0f} s"
    except BaseException as e:  # report the real failure, not a timeout
        return False, f"{type(e).__name__}: {e}"
    return True, detail


def probe_torch_backend_subprocess(timeout_s: float) -> tuple[bool, str]:
    """Like :func:`probe_torch_backend`, but in a THROWAWAY subprocess.

    CUDA initialisation is once per process: after an in-process probe
    hangs, every later CUDA call in the same process blocks behind it, so
    an in-process probe can never be retried.  A subprocess probe leaves
    this process's CUDA context untouched until a probe has succeeded."""
    bad = _nonpositive_timeout_detail(timeout_s)
    if bad is not None:
        return False, bad
    try:
        r = subprocess.run(
            [sys.executable, "-c", _PROBE_CODE],
            capture_output=True, text=True, timeout=timeout_s,
        )
    except subprocess.TimeoutExpired:
        return False, f"torch backend init timed out after {timeout_s:.0f} s"
    if r.returncode != 0:
        tail = (r.stderr.strip().splitlines() or ["backend init failed"])[-1]
        return False, tail
    return True, r.stdout.strip()


def guarded_backend_init(
    default_budget_s: float = 600.0,
    default_interval_s: float = 60.0,
    log=None,
) -> tuple[bool, str, bool]:
    """The two-stage backend guard: budgeted subprocess probes first
    (retryable — an in-process probe that hangs wedges this process's CUDA
    context for good), then THIS process's init under the in-process hang
    guard (the card can drop between the child's exit and this init).

    Env-tunable: ``BENCH_PROBE_BUDGET_S`` (total retry budget),
    ``BENCH_PROBE_TIMEOUT_S`` (per probe), ``BENCH_PROBE_INTERVAL_S``.

    Returns ``(ok, detail, poisoned)`` — ``poisoned`` means the in-process
    init was attempted and failed, so this process's CUDA context is
    unusable (compute in a fresh process).
    """
    import os

    per_probe_s = float(os.environ.get("BENCH_PROBE_TIMEOUT_S", 240))
    ok, detail = probe_torch_backend_with_retry(
        total_budget_s=float(os.environ.get("BENCH_PROBE_BUDGET_S", default_budget_s)),
        per_probe_s=per_probe_s,
        interval_s=float(os.environ.get("BENCH_PROBE_INTERVAL_S", default_interval_s)),
        log=log,
    )
    poisoned = False
    if ok:
        ok, detail = probe_torch_backend(per_probe_s)
        poisoned = not ok
    return ok, detail, poisoned


class MeasurementWedgedError(RuntimeError):
    """A device round trip blocked past its deadline mid-measurement.

    Init guards cannot catch this class of failure: the card initialised
    fine, rounds were completing, and then one device->host copy never
    returned.  Once it happens the process's device is unusable — the
    blocked copy never returns — so callers must emit whatever they
    already measured and exit rather than retry in-process.
    """


def run_with_deadline(fn, timeout_s: float, what: str = "device round-trip"):
    """Run ``fn()`` in a daemon thread, bounded by ``timeout_s``.

    A wedged device copy blocks in native code with no Python signal
    opportunity, so neither SIGALRM nor an exception can break it — but a
    daemon thread lets the caller walk away.  Raises
    :class:`MeasurementWedgedError` on timeout; exceptions from ``fn``
    propagate unchanged (including ``fn``'s own TimeoutErrors — only the
    deadline sentinel converts).  The abandoned thread keeps the wedged
    copy (and the process's CUDA context) hostage, so treat a wedge as
    terminal for device work in this process.

    A measurement-layer veneer over
    :func:`~rplidar_ros2_driver_tpu_torch.utils.fetch.bounded_fetch` (one
    daemon-thread deadline implementation, two exception contracts).
    """
    from rplidar_ros2_driver_tpu_torch.utils.fetch import (
        DeadlineExpired,
        bounded_fetch,
    )

    if not timeout_s or timeout_s <= 0:
        # bounded_fetch treats a falsy timeout as "run inline, unbounded",
        # which would remove the hang guard that is this function's purpose
        raise ValueError(
            f"run_with_deadline requires a positive deadline, got {timeout_s!r}"
        )

    def _captured():
        # fn's exceptions — including a DeadlineExpired from a NESTED
        # bounded_fetch — come back as values, so a DeadlineExpired
        # escaping the outer bounded_fetch can only be ITS OWN wait expiring
        try:
            return True, fn()
        except BaseException as e:  # re-raised on the caller thread
            return False, e

    try:
        ok, value = bounded_fetch(_captured, timeout_s, what)
    except DeadlineExpired:
        raise MeasurementWedgedError(
            f"{what} blocked past {timeout_s:.0f} s (device wedged mid-run)"
        ) from None
    if not ok:
        raise value
    return value


def exit_skipping_destructors(code: int = 0) -> None:
    """Flush stdio and ``os._exit`` — the only safe exit after a wedge.

    A thread abandoned by :func:`run_with_deadline` (or a hung init probe)
    is still blocked inside native runtime code; normal interpreter
    teardown can abort on it, which would turn an already-emitted artifact
    into a nonzero exit.  The flush matters: ``os._exit`` skips atexit AND
    stdio flushing.
    """
    import os

    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)


def probe_torch_backend_with_retry(
    total_budget_s: float = 1200.0,
    per_probe_s: float = 240.0,
    interval_s: float = 120.0,
    log=None,
    _probe=None,
) -> tuple[bool, str]:
    """Probe with retry: a transient outage should cost minutes, not a
    run.  Probes in subprocesses every ``interval_s`` for up to
    ``total_budget_s`` before giving up; returns the first success or
    (False, last-error) once the budget is spent.  ``log`` (if given)
    receives one progress line per failed attempt — callers whose stdout
    is machine-read should pass a stderr writer.
    """
    if _probe is None:
        # resolved at call time, so tests (and callers) can substitute the
        # subprocess probe via the module attribute
        _probe = probe_torch_backend_subprocess
    deadline = time.monotonic() + total_budget_s
    attempt = 0
    detail = "no probe attempted"
    while True:
        attempt += 1
        remaining = deadline - time.monotonic()
        ok, detail = _probe(min(per_probe_s, max(remaining, 10.0)))
        if ok:
            return True, detail
        if log is not None:
            log(f"backend probe {attempt} failed ({detail}); "
                f"{max(deadline - time.monotonic(), 0):.0f} s of budget left")
        if time.monotonic() + interval_s >= deadline:
            return False, (f"backend unreachable after {attempt} probes "
                           f"over {total_budget_s:.0f} s: {detail}")
        time.sleep(interval_s)

"""Per-stage latency tracing.

The reference has no tracing subsystem (SURVEY.md §5); the p99 publish
latency north-star metric needs one.  Lightweight monotonic-clock stage
timers with streaming percentile estimation over a bounded ring.
"""

from __future__ import annotations

import contextlib
import threading
import time

import numpy as np


class StageTimer:
    """Thread-safe named-stage duration collector (seconds)."""

    def __init__(self, capacity: int = 4096) -> None:
        self._capacity = capacity
        self._lock = threading.Lock()
        self._samples: dict[str, list] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                buf = self._samples.setdefault(name, [])
                buf.append(dt)
                if len(buf) > self._capacity:
                    del buf[: len(buf) - self._capacity]

    def record(self, name: str, seconds: float) -> None:
        with self._lock:
            buf = self._samples.setdefault(name, [])
            buf.append(seconds)
            if len(buf) > self._capacity:
                del buf[: len(buf) - self._capacity]

    def percentile(self, name: str, q: float) -> float:
        with self._lock:
            buf = self._samples.get(name)
            if not buf:
                return float("nan")
            return float(np.percentile(np.asarray(buf), q))

    def summary(self) -> dict[str, dict[str, float]]:
        with self._lock:
            out = {}
            for name, buf in self._samples.items():
                a = np.asarray(buf)
                if len(a) == 0:
                    continue
                out[name] = {
                    "n": int(len(a)),
                    "mean_ms": float(a.mean() * 1e3),
                    "p50_ms": float(np.percentile(a, 50) * 1e3),
                    "p99_ms": float(np.percentile(a, 99) * 1e3),
                    "max_ms": float(a.max() * 1e3),
                }
            return out

    def reset(self) -> None:
        with self._lock:
            self._samples.clear()


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Capture a ``torch.profiler`` host + CUDA trace around a block and
    write it to ``log_dir`` as a Chrome trace (viewable in Perfetto) —
    the real-tracing upgrade over the reference's printf packet dump
    (sl_async_transceiver.cpp:336-359).  Yields the profiler, so callers
    can read ``key_averages()`` too."""
    import os

    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))

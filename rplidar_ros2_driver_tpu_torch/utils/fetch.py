"""Deadline-bounded device->host fetch.

The reference bounds every wait on the device (grab timeout 2000 ms
default, sl_lidar_driver.h:332; channel waits, sl_lidar_driver.h:171-238
take explicit timeouts).  A host materialization of device output (here:
waiting on the CUDA event of the output's device->host copy) has no such
bound, and a wedged device can block it indefinitely.  This helper
races the fetch against a deadline on a daemon thread so the publish
path can surface a TimeoutError to the FSM's transient-fault recovery
instead of hanging the stream.

An expired fetch's thread stays blocked until the link resolves or the
process exits; callers keep the un-materialized handle (re-stash) so
the data itself is not lost, and their recovery cadence — not the tick
rate — bounds how many threads one incident can strand.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional, TypeVar

T = TypeVar("T")


class DeadlineExpired(TimeoutError):
    """Raised by :func:`bounded_fetch` when the DEADLINE expires — never
    by the wrapped ``fn`` — so layers that need to distinguish "the wait
    ran out" from "the fetch itself raised TimeoutError" can (see
    utils/backend.run_with_deadline).  A plain TimeoutError to every
    existing caller."""


def bounded_fetch(
    fn: Callable[[], T],
    timeout_s: Optional[float],
    what: str = "device->host fetch",
) -> T:
    """Run ``fn`` (a blocking fetch/materialize) with a deadline.

    ``timeout_s`` of None or 0 means unbounded: ``fn`` runs inline on
    the calling thread with zero overhead — the default, and always the
    right choice for a locally-attached device whose D2H is microseconds.
    """
    if not timeout_s:
        return fn()
    box: dict[str, object] = {}
    done = threading.Event()

    def run() -> None:
        try:
            box["out"] = fn()
        except BaseException as e:  # noqa: BLE001 - relayed to the caller
            box["err"] = e
        finally:
            done.set()

    threading.Thread(target=run, daemon=True, name="bounded-fetch").start()
    if not done.wait(timeout_s):
        raise DeadlineExpired(f"{what} exceeded {timeout_s} s")
    if "err" in box:
        raise box["err"]  # type: ignore[misc]
    return box["out"]  # type: ignore[return-value]

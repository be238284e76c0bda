"""Capped-backoff primitive for the scan loop's reconnects.

The JAX package's ``driver/health.py`` also carries the fleet-scale
per-stream health FSM; this package has no fleet yet, so it holds only
:class:`BackoffPolicy`, which the single-stream FSM (node/fsm.py) uses for
its CONNECTING retries.  Host-side bookkeeping: no device work.
"""

from __future__ import annotations

import random
from typing import Optional


class BackoffPolicy:
    """Capped exponential backoff with jitter — the ONE retry-delay
    helper, so no loop hand-rolls an unbounded ``while True: sleep(k)``.

    ``next_delay()`` returns ``min(base * 2**(attempt-1), max) *
    (1 + jitter * u)`` with ``u ∈ [0, 1)`` from a private RNG —
    seedable for deterministic tests, decorrelated across streams in
    production so a fleet-wide outage does not produce a synchronized
    reconnect storm.
    """

    def __init__(
        self,
        base_s: float = 0.5,
        max_s: float = 30.0,
        jitter: float = 0.1,
        seed: Optional[int] = None,
    ) -> None:
        if base_s <= 0 or max_s < base_s:
            raise ValueError("need 0 < base_s <= max_s")
        if not (0.0 <= jitter <= 1.0):
            raise ValueError("jitter must be within [0, 1]")
        self.base_s = float(base_s)
        self.max_s = float(max_s)
        self.jitter = float(jitter)
        self._rng = random.Random(seed)
        self.attempt = 0
        self.last_delay_s = 0.0

    def next_delay(self) -> float:
        self.attempt += 1
        # exponent clamp BEFORE the cap: 2.0**1024 overflows a Python
        # float, and a device that stays dead for hours walks the
        # attempt counter that far — an OverflowError here would crash
        # the retry loop it exists to pace
        raw = min(
            self.base_s * (2.0 ** min(self.attempt - 1, 63)), self.max_s
        )
        self.last_delay_s = raw * (1.0 + self.jitter * self._rng.random())
        return self.last_delay_s

    def reset(self) -> None:
        self.attempt = 0
        self.last_delay_s = 0.0

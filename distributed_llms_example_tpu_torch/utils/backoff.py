"""Capped-exponential retry backoff (the port's own copy of the JAX
package's ``utils/backoff.py``): the one owner of retry sleeps.  The
caller logs each retry, with its delay, before the sleep."""

from __future__ import annotations

import time


def sleep_backoff(delay_s: float, *, cap_s: float, factor: float = 2.0) -> float:
    """Sleep ``delay_s`` seconds and return the NEXT delay in the capped
    exponential schedule (``min(delay_s * factor, cap_s)``):

        delay = sleep_backoff(delay, cap_s=2.0)
    """
    time.sleep(max(0.0, float(delay_s)))
    return min(float(delay_s) * float(factor), float(cap_s))


def backoff_ticks(retries: int, *, base: int = 2, cap: int = 16) -> int:
    """The deterministic (tick-unit) twin of ``sleep_backoff``: how many
    scheduler ticks a request waits before its ``retries``-th re-dispatch."""
    if retries <= 0:
        return 0
    return min(int(base) * (2 ** (int(retries) - 1)), int(cap))

"""Exponential-backoff retry (reference util/retry.go:9-26).

The reference wraps apimachinery's wait.ExponentialBackoff with 100ms initial
delay, factor 3, 6 steps and no jitter. Same contract here, plus optional
jitter (the reference notes none; we keep the default faithful). The
result store's annotation flush retries through it; the API client's
transient-failure absorption takes ``jittered_delays``.
"""
from __future__ import annotations

import random
import time
from typing import Callable


def retry_with_exponential_backoff(
    fn: Callable[[], bool],
    *,
    initial_duration: float = 0.1,
    factor: float = 3.0,
    steps: int = 6,
    jitter: float = 0.0,
    sleep: Callable[[float], None] = time.sleep,
) -> bool:
    """Call ``fn`` until it returns True, backing off exponentially.

    Returns True on success, False if all ``steps`` attempts returned False.
    Mirrors util.RetryWithExponentialBackOff (reference util/retry.go:18-26):
    ``fn`` returning True means done; an exception propagates immediately.
    """
    duration = initial_duration
    for step in range(steps):
        if fn():
            return True
        if step == steps - 1:
            break
        d = duration
        if jitter > 0:
            d += duration * jitter * random.random()
        sleep(d)
        duration *= factor
    return False


def backoff_durations(
    initial_duration: float = 0.1, factor: float = 3.0, steps: int = 6
) -> list[float]:
    """The sleep schedule retry_with_exponential_backoff would use."""
    out, d = [], initial_duration
    for _ in range(steps - 1):
        out.append(d)
        d *= factor
    return out


def jittered_delays(
    initial_duration: float = 0.05,
    factor: float = 2.0,
    max_duration: float = 1.0,
    rng: Callable[[], float] = random.random,
):
    """Infinite jittered exponential delay schedule (generator).

    Deadline-driven retry loops (RemoteStore transient absorption) want
    "back off until the clock runs out", not a fixed step count: each
    ``next()`` yields the current base delay with up to +100% jitter
    (full-jitter upper half — decorrelates a thundering herd of engines
    retrying the same blipped apiserver), then doubles the base up to
    ``max_duration``. The caller owns the deadline.
    """
    d = initial_duration
    while True:
        yield d * (1.0 + rng())
        d = min(d * factor, max_duration)

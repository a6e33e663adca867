"""Exponential-backoff retry (reference util/retry.go:9-26).

The reference wraps apimachinery's wait.ExponentialBackoff with 100ms initial
delay, factor 3, 6 steps and no jitter. Same contract here, plus optional
jitter (the reference notes none; we keep the default faithful). The
result store's annotation flush retries through it.
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

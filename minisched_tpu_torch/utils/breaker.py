"""Counted circuit breaker: closed → open → half-open.

The RemoteStore's transient-failure absorption (``_call`` +
``utils/retry.py jittered_delays``) retries a down apiserver until
``retry_deadline_s`` — correct for a blip, but a HARD-down server gets
hammered with a fresh TCP SYN per jittered slot from every thread until
every caller's deadline lapses. The breaker sits in front of that loop:

    closed     requests flow; ``threshold`` CONSECUTIVE wire-class
               failures trip it open (one success resets the streak)
    open       requests fast-fail without touching the socket until
               ``reset_s`` has passed — the server gets a quiet window
    half-open  exactly ONE probe request is admitted; success closes
               the breaker, failure re-opens it for another reset_s

State transitions, fast-fails, and probes are all counted
(:meth:`stats`), and the engine surfaces them on ``/metrics`` through
``Scheduler.metrics()`` (``store_breaker_*``) when its store is a
RemoteStore. Thread-safe: one lock, no I/O under it.
"""
from __future__ import annotations

import threading
import time
from typing import Dict

__all__ = ["CircuitBreaker", "BreakerOpenError",
           "CLOSED", "OPEN", "HALF_OPEN"]

CLOSED, OPEN, HALF_OPEN = 0, 1, 2
_STATE_NAMES = ("closed", "open", "half-open")


class BreakerOpenError(RuntimeError):
    """Fast-fail verdict: the breaker is open and the probe slot is
    taken. Deliberately a RuntimeError so callers' existing transient
    containment classifies it like the wire failure it stands in for."""


class CircuitBreaker:
    def __init__(self, threshold: int = 6, reset_s: float = 0.5,
                 name: str = "apiserver"):
        if threshold < 1:
            raise ValueError(f"threshold={threshold} must be >= 1")
        if reset_s <= 0:
            raise ValueError(f"reset_s={reset_s} must be > 0")
        self.threshold = int(threshold)
        self.reset_s = float(reset_s)
        self.name = name
        self._lock = threading.Lock()
        self._state = CLOSED
        self._failures = 0        # consecutive wire-class failures
        self._opened_at = 0.0
        self._probing = False     # the half-open probe slot is taken
        self._opens = 0
        self._fast_fails = 0
        self._probes = 0

    def allow(self) -> bool:
        """May a request proceed right now? False = fast-fail (counted)
        — the caller should wait toward the next probe slot instead of
        touching the socket."""
        with self._lock:
            if self._state == CLOSED:
                return True
            now = time.monotonic()
            if self._state == OPEN and now - self._opened_at >= self.reset_s:
                self._state = HALF_OPEN
                self._probing = True
                self._probes += 1
                return True
            if self._state == HALF_OPEN and not self._probing:
                self._probing = True
                self._probes += 1
                return True
            self._fast_fails += 1
            return False

    def record_success(self) -> None:
        """The server answered (any HTTP status — a 404 is a healthy
        wire): close and reset the failure streak."""
        with self._lock:
            self._state = CLOSED
            self._failures = 0
            self._probing = False

    def record_failure(self) -> None:
        """A wire-class failure (refused/reset/timeout/5xx/malformed):
        half-open re-opens immediately; closed opens at the threshold.
        Already-open stays put — re-stamping the open clock on every
        straggling in-flight failure would keep pushing the probe slot
        out past ``reset_s`` for as long as old requests keep timing
        out, starving recovery detection."""
        with self._lock:
            self._probing = False
            self._failures += 1
            if self._state == OPEN:
                return
            if (self._state == HALF_OPEN
                    or self._failures >= self.threshold):
                self._opens += 1
                self._state = OPEN
                self._opened_at = time.monotonic()

    @property
    def state(self) -> int:
        return self._state

    @property
    def state_name(self) -> str:
        return _STATE_NAMES[self._state]

    def next_probe_in(self) -> float:
        """Seconds until a blocked caller should knock again — the
        sleep hint for the fast-fail path. Open: the remaining reset
        window. Half-open: one reset window (the probe slot is taken
        and its request may block for its full timeout; a 0 hint would
        have every waiting thread busy-poll the lock at the caller's
        floor cadence for the whole probe)."""
        with self._lock:
            if self._state == OPEN:
                return max(0.0, self._opened_at + self.reset_s
                           - time.monotonic())
            if self._state == HALF_OPEN:
                return self.reset_s
            return 0.0

    def stats(self) -> Dict[str, float]:
        with self._lock:
            return {
                "breaker_state": self._state,
                "breaker_opens_total": self._opens,
                "breaker_fast_fails_total": self._fast_fails,
                "breaker_probes_total": self._probes,
                "breaker_consecutive_failures": self._failures,
            }

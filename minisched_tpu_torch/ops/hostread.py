"""Blocking reads of the card made inside a step's ops (the gang
admission's loop, the caps' ``any_enforced``), tallied per host thread.

The engine books a step's reads from the delta of the calling thread's
tally around the call (``engine/scheduler._count_launches``), beside its
own fetches, into ``host_syncs_total`` and ``fetch_wait_s_total``. A
read returns what the plain conversion returns: the tally never changes
an op's result.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, List

_tls = threading.local()


def thread_reads() -> List:
    """The calling thread's [reads, seconds] (its live tally: copy the
    two numbers to take a "before")."""
    tally = getattr(_tls, "tally", None)
    if tally is None:
        tally = _tls.tally = [0, 0.0]
    return tally


def host_read(conv: Callable, x):
    """``conv(x)`` (``bool``, ``int``, ``torch.Tensor.tolist`` of a
    device tensor: the host waits for the card), counted and timed on
    the calling thread's tally."""
    t0 = time.perf_counter()
    out = conv(x)
    tally = thread_reads()
    tally[0] += 1
    tally[1] += time.perf_counter() - t0
    return out

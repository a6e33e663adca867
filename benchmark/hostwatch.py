"""What the host did over the window, read from outside the program:
the interpreter's garbage-collector pauses (``gc.callbacks``) and the
process's CPU time (``getrusage``). It changes nothing in the run; it
explains how a run's rate came about.
"""
from __future__ import annotations

import gc
import os
import resource
import threading
import time
from typing import Dict, List


class HostWatch:
    """Records every collection's start (wall clock), pause and
    generation from ``start`` to ``stop``, and the process's CPU over
    ``[mark, close]``."""

    def __init__(self):
        self.pauses: List[tuple] = []   # (wall start, seconds, generation)
        self._t = 0.0
        self._w = 0.0
        self.r0 = self.r1 = None
        self.threads = 0

    def _cb(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._w = time.time()
            self._t = time.perf_counter()
        else:
            self.pauses.append((self._w, time.perf_counter() - self._t,
                                int(info["generation"])))

    def start(self) -> None:
        gc.callbacks.append(self._cb)

    def mark(self) -> None:
        self.r0 = resource.getrusage(resource.RUSAGE_SELF)

    def close(self) -> None:
        self.r1 = resource.getrusage(resource.RUSAGE_SELF)
        self.threads = threading.active_count()

    def stop(self) -> None:
        if self._cb in gc.callbacks:
            gc.callbacks.remove(self._cb)

    def summary(self, t0: float, t_end: float, parts: int = 5) -> Dict:
        """The window's pauses by generation and by part of the window,
        and the CPU read between ``mark`` and ``close``."""
        gens = {g: [0, 0.0] for g in range(3)}
        by_part = [0.0] * parts
        step = (t_end - t0) / parts
        for w, s, g in self.pauses:
            if t0 <= w < t_end:
                gens[g][0] += 1
                gens[g][1] += s
                by_part[min(int((w - t0) / step), parts - 1)] += s
        out = {"gc": {f"gen{g}": {"n": n, "s": s}
                      for g, (n, s) in gens.items()},
               "gc_s": sum(s for _n, s in gens.values()),
               "gc_s_by_part": by_part,
               "gc_longest_s": max((s for w, s, _g in self.pauses
                                    if t0 <= w < t_end), default=0.0),
               "threads": self.threads,
               "cores": len(os.sched_getaffinity(0))}
        if self.r0 is not None and self.r1 is not None:
            out["cpu_user_s"] = self.r1.ru_utime - self.r0.ru_utime
            out["cpu_sys_s"] = self.r1.ru_stime - self.r0.ru_stime
        return out

"""The traced run's reduction: from ``torch.profiler``'s trace and the
engine's counters to the numbers the per-layer metrics read.

The profiler records the last ``profile_s`` seconds of the window. The
reduction gives the device's busy time (the union of kernel, copy and
set intervals), the traced window's length, each device operation's
total time and count, and the idle gaps between device work, each named
by the engine span (``minisched_tpu_torch.obs``, armed for the traced
run) that covered it on the host.
"""
from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from typing import Dict, List, Optional

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# The port's hand-written kernels (minisched_tpu_torch/csrc/*.cu).
HAND_KERNELS = ("greedy_assign_kernel", "shortlist_select_kernel",
                "shortlist_scan_kernel", "insert_ports_kernel",
                "caps_scan_kernel", "auction_kernel", "bid_auction_kernel")
# The engine's spans (minisched_tpu_torch/obs's catalog): an idle gap is
# named by the scheduling thread's span that covered it, else by a
# worker's (the commit worker, the binders), else "none".
SCHEDULING_SPANS = ("queue.pop", "prepare", "encode.pods", "h2d.dyn",
                    "step.dispatch", "resolve", "fetch.decision",
                    "fetch.spread", "gather.wait", "commit.wait")
WORKER_SPANS = ("commit", "commit.flush", "bind.bulk", "bind.pod")
ENGINE_SPANS = SCHEDULING_SPANS + WORKER_SPANS
NAME_CHARS = 120   # a device operation's name, cut for the breakdown
TOP = 10
MARK = "bench.profile"


def counter_delta(a: dict, b: dict) -> Dict[str, float]:
    """``b - a`` of every number the engine's ``metrics()`` holds."""
    out = {}
    for k, v in b.items():
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            out[k] = float(v) - float(a.get(k, 0) or 0)
    return out


class Profiler:
    """Records the window's last ``profile_s`` seconds from the thread
    that drives the traffic (the profiler starts and stops on the
    thread that first used it): ``poll`` starts it when the time comes,
    ``finish`` stops it after the window and reduces the trace into
    ``result``. The device's times are the trace's; the engine's spans
    come from its own recorder (``obs``), placed on the same wall clock
    by a marker span opened at a known time."""

    def __init__(self, run, t_end: float, traffic: dict):
        self.run = run
        self.t_end = t_end
        self.t_start = t_end - float(traffic["profile_s"])
        self.prof = None
        self.w0 = self.w1 = 0
        self.m0: dict = {}
        self.m1: dict = {}
        self.result: Optional[dict] = None

    @staticmethod
    def _new(device: str):
        from torch.profiler import ProfilerActivity, profile

        return profile(activities=[ProfilerActivity.CPU if device == "cpu"
                                   else ProfilerActivity.CUDA])

    @classmethod
    def warm(cls, device: str) -> None:
        """Start and stop a profile once in set-up, so that starting
        one inside the window is quick."""
        p = cls._new(device)
        p.start()
        p.stop()

    def poll(self, now: float) -> None:
        if self.prof is None and now >= self.t_start:
            from minisched_tpu_torch import obs

            self.prof = self._new(self.run.device)
            self.prof.start()
            with obs.span(MARK):
                self.w0 = time.time_ns()
            self.m0 = self.run.sched.metrics()

    def stop(self) -> None:
        """At the window's close: the counters, then the profiler."""
        if self.prof is None:
            return
        self.m1 = self.run.sched.metrics()
        self.w1 = time.time_ns()
        self.prof.stop()

    def finish(self) -> None:
        from minisched_tpu_torch import obs

        if self.prof is None:
            return
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                trace = json.load(f)
        finally:
            os.unlink(path)
        self.prof = None
        spans = obs.TRACE.events()
        mark = [e for e in spans if e["name"] == MARK]
        host = []
        if mark:
            shift = self.w0 - mark[-1]["ts_ns"]
            host = [(e["name"], e["ts_ns"] + shift,
                     e["ts_ns"] + e["dur_ns"] + shift)
                    for e in spans if e["ph"] == "X"
                    and e["name"] in ENGINE_SPANS]
        self.result = reduce_trace(trace, self.w0, self.w1, host)
        self.result["counters"] = counter_delta(self.m0, self.m1)


def _merge(spans: List[tuple]) -> List[tuple]:
    out: List[list] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


def device_events(trace: dict) -> List[tuple]:
    """(name, start ns, end ns) of every kernel, copy and set in a
    Chrome trace, on the wall clock: the trace's microseconds after its
    ``baseTimeNanoseconds`` (0 when the trace gives none)."""
    base = float(trace.get("baseTimeNanoseconds", 0) or 0)
    return [(e["name"], base + 1e3 * e["ts"],
             base + 1e3 * (e["ts"] + e["dur"]))
            for e in trace.get("traceEvents", [])
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS
            and "dur" in e]


class _Lane:
    """Spans (name, start, end) searchable by the interval they cover."""

    def __init__(self, spans: List[tuple]):
        self.spans = sorted(spans, key=lambda h: h[1])
        self.starts = [h[1] for h in self.spans]
        self.longest = max((h[2] - h[1] for h in self.spans), default=0.0)

    def cover(self, a: float, b: float) -> Optional[str]:
        """The span overlapping [a, b] most (the innermost on a tie)."""
        best, best_key = None, None
        lo = bisect.bisect_left(self.starts, a - self.longest)
        for name, s, e in self.spans[lo:bisect.bisect_left(self.starts, b)]:
            ov = min(b, e) - max(a, s)
            if ov > 0 and (best_key is None or (ov, s - e) > best_key):
                best, best_key = name, (ov, s - e)
        return best


def kernel_name(name: str) -> str:
    """A device operation's function name, without its return type,
    namespaces, template and parameter lists
    (``void (anonymous namespace)::k<...>(...)`` -> ``k``)."""
    if name.startswith("void "):
        name = name[5:]
    name = name.replace("(anonymous namespace)::", "")
    for sep in ("<", "("):
        name = name.split(sep, 1)[0]
    return name.rsplit("::", 1)[-1].strip()


def reduce_trace(trace: dict, w0: float, w1: float,
                 host: List[tuple]) -> dict:
    """The busy time, each device operation's time and count, and the
    idle gaps named by the engine span that covered them, over the
    window ``[w0, w1]`` (wall-clock ns). ``host`` holds the engine's
    spans as (name, start ns, end ns)."""
    dev = []
    for name, a, b in device_events(trace):
        a, b = max(a, w0), min(b, w1)
        if b > a:
            dev.append((name, a, b))
    ops: Dict[str, list] = {}
    for name, a, b in dev:
        o = ops.setdefault(name, [0.0, 0])
        o[0] += (b - a) * 1e-9
        o[1] += 1
    merged = _merge([(a, b) for _n, a, b in dev])
    busy = sum(b - a for a, b in merged)
    edges = [w0] + [x for ab in merged for x in ab] + [w1]
    gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    lanes = [_Lane([h for h in host if h[0] in names])
             for names in (SCHEDULING_SPANS, WORKER_SPANS)]
    named: Dict[str, float] = {}
    for a, b in gaps:
        best = "none"
        for lane in lanes:
            found = lane.cover(a, b)
            if found is not None:
                best = found
                break
        named[best] = named.get(best, 0.0) + (b - a) * 1e-9
    device_ops = sorted(([k[:NAME_CHARS], v[0]] for k, v in ops.items()),
                        key=lambda kv: -kv[1])[:TOP]
    idle = sorted(([k, v] for k, v in named.items()),
                  key=lambda kv: -kv[1])[:TOP]
    return {"window_s": (w1 - w0) * 1e-9, "busy_s": busy * 1e-9,
            "ops": {k: {"s": v[0], "n": v[1]} for k, v in ops.items()},
            "device_ops": device_ops, "idle_gaps": idle}

"""Engine flight recorder: process-wide span/instant tracer and
fixed-bucket latency histograms.

The port's bursts are host-bound, and the host clocks alone cannot say
where the time between batches goes. This module is the instrument: a
lock-light per-thread ring-buffer tracer in the mold of ``faults.py``
(env-gated; unset = a single attribute test on the hot path) recording
**spans** (monotonic-ns begin/end, nested per thread) and **instants**
at the engine's seams, exported as Chrome trace-event JSON
(:meth:`TraceRecorder.export_chrome`, loadable in Perfetto).

Arming:

    MINISCHED_TRACE=1        enable the tracer (tests/embedders use
                             :func:`configure`)
    MINISCHED_TRACE_BUF=N    per-thread ring capacity in events
                             (default 65536; the ring wraps, keeping the
                             newest events, and reports what it dropped)

Seam catalog (the span names the engine emits; ``seq`` = the batch's
id, ``engine._batch_seq`` as the batch's prepare assigns it):

    queue.pop        batch gather (engine/queue.py; the gather worker's
                     lane in pipelined mode)
    prepare          encode → snapshot → dispatch (scheduling thread);
                     ``seq``
    encode.pods      pod-feature encode
    h2d.dyn          residency attach corrections
    step.dispatch    step dispatch + decision pack; ``seq``
    resolve          fetch → residual → assume → bind submit; ``seq``
    fetch.decision / fetch.spread / fetch.index / fetch.loop /
    fetch.carry / fetch.free / fetch.tables / fetch.check /
    fetch.verify / fetch.preempt
                     blocking device readbacks (+ unpack), each counted
                     in the engine's ``host_syncs_total`` and timed in
                     ``fetch_wait_s_total``; ``seq`` (a loop tranche's
                     first slot's)
    gather.wait      the scheduling thread waiting on the next pop
    commit / commit.flush
                     metrics fold / bulk failure flush (commit worker);
                     ``seq``
    commit.wait      the scheduling thread waiting on the commit worker
    bind.bulk / bind.pod
                     binder-pool store commits (``bind.bulk``: ``seq``)
    gc               a generation-1 or -2 collection of the interpreter's
                     garbage collector, on the thread that ran it (every
                     thread stops meanwhile); args ``generation``,
                     ``collected``. Written by :data:`GC_WATCH`'s
                     callback straight into that thread's ring; gen-0
                     collections are only counted

Instants: ``fault.<gate>`` (every fault-gate fire, faults.py),
``supervisor.escalate`` / ``supervisor.recover`` /
``supervisor.early_warning`` (ladder transitions, SLO warnings),
``watchdog.trip``, ``residency.desync``, ``shortlist.desync``,
``slo.burn`` / ``slo.clear``, ``overload.escalate`` /
``overload.recover`` / ``overload.tune`` — so a faulted or overloaded
run's timeline shows *where* the ladders moved.

While the tracer is on, every span (but ``gc``) also enters a
``torch.profiler.record_function`` of the same name, so a
``torch.profiler`` capture (and, on a card, its NVTX ranges) lines up
with the engine spans by name. By time, too: :meth:`TraceRecorder.
export_chrome` writes the wall clock read beside the monotonic anchor
at ``configure`` as ``otherData.wall_t0_ns``, so an event's wall time
is ``wall_t0_ns + 1000 * ts``, on the clock of a profiler trace's
``baseTimeNanoseconds``.

Collector watch: :data:`GC_WATCH` (installed once per process by the
first engine that starts; always on) counts the interpreter's
collections by generation and their pause seconds, process-wide, for
the engines' ``metrics()`` (``gc_collections_gen0/1/2``,
``gc_pause_s_total``); armed, the gen-1 and gen-2 collections are also
``gc`` spans.

The tracer never touches decisions, PRNG state, or any engine input:
decisions are bit-identical with the recorder on or off.

Histograms: :class:`Histogram` is a fixed-bucket latency histogram
(bounded memory, mergeable, Prometheus-shaped buckets).
"""
from __future__ import annotations

import functools
import gc
import json
import os
import threading
import time
from bisect import bisect_left
from typing import Dict, List, Optional

__all__ = ["TRACE", "TraceRecorder", "Histogram", "LATENCY_BUCKETS",
           "configure", "span", "instant", "traced", "hist_quantile",
           "ring_tail", "GC_WATCH", "GcWatch"]


def ring_tail(buf: list, n: int, cap: int) -> list:
    """Oldest-retained-first copy of a bounded overwrite ring (the
    journal / timeline ring discipline: append at ``n % cap`` once
    full). One shared definition — the rotation arithmetic must not be
    re-derived at every snapshot site. Caller holds whatever lock
    guards ``buf``."""
    if n <= cap:
        return list(buf)
    i = n % cap
    return buf[i:] + buf[:i]


class _NullSpan:
    """The shared disabled-path span: enter/exit/set are no-ops and the
    object is a singleton, so an unarmed seam costs one attribute test
    plus an allocation-free call."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **args) -> None:
        pass


_NULL = _NullSpan()


class _Span:
    """One armed span: monotonic-ns begin/end recorded into the calling
    thread's ring at exit (children therefore precede parents in the
    raw stream; the Chrome "X" complete-event form carries begin+dur, so
    viewers re-nest by interval). Mirrors itself into a
    torch.profiler.record_function of the same name."""

    __slots__ = ("_rec", "name", "args", "_t0", "_ann")

    def __init__(self, rec: "TraceRecorder", name: str,
                 args: Optional[dict]):
        self._rec = rec
        self.name = name
        self.args = args
        self._ann = None

    def __enter__(self):
        ann_cls = self._rec._ann
        if ann_cls is not None:
            try:
                self._ann = ann_cls(self.name)
                self._ann.__enter__()
            except Exception:
                self._ann = None
        self._t0 = time.monotonic_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.monotonic_ns()
        if self._ann is not None:
            try:
                self._ann.__exit__(*exc)
            except Exception:
                pass
        self._rec._append(("X", self.name, self._t0, t1 - self._t0,
                           self.args))
        return False

    def set(self, **args) -> None:
        """Attach/merge args discovered mid-span (e.g. the popped batch
        size)."""
        if self.args is None:
            self.args = args
        else:
            self.args.update(args)


class _Ring:
    """Per-thread event ring. Owned (appended) by exactly one thread;
    the recorder's snapshot copies it under the registry lock — the only
    cross-thread access, and a torn read there can at worst duplicate or
    drop one wrapping event, never corrupt the stream."""

    __slots__ = ("cap", "buf", "n", "tid", "tname", "epoch")

    def __init__(self, cap: int, epoch: int, tid: int):
        t = threading.current_thread()
        self.cap = cap
        self.buf: List[tuple] = []
        self.n = 0  # total appended (>= len(buf) once wrapped)
        # Synthetic lane id, NOT the OS thread ident: CPython reuses
        # pthread idents of joined threads, so successive engine runs'
        # scheduling loops would otherwise merge onto one exported lane
        # (mislabeled in Perfetto, and their disjoint windows spliced by
        # trace_view.thread_coverage).
        self.tid = tid
        self.tname = t.name
        self.epoch = epoch

    def append(self, ev: tuple) -> None:
        # The slot is claimed before it is written: a collection that
        # starts after the claim (GcWatch's callback appends a ``gc``
        # span on this thread) takes the next slot, never this one.
        n = self.n
        self.n = n + 1
        if n < self.cap:
            self.buf.append(ev)
        else:
            self.buf[n % self.cap] = ev


class TraceRecorder:
    """The process-wide flight recorder. One instance (:data:`TRACE`);
    tests re-arm it with :func:`configure` and disarm with
    ``configure(False)`` (which also clears the rings — a reconfigure
    bumps the epoch so stale thread-local rings from the previous
    configuration can never leak events across runs)."""

    def __init__(self, enabled: bool = False, buf: int = 65536):
        self._lock = threading.Lock()
        self._local = threading.local()
        self._epoch = 0
        self.configure(enabled, buf)

    def configure(self, enabled: bool, buf: int = 65536) -> None:
        with self._lock:
            self._epoch += 1
            self._rings: List[_Ring] = []
            self._tid_seq = 0
            self.buf_cap = max(16, int(buf))
            # t0 anchors exported timestamps near zero (Perfetto handles
            # absolute ns fine; small numbers are just friendlier); the
            # wall clock read beside it places the export on the wall.
            self._t0 = time.monotonic_ns()
            self.wall_t0_ns = time.time_ns()
            # gc spans a collection could not record (its thread had no
            # ring and the registry lock was taken).
            self._gc_unrecorded = 0
            self._ann = None
            if enabled:
                # Mirror spans into torch.profiler so a profiler capture
                # lines up with them by name. Imported here, not at module
                # import, so the disarmed path never loads the profiler.
                try:
                    from torch.profiler import record_function
                    self._ann = record_function
                except Exception:
                    self._ann = None
            # Written LAST: a racing span() sees enabled only after the
            # ring registry above is consistent.
            self.enabled = bool(enabled)

    # ---- recording ------------------------------------------------------

    def _ring(self, block: bool = True) -> Optional[_Ring]:
        """The calling thread's ring of the current configuration, made
        on first use. ``block=False`` (a collector callback, which may
        run while this very thread holds the registry lock) returns None
        where making it would wait for the lock."""
        r = getattr(self._local, "ring", None)
        if r is None or r.epoch != self._epoch:
            if not self._lock.acquire(blocking=block):
                return None
            try:
                self._tid_seq += 1
                r = _Ring(self.buf_cap, self._epoch, self._tid_seq)
                if r.epoch == self._epoch:
                    self._rings.append(r)
            finally:
                self._lock.release()
            self._local.ring = r
        return r

    def _append(self, ev: tuple) -> None:
        self._ring().append(ev)

    def _append_gc(self, t0_ns: int, dur_ns: int, args: dict) -> None:
        """A ``gc`` span from the collector callback: one tuple into the
        collecting thread's ring, no profiler annotation, and never a
        wait on the registry lock."""
        r = self._ring(block=False)
        if r is None:
            self._gc_unrecorded += 1
            return
        r.append(("X", "gc", t0_ns, dur_ns, args))

    def instant(self, name: str, args: Optional[dict] = None) -> None:
        if self.enabled:
            self._ring().append(("i", name, time.monotonic_ns(), 0, args))

    # ---- readback -------------------------------------------------------

    def events(self) -> List[dict]:
        """Snapshot every thread's ring as a time-ordered list of event
        dicts: {"ph": "X"|"i", "name", "ts_ns", "dur_ns", "tid",
        "thread", "args"} with ts_ns relative to the configure anchor."""
        with self._lock:
            rings = [(r.tid, r.tname, list(r.buf)) for r in self._rings]
        out = []
        for tid, tname, buf in rings:
            for ph, name, t_ns, dur_ns, args in buf:
                out.append({"ph": ph, "name": name,
                            "ts_ns": t_ns - self._t0, "dur_ns": dur_ns,
                            "tid": tid, "thread": tname, "args": args})
        out.sort(key=lambda e: e["ts_ns"])
        return out

    def dropped(self) -> int:
        """Events the rings have overwritten (total appended − retained),
        and ``gc`` spans that found no ring."""
        with self._lock:
            return (sum(max(0, r.n - len(r.buf)) for r in self._rings)
                    + self._gc_unrecorded)

    def export_chrome(self, path: str) -> str:
        """Write the ring contents as Chrome trace-event JSON (the
        ``traceEvents`` object form; loads in Perfetto / chrome://tracing
        / TensorBoard's trace viewer). Returns ``path``. Timestamps are
        microseconds (the format's unit) after the ``configure`` anchor,
        whose wall clock is ``otherData.wall_t0_ns``; thread-name
        metadata events carry the real thread names so the engine's
        scheduling-loop / gather / commit / binder lanes are labeled."""
        pid = os.getpid()
        evs = self.events()
        out = []
        seen_tids: Dict[int, str] = {}
        for e in evs:
            if e["tid"] not in seen_tids:
                seen_tids[e["tid"]] = e["thread"]
        for tid, tname in seen_tids.items():
            out.append({"ph": "M", "name": "thread_name", "pid": pid,
                        "tid": tid, "args": {"name": tname}})
        for e in evs:
            rec = {"name": e["name"], "ph": e["ph"], "pid": pid,
                   "tid": e["tid"], "ts": e["ts_ns"] / 1e3}
            if e["ph"] == "X":
                rec["dur"] = e["dur_ns"] / 1e3
            else:
                rec["s"] = "t"  # instant scope: thread
            if e["args"]:
                rec["args"] = {k: (v if isinstance(v, (int, float, str,
                                                       bool, type(None)))
                                   else str(v))
                               for k, v in e["args"].items()}
            out.append(rec)
        doc = {"traceEvents": out, "displayTimeUnit": "ms",
               "otherData": {"producer": "minisched_tpu_torch flight recorder",
                             "dropped_events": self.dropped(),
                             "wall_t0_ns": self.wall_t0_ns}}
        with open(path, "w", encoding="utf-8") as f:
            json.dump(doc, f, separators=(",", ":"))
        return path


def _from_env() -> TraceRecorder:
    enabled = os.environ.get("MINISCHED_TRACE", "") == "1"
    try:
        buf = int(os.environ.get("MINISCHED_TRACE_BUF", "65536"))
    except ValueError:
        buf = 65536
    return TraceRecorder(enabled, buf)


#: The process-wide recorder every seam imports.
TRACE = _from_env()


def configure(enabled: bool, buf: int = 65536) -> TraceRecorder:
    """Re-arm the process-wide recorder (tests / embedders). Clears the
    rings; ``configure(False)`` disarms."""
    TRACE.configure(enabled, buf)
    return TRACE


def span(name: str, **args):
    """Open a span at a seam: ``with span("fetch.decision"): ...``.
    Unarmed: one attribute test, returns the shared no-op span."""
    rec = TRACE
    if not rec.enabled:
        return _NULL
    return _Span(rec, name, args or None)


def instant(name: str, **args) -> None:
    """Record a point event (fault fire, ladder transition). Unarmed:
    one attribute test."""
    rec = TRACE
    if rec.enabled:
        rec.instant(name, args or None)


def traced(name: str):
    """Decorator form of :func:`span` for whole-function seams (cache
    snapshots, resultstore ingest). Off path: one extra call frame + the
    attribute test — per-batch seams only, never per-pod loops."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*a, **kw):
            rec = TRACE
            if not rec.enabled:
                return fn(*a, **kw)
            with _Span(rec, name, None):
                return fn(*a, **kw)

        return wrapper

    return deco


# ---------------------------------------------------------------------------
# The interpreter's collector, watched from inside
# ---------------------------------------------------------------------------


class GcWatch:
    """One ``gc.callbacks`` hook for the whole process: each collection's
    count by generation and its pause (``time.perf_counter``, from the
    callback's "start" to its "stop"), and, with the recorder armed, a
    ``gc`` span for each gen-1 and gen-2 collection. Process-wide: every
    engine of a process reports the same numbers. Collections never
    overlap (the interpreter runs one at a time), so the callback keeps
    its state in plain attributes."""

    def __init__(self):
        self.collections = [0, 0, 0]
        self.pause_s = 0.0
        self._t = 0.0
        self._t_ns = 0
        self._lock = threading.Lock()

    def install(self) -> None:
        """Hook the collector (once; later calls do nothing)."""
        with self._lock:
            if self._cb not in gc.callbacks:
                gc.callbacks.append(self._cb)

    def uninstall(self) -> None:
        with self._lock:
            if self._cb in gc.callbacks:
                gc.callbacks.remove(self._cb)

    def _cb(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t_ns = time.monotonic_ns() if TRACE.enabled else 0
            self._t = time.perf_counter()
            return
        dt = time.perf_counter() - self._t
        g = info["generation"]
        self.collections[g] += 1
        self.pause_s += dt
        if g and self._t_ns and TRACE.enabled:
            TRACE._append_gc(self._t_ns, time.monotonic_ns() - self._t_ns,
                             {"generation": g, "collected": info["collected"]})

    def counters(self) -> Dict[str, float]:
        """The process's collections by generation and their pause
        seconds since the hook went in."""
        c = self.collections
        return {"gc_collections_gen0": c[0], "gc_collections_gen1": c[1],
                "gc_collections_gen2": c[2], "gc_pause_s_total": self.pause_s}


#: The process-wide collector watch (the engines install it at start).
GC_WATCH = GcWatch()


# ---------------------------------------------------------------------------
# Fixed-bucket latency histograms
# ---------------------------------------------------------------------------

#: Upper bounds (seconds) of the finite buckets, Prometheus-style
#: log-spaced; one implicit +Inf bucket follows. Fixed across the fleet
#: so series from different runs/hosts aggregate (the Prometheus
#: histogram contract — quantiles are computed from counts, never from
#: raw samples the server would have to keep).
LATENCY_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                   0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)


class Histogram:
    """Fixed-bucket histogram: observe = one bisect + three adds under a
    private lock (bound pods arrive from binder threads and the
    scheduling thread). Snapshot/quantile never block observers for
    long; the exposition (`_bucket`/`_sum`/`_count`) is derived from the
    snapshot."""

    __slots__ = ("bounds", "_counts", "_sum", "_n", "_lock")

    def __init__(self, bounds=LATENCY_BUCKETS):
        self.bounds = tuple(float(b) for b in bounds)
        self._counts = [0] * (len(self.bounds) + 1)  # +1: the +Inf bucket
        self._sum = 0.0
        self._n = 0
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        # bisect_left: an observation EQUAL to a bound belongs in that
        # bound's bucket — the Prometheus ``le`` (<=) contract the
        # exposition advertises.
        i = bisect_left(self.bounds, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._n += 1

    def observe_many(self, vals) -> None:
        """Bulk observe: one lock hold for a whole bound tranche."""
        idx = [bisect_left(self.bounds, v) for v in vals]
        with self._lock:
            for i in idx:
                self._counts[i] += 1
            self._sum += float(sum(vals))
            self._n += len(idx)

    def snapshot(self) -> dict:
        with self._lock:
            return {"bounds": list(self.bounds),
                    "counts": list(self._counts),
                    "sum": round(self._sum, 6), "count": self._n}

    def quantile(self, q: float) -> float:
        return hist_quantile(self.snapshot(), q)


def hist_quantile(snap: dict, q: float) -> float:
    """Prometheus-style quantile estimate from a histogram snapshot:
    find the bucket holding the q-th observation and interpolate
    linearly inside it (the +Inf bucket reports its lower bound — the
    last finite boundary — like histogram_quantile does)."""
    counts = snap["counts"]
    bounds = snap["bounds"]
    n = snap["count"]
    if n <= 0:
        return 0.0
    rank = q * n
    cum = 0.0
    for i, c in enumerate(counts):
        cum += c
        if cum >= rank:
            if i >= len(bounds):  # +Inf bucket
                return float(bounds[-1]) if bounds else 0.0
            lo = float(bounds[i - 1]) if i else 0.0
            hi = float(bounds[i])
            if c <= 0:
                return hi
            frac = (rank - (cum - c)) / c
            return lo + (hi - lo) * frac
    return float(bounds[-1]) if bounds else 0.0

"""Black-box decision journal: a process-wide causal event log plus
per-pod decision provenance.

The engine's control machinery (the supervisor's degradation ladder,
the residency protocol, the shortlist cross-check) detects every state
transition it takes but only counts them: after an incident the metrics
say ``supervisor_escalations=2`` and nothing says which batch rode
which path or what caused what. This module is the recorder: a
lock-light, bounded, process-wide **journal** receiving one typed,
monotonic-seq event at every transition the engine already detects,
each carrying causal tags (batch id, step counter, gate name,
prior->next state, serving profile), so the causal chain from a
``fault.<gate>`` fire through the ladder moves to recovery can be read
back after the fact.

Arming (the faults.py / obs discipline: process-wide env config;
unset = one attribute test at every hook, decisions unchanged):

    MINISCHED_JOURNAL=1        enable the in-memory ring
    MINISCHED_JOURNAL=<path>   ring + append-only JSONL sink at <path>
                               (one JSON object per line)
    MINISCHED_JOURNAL_CAP=N    ring capacity in events (default 4096;
                               wraps keeping the newest, the dropped
                               count is reported)

Event record (flat JSON-able dict; ``kind`` names the transition):

    seq      monotonic per-process sequence number (the ``GET
             /journal?since=<seq>`` cursor; the ``journal:corrupt``
             fault gate scribbles this FIELD while the internal
             ordering key stays exact — a corrupted recorder must be
             observable, never able to reorder history)
    t / unix monotonic seconds since arming / wall clock
    kind     e.g. ``supervisor.escalate``, ``overload.recover``,
             ``index.fallback``, ``loop.break``, ``fault.step``,
             ``slo.burn``, ``queue.shed``, ``invariant.violation``
    thread   recording thread's name
    ...      per-kind causal tags (profile, batch, step, from/to rung,
             reason, gate, slot, pods, ...)

Fault gate: ``journal`` (faults.GATES) sits on the event write —
``err`` drops the event (counted ``dropped_by_fault``; the engine's
decisions must be bit-identical under an err'd journal, pinned by
test), ``corrupt`` scribbles the recorded seq field. The gate is
skipped for the ``fault.journal`` event itself (the registry emits a
journal event per fire; gating that one would recurse).

Per-pod provenance: :class:`ProvenanceStore` is the bounded LRU beside
the explain resultstore — each bound/failed pod's compact record of the
path that served it (engine mode, loop slot or per-batch, index
hit/fallback, shortlist certified/repaired, residency posture,
attempts, shed stamps, overload/degradation level at decision time),
recorded by the engine only while the journal is armed and served via
``GET /provenance/<pod>``.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional

from . import ring_tail

__all__ = ["JOURNAL", "Journal", "ProvenanceStore", "configure", "note"]

#: Scalar types that pass into an event record unchanged; anything else
#: is stringified (events must stay JSON-able end to end).
_SCALARS = (int, float, str, bool, type(None))


class Journal:
    """The process-wide journal (one instance, :data:`JOURNAL`). A
    single small lock guards the ring + seq — events fire at state
    TRANSITIONS (ladder moves, desyncs, breaks), never in per-pod or
    per-row loops, so the armed cost is one lock hold per transition
    and the unarmed cost is the single ``enabled`` attribute test."""

    def __init__(self, spec: str = "", cap: int = 4096):
        self._lock = threading.Lock()
        self.configure(spec, cap)

    def configure(self, spec: str = "", cap: int = 4096) -> None:
        """Re-arm (tests / embedders): ``""``/``"0"`` disarms, ``"1"``
        arms the ring, anything else arms ring + JSONL sink at that
        path. Clears the ring and restarts the seq counter — a
        reconfigure is a fresh run."""
        with self._lock:
            old_sink = getattr(self, "_sink", None)
            if old_sink is not None:
                try:
                    old_sink.close()
                except OSError:
                    pass
            spec = (spec or "").strip()
            self.spec = spec
            self.sink_path = (spec if spec not in ("", "0", "1")
                              else None)
            self.cap = max(16, int(cap))
            self._ring: List[tuple] = []   # (true_seq, event dict)
            self._n = 0                    # events ever recorded
            self._seq = 0
            self._t0 = time.monotonic()
            self.dropped_by_fault = 0
            self.sink_errors = 0
            self._sink = None
            if self.sink_path:
                try:
                    self._sink = open(self.sink_path, "a",
                                      encoding="utf-8")
                except OSError:
                    import logging

                    logging.getLogger(__name__).error(
                        "cannot open MINISCHED_JOURNAL sink %r; "
                        "keeping the in-memory ring only",
                        self.sink_path, exc_info=True)
                    self._sink = None
                    self.sink_errors += 1
            # written LAST: a racing note() sees enabled only after the
            # ring/sink state above is consistent
            self.enabled = bool(spec) and spec != "0"

    # ---- recording -------------------------------------------------------

    def note(self, kind: str, **tags) -> None:
        """Record one transition event. Unarmed: one attribute test.
        The ``journal`` fault gate is consulted BEFORE the lock (its
        ``err`` raise / ``stall`` sleep must never hold the ring lock,
        and a fired gate's own ``fault.journal`` event re-enters here)."""
        if not self.enabled:
            return
        act = None
        if kind != "fault.journal":
            from ..faults import FAULTS, FaultInjected

            try:
                act = FAULTS.hit("journal")
            except FaultInjected:
                # err = drop this event write. The journal is an
                # observer — a faulted recorder loses history, never a
                # decision (tests pin bit-identity under an err'd
                # journal).
                with self._lock:
                    self.dropped_by_fault += 1
                return
        ev: Dict[str, object] = {"kind": kind,
                                 "thread": threading.current_thread().name}
        for k, v in tags.items():
            ev[k] = v if isinstance(v, _SCALARS) else str(v)
        with self._lock:
            self._seq += 1
            seq = self._seq
            # corrupt = scribble the RECORDED seq field: downstream
            # consumers (postmortem monotonicity check, /journal
            # cursors) must be able to SEE a corrupted recorder; the
            # internal ordering key stays exact so the ring itself can
            # never reorder history.
            ev["seq"] = (seq ^ 0x40000000) if act == "corrupt" else seq
            ev["t"] = round(time.monotonic() - self._t0, 6)
            ev["unix"] = round(time.time(), 3)
            if self._n < self.cap:
                self._ring.append((seq, ev))
            else:
                self._ring[self._n % self.cap] = (seq, ev)
            self._n += 1
            if self._sink is not None:
                try:
                    self._sink.write(
                        json.dumps(ev, separators=(",", ":")) + "\n")
                    self._sink.flush()
                except OSError:
                    self.sink_errors += 1

    # ---- readback --------------------------------------------------------

    def entries(self, since: int = 0) -> List[dict]:
        """Events with (true) seq > ``since``, oldest retained first —
        the ``GET /journal?since=`` cursor contract: a client polling
        with the last doc's ``next_seq`` re-downloads nothing."""
        with self._lock:
            ring = ring_tail(self._ring, self._n, self.cap)
        return [dict(ev) for seq, ev in ring if seq > since]

    def next_seq(self) -> int:
        with self._lock:
            return self._seq

    def dropped(self) -> int:
        """Events the ring overwrote (recorded − retained)."""
        with self._lock:
            return max(0, self._n - len(self._ring))

    def to_doc(self, since: int = 0) -> dict:
        """The ``GET /journal`` JSON payload. Empty-but-valid when
        unarmed. Ring, seq counter, and drop count are read under ONE
        lock hold: sampling them separately would let an event recorded
        between the reads land above the advertised ``next_seq`` and be
        re-delivered on the client's next poll (or, the other way, be
        skipped forever) — the cursor must cover exactly the returned
        entries."""
        with self._lock:
            ring = ring_tail(self._ring, self._n, self.cap)
            next_seq = self._seq
            dropped = max(0, self._n - len(self._ring))
            doc = {"enabled": self.enabled,
                   "cap": self.cap,
                   "next_seq": next_seq,
                   "dropped": dropped,
                   "dropped_by_fault": self.dropped_by_fault,
                   "sink_errors": self.sink_errors,
                   "entries": [dict(ev) for seq, ev in ring
                               if seq > since]}
        if self.sink_path:
            doc["sink_path"] = self.sink_path
        return doc


def _from_env() -> Journal:
    spec = os.environ.get("MINISCHED_JOURNAL", "")
    try:
        cap = int(os.environ.get("MINISCHED_JOURNAL_CAP", "4096") or 4096)
    except ValueError:
        import logging

        logging.getLogger(__name__).error(
            "ignoring malformed MINISCHED_JOURNAL_CAP", exc_info=True)
        cap = 4096
    return Journal(spec, cap)


#: The process-wide journal every transition hook imports.
JOURNAL = _from_env()


def configure(spec: str = "", cap: int = 4096) -> Journal:
    """Re-arm the process-wide journal (tests / embedders);
    ``configure("")`` disarms and clears the ring."""
    JOURNAL.configure(spec, cap)
    return JOURNAL


def note(kind: str, **tags) -> None:
    """Module-level convenience for hook sites. Unarmed: one attribute
    test."""
    JOURNAL.note(kind, **tags)


# ---------------------------------------------------------------------------
# Per-pod decision provenance
# ---------------------------------------------------------------------------


class ProvenanceStore:
    """Bounded LRU of per-pod decision-provenance records — the
    resultstore's retention discipline (newest ``cap`` pods, evictions
    counted) applied to the compact path-that-served-it record instead
    of the full explain matrices. The engine records only while the
    journal is armed (the MINISCHED_JOURNAL attribute test), so the
    unarmed hot path pays nothing; reads come from ``GET
    /provenance/<pod>`` and tests."""

    def __init__(self, cap: int = 4096):
        self._lock = threading.Lock()
        self._cap = max(16, int(cap))
        self._recs: "OrderedDict[str, dict]" = OrderedDict()
        self.evictions = 0

    def record(self, key: str, rec: dict) -> None:
        with self._lock:
            if key in self._recs:
                self._recs.pop(key)
            self._recs[key] = rec
            while len(self._recs) > self._cap:
                self._recs.popitem(last=False)
                self.evictions += 1

    def get(self, key: str) -> Optional[dict]:
        with self._lock:
            rec = self._recs.get(key)
            return dict(rec) if rec is not None else None

    def keys(self) -> List[str]:
        with self._lock:
            return list(self._recs)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"records": len(self._recs), "cap": self._cap,
                    "evictions": self.evictions}

"""Temporal telemetry: a rolling time-series ring over the engine's
metrics surface.

The flight recorder (obs/__init__.py) answers "what happened inside
this span"; the
per-batch series in ``Scheduler.metrics()["batch_series"]`` answer
"what did the last 64 batches cost". Neither answers "is the engine
getting WORSE" — a p99 creeping up through a reclamation wave, a desync
counter that starts moving an hour in, a degradation rung the engine
keeps revisiting. This module is that temporal layer: a lock-light,
fixed-capacity ring of periodic snapshots of ``Scheduler.metrics()``
counters/gauges plus histogram-DELTA quantiles (the p99 of the pods
bound *since the last snapshot*, not the run-cumulative figure that
stops moving after enough history), taken on the scheduling thread at a
batch-count or wall-clock cadence.

Arming (the faults.py / obs tracer discipline — process-wide env
config; unset = one attribute test on the hot path and decisions
bit-identical, pinned by tests/test_torch_timeline.py):

    MINISCHED_TIMELINE=1         enable snapshots (tests/embedders use
                                 :func:`configure`)
    MINISCHED_TIMELINE_EVERY=N   snapshot cadence: ``8`` = every 8
                                 resolved batches (default), ``2s`` /
                                 ``500ms`` = wall-clock cadence
    MINISCHED_TIMELINE_CAP=N     ring capacity in snapshots (default
                                 512; wraps keeping the newest, the
                                 dropped count is reported)

Each entry is a flat JSON-able dict:

    t / unix                monotonic seconds since arming / wall clock
    batches, pods_bound, pods_failed, degradation_level,
    queue_active/backoff/unschedulable, shortlist_width
                            gauges straight from metrics()
    d_*                     counter DELTAS since the previous snapshot
                            (pods_bound, pods_failed, batch_faults,
                            desyncs = residency+shortlist, fault_fires,
                            quarantined, escalations, bind_conflicts)
    create_bound_p50_s / create_bound_p99_s / queue_wait_p95_s
                            quantiles over the histogram-count DELTA of
                            the window (absent when the window bound
                            nothing — an idle window has no latency)
    tags                    per-source attribution deltas from
                            :func:`note_activity` — the lifecycle
                            engine tags every event with its generator
                            name, so a reclamation wave is *visible* in
                            the timeline row where p99 moved (the
                            per-profile attribution dimension the
                            multi-tenant work will reuse)

The ring is consumed by the SLO sentinel (obs/slo.py), the overload
controller (engine/overload.py), ``Scheduler.timeline()`` and the
incident bundles (obs/bundle.py).
"""
from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional

from . import hist_quantile, ring_tail

__all__ = ["TIMELINE", "TimelineConfig", "TimelineTracker", "configure",
           "note_activity", "parse_every"]

#: Counters whose per-window deltas every snapshot carries.
DELTA_KEYS = ("pods_bound", "pods_failed", "batch_faults",
              "quarantined_batches", "supervisor_escalations",
              "bind_conflicts", "watchdog_trips",
              "supervisor_early_warnings", "shortlist_repairs",
              "queue_shed_total")

#: Gauges copied verbatim into every snapshot.
GAUGE_KEYS = ("batches", "pods_bound", "pods_failed", "degradation_level",
              "queue_active", "queue_backoff", "queue_unschedulable",
              "shortlist_width", "waiting_pods", "overload_level",
              "queue_shed")


def parse_every(tok: str):
    """``"8"`` → (8 batches, None); ``"2s"``/``"500ms"`` → (None,
    seconds). Raises ValueError on junk — a silently-ignored cadence
    would defeat the knob (the faults.py parse discipline)."""
    tok = (tok or "").strip()
    for suffix, scale in (("ms", 1e-3), ("s", 1.0)):
        if tok.endswith(suffix):
            try:
                dur = float(tok[:-len(suffix)]) * scale
            except ValueError:
                # "bogus".endswith("s") routes junk here — keep the
                # curated message, not float()'s
                raise ValueError(f"bad timeline cadence {tok!r}")
            if dur <= 0.0:
                # "0s" would silently snapshot EVERY batch — the
                # worst-case cadence — instead of what the operator
                # typed; non-positive is a misconfiguration, said loudly.
                raise ValueError(f"bad timeline cadence {tok!r} "
                                 "(duration must be > 0)")
            return None, dur
    n = int(tok)
    if n < 1:
        raise ValueError(f"bad timeline cadence {tok!r}")
    return n, None


class TimelineConfig:
    """Process-wide arming state (one instance, :data:`TIMELINE`).
    ``enabled`` is the single attribute the hot path tests; everything
    else is read only at snapshot time. Reconfiguring bumps ``epoch`` so
    per-engine trackers reset instead of splicing two configurations'
    windows, and clears the attribution counters."""

    def __init__(self, enabled: bool = False, every: str = "8",
                 capacity: int = 512):
        self._lock = threading.Lock()
        self.epoch = 0
        self.configure(enabled, every, capacity)

    def configure(self, enabled: bool, every: str = "8",
                  capacity: int = 512) -> None:
        every_batches, every_s = parse_every(every)
        with self._lock:
            self.epoch += 1
            self.every_batches = every_batches
            self.every_s = every_s
            self.capacity = max(4, int(capacity))
            self._activity: Dict[str, int] = {}
            # written last — a racing tick sees enabled only after the
            # cadence/capacity above are consistent
            self.enabled = bool(enabled)

    # ---- attribution tags ------------------------------------------------

    def note_activity(self, tag: str, n: int = 1) -> None:
        """Cumulative per-source activity counter (lifecycle generators
        tag their events; invariant violations tag themselves).
        Snapshots carry the per-window DELTA. Disarmed: one attribute
        test."""
        if not self.enabled:
            return
        with self._lock:
            self._activity[tag] = self._activity.get(tag, 0) + n

    def activity(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._activity)


def _from_env() -> TimelineConfig:
    try:
        return TimelineConfig(
            enabled=os.environ.get("MINISCHED_TIMELINE", "") == "1",
            every=os.environ.get("MINISCHED_TIMELINE_EVERY", "8") or "8",
            capacity=int(os.environ.get("MINISCHED_TIMELINE_CAP", "512")
                         or 512))
    except ValueError:
        # A typo in a telemetry knob must fail LOUDLY but not
        # unimportably — the engine imports this module
        # unconditionally, and a disarmed-timeline process dying on a
        # malformed cadence string would take the scheduler down with
        # it (the faults.py malformed-env discipline).
        import logging

        logging.getLogger(__name__).error(
            "ignoring malformed MINISCHED_TIMELINE_EVERY/_CAP",
            exc_info=True)
        return TimelineConfig(
            enabled=os.environ.get("MINISCHED_TIMELINE", "") == "1")


#: The process-wide config every tracker and tag site reads.
TIMELINE = _from_env()


def configure(enabled: bool, every: str = "8",
              capacity: int = 512) -> TimelineConfig:
    """Re-arm the process-wide timeline (tests / embedders);
    ``configure(False)`` disarms and clears attribution counters."""
    TIMELINE.configure(enabled, every, capacity)
    return TIMELINE


def note_activity(tag: str, n: int = 1) -> None:
    """Module-level convenience for tag sites (the lifecycle engine)."""
    TIMELINE.note_activity(tag, n)


#: Histogram names whose window-delta quantiles each snapshot derives.
_HIST_QUANTILES = (
    ("pod_create_to_bound_s", (("create_bound_p50_s", 0.50),
                               ("create_bound_p99_s", 0.99))),
    ("pod_queue_wait_s", (("queue_wait_p95_s", 0.95),)),
)


class TimelineTracker:
    """One engine's snapshot ring. Owned by the Scheduler; ``tick()``
    runs on the scheduling thread only (the one thread that resolves
    batches), so the previous-state fields need no lock — the ring list
    is guarded for the reader side (``entries()`` from metrics or
    bundle threads)."""

    def __init__(self, metrics_fn, name: str = "engine"):
        self._metrics_fn = metrics_fn
        self.name = name
        self._lock = threading.Lock()  # ring/alerts reader guard
        self._epoch = -1               # forces reset on first armed tick
        # Cadence multiplier (overload brownout: quality shed —
        # telemetry coarsens while level 3 holds). Scheduling-thread
        # written, read only in tick(); survives config-epoch resets
        # (the controller, not the config, owns it).
        self.stretch = 1
        self._reset()

    def _reset(self) -> None:
        cfg = TIMELINE
        self._epoch = cfg.epoch
        self._cap = cfg.capacity
        self._ring: List[dict] = []
        self._n = 0
        self._alerts: List[dict] = []
        self._t0 = time.monotonic()
        self._last_t = self._t0
        self._batches_since = 0
        self._prev: Dict[str, float] = {}
        self._prev_hists: Dict[str, list] = {}
        self._prev_tags: Dict[str, int] = {}
        self._primed = False

    # ---- scheduling-thread side -----------------------------------------

    def tick(self) -> Optional[dict]:
        """One resolved batch. Returns the new snapshot entry when the
        cadence elapsed, else None. Caller gates on TIMELINE.enabled —
        the disarmed cost is that one attribute test."""
        cfg = TIMELINE
        if cfg.epoch != self._epoch:
            self._reset()
        self._batches_since += 1
        now = time.monotonic()
        if not self._primed:
            # First armed batch: prime the delta baselines so the first
            # real snapshot's deltas cover its own window, not the whole
            # pre-arming history.
            self._prime(self._metrics_fn())
            self._last_t = now
            self._batches_since = 0
            return None
        stretch = max(1, int(self.stretch))
        if cfg.every_batches is not None:
            if self._batches_since < cfg.every_batches * stretch:
                return None
        elif now - self._last_t < (cfg.every_s or 0.0) * stretch:
            return None
        return self.snapshot_now()

    def _prime(self, m: dict) -> None:
        self._prev = {k: float(m.get(k, 0) or 0) for k in DELTA_KEYS}
        self._prev["desyncs"] = (float(m.get("residency_desyncs", 0))
                                 + float(m.get("shortlist_desyncs", 0)))
        self._prev["fault_fires"] = float(sum(
            v for k, v in m.items() if k.startswith("fault_fires_")))
        hists = m.get("histograms") or {}
        self._prev_hists = {name: list(snap.get("counts") or [])
                            for name, snap in hists.items()}
        self._prev_tags = TIMELINE.activity()
        self._primed = True

    def snapshot_now(self) -> dict:
        """Build one snapshot entry from the live metrics surface and
        append it to the ring (scheduling thread; tests may call it
        directly to force a row)."""
        m = self._metrics_fn()
        now = time.monotonic()
        entry: dict = {"t": round(now - self._t0, 6),
                       "unix": round(time.time(), 3),
                       # Monotonic per-tracker row number — the ``GET
                       # /timeline?since=<seq>`` cursor (scrapers stop
                       # re-downloading the full ring every poll) and
                       # the per-profile attribution key: every row
                       # names the profile whose engine produced it
                       # (the multi-tenant per-tenant dimension).
                       "seq": self.snapshots() + 1,
                       "profile": self.name}
        for k in GAUGE_KEYS:
            v = m.get(k)
            if isinstance(v, (int, float)):
                entry[k] = v
        # counter deltas since the previous snapshot
        cur = {k: float(m.get(k, 0) or 0) for k in DELTA_KEYS}
        cur["desyncs"] = (float(m.get("residency_desyncs", 0))
                          + float(m.get("shortlist_desyncs", 0)))
        cur["fault_fires"] = float(sum(
            v for k, v in m.items() if k.startswith("fault_fires_")))
        for k, v in cur.items():
            entry[f"d_{k}"] = round(v - self._prev.get(k, 0.0), 6)
        self._prev = cur
        # histogram-delta quantiles: the latency OF THIS WINDOW
        hists = m.get("histograms") or {}
        for name, wants in _HIST_QUANTILES:
            snap = hists.get(name)
            if not snap:
                continue
            counts = list(snap.get("counts") or [])
            prev = self._prev_hists.get(name) or [0] * len(counts)
            delta = [max(0, c - p) for c, p in zip(counts, prev)]
            self._prev_hists[name] = counts
            n = sum(delta)
            entry.setdefault("window_bound" if name ==
                             "pod_create_to_bound_s" else
                             "window_queue_obs", n)
            if n <= 0:
                continue
            dsnap = {"bounds": snap["bounds"], "counts": delta, "count": n,
                     "sum": 0.0}
            for key, q in wants:
                entry[key] = round(hist_quantile(dsnap, q), 6)
        # attribution tags: per-source activity deltas (nonzero only)
        tags_now = TIMELINE.activity()
        tags = {k: v - self._prev_tags.get(k, 0)
                for k, v in tags_now.items()
                if v - self._prev_tags.get(k, 0)}
        self._prev_tags = tags_now
        if tags:
            entry["tags"] = tags
        with self._lock:
            if self._n < self._cap:
                self._ring.append(entry)
            else:
                self._ring[self._n % self._cap] = entry
            self._n += 1
        self._last_t = now
        self._batches_since = 0
        return entry

    def note_alert(self, alert: dict) -> None:
        """SLO sentinel verdicts ride the same surface (/timeline shows
        alerts beside the rows that tripped them); bounded like the
        ring."""
        with self._lock:
            self._alerts.append(alert)
            if len(self._alerts) > 256:
                del self._alerts[0]

    # ---- reader side -----------------------------------------------------

    def entries(self) -> List[dict]:
        """Time-ordered snapshot copies (oldest retained first)."""
        with self._lock:
            return ring_tail(self._ring, self._n, self._cap)

    def alerts(self) -> List[dict]:
        with self._lock:
            return list(self._alerts)

    def dropped(self) -> int:
        with self._lock:
            return max(0, self._n - len(self._ring))

    def snapshots(self) -> int:
        with self._lock:
            return self._n

    def now_t(self) -> float:
        """Current time on the entries' ``t`` axis — lets a reader
        re-evaluate window membership against a ring that stopped
        growing (idle engine)."""
        return time.monotonic() - self._t0

    def to_doc(self, since: int = 0) -> dict:
        """The ``GET /timeline`` JSON payload for this engine.
        ``since`` is the cursor contract shared with ``/journal``: only
        rows with ``seq > since`` are returned, and ``next_seq`` is
        what the client hands back next poll — rows the ring already
        dropped are simply gone (the client's cursor stays valid; the
        ``dropped`` count says how much history it missed)."""
        cfg = TIMELINE
        # Ring and counters under ONE lock hold: a tick landing between
        # an entries() snapshot and a separate counter read would
        # advance next_seq past a row the client never received — the
        # cursor must cover exactly the returned rows.
        with self._lock:
            entries = ring_tail(self._ring, self._n, self._cap)
            snapshots = self._n
            dropped = max(0, self._n - len(self._ring))
            alerts = list(self._alerts)
        if since:
            entries = [e for e in entries if e.get("seq", 0) > since]
        return {"enabled": cfg.enabled,
                "every_batches": cfg.every_batches,
                "every_s": cfg.every_s,
                "capacity": cfg.capacity,
                "snapshots": snapshots,
                "next_seq": snapshots,
                "dropped": dropped,
                "entries": entries,
                "alerts": alerts}

"""SLO burn-rate sentinel over the timeline ring — observability that
actuates.

Declarative SLO specs evaluated with the multi-window burn-rate method
(the SRE alerting shape: a breach must burn through BOTH a short window
— "it is happening now" — and a long window — "it is not a blip" —
before it alerts; a single bad snapshot never pages). The sentinel runs
at timeline-snapshot cadence on the scheduling thread, so it costs
nothing while the timeline is disarmed and a bounded ring scan when
armed.

The default objective catalog (thresholds overridable via the env
spec):

    create_bound_p99     window p99 of pod create→bound exceeds the
                         threshold seconds (default 1.0)
    queue_wait_p95       window p95 queue wait exceeds the threshold
                         seconds (default 2.0)
    desync_rate          any residency/shortlist desync in the window
                         (threshold 0 — the carry protocols make
                         desyncs structurally impossible, so ONE is an
                         incident)
    batch_fault_rate     any detected batch fault in the window
                         (threshold 0)
    invariant_violations any lifecycle-invariant violation tagged into
                         the timeline (threshold 0)
    degraded_fraction    the engine spent the window off the full fast
                         path (degradation_level > 0)

Arming (process-wide env, the faults.py discipline; also implies the
timeline must be armed — the sentinel reads the ring):

    MINISCHED_SLO=1                          default catalog
    MINISCHED_SLO="create_bound_p99=0.25,short=2,long=8,burn=0.5"
                                             per-objective threshold
                                             overrides plus the global
                                             window knobs (seconds)

Alerts are RISING-EDGE: one alert per transition into burning (the
gauge ``slo_burning_<name>`` stays up while it burns, and a
``slo.clear`` instant marks recovery). Every alert is (1) counted in
``Scheduler.metrics()`` (``slo_alerts_total`` + per-objective), (2)
emitted as a ``slo.burn`` trace instant on the flight recorder's
timeline, (3) appended to the /timeline alerts list, and (4) fed to the
engine supervisor as an EARLY-WARNING input: a burning SLO resets the
probation counter (a degraded engine cannot climb back to the fast
path while its SLO burns) and pre-arms the per-batch watchdog for the
next batches even when ``MINISCHED_WATCHDOG`` is unset — the sentinel
turns a latency trend into a containment posture before the ladder has
to find out the hard way.
"""
from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional

__all__ = ["SLOSpec", "SLOSentinel", "SLOConfig", "SLO", "configure",
           "default_specs", "parse_spec"]

#: Objective catalog: name → (kind, default threshold). Kinds:
#:   window_quantile  entry[key] > threshold (entries without the key —
#:                    idle windows — don't vote)
#:   delta            entry[f"d_{key}"] > threshold
#:   tag              entry["tags"][key] > threshold
#:   degraded         entry["degradation_level"] > threshold
_CATALOG = {
    "create_bound_p99": ("window_quantile", "create_bound_p99_s", 1.0),
    "queue_wait_p95": ("window_quantile", "queue_wait_p95_s", 2.0),
    "desync_rate": ("delta", "desyncs", 0.0),
    "batch_fault_rate": ("delta", "batch_faults", 0.0),
    "invariant_violations": ("tag", "invariant_violation", 0.0),
    "degraded_fraction": ("degraded", "degradation_level", 0.0),
}


@dataclass(frozen=True)
class SLOSpec:
    """One declarative objective: how to read a timeline entry and when
    a window burns."""

    name: str
    kind: str          # window_quantile | delta | tag | degraded
    key: str           # entry key / delta name / tag name
    threshold: float

    @property
    def incident(self) -> bool:
        """Incident-class objectives (counter deltas / tags): ONE
        breaching row burns the whole window — a desync or invariant
        violation is an incident regardless of how many clean rows
        surround it, so the burn fraction must not dilute it."""
        return self.kind in ("delta", "tag")

    def value(self, entry: dict) -> Optional[float]:
        """The entry's vote input; None = this entry doesn't vote (an
        idle window has no latency sample)."""
        if self.kind == "window_quantile":
            v = entry.get(self.key)
            return float(v) if isinstance(v, (int, float)) else None
        if self.kind == "delta":
            return float(entry.get(f"d_{self.key}", 0.0) or 0.0)
        if self.kind == "tag":
            return float((entry.get("tags") or {}).get(self.key, 0))
        if self.kind == "degraded":
            return float(entry.get(self.key, 0) or 0)
        raise ValueError(f"unknown SLO kind {self.kind!r}")

    def breaches(self, entry: dict) -> Optional[bool]:
        v = self.value(entry)
        return None if v is None else v > self.threshold


def default_specs(overrides: Optional[Dict[str, float]] = None
                  ) -> List[SLOSpec]:
    out = []
    for name, (kind, key, thresh) in _CATALOG.items():
        if overrides and name in overrides:
            thresh = overrides[name]
        out.append(SLOSpec(name, kind, key, float(thresh)))
    return out


def parse_spec(spec: str):
    """``MINISCHED_SLO`` grammar → (specs, short_s, long_s, burn).
    ``"1"`` = defaults; otherwise comma-separated ``name=value`` pairs
    where ``short``/``long``/``burn`` set the windows and any catalog
    name overrides its threshold. Raises ValueError on junk (the
    faults.py loud-misconfiguration discipline)."""
    short_s, long_s, burn = 5.0, 30.0, 0.5
    overrides: Dict[str, float] = {}
    spec = (spec or "").strip()
    if spec and spec != "1":
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            try:
                name, val = part.split("=", 1)
                name, fval = name.strip(), float(val)
            except ValueError:
                raise ValueError(f"bad SLO term {part!r} "
                                 "(want name=value)")
            if name in ("short", "long"):
                # a non-positive window silently neuters the sentinel
                # (nothing ever votes) — misconfiguration, said loudly
                if fval <= 0.0:
                    raise ValueError(
                        f"{name}={fval} must be > 0 seconds")
                if name == "short":
                    short_s = fval
                else:
                    long_s = fval
            elif name == "burn":
                if not 0.0 < fval <= 1.0:
                    raise ValueError(f"burn={fval} outside (0, 1]")
                burn = fval
            elif name in _CATALOG:
                overrides[name] = fval
            else:
                raise ValueError(
                    f"unknown SLO objective {name!r} "
                    f"(known: {', '.join(sorted(_CATALOG))})")
    return default_specs(overrides), short_s, long_s, burn


class SLOConfig:
    """Process-wide arming state (one instance, :data:`SLO`) — the
    engine builds its sentinel from the epoch-current configuration, so
    tests re-arm between runs without rebuilding schedulers."""

    def __init__(self, spec: str = ""):
        self._lock = threading.Lock()
        self.epoch = 0
        # Did THIS config arm the timeline as the documented
        # implication? Then disarming the sentinel disarms it again —
        # an embedder toggling just the SLO knob must not leave the
        # per-batch snapshot path running forever. An explicitly-armed
        # timeline (env or timeseries.configure) is left alone.
        self._armed_timeline = False
        self.configure(spec)

    def configure(self, spec: str) -> None:
        specs, short_s, long_s, burn = (parse_spec(spec) if spec
                                        else ([], 5.0, 30.0, 0.5))
        with self._lock:
            self.epoch += 1
            self.specs = specs
            self.short_s = short_s
            self.long_s = long_s
            self.burn = burn
            self.spec = spec or ""
            self.enabled = bool(specs)
        from .timeseries import TIMELINE

        if self.enabled:
            # The sentinel reads the timeline ring — arming the SLO
            # without the timeline would silently never evaluate
            # (Scheduler gates the tick on TIMELINE.enabled). Arming
            # the sentinel therefore implies the timeline, on BOTH the
            # env path and this programmatic one; explicit timeline
            # knobs/configure calls still win when already armed. A
            # malformed timeline env knob must not poison the SLO
            # arming (nor get blamed on MINISCHED_SLO): fall back to
            # the default cadence, like timeseries' own env path.
            if not TIMELINE.enabled:
                try:
                    TIMELINE.configure(
                        True,
                        os.environ.get("MINISCHED_TIMELINE_EVERY", "8")
                        or "8",
                        int(os.environ.get("MINISCHED_TIMELINE_CAP",
                                           "512") or 512))
                except ValueError:
                    import logging

                    logging.getLogger(__name__).error(
                        "malformed MINISCHED_TIMELINE_EVERY/_CAP while "
                        "arming the SLO sentinel; using the default "
                        "timeline cadence", exc_info=True)
                    TIMELINE.configure(True)
                self._armed_timeline = True
        else:
            # Symmetric disarm: only the timeline THIS config armed,
            # and never one the env pins on.
            if (self._armed_timeline and TIMELINE.enabled
                    and os.environ.get("MINISCHED_TIMELINE", "") != "1"):
                TIMELINE.configure(False)
            self._armed_timeline = False


def _from_env() -> SLOConfig:
    spec = os.environ.get("MINISCHED_SLO", "")
    try:
        return SLOConfig(spec)
    except ValueError:
        import logging

        logging.getLogger(__name__).error(
            "ignoring malformed MINISCHED_SLO=%r", spec, exc_info=True)
        return SLOConfig("")


#: The process-wide SLO configuration.
SLO = _from_env()


def configure(spec: str) -> SLOConfig:
    """Re-arm the process-wide SLO config (tests / embedders);
    ``configure("")`` disarms."""
    SLO.configure(spec)
    return SLO


class SLOSentinel:
    """Evaluates the spec list over a timeline ring. Single-threaded by
    contract (the scheduling thread, at snapshot cadence); ``burning``
    is read cross-thread by metrics() — plain dict reads of immutable
    values, worst case one stale gauge."""

    def __init__(self, specs: List[SLOSpec], short_s: float,
                 long_s: float, burn: float):
        self.specs = specs
        self.short_s = float(short_s)
        self.long_s = float(long_s)
        self.burn = float(burn)
        self.burning: Dict[str, bool] = {s.name: False for s in specs}
        # Objectives whose burning flag the LAST evaluate() cleared —
        # the engine emits their ``slo.clear`` instants (the recovery
        # marker the module docstring promises).
        self.last_cleared: List[str] = []

    def _window_burn(self, entries: List[dict], now_t: float,
                     spec: SLOSpec, window_s: float):
        """(burn fraction, voting entries) over entries within the
        window. Entries that can't vote (idle latency windows) are
        excluded from the denominator. Incident-class specs saturate:
        one breaching row = the window burns at 1.0 (fraction math
        would dilute a single desync across every clean row and a
        threshold-0 'one is an incident' objective could never page).

        Newest-first with an early break: the ring is time-ordered and
        a window typically covers a handful of its rows — scanning all
        of a full 512-entry ring for every spec at every cadence point
        would cost thousands of breach evaluations per batch on the
        scheduling thread."""
        votes = bad = 0
        for e in reversed(entries):
            if now_t - e["t"] > window_s:
                break
            b = spec.breaches(e)
            if b is None:
                continue
            votes += 1
            if b:
                bad += 1
        if spec.incident:
            return (1.0 if bad else 0.0), votes
        return (bad / votes if votes else 0.0), votes

    def evaluate(self, entries: List[dict]) -> List[dict]:
        """One pass after a new snapshot. Returns the RISING-EDGE alerts
        (one dict per objective that just started burning); clears the
        burning gauge on recovery."""
        if not entries:
            return []
        now_t = entries[-1]["t"]
        alerts: List[dict] = []
        self.last_cleared = []
        for spec in self.specs:
            short, n_short = self._window_burn(entries, now_t, spec,
                                               self.short_s)
            long_, n_long = self._window_burn(entries, now_t, spec,
                                              self.long_s)
            # Both windows must burn, and the long window needs ≥2
            # voting points — one snapshot alone is a blip by
            # definition, not a trend.
            is_burning = (n_short >= 1 and n_long >= 2
                          and short >= self.burn and long_ >= self.burn)
            was = self.burning[spec.name]
            self.burning[spec.name] = is_burning
            if was and not is_burning:
                self.last_cleared.append(spec.name)
            if is_burning and not was:
                alerts.append({
                    "slo": spec.name, "t": now_t,
                    "threshold": spec.threshold,
                    "short_burn": round(short, 4),
                    "long_burn": round(long_, 4),
                    "short_window_s": self.short_s,
                    "long_window_s": self.long_s,
                    "value": spec.value(entries[-1]),
                    "degradation_level":
                        entries[-1].get("degradation_level", 0),
                })
        return alerts

    def burning_now(self, entries: List[dict],
                    now_t: float) -> Dict[str, bool]:
        """Read-only gauge view at ``now_t``: a flag evaluate() set
        stays exported only while its burn windows STILL hold with the
        clock advanced — an idle engine resolves no batches, so
        evaluate() alone would latch a stale 1 forever once the queue
        drains. Never mutates sentinel state (metrics() calls this
        from arbitrary threads)."""
        out: Dict[str, bool] = {}
        for spec in self.specs:
            if not self.burning.get(spec.name):
                out[spec.name] = False
                continue
            short, n_short = self._window_burn(entries, now_t, spec,
                                               self.short_s)
            long_, n_long = self._window_burn(entries, now_t, spec,
                                              self.long_s)
            out[spec.name] = (n_short >= 1 and n_long >= 2
                              and short >= self.burn
                              and long_ >= self.burn)
        return out

    @classmethod
    def from_config(cls, cfg: SLOConfig) -> "SLOSentinel":
        return cls(cfg.specs, cfg.short_s, cfg.long_s, cfg.burn)

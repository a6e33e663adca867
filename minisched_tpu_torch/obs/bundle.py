"""Auto-captured incident bundles — the black-box recorder's crash dump.

When the engine crosses one of its terminal containment transitions —
quarantine (the fault ladder's bottom rung), a permanent index or
shortlist certification revert, brownout entry (the overload ladder's
deepest rung), or a lifecycle invariant violation — the state that
explains it is spread across four live surfaces (journal ring, timeline
ring, trace rings, metrics dict) that keep moving after the incident.
This module freezes all of them into one atomically-renamed bundle
directory the moment the transition fires, rate-limited to ONE bundle
per incident class per run (the first occurrence is the diagnostic one;
a storm must not fill the disk), so ``tools/postmortem.py <bundle>``
can validate the schema and print the causal narrative offline.

Arming (the faults.py / obs discipline):

    MINISCHED_BUNDLE_DIR=<dir>   capture bundles under <dir>; unset =
                                 every trigger is one attribute test

Bundle contract (the schema ``tools/postmortem.py`` validates):

    manifest.json   {"schema": 1, "incident_class", "reason", "unix",
                     "pid", "journal_next_seq", "files": [...]} —
                    written LAST inside the temp dir, so a bundle with
                    a manifest is complete by construction
    journal.jsonl   the journal ring's tail, one event per line
    metrics.json    the full Scheduler.metrics() surface (JSON-safe)
    timeline.json   Scheduler.timeline() (ring + alerts)
    trace.json      Scheduler.dump_trace export (Chrome trace-event
                    JSON; valid-but-empty when MINISCHED_TRACE unset)
    config.json     resolved MINISCHED_* env + the live faults spec and
                    per-gate fire counts

``capture`` never raises into the engine — a failed dump logs and
returns None; losing a bundle must never lose a batch.
"""
from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Optional, Set

from . import TRACE
from .journal import JOURNAL, note as _jnote

log = logging.getLogger(__name__)

__all__ = ["BUNDLES", "BundleConfig", "capture", "configure"]

SCHEMA = 1


class BundleConfig:
    """Process-wide arming state + the per-run one-per-class limiter."""

    def __init__(self, directory: str = ""):
        self._lock = threading.Lock()
        self.configure(directory)

    def configure(self, directory: str = "") -> None:
        with self._lock:
            self.directory = (directory or "").strip()
            self._captured: Set[str] = set()
            self.captures = 0
            self.suppressed = 0
            self.errors = 0
            self.enabled = bool(self.directory)

    def claim(self, incident_class: str) -> bool:
        """First trigger of this class this run? (thread-safe)"""
        with self._lock:
            if not self.enabled or incident_class in self._captured:
                if self.enabled:
                    self.suppressed += 1
                return False
            self._captured.add(incident_class)
            return True


def _from_env() -> BundleConfig:
    return BundleConfig(os.environ.get("MINISCHED_BUNDLE_DIR", ""))


#: The process-wide bundle config every trigger site imports.
BUNDLES = _from_env()


def configure(directory: str = "") -> BundleConfig:
    """Re-arm the process-wide bundle capture (tests / embedders);
    ``configure("")`` disarms and resets the per-class limiter."""
    BUNDLES.configure(directory)
    return BUNDLES


def _json_safe(obj):
    """Best-effort JSON coercion for the metrics surface (tuples become
    lists natively; anything exotic stringifies)."""
    return json.loads(json.dumps(obj, default=str))


def capture(incident_class: str, *, scheduler=None, reason: str = "",
            extra: Optional[dict] = None) -> Optional[str]:
    """Freeze an incident bundle. Returns the bundle directory path, or
    None (unarmed, rate-limited, or the dump failed — never raises).
    ``scheduler`` supplies the engine surfaces (metrics/timeline/trace);
    engine-less callers (the lifecycle engine's invariant oracle) still
    get the journal tail + config."""
    if not BUNDLES.enabled:
        return None
    if not BUNDLES.claim(incident_class):
        return None
    try:
        base = BUNDLES.directory
        os.makedirs(base, exist_ok=True)
        final = os.path.join(base, f"incident-{incident_class}")
        n = 0
        while os.path.exists(final):  # a previous run's bundle survives
            n += 1
            final = os.path.join(base,
                                 f"incident-{incident_class}-{n}")
        tmp = final + f".tmp-{os.getpid()}"
        os.makedirs(tmp)
        files = []

        def dump(name: str, payload) -> None:
            with open(os.path.join(tmp, name), "w",
                      encoding="utf-8") as f:
                if name.endswith(".jsonl"):
                    for line in payload:
                        f.write(json.dumps(line,
                                           separators=(",", ":")) + "\n")
                else:
                    json.dump(payload, f, indent=1, sort_keys=True)
            files.append(name)

        dump("journal.jsonl", JOURNAL.entries())
        from ..faults import FAULTS

        env = {k: v for k, v in sorted(os.environ.items())
               if k.startswith("MINISCHED_")}
        dump("config.json", {"env": env, "faults_spec": FAULTS.spec,
                             "fault_fires": FAULTS.counts(),
                             "journal": {"enabled": JOURNAL.enabled,
                                         "cap": JOURNAL.cap,
                                         "dropped": JOURNAL.dropped()}})
        if scheduler is not None:
            dump("metrics.json", _json_safe(scheduler.metrics()))
            dump("timeline.json", _json_safe(scheduler.timeline()))
            TRACE.export_chrome(os.path.join(tmp, "trace.json"))
            files.append("trace.json")
        manifest = {"schema": SCHEMA,
                    "incident_class": incident_class,
                    "reason": str(reason)[:500],
                    "unix": round(time.time(), 3),
                    "pid": os.getpid(),
                    "journal_next_seq": JOURNAL.next_seq(),
                    "files": sorted(files)}
        if extra:
            manifest["extra"] = _json_safe(extra)
        # manifest LAST, rename LAST-er: a reader that sees the final
        # directory sees a complete bundle; a crash mid-dump leaves
        # only a .tmp-* directory postmortem ignores.
        dump("manifest.json", manifest)
        os.rename(tmp, final)
        with BUNDLES._lock:
            BUNDLES.captures += 1
        log.warning("incident bundle captured: class=%s -> %s",
                    incident_class, final)
        _jnote("bundle.captured", incident_class=incident_class,
               path=final, reason=str(reason)[:200])
        return final
    except Exception:
        with BUNDLES._lock:
            BUNDLES.errors += 1
        log.exception("incident bundle capture failed (class=%s); "
                      "continuing — a lost bundle never loses a batch",
                      incident_class)
        return None

"""Adaptive overload control: the SLO sentinel turned from an alarm
into an actuator.

The burn-rate sentinel (obs/slo.py) can *detect* sustained trouble and
the engine supervisor can *contain* faults, but under sustained overload the engine
had no defense: ingress was unbounded, and a traffic spike simply
inflated queue-wait p99 until every SLO burned. This module closes the
loop with the standard production-scheduler overload posture — shed
early, degrade quality before latency, recover with hysteresis — as a
counted, trace-instant-visible ladder composed with the fault ladder:

    0 normal     no actuation; every effective knob equals its base
    1 tuned      adaptive tuning: effective max-batch steps DOWN (small
                 batches drain the queue at lower per-batch latency),
                 the batch-formation window steps UP (full deterministic
                 batches, no mid-burst recompiles), and the shortlist
                 width K widens or narrows within its certified bounds
                 (repairs climbing ⇒ widen — contention is exhausting K
                 candidates and each repair pays a full-row rescan;
                 latency burning with ZERO repairs ⇒ narrow — the scan
                 width is pure headroom)
    2 shedding   admission control: new low-priority arrivals (priority
                 below ``shed_priority``) park in the queue's counted
                 shed lane with backoff instead of entering activeQ —
                 NEVER dropped (the lifecycle invariant oracle stays
                 green; every shed pod re-admits via the backoff flusher
                 or the recovery release) — and the apiserver answers
                 pod creates with a typed 429-style verdict so remote
                 producers feel backpressure too
    3 brownout   shed optional QUALITY before latency: explain-mode
                 result ingestion pauses, the timeline snapshot cadence
                 stretches, and node-axis score sampling engages (the
                 ``percentageOfNodesToScore`` knob, which upstream
                 already treats as a static brownout dial)

The controller runs at timeline-snapshot cadence on the scheduling
thread (the sentinel's own cadence): each snapshot window votes
burning/clean from the sentinel's SYMPTOM objectives (the
degraded-posture objective is excluded for the same livelock reason the
supervisor's probation gate excludes it). Hysteresis is structural —
any level change requires ``hold`` windows since the last change, and
stepping DOWN additionally requires ``probation`` consecutive clean
windows — so an oscillating arrival curve cannot flap an actuation
between consecutive windows. Every transition is counted, emitted as an
``overload.escalate`` / ``overload.recover`` trace instant, and tagged
into the timeline's attribution stream.

Arming (process-wide env, the faults.py discipline; implies the SLO
sentinel, which implies the timeline — the controller is driven by
burn verdicts over the snapshot ring):

    MINISCHED_OVERLOAD=1                       default knobs
    MINISCHED_OVERLOAD="shed_priority=500,min_batch=16,hold=2,
                        probation=2,brownout_pct=50"
    MINISCHED_OVERLOAD="shed_priority=0;noisy:shed_priority=500"
                                               per-tenant shed budget:
                                               the ``noisy`` profile's
                                               engine sheds below 500
                                               while every other tenant
                                               keeps the base threshold

Unset (the default), every hook is a single attribute test and
decisions are bit-identical to an engine without this module —
pinned per engine mode by tests/test_torch_overload.py.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Dict, Optional, Set

from ..obs import instant
from ..obs.journal import note as jnote
from ..obs.timeseries import TIMELINE

__all__ = ["OVERLOAD", "OVERLOAD_LADDER", "OverloadConfig",
           "OverloadController", "configure", "parse_spec",
           "parse_spec_overrides"]

#: The actuation ladder, calm first. ``OverloadController.level``
#: indexes it; each level includes every shallower level's actuation.
OVERLOAD_LADDER = ("normal", "tuned", "shedding", "brownout")

#: Spec knobs: name → (default, caster, validator description). A
#: non-catalog name in the env spec is a loud ValueError (the faults.py
#: misconfiguration discipline).
_KNOBS = {
    # priority threshold: pods with spec.priority < this are sheddable
    # at the shedding rung (default 0 sheds only below-default-priority
    # pods — the conservative posture; size it to your tenant mix)
    "shed_priority": 0,
    # adaptive-tuning floor for the effective max batch size
    "min_batch": 16,
    # hysteresis: snapshot windows that must pass since the last
    # actuation before another level change may fire
    "hold": 2,
    # consecutive CLEAN windows required per recovery step down
    "probation": 2,
    # shed-lane backoff: initial park duration, doubling per re-shed up
    # to the ceiling (seconds) — guarantees every shed pod is re-offered
    # to the admission gate, so nothing is ever silently dropped
    "shed_backoff": 0.5,
    "shed_backoff_max": 5.0,
    # brownout: percentageOfNodesToScore engaged while level 3 holds
    # (clamped against an explicit base knob; 0 < pct < 100)
    "brownout_pct": 50,
    # brownout: timeline snapshot cadence multiplier (quality shed —
    # coarser telemetry while browning out; 1 disables the stretch)
    "timeline_stretch": 4,
    # tuning: seconds of batch-formation window added per tune step
    "window_step": 0.02,
    # tuning: maximum halvings of the effective max batch
    "tune_max": 2,
    # apiserver ingress: reject pod creates with the 429-style verdict
    # at this level and above (0 disables the HTTP-side gate; the
    # queue-side shed lane is independent of it)
    "http_reject_level": 3,
    # idle gate-open grace: the controller only observes windows while
    # batches resolve, so a level latched high with NO traffic would
    # keep the admission gates rejecting exactly the traffic recovery
    # needs (observed end-to-end: a producer 429'd at brownout forever
    # once the backlog drained). After this many seconds without a
    # window, the shed/HTTP gates soft-OPEN (the level itself only
    # moves on the scheduling thread, via the windows the re-admitted
    # traffic produces). 0 disables.
    "idle_open": 5.0,
}


def parse_spec(spec: str) -> Dict[str, float]:
    """``MINISCHED_OVERLOAD`` grammar → knob dict (the process-wide
    knobs; per-profile override segments are validated but returned by
    :func:`parse_spec_overrides`). Raises ValueError on junk — a
    silently-ignored overload spec would defeat the knob."""
    return parse_spec_overrides(spec)[0]


def parse_spec_overrides(spec: str) -> tuple:
    """Full ``MINISCHED_OVERLOAD`` grammar → (knobs, shed_overrides).

    Segments split on ``;``. The FIRST segment is the process-wide knob
    spec (``"1"`` = defaults; otherwise comma-separated ``name=value``
    pairs over the knob catalog). Every LATER segment is a per-profile
    shed-budget override, ``profile:shed_priority=N`` — that profile's
    engine sheds below N while the rest keep the base threshold, so one
    noisy tenant browns out alone:

        MINISCHED_OVERLOAD="shed_priority=0,hold=1;noisy:shed_priority=500"
    """
    out = {k: float(v) for k, v in _KNOBS.items()}
    spec = (spec or "").strip()
    segments = spec.split(";")
    base = segments[0].strip()
    overrides: Dict[str, int] = {}
    for seg in segments[1:]:
        seg = seg.strip()
        if not seg:
            continue
        try:
            prof, term = seg.split(":", 1)
            name, val = term.split("=", 1)
            prof, name, fval = prof.strip(), name.strip(), float(val)
        except ValueError:
            raise ValueError(
                f"bad per-profile overload term {seg!r} "
                "(want profile:shed_priority=N)")
        if not prof:
            raise ValueError(
                f"empty profile name in overload term {seg!r}")
        if name != "shed_priority":
            # shed_priority is the only per-profile knob: the ladder
            # state machine is per engine already, and the remaining
            # knobs shape process-wide machinery (windows, sentinel).
            raise ValueError(
                f"unknown per-profile overload knob {name!r} "
                "(only shed_priority may be set per profile)")
        overrides[prof] = int(fval)
    if base and base != "1":
        for part in base.split(","):
            part = part.strip()
            if not part:
                continue
            try:
                name, val = part.split("=", 1)
                name, fval = name.strip(), float(val)
            except ValueError:
                raise ValueError(
                    f"bad overload term {part!r} (want name=value)")
            if name not in _KNOBS:
                raise ValueError(
                    f"unknown overload knob {name!r} "
                    f"(known: {', '.join(sorted(_KNOBS))})")
            if name in ("hold", "probation", "min_batch",
                        "timeline_stretch") and fval < 1:
                raise ValueError(f"{name}={fval} must be >= 1")
            if name in ("shed_backoff", "shed_backoff_max") and fval <= 0:
                raise ValueError(f"{name}={fval} must be > 0 seconds")
            if name in ("tune_max", "http_reject_level", "idle_open",
                        "window_step") and fval < 0:
                # a negative tune_max would reach effective_max_batch as
                # a negative shift and kill the scheduling thread under
                # the exact load the controller exists to survive
                raise ValueError(f"{name}={fval} must be >= 0")
            if name == "brownout_pct" and not 0 < fval < 100:
                raise ValueError(
                    f"brownout_pct={fval} outside (0, 100) — 100 would "
                    "make the brownout rung a no-op")
            out[name] = fval
    return out, overrides


class OverloadConfig:
    """Process-wide arming state (one instance, :data:`OVERLOAD`).
    ``enabled`` is the single attribute every hot-path hook tests;
    the knob values are read only at actuation time."""

    def __init__(self, spec: str = ""):
        self._lock = threading.Lock()
        self.epoch = 0
        # Did THIS config arm the SLO sentinel as the documented
        # implication? Then disarming the controller disarms it again
        # (and the sentinel applies the same symmetry to the timeline).
        self._armed_slo = False
        self.configure(spec)

    def configure(self, spec: str) -> None:
        if spec:
            knobs, shed_overrides = parse_spec_overrides(spec)
        else:
            knobs = {k: float(v) for k, v in _KNOBS.items()}
            shed_overrides = {}
        with self._lock:
            self.epoch += 1
            self.spec = spec or ""
            self.shed_priority = int(knobs["shed_priority"])
            # Per-profile shed budgets (profile name → priority
            # threshold): an engine whose name is absent keeps the base.
            self.shed_overrides = dict(shed_overrides)
            self.min_batch = int(knobs["min_batch"])
            self.hold = int(knobs["hold"])
            self.probation = int(knobs["probation"])
            self.shed_backoff = float(knobs["shed_backoff"])
            self.shed_backoff_max = float(knobs["shed_backoff_max"])
            self.brownout_pct = int(knobs["brownout_pct"])
            self.timeline_stretch = int(knobs["timeline_stretch"])
            self.window_step = float(knobs["window_step"])
            self.tune_max = int(knobs["tune_max"])
            self.http_reject_level = int(knobs["http_reject_level"])
            self.idle_open = float(knobs["idle_open"])
            self.enabled = bool(spec)
        from ..obs import slo as slo_mod

        if self.enabled:
            # The controller is driven by burn verdicts — arming it
            # without the sentinel would never actuate anything. Arming
            # the controller therefore implies the sentinel (which in
            # turn implies the timeline); an explicitly-armed sentinel
            # (env or slo.configure) is left alone.
            if not slo_mod.SLO.enabled:
                try:
                    slo_mod.SLO.configure(
                        os.environ.get("MINISCHED_SLO", "") or "1")
                except ValueError:
                    import logging

                    logging.getLogger(__name__).error(
                        "malformed MINISCHED_SLO while arming the "
                        "overload controller; using the default catalog",
                        exc_info=True)
                    slo_mod.SLO.configure("1")
                self._armed_slo = True
                # Epoch stamp: a LATER explicit slo.configure() bumps
                # the epoch, and the disarm below then leaves that
                # user-owned sentinel alone.
                self._armed_slo_epoch = slo_mod.SLO.epoch
        else:
            # Symmetric disarm: only a sentinel THIS config armed —
            # never one the env pins on, and never one explicitly
            # reconfigured since (epoch moved = someone else owns it).
            if (self._armed_slo and slo_mod.SLO.enabled
                    and slo_mod.SLO.epoch == getattr(
                        self, "_armed_slo_epoch", -1)
                    and not os.environ.get("MINISCHED_SLO", "")):
                slo_mod.SLO.configure("")
            self._armed_slo = False

    def shed_priority_for(self, name: str) -> int:
        """The shed-budget threshold for one engine's profile name —
        the per-profile override when present, else the base knob
        (per-tenant shed budgets). Read on informer threads;
        both attributes are replaced under configure's lock, so worst
        case is one stale epoch, never a torn value."""
        return self.shed_overrides.get(name, self.shed_priority)


def _from_env() -> OverloadConfig:
    spec = os.environ.get("MINISCHED_OVERLOAD", "")
    if spec == "0":
        spec = ""  # MINISCHED_OVERLOAD=0 is the documented explicit off
    try:
        return OverloadConfig(spec)
    except ValueError:
        import logging

        logging.getLogger(__name__).error(
            "ignoring malformed MINISCHED_OVERLOAD=%r", spec,
            exc_info=True)
        return OverloadConfig("")


#: The process-wide overload configuration.
OVERLOAD = _from_env()


def configure(spec: str) -> OverloadConfig:
    """Re-arm the process-wide overload config (tests / embedders);
    ``configure("")`` disarms."""
    OVERLOAD.configure(spec)
    return OVERLOAD


#: The SLO objectives whose burn votes count as LATENCY symptoms for
#: the shortlist-narrowing rule (narrowing helps only when the cost is
#: scan width, which shows up as latency, not as faults/desyncs).
_LATENCY_SLOS = ("create_bound_p99", "queue_wait_p95")


class OverloadController:
    """One engine's closed-loop overload state machine.

    ``note_window`` is called once per timeline snapshot on the
    scheduling thread — the ONLY writer. Every other method is a
    cross-thread read of immutable ints (queue admission gate on
    informer threads, metrics() from scrape threads): worst case one
    stale gauge, never a torn value. Counters ride a small private
    lock so the metrics surface sums exactly."""

    def __init__(self, name: str = "engine"):
        self.name = name
        self.level = 0
        self.tune_steps = 0
        # Monotonic stamp of the last observed window — the gates'
        # idle-open clock (see OVERLOAD.idle_open).
        self._last_window_t = time.monotonic()
        # shortlist width exponent relative to the configured base K:
        # +n = widen (K << n), −n = narrow (K >> n); bounded ±2
        self.sl_exp = 0
        self._since_change = 10 ** 9  # a fresh engine may act at once
        self._sl_since = 10 ** 9      # the tuner's own hysteresis clock
        self._clean = 0
        # Last window's burning SYMPTOM objectives — the burn signal a
        # fleet replica publishes on its lease heartbeat (the steward's
        # rebalance trigger reads it; fleet/election.py). Written only
        # by the scheduling thread, read cross-thread as an immutable
        # frozenset (worst case one stale window, never torn).
        self.last_burning: frozenset = frozenset()
        self._lock = threading.Lock()
        self._counters: Dict[str, int] = {
            "overload_escalations": 0, "overload_recoveries": 0,
            "overload_transitions": 0, "overload_brownouts": 0,
            "overload_tuner_adjustments": 0,
            "admission_rejects_total": 0,
            "overload_explain_skipped": 0,
        }

    # ---- scheduling-thread state machine -------------------------------

    def note_window(self, burning: Set[str],
                    repairs_delta: float = 0.0) -> bool:
        """One snapshot window observed. ``burning`` is the set of
        SYMPTOM objectives currently burning (the sentinel's view with
        the degraded-posture objective already excluded). Returns True
        when any actuation changed (the engine then applies the new
        effective knobs). Hysteresis contract: at most one level change
        per ``hold`` windows, and recovery additionally needs
        ``probation`` consecutive clean windows — an input that flips
        burning/clean every window holds the level steady."""
        if not OVERLOAD.enabled:
            # Runtime disarm with actuation still latched: neutralize
            # everything in one step (the caller applies the restored
            # effective knobs — timeline stretch, shortlist base). The
            # cross-thread hooks below additionally gate on ``enabled``
            # so a disarm takes effect even before this window runs.
            if self.level or self.tune_steps or self.sl_exp:
                self.level = 0
                self.tune_steps = 0
                self.sl_exp = 0
                self._clean = 0
                self._count("overload_transitions")
                instant("overload.disarm")
                jnote("overload.disarm", engine=self.name)
                return True
            return False
        cfg = OVERLOAD
        self._last_window_t = time.monotonic()
        self.last_burning = frozenset(burning)
        self._since_change += 1
        self._sl_since += 1
        prev_level = self.level
        changed = False
        if burning:
            self._clean = 0
            if (self.level < len(OVERLOAD_LADDER) - 1
                    and self._since_change >= cfg.hold):
                self.level += 1
                changed = True
                self._since_change = 0
                self._count("overload_escalations")
                self._count("overload_transitions")
                if self.level == 3:
                    self._count("overload_brownouts")
                instant("overload.escalate",
                        to=OVERLOAD_LADDER[self.level], level=self.level,
                        burning=",".join(sorted(burning)))
                jnote("overload.escalate", engine=self.name,
                      frm=OVERLOAD_LADDER[self.level - 1],
                      to=OVERLOAD_LADDER[self.level], level=self.level,
                      burning=",".join(sorted(burning)),
                      knobs=("batch,window" if self.level == 1
                             else "admission,shed"
                             if self.level == 2
                             else "explain,timeline_stretch,sampling"))
                if TIMELINE.enabled:
                    TIMELINE.note_activity(
                        f"overload:{OVERLOAD_LADDER[self.level]}")
            # Shortlist tuning inside the tuned region: repairs climbing
            # ⇒ widen (each repair is a counted full-row rescan — K is
            # too narrow for the contention); latency burning with zero
            # repairs ⇒ narrow (K certifies everything — width is pure
            # scan cost). Hysteresis-gated on the tuner's OWN clock so
            # a level change in the same window neither blocks nor is
            # blocked by a retune. Gated on the PREVIOUS window's level:
            # tuning refines an engine already in the tuned region, it
            # is not part of entering it.
            if prev_level >= 1 and self._sl_since >= cfg.hold:
                want = self.sl_exp
                if repairs_delta > 0:
                    want = min(2, self.sl_exp + 1)
                elif any(n in burning for n in _LATENCY_SLOS):
                    want = max(-2, self.sl_exp - 1)
                if want != self.sl_exp:
                    self.sl_exp = want
                    self._sl_since = 0
                    self._count("overload_tuner_adjustments")
                    changed = True
                    instant("overload.tune", shortlist_exp=want)
                    jnote("overload.tune", engine=self.name,
                          shortlist_exp=want,
                          burning=",".join(sorted(burning)))
            # Tune depth follows the level (bounded): deeper burn, the
            # smaller the effective batch / wider the formation window.
            want_tune = min(cfg.tune_max, self.level)
            if want_tune != self.tune_steps:
                self.tune_steps = want_tune
                changed = True
        else:
            self._clean += 1
            if (self.level > 0 and self._clean >= cfg.probation
                    and self._since_change >= cfg.hold):
                self.level -= 1
                self._clean = 0
                self._since_change = 0
                changed = True
                self._count("overload_recoveries")
                self._count("overload_transitions")
                instant("overload.recover",
                        to=OVERLOAD_LADDER[self.level], level=self.level)
                jnote("overload.recover", engine=self.name,
                      frm=OVERLOAD_LADDER[self.level + 1],
                      to=OVERLOAD_LADDER[self.level], level=self.level)
                if TIMELINE.enabled:
                    TIMELINE.note_activity(
                        f"overload:{OVERLOAD_LADDER[self.level]}")
                self.tune_steps = min(self.tune_steps, self.level,
                                      OVERLOAD.tune_max)
                if self.level == 0 and self.sl_exp:
                    # full recovery restores the configured default K
                    self.sl_exp = 0
                    self._count("overload_tuner_adjustments")
        return changed

    def _count(self, key: str, n: int = 1) -> None:
        with self._lock:
            self._counters[key] = self._counters.get(key, 0) + n

    # ---- effective knobs (read on the scheduling thread) ----------------

    def effective_max_batch(self, base: int) -> int:
        if self.tune_steps == 0 or not OVERLOAD.enabled:
            return base
        return max(min(OVERLOAD.min_batch, base), base >> self.tune_steps)

    def effective_window(self, base: float) -> float:
        if self.tune_steps == 0 or not OVERLOAD.enabled:
            return base
        return max(base, self.tune_steps * OVERLOAD.window_step)

    def effective_idle(self, base: float) -> float:
        """A widened formation window needs an idle exit so the tail
        batch of a shrinking burst doesn't stall for the whole window."""
        if self.tune_steps == 0 or base > 0 or not OVERLOAD.enabled:
            return base
        return OVERLOAD.window_step / 2.0

    def effective_loop_depth(self, base: int) -> int:
        """The device-loop work-ring depth under tuning: halved per tune
        step (floor 1 — depth 1 disengages the fused loop entirely, the
        latency-first posture), untouched at tune depth 0 so loop-mode
        decision/batch streams are bit-identical to an untuned engine.
        Composes with the batch/K dials: a tuned engine runs smaller
        batches through a shallower ring, trading fused-dispatch
        amortization back for per-batch latency and break granularity."""
        if self.tune_steps == 0 or not OVERLOAD.enabled:
            return base
        return max(1, base >> self.tune_steps)

    def shortlist_target(self, base_k: Optional[int]) -> Optional[int]:
        """The tuner's shortlist width for a configured base K — always
        within the certified machinery (any K is exact; repairs absorb a
        too-narrow one), bounded to [16, 4×base]."""
        if base_k is None:
            return None
        if self.sl_exp == 0:
            return base_k
        if self.sl_exp > 0:
            return min(base_k * 4, base_k << self.sl_exp)
        # floor at min(base, 16): a bare max(16, ...) would WIDEN a
        # sub-16 configured base exactly when the tuner meant to narrow
        return max(min(base_k, 16), base_k >> (-self.sl_exp))

    def effective_pct_nodes(self, base_pct: int) -> int:
        """Brownout engages node-axis score sampling: the upstream
        percentageOfNodesToScore dial, pulled DOWN to ``brownout_pct``
        while level 3 holds (an explicit tighter base wins)."""
        if self.level < 3 or not OVERLOAD.enabled:
            return base_pct
        pct = OVERLOAD.brownout_pct
        if 0 < base_pct < pct:
            return base_pct
        return pct

    @property
    def brownout_active(self) -> bool:
        return self.level >= 3 and OVERLOAD.enabled

    @property
    def timeline_stretch(self) -> int:
        return (OVERLOAD.timeline_stretch
                if self.level >= 3 and OVERLOAD.enabled else 1)

    @property
    def shedding(self) -> bool:
        return self.level >= 2 and OVERLOAD.enabled

    # ---- cross-thread gates ---------------------------------------------

    def _gates_idle_open(self) -> bool:
        """Has the controller seen NO window for idle_open seconds? A
        window only happens while batches resolve, so a level latched
        high over an idle engine must not keep rejecting the very
        traffic whose windows would walk it back down. The LEVEL is
        untouched (scheduling-thread-owned); only the gates open."""
        grace = OVERLOAD.idle_open
        return (grace > 0
                and time.monotonic() - self._last_window_t > grace)

    def admits(self, pod) -> bool:
        """Queue-ingress admission verdict (informer threads): at the
        shedding rung and deeper, a new arrival below the priority
        threshold parks in the shed lane. Level < 2 is one int compare
        — the disarmed hot-path cost."""
        if self.level < 2 or not OVERLOAD.enabled:
            return True
        if self._gates_idle_open():
            return True
        # Per-profile shed budget: this controller's name (the engine's
        # serving profile) selects its own threshold, so one noisy
        # tenant's override sheds that tenant alone while every quiet
        # tenant's gate keeps the base budget.
        return pod.spec.priority >= OVERLOAD.shed_priority_for(self.name)

    def explain_skip(self) -> bool:
        """Brownout quality shed: pause explain-result ingestion
        (counted — the gap in the result store is attributable)."""
        if self.level < 3 or not OVERLOAD.enabled:
            return False
        self._count("overload_explain_skipped")
        return True

    def http_reject_reason(self) -> Optional[str]:
        """The apiserver's typed 429-style ingress verdict (server
        threads): non-None ⇒ reject this pod create, counted. The HTTP
        gate engages one rung deeper than the queue shed by default
        (http_reject_level=3): remote producers lose ingress only when
        quality is already being shed."""
        lvl = OVERLOAD.http_reject_level
        if not OVERLOAD.enabled or lvl < 1 or self.level < lvl:
            return None
        if self._gates_idle_open():
            return None
        self._count("admission_rejects_total")
        return (f"scheduler overloaded ({OVERLOAD_LADDER[self.level]}); "
                "retry after backoff")

    # ---- observability ---------------------------------------------------

    def metrics(self) -> Dict[str, float]:
        with self._lock:
            out: Dict[str, float] = dict(self._counters)
        out["overload_level"] = self.level
        out["overload_state"] = OVERLOAD_LADDER[self.level]  # non-numeric
        out["brownout_active"] = int(self.level >= 3)
        out["overload_tune_steps"] = self.tune_steps
        out["overload_shortlist_exp"] = self.sl_exp
        return out

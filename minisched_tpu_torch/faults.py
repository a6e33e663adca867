"""Process-wide, seedable fault-gate registry: deterministic failure
injection at the engine's hot seams.

The engine's fast paths (the two-deep pipeline, the device-resident
delta protocol, the shortlist scan) have failure behaviour worth probing
on purpose. Named gates sit at the seams; this package wires these:

    step        step dispatch                (engine/scheduler.py)
    fetch       decision fetch               (engine/scheduler.py) —
                ``corrupt`` scribbles the chosen plane with absurd rows
    residency   dynamic-leaf delta/carry     (engine/scheduler.py) —
                ``corrupt`` diverges the host mirror from the device
    shortlist_repair
                shortlist decision accounting (engine/scheduler.py) —
                ``corrupt`` re-points an assigned pod's fetched chosen
                row at a DIFFERENT valid node, modeling a shortlist
                mispick the certificate should have repaired; only the
                full-width cross-check (``shortlist_check_every``) can
                catch it, since the row passes the range sanity check
    commit      commit-worker failure flush  (engine/scheduler.py)
    bind        bulk binding task            (engine/scheduler.py)
    informer    informer dispatch loop       (state/informer.py)
    admission   queue ingress, once per add  (engine/queue.py) —
                ``corrupt`` force-sheds the transaction (the pods
                re-admit through the shed lane); ``err`` admits
    journal     journal event write          (obs/journal.py)
    auction_mirror
                the auction's residency replay (engine/scheduler.py)
    index       the maintained index's dispatch (engine/scheduler.py) —
                ``corrupt`` scribbles the served score slab
    tenant_index
                the fused-indexed tenant dispatch (encode/cache.py) —
                ``corrupt`` scribbles one tenant's slice of the slab
    http        every RemoteStore call       (apiserver/client.py) —
                ``err`` models the wire eating the request; the
                client's retry deadline absorbs it
    checkpoint  checkpoint write, before any disk touch
                                             (state/persistence.py)
    lifecycle   every lifecycle driver step  (lifecycle/driver.py) —
                ``err``/``die`` skip the step and retry it 50 ms of
                virtual time later; ``corrupt`` burns one draw of the
                generator's PRNG stream
    lease       a fleet replica's lease heartbeat (fleet/lease.py) —
                ``err`` drops the renewal; ``corrupt`` sends it with a
                rewound resource_version, which the store's CAS rejects

``GATES`` keeps the JAX package's whole catalog, in its order, so a spec
parses alike in both packages and every gate's PRNG stream (seeded by
its catalog index) is the same. The two other gates (proc, election)
belong to the process fleet and its steward election, which are not
part of this package yet: they parse and count, but no seam of this
package calls them.

Configured once per process from ``MINISCHED_FAULTS`` (tests reconfigure
via :func:`configure`), a comma-separated list of ``gate:action@trigger``
rules:

    MINISCHED_FAULTS="step:err@0.02,fetch:corrupt@3,commit:die@once,
                      informer:stall@2s,bind:err@5"

Actions:
    err      raise :class:`FaultInjected` at the gate (the generic
             recoverable fault; every gate's callers contain it).
    die      raise :class:`FaultWorkerDeath` — escapes the commit
             worker's normal exception guard, simulating the worker
             thread dying mid-flush (the supervisor must drain the
             pipeline and restart the worker).
    corrupt  the gate RETURNS ``"corrupt"`` and its call site applies a
             seam-specific corruption (garbage decision plane, scribbled
             residency mirror) — exercising DETECTORS, not just
             exception paths.
    stall    sleep at the gate (watchdog / latency injection).

Triggers:
    once         fire on the first call only (= ``1``).
    N (int)      fire on exactly the Nth call to the gate (1-based) —
                 the deterministic-schedule form the fault suite uses.
    p (float<1)  fire each call with probability p, drawn from a PRNG
                 seeded by ``MINISCHED_FAULT_SEED`` and the gate name —
                 the ambient-rate form the chaos soak uses; a fixed seed
                 makes a soak run reproducible.
    DUR          (stall only) the stall duration — ``2s`` / ``150ms``;
                 fires once unless suffixed ``xTRIGGER``
                 (``stall@50msx0.1`` = 50 ms stall at 10% per call,
                 ``stall@2sx3`` = 2 s stall on the 3rd call).

With ``MINISCHED_FAULTS`` unset the registry holds no rules and
:meth:`FaultRegistry.hit` is a single attribute test — the compiled-out
no-op the acceptance bar demands (gates sit on per-batch seams, never in
per-pod loops, so even the armed cost is noise).

Every gate call and every fire is counted (thread-safe); the engine
surfaces the counts through ``Scheduler.metrics()``
(``fault_fires_<gate>``), so a run can prove it was fault-free (or
exactly how fault-ridden it was).
"""
from __future__ import annotations

import logging
import os
import random
import threading
import time
from typing import Dict, List, Optional

from .obs import instant as _trace_instant
from .obs.journal import note as _journal_note

log = logging.getLogger(__name__)

#: The gate catalog; hit() rejects unknown names so a typo in a rule or a
#: call site cannot silently never fire.
# New gates append LAST: per-gate PRNG streams seed by catalog index,
# so appending (never inserting) keeps every existing gate's firing
# pattern stable under a fixed seed. auction_mirror sits inside
# _DeviceResidency.note_debits: corrupt scribbles one node's aggregate
# debit — certificate-invisible by construction (the decision already
# left the device), so only the MINISCHED_RESIDENT_CHECK_EVERY
# cross-check can catch it. proc sits on the process-fleet lifecycle
# seams (fleet/procfleet.py): spawn, replica heartbeat, and the
# replica-side batch seam where ``die`` becomes a real SIGKILL.
# election sits on the steward-election seams (fleet/election.py):
# the CAS claim/renew call and the burn-signal heartbeat publication.
# tenant_index sits on the fused-indexed tenant dispatch seam
# (encode/cache.py): the stacked (T,C,N) slab, pre-dispatch.
GATES = ("step", "fetch", "residency", "shortlist_repair", "commit",
         "bind", "informer", "http", "checkpoint", "lifecycle",
         "admission", "index", "journal", "lease", "auction_mirror",
         "proc", "election", "tenant_index")

_ACTIONS = ("err", "die", "corrupt", "stall")


class FaultInjected(RuntimeError):
    """An injected fault fired at a gate. Deliberately a RuntimeError:
    callers' existing transient-failure containment must absorb it the
    way it absorbs the real fault the gate models."""


class FaultWorkerDeath(FaultInjected):
    """An injected WORKER DEATH: the commit worker's normal exception
    guard re-raises this (and only this), so it escapes to the
    supervisor like a thread that died — the drain/restart path, not the
    log-and-continue path."""


class _Rule:
    """One parsed ``gate:action@trigger`` rule."""

    __slots__ = ("gate", "action", "nth", "prob", "stall_s", "spec")

    def __init__(self, gate: str, action: str, nth: Optional[int],
                 prob: Optional[float], stall_s: float, spec: str):
        self.gate = gate
        self.action = action
        self.nth = nth          # fire on exactly this 1-based call number
        self.prob = prob        # or: per-call probability
        self.stall_s = stall_s  # stall duration (stall action only)
        self.spec = spec

    def fires(self, call_no: int, rng: random.Random) -> bool:
        if self.nth is not None:
            return call_no == self.nth
        if self.prob is not None:
            return rng.random() < self.prob
        return False


def _parse_duration(tok: str) -> Optional[float]:
    """``2s``/``150ms`` → seconds, else None."""
    for suffix, scale in (("ms", 1e-3), ("s", 1.0)):
        if tok.endswith(suffix):
            try:
                return float(tok[:-len(suffix)]) * scale
            except ValueError:
                return None
    return None


def _parse_trigger(tok: str):
    """``once``/int/float → (nth, prob); raises ValueError on junk."""
    if tok == "once":
        return 1, None
    try:
        if "." in tok:
            p = float(tok)
            if not 0.0 < p < 1.0:
                raise ValueError
            return None, p
        n = int(tok)
        if n < 1:
            raise ValueError
        return n, None
    except ValueError:
        raise ValueError(f"bad fault trigger {tok!r} (want once, a "
                         "1-based call number, or a probability < 1)")


def parse_spec(spec: str) -> List[_Rule]:
    """Parse a ``MINISCHED_FAULTS`` string into rules. Raises ValueError
    on malformed input — a misconfigured fault schedule silently not
    firing would defeat the whole point."""
    rules: List[_Rule] = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        try:
            gate_action, trigger = part.split("@", 1)
            gate, action = gate_action.split(":", 1)
        except ValueError:
            raise ValueError(f"bad fault rule {part!r} "
                             "(want gate:action@trigger)")
        gate, action, trigger = (gate.strip(), action.strip(),
                                 trigger.strip())
        if gate not in GATES:
            raise ValueError(f"unknown fault gate {gate!r} "
                             f"(known: {', '.join(GATES)})")
        if action not in _ACTIONS:
            raise ValueError(f"unknown fault action {action!r} "
                             f"(known: {', '.join(_ACTIONS)})")
        if action == "stall":
            dur_tok, _, trig_tok = trigger.partition("x")
            stall_s = _parse_duration(dur_tok)
            if stall_s is None:
                raise ValueError(
                    f"stall rule {part!r} needs a duration (2s / 150ms), "
                    "optionally suffixed xTRIGGER")
            nth, prob = _parse_trigger(trig_tok) if trig_tok else (1, None)
            rules.append(_Rule(gate, action, nth, prob, stall_s, part))
        else:
            nth, prob = _parse_trigger(trigger)
            rules.append(_Rule(gate, action, nth, prob, 0.0, part))
    return rules


class FaultRegistry:
    """Rules + per-gate call/fire counters. One process-wide instance
    (:data:`FAULTS`); tests swap its configuration with
    :func:`configure` and restore with ``configure("")``."""

    def __init__(self, spec: str = "", seed: int = 0):
        self._lock = threading.Lock()
        self.configure(spec, seed)

    def configure(self, spec: str, seed: int = 0) -> None:
        with self._lock:
            self._rules: Dict[str, List[_Rule]] = {}
            for rule in parse_spec(spec or ""):
                self._rules.setdefault(rule.gate, []).append(rule)
            self.spec = spec or ""
            self.seed = seed
            # Per-gate PRNG streams: one gate's firing pattern must not
            # shift when another gate's rule is added/removed, or a
            # "same seed" soak re-run stops being a re-run.
            self._rng = {g: random.Random((seed << 8) ^ i)
                         for i, g in enumerate(GATES)}
            self._calls = {g: 0 for g in GATES}
            self._fires = {g: 0 for g in GATES}
            self.enabled = bool(self._rules)

    def hit(self, gate: str) -> Optional[str]:
        """One pass through a gate. Unarmed (no rules anywhere): a
        single attribute test. Armed: count the call, evaluate this
        gate's rules in order, and on a fire count it and act — raise
        (err/die), sleep (stall), or return ``"corrupt"`` for the call
        site to apply its seam-specific corruption. Returns None when
        nothing fired."""
        if not self.enabled:
            return None
        with self._lock:
            if gate not in self._calls:
                raise KeyError(f"unknown fault gate {gate!r}")
            self._calls[gate] += 1
            call_no = self._calls[gate]
            fired = None
            for rule in self._rules.get(gate, ()):
                if rule.fires(call_no, self._rng[gate]):
                    fired = rule
                    self._fires[gate] += 1
                    break
        if fired is None:
            return None
        log.warning("fault gate %r fired (%s, call #%d)", gate,
                    fired.spec, call_no)
        # Flight-recorder instant (obs): a faulted run's trace timeline
        # shows WHERE each gate fired relative to the engine spans.
        _trace_instant(f"fault.{gate}", spec=fired.spec, call=call_no,
                       action=fired.action)
        # Decision-journal event (obs/journal.py): the causal chain's
        # ROOT — postmortem narratives trace from this fire through the
        # ladder moves it provoked. note() skips its own gate for the
        # ``fault.journal`` kind, so a firing journal gate cannot
        # recurse.
        _journal_note(f"fault.{gate}", spec=fired.spec, call=call_no,
                      action=fired.action)
        if fired.action == "stall":
            time.sleep(fired.stall_s)
            return None
        if fired.action == "die":
            raise FaultWorkerDeath(
                f"injected worker death at gate {gate!r} ({fired.spec})")
        if fired.action == "err":
            raise FaultInjected(
                f"injected fault at gate {gate!r} ({fired.spec})")
        return "corrupt"

    def counts(self) -> Dict[str, int]:
        """Per-gate FIRE counts (gates that never fired included at 0)."""
        with self._lock:
            return dict(self._fires)

    def calls(self) -> Dict[str, int]:
        """Per-gate call (traversal) counts."""
        with self._lock:
            return dict(self._calls)

    def reset_counts(self) -> None:
        with self._lock:
            self._calls = {g: 0 for g in GATES}
            self._fires = {g: 0 for g in GATES}


def _from_env() -> FaultRegistry:
    spec = os.environ.get("MINISCHED_FAULTS", "")
    seed = int(os.environ.get("MINISCHED_FAULT_SEED", "0"))
    try:
        return FaultRegistry(spec, seed)
    except ValueError:
        # A malformed env spec must fail LOUDLY but not unimportably —
        # the engine still has to boot for the operator to see the log.
        log.error("ignoring malformed MINISCHED_FAULTS=%r", spec,
                  exc_info=True)
        return FaultRegistry("", seed)


#: The process-wide registry every gate call site imports.
FAULTS = _from_env()


def configure(spec: str, seed: int = 0) -> FaultRegistry:
    """Re-arm the process-wide registry (tests / embedders). Resets all
    counters. ``configure("")`` disarms."""
    FAULTS.configure(spec, seed)
    return FAULTS

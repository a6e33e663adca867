"""Cluster-lifecycle scenario engine: the event-loop driver.

The scenario harness (``scenario/runner.py``) drives the scheduler with a
single hand-written script; the fault registry (``faults.py``) injects
infrastructure failures. Neither exercises the engine under loads shaped
like production — autoscaling pools, spot reclamation waves, rolling
upgrades, diurnal arrival curves — the workload dynamics trace-driven
cluster-scheduler studies (Borg-style traces) made the standard
evaluation methodology. This package closes that gap with a composable,
seed-deterministic scenario GENERATOR subsystem layered on the
``Cluster`` facade:

  * :class:`LifecycleDriver` — a virtual-clock event loop. Generators
    (``generators.py``) are plain Python generator functions that mutate
    the cluster through a ledger-tracked :class:`LifecycleView` and
    ``yield`` the virtual delay to their next step; the driver
    interleaves them on a heap keyed by virtual time and re-checks every
    registered invariant (``invariants.py``) after each step — every
    soak doubles as a correctness oracle.
  * Determinism contract: the event stream is a pure function of
    ``MINISCHED_LIFECYCLE_SEED`` (per-generator PRNG streams, the
    faults.py discipline: adding a generator never shifts another's
    draws) — in PURE mode (no scheduler attached, ``pace=0``) two runs
    with the same seed produce byte-identical :meth:`event_lines` and
    identical :meth:`state_digest`. With a LIVE engine attached the
    stream may diverge (the scheduler binds pods on its own clock) and
    the invariants are the oracle instead.
  * :class:`DisruptionBudget` — the PodDisruptionBudget-like
    max-unavailable constraint voluntary-disruption generators (rolling
    upgrades, reclamation waves) must acquire nodes through; the
    matching invariant re-derives the cordoned count from the STORE, so
    the budget is verified, not trusted.
  * Fault composition: every driver step passes the ``lifecycle`` gate
    of the process-wide fault registry, so ``MINISCHED_FAULTS=
    "lifecycle:err@0.05,step:err@2,..."`` composes workload churn with
    infrastructure faults in one run (``err``/``die`` skip the step and
    retry it shortly after — a flaky orchestrator tick; ``corrupt``
    burns one PRNG draw, deterministically perturbing the remaining
    schedule; ``stall`` delays inside the registry).

Virtual time: generators yield delays in virtual seconds; ``pace`` maps
them to real sleeps (``pace=1.0`` = real time, the live default; ``0`` =
as fast as possible, the pure-generation default). The clock only ever
advances — event records carry virtual stamps, never wall-clock.
"""
from __future__ import annotations

import hashlib
import itertools
import json
import os
import random
import threading
import time
import zlib
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Set, Tuple

from ..faults import FAULTS, FaultInjected
from ..obs import instant
from ..obs.timeseries import note_activity
from ..state import objects as obj
from ..errors import NotFoundError

#: Env knobs (documented in README): the seed every run derives its
#: per-generator PRNG streams from, and global rate/amplitude scales the
#: bench churn phase applies to its arrival curves.
SEED_ENV = "MINISCHED_LIFECYCLE_SEED"
RATE_ENV = "MINISCHED_LIFECYCLE_RATE"
AMPLITUDE_ENV = "MINISCHED_LIFECYCLE_AMPLITUDE"


def seed_from_env(default: int = 0) -> int:
    return int(os.environ.get(SEED_ENV, str(default)))


class InvariantViolation(AssertionError):
    """An invariant failed (and stayed failed through the settle
    window). Carries the event index + virtual time for replay: re-run
    with the same seed and the violation reproduces exactly in pure
    mode."""


@dataclass(frozen=True)
class LifecycleEvent:
    """One recorded mutation: virtual stamp + generator + verb.
    ``line()`` is the byte-identity unit of the determinism contract —
    no wall-clock, no uids, no object ids."""

    t: float
    gen: str
    verb: str
    detail: str

    def line(self) -> str:
        return f"{self.t:.6f} {self.gen} {self.verb} {self.detail}"


class DisruptionBudget:
    """Max-unavailable constraint over one node pool (the policy/v1
    PodDisruptionBudget shape applied to NODES: at most
    ``max_unavailable`` pool members voluntarily disrupted — cordoned /
    draining / mid-replacement — at once). Generators ``acquire`` a node
    before cordoning and ``release`` it once the node is healthy (or
    gone); ``denials`` counts contention, the adversarial-overlap test's
    evidence that two generators actually raced for the budget."""

    def __init__(self, pool: str, max_unavailable: int):
        self.pool = pool
        self.max_unavailable = int(max_unavailable)
        self._held: Set[str] = set()
        self._lock = threading.Lock()
        self.denials = 0
        self.acquires = 0
        self.high_water = 0

    def acquire(self, node: str) -> bool:
        with self._lock:
            if node in self._held or len(self._held) >= self.max_unavailable:
                self.denials += 1
                return False
            self._held.add(node)
            self.acquires += 1
            self.high_water = max(self.high_water, len(self._held))
            return True

    def release(self, node: str) -> None:
        with self._lock:
            self._held.discard(node)

    def held(self) -> Set[str]:
        with self._lock:
            return set(self._held)


class LifecycleView:
    """Ledger-tracked mutation facade the generators drive the cluster
    through. Every verb goes through the same store the informers watch
    (the client-go path — never a cache backdoor), records one
    :class:`LifecycleEvent`, and maintains the ledgers the invariants
    audit: ``expected_pods`` (created minus deliberately removed),
    ``deleted_pods`` (tombstones — resurrection detection),
    ``preempted_pods`` (missing-but-explained, from Preempted events),
    ``expected_nodes``, and per-verb counters."""

    def __init__(self, driver: "LifecycleDriver"):
        self._d = driver
        self.cluster = driver.cluster
        self.store = driver.cluster.store
        self.expected_pods: Set[str] = set()
        self.deleted_pods: Set[str] = set()
        self.preempted_pods: Set[str] = set()
        self.expected_nodes: Set[str] = set()
        self.counters: Dict[str, int] = {}
        self._pool_seq: Dict[str, itertools.count] = {}
        self._evict_seq = itertools.count(1)
        self._reconcile_seq = itertools.count(1)
        # Adopt whatever the scenario pre-created, so invariants audit
        # the whole cluster, not just driver-born objects.
        for p in self.store.list("Pod"):
            self.expected_pods.add(p.key)
        for n in self.store.list("Node"):
            self.expected_nodes.add(n.metadata.name)

    def count(self, key: str, n: int = 1) -> None:
        self.counters[key] = self.counters.get(key, 0) + n

    # ---- pods ----------------------------------------------------------

    def create_pod(self, name: str, **kw) -> obj.Pod:
        pod = self.cluster.create_pod(name, **kw)
        self.expected_pods.add(pod.key)
        self.count("pods_created")
        self._d.record("create_pod", f"{pod.key} {_kw_detail(kw)}")
        return pod

    def create_pods(self, pods: List[obj.Pod]) -> List[obj.Pod]:
        """Bulk ledgered submission: ONE store transaction for a whole
        arrival wave (the overload bench's open-loop saturator — per-pod
        creates cap the achievable arrival rate at the store's per-call
        overhead, which can undershoot the engine and never saturate)."""
        created = self.cluster.create_objects(pods)
        self.expected_pods.update(p.key for p in created)
        self.count("pods_created", len(created))
        self._d.record("create_pods", f"x{len(created)}")
        return created

    def delete_pod(self, key: str) -> None:
        """Deliberate removal (a job finishing, a client cancel) — the
        ledger forgets it; only SILENT loss is a violation."""
        self.store.delete("Pod", key)
        self.expected_pods.discard(key)
        self.deleted_pods.add(key)
        self.count("pods_deleted")
        self._d.record("delete_pod", key)

    def evict_pods_on(self, node_name: str, recreate: bool = True) -> int:
        """Evict every pod bound to ``node_name``: delete, and (like the
        ReplicaSet controller the rebuild doesn't model) recreate a
        fresh same-spec incarnation as a pending pod. Deterministic
        order (sorted keys); returns the eviction count."""
        n = 0
        for p in sorted(self.store.list("Pod"), key=lambda p: p.key):
            if p.spec.node_name == node_name:
                n += self._evict_one(p, recreate)
        self._d.record("evict", f"{node_name} n={n}")
        return n

    def _evict_one(self, p: obj.Pod, recreate: bool = True) -> int:
        """Single-pod eviction bookkeeping shared by ``evict_pods_on``
        and ``delete_node``'s post-delete sweep: delete, tombstone,
        count, recreate a fresh incarnation. Returns 1 on eviction, 0
        when the pod was already gone."""
        try:
            self.store.delete("Pod", p.key)
        except NotFoundError:
            return 0
        self.expected_pods.discard(p.key)
        self.deleted_pods.add(p.key)
        self.count("pods_evicted")
        if recreate:
            self._recreate(p, f"{p.metadata.name}-e{next(self._evict_seq)}")
        return 1

    def _recreate(self, old: obj.Pod, name: str) -> obj.Pod:
        spec = obj.deepcopy_obj(old.spec)
        spec.node_name = ""
        pod = obj.Pod(
            metadata=obj.ObjectMeta(name=name,
                                    namespace=old.metadata.namespace,
                                    labels=dict(old.metadata.labels)),
            spec=spec)
        self.store.create(pod)
        self.expected_pods.add(pod.key)
        self.count("pods_recreated")
        return pod

    def note_preempted(self, key: str) -> None:
        """A missing pod explained by a Preempted event: accounted, not
        lost. The tenant-mix reconciler recreates replacements from
        here."""
        if key in self.expected_pods:
            self.expected_pods.discard(key)
            self.preempted_pods.add(key)
            self.count("pods_preempted")

    def reconcile_preempted(self) -> int:
        """The controller half of preemption the rebuild's store lacks:
        recreate a fresh incarnation for every preempted-and-not-yet-
        replaced pod (deterministic order). Returns replacements made."""
        n = 0
        for key in sorted(self.preempted_pods):
            self.preempted_pods.discard(key)
            ns, name = key.split("/", 1)
            pod = obj.Pod(metadata=obj.ObjectMeta(
                name=f"{name}-pr{next(self._reconcile_seq)}", namespace=ns))
            try:
                prior = self.store.get("Pod", key)
                pod.spec = obj.deepcopy_obj(prior.spec)  # pragma: no cover
            except NotFoundError:
                pass  # victim is gone (the normal case): fresh default spec
            self.store.create(pod)
            self.expected_pods.add(pod.key)
            self.count("pods_recreated")
            n += 1
        if n:
            self._d.record("reconcile_preempted", f"n={n}")
        return n

    def preempted_event_keys(self) -> Set[str]:
        """Pod keys named by Preempted events (the broadcaster commits
        them asynchronously — callers retry within the settle window)."""
        out = set()
        for e in self.store.list("Event"):
            if e.reason == "Preempted" and e.involved_object.startswith("Pod:"):
                out.add(e.involved_object[4:])
        return out

    # ---- nodes ---------------------------------------------------------

    def create_pool_node(self, pool: str, **kw) -> str:
        """Fresh-incarnation pool member: ``{pool}-{seq}`` with a
        ``minisched.io/pool`` label, monotonically named so a replaced
        node never reuses a dead incarnation's identity."""
        seq = self._pool_seq.setdefault(pool, itertools.count(0))
        name = f"{pool}-{next(seq)}"
        labels = dict(kw.pop("labels", {}) or {})
        labels.setdefault("minisched.io/pool", pool)
        self.cluster.create_node(name, labels=labels, **kw)
        self.expected_nodes.add(name)
        self.count("nodes_added")
        self._d.record("create_node", f"{name} {_kw_detail(kw)}")
        return name

    def pool_nodes(self, pool: str) -> List[str]:
        """Live pool members in incarnation order ((len, name) sort puts
        numeric suffixes in birth order) — the deterministic iteration
        order every generator uses."""
        return sorted(
            (n.metadata.name for n in self.store.list("Node")
             if n.metadata.labels.get("minisched.io/pool") == pool),
            key=lambda n: (len(n), n))

    def node_exists(self, name: str) -> bool:
        try:
            self.store.get("Node", name)
            return True
        except NotFoundError:
            return False

    def cordon(self, name: str) -> None:
        self.cluster.cordon(name)
        self.count("cordons")
        self._d.record("cordon", name)

    def uncordon(self, name: str) -> None:
        self.cluster.uncordon(name)
        self.count("uncordons")
        self._d.record("uncordon", name)

    def update_node(self, name: str, **kw) -> None:
        self.cluster.update_node(name, **kw)
        self.count("node_updates")
        self._d.record("update_node", f"{name} {_kw_detail(kw)}")

    def delete_node(self, name: str, evict: bool = True) -> None:
        """Remove a node, evicting its pods first and SWEEPING after:
        ``store.bind_pods`` refuses bindings to missing nodes, so a bind
        that raced the eviction can only have committed BEFORE the
        delete — the post-delete sweep evicts exactly those, after which
        no pod can ever reference the dead incarnation (the
        node-controller GC kubernetes has and the reference lacks)."""
        if evict:
            self.evict_pods_on(name)
        try:
            self.store.delete("Node", name)
        except NotFoundError:
            return
        self.expected_nodes.discard(name)
        self.count("nodes_deleted")
        self._d.record("delete_node", name)
        if evict:
            # post-delete sweep: binds that landed between the eviction
            # scan and the delete (the store forbids any later ones)
            for p in sorted(self.store.list("Pod"), key=lambda p: p.key):
                if p.spec.node_name == name:
                    self._evict_one(p)

    # ---- observations --------------------------------------------------

    def pending_count(self) -> int:
        """Unbound pods — the queue-pressure signal autoscalers key on
        (store-derived, so pure mode observes it deterministically)."""
        return sum(1 for p in self.store.list("Pod")
                   if not p.spec.node_name)

    def pods_on(self, node_name: str) -> int:
        """Bound pods on a node (the autoscaler's utilization signal:
        only EMPTY nodes are scale-down candidates — draining a loaded
        node would just recreate its pods as fresh pressure)."""
        return sum(1 for p in self.store.list("Pod")
                   if p.spec.node_name == node_name)

    def bound_count(self) -> int:
        return sum(1 for p in self.store.list("Pod") if p.spec.node_name)


def _kw_detail(kw: dict) -> str:
    return ",".join(f"{k}={kw[k]}" for k in sorted(kw)
                    if not isinstance(kw[k], (dict, list)))


class LifecycleDriver:
    """The event loop. Construct over a (started or not) ``Cluster``,
    ``add()`` generators, ``add_invariant()`` / ``install_default_
    invariants()``, then ``run()``."""

    def __init__(self, cluster, *, seed: Optional[int] = None,
                 pace: float = 0.0, settle_s: float = 0.0,
                 max_steps: int = 200_000):
        self.cluster = cluster
        self.seed = seed_from_env() if seed is None else int(seed)
        self.pace = float(pace)
        self.settle_s = float(settle_s)
        self.max_steps = max_steps
        self.view = LifecycleView(self)
        self.events: List[LifecycleEvent] = []
        self.clock = 0.0
        self.steps = 0
        self.faulted_steps = 0
        self.invariant_checks = 0
        self._gens: List = []
        self._rngs: List[random.Random] = []
        self._invariants: List[Tuple[str, Callable]] = []
        self._budgets: Dict[str, DisruptionBudget] = {}
        self._current: Optional[str] = None

    # ---- composition ---------------------------------------------------

    def rng_for(self, name: str) -> random.Random:
        """Per-generator PRNG stream keyed by (seed, name) — adding or
        removing one generator never shifts another's draws (the
        faults.py per-gate-stream discipline)."""
        return random.Random((self.seed << 20)
                             ^ zlib.crc32(name.encode("utf-8")))

    def add(self, gen) -> None:
        self._gens.append(gen)
        self._rngs.append(self.rng_for(gen.name))

    def budget(self, pool: str, max_unavailable: int) -> DisruptionBudget:
        b = self._budgets.get(pool)
        if b is None:
            b = self._budgets[pool] = DisruptionBudget(pool, max_unavailable)
        return b

    def budgets(self) -> Dict[str, DisruptionBudget]:
        return dict(self._budgets)

    def add_invariant(self, name: str, fn: Callable) -> None:
        """``fn(view) -> list[str]`` — empty means the invariant holds.
        Checked after every driver step (and retried through the settle
        window in live mode before a violation raises)."""
        self._invariants.append((name, fn))

    def install_default_invariants(self) -> None:
        from .invariants import default_invariants

        for name, fn in default_invariants(self):
            self.add_invariant(name, fn)

    # ---- event recording ----------------------------------------------

    def record(self, verb: str, detail: str) -> None:
        ev = LifecycleEvent(self.clock, self._current or "-", verb, detail)
        self.events.append(ev)
        instant(f"lifecycle.{verb}", t=round(self.clock, 6),
                gen=ev.gen, detail=detail)
        # Per-generator attribution for the temporal-telemetry ring
        # (obs/timeseries): each timeline snapshot carries the delta of
        # these counters, so a reclamation wave is VISIBLE in the same
        # row where p99 moved. Disarmed: one attribute test.
        if ev.gen != "-":
            note_activity(ev.gen)

    def event_lines(self) -> List[str]:
        return [e.line() for e in self.events]

    def stream_digest(self) -> str:
        h = hashlib.sha256()
        for line in self.event_lines():
            h.update(line.encode("utf-8"))
            h.update(b"\n")
        return h.hexdigest()

    def state_digest(self) -> str:
        """Canonical hash of the final cluster state: the store snapshot
        minus the per-process nondeterminism (uids from the global
        counter, wall-clock stamps) and minus the async Event stream.
        In pure mode this is the determinism contract's second half."""
        snap = self.cluster.store.snapshot()
        snap["objects"].pop("Event", None)

        def scrub(v):
            if isinstance(v, dict):
                return {k: scrub(x) for k, x in v.items()
                        if k not in ("uid", "creation_timestamp",
                                     "scheduled_time")}
            if isinstance(v, list):
                return [scrub(x) for x in v]
            return v

        return hashlib.sha256(
            json.dumps(scrub(snap), sort_keys=True).encode()).hexdigest()

    # ---- the loop ------------------------------------------------------

    def run(self, until_s: Optional[float] = None) -> None:
        """Interleave every generator on the virtual clock until all are
        exhausted, ``until_s`` virtual seconds pass, or ``max_steps``.
        Invariants are checked after every step."""
        import heapq

        heap: List[tuple] = []
        for i, gen in enumerate(self._gens):
            env = _Env(self.view, self._rngs[i], self)
            heap.append((0.0, i, gen.run(env)))
        heapq.heapify(heap)
        while heap and self.steps < self.max_steps:
            t, idx, it = heapq.heappop(heap)
            if until_s is not None and t > until_s:
                break
            if self.pace > 0 and t > self.clock:
                time.sleep((t - self.clock) * self.pace)
            self.clock = max(self.clock, t)
            self._current = self._gens[idx].name
            try:
                verdict = FAULTS.hit("lifecycle")
            except FaultInjected:
                # A faulted orchestrator tick: the step did not run;
                # retry it shortly after (contained, counted).
                self.faulted_steps += 1
                heapq.heappush(heap, (t + 0.05, idx, it))
                self._current = None
                continue
            if verdict == "corrupt":
                # Deterministic schedule perturbation: burn one draw of
                # this generator's stream.
                self._rngs[idx].random()
            try:
                delay = next(it)
            except StopIteration:
                self._current = None
                continue
            self.steps += 1
            heapq.heappush(heap, (t + max(float(delay), 1e-6), idx, it))
            self._current = None
            self.check_invariants()
        self.check_invariants()

    def check_invariants(self) -> None:
        """Run every registered invariant; a non-empty result is retried
        through the settle window (live mode: the broadcaster commits
        Preempted events asynchronously, informers lag the store) and
        raises :class:`InvariantViolation` if it persists."""
        self.invariant_checks += 1
        for name, fn in self._invariants:
            viols = fn(self.view)
            if viols and self.settle_s > 0:
                deadline = time.monotonic() + self.settle_s
                while viols and time.monotonic() < deadline:
                    time.sleep(0.02)
                    viols = fn(self.view)
            if viols:
                # SLO-visible before the raise unwinds the run: the
                # sentinel's invariant_violations objective watches this
                # tag (threshold 0 — one confirmed violation burns).
                note_activity("invariant_violation", len(viols))
                # Journal + incident bundle BEFORE the raise unwinds:
                # the oracle's verdict is a terminal incident class and
                # the state explaining it is gone once the run tears
                # down. Engine surfaces ride along when the cluster
                # runs live.
                from ..obs import bundle as bundle_mod
                from ..obs.journal import note as jnote

                jnote("invariant.violation", invariant=name,
                      step=self.steps, t=round(self.clock, 6),
                      seed=self.seed, count=len(viols),
                      first=viols[0][:200])
                svc = getattr(self.cluster, "service", None)
                sched = svc.scheduler if svc is not None else None
                bundle_mod.capture(
                    "invariant_violation", scheduler=sched,
                    reason=f"[{name}] " + "; ".join(viols[:3]))
                raise InvariantViolation(
                    f"[{name}] after step #{self.steps} "
                    f"(t={self.clock:.3f}, seed={self.seed}): "
                    + "; ".join(viols[:5]))

    # ---- live-mode helpers ---------------------------------------------

    def settle(self, timeout: float = 30.0) -> bool:
        """Wait until every expected pod is settled — bound, or pending
        with recorded plugin attribution (the chaos-suite quiescence
        contract). Returns False on timeout."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            pods = self.cluster.store.list("Pod")
            if all(p.spec.node_name or p.status.unschedulable_plugins
                   for p in pods):
                return True
            time.sleep(0.05)
        return False


class _Env:
    """What a generator's ``run(env)`` sees: the ledger-tracked view,
    its own PRNG stream, and the driver (for the virtual clock)."""

    __slots__ = ("view", "rng", "driver")

    def __init__(self, view: LifecycleView, rng: random.Random,
                 driver: LifecycleDriver):
        self.view = view
        self.rng = rng
        self.driver = driver

    @property
    def clock(self) -> float:
        return self.driver.clock

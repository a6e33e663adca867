"""Lifecycle generator library — production-shaped workload dynamics.

Each generator is a small class with a ``name`` and a ``run(env)``
Python generator function: it mutates the cluster through the
ledger-tracked ``env.view`` and ``yield``s the virtual delay to its next
step (the driver interleaves all of them on one virtual clock and
checks invariants after every step). All randomness comes from
``env.rng`` — the generator's own seeded stream — so a composition is
deterministic per seed in pure mode, and every generator is reusable in
any mix.

Catalog (the trace-study staples):

  * :class:`PoissonArrivals` — diurnal/bursty pod arrival curves:
    a Poisson process whose rate is modulated by a sinusoid
    (``amplitude``/``period_s``), sampled by thinning against the peak
    rate so the draw count stays schedule-independent.
  * :class:`AutoscalerLoop` — a node pool growing under queue pressure
    and draining (cordon → grace → evict → delete) when idle.
  * :class:`ReclamationWave` — correlated spot/preemptible node
    deletions honoring a grace window: cordon the wave, wait, evict,
    delete, optionally create replacement capacity (fresh incarnation
    names — a reclaimed identity never returns).
  * :class:`RollingUpgrade` — serial node upgrades under a
    :class:`~.driver.DisruptionBudget`: acquire → cordon → grace →
    evict → relabel (the "upgrade") → uncordon → release; retries while
    the budget is contended, which is exactly what the adversarial
    overlap test measures.
  * :class:`TenantMix` — a weighted multi-tenant arrival mix with
    per-tenant priorities (sustained exercise for ``PodSpec.priority``
    and the preemption PostFilter) plus the controller-side reconcile
    loop that recreates preempted victims.
  * :class:`KillScheduler` / :class:`RestartScheduler` — control-plane
    failure injection for fleet runs (``MINISCHED_FLEET`` ≥ 2 or
    ``Cluster.start(fleet=N)``): crash one replica mid-workload (its
    lease is left to EXPIRE — the honest crash model) and optionally
    bring it back after a downtime window. The failover invariants
    (no_pod_lost, stable_bindings, lease_integrity) then certify the
    takeover end-to-end.
  * :class:`KillSteward` / :class:`RestartApiserver` — the
    self-governing fleet drills (``MINISCHED_FLEET_ELECT=1``,
    fleet/election.py): decapitate whichever replica currently holds
    the steward lease (a peer must claim the crown within one TTL and
    adopt the census exactly-once), and kill/revive the apiserver on
    the same port so every replica rides the outage out through the
    reattach + fresh-epoch re-claim path.
"""
from __future__ import annotations

import math
from collections import deque
from typing import Optional, Sequence, Tuple


class Generator:
    """Base: subclasses set ``self.name`` and implement ``run(env)``."""

    name = "generator"

    def run(self, env):  # pragma: no cover - interface
        raise NotImplementedError


def _weighted(rng, choices: Sequence[Tuple]) -> Tuple:
    """Deterministic weighted pick: choices are (payload..., weight)."""
    total = sum(c[-1] for c in choices)
    x = rng.random() * total
    for c in choices:
        x -= c[-1]
        if x <= 0:
            return c
    return choices[-1]


class PoissonArrivals(Generator):
    """Poisson pod arrivals with a sinusoidal (diurnal) rate curve.

    Thinning keeps the PRNG draw count independent of the acceptance
    pattern: inter-arrival gaps are sampled at the PEAK rate and each
    candidate is accepted with probability rate(t)/peak — so the stream
    stays bit-stable under parameter tweaks that keep the peak fixed.
    ``burst`` > 1 turns each accepted arrival into a small batch (the
    bursty variant)."""

    def __init__(self, name: str = "arrivals", *, rate_pps: float = 20.0,
                 duration_s: float = 10.0, amplitude: float = 0.0,
                 period_s: float = 4.0, burst: int = 1, cpu: int = 100,
                 prefix: str = "lc", namespace: str = "default",
                 priority_choices: Sequence[Tuple[int, float]] = ((0, 1.0),)):
        self.name = name
        self.rate = float(rate_pps)
        self.duration = float(duration_s)
        self.amplitude = max(0.0, min(1.0, float(amplitude)))
        self.period = float(period_s)
        self.burst = max(1, int(burst))
        self.cpu = cpu
        self.prefix = prefix
        self.namespace = namespace
        self.priority_choices = tuple(priority_choices)

    def run(self, env):
        rng, v = env.rng, env.view
        peak = self.rate * (1.0 + self.amplitude)
        t, i = 0.0, 0
        while t < self.duration:
            gap = rng.expovariate(peak)
            accept = rng.random()
            t += gap
            yield gap
            rate_t = self.rate * (1.0 + self.amplitude * math.sin(
                2.0 * math.pi * t / self.period))
            if accept * peak > rate_t:
                continue
            for _ in range(self.burst):
                prio, _w = _weighted(rng, self.priority_choices)
                v.create_pod(f"{self.prefix}-p{i}", namespace=self.namespace,
                             cpu=self.cpu, priority=prio)
                i += 1


class AutoscalerLoop(Generator):
    """Reactive node-pool autoscaler: grow under queue pressure, drain
    when idle. Scale-down is a full voluntary-disruption sequence —
    cordon, grace, evict, delete — optionally gated by a shared
    :class:`~.driver.DisruptionBudget` when the pool is also being
    upgraded/reclaimed."""

    def __init__(self, name: str = "autoscaler", *, pool: str = "as",
                 interval_s: float = 0.5, min_nodes: int = 2,
                 max_nodes: int = 10, scale_up_pending: int = 8,
                 step: int = 2, idle_rounds: int = 3, cpu: float = 4000,
                 drain_grace_s: float = 0.3, rounds: Optional[int] = None,
                 budget=None):
        self.name = name
        self.pool = pool
        self.interval = float(interval_s)
        self.min_nodes = int(min_nodes)
        self.max_nodes = int(max_nodes)
        self.scale_up_pending = int(scale_up_pending)
        self.step = max(1, int(step))
        self.idle_rounds = max(1, int(idle_rounds))
        self.cpu = cpu
        self.grace = float(drain_grace_s)
        self.rounds = rounds
        self.budget = budget

    def run(self, env):
        v = env.view
        for _ in range(self.min_nodes):
            v.create_pool_node(self.pool, cpu=self.cpu)
        idle, r = 0, 0
        while self.rounds is None or r < self.rounds:
            yield self.interval
            r += 1
            pending = v.pending_count()
            members = v.pool_nodes(self.pool)
            if (pending > self.scale_up_pending
                    and len(members) < self.max_nodes):
                v.count("autoscaler_scale_ups")
                for _ in range(min(self.step,
                                   self.max_nodes - len(members))):
                    v.create_pool_node(self.pool, cpu=self.cpu)
                idle = 0
                continue
            if pending == 0 and len(members) > self.min_nodes:
                idle += 1
                if idle >= self.idle_rounds:
                    # Only EMPTY nodes are candidates (utilization-based
                    # scale-down): draining a loaded member would just
                    # recreate its pods as fresh queue pressure and
                    # thrash against the scale-up arm.
                    empties = [n for n in members if v.pods_on(n) == 0]
                    if not empties:
                        continue  # stay armed; retry next round
                    target = empties[-1]  # newest empty first out
                    if self.budget is not None \
                            and not self.budget.acquire(target):
                        continue  # pool contended; retry next round
                    v.count("autoscaler_scale_downs")
                    v.cordon(target)
                    yield self.grace
                    v.delete_node(target)
                    if self.budget is not None:
                        self.budget.release(target)
                    idle = 0
            else:
                idle = 0


class ReclamationWave(Generator):
    """Correlated spot/preemptible reclamation: every ``interval_s`` a
    wave of ``wave_frac`` of the live pool is cordoned together, given
    ``grace_s`` of virtual grace (the cloud's termination notice), then
    evicted and deleted; ``replace=True`` creates fresh-incarnation
    replacement capacity (spot pools refill). A shared budget caps how
    much of the pool a wave may take at once — surplus targets are
    simply spared (denials counted)."""

    def __init__(self, name: str = "reclaim", *, pool: str,
                 interval_s: float = 1.0, wave_frac: float = 0.34,
                 grace_s: float = 0.3, waves: int = 3, replace: bool = True,
                 cpu: float = 4000, budget=None):
        self.name = name
        self.pool = pool
        self.interval = float(interval_s)
        self.wave_frac = float(wave_frac)
        self.grace = float(grace_s)
        self.waves = int(waves)
        self.replace = replace
        self.cpu = cpu
        self.budget = budget

    def run(self, env):
        rng, v = env.rng, env.view
        for _w in range(self.waves):
            yield self.interval
            live = v.pool_nodes(self.pool)
            if not live:
                continue
            k = max(1, int(len(live) * self.wave_frac))
            targets = sorted(rng.sample(live, min(k, len(live))))
            taken = []
            for n in targets:
                if self.budget is not None and not self.budget.acquire(n):
                    continue
                v.cordon(n)
                taken.append(n)
            v.count("reclamation_waves")
            yield self.grace
            for n in taken:
                v.delete_node(n)
                v.count("nodes_reclaimed")
                if self.budget is not None:
                    self.budget.release(n)
            if self.replace:
                for _ in taken:
                    v.create_pool_node(self.pool, cpu=self.cpu)


class RollingUpgrade(Generator):
    """Serial rolling upgrade of a pool under a max-unavailable budget:
    for each member (snapshot order) acquire the budget — retrying on
    contention — cordon, grace, evict, stamp the version label (the
    "upgrade"), uncordon, release. Nodes reclaimed mid-rollout are
    skipped (their replacement incarnations are born current)."""

    VERSION_LABEL = "minisched.io/os-version"

    def __init__(self, name: str = "upgrade", *, pool: str, budget,
                 version: str = "v2", grace_s: float = 0.3,
                 retry_s: float = 0.2, start_after_s: float = 0.0):
        self.name = name
        self.pool = pool
        self.budget = budget
        self.version = version
        self.grace = float(grace_s)
        self.retry = float(retry_s)
        self.start_after = float(start_after_s)

    def run(self, env):
        v = env.view
        if self.start_after:
            yield self.start_after
        todo = deque(v.pool_nodes(self.pool))
        while todo:
            n = todo[0]
            if not v.node_exists(n):
                todo.popleft()  # reclaimed mid-rollout
                continue
            if not self.budget.acquire(n):
                yield self.retry
                continue
            todo.popleft()
            v.cordon(n)
            yield self.grace
            if v.node_exists(n):
                v.evict_pods_on(n)
                v.update_node(n, labels={self.VERSION_LABEL: self.version})
                v.uncordon(n)
                v.count("nodes_upgraded")
            self.budget.release(n)
            yield 1e-3  # hand the clock over between members


def _fleet_of(env):
    """The FleetSupervisor behind this cluster, or None when the run is
    single-engine (the generators degrade to no-ops so a mix that
    includes them stays reusable outside fleet mode)."""
    svc = getattr(env.view.cluster, "service", None)
    return getattr(svc, "fleet", None) if svc is not None else None


class KillScheduler(Generator):
    """Crash one fleet replica mid-workload. The kill is the CRASH
    model: the engine stops and the replica forgets its leases locally,
    but the store's Lease objects are left untouched — a peer may only
    claim the dead replica's shards after the TTL expires, exactly as a
    dead process leaves the world. Pods the victim had queued are
    re-derived from the store by the claimant's takeover sweep, so the
    no_pod_lost / stable_bindings oracle certifies the failover.

    ``crash=True`` hardens the kill: an in-process replica is abandoned
    mid-tranche (staged device-loop slots never commit, leaving debris
    for the adopter's takeover sweep); a process replica is SIGKILLed —
    there the flag is implicit, every proc kill is a crash."""

    def __init__(self, name: str = "kill-sched", *, replica: str = "r1",
                 after_s: float = 1.0, crash: bool = False):
        self.name = name
        self.replica = replica
        self.after = float(after_s)
        self.crash = bool(crash)

    def run(self, env):
        yield self.after
        fleet = _fleet_of(env)
        if fleet is None:
            return  # single-engine run: nothing to kill
        if fleet.kill(self.replica, crash=self.crash):
            env.view.count("scheduler_kills")


class RestartScheduler(Generator):
    """Crash one replica, wait out a downtime window, then bring a
    fresh incarnation back under the same id. The restarted replica
    rejoins with an EMPTY shard set and re-earns ownership through the
    lease scan — shards its peers claimed during the outage stay theirs
    until those leases lapse (no failback storm)."""

    def __init__(self, name: str = "restart-sched", *, replica: str = "r1",
                 after_s: float = 1.0, downtime_s: float = 2.0):
        self.name = name
        self.replica = replica
        self.after = float(after_s)
        self.downtime = float(downtime_s)

    def run(self, env):
        yield self.after
        fleet = _fleet_of(env)
        if fleet is None:
            return
        if fleet.kill(self.replica):
            env.view.count("scheduler_kills")
        yield self.downtime
        if fleet.restart(self.replica):
            env.view.count("scheduler_restarts")


class KillSteward(Generator):
    """Decapitate the self-governing fleet: resolve the CURRENT steward
    from the store's election lease (fleet/election.py) and SIGKILL that
    replica mid-workload. No supervisor exists to notice — a surviving
    peer must claim the steward lease within one TTL, adopt the census
    ledger, and respawn the victim exactly once; the steward_uniqueness
    / lease_integrity / no_pod_lost oracle certifies the succession.

    Resolution is store-truth only (the generator holds no process
    handles): the steward Lease names the victim, its ReplicaStatus
    heartbeat carries the pid. Degrades to a no-op outside elected
    process-fleet runs (no steward lease, or no live pid)."""

    STEWARD_NAME = "steward"

    def __init__(self, name: str = "kill-steward", *, after_s: float = 1.0):
        self.name = name
        self.after = float(after_s)

    def run(self, env):
        yield self.after
        store = env.view.store
        try:
            lease = store.get("Lease", self.STEWARD_NAME)
        except Exception:
            return  # no election running: nothing to decapitate
        rid = lease.holder
        if not rid:
            return
        fleet = _fleet_of(env)
        if fleet is not None and hasattr(fleet, "kill"):
            if fleet.kill(rid):
                env.view.count("steward_kills")
            return
        # Supervisor-less path: the heartbeat record is the only pid map.
        try:
            st = store.get("ReplicaStatus", f"replica-{rid}")
        except Exception:
            return
        pid = int(getattr(st, "pid", 0) or 0)
        if pid <= 1:
            return
        import os
        import signal
        try:
            os.kill(pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            return
        env.view.count("steward_kills")


class RestartApiserver(Generator):
    """Kill the control plane out from under the fleet, then revive it
    on the SAME port after an outage window — the ride-through drill.
    Every replica's RemoteStore must declare the outage, reattach on
    revival, and re-earn its shards through a fresh epoch; the
    no_pod_lost / stable_bindings oracle certifies that the staged work
    reconciled against store truth with nothing lost or doubly bound.

    ``server`` is the live APIServer handle or a zero-arg getter for it
    (the revived instance replaces it via ``on_restart`` so later
    generators see the fresh handle). The store OBJECT survives — this
    models an apiserver crash in front of durable etcd, not data loss.
    Degrades to a no-op when no handle is supplied."""

    def __init__(self, name: str = "restart-apiserver", *,
                 server=None, after_s: float = 1.0,
                 outage_s: float = 2.0, on_restart=None):
        self.name = name
        self.server = server
        self.after = float(after_s)
        self.outage = float(outage_s)
        self.on_restart = on_restart

    def run(self, env):
        yield self.after
        srv = self.server() if callable(self.server) else self.server
        if srv is None:
            return
        port, backing = srv.port, srv.store
        srv.shutdown()
        env.view.count("apiserver_outages")
        yield self.outage
        from ..apiserver.server import APIServer

        revived = APIServer(backing, port=port).start()
        env.view.count("apiserver_revivals")
        if self.on_restart is not None:
            self.on_restart(revived)


class TenantMix(Generator):
    """Weighted multi-tenant arrivals with per-tenant priorities plus
    the preemption reconcile loop. ``tenants`` is a sequence of
    (label, priority, weight); every accepted arrival draws a tenant,
    and every tick also recreates any preempted victims the invariant
    layer has attributed (the ReplicaSet-controller half of the
    preemption contract — victims are deleted, replacements re-queue
    at their tenant's priority)."""

    def __init__(self, name: str = "tenants", *,
                 tenants: Sequence[Tuple[str, int, float]] = (
                     ("gold", 100, 0.2), ("silver", 10, 0.3),
                     ("best-effort", 0, 0.5)),
                 rate_pps: float = 20.0, duration_s: float = 6.0,
                 cpu: int = 100, prefix: str = "tm"):
        self.name = name
        self.tenants = tuple(tenants)
        self.rate = float(rate_pps)
        self.duration = float(duration_s)
        self.cpu = cpu
        self.prefix = prefix

    def run(self, env):
        rng, v = env.rng, env.view
        t, i = 0.0, 0
        while t < self.duration:
            gap = rng.expovariate(self.rate)
            t += gap
            yield gap
            tenant, prio, _w = _weighted(rng, self.tenants)
            v.create_pod(f"{self.prefix}-{tenant}-{i}", cpu=self.cpu,
                         priority=prio,
                         labels={"minisched.io/tenant": tenant})
            i += 1
            v.reconcile_preempted()

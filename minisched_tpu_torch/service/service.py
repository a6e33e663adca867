"""Scheduler lifecycle service.

Rebuild of reference scheduler/scheduler.go: NewSchedulerService (:36),
StartScheduler (:50-80: informers + event broadcaster + the scheduler +
start informers + go Run), RestartScheduler (:40-47: shutdown + start
with the retained config), ShutdownScheduler (:82-87) and
GetSchedulerConfig (:89). With ``SchedulerConfig.explain`` the service
also runs the result store (``result_store``), which publishes every
pod's per-plugin verdicts and scores as annotations.

Multi-profile: ``start_scheduler`` also takes a
``SchedulerConfiguration`` or a list of Profiles. Each profile gets its
own engine, and pods select one with ``spec.scheduler_name`` (reference
KubeSchedulerProfile semantics, scheduler.go:97-142). Every engine shares
one cluster state over the one store, so capacity accounting stays
consistent across profiles.

Replicated fleet: ``start_scheduler(fleet=N)`` (or ``MINISCHED_FLEET``)
runs N engine replicas of one profile in this process, each with its own
cluster state, pods partitioned by shard leases and failed over by the
``fleet.supervisor.FleetSupervisor``. ``start_scheduler(fleet_proc=N)``
(or ``MINISCHED_FLEET_PROC``) runs N replica PROCESSES instead, each an
engine of the port over ``RemoteStore`` on the device the config names,
under ``fleet.procfleet.ProcFleetSupervisor``; the service serves an
in-process store to them over its own API server.

Fused multi-tenant arbitration: ``TenantFusionCoordinator`` serves T
virtual clusters (``Tenant``: a store each) from one serve thread, one
fused dispatch per compatible group of tenants a round
(``MINISCHED_TENANTS_FUSE``, ``tenants_fuse_from_env``).
"""
from __future__ import annotations

import dataclasses
import logging
import os
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Union

from ..config import SchedulerConfig
from ..engine.clusterstate import SharedClusterState
from ..engine.queue import bucket_major_quotas
from ..engine.scheduler import Scheduler
from ..explain import ResultStore
from ..faults import FaultWorkerDeath
from ..fleet.shardmap import (fleet_from_env, fleet_proc_from_env,
                              shards_from_env)
from ..fleet.supervisor import FleetSupervisor
from ..state.informer import ResourceEventHandlers
from .config import SchedulerConfiguration
from .defaultconfig import Profile, default_scheduler_profile

log = logging.getLogger(__name__)

ProfileSpec = Union[Profile, Sequence[Profile], SchedulerConfiguration, None]


class SchedulerService:
    def __init__(self, store, *, checkpoint_path: Optional[str] = None,
                 checkpoint_interval_s: float = 30.0):
        """``checkpoint_path`` wires the etcd-durability analog into the
        service lifecycle (reference: state persists in etcd,
        k8sapiserver/k8sapiserver.go:93-105): the store is checkpointed on
        an interval while the scheduler runs and once more on shutdown;
        boot the store with state.persistence.open_or_restore to resume
        after a restart. In-process stores only: a RemoteStore's
        durability belongs to its server."""
        self._store = store
        self._scheds: Dict[str, Scheduler] = {}
        self._shared_state: Optional[SharedClusterState] = None
        self._profiles: List[Profile] = []
        self._multi = False
        self._config: Optional[SchedulerConfig] = None
        # The explain-mode result store of the running engines, else None.
        self.result_store: Optional[ResultStore] = None
        # The replicated fleet (fleet/supervisor.py) in place of the
        # profile engines, else None; single-profile only.
        self._fleet = None
        self._fleet_n = 0
        # The process fleet (fleet/procfleet.py): N replica PROCESSES
        # over RemoteStore; the service owns the API server they dial
        # when its store is in-process.
        self._fleet_proc_n = 0
        self._proc_api = None
        # RemoteStore has a snapshot() too (the /snapshot verb), so the
        # check is the checkpointer's whole surface: resource_version()
        # is the store-local half a RemoteStore lacks.
        if checkpoint_path and not (hasattr(store, "snapshot")
                                    and hasattr(store, "resource_version")):
            raise ValueError(
                "checkpoint_path requires an in-process ClusterStore; "
                "remote stores persist on the serving side")
        self._checkpoint_path = checkpoint_path
        self._checkpoint_interval_s = checkpoint_interval_s
        self._checkpointer = None

    @property
    def scheduler(self) -> Optional[Scheduler]:
        """The first (or only) running engine, or None; in a fleet, the
        first live replica's engine."""
        if self._fleet is not None:
            return self._fleet.scheduler
        return next(iter(self._scheds.values()), None)

    @property
    def schedulers(self) -> Dict[str, Scheduler]:
        """Profile name to engine; in a fleet, replica id to engine for
        the live replicas."""
        if self._fleet is not None:
            return self._fleet.engines()
        return dict(self._scheds)

    @property
    def fleet(self):
        """The FleetSupervisor when a fleet runs, else None (the
        lifecycle kill and restart generators reach the fleet here)."""
        return self._fleet

    def metrics(self) -> Dict[str, float]:
        """Engine cycle metrics across every profile, flat for one
        /metrics scrape (``APIServer.metrics_providers``): a
        single-profile service exposes the engine's keys unprefixed; a
        MULTI-profile configuration prefixes each key with the profile
        name. The prefix follows the configuration's style (the bit that
        also decides pod routing), not the engine count, so a one-profile
        multi-config keeps its names when a second profile joins. The
        engine's non-numeric diagnostics (batch_sizes, last_shapes,
        histograms) stay on ``Scheduler.metrics()``."""

        def numeric(m: Dict) -> Dict[str, float]:
            return {k: v for k, v in m.items()
                    if isinstance(v, (int, float)) and not isinstance(v, bool)}

        if self._fleet is not None:
            # The counters summed over the live replicas, with the lease
            # counters and the fleet gauges.
            return self._fleet.metrics()
        scheds = self.schedulers
        if not scheds:
            return {}
        if not self._multi:
            return numeric(next(iter(scheds.values())).metrics())
        out: Dict[str, float] = {}
        for name, engine in scheds.items():
            for k, v in numeric(engine.metrics()).items():
                out[f"{name}_{k}"] = v
        return out

    def metrics_histograms(self) -> Dict[str, dict]:
        """Per-pod lifecycle histogram snapshots (bounds/counts/sum/count)
        across every profile, keyed as :meth:`metrics` keys them: the
        ``APIServer.histogram_providers`` feed for the native Prometheus
        histogram exposition. A fleet merges its live replicas'."""
        if self._fleet is not None:
            return self._fleet.histograms()
        scheds = self.schedulers
        if not scheds:
            return {}
        if not self._multi:
            m = next(iter(scheds.values())).metrics()
            return dict(m.get("histograms", {}))
        out: Dict[str, dict] = {}
        for name, engine in scheds.items():
            for k, v in engine.metrics().get("histograms", {}).items():
                out[f"{name}_{k}"] = v
        return out

    def admission_reject_reason(self) -> Optional[str]:
        """The API server's overload admission provider
        (``APIServer.admission_providers``): the first engine whose
        overload controller is at or past its HTTP-reject rung gives the
        typed 429 reason; None admits."""
        for engine in self.schedulers.values():
            reason = engine.overload_reject_reason()
            if reason:
                return reason
        return None

    def timeline(self, since: int = 0) -> Dict[str, dict]:
        """Per-profile timeline documents (the ``GET /timeline``
        payload): profile name to ``Scheduler.timeline(since)``. Always
        keyed by profile name; each profile's row cursor is its own, so a
        multi-profile scraper polls one profile per request
        (``?profile=<name>&since=<seq>``)."""
        return {name: engine.timeline(since)
                for name, engine in self.schedulers.items()}

    def journal(self, since: int = 0) -> Dict:
        """The ``GET /journal`` payload: the process-wide decision
        journal, one causal log for every profile engine, each event
        tagged with its profile. Empty but valid with MINISCHED_JOURNAL
        unset. Under a process fleet the supervisor's merged stream of
        every replica process answers instead (source-tagged,
        re-sequenced), so one ``GET /journal`` narrates the whole
        fleet."""
        if self._fleet is not None and hasattr(self._fleet, "journal"):
            return self._fleet.journal(since)
        from ..obs.journal import JOURNAL

        return JOURNAL.to_doc(since)

    def provenance(self, pod_key: str):
        """The ``GET /provenance/<pod>`` record: the first profile engine
        holding a decision-provenance record for the pod answers
        (profiles share no pods, replicas no shards); None when none
        does. A process fleet fans the lookup out to the replicas'
        sidecars and names the one that served it."""
        if self._fleet is not None:
            return self._fleet.provenance(pod_key)
        for engine in self.schedulers.values():
            rec = engine.provenance(pod_key)
            if rec is not None:
                return rec
        return None

    def start_scheduler(self, profile: ProfileSpec = None,
                        config: Optional[SchedulerConfig] = None,
                        fleet: Optional[int] = None,
                        fleet_proc: Optional[int] = None
                        ) -> Optional[Scheduler]:
        """Start one engine per profile (one profile, a list, or a
        ``SchedulerConfiguration``, whose non-default
        ``percentage_of_nodes_to_score`` carries into the config).
        ``fleet`` at 2 or more (None reads ``MINISCHED_FLEET``; 0 and 1
        are off) runs that many replicated engines of one profile with
        shard leases instead (fleet/supervisor.py). ``fleet_proc`` at 2
        or more (None reads ``MINISCHED_FLEET_PROC``) runs that many
        replica PROCESSES of one profile over RemoteStore instead
        (fleet/procfleet.py) and wins over ``fleet``: there is then no
        engine in this process, and this returns None (the fleet's
        surfaces are on :attr:`fleet`). Returns the first engine."""
        if self._scheds or self._fleet is not None:
            raise RuntimeError("scheduler already running")
        n_proc = (int(fleet_proc) if fleet_proc is not None
                  else fleet_proc_from_env())
        n_fleet = int(fleet) if fleet is not None else fleet_from_env()
        if isinstance(profile, SchedulerConfiguration):
            profiles, self._multi = list(profile.profiles), True
            pct = profile.percentage_of_nodes_to_score
            if (config is not None
                    and pct != type(profile)().percentage_of_nodes_to_score):
                config = dataclasses.replace(
                    config, percentage_of_nodes_to_score=pct)
            elif config is None and pct:
                config = SchedulerConfig(percentage_of_nodes_to_score=pct)
        elif isinstance(profile, (list, tuple)):
            profiles, self._multi = list(profile), True
        else:
            profiles = [profile or default_scheduler_profile()]
            self._multi = False
        if not profiles:
            profiles = [default_scheduler_profile()]
        names = [p.name for p in profiles]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate profile names: {names}")
        if max(n_fleet, n_proc) >= 2 and self._multi:
            raise ValueError(
                "fleet mode is single-profile: profiles partition pods by "
                "scheduler_name, fleet shards by pod-key hash; one routing "
                "scheme at a time")
        self._profiles = profiles
        self._config = config or SchedulerConfig()
        if n_proc >= 2:
            return self._start_proc_fleet(profiles[0], n_proc)
        if n_fleet >= 2:
            return self._start_fleet(profiles[0], n_fleet)
        self._fleet_n = 0
        # Build every plugin set before any engine starts, so a bad later
        # profile (unknown plugin, bad args) leaves nothing half-started.
        built = [(p, p.build()) for p in profiles]
        # ONE cluster state (feature cache + informer set) for every
        # profile engine (reference: one scheduler, many profiles):
        # per-profile caches would multiply the node state and let two
        # profiles jointly over-commit a node. Every engine registers
        # before the first start() syncs the informers.
        shared = self._shared_state = SharedClusterState(self._store)
        recorder = None
        if self._config.explain:
            # Annotations flush on the store's worker, off the scheduling
            # thread (the reference flushes on informer events).
            self.result_store = recorder = ResultStore(self._store,
                                                       async_flush=True)
            # Pod updates re-drive a flush that ran out of CAS retries
            # (results land on the pod's next update); a deleted pod's
            # records are evicted.
            shared.informer_factory.add_handlers(
                "Pod", ResourceEventHandlers(
                    on_update=lambda old, new: recorder.on_pod_event(
                        new.key),
                    on_update_many=lambda pairs: recorder.on_pod_events(
                        [new.key for _old, new in pairs]),
                    on_delete=lambda pod: recorder.delete_data(pod.key)))
        try:
            for p, plugin_set in built:
                # A multi-profile engine takes only the pods naming its
                # profile; a single profile takes every pod.
                self._scheds[p.name] = Scheduler(
                    self._store, plugin_set, self._config,
                    recorder=recorder,
                    scheduler_names={p.name} if self._multi else None,
                    shared=shared, profile=p.name)
            for sched in self._scheds.values():
                sched.start()
        except BaseException:
            self.shutdown_scheduler()
            raise
        if self._checkpoint_path:
            from ..state.persistence import Checkpointer

            self._checkpointer = Checkpointer(
                self._store, self._checkpoint_path,
                interval_s=self._checkpoint_interval_s)
        sched = self.scheduler
        cfg = sched.config
        log.info("scheduler started (profiles=%s, device=%s, pipeline=%s, "
                 "device_resident=%s, shortlist=%s k=%d)", names,
                 sched.device, cfg.pipeline, cfg.device_resident,
                 cfg.shortlist, cfg.shortlist_k)
        return sched

    def _start_fleet(self, p: Profile, n: int) -> Optional[Scheduler]:
        """N replicated engines, each with its OWN cluster state
        (informers and feature cache) over the one store: independent
        optimistic views whose capacity races resolve at the store's bind
        CAS, under a FleetSupervisor driving the shard leases. The
        checkpointer (when configured) comes first, so a takeover can
        persist the new ownership at once. In explain mode the replicas
        share one result store."""
        if self._checkpoint_path:
            from ..state.persistence import Checkpointer

            self._checkpointer = Checkpointer(
                self._store, self._checkpoint_path,
                interval_s=self._checkpoint_interval_s)
        recorder = None
        if self._config.explain:
            self.result_store = recorder = ResultStore(self._store,
                                                       async_flush=True)

        def factory(rid: str) -> Scheduler:
            return Scheduler(self._store, p.build(), self._config,
                             recorder=recorder, profile=p.name, replica=rid)

        self._fleet = FleetSupervisor(
            self._store, engine_factory=factory, replicas=n,
            n_shards=shards_from_env(n), checkpointer=self._checkpointer)
        self._fleet_n = n
        try:
            self._fleet.start()
        except BaseException:
            self.shutdown_scheduler()
            raise
        log.info("scheduler fleet started (%d replicas, profile=%s, "
                 "%d shards, device=%s)", n, p.name, self._fleet.n_shards,
                 self.scheduler.device)
        return self.scheduler

    def _start_proc_fleet(self, p: Profile, n: int) -> None:
        """N replica processes, each an engine of this package over
        RemoteStore on the device the config names. With an in-process
        store the service serves it over its own API server, which the
        replicas dial; a RemoteStore's address is dialed directly (its
        serving side already exists). On a CUDA config the supervisor
        builds the kernels once before it spawns."""
        from ..apiserver.server import APIServer
        from ..fleet.procfleet import ProcFleetSupervisor, rebalance_from_env

        if self._checkpoint_path:
            from ..state.persistence import Checkpointer

            self._checkpointer = Checkpointer(
                self._store, self._checkpoint_path,
                interval_s=self._checkpoint_interval_s)
        addr = getattr(self._store, "address", None)
        if addr is None or hasattr(self._store, "resource_version"):
            self._proc_api = APIServer(self._store).start()
            addr = self._proc_api.address
        self._fleet = ProcFleetSupervisor(
            self._store, addr, replicas=n, n_shards=shards_from_env(n),
            config_overrides=dataclasses.asdict(self._config), profile=p,
            rebalance=rebalance_from_env())
        self._fleet_proc_n = n
        try:
            self._fleet.start()
        except BaseException:
            self.shutdown_scheduler()
            raise
        log.info("process fleet started (%d replica processes, profile=%s, "
                 "%d shards, device=%s, apiserver=%s)", n, p.name,
                 self._fleet.n_shards, self._config.platform or "cuda:0",
                 addr)
        return None

    def shutdown_scheduler(self) -> None:
        if self._fleet is not None:
            self._fleet.shutdown()
            self._fleet = None
            log.info("scheduler fleet shut down")
        if self._proc_api is not None:
            self._proc_api.shutdown()
            self._proc_api = None
        for name, sched in list(self._scheds.items()):
            sched.shutdown()
            log.info("scheduler %s shut down", name)
        self._scheds.clear()
        if self._shared_state is not None:
            self._shared_state.shutdown()
            self._shared_state = None
        if self._checkpointer is not None:
            # Final checkpoint AFTER the engines stop: every in-flight
            # bind has committed, so the snapshot is the state a restart
            # resumes from.
            self._checkpointer.close()
            self._checkpointer = None

    def restart_scheduler(self) -> Optional[Scheduler]:
        """Shutdown, then start with the retained profiles and config
        (reference RestartScheduler, scheduler.go:40-47). Queue and cache
        state is rebuilt from the store, as in the reference."""
        profiles, config, multi = self._profiles, self._config, self._multi
        fleet_n, proc_n = self._fleet_n, self._fleet_proc_n
        self.shutdown_scheduler()
        self._profiles, self._config = [], None
        self._fleet_proc_n = 0
        spec: ProfileSpec = profiles if multi else (profiles[0] if profiles
                                                    else None)
        return self.start_scheduler(spec, config, fleet=fleet_n or None,
                                    fleet_proc=proc_n or None)

    def get_scheduler_profile(self) -> Optional[Profile]:
        """reference GetSchedulerConfig (scheduler.go:89-91)."""
        return self._profiles[0] if self._profiles else None

    def get_scheduler_profiles(self) -> List[Profile]:
        return list(self._profiles)


# ---- fused multi-tenant arbitration ----------------------------------------


def tenants_fuse_from_env() -> int:
    """``MINISCHED_TENANTS_FUSE``: the fused-tranche width cap (how many
    tenants one fused dispatch may serve). 0, 1, unset or unparsable:
    fusion off; the coordinator then steps each tenant in turn, the
    baseline the fused mode must equal."""
    try:
        return int(os.environ.get("MINISCHED_TENANTS_FUSE", "0") or 0)
    except ValueError:
        return 0


@dataclass
class Tenant:
    """One virtual cluster of a fused multi-tenant group: its OWN
    ClusterStore (tenants share no objects), its fair-share weight in
    the round's batch-slot gather, and an optional plugin profile."""

    name: str
    store: object
    weight: float = 1.0
    profile: Optional[Profile] = None


class TenantFusionCoordinator:
    """Serve T virtual clusters from ONE arbitration dispatch per round.

    Each tenant has a private engine (its own store, cluster state and
    feature cache, so its sparse deltas reach its own slabs; its own
    queue; its own overload controller, named for the tenant, so
    per-profile shed budgets hold per tenant) but no run thread: the
    coordinator drives every engine's prepare, resolve and commit from
    one serve thread, with a ``TenantCacheMux`` (encode/cache.py)
    installed at the dispatch seam when fusion is on. The engines run on
    the device ``SchedulerConfig.platform`` names, ``cuda:0`` by
    default (which raises without a card).

    One round (``serve_round``):

      1. Tenants group by the pod-pad bucket of their pending demand,
         and ``max_batch_size`` slots split by tenant weight inside each
         group (engine/queue.bucket_major_quotas): a hot tenant cannot
         starve its group's fused slot, and a small tenant never pads to
         a large one's bucket.
      2. Each tenant pops its quota; ``mux.round_pods`` is set per group
         to the group's common pod bucket, so its ragged batches pad to
         one shape with invalid rows.
      3. Each engine's prepare runs: a fusable batch SUBMITS its staged
         inputs to the mux (an index-armed engine its repaired (C,N)
         slab beside them); any other batch (gangs, nominations, a
         degraded rung, sampling, explain, mesh, spread) dispatches
         solo inside prepare.
      4. ``mux.dispatch()`` runs one fused step per group and hands each
         lane its decision.
      5. Resolve and commit per tenant, in tenant order, each through
         its engine's own machinery; a lane's resolve fault engages only
         that engine's supervised retry.

    With ``fuse < 2`` no mux is installed and the same loop runs each
    tenant's batch through its own full dispatch: the sequential
    baseline. Decisions are equal in the two modes; only the dispatch
    and fetch counts differ.
    """

    def __init__(self, tenants: Sequence[Tenant],
                 config: Optional[SchedulerConfig] = None,
                 fuse: Optional[int] = None):
        from ..encode.cache import TenantCacheMux

        if fuse is None:
            fuse = tenants_fuse_from_env()
        self.fuse = max(0, int(fuse))
        self.fused = self.fuse >= 2
        names = [t.name for t in tenants]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate tenant names: {names}")
        if not tenants:
            raise ValueError("at least one tenant required")
        self._tenants = list(tenants)
        self._config = config or SchedulerConfig()
        self._weights = [float(t.weight) for t in self._tenants]
        self.mux = TenantCacheMux() if self.fused else None
        if self.mux is not None:
            self.mux.max_lanes = self.fuse
        self._engines: Dict[str, Scheduler] = {}
        for t in self._tenants:
            pset = (t.profile or default_scheduler_profile()).build()
            eng = Scheduler(t.store, pset, self._config, profile=t.name)
            if self.mux is not None:
                eng._tenant_mux = self.mux
            self._engines[t.name] = eng
        self._rounds = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @property
    def engines(self) -> Dict[str, Scheduler]:
        return dict(self._engines)

    def engine(self, name: str) -> Scheduler:
        return self._engines[name]

    def store(self, name: str):
        for t in self._tenants:
            if t.name == name:
                return t.store
        raise KeyError(name)

    # ---- lifecycle ------------------------------------------------------

    def start(self) -> None:
        """Sync every tenant's informers, then start ONE serve thread.
        No engine gets its own run loop (``Scheduler.start`` is not
        called): the coordinator sequences the phases, which is what lets
        a round's prepares meet at the mux."""
        for eng in self._engines.values():
            eng._shared.ensure_started()
        self._thread = threading.Thread(target=self._serve, daemon=True,
                                        name="tenant-coordinator")
        self._thread.start()
        log.info("tenant coordinator started (%d tenants, fuse=%d)",
                 len(self._tenants), self.fuse)

    def shutdown(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        for eng in self._engines.values():
            eng.shutdown()

    def _serve(self) -> None:
        while not self._stop.is_set():
            try:
                served = self.serve_round()
            except Exception:
                log.exception("tenant round failed")
                served = False
            if not served:
                self._stop.wait(0.01)

    # ---- one fused round ------------------------------------------------

    def serve_round(self) -> bool:
        """Drive one coordinated round across every tenant; False when no
        tenant had work to pop. Public so that a caller can step rounds
        without the serve thread (tests and the chip check do, with
        every pod in the stores first, so that each round's batches do
        not depend on timing).

        Tenants group by the pod bucket their demand serves at, and the
        slots split per group (engine/queue.bucket_major_quotas); each
        group's prepares run at the group's common pad
        (``mux.round_pods``), then ONE ``mux.dispatch()`` fires every
        group's fused tranche. The sequential coordinator walks the same
        groups and quotas, so both modes pop the same pods a round."""
        from ..encode.cache import step_bucket

        engines = [self._engines[t.name] for t in self._tenants]
        demands = [eng.queue.pending_count() for eng in engines]
        if not any(demands):
            return False
        cap = self._config.max_batch_size
        buckets = [step_bucket(min(d, cap), self._config.pod_bucket_min)
                   if d else 0 for d in demands]
        lanes = []
        for _bucket, idxs, quotas in bucket_major_quotas(
                demands, self._weights, cap, buckets):
            work = []
            for i, quota in zip(idxs, quotas):
                if quota <= 0:
                    continue
                batch = engines[i].queue.pop_batch(quota, timeout=0.05)
                if batch:
                    work.append((engines[i], batch))
            if not work:
                continue
            if self.mux is not None:
                # The group's common pod pad, so its stacked lanes are
                # rectangular; another group's pad differs, and its lanes
                # group apart at the mux by shape.
                self.mux.round_pods = step_bucket(
                    max(len(b) for _eng, b in work),
                    self._config.pod_bucket_min)
            for eng, batch in work:
                lanes.append((eng, eng._prepare_batch(batch)))
        if not lanes:
            return False
        if self.mux is not None:
            self.mux.dispatch()
        for eng, b in lanes:
            try:
                eng._resolve_batch(b)
            except Exception:
                # Per-lane containment, the engine's own idiom: a resolve
                # fault (e.g. the index cross-check's EngineDesync on a
                # scribbled fused slab) engages THAT engine's supervised
                # retry while the round's other tenants settle.
                log.exception("tenant lane resolve failed; engaging "
                              "that engine's supervisor")
                eng._supervised_retry(b.batch, b)
                continue
            try:
                eng._commit_batch(b)
            except FaultWorkerDeath:
                # As the engine's synchronous cycle: requeue the flush
                # tranche and keep the coordinator alive.
                for qpi, _plugins, _msg, _retry in b.failures:
                    eng.queue.requeue_backoff(qpi)
        self._rounds += 1
        return True

    # ---- observability --------------------------------------------------

    def metrics(self) -> Dict[str, float]:
        """Tenant-prefixed engine metrics, the mux's fusion ledger, and
        the cross-tenant dispatch and fetch totals the fused and the
        sequential modes are compared by."""
        out: Dict[str, float] = {}
        total_disp = 0.0
        total_fetch = 0.0
        for name, eng in self._engines.items():
            m = eng.metrics()
            for k, v in m.items():
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    out[f"{name}_{k}"] = v
            total_disp += m.get("steps_dispatched", 0)
            total_fetch += m.get("decision_fetches", 0)
        if self.mux is not None:
            out.update(self.mux.counters)
            total_disp += self.mux.counters["tenant_dispatches"]
            total_fetch += self.mux.counters["tenant_fetches"]
        out["steps_dispatched_total"] = total_disp
        out["decision_fetches_total"] = total_fetch
        out["tenant_rounds_served"] = self._rounds
        return out

    def provenance(self, pod_key: str):
        """The first tenant engine holding a record answers (tenants
        share no pods)."""
        for eng in self._engines.values():
            rec = eng.provenance(pod_key)
            if rec is not None:
                return rec
        return None

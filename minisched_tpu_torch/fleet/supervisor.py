"""Fleet supervisor: N engine replicas, one store, lease-based failover.

Construction model: the caller supplies ``engine_factory(replica_id) ->
Scheduler`` — each call must return an UNSTARTED engine with its own
private cluster state (``shared=None``) and ``replica=replica_id``, so
every replica runs its own informers and feature cache against the one
shared store (independent optimistic views, the Omega model; capacity
races resolve at the store's bind CAS, counted in ``bind_conflicts``).

Ownership: ``n_shards`` hash shards (shardmap.py), initially dealt
round-robin (shard i → replica i mod N) and claimed through per-shard
Lease objects BEFORE the engines start, so each engine's informer sync
only gathers its own shard. One supervisor tick thread (period ≈ TTL/4)
then drives the whole lease protocol deterministically:

  1. every live replica renews its held leases (``lease`` fault gate);
  2. shards whose lease a replica LOST are handed off —
     ``engine.release_shards`` drops the queued pods (the new owner
     re-gathers them) and the bind fence withholds in-flight commits;
  3. every live replica scans for expired leases and claims them with
     an epoch bump (store CAS picks one winner), then drains the dead
     owner's pending pods via ``engine.adopt_shards`` — the live
     takeover. A takeover from a dead PEER journals ``lease.takeover``
     and captures an incident bundle (one per class per run) whose
     postmortem narrative names the dead replica and the claiming
     epoch.

``kill()`` models a crash: the engine stops, the lease manager forgets
its shards WITHOUT releasing the store objects — exactly the debris a
dead process leaves — and a peer claims the shards within ~one lease
TTL. ``restart()`` brings a fresh engine up under the same replica id
with no shards; it re-acquires whatever is (or becomes) expired.
"""
from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Dict, List, Optional

from ..obs import bundle as bundle_mod
from ..obs.journal import note as jnote
from ..errors import NotFoundError
from .lease import LeaseManager
from .shardmap import lease_name, lease_ttl_from_env, shard_of

log = logging.getLogger(__name__)


class _Replica:
    __slots__ = ("id", "engine", "lease", "alive")

    def __init__(self, rid: str, engine, lease: LeaseManager):
        self.id = rid
        self.engine = engine
        self.lease = lease
        self.alive = False


class FleetSupervisor:
    def __init__(self, store, *, engine_factory: Callable,
                 replicas: int = 2, n_shards: Optional[int] = None,
                 lease_ttl_s: Optional[float] = None,
                 tick_s: Optional[float] = None,
                 checkpointer=None,
                 clock: Callable[[], float] = time.monotonic):
        if replicas < 1:
            raise ValueError(f"fleet needs >= 1 replica, got {replicas}")
        self.store = store
        self._factory = engine_factory
        self.n_replicas = int(replicas)
        self.n_shards = int(n_shards) if n_shards else self.n_replicas
        self.lease_ttl_s = (float(lease_ttl_s) if lease_ttl_s is not None
                            else lease_ttl_from_env())
        self.tick_s = (float(tick_s) if tick_s is not None
                       else max(0.05, self.lease_ttl_s / 4.0))
        self._checkpointer = checkpointer
        self._clock = clock
        self._lock = threading.RLock()
        self._replicas: Dict[str, _Replica] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.takeovers = 0

    # ---- lifecycle ------------------------------------------------------

    def start(self) -> None:
        """Deal shards round-robin, claim the leases, THEN start every
        engine — set_shards must precede start() so each informer's
        initial sync gathers only the replica's own shard."""
        with self._lock:
            if self._replicas:
                raise RuntimeError("fleet already started")
            for i in range(self.n_replicas):
                rid = f"r{i}"
                self._replicas[rid] = self._make_replica(rid)
            reps = list(self._replicas.values())
            for shard in range(self.n_shards):
                rep = reps[shard % len(reps)]
                rep.lease.try_acquire(shard)
            for rep in reps:
                rep.engine.set_shards(
                    frozenset(rep.lease.held()), self.n_shards,
                    epoch=max(rep.lease.held().values(), default=0))
                rep.engine.start()
                rep.alive = True
            # The deal's claims predate every informer sync, and the
            # syncs together can outlast a TTL (seconds at 50,000
            # nodes): heartbeat once before the tick's first period, so
            # store truth never reads a live replica's lease expired.
            for rep in reps:
                rep.lease.renew_all()
        jnote("fleet.start", replicas=self.n_replicas,
              shards=self.n_shards, ttl_s=self.lease_ttl_s)
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="fleet-tick")
        self._thread.start()

    def _make_replica(self, rid: str) -> _Replica:
        engine = self._factory(rid)
        mgr = LeaseManager(self.store, rid, ttl_s=self.lease_ttl_s,
                           clock=self._clock)
        # Bind fence: a commit is withheld unless this replica still
        # holds the pod's shard lease LOCALLY (no store round-trip on
        # the hot path; true epoch races still resolve at the bind CAS).
        n = self.n_shards
        engine.set_bind_guard(
            lambda key, _m=mgr: _m.holds(shard_of(key, n)))
        return _Replica(rid, engine, mgr)

    def shutdown(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        with self._lock:
            for rep in self._replicas.values():
                if rep.alive:
                    rep.engine.shutdown()
                    rep.alive = False
            self._replicas.clear()

    # ---- failure injection / recovery ----------------------------------

    def kill(self, rid: str, *, crash: bool = False) -> bool:
        """Crash one replica: the engine stops, its leases are FORGOTTEN
        locally but left in the store to expire — a peer claims them
        within ~one lease TTL via the tick's takeover scan. Returns
        True iff a live replica was actually taken down.

        ``crash=True`` is the harsher SIGKILL model: leases are dropped
        FIRST and the engine is ``abandon()``ed rather than shut down —
        no commit flush, and a device-loop mid-tranche stops BETWEEN
        slots, leaving staged-but-unresolved ring slots as unbound
        debris for the adopter (the fleet × device-loop drain test
        rides this). The default stays the gentler stop the existing
        failover tests pin."""
        with self._lock:
            rep = self._replicas.get(rid)
            if rep is None or not rep.alive:
                return False
            rep.alive = False
        jnote("fleet.kill", replica=rid, crash=crash,
              shards=",".join(str(s) for s in sorted(rep.lease.held())))
        if crash:
            rep.lease.drop_all()
            rep.engine.abandon()
        else:
            rep.engine.shutdown()
            rep.lease.drop_all()
        log.warning("fleet: replica %s killed%s", rid,
                    " (crash)" if crash else "")
        return True

    def restart(self, rid: str) -> bool:
        """Bring a fresh engine up under the same replica id, owning
        nothing: it re-acquires shards as their leases expire (no
        preemptive rebalance — ownership only ever moves through the
        lease protocol). Returns True iff a new incarnation started."""
        with self._lock:
            old = self._replicas.get(rid)
            if old is not None and old.alive:
                return False
            rep = self._make_replica(rid)
            rep.engine.set_shards(frozenset(), self.n_shards)
            rep.engine.start()
            rep.alive = True
            self._replicas[rid] = rep
        jnote("fleet.restart", replica=rid)
        return True

    # ---- the tick -------------------------------------------------------

    def _run(self) -> None:
        while not self._stop.wait(self.tick_s):
            try:
                self.tick()
            except Exception:
                log.exception("fleet tick failed; continuing")

    def tick(self) -> None:
        """One deterministic pass of the lease protocol (also callable
        directly by tests for step-by-step control)."""
        with self._lock:
            live = [r for r in self._replicas.values() if r.alive]
        for rep in live:
            rep.lease.renew_all()
            self._sync_shards(rep)
        for rep in live:
            self._scan_and_claim(rep)

    def _sync_shards(self, rep: _Replica) -> None:
        """Hand off shards whose lease this replica lost (renewal CAS
        lost / epoch superseded): shrink the engine's owned set and drop
        the queued pods — the new owner re-gathers them."""
        held = frozenset(rep.lease.held())
        _n, owned, _e = rep.engine.shard_view
        lost = owned - held
        if lost:
            rep.engine.release_shards(
                lost, epoch=max(rep.lease.held().values(), default=0),
                reason="lease lost")

    def _scan_and_claim(self, rep: _Replica) -> None:
        """The takeover scan: claim every expired (or never-created)
        lease with an epoch bump and drain the dead owner's pending
        pods into this replica's queue."""
        now = self._clock()
        for shard in range(self.n_shards):
            if rep.lease.holds(shard):
                continue
            try:
                lease = self.store.get("Lease", lease_name(shard))
            except NotFoundError:
                lease = None
            if lease is not None and not lease.expired(now):
                continue
            prev = lease.holder if lease is not None else ""
            if not rep.lease.try_acquire(shard):
                continue  # a peer's CAS won this epoch
            epoch = rep.lease.epoch_of(shard)
            pods = rep.engine.adopt_shards(
                {shard}, epoch=epoch,
                reason=f"takeover from {prev or 'unheld'}")
            if prev and prev != rep.id:
                self.takeovers += 1
                jnote("lease.takeover", replica=rep.id, frm=prev,
                      shard=shard, epoch=epoch, pods=pods)
                log.warning(
                    "fleet: %s took over shard %d from dead %s at "
                    "epoch %d (%d pending pods drained)",
                    rep.id, shard, prev, epoch, pods)
                bundle_mod.capture(
                    "fleet_takeover", scheduler=rep.engine,
                    reason=(f"replica {prev!r} lease on shard {shard} "
                            f"expired; {rep.id!r} claimed at epoch "
                            f"{epoch} and drained {pods} pending "
                            "pod(s)"),
                    extra={"dead_replica": prev, "claimed_by": rep.id,
                           "shard": shard, "epoch": epoch,
                           "pods_drained": pods})
                if self._checkpointer is not None:
                    # Persist the post-takeover ownership promptly: a
                    # restart from this checkpoint resumes with the
                    # claim already durable (state/persistence.py).
                    try:
                        self._checkpointer.checkpoint()
                    except Exception:
                        log.exception("post-takeover checkpoint failed")

    # ---- views ----------------------------------------------------------

    @property
    def scheduler(self):
        """The first live engine (single-engine API mirrors; bundle
        capture and service providers reach engine surfaces here)."""
        with self._lock:
            for rep in self._replicas.values():
                if rep.alive:
                    return rep.engine
        return None

    def engines(self) -> Dict[str, object]:
        with self._lock:
            return {rid: rep.engine
                    for rid, rep in self._replicas.items() if rep.alive}

    def replica_ids(self) -> List[str]:
        with self._lock:
            return sorted(self._replicas)

    def owner_of(self, shard: int) -> str:
        """Store-truth owner of a shard ("" = unheld/expired)."""
        try:
            lease = self.store.get("Lease", lease_name(shard))
        except NotFoundError:
            return ""
        return lease.holder if not lease.expired(self._clock()) else ""

    def wait_converged(self, timeout: float = 10.0) -> bool:
        """Every shard lease held by a live replica AND each engine's
        owned set matching its lease manager's — the quiescence contract
        tests wait on after a kill."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                live = [r for r in self._replicas.values() if r.alive]
            held = set()
            ok = True
            for rep in live:
                h = frozenset(rep.lease.held())
                _n, owned, _e = rep.engine.shard_view
                if owned != h:
                    ok = False
                held |= h
            if ok and held == set(range(self.n_shards)):
                return True
            time.sleep(0.02)
        return False

    def metrics(self) -> Dict[str, float]:
        """Aggregate fleet metrics: numeric engine counters SUMMED
        across live replicas (pods_bound, bind_conflicts,
        stale_owner_binds... — the fleet-wide totals the bench and the
        oracle read), plus summed lease counters and fleet gauges."""
        out: Dict[str, float] = {}
        with self._lock:
            reps = list(self._replicas.values())
        live = 0
        for rep in reps:
            if not rep.alive:
                continue
            live += 1
            for k, v in rep.engine.metrics().items():
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    out[k] = out.get(k, 0) + v
            for k, v in rep.lease.counters.items():
                key = f"lease_{k}"
                out[key] = out.get(key, 0) + v
        out["fleet_replicas_live"] = live
        out["fleet_takeovers"] = self.takeovers
        out["fleet_shards"] = self.n_shards
        return out

    def histograms(self) -> Dict[str, dict]:
        """Per-pod latency histograms MERGED across live replicas
        (identical bucket bounds by construction): counts, sum, and
        count add — the fleet-wide p99 the bench reads."""
        merged: Dict[str, dict] = {}
        with self._lock:
            reps = [r for r in self._replicas.values() if r.alive]
        for rep in reps:
            for name, snap in rep.engine.metrics().get(
                    "histograms", {}).items():
                m = merged.get(name)
                if m is None or m["bounds"] != snap["bounds"]:
                    if m is None:
                        merged[name] = {"bounds": list(snap["bounds"]),
                                        "counts": list(snap["counts"]),
                                        "sum": snap["sum"],
                                        "count": snap["count"]}
                    continue
                m["counts"] = [a + b for a, b in
                               zip(m["counts"], snap["counts"])]
                m["sum"] += snap["sum"]
                m["count"] += snap["count"]
        return merged

    def provenance(self, pod_key: str):
        with self._lock:
            reps = [r for r in self._replicas.values() if r.alive]
        for rep in reps:
            rec = rep.engine.provenance(pod_key)
            if rec is not None:
                return rec
        return None

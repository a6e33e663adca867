"""Per-replica lease manager: heartbeats, claims, and fencing.

One :class:`LeaseManager` per fleet replica. Each owned shard has a
``Lease`` object in the store (``state/objects.Lease``, cluster-scoped,
named by ``shardmap.lease_name``); ownership transitions are ALWAYS a
resource-version CAS through ``store.update(check_version=True)``, so
two claimants can never both win an epoch — the loser's write raises
``Conflict`` and it re-reads the new truth. The epoch is the fencing
token: bumped on every ownership CHANGE (claim/takeover), never on
renewal, so a zombie holder's stale epoch is detectable forever.

Lease state machine (journaled as ``lease.*`` events):

    unheld/expired --try_acquire (CAS, epoch+1)--> held   lease.acquire
                                                          (+ .takeover
                                                          when a dead
                                                          peer held it)
    held --renew (CAS, same epoch)--> held                lease.renew
    held --peer claimed (epoch moved) / CAS lost--> lost  lease.lose

The ``lease`` fault gate (faults.py) sits on the heartbeat write:
``err`` drops the renewal (miss enough and the lease expires — the
degraded-network failure mode), ``corrupt`` sends the heartbeat with a
STALE resource_version so the store CAS must reject it — the
containment proof that a corrupted lease can never mint two live owners
of one shard.

Clock: ``time.monotonic`` by default (replicas share the process; a
restored checkpoint's stale ``renewed_at`` simply reads as expired,
which is the correct recovery posture). Injectable for tests.
"""
from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Dict, Optional

from ..errors import AlreadyExistsError, ConflictError, NotFoundError
from ..faults import FAULTS, FaultInjected
from ..obs.journal import note as jnote
from ..state import objects as obj
from .shardmap import lease_name, lease_ttl_from_env

log = logging.getLogger(__name__)


class LeaseManager:
    """Lease-side state of one replica: which shards it holds, at which
    epochs, and the CAS machinery to keep (or lose) them honestly."""

    def __init__(self, store, replica: str, *,
                 ttl_s: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic,
                 lease_name_fn: Callable[[int], str] = lease_name,
                 burn_provider: Optional[Callable[[], tuple]] = None):
        self.store = store
        self.replica = replica
        self.ttl_s = float(ttl_s) if ttl_s is not None \
            else lease_ttl_from_env()
        self._clock = clock
        #: Injectable name map: the steward election (fleet/election.py)
        #: reuses this manager verbatim against its ONE named lease.
        self._lease_name = lease_name_fn
        #: Burn publication (a self-governing fleet): ``() -> (level,
        #: "obj1,obj2")`` stamped onto every renewal heartbeat so the
        #: steward's rebalance trigger reads load off the lease records.
        self._burn_provider = burn_provider
        self._lock = threading.Lock()
        self._held: Dict[int, int] = {}  # shard -> epoch this replica won
        #: Counters surfaced through FleetSupervisor.metrics(): renewals,
        #: drops (lease:err), stale heartbeats sent + rejected
        #: (lease:corrupt), claim conflicts (lost CAS races), losses.
        self.counters: Dict[str, int] = {
            "renewals": 0, "heartbeats_dropped": 0,
            "stale_heartbeats_rejected": 0, "claim_conflicts": 0,
            "acquires": 0, "losses": 0, "releases": 0,
        }

    # ---- local views (hot path: no store round-trip) --------------------

    def holds(self, shard: int) -> bool:
        return shard in self._held  # GIL-atomic dict probe

    def held(self) -> Dict[int, int]:
        with self._lock:
            return dict(self._held)

    def epoch_of(self, shard: int) -> int:
        return self._held.get(shard, 0)

    # ---- ownership transitions ------------------------------------------

    def try_acquire(self, shard: int) -> bool:
        """Claim the shard if its lease is unheld or expired: epoch bump
        through the store CAS. Exactly one concurrent claimant wins; the
        rest count a ``claim_conflict`` and return False."""
        name = self._lease_name(shard)
        now = self._clock()
        try:
            lease = self.store.get("Lease", name)
        except NotFoundError:
            lease = obj.Lease(metadata=obj.ObjectMeta(name=name),
                              holder=self.replica, epoch=1,
                              ttl_s=self.ttl_s, renewed_at=now,
                              shard=shard)
            try:
                self.store.create(lease)
            except AlreadyExistsError:
                # Lost the creation race; fall through to the claim path
                # against the winner's object.
                with self._lock:
                    self.counters["claim_conflicts"] += 1
                return False
            with self._lock:
                self._held[shard] = 1
                self.counters["acquires"] += 1
            jnote("lease.acquire", replica=self.replica, shard=shard,
                  epoch=1, frm="")
            return True
        if lease.holder == self.replica and lease.epoch == \
                self._held.get(shard):
            return True  # already ours at the epoch we won
        if not lease.expired(now):
            return False
        prev = lease.holder
        lease.holder = self.replica
        lease.epoch += 1
        lease.ttl_s = self.ttl_s
        lease.renewed_at = now
        try:
            self.store.update(lease, check_version=True)
        except (ConflictError, NotFoundError):
            with self._lock:
                self.counters["claim_conflicts"] += 1
            return False
        with self._lock:
            self._held[shard] = lease.epoch
            self.counters["acquires"] += 1
        jnote("lease.acquire", replica=self.replica, shard=shard,
              epoch=lease.epoch, frm=prev)
        return True

    def renew(self, shard: int) -> bool:
        """Heartbeat one held lease (same epoch, fresh renewed_at)
        through the CAS. Returns False when the renewal did not commit —
        dropped by the ``lease`` fault gate, rejected as stale, or the
        shard was lost to a peer (which also drops it from the held
        set; the caller hands the shard off via engine.release_shards)."""
        my_epoch = self._held.get(shard)
        if my_epoch is None:
            return False
        # Fault gate: lease heartbeat write. ``err`` drops this renewal;
        # ``corrupt`` rewinds the resource_version below so the store
        # CAS MUST reject the write (stale fencing token).
        try:
            act = FAULTS.hit("lease")
        except FaultInjected:
            with self._lock:
                self.counters["heartbeats_dropped"] += 1
            jnote("lease.heartbeat_dropped", replica=self.replica,
                  shard=shard, epoch=my_epoch)
            return False
        name = self._lease_name(shard)
        try:
            lease = self.store.get("Lease", name)
        except NotFoundError:
            self._lose(shard, my_epoch, "lease object deleted")
            return False
        if lease.holder != self.replica or lease.epoch != my_epoch:
            self._lose(shard, my_epoch,
                       f"superseded by {lease.holder}@{lease.epoch}")
            return False
        lease.renewed_at = self._clock()
        if self._burn_provider is not None:
            # Burn signal rides the heartbeat it already pays for: the
            # overload rung + burning objectives land on the lease
            # record, where the steward's rebalance scan reads them.
            try:
                level, names = self._burn_provider()
                lease.burn_level = int(level)
                lease.burning = str(names)
            except Exception:
                pass  # a failed probe never blocks the renewal
        if act == "corrupt":
            # Zombie heartbeat: write with a rewound resource_version.
            # The CAS below rejects it BY CONSTRUCTION — the containment
            # the two-owners test pins.
            lease.metadata.resource_version -= 1
        try:
            self.store.update(lease, check_version=True)
        except ConflictError:
            if act == "corrupt":
                with self._lock:
                    self.counters["stale_heartbeats_rejected"] += 1
                jnote("lease.stale_heartbeat_rejected",
                      replica=self.replica, shard=shard, epoch=my_epoch)
                # Store truth may still name us holder; the next clean
                # renewal re-reads and decides.
                return False
            # A peer wrote the lease between our read and write — if the
            # epoch moved we lost; a pure rv race retries next tick.
            try:
                fresh = self.store.get("Lease", name)
            except NotFoundError:
                self._lose(shard, my_epoch, "lease object deleted")
                return False
            if fresh.holder != self.replica or fresh.epoch != my_epoch:
                self._lose(shard, my_epoch,
                           f"superseded by {fresh.holder}@{fresh.epoch}")
            return False
        with self._lock:
            self.counters["renewals"] += 1
        jnote("lease.renew", replica=self.replica, shard=shard,
              epoch=my_epoch)
        return True

    def renew_all(self) -> None:
        for shard in sorted(self.held()):
            self.renew(shard)

    def release(self, shard: int) -> bool:
        """VOLUNTARY handoff (elastic rebalance): clear the holder field
        through the CAS — epoch untouched, the next claimant bumps it —
        and forget the shard locally. Unlike the crash model the store
        object immediately reads unheld, so the nominated recipient can
        claim without waiting out a TTL. Returns False when the CAS
        lost (a peer already superseded us — nothing left to release)."""
        my_epoch = self._held.get(shard)
        if my_epoch is None:
            return False
        name = self._lease_name(shard)
        try:
            lease = self.store.get("Lease", name)
        except NotFoundError:
            self._lose(shard, my_epoch, "lease object deleted")
            return False
        if lease.holder != self.replica or lease.epoch != my_epoch:
            self._lose(shard, my_epoch,
                       f"superseded by {lease.holder}@{lease.epoch}")
            return False
        lease.holder = ""
        try:
            self.store.update(lease, check_version=True)
        except (ConflictError, NotFoundError):
            return False
        with self._lock:
            self._held.pop(shard, None)
            self.counters["releases"] += 1
        jnote("lease.release", replica=self.replica, shard=shard,
              epoch=my_epoch)
        return True

    def drop_all(self) -> None:
        """Forget every held shard locally WITHOUT touching the store —
        the crash model (kill_scheduler): the lease object stays put and
        simply expires, which is what a dead process leaves behind."""
        with self._lock:
            self._held.clear()

    def _lose(self, shard: int, epoch: int, reason: str) -> None:
        with self._lock:
            self._held.pop(shard, None)
            self.counters["losses"] += 1
        jnote("lease.lose", replica=self.replica, shard=shard,
              epoch=epoch, reason=reason)
        log.warning("replica %s lost lease on shard %d: %s",
                    self.replica, shard, reason)

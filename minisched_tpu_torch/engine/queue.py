"""Scheduling queue: active / backoff / unschedulable, batch pops.

Rebuild of the reference's three-queue design (reference
minisched/queue/queue.go:16-24) with its defects fixed (SURVEY §2 "quirks"):

  * NextPod busy-spins lock-free until activeQ is non-empty
    (queue.go:84-92) — a data race and a 100% CPU burn. Here pops block on a
    condition variable.
  * flushBackoffQCompleted and friends panic("not implemented")
    (queue.go:109-146), so backed-off pods are stranded forever unless a
    later event happens to move them. Here a flusher thread drains due
    backoff entries into activeQ.
  * Update/Delete panic in the reference; implemented here.

And one batched-world change: pops return *batches* of pending pods ordered
by priority, feeding the (P × N) XLA step instead of one pod at a time.

Event-filtered requeue keeps the reference's exact gating contract
(queue.go:54-82,167-190): an unschedulable pod moves back only when a
cluster event arrives that a plugin in its UnschedulablePlugins set
registered interest in; pods still in their backoff window go to backoffQ
instead of activeQ. Backoff is exponential 1s→10s doubling per attempt
(queue.go:218-235).
"""
from __future__ import annotations

import heapq
import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from ..faults import FAULTS, FaultInjected
from ..obs import span
from ..obs.journal import note as jnote
from ..state.events import ClusterEvent
from ..state.objects import Pod, gang_key

# Pseudo-plugin recorded when a pod lost only because earlier pods in the
# same batch consumed the capacity (no reference analog — batching artifact).
# Registered against node add/update events by the scheduler.
BATCH_CAPACITY = "BatchCapacity"

# Pseudo-plugin recorded when a pod's gang missed quorum (ops/gang.py).
# Registered against pod add/delete + node add/update events: a new gang
# member or freed capacity can complete the group.
COSCHEDULING = "Coscheduling"


def weighted_gather(demands: List[int], weights: List[float],
                    capacity: int) -> List[int]:
    """Weighted fair batch formation across tenants: split ``capacity``
    batch slots over tenants in proportion to ``weights``, never granting
    a tenant more than its ``demands`` (pending pods) — the fused-slot
    apportionment that keeps one hot tenant from starving the rest
    (ISSUE 16 fairness gather).

    Largest-remainder apportionment with demand caps, iterated: each
    round splits the remaining capacity over the still-unmet tenants by
    weight (floor of the ideal share, capped by unmet demand), then
    hands out any whole slots the flooring stranded one at a time in
    descending fractional-remainder order (ties broken by tenant index
    — deterministic). Capacity a capped tenant cannot use rolls over to
    the others in the next round, so the result saturates: either every
    tenant's demand is fully met or every slot is granted.

    Properties (pinned by tests/test_tenants.py): sum(alloc) <=
    capacity; alloc[i] <= demands[i]; sum(alloc) == min(capacity,
    sum(demands)) when all live weights > 0; zero-weight tenants are
    granted only what zero competition leaves behind (nothing, unless
    every weighted tenant's demand is already met)."""
    t = len(demands)
    alloc = [0] * t
    if capacity <= 0 or t == 0:
        return alloc
    remaining = capacity

    def _round(eligible) -> bool:
        nonlocal remaining
        live = [i for i in eligible
                if alloc[i] < demands[i]]
        if not live or remaining <= 0:
            return False
        total_w = sum(weights[i] for i in live)
        if total_w <= 0:
            # Equal-weight split among the (all-zero-weight) survivors.
            shares = [(i, remaining / len(live)) for i in live]
        else:
            shares = [(i, remaining * weights[i] / total_w) for i in live]
        granted = 0
        fracs = []
        for i, ideal in shares:
            want = demands[i] - alloc[i]
            g = min(int(ideal), want)
            alloc[i] += g
            granted += g
            fracs.append((ideal - int(ideal), i, want - g))
        remaining -= granted
        if granted == 0 and remaining > 0:
            # Flooring stranded every slot: hand out single units in
            # descending fractional-remainder order (index-ascending on
            # ties) to tenants with unmet demand.
            for _frac, i, headroom in sorted(
                    fracs, key=lambda e: (-e[0], e[1])):
                if remaining <= 0:
                    break
                if headroom > 0:
                    alloc[i] += 1
                    remaining -= 1
                    granted += 1
        return granted > 0

    weighted = [i for i in range(t) if weights[i] > 0]
    while _round(weighted):
        pass
    # Whatever the weighted tenants could not absorb goes to zero-weight
    # tenants (weight 0 = "no guaranteed share", not "never served").
    zeroed = [i for i in range(t) if weights[i] <= 0]
    while _round(zeroed):
        pass
    return alloc


def bucket_major_quotas(demands: List[int], weights: List[float],
                        capacity: int, buckets: List[int]
                        ) -> List[Tuple[int, List[int], List[int]]]:
    """Bucket-major slot apportionment (ISSUE 20's second prong): group
    tenants by the pod pad bucket their pending demand would serve at
    (``buckets[i]``, precomputed by the caller via encode.step_bucket)
    and run :func:`weighted_gather` INSIDE each group over the full
    round capacity — largest-remainder slots per group, so mixed-size
    tenants still fuse within their bucket instead of one global pad
    forcing every lane to the widest tenant's shape (or fragmenting the
    round to solo dispatches).

    Returns ``[(bucket, indices, quotas), ...]`` in ascending bucket
    order — deterministic, so the fused and sequential coordinators pop
    identical pods per round (the bit-identity precondition). Tenants
    with zero demand are absent; a group's ``quotas`` aligns with its
    ``indices``. All of weighted_gather's properties hold per group."""
    groups: Dict[int, List[int]] = {}
    for i, d in enumerate(demands):
        if d > 0:
            groups.setdefault(buckets[i], []).append(i)
    out: List[Tuple[int, List[int], List[int]]] = []
    for bucket in sorted(groups):
        idxs = groups[bucket]
        quotas = weighted_gather([demands[i] for i in idxs],
                                 [weights[i] for i in idxs], capacity)
        out.append((bucket, idxs, quotas))
    return out


@dataclass
class QueuedPodInfo:
    """reference framework.QueuedPodInfo: pod + queue bookkeeping."""

    pod: Pod
    attempts: int = 0
    added_at: float = field(default_factory=time.monotonic)
    last_failure_at: float = 0.0
    unschedulable_plugins: Set[str] = field(default_factory=set)
    # move-request cycle observed when this pod was popped; see
    # SchedulingQueue._move_cycle.
    popped_at_cycle: int = 0
    # Lifecycle stamps (monotonic) feeding the engine's latency
    # histograms (obs.Histogram): queued = added_at above (first entry),
    # gathered = last pop into a scheduling attempt, decided = that
    # attempt's arbitration verdict. A retried pod's stage windows
    # describe its SUCCESSFUL attempt; create→bound spans everything.
    gathered_at: float = 0.0
    decided_at: float = 0.0
    # Which sub-queue holds the pod ("active" | "backoff" | "unsched" |
    # "shed" | "popped") — lets update/delete be O(1) dict lookups
    # instead of the linear scans the round-1 design used (quadratic
    # churn at 10k+ pods).
    where: str = "active"
    # Times this pod was parked in the overload shed lane (doubles the
    # shed backoff per re-shed, up to the ceiling).
    shed_count: int = 0
    # Lazy-deletion marker: list/heap entries for a deleted pod stay in
    # place and are skipped at pop/flush time (heap removal is O(n)).
    gone: bool = False
    # Decision-provenance stamp (obs/journal.ProvenanceStore): the
    # engine writes the path-that-served-it record here at placement
    # time (journal armed only) and the bound/failed settlement sites
    # publish it into the LRU.
    prov: Optional[dict] = None

    @property
    def key(self) -> str:
        return self.pod.key


class SchedulingQueue:
    def __init__(self, cluster_event_map: Dict[ClusterEvent, Set[str]],
                 *, backoff_initial: float = 1.0, backoff_max: float = 10.0,
                 flush_interval: float = 0.05):
        self._cond = threading.Condition()
        self._active: List[QueuedPodInfo] = []
        self._active_live = 0  # entries in _active not marked gone
        self._arrival_seq = 0  # bumped on every activeQ insertion
        self._backoff: List = []  # heap of (ready_time, seq, qpi)
        self._backoff_live = 0
        self._unschedulable: Dict[str, QueuedPodInfo] = {}
        self._known: Set[str] = set()  # keys present in any queue
        # key → live QueuedPodInfo for every pod currently held by a
        # sub-queue (NOT popped/in-flight pods): O(1) update/delete.
        self._index: Dict[str, QueuedPodInfo] = {}
        self._event_map = dict(cluster_event_map)
        self._backoff_initial = backoff_initial
        self._backoff_max = backoff_max
        self._seq = itertools.count()
        # Incremented on every move_all_to_active_or_backoff. A pod whose
        # scheduling attempt straddled a move request must not be parked in
        # unschedulableQ — the event it needed may have fired mid-attempt and
        # found nothing to revive (upstream kube-scheduler's
        # moveRequestCycle mechanism; the reference has the same race with a
        # tiny window, widened here by batch+compile latency).
        self._move_cycle = 0
        # Requeue fan-out accounting (lifecycle churn observability):
        # moves that scanned the unschedulableQ vs events dropped at the
        # no-registered-interest gate.
        self._moves = 0
        self._move_skips = 0
        # Overload shed lane (engine/overload.py): NEW arrivals the
        # admission gate declines park here — a heap of (ready, seq,
        # qpi) like backoffQ, drained by the flusher, which re-offers
        # each due entry to the gate (still shedding ⇒ re-park with
        # doubled backoff; recovered ⇒ activeQ). Counted, never
        # dropped: the lifecycle no_pod_lost oracle covers it.
        self._shed: List = []
        self._shed_live = 0
        self._shed_total = 0       # shed EVENTS (re-parks included)
        self._shed_pods = 0        # unique pods ever shed (first park)
        self._shed_readmitted = 0
        self._admission = None  # callable(pod) -> bool, or None
        self._shed_backoff_fn = None  # () -> (initial_s, max_s), live
        self._closed = False
        self._flusher = threading.Thread(
            target=self._flush_loop, args=(flush_interval,), daemon=True,
            name="backoff-flusher")
        self._flusher.start()

    # ---- producers ------------------------------------------------------

    def set_admission(self, fn, *, backoff_fn=None) -> None:
        """Install the overload admission gate at the ingress seam:
        ``fn(pod) -> bool`` (False = park in the shed lane). The gate is
        consulted for NEW arrivals and for due shed entries at flush
        time — requeues of in-flight pods never shed (backpressure
        applies at ingress, not to work already admitted).
        ``backoff_fn() -> (initial_s, max_s)`` resolves the shed-lane
        backoff at each park, so knobs reconfigured on a LIVE engine
        (overload.configure between runs) take effect instead of
        latching the construction-time values. ``None`` uninstalls /
        keeps the defaults."""
        with self._cond:
            self._admission = fn
            self._shed_backoff_fn = backoff_fn

    def _ingress_fault(self) -> bool:
        """The ``admission`` fault gate (faults.py), hit once per
        ingress transaction (the per-batch-seam discipline). ``corrupt``
        force-sheds the whole transaction — the chaos handle on the
        shed path (pods re-admit via the flusher; nothing is lost);
        ``err`` models the verdict machinery failing and FAILS OPEN
        (admit — a broken gate must not drop ingress); ``stall`` sleeps
        in the registry. Never called under the queue lock."""
        try:
            return FAULTS.hit("admission") == "corrupt"
        except FaultInjected:
            return False

    def _admits(self, pod: Pod) -> bool:
        """Consult the installed admission gate (caller may hold the
        lock — the gate is a plain int compare on the overload
        controller). A raising gate fails open."""
        fn = self._admission
        if fn is None:
            return True
        try:
            return bool(fn(pod))
        except Exception:
            return True

    def add(self, pod: Pod) -> None:
        """New unscheduled pod (reference queue.go:35-43)."""
        forced = self._ingress_fault()
        shed = False
        with self._cond:
            if pod.key in self._known or self._closed:
                return
            self._known.add(pod.key)
            qpi = QueuedPodInfo(pod=pod)
            if forced or not self._admits(pod):
                self._push_shed(qpi, time.monotonic())
                shed = True
            else:
                self._push_active(qpi)
                self._cond.notify_all()
        if shed:
            # Journal OUTSIDE the queue lock (the journal's JSONL sink
            # write must never extend a lock hold the scheduling
            # thread's pop waits on), one event per ingress transaction
            # — never per pod in a loop.
            jnote("queue.shed", pods=1, pod=pod.key)

    def add_many(self, pods: List[Pod]) -> None:
        """Bulk ``add``: one lock acquisition and ONE consumer wake-up for
        a whole arrival burst (per-pod adds wake the batch-gathering
        ``pop_batch`` thread once per pod — 10k context-switch round-trips
        per workload submission)."""
        forced = self._ingress_fault()
        shed_n = 0
        with self._cond:
            if self._closed:
                return
            added = False
            now = time.monotonic()  # one due time for the whole shed wave
            for pod in pods:
                if pod.key in self._known:
                    continue
                self._known.add(pod.key)
                qpi = QueuedPodInfo(pod=pod)
                if forced or not self._admits(pod):
                    self._push_shed(qpi, now)
                    shed_n += 1
                    continue
                self._push_active(qpi)
                added = True
            if added:
                self._cond.notify_all()
        if shed_n:
            # One aggregate event per ingress transaction, outside the
            # lock — a shed WAVE must not flood the journal ring with
            # per-pod entries (evicting the ladder history the ring
            # exists to keep) nor pay a sink write per pod under the
            # queue lock.
            jnote("queue.shed", pods=shed_n)

    def update(self, old: Pod, new: Pod) -> None:
        """Pod updated (reference Update panics, queue.go:109-118; we
        implement upstream semantics: refresh the stored pod, and a *spec*
        update may make an unschedulable pod schedulable again → move to
        active; status-only updates — e.g. the scheduler recording
        unschedulable_plugins — must NOT revive it)."""
        with self._cond:
            qpi = self._index.get(new.key)
            if qpi is None:
                return
            qpi.pod = new
            if qpi.where == "unsched" and (old is None or old.spec != new.spec):
                del self._unschedulable[new.key]
                self._push_active(qpi)
                self._cond.notify_all()

    def delete(self, pod: Pod) -> None:
        """Pod deleted (reference Delete panics, queue.go:120-127)."""
        with self._cond:
            key = pod.key
            self._known.discard(key)
            qpi = self._index.pop(key, None)
            if qpi is None:
                return
            qpi.gone = True  # list/heap entries are skipped lazily
            if qpi.where == "active":
                self._active_live -= 1
            elif qpi.where == "backoff":
                self._backoff_live -= 1
            elif qpi.where == "shed":
                self._shed_live -= 1
            elif qpi.where == "unsched":
                self._unschedulable.pop(key, None)

    def forget(self, key: str) -> None:
        """Pod left the scheduling pipeline for good (bound, or deleted
        while in flight): allow a future same-named pod to be queued."""
        with self._cond:
            self._known.discard(key)

    def forget_many(self, keys) -> None:
        """Bulk ``forget``: one lock acquisition for a whole bound batch."""
        with self._cond:
            self._known.difference_update(keys)

    def release_unwanted(self, wants) -> List[str]:
        """Fleet shard handoff (engine.release_shards): drop every
        QUEUED pod ``wants(pod)`` now rejects — the replica lost the
        pod's shard lease, and the new owner's takeover sweep re-gathers
        the pod from the store. Only pods HELD by a sub-queue are
        released; popped/in-flight pods stay known until their commit
        resolves through the bind fence / store CAS. ``wants`` is a
        cheap pure predicate (set lookups + a crc32), safe under the
        lock. Returns the released keys."""
        out: List[str] = []
        with self._cond:
            for key, qpi in list(self._index.items()):
                try:
                    if wants(qpi.pod):
                        continue
                except Exception:
                    continue  # a broken filter must not drop pods
                self._index.pop(key, None)
                self._known.discard(key)
                qpi.gone = True
                if qpi.where == "active":
                    self._active_live -= 1
                elif qpi.where == "backoff":
                    self._backoff_live -= 1
                elif qpi.where == "shed":
                    self._shed_live -= 1
                elif qpi.where == "unsched":
                    self._unschedulable.pop(key, None)
                out.append(key)
        return out

    def add_unschedulable(self, qpi: QueuedPodInfo,
                          unschedulable_plugins: Set[str]) -> None:
        """Scheduling attempt failed (reference AddUnschedulable
        queue.go:95-107): record rejecting plugins and park the pod."""
        with self._cond:
            if not self._may_requeue(qpi):
                return
            qpi.attempts += 1
            qpi.last_failure_at = time.monotonic()
            qpi.unschedulable_plugins = set(unschedulable_plugins)
            if qpi.popped_at_cycle < self._move_cycle:
                # A move request fired during the attempt; retry via backoff
                # instead of parking (the event can no longer revive us).
                self._push_backoff(qpi)
                return
            qpi.where, qpi.gone = "unsched", False
            self._index[qpi.key] = qpi
            self._unschedulable[qpi.key] = qpi

    def requeue_backoff(self, qpi: QueuedPodInfo) -> None:
        """Retryable failure (in-batch capacity loss, bind conflict): back
        off, then automatically return to activeQ via the flusher."""
        with self._cond:
            if not self._may_requeue(qpi):
                return
            qpi.attempts += 1
            qpi.last_failure_at = time.monotonic()
            self._push_backoff(qpi)

    def quarantine(self, qpi: QueuedPodInfo) -> None:
        """Quarantine-and-requeue (the supervisor's bottom ladder rung):
        park the pod on the backoff heap at the FULL backoff ceiling
        regardless of its attempt count — a batch that exhausted the
        degradation ladder gets the cluster a maximal quiet window
        before it re-forms, while still guaranteeing the pods return
        (never lost, unlike a terminal unschedulable park which needs a
        reviving event)."""
        with self._cond:
            if not self._may_requeue(qpi):
                return
            qpi.attempts += 1
            qpi.last_failure_at = time.monotonic()
            self._push_backoff(
                qpi, ready=qpi.last_failure_at + self._backoff_max)

    def requeue_failures(self, retryable: List[QueuedPodInfo],
                         unsched: List[tuple]) -> None:
        """Bulk failure requeue: one lock acquisition for a whole commit
        flush — ``retryable`` qpis go to the backoff heap, ``unsched``
        (qpi, plugins) pairs park in unschedulableQ (or backoff when a
        move request fired mid-attempt, exactly like add_unschedulable).
        The per-pod paths cost one lock round-trip per revocation; a
        skew-constrained burst revokes thousands per cycle."""
        now = time.monotonic()
        with self._cond:
            for qpi in retryable:
                if not self._may_requeue(qpi):
                    continue
                qpi.attempts += 1
                qpi.last_failure_at = now
                self._push_backoff(qpi)
            for qpi, plugins in unsched:
                if not self._may_requeue(qpi):
                    continue
                qpi.attempts += 1
                qpi.last_failure_at = now
                qpi.unschedulable_plugins = set(plugins)
                if qpi.popped_at_cycle < self._move_cycle:
                    self._push_backoff(qpi)
                    continue
                qpi.where, qpi.gone = "unsched", False
                self._index[qpi.key] = qpi
                self._unschedulable[qpi.key] = qpi

    # ---- event-driven requeue ------------------------------------------

    def move_all_to_active_or_backoff(self, event: ClusterEvent) -> None:
        """A cluster event occurred: revive matching unschedulable pods
        (reference MoveAllToActiveOrBackoffQueue queue.go:54-82).

        Drain/cordon-aware gating: an event NO registered plugin has
        interest in cannot revive anything — it is dropped before it
        bumps the move cycle. Bumping unconditionally (the old behavior)
        made every in-flight attempt that straddled ANY event route its
        unschedulable verdict to backoff instead of parking; under
        lifecycle churn (node updates every few hundred ms) terminal
        pods then cycled backoff→active→reject forever. (Narrowing node
        updates — cordons, shrinking allocatable — are additionally
        suppressed upstream of the queue, engine/clusterstate.py.)"""
        with self._cond:
            if not any(reg.matches(event) for reg in self._event_map):
                self._move_skips += 1
                return
            self._moves += 1
            self._move_cycle += 1
            moved = []
            for key, qpi in list(self._unschedulable.items()):
                if self._pod_matches_event(qpi, event):
                    moved.append(key)
                    del self._unschedulable[key]
                    if self._is_backing_off(qpi):
                        self._push_backoff(qpi)
                    else:
                        self._push_active(qpi)
            if moved:
                self._cond.notify_all()

    def _pod_matches_event(self, qpi: QueuedPodInfo, event: ClusterEvent) -> bool:
        """reference podMatchesEvent (queue.go:167-190): the event must match
        a registered ClusterEvent whose interested plugins intersect the
        pod's UnschedulablePlugins."""
        for registered, names in self._event_map.items():
            if registered.matches(event) and (qpi.unschedulable_plugins & names):
                return True
        return False

    # ---- consumer -------------------------------------------------------

    def pop_batch(self, max_n: int, timeout: Optional[float] = None,
                  gather_window: float = 0.0,
                  gather_idle: float = 0.0) -> List[QueuedPodInfo]:
        """Flight-recorded wrapper around :meth:`_pop_batch` — the
        ``queue.pop`` span covers the blocking wait plus the batch-
        formation window (on the gather worker's own lane in pipelined
        mode), with the popped size attached."""
        with span("queue.pop") as sp:
            batch = self._pop_batch(max_n, timeout, gather_window,
                                    gather_idle)
            sp.set(pods=len(batch))
            return batch

    def _pop_batch(self, max_n: int, timeout: Optional[float] = None,
                   gather_window: float = 0.0,
                   gather_idle: float = 0.0) -> List[QueuedPodInfo]:
        """Block until activeQ is non-empty (condvar — fixes the busy-wait at
        reference queue.go:84-92), then pop up to max_n pods ordered by
        descending priority (stable FIFO within a priority).

        ``gather_window``: after the first pod arrives, keep gathering up
        to that many seconds (or until max_n pods are queued) before
        popping. An arrival burst otherwise fragments into partial batches
        whose differing pad buckets each pay an XLA compile; a small
        window makes batch formation deterministic and full-sized. 0
        preserves pop-immediately semantics (the latency-sensitive
        default).

        ``gather_idle`` (needs a window): ALSO stop gathering once no new
        pod has arrived for this long — the burst's TAIL batch (fewer
        than max_n pods left) otherwise stalls for the whole window
        (measured: a 1000-pod burst at max_n=256 paid the full window on
        its 232-pod tail, dominating its p99). The grace is judged by an
        arrival sequence, not condvar wakeups, so spurious notifies don't
        fake quiescence. Size it ABOVE expected informer stalls: a gen-2
        GC pause over a 60k-object cluster (~100 ms) masquerades as
        end-of-burst and splits a straggler batch onto its own pad
        bucket — that only costs an extra compile (amortized), but a
        too-small grace pays it often. 0 keeps the pure-window behavior."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while self._active_live == 0 and not self._closed:
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return []
                    self._cond.wait(remaining)
                else:
                    self._cond.wait(1.0)
            if self._closed:
                return []
            if gather_window > 0:
                gather_end = time.monotonic() + gather_window
                idle_end = time.monotonic() + gather_idle
                while self._active_live < max_n and not self._closed:
                    now = time.monotonic()
                    remaining = gather_end - now
                    if remaining <= 0:
                        break
                    if gather_idle > 0:
                        idle_left = idle_end - now
                        if idle_left <= 0:
                            break  # queue quiescent: the burst's tail
                        seq = self._arrival_seq
                        self._cond.wait(min(remaining, idle_left))
                        if self._arrival_seq != seq:
                            idle_end = time.monotonic() + gather_idle
                    else:
                        self._cond.wait(remaining)
                if self._closed:
                    return []
            live = [q for q in self._active if not q.gone]
            live.sort(key=lambda q: -q.pod.spec.priority)
            batch, self._active = live[:max_n], live[max_n:]
            self._active_live = len(self._active)
            for qpi in batch:
                self._mark_popped(qpi)
            return batch

    def pop_group(self, group: str) -> List[QueuedPodInfo]:
        """Pull every queued member of a gang (namespaced gang key,
        objects.gang_key) so one batch sees the whole group (a batch
        boundary splitting a gang would otherwise reject it for missing
        quorum). Members still in their backoff window are pulled too —
        gang activation bypasses backoff, like upstream coscheduling's
        sibling activation — and so are SHED members (a gang split
        across the shedding transition would otherwise miss quorum on
        every attempt until the lane drained, and a shed-lane
        readmission fires no reviving ClusterEvent for the parked
        siblings). Parked unschedulable members are left to
        event-driven revival. Non-blocking."""
        with self._cond:
            members = [q for q in self._active
                       if not q.gone and gang_key(q.pod) == group]
            in_backoff = [e for e in self._backoff
                          if not e[2].gone and gang_key(e[2].pod) == group]
            in_shed = [e for e in self._shed
                       if not e[2].gone and e[2].where == "shed"
                       and gang_key(e[2].pod) == group]
            if members:
                self._active = [q for q in self._active
                                if q.gone or gang_key(q.pod) != group]
                self._active_live -= len(members)
            if in_backoff:
                self._backoff = [e for e in self._backoff
                                 if e[2].gone or gang_key(e[2].pod) != group]
                heapq.heapify(self._backoff)
                self._backoff_live -= len(in_backoff)
                members.extend(e[2] for e in in_backoff)
            if in_shed:
                self._shed = [e for e in self._shed
                              if e[2].gone or e[2].where != "shed"
                              or gang_key(e[2].pod) != group]
                heapq.heapify(self._shed)
                self._shed_live -= len(in_shed)
                members.extend(e[2] for e in in_shed)
            for qpi in members:
                self._mark_popped(qpi)
            return members

    # ---- lifecycle / introspection -------------------------------------

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def stats(self) -> Dict[str, int]:
        with self._cond:
            return {"active": self._active_live,
                    "backoff": self._backoff_live,
                    "unschedulable": len(self._unschedulable),
                    "moves": self._moves,
                    "move_skips": self._move_skips,
                    "shed": self._shed_live,
                    "shed_total": self._shed_total,
                    "shed_pods": self._shed_pods,
                    "shed_readmitted": self._shed_readmitted}

    def unschedulable_keys(self) -> Set[str]:
        with self._cond:
            return set(self._unschedulable)

    def pending_count(self) -> int:
        """Pods poppable RIGHT NOW (live activeQ entries) — the demand
        signal the tenant fusion coordinator feeds ``weighted_gather``.
        Backoff/shed/unschedulable parks are excluded: they are not
        servable this round, and counting them would grant a tenant
        batch slots it cannot fill (slots the gather exists to share)."""
        with self._cond:
            return self._active_live

    # ---- internals ------------------------------------------------------

    def _may_requeue(self, qpi: QueuedPodInfo) -> bool:
        """Can an in-flight qpi re-enter the queues? (caller holds the lock)
        No if the pod left the pipeline (deleted/bound → not in _known) or
        if the key is now held by a DIFFERENT qpi — the pod was deleted and
        recreated while this attempt was in flight; indexing the stale qpi
        would orphan the live one and resurrect a stale spec.

        Re-entry also consumes any leftover provenance stamp: a later
        attempt must never publish THIS attempt's node/batch tags under
        its own verdict — the settlement sites consume stamps while the
        journal is armed, but a disarm window (or a quarantine, which
        settles nothing) can leave one behind, and this is the one
        choke point every re-entry path crosses."""
        qpi.prov = None
        if qpi.key not in self._known or self._closed:
            return False
        existing = self._index.get(qpi.key)
        return existing is None or existing is qpi

    def _push_active(self, qpi: QueuedPodInfo) -> None:
        """Append to activeQ and index (caller holds the lock)."""
        qpi.where, qpi.gone = "active", False
        self._index[qpi.key] = qpi
        self._active.append(qpi)
        self._active_live += 1
        # Arrival sequence for pop_batch's idle-exit: every activeQ
        # insertion (add/add_many/event revival/backoff flush) bumps it,
        # so "seq unchanged across a grace period" means the queue is
        # genuinely quiescent, not merely between condvar wakeups.
        self._arrival_seq += 1

    def _push_shed(self, qpi: QueuedPodInfo, now: float) -> None:
        """Park a declined arrival in the shed lane (caller holds the
        lock): counted, indexed, backoff doubling per re-shed up to the
        ceiling. The flusher re-offers due entries to the gate, so a
        shed pod ALWAYS re-enters scheduling once the overload clears
        (or at the ceiling cadence while it persists). ``now`` is the
        transaction's clock: every pod parked in one transaction falls
        due at one instant, so one flush pass re-offers the wave whole
        (a wave split across two passes would see its own first half,
        re-admitted by the idle override, as a busy queue and re-park
        the rest)."""
        qpi.where, qpi.gone = "shed", False
        self._index[qpi.key] = qpi
        initial, ceiling = 0.5, 5.0
        if self._shed_backoff_fn is not None:
            try:
                initial, ceiling = self._shed_backoff_fn()
            except Exception:
                pass  # a broken knob source must not drop the park
        ready = now + min(
            initial * (2 ** min(qpi.shed_count, 30)), ceiling)
        if qpi.shed_count == 0:
            self._shed_pods += 1
        qpi.shed_count += 1
        self._shed_total += 1
        heapq.heappush(self._shed, (ready, next(self._seq), qpi))
        self._shed_live += 1

    def release_shed(self) -> int:
        """Overload cleared below the shedding rung: re-admit EVERY shed
        pod to activeQ now instead of waiting out each backoff. Returns
        the count."""
        with self._cond:
            moved = 0
            now = time.monotonic()
            for _ready, _seq, qpi in self._shed:
                if qpi.gone or qpi.where != "shed":
                    continue
                qpi.added_at = now  # queue wait restarts at readmission
                self._push_active(qpi)
                moved += 1
            self._shed = []
            self._shed_live = 0
            self._shed_readmitted += moved
            if moved:
                self._cond.notify_all()
        if moved:
            jnote("queue.release_shed", pods=moved)
        return moved

    def _push_backoff(self, qpi: QueuedPodInfo,
                      ready: Optional[float] = None) -> None:
        """Push onto the backoff heap and index (caller holds the lock).
        ``ready`` overrides the attempt-derived backoff expiry
        (quarantine pins it at the ceiling)."""
        qpi.where, qpi.gone = "backoff", False
        self._index[qpi.key] = qpi
        if ready is None:
            ready = qpi.last_failure_at + self._backoff_duration(qpi)
        heapq.heappush(self._backoff, (ready, next(self._seq), qpi))
        self._backoff_live += 1

    def _mark_popped(self, qpi: QueuedPodInfo) -> None:
        """Pod leaves the queues for a scheduling attempt (caller holds the
        lock): drop it from the index so updates during the attempt don't
        touch it (it re-enters via add_unschedulable/requeue_backoff)."""
        qpi.popped_at_cycle = self._move_cycle
        qpi.where = "popped"
        qpi.gathered_at = time.monotonic()
        self._index.pop(qpi.key, None)

    def _backoff_duration(self, qpi: QueuedPodInfo) -> float:
        """1s initial, ×2 per attempt, 10s cap (reference queue.go:218-235)."""
        d = self._backoff_initial
        for _ in range(1, qpi.attempts):
            d *= 2
            if d >= self._backoff_max:
                return self._backoff_max
        return d

    def _is_backing_off(self, qpi: QueuedPodInfo) -> bool:
        return (qpi.last_failure_at + self._backoff_duration(qpi)
                > time.monotonic())

    def _flush_loop(self, interval: float) -> None:
        """Drain due backoff entries into activeQ — the flusher the
        reference never implemented (queue.go:136-139 panics)."""
        while True:
            readmitted = 0
            with self._cond:
                if self._closed:
                    return
                now = time.monotonic()
                fired = False
                while self._backoff and self._backoff[0][0] <= now:
                    _, _, qpi = heapq.heappop(self._backoff)
                    if qpi.gone or qpi.where != "backoff":
                        continue  # lazily-deleted or already moved elsewhere
                    self._backoff_live -= 1
                    self._push_active(qpi)
                    fired = True
                # Shed lane: each due entry is RE-OFFERED to the
                # admission gate — recovered ⇒ activeQ (counted
                # readmission); still shedding ⇒ re-park with doubled
                # backoff. This is the never-dropped guarantee: a shed
                # pod keeps knocking at the ceiling cadence forever.
                # A DRAINED activeQ overrides a shedding verdict: the
                # overload controller only observes windows while
                # batches resolve, so an engine that went idle with
                # shed work parked would otherwise hold its last level
                # forever — and an idle engine is, by definition, not
                # overloaded (re-admitted pods then produce the clean
                # windows that walk the controller back down).
                # Snapshotted BEFORE the drain: the first readmission
                # makes activeQ non-empty, and re-testing live would
                # dribble one pod per flush pass out of a lane the
                # idle override means to release wholesale.
                idle = self._active_live == 0
                while self._shed and self._shed[0][0] <= now:
                    _, _, qpi = heapq.heappop(self._shed)
                    if qpi.gone or qpi.where != "shed":
                        continue
                    self._shed_live -= 1
                    if idle or self._admits(qpi.pod):
                        # Queue-wait restarts at readmission: the shed
                        # park is ADMISSION latency (counted here and
                        # visible in create→bound), not active-queue
                        # residency — without the re-stamp, every
                        # readmitted pod's bind would re-burn the
                        # queue-wait SLO with the PAST overload's wait
                        # and hold the controller engaged forever.
                        qpi.added_at = now
                        self._push_active(qpi)
                        self._shed_readmitted += 1
                        readmitted += 1
                        fired = True
                    else:
                        self._push_shed(qpi, now)
                if fired:
                    self._cond.notify_all()
            if readmitted:
                # One aggregate event per flush pass, outside the lock
                # (see add_many's shed event for the rationale).
                jnote("queue.readmit", pods=readmitted)
            time.sleep(interval)

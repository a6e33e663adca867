"""Event-sourced in-process cluster store.

Replaces the reference's control plane — a real kube-apiserver backed by etcd
(reference k8sapiserver/k8sapiserver.go:43-105) — with a typed, versioned,
watchable state store. The architectural essence preserved (SURVEY §1): the
scheduler and the scenario never call each other; both mutate/observe shared
cluster state here, coupled only by watch events.

Capabilities mirrored:
  * CRUD with optimistic concurrency (resource_version) — the apiserver/etcd
    compare-and-swap contract.
  * Versioned watch streams: every mutation is appended to a global event log
    with a monotonically increasing resource version; watchers can replay
    from any version (etcd watch semantics).
  * Durable snapshot/restore (the etcd-persistence capability: reference
    docker-compose.yml mounts an etcd volume; restart against the same etcd
    and state survives): ``snapshot`` / ``save``, ``restore`` / ``load``,
    and state/persistence.py's checkpointer.
"""
from __future__ import annotations

import gc
import json
import threading
import time
from typing import Any, Dict, Iterator, List, NamedTuple, Optional

from ..errors import AlreadyExistsError, ConflictError, NotFoundError
from . import objects as obj
from .objects import deepcopy_obj, kind_of, snapshot_obj, untrack_obj


class EventType:
    ADDED = "ADDED"
    MODIFIED = "MODIFIED"
    DELETED = "DELETED"


class WatchEvent(NamedTuple):
    # NamedTuple, not dataclass: two are built per mutated object (ADD +
    # MODIFIED on bind) and a 10k-pod burst was paying ~0.15 s per 10k
    # just in generated dataclass __init__ on the 1-core host.
    type: str  # EventType
    kind: str  # "Pod" | "Node" | ...
    object: Any  # snapshot of the object after (or, for DELETED, at) mutation
    old_object: Any = None  # snapshot before mutation (MODIFIED/DELETED)
    resource_version: int = 0


class Watcher:
    """A watch stream. Iterate or ``next_event(timeout)``; ``stop()`` ends it."""

    def __init__(self, store: "ClusterStore", kinds: Optional[List[str]], start_rv: int):
        self._store = store
        self._kinds = set(kinds) if kinds else None
        self._cursor = start_rv
        self._stopped = threading.Event()

    def wants(self, ev: WatchEvent) -> bool:
        return self._kinds is None or ev.kind in self._kinds

    @property
    def cursor(self) -> int:
        """Resource version this watch has scanned to — includes events
        skipped by the kind filter, so a resumed watch (the HTTP
        long-poll) neither rescans them nor spuriously falls behind."""
        return self._cursor

    def next_event(self, timeout: Optional[float] = None) -> Optional[WatchEvent]:
        """Next matching event after the cursor, or None on timeout/stop."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._store._cond:
            while not self._stopped.is_set():
                ev, scanned_to = self._store._next_after(self._cursor, self._kinds)
                # Advance past non-matching events too, so a kind-filtered
                # watcher neither rescans them nor "falls behind" on them.
                self._cursor = scanned_to
                if ev is not None:
                    return ev
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return None
                    self._store._cond.wait(remaining)
                else:
                    self._store._cond.wait(1.0)
        return None

    def next_events(self, max_n: int,
                    timeout: Optional[float] = None) -> List[WatchEvent]:
        """Up to ``max_n`` matching events in ONE lock acquisition (the
        per-event ``next_event`` loop costs a condvar round-trip per event —
        a 10k-object burst is 10k acquisitions a batch drain collapses to a
        handful). Blocks like ``next_event`` until at least one event
        matches, the timeout lapses (→ []), or the watcher stops."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._store._cond:
            while not self._stopped.is_set():
                evs, scanned_to = self._store._drain_after(
                    self._cursor, self._kinds, max_n)
                self._cursor = scanned_to
                if evs:
                    return evs
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return []
                    self._store._cond.wait(remaining)
                else:
                    self._store._cond.wait(1.0)
        return []

    def __iter__(self) -> Iterator[WatchEvent]:
        while not self._stopped.is_set():
            ev = self.next_event(timeout=0.1)
            if ev is not None:
                yield ev

    def stop(self) -> None:
        self._stopped.set()
        with self._store._cond:
            self._store._cond.notify_all()


class ClusterStore:
    """Thread-safe typed object store with versioned watch log."""

    KINDS = ("Pod", "Node", "PersistentVolume", "PersistentVolumeClaim",
             "Event", "PodDisruptionBudget", "Lease", "ReplicaStatus",
             "ShardMove", "Incarnation")

    def __init__(self, max_log: int = 100_000):
        self._cond = threading.Condition()
        self._rv = 0
        self._objects: Dict[str, Dict[str, Any]] = {k: {} for k in self.KINDS}
        self._log: List[WatchEvent] = []
        self._max_log = max_log
        self._log_base = 0  # rv of the oldest retained log entry - 1
        # Objects stored off the collector's lists / still on them (the
        # Python walk, MINISCHED_NO_NATIVE=1): counted by _keep.
        self._untracked = 0
        self._tracked = 0

    # ---- CRUD -----------------------------------------------------------

    # Copy discipline (the client-go contract, one copy per mutation):
    # the store keeps its own clone of every written object; watch events
    # and the informer's initial list SHARE those stored snapshots —
    # stored objects are replacement-only, so a snapshot never mutates
    # after publication, but consumers must treat event objects as
    # READ-ONLY (exactly client-go's shared-informer rule; engine/
    # pvcontroller mutate only fresh get() copies). get()/list() still
    # return private deep copies the caller may freely mutate. Mutators
    # return the caller's own (rv-stamped) object, not a third clone.
    # Being immutable and acyclic, every stored object and every watch
    # event leaves the cycle collector's lists as it is built, under the
    # lock and before it is published (objects.snapshot_obj, untrack_obj;
    # reference counts still free them): a stored object is NEVER mutated,
    # since nothing would find a cycle made through it.

    def _keep(self, stored: Any) -> Any:
        """Count an object the store keeps by whether it left the
        collector's lists."""
        if gc.is_tracked(stored):
            self._tracked += 1
        else:
            self._untracked += 1
        return stored

    def create(self, o: Any) -> Any:
        kind = kind_of(o)
        with self._cond:
            key = o.key
            if key in self._objects[kind]:
                raise AlreadyExistsError(f"{kind} {key!r} already exists")
            self._rv += 1
            o.metadata.resource_version = self._rv
            if not o.metadata.creation_timestamp:
                o.metadata.creation_timestamp = time.time()
            stored = self._keep(snapshot_obj(o))
            self._objects[kind][key] = stored
            self._append(WatchEvent(EventType.ADDED, kind, stored,
                                    None, self._rv))
            return o

    def create_many(self, objs: List[Any]) -> List[Any]:
        """Bulk create: one lock acquisition and one watcher wake-up for a
        whole burst of objects (a 10k-pod workload submission is 10k lock
        round-trips + 10k condvar broadcasts on the per-object path; the
        watch log stays rv-contiguous either way). All-or-nothing on name
        collisions: the duplicate check runs for the entire batch before
        the first mutation, so a failed call leaves no partial state."""
        objs = list(objs)  # two passes below — an iterator must not exhaust
        now = time.time()
        with self._cond:
            seen = set()
            for o in objs:
                kind, key = kind_of(o), o.key
                if key in self._objects[kind] or (kind, key) in seen:
                    raise AlreadyExistsError(f"{kind} {key!r} already exists")
                seen.add((kind, key))
            for o in objs:
                kind = kind_of(o)
                self._rv += 1
                o.metadata.resource_version = self._rv
                if not o.metadata.creation_timestamp:
                    o.metadata.creation_timestamp = now
                stored = self._keep(snapshot_obj(o))
                self._objects[kind][o.key] = stored
                self._append(WatchEvent(EventType.ADDED, kind, stored,
                                        None, self._rv), notify=False)
            self._cond.notify_all()
        return objs

    def get(self, kind: str, key: str) -> Any:
        # Stored objects are replacement-only (update/bind deep-copy before
        # storing), so copying can happen outside the lock.
        with self._cond:
            try:
                o = self._objects[kind][key]
            except KeyError:
                raise NotFoundError(f"{kind} {key!r} not found")
        return deepcopy_obj(o)

    def list(self, kind: str) -> List[Any]:
        with self._cond:
            refs = list(self._objects[kind].values())
        return [deepcopy_obj(o) for o in refs]

    def stats(self) -> Dict[str, Any]:
        """One consistent reading of the store's observable state for
        the apiserver's /metrics endpoint: per-kind object counts, the
        current resource version, the watch log's retained depth, and
        the objects stored off and on the collector's lists."""
        with self._cond:
            return {
                "objects": {k: len(v) for k, v in self._objects.items()},
                "resource_version": self._rv,
                "watch_log_depth": len(self._log),
                "watch_log_capacity": self._max_log,
                **self.snapshot_counts(),
            }

    def snapshot_counts(self) -> Dict[str, int]:
        """Objects stored since the store was made: off the cycle
        collector's lists (``snapshots_untracked_total``) and on them
        (``snapshots_tracked_total``, the Python walk's). Read without
        the lock: two monotonic counters, for the engine's metrics."""
        return {"snapshots_untracked_total": self._untracked,
                "snapshots_tracked_total": self._tracked}

    def count(self, kind: str) -> int:
        with self._cond:
            return len(self._objects[kind])

    def update(self, o: Any, *, check_version: bool = False) -> Any:
        kind = kind_of(o)
        with self._cond:
            key = o.key
            old = self._objects[kind].get(key)
            if old is None:
                raise NotFoundError(f"{kind} {key!r} not found")
            if old is o:
                # The caller is holding the published snapshot itself (a
                # watch-event object) — stamping rv into it would corrupt
                # the already-delivered event and make the MODIFIED event's
                # old/new alias one object. Enforce the read-only contract:
                # mutate a get()/list() copy instead.
                raise ValueError(
                    f"update({kind} {key!r}) called with the stored "
                    "snapshot itself; watch/list_and_watch objects are "
                    "read-only — mutate a get() copy")
            if check_version and o.metadata.resource_version != old.metadata.resource_version:
                raise ConflictError(
                    f"{kind} {key!r}: stale resource_version "
                    f"{o.metadata.resource_version} != {old.metadata.resource_version}")
            self._rv += 1
            o.metadata.resource_version = self._rv
            stored = self._keep(snapshot_obj(o))
            self._objects[kind][key] = stored
            self._append(WatchEvent(EventType.MODIFIED, kind, stored,
                                    old, self._rv))
            return o

    def delete(self, kind: str, key: str) -> None:
        with self._cond:
            old = self._objects[kind].pop(key, None)
            if old is None:
                raise NotFoundError(f"{kind} {key!r} not found")
            self._rv += 1
            self._append(WatchEvent(EventType.DELETED, kind, old,
                                    old, self._rv))

    # ---- Typed conveniences --------------------------------------------

    def bind_pod(self, pod_key: str, node_name: str) -> Any:
        """Commit a binding (reference minisched/minisched.go:266-277 POSTs a
        v1.Binding; here the binding subresource is a store-level CAS that
        fails if the pod is already bound or the node is gone)."""
        with self._cond:
            pod = self._objects["Pod"].get(pod_key)
            if pod is None:
                raise NotFoundError(f"Pod {pod_key!r} not found")
            if pod.spec.node_name:
                raise ConflictError(
                    f"Pod {pod_key!r} already bound to {pod.spec.node_name!r}")
            if node_name not in self._objects["Node"]:
                raise NotFoundError(f"Node {node_name!r} not found")
            updated = deepcopy_obj(pod)
            updated.spec.node_name = node_name
            updated.status.phase = obj.PodPhase.RUNNING
            updated.status.unschedulable_plugins = []
            updated.status.message = ""
            updated.status.scheduled_time = time.time()
            return self.update(updated)

    def bind_pods(self, assignments) -> List[str]:
        """Bulk binding commit: one lock acquisition for a whole batch of
        (pod_key, node_name) pairs; returns the keys of the newly-bound
        pods (keys, not objects — the live stored objects must not escape
        the store's copy-on-read isolation). Pods already bound/deleted or
        nodes gone are skipped (callers diff the returned keys against the
        request to re-schedule).
        Uses shallow_evolve instead of deep copies — stored objects are
        replacement-only, so structural sharing with superseded versions is
        safe; watch events carry the same immutable-by-convention snapshots.
        The evolved objects leave the collector's lists (untrack_obj walks
        only what is new: the shared parts are off them already).
        One watcher wake-up for the whole batch (a per-pod notify_all is
        10k condvar broadcasts under the lock)."""
        evolve = obj.shallow_evolve
        bound: List[str] = []
        now = time.time()
        with self._cond:
            pods_map = self._objects["Pod"]
            nodes_map = self._objects["Node"]
            for pod_key, node_name in assignments:
                pod = pods_map.get(pod_key)
                if pod is None or pod.spec.node_name:
                    continue
                if node_name not in nodes_map:
                    continue
                self._rv += 1
                new = evolve(
                    pod,
                    metadata=evolve(pod.metadata, resource_version=self._rv),
                    spec=evolve(pod.spec, node_name=node_name),
                    status=evolve(pod.status, phase=obj.PodPhase.RUNNING,
                                  unschedulable_plugins=[], message="",
                                  scheduled_time=now))
                untrack_obj(new)
                pods_map[pod_key] = self._keep(new)
                self._append(WatchEvent(EventType.MODIFIED, "Pod", new, pod,
                                        self._rv), notify=False)
                bound.append(pod_key)
            if bound:
                self._cond.notify_all()
        return bound

    def fail_pods(self, verdicts) -> List[str]:
        """Bulk FailedScheduling status commit — the failure-path twin of
        ``bind_pods``: one lock acquisition for a whole batch of
        (pod_key, unschedulable_plugins, message) triples. Pods that were
        bound or deleted mid-flight are skipped (their status must not be
        clobbered with a stale verdict); returns the keys that were NOT
        found so the caller can drop them from its queues. Uses
        shallow_evolve (stored objects are replacement-only) and one
        watcher wake-up for the whole batch — a skew-constrained burst
        revokes thousands of pods per cycle, and the per-pod
        get+mutate+update path was two deep copies plus a condvar
        broadcast per revocation."""
        evolve = obj.shallow_evolve
        missing: List[str] = []
        with self._cond:
            pods_map = self._objects["Pod"]
            dirty = False
            for pod_key, plugins, message in verdicts:
                pod = pods_map.get(pod_key)
                if pod is None:
                    missing.append(pod_key)
                    continue
                if pod.spec.node_name:
                    continue  # bound by a competing path; verdict is stale
                self._rv += 1
                new = evolve(
                    pod,
                    metadata=evolve(pod.metadata, resource_version=self._rv),
                    status=evolve(pod.status,
                                  unschedulable_plugins=sorted(plugins),
                                  message=message))
                untrack_obj(new)
                pods_map[pod_key] = self._keep(new)
                self._append(WatchEvent(EventType.MODIFIED, "Pod", new, pod,
                                        self._rv), notify=False)
                dirty = True
            if dirty:
                self._cond.notify_all()
        return missing

    # ---- Watch ----------------------------------------------------------

    def watch(self, kinds: Optional[List[str]] = None,
              from_version: Optional[int] = None) -> Watcher:
        with self._cond:
            start = self._rv if from_version is None else from_version
            if start < self._log_base:
                raise ValueError(
                    f"watch from_version={start} is older than retained log "
                    f"(base {self._log_base}); re-list and restart the watch")
            return Watcher(self, kinds, start)

    def list_and_watch(self, kinds: Optional[List[str]] = None):
        """Atomic LIST + WATCH: the watcher's cursor is the exact version the
        lists were taken at, so no event is missed or delivered twice
        (client-go reflector's list-then-watch-from-listRV contract).

        The returned lists SHARE the stored snapshots (read-only, like the
        watch events they are delivered alongside) — a 50k-node initial
        sync must not clone the whole cluster before the first cycle."""
        with self._cond:
            lists = {k: list(self._objects[k].values())
                     for k in (kinds or self.KINDS)}
            watcher = Watcher(self, kinds, self._rv)
        return lists, watcher

    def resource_version(self) -> int:
        with self._cond:
            return self._rv

    def _append(self, ev: WatchEvent, notify: bool = True) -> None:
        untrack_obj(ev)  # strings, integers and stored snapshots only
        self._log.append(ev)
        if len(self._log) > self._max_log:
            drop = len(self._log) - self._max_log
            self._log_base = self._log[drop - 1].resource_version
            del self._log[:drop]
        if notify:
            self._cond.notify_all()

    def _next_after(self, rv: int, kinds: Optional[set]):
        """Return (first matching event after rv, cursor to advance to).

        Every mutation appends exactly one event with rv = previous + 1, so
        the log is rv-contiguous: _log[i].resource_version == _log_base+1+i.
        When no event matches, the cursor still advances to the end of the
        log (non-matching events are consumed, not rescanned).
        """
        if rv < self._log_base:
            raise ValueError(
                f"watch cursor {rv} fell behind retained log (base "
                f"{self._log_base}); re-list and restart the watch")
        for ev in self._log[rv - self._log_base:]:
            if kinds is None or ev.kind in kinds:
                return ev, ev.resource_version
        return None, self._rv

    def _drain_after(self, rv: int, kinds: Optional[set], max_n: int):
        """Batch form of _next_after: (up to max_n matching events, cursor).
        The cursor lands on the last MATCHING event consumed (or the log
        end when under max_n), so unconsumed matches are never skipped."""
        if rv < self._log_base:
            raise ValueError(
                f"watch cursor {rv} fell behind retained log (base "
                f"{self._log_base}); re-list and restart the watch")
        out: List[WatchEvent] = []
        cursor = self._rv
        for ev in self._log[rv - self._log_base:]:
            if kinds is None or ev.kind in kinds:
                out.append(ev)
                if len(out) >= max_n:
                    cursor = ev.resource_version
                    break
        return out, cursor

    # ---- Snapshot / restore (etcd durability analog) -------------------

    def for_each(self, kind: str, fn) -> None:
        """READ-ONLY visitor over the stored objects of ``kind`` WITHOUT
        the copy-on-read isolation — for aggregate scans (e.g. the
        engine's PodDisruptionBudget counting) where list()'s per-object
        deep copy would dominate. ``fn`` runs under the store lock and
        MUST NOT mutate or retain the objects (the read-only contract
        watch/list_and_watch snapshots already carry)."""
        with self._cond:
            for o in self._objects[kind].values():
                fn(o)

    def snapshot(self) -> Dict[str, Any]:
        # Only the reference grab runs under the lock; the O(objects)
        # to_dict conversion happens outside it (stored objects are
        # replacement-only, so the references are immutable snapshots) —
        # an interval checkpoint at 50k nodes must not stall every
        # scheduling-cycle read for the whole serialization.
        with self._cond:
            rv = self._rv
            cols = {kind: dict(col) for kind, col in self._objects.items()}
        return {
            "resource_version": rv,
            "objects": {
                kind: {k: obj.to_dict(o) for k, o in col.items()}
                for kind, col in cols.items()
            },
        }

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.snapshot(), f)

    @classmethod
    def restore(cls, snap: Dict[str, Any]) -> "ClusterStore":
        """A store holding ``snap``'s objects at its resource version. The
        uid counter moves past every restored ``uid-N``, so objects made
        after a restart never reuse a uid from before it."""
        from . import serde

        store = cls()
        store._rv = snap["resource_version"]
        store._log_base = store._rv
        max_uid = 0
        for kind, col in snap["objects"].items():
            for key, d in col.items():
                o = serde.from_dict(kind, d)
                uid = o.metadata.uid
                if uid.startswith("uid-") and uid[4:].isdigit():
                    max_uid = max(max_uid, int(uid[4:]))
                untrack_obj(o)
                store._objects[kind][key] = store._keep(o)
        obj.bump_uid_counter(max_uid)
        return store

    @classmethod
    def load(cls, path: str) -> "ClusterStore":
        with open(path) as f:
            return cls.restore(json.load(f))

"""Informer layer: watch-pump threads dispatching to typed handlers.

Analog of client-go shared informers the reference relies on everywhere
(reference scheduler/scheduler.go:54,72-73 builds/starts the factory;
minisched/eventhandler.go:14-76 registers handlers). Semantics preserved:
  * start() performs an initial LIST sync — every pre-existing object is
    delivered as an Add before live events flow (client-go cache sync).
  * wait_for_cache_sync() blocks until that initial delivery completed.
  * handlers run on the informer's dispatch thread, not the mutator's
    (the client-go watch-pump goroutine boundary, SURVEY §3.4).
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

from ..faults import FAULTS, FaultInjected
from .store import ClusterStore, EventType, WatchEvent

import logging

log = logging.getLogger(__name__)


@dataclass
class ResourceEventHandlers:
    on_add: Optional[Callable[[Any], None]] = None
    on_update: Optional[Callable[[Any, Any], None]] = None  # (old, new)
    on_delete: Optional[Callable[[Any], None]] = None
    # Optional pre-filter, mirroring client-go FilteringResourceEventHandler
    # (used by the reference to split scheduled vs unscheduled pods,
    # eventhandler.go:20-35).
    filter: Optional[Callable[[Any], bool]] = None
    # Optional bulk add: when a burst of ADDED events of one kind arrives
    # back-to-back (workload submission, initial sync), the dispatcher
    # hands the whole run to on_add_many in one call instead of one
    # on_add per object — consumers turn 10k per-object lock round-trips
    # into one. Falls back to on_add when absent.
    on_add_many: Optional[Callable[[List[Any]], None]] = None
    # Bulk update, same contract for MODIFIED runs (a 10k bulk bind emits
    # 10k MODIFIED events back-to-back; per-event dispatch steals the
    # single-core host from the binder thread mid-commit). Receives
    # [(old, new), ...]; falls back to on_update when absent.
    on_update_many: Optional[Callable[[List[tuple]], None]] = None


class InformerFactory:
    """One dispatch thread fanning store watch events out to handlers."""

    def __init__(self, store: ClusterStore):
        self.store = store
        self._handlers: Dict[str, List[ResourceEventHandlers]] = {}
        self._thread: Optional[threading.Thread] = None
        self._watcher = None
        self._synced = threading.Event()
        self._stop = threading.Event()
        self._lock = threading.Lock()

    def add_handlers(self, kind: str, handlers: ResourceEventHandlers) -> None:
        with self._lock:
            if self._thread is not None:
                raise RuntimeError("informer already started")
            self._handlers.setdefault(kind, []).append(handlers)

    def start(self) -> None:
        with self._lock:
            if self._thread is not None:
                return
            self._stop.clear()
            kinds = list(self._handlers) or None
            # Atomic list+watch: no gap, no double delivery.
            initial, self._watcher = self.store.list_and_watch(kinds=kinds)
            self._thread = threading.Thread(
                target=self._run, args=(initial,), daemon=True,
                name="informer-dispatch")
            self._thread.start()

    def wait_for_cache_sync(self, timeout: float = 10.0) -> bool:
        return self._synced.wait(timeout)

    def shutdown(self) -> None:
        self._stop.set()
        if self._watcher is not None:
            self._watcher.stop()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        self._synced.clear()

    # ---- dispatch -------------------------------------------------------

    # Initial-sync delivery order: nodes and volumes before pods, so
    # handlers that account pods against node state (feature-cache bind
    # accounting) see the nodes first on restart/restore.
    SYNC_ORDER = ("Node", "PersistentVolume", "PersistentVolumeClaim",
                  "Pod", "Event")

    @classmethod
    def _in_sync_order(cls, kinds) -> List[str]:
        return sorted(kinds, key=lambda k: (
            cls.SYNC_ORDER.index(k) if k in cls.SYNC_ORDER
            else len(cls.SYNC_ORDER)))

    def _run(self, initial: Dict[str, List[Any]]) -> None:
        for kind in self._in_sync_order(initial):
            self._dispatch_adds(kind, initial[kind])
        self._synced.set()
        while not self._stop.is_set():
            try:
                # Fault gate: informer dispatch. Placed BEFORE the drain
                # so an injected err/stall delays delivery (the real
                # failure mode: a wedged/lagging pump) without ever
                # dropping events already taken off the watch — and a
                # raise here must not kill the pump thread.
                FAULTS.hit("informer")
            except FaultInjected:
                log.warning("informer dispatch fault injected; pump "
                            "continues next iteration")
                continue
            try:
                # Batch drain: one store-lock acquisition per burst instead
                # of one per event (a 10k-pod submission would otherwise
                # cost 10k condvar round-trips on this thread). 4096 =
                # the apiserver's /watch limit cap: over the wire each
                # drain is one long-poll round trip, so a 10k-pod burst
                # arrives in 3 polls instead of 10.
                evs = self._watcher.next_events(4096, timeout=0.2)
            except ValueError:
                # Cursor fell behind the store's retained log (pathological
                # backlog). Re-list atomically and redeliver current state as
                # Adds (at-least-once: handlers must tolerate duplicate adds,
                # which queue/cache consumers do via keyed dedupe). Deletions
                # that happened in the gap cannot be synthesized without a
                # local cache; surface that loudly.
                log.error(
                    "informer fell behind watch log; re-listing and "
                    "redelivering adds (deletes in the gap are lost)")
                # The re-list itself is a network call when the store is
                # a RemoteStore (engine-over-the-wire mode); a transient
                # failure here — e.g. the server still restarting, which
                # is exactly when 410s happen — must retry, not kill the
                # watch pump (the engine would then pend every future
                # pod with healthz green). In-process stores never throw
                # here, so the loop is wire-only in practice.
                while not self._stop.is_set():
                    try:
                        initial, self._watcher = self.store.list_and_watch(
                            kinds=list(self._handlers) or None)
                        break
                    except Exception:
                        log.exception("informer re-list failed; retrying")
                        self._stop.wait(0.5)
                else:
                    return
                # Redeliver in SYNC_ORDER like the initial sync: a Pod bound
                # to a Node created in the gap must see that Node's add
                # first, or bind accounting is silently dropped (unknown
                # node) and the node over-commits.
                for kind in self._in_sync_order(initial):
                    self._dispatch_adds(kind, initial[kind])
                continue
            # Group consecutive ADDED / MODIFIED runs of one kind so
            # bulk-capable handlers see the whole burst at once;
            # everything else dispatches per event in arrival order.
            i, n = 0, len(evs)
            while i < n:
                ev = evs[i]
                if ev.type in (EventType.ADDED, EventType.MODIFIED):
                    j = i + 1
                    while (j < n and evs[j].type == ev.type
                           and evs[j].kind == ev.kind):
                        j += 1
                    if ev.type == EventType.ADDED:
                        self._dispatch_adds(
                            ev.kind, [e.object for e in evs[i:j]])
                    else:
                        self._dispatch_updates(
                            ev.kind,
                            [(e.old_object, e.object) for e in evs[i:j]])
                    i = j
                else:
                    self._dispatch(ev)
                    i += 1

    def _dispatch_adds(self, kind: str, objs: List[Any]) -> None:
        """Deliver a run of ADDED objects of one kind: bulk-capable
        handlers get one on_add_many call, the rest one on_add each."""
        if not objs:
            return

        def safe_filter(flt, o) -> bool:
            try:
                return flt(o)
            except Exception:  # a bad object loses itself, not the burst
                log.exception("informer filter failed for %s", kind)
                return False

        def add_one_by_one(h, batch) -> None:
            # Per-object isolation: one bad object must not eat the rest
            # of the burst (same contract as _dispatch).
            deliver = h.on_add or (lambda o: h.on_add_many([o]))
            for o in batch:
                try:
                    deliver(o)
                except Exception:
                    log.exception("informer add handler failed for %s", kind)

        for h in self._handlers.get(kind, ()):
            batch = (objs if h.filter is None
                     else [o for o in objs if safe_filter(h.filter, o)])
            if not batch:
                continue
            if h.on_add_many is not None and len(batch) > 1:
                try:
                    h.on_add_many(batch)
                except Exception:
                    # The bulk call gives no indication how far it got, and
                    # the watch events are already consumed — redeliver per
                    # object so one bad object can't strand the rest
                    # Pending forever (consumers dedupe by key, so objects
                    # the bulk call DID process are delivered at-least-once,
                    # not twice).
                    log.exception(
                        "informer bulk add handler failed for %s; "
                        "redelivering burst per-object", kind)
                    add_one_by_one(h, batch)
            elif h.on_add or h.on_add_many:
                add_one_by_one(h, batch)

    def _dispatch_updates(self, kind: str, pairs: List[tuple]) -> None:
        """Deliver a run of MODIFIED (old, new) pairs of one kind:
        bulk-capable handlers get one on_update_many call, the rest one
        on_update each (per-object isolation, same contract as adds)."""
        if not pairs:
            return

        def safe_filter(flt, o) -> bool:
            try:
                return flt(o)
            except Exception:
                log.exception("informer filter failed for %s", kind)
                return False

        def update_one_by_one(h, batch) -> None:
            deliver = (h.on_update
                       or (lambda old, new: h.on_update_many([(old, new)])))
            for old, new in batch:
                try:
                    deliver(old, new)
                except Exception:
                    log.exception(
                        "informer update handler failed for %s", kind)

        for h in self._handlers.get(kind, ()):
            if not (h.on_update or h.on_update_many):
                continue
            batch = (pairs if h.filter is None
                     else [p for p in pairs if safe_filter(h.filter, p[1])])
            if not batch:
                continue
            if h.on_update_many is not None and len(batch) > 1:
                try:
                    h.on_update_many(batch)
                except Exception:
                    log.exception(
                        "informer bulk update handler failed for %s; "
                        "redelivering burst per-object", kind)
                    update_one_by_one(h, batch)
            else:
                update_one_by_one(h, batch)

    def _dispatch(self, ev: WatchEvent) -> None:
        for h in self._handlers.get(ev.kind, ()):
            try:
                if h.filter is not None and not h.filter(ev.object):
                    # client-go filtering handlers also deliver "object
                    # stopped matching the filter" as a delete; the reference
                    # does not depend on that subtlety, so plain skip.
                    continue
                if ev.type == EventType.ADDED and h.on_add:
                    h.on_add(ev.object)
                elif ev.type == EventType.MODIFIED and h.on_update:
                    h.on_update(ev.old_object, ev.object)
                elif ev.type == EventType.DELETED and h.on_delete:
                    h.on_delete(ev.object)
            except Exception:  # handler errors must not kill the pump
                log.exception(
                    "informer handler failed for %s %s", ev.type, ev.kind)

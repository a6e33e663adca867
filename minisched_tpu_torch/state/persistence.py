"""Durable checkpoint/restore wired into the process lifecycle — the
etcd-persistence analog.

The reference gets durability ambiently: every object lives in etcd
(reference k8sapiserver/k8sapiserver.go:93-105) and docker-compose mounts
an etcd data volume (reference docker-compose.yml:20-21) — kill the
process, restart it against the same etcd, and the cluster state
survives; only scheduler-internal state (queues, waiting pods) is
volatile and is rebuilt from the surviving objects. The rebuild's store
is in-process, so the same capability is explicit:

  * ``open_or_restore(path)`` — boot-time restore: load the last
    snapshot if one exists, else start empty (the "same etcd volume"
    contract).
  * ``Checkpointer`` — background interval checkpoints + a final
    checkpoint on ``close()`` (clean shutdown) + on-demand
    ``checkpoint()`` (the apiserver's POST /checkpoint). No-op when the
    store hasn't advanced since the last write.

Crash consistency: the snapshot is serialized OUTSIDE the store lock
(ClusterStore.snapshot() only grabs object references under it), written to a temp
file in the target directory, fsync'd, and ``os.replace``d over the
target — atomic on POSIX, so a kill -9 mid-write leaves the previous
complete snapshot, never a torn file. Scheduler-internal state is
deliberately NOT checkpointed (reference parity: queues/waitingPods are
volatile, scheduler/scheduler.go:40-47 rebuilds them from store state on
restart); unbound pods in the snapshot are re-discovered by the engine's
informers on boot and reschedule.
"""
from __future__ import annotations

import json
import logging
import os
import threading
from typing import Optional

from ..faults import FAULTS
from .store import ClusterStore

log = logging.getLogger(__name__)


def open_or_restore(path: str) -> ClusterStore:
    """Restore-on-boot: the store from ``path``'s snapshot, or a fresh
    one when no snapshot exists yet. Restoring bumps the uid counter past
    every restored object (store.restore), so objects created after the
    restart never collide with pre-crash uids."""
    if path and os.path.exists(path):
        store = ClusterStore.load(path)
        n = sum(store.stats()["objects"].values())
        log.info("restored %d objects (rv=%d) from %s", n,
                 store.resource_version(), path)
        return store
    return ClusterStore()


class Checkpointer:
    """Periodic + on-demand + shutdown checkpoints of one store to one
    path. Thread-safe; idempotent close()."""

    def __init__(self, store: ClusterStore, path: str,
                 interval_s: float = 0.0):
        if not path:
            raise ValueError("Checkpointer needs a non-empty path")
        self.store = store
        self.path = path
        self.interval_s = interval_s
        self._saved_rv = -1  # rv the on-disk snapshot reflects
        self._wake = threading.Event()
        self._stopped = False
        self._lock = threading.Lock()  # serializes writers (timer vs API)
        self._thread: Optional[threading.Thread] = None
        if interval_s > 0:
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name="checkpointer")
            self._thread.start()

    def _loop(self) -> None:
        while True:
            self._wake.wait(self.interval_s)
            if self._stopped:
                return
            self._wake.clear()
            try:
                self.checkpoint()
            except Exception:  # a full disk must not kill the timer
                log.exception("interval checkpoint failed")

    def checkpoint(self) -> bool:
        """Write a snapshot now. Returns False when the store hasn't
        advanced since the last successful write (no disk touch)."""
        with self._lock:
            rv = self.store.resource_version()
            if rv == self._saved_rv:
                return False
            # Fault gate: checkpoint write. Fires BEFORE any disk touch,
            # so an injected failure proves the crash-consistency story:
            # the previous complete snapshot survives untouched (the
            # atomic temp-write + rename below is never half-entered).
            FAULTS.hit("checkpoint")
            snap = self.store.snapshot()  # locked inside; serialize outside
            tmp = f"{self.path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(snap, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)
            # snapshot() is atomic, so the file reflects exactly its rv —
            # a mutation racing this write just leaves rv ahead of
            # _saved_rv and the next checkpoint picks it up.
            self._saved_rv = snap["resource_version"]
            return True

    def close(self) -> None:
        """Final checkpoint + stop the interval thread (clean-shutdown
        durability; crash durability comes from the last interval write)."""
        self._stopped = True
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        try:
            self.checkpoint()
        except Exception:
            log.exception("shutdown checkpoint failed")

"""Core scheduling engine: batched cycles over the step.

Rebuild of reference minisched/minisched.go + initialize.go. One cycle
(reference scheduleOne, minisched.go:32-112) becomes one *batch* cycle,
three phases:

  prepare  pop batch → priority sort → encode pods → snapshot node
           features (cache) → tensors on the device (with device
           residency: sparse corrections to the carried free/used_ports)
           → step: filters ∧ → scores → normalize → weigh → sum → greedy
           capacity-aware assignment (the shortlist scan or the full
           greedy kernel on a card) → pack the decision on the device
  resolve  read the packed decision back (one fetch) → replay the
           device's debits and port insertions into the residency mirror
           → per pod: assume + permit plugins (host) or a failure verdict
           → async bulk bind
  commit   flush the batch's failure verdicts in bulk, fold the metrics

With ``config.pipeline`` (the default) the loop is the bounded two-deep
pipeline of ``_run_pipelined``; otherwise the three phases run back to
back on the scheduling thread.

The scheduler "assumes" a pod onto its node at selection time (cache
accounting) and unassumes on any later failure — upstream
kube-scheduler's assume/forget model.

Failure path mirrors ErrorFunc (minisched.go:283-298): record the
rejecting plugins on the pod status, emit a FailedScheduling event, park
the pod in unschedulableQ keyed by those plugins for event-driven revival.
"""
from __future__ import annotations

import logging
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Set

import numpy as np
import torch

from ..config import SchedulerConfig
from ..encode import NodeFeatureCache, encode_pods, to_torch
from ..encode.cache import bucket_for, step_bucket
from ..errors import ConflictError, NotFoundError
from ..ops import prng
from ..ops._cuda_build import KERNELS, LAUNCHES
from ..ops.pipeline import Decision, build_step
from ..ops.residency import (apply_rows, apply_rows_bytes, insert_ports,
                             insert_ports_bytes, pack_decision_i32,
                             pack_decision_slim, replay_ports_host,
                             unpack_decision_i32, unpack_decision_slim)
from ..plugins.base import PluginSet
from ..state.events import ActionType, ClusterEvent, EventBroadcaster, GVK
from ..state.objects import gang_key
from .clusterstate import SharedClusterState
from .queue import (BATCH_CAPACITY, COSCHEDULING, QueuedPodInfo,
                    SchedulingQueue)
from .waitingpod import WaitingPod

log = logging.getLogger(__name__)


class _Batch:
    """One batch moving through prepare → resolve → commit."""

    __slots__ = ("batch", "eb", "names", "row_incs", "decision",
                 "packed_dev", "res_carried", "failures", "n_assigned",
                 "launches", "sl_repairs", "t0", "t_encode", "t_dispatch",
                 "t_fetch_start", "t_fetched", "t_resolved")

    def __init__(self):
        self.failures: List[tuple] = []  # (qpi, plugins, message, retryable)
        self.n_assigned = 0
        self.decision: Optional[Decision] = None
        self.packed_dev = None
        # This batch's free/used_ports input is the device-resident chain:
        # its free_after is carried and its debits replayed into the host
        # mirror at resolve time.
        self.res_carried = False
        self.launches: Dict[str, int] = {}  # kernel launches by name
        self.sl_repairs = 0


def _count_launches(b: _Batch, fn, *args):
    """Run ``fn`` and book the kernel launches it made into ``b``. Only
    the scheduling thread launches kernels, so the deltas are this
    batch's."""
    before = dict(LAUNCHES)
    out = fn(*args)
    for name, n in LAUNCHES.items():
        if n != before[name]:
            b.launches[name] = b.launches.get(name, 0) + n - before[name]
    return out


def _device_copy(a: np.ndarray, device) -> torch.Tensor:
    """A device tensor that never shares memory with ``a`` (on the CPU
    ``from_numpy(a).to("cpu")`` would alias the host mirror)."""
    return torch.tensor(a, device=device)


class _DeviceResidency:
    """Loop-carried device residency of the dynamic node-feature leaves
    (``free`` / ``used_ports``): the step's ``free_after`` stays on the
    device as the next batch's input, and the host uploads only sparse
    host-truth corrections (ops/residency.apply_rows) for the rows where
    its cache diverged from the device's optimistic view — revoked
    placements, failed binds, informer churn and node lifecycle all
    surface through the cache's DynDeltaListener. ``used_ports`` carries
    its own optimistic update: the batch's host-port insertions run on
    the resident copy (ops/residency.insert_ports, the CUDA kernel on a
    card) and are replayed into the host mirror in the same integer op
    order (note_ports), so a port-heavy steady state stays upload-free.

    Invariants (held end to end by tests/test_torch_residency.py and
    tests/test_torch_engine.py against the JAX engine):

      I1. the host mirrors equal the device arrays: the mirror replay is
          an order-free per-node debit aggregate (the batch's requests
          summed per debited node with ``np.add.at``, then one subtract
          per node). Every request and capacity component is an
          integer-valued f32 inside the 2**24 exact-integer window, so
          the aggregate equals the scan's sequential pod-order debits
          bitwise.
      I2. after ``attach`` the device arrays equal the cache's truth on
          every row, so the step consumes exactly what the
          upload-every-batch path would feed it.
      I3. the correction candidate set is complete: a row diverges only
          through a host mutation (the cache marks it into the listener)
          or a device debit (``note_debits`` records it with its
          pre-replay truth). The epoch counter carried on both sides
          turns any protocol break into a full re-upload (counted in
          ``residency_resyncs``), never a silent desync.
    """

    __slots__ = ("listener", "epoch", "free_dev", "ports_dev",
                 "mirror_free", "mirror_ports", "pending_rows",
                 "pending_pre", "pending_prows", "pending_ppre")

    def __init__(self, listener):
        self.listener = listener
        self.epoch = -1          # engine-side epoch; -1 = no device state
        self.free_dev = None     # device (N,R) f32 — next step input
        self.ports_dev = None    # device (N,PORT) i32
        self.mirror_free = None  # host twins of the device arrays
        self.mirror_ports = None
        self.pending_rows = None  # rows the last step debited (unique)
        self.pending_pre = None   # their pre-replay mirror rows
        self.pending_prows = None  # rows the last port insertion touched
        self.pending_ppre = None   # and their pre-insert mirror rows

    def attach(self, eng, nf, delta):
        """Bring the device-resident dynamic leaves up to host truth for
        this batch and splice them into ``nf``. ``delta`` None = full
        rebase (the snapshot returned real leaves and rebased the
        listener); else apply the sparse correction. Raises on epoch
        desync — the caller drops residency and re-snapshots."""
        dev = eng.device
        if delta is None:
            free_np, ports_np = nf.free, nf.used_ports
            self.free_dev = _device_copy(free_np, dev)
            self.ports_dev = _device_copy(ports_np, dev)
            # The snapshot copies are private — they become the mirrors.
            self.mirror_free, self.mirror_ports = free_np, ports_np
            self.epoch = self.listener.epoch
            self.pending_rows = self.pending_pre = None
            self.pending_prows = self.pending_ppre = None
            eng._res_count(resync=True,
                           h2d=free_np.nbytes + ports_np.nbytes)
            return nf._replace(free=self.free_dev,
                               used_ports=self.ports_dev)
        if delta.epoch != self.epoch + 1 or self.free_dev is None:
            raise RuntimeError(
                f"residency epoch desync: device at {self.epoch}, delta "
                f"at {delta.epoch}")
        self.epoch = delta.epoch
        h2d = 0
        self.free_dev, self.mirror_free, n = self._correct(
            self.free_dev, self.mirror_free, delta.rows, delta.free,
            self.pending_rows, self.pending_pre, donate=False)
        h2d += n
        self.ports_dev, self.mirror_ports, n = self._correct(
            self.ports_dev, self.mirror_ports, delta.rows,
            delta.used_ports, self.pending_prows, self.pending_ppre,
            donate=True)
        h2d += n
        self.pending_rows = self.pending_pre = None
        self.pending_prows = self.pending_ppre = None
        eng._res_count(resync=False, h2d=h2d)
        return nf._replace(free=self.free_dev, used_ports=self.ports_dev)

    @staticmethod
    def _correct(state, mirror, rows, vals, pending_rows, pending_pre, *,
                 donate):
        """Upload the rows whose truth differs from the mirror. Rows the
        device changed that the host never touched take their
        pre-replay mirror value as truth (a host-mutated row lands in
        the delta and wins here by exclusion). ``free`` is never
        donated: the carried array is the last Decision's free_after,
        which its batch object still holds."""
        rows = rows.astype(np.int64)
        if pending_rows is not None:
            extra = ~np.isin(pending_rows, rows)
            if extra.any():
                rows = np.concatenate([rows, pending_rows[extra]])
                vals = np.concatenate([vals, pending_pre[extra]])
        if not rows.size:
            return state, mirror, 0
        diff = np.any(vals != mirror[rows], axis=1)
        if not diff.any():
            return state, mirror, 0
        up_r = rows[diff].astype(np.int32)
        up_v = np.ascontiguousarray(vals[diff])
        state = apply_rows(state, up_r, up_v, donate=donate)
        mirror[up_r] = up_v
        return state, mirror, apply_rows_bytes(up_r.shape[0], up_v)

    def note_debits(self, chosen, assigned, requests, free_after_dev):
        """Record the step's device-side debits: fold them into the host
        mirror as the per-node commutative aggregate (exact — I1) and
        adopt ``free_after`` as the carried device array."""
        rows = chosen[assigned].astype(np.int64)
        if rows.size:
            reqs = requests[assigned]
            uniq = np.unique(rows)
            self.pending_pre = self.mirror_free[uniq].copy()
            self.pending_rows = uniq
            agg = np.zeros((uniq.shape[0], reqs.shape[1]),
                           dtype=self.mirror_free.dtype)
            np.add.at(agg, np.searchsorted(uniq, rows), reqs)
            self.mirror_free[uniq] -= agg
        else:
            self.pending_rows = self.pending_pre = None
        self.free_dev = free_after_dev

    def note_ports(self, rows: np.ndarray, ports: np.ndarray) -> int:
        """Run the batch's host-port insertions on the resident
        used_ports (the device op) and replay them into the mirror (the
        host op), tracking touched rows like the free carry's pending
        set. ``rows`` is (P,) chosen with -1 for pods that insert
        nothing. Returns the host→device bytes the insertion uploaded."""
        uniq = np.unique(rows[rows >= 0])
        self.pending_prows = uniq
        self.pending_ppre = self.mirror_ports[uniq].copy()
        replay_ports_host(self.mirror_ports, rows, ports)
        self.ports_dev = insert_ports(self.ports_dev, rows, ports)
        return insert_ports_bytes(rows.shape[0], ports.shape[1])

    def drop(self, reason: str) -> None:
        """Abandon the device state; the next residency batch does a
        full re-upload (the listener rebases itself at collection)."""
        if self.epoch >= 0:
            log.info("device residency dropped (%s); next batch "
                     "re-uploads the dynamic leaves", reason)
        self.epoch = -1
        self.free_dev = self.ports_dev = None
        self.mirror_free = self.mirror_ports = None
        self.pending_rows = self.pending_pre = None
        self.pending_prows = self.pending_ppre = None
        self.listener.invalidate()


class Scheduler:
    def __init__(self, store, plugin_set: PluginSet,
                 config: Optional[SchedulerConfig] = None,
                 shared: Optional[SharedClusterState] = None):
        self.store = store
        self.plugin_set = plugin_set
        self.config = config or SchedulerConfig()
        if self.config.assignment != "greedy":
            raise ValueError(f"unknown assignment strategy "
                             f"{self.config.assignment!r}; this package "
                             "implements 'greedy'")
        # Resolved (and checked) at construction: a missing card fails
        # start_scheduler, not every later cycle.
        self.device = self.config.device()
        self._shared = shared or SharedClusterState(store)
        self._owns_shared = shared is None
        self.cache = self._shared.cache
        self._shared.register(self)
        self.broadcaster = EventBroadcaster(store)

        event_map = plugin_set.cluster_event_map()
        # In-batch capacity losses and bind conflicts are revivable by any
        # node add/update or assigned-pod delete (capacity freed).
        for ev in (ClusterEvent(GVK.NODE, ActionType.ADD | ActionType.UPDATE),
                   ClusterEvent(GVK.POD, ActionType.DELETE)):
            event_map.setdefault(ev, set()).add(BATCH_CAPACITY)
        # Gang-rejected pods revive when a new member arrives (pod add),
        # capacity frees (pod delete), or nodes appear/change.
        for ev in (ClusterEvent(GVK.POD, ActionType.ADD | ActionType.DELETE),
                   ClusterEvent(GVK.NODE, ActionType.ADD | ActionType.UPDATE)):
            event_map.setdefault(ev, set()).add(COSCHEDULING)
        self.queue = SchedulingQueue(
            event_map,
            backoff_initial=self.config.backoff_initial_s,
            backoff_max=self.config.backoff_max_s)

        # Shortlist-compressed arbitration: None = the full greedy kernel.
        self._shortlist_k = (self.config.shortlist_k
                             if self.config.shortlist else None)
        self._step = build_step(plugin_set, shortlist=self._shortlist_k)
        self._key = prng.PRNGKey(self.config.seed)
        self._step_counter = 0
        self.waiting_pods: Dict[str, WaitingPod] = {}
        self._waiting_lock = threading.Lock()
        self._binder = ThreadPoolExecutor(
            max_workers=self.config.bind_workers, thread_name_prefix="binder")
        # Workers of the pipelined cycle (_run_pipelined): batch k-1's
        # failure flush runs on the commit worker (ONE worker: commits
        # apply in batch order) and batch k+1's queue pop on the gather
        # worker, while the scheduling thread resolves batch k.
        self._committer = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="commit")
        self._gatherer = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="gather")
        # Deferred-failure sink: while the scheduling thread resolves a
        # batch, _handle_failure APPENDS verdicts here and _commit_batch
        # flushes them in bulk. Thread-gated: binder/permit threads always
        # take the immediate path.
        self._fail_sink: Optional[List[tuple]] = None
        self._fail_sink_tid = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.filter_names = [p.name for p in plugin_set.filter_plugins]
        # Device copies of the static node-feature leaves, keyed on
        # (cache static version, pad). Scheduling thread only.
        self._nf_static_device = None
        # Slim decision readback rides the residency knob, as in the JAX
        # package: device_resident=False restores the all-i32 fetch.
        self._slim = bool(self.config.device_resident)
        self._residency: Optional[_DeviceResidency] = None
        if self.config.device_resident:
            self._residency = _DeviceResidency(
                self.cache.register_dyn_listener())
        self._metrics_lock = threading.Lock()
        self._metrics: Dict[str, float] = {
            "batches": 0, "pods_seen": 0, "pods_assigned": 0,
            "pods_failed": 0, "pods_bound": 0, "bind_conflicts": 0,
            "cycle_errors": 0,
            # Phase clocks (host seconds). The step window runs from the
            # dispatch to the decision read back and replayed, less the
            # next batch's gather in pipelined mode; it includes the
            # device time.
            "prepare_s_total": 0.0, "step_s_total": 0.0,
            "resolve_s_total": 0.0, "bind_s_total": 0.0,
            # Transfer ledger: host→device bytes (static-leaf uploads,
            # full dynamic-leaf uploads, residency corrections, port
            # insertions; the pod encode is not counted) and
            # device→host bytes of the decision fetches; the residency
            # protocol's hits (delta-corrected batches) and resyncs
            # (full re-uploads).
            "h2d_bytes_total": 0.0, "fetch_bytes_total": 0.0,
            "residency_hits": 0, "residency_resyncs": 0,
            # Shortlist repair events (full-row rescans) and their
            # per-batch complement.
            "shortlist_repairs": 0, "shortlist_certified": 0,
            "last_shortlist_repairs": 0,
            # Kernel launches made by this engine's batches (0 on the
            # CPU): the sum, and one count per kernel.
            "kernel_launches": 0,
            **{f"kernel_launches_{k}": 0 for k in KERNELS},
            "last_batch_size": 0,
        }

    # ---- lifecycle -----------------------------------------------------

    def wants_pod(self, pod) -> bool:
        """Does this scheduler handle the pod? One engine per service
        handles every pod (the JAX package's single-profile mode)."""
        return True

    def start(self) -> None:
        """Start the informers + this engine's scheduling loop
        (reference scheduler.go:72-75)."""
        self._shared.ensure_started()
        self._thread = threading.Thread(target=self.run, daemon=True,
                                        name="scheduling-loop")
        self._thread.start()

    def shutdown(self) -> None:
        self._stop.set()
        self.queue.close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        self._committer.shutdown(wait=True)
        self._gatherer.shutdown(wait=False)
        if self._owns_shared:
            self._shared.shutdown()
        self._binder.shutdown(wait=False)
        self.broadcaster.flush(timeout=2.0)
        self.broadcaster.close()

    def _pop(self) -> List[QueuedPodInfo]:
        cfg = self.config
        return self.queue.pop_batch(
            cfg.max_batch_size, timeout=0.2,
            gather_window=cfg.batch_window_s, gather_idle=cfg.batch_idle_s)

    def run(self) -> None:
        """The scheduling loop (reference minisched.go:28-30
        wait.UntilWithContext(ctx, scheduleOne, 0)); each iteration
        schedules a whole batch. With ``config.pipeline`` the loop is the
        bounded two-deep pipeline of _run_pipelined."""
        if self.config.pipeline:
            self._run_pipelined()
            return
        while not self._stop.is_set():
            batch = self._pop()
            if not batch:
                continue
            try:
                self.schedule_batch(batch)
            except Exception:
                self._cycle_failed(batch)

    def _cycle_failed(self, batch: List[QueuedPodInfo]) -> None:
        """The loop must outlive a failed cycle; its pods retry with
        backoff. Counted, so a caller can tell a failing engine from a
        slow one. The device state is dropped: the next batch
        re-uploads it from the cache's truth."""
        log.exception("scheduling cycle failed; requeueing its %d pods "
                      "with backoff", len(batch))
        with self._metrics_lock:
            self._metrics["cycle_errors"] += 1
        if self._residency is not None:
            self._residency.drop("cycle error")
        for qpi in batch:
            self.queue.requeue_backoff(qpi)

    def _run_pipelined(self) -> None:
        """Bounded two-deep pipelined scheduling loop.

        While batch k's step runs on the device, the host (a) flushes
        batch k-1's commit work on the commit worker and (b) gathers
        batch k+1 from the queue on the gather worker. Batch k+1 is
        ENCODED only after batch k's arbitration + assume accounting
        (_resolve_batch): encode sees cache state that already includes
        k's assumed placements, so decisions are bit-identical to the
        synchronous loop. In-flight work is bounded: one dispatched
        step + one commit flush.

        Where the host waits: PyTorch launches the step's kernels
        asynchronously, but gang_admission reads ``failing.any()`` on
        the host after the first assignment attempt, so the dispatch
        returns only once that attempt has run on the device. The
        overlap is then the commit and gather workers' host work against
        the next prepare, the pack and the fetch.

            sched:  ...| resolve k | commit k-1 wait | enc+step k+1 |
            commit:    [... flush k-1 (worker) ...]   [... flush k ...
            gather:    [pop k+1]                      [pop k+2 ...
        """
        inflight = None            # prepared + dispatched, not resolved
        pending = None             # commit future in flight
        gather_fut = None          # in-flight pop on the gather worker
        try:
            while not self._stop.is_set():
                if inflight is None:
                    if gather_fut is not None:
                        batch = gather_fut.result()
                        gather_fut = None
                    else:
                        batch = self._pop()
                    if not batch:
                        pending = self._await_commit(pending)
                        continue
                    inflight = self._prepare_guarded(batch)
                    continue
                if gather_fut is None and not self._stop.is_set():
                    try:
                        gather_fut = self._gatherer.submit(self._pop)
                    except RuntimeError:  # executor torn down (shutdown)
                        gather_fut = None
                pending = self._finish(inflight, pending)
                nxt = []
                if gather_fut is not None and not self._stop.is_set():
                    nxt = gather_fut.result() or []
                    gather_fut = None
                inflight = self._prepare_guarded(nxt) if nxt else None
        finally:
            # Drain: a dispatched batch is completed, then the last
            # commit is awaited. A gather that raced the stop and popped
            # pods must not lose them.
            if inflight is not None:
                pending = self._finish(inflight, pending)
            if gather_fut is not None:
                for qpi in gather_fut.result():
                    self.queue.requeue_backoff(qpi)
            self._await_commit(pending)

    def _prepare_guarded(self, batch) -> Optional[_Batch]:
        try:
            return self._prepare_batch(batch)
        except Exception:
            self._cycle_failed(batch)
            return None

    def _finish(self, b: _Batch, pending):
        """Resolve ``b``, then commit it: on the commit worker when it
        has failure verdicts to flush (after the previous commit lands),
        inline when the commit is only a metrics fold."""
        try:
            self._resolve_batch(b)
        except Exception:
            self._cycle_failed(b.batch)
            return pending
        if not b.failures:
            self._commit_batch(b)
            return pending
        pending = self._await_commit(pending)
        try:
            return self._committer.submit(self._commit_batch, b)
        except RuntimeError:  # executor torn down (shutdown race)
            self._commit_batch(b)
            return None

    @staticmethod
    def _await_commit(pending):
        """Bound the pipeline at ONE commit in flight."""
        if pending is not None:
            pending.result()
        return None

    # ---- one batched scheduling cycle ----------------------------------

    def schedule_batch(self, batch: List[QueuedPodInfo]) -> Decision:
        """One synchronous cycle: prepare → resolve → commit."""
        b = self._prepare_batch(batch)
        self._resolve_batch(b)
        self._commit_batch(b)
        return b.decision

    def _node_pad(self, hw: int) -> int:
        """Node-axis pad: the eighth-step bucket of the cache's row
        high-water (50k nodes pad to 53248). Resolved under the snapshot
        lock (passed as a callable)."""
        return step_bucket(max(hw, 1), self.config.node_bucket_min)

    def _af_pad(self, hw: int) -> int:
        return bucket_for(max(hw, 1), 16)

    def _count_h2d(self, nbytes: int) -> None:
        with self._metrics_lock:
            self._metrics["h2d_bytes_total"] += nbytes

    def _res_count(self, *, resync: bool, h2d: int) -> None:
        with self._metrics_lock:
            self._metrics["h2d_bytes_total"] += h2d
            if resync:
                self._metrics["residency_resyncs"] += 1
            else:
                self._metrics["residency_hits"] += 1

    def _with_device_static(self, nf, static_version: int, pad: int):
        """Swap the static node-feature leaves for device copies cached
        per (static version, pad); on a hit the snapshot elided their
        host copies."""
        key = (static_version, pad)
        cached = self._nf_static_device
        dynamic = NodeFeatureCache.DYNAMIC_NF_FIELDS
        if cached is None or cached[0] != key:
            host = {f: getattr(nf, f) for f in nf._fields
                    if f not in dynamic}
            leaves = {f: to_torch(a, self.device) for f, a in host.items()}
            self._nf_static_device = cached = (key, leaves)
            self._count_h2d(sum(a.nbytes for a in host.values()))
        return nf._replace(**cached[1])

    def _snapshot(self):
        """Node features for this batch: (nf with device leaves, names,
        row incarnations, carried). With residency the dynamic leaves
        are the carried device arrays brought up to the cache's truth by
        a sparse correction; an attach error drops residency and falls
        back to a full snapshot. Without it they are uploaded whole."""
        cached = self._nf_static_device
        known = cached[0] if cached else None
        res = self._residency
        if res is not None:
            nf, names, static_v, row_incs, delta = (
                self.cache.snapshot_resident(pad=self._node_pad,
                                             known_static=known,
                                             dyn=res.listener))
            nf = self._with_device_static(nf, static_v, row_incs.shape[0])
            try:
                return res.attach(self, nf, delta), names, row_incs, True
            except Exception:
                log.exception("device residency attach failed; resyncing "
                              "through a full snapshot")
                res.drop("attach error")
                cached = self._nf_static_device
                known = cached[0] if cached else None
        nf, names, static_v, row_incs = self.cache.snapshot_versioned(
            pad=self._node_pad, known_static=known)
        nf = self._with_device_static(nf, static_v, row_incs.shape[0])
        self._count_h2d(nf.free.nbytes + nf.used_ports.nbytes)
        nf = nf._replace(free=to_torch(nf.free, self.device),
                         used_ports=to_torch(nf.used_ports, self.device))
        return nf, names, row_incs, False

    def _prepare_batch(self, batch: List[QueuedPodInfo]) -> _Batch:
        b = _Batch()
        b.t0 = time.perf_counter()
        cfg = self.config
        # Pull queued gang-mates so no batch boundary splits a gang (the
        # step would reject the partial group for missing quorum).
        for group in {gang_key(q.pod) for q in batch
                      if q.pod.spec.pod_group}:
            batch.extend(self.queue.pop_group(group))
        if len(batch) > cfg.max_batch_size:
            log.warning("batch grew to %d pods (> max_batch_size %d) "
                        "pulling gang mates", len(batch), cfg.max_batch_size)
        batch = sorted(batch, key=lambda q: -q.pod.spec.priority)
        pods = [q.pod for q in batch]
        # Encode pods FIRST: constraints may register new topology keys,
        # which the node snapshot's domain tables must reflect.
        eb = encode_pods(pods, step_bucket(len(pods), cfg.pod_bucket_min),
                         cfg=self.cache.cfg, registry=self.cache.registry,
                         overflow=self.cache.overflow,
                         gang_bound_fn=self.cache.gang_bound_count)
        nf, names, row_incs, b.res_carried = self._snapshot()
        af = to_torch(self.cache.snapshot_assigned(pad=self._af_pad),
                      self.device)
        eb_dev = to_torch(eb, self.device)
        self._step_counter += 1
        key = prng.fold_in(self._key, self._step_counter)
        b.t_encode = time.perf_counter()
        d = _count_launches(b, self._step, eb_dev, nf, af, key)
        # One device buffer for the whole decision: the slim layout with
        # residency, else the all-i32 stack.
        pack = pack_decision_slim if self._slim else pack_decision_i32
        b.packed_dev = pack(d.chosen, d.assigned, d.gang_rejected,
                            d.feasible_counts, d.feasible_static,
                            d.reject_counts, d.shortlist_repaired)
        b.decision = d
        b.batch, b.eb, b.names, b.row_incs = batch, eb, names, row_incs
        b.t_dispatch = time.perf_counter()
        return b

    def _fetch_decision(self, packed_dev, p: int, f: int):
        """Block on the ONE packed decision fetch and unpack it into
        writable host arrays: (chosen, assigned, gang_rejected, feasible,
        feasible_static, rejects (F,P), repaired)."""
        buf = np.array(packed_dev.cpu().numpy())
        with self._metrics_lock:
            self._metrics["fetch_bytes_total"] += buf.nbytes
        if self._slim:
            return unpack_decision_slim(buf, p, f)
        return unpack_decision_i32(buf)

    def _resolve_batch(self, b: _Batch) -> None:
        self._fail_sink = b.failures
        self._fail_sink_tid = threading.get_ident()
        try:
            self._resolve_batch_impl(b)
        finally:
            self._fail_sink = None
            b.t_resolved = time.perf_counter()

    def _replay_on_residency(self, b: _Batch, chosen, assigned) -> None:
        """Replay the step's device debits into the host mirror and adopt
        free_after as the carried next-batch input, then model the
        batch's host-port insertions on the resident used_ports (only the
        port-carrying pods, padded to a power-of-two bucket; -1 rows are
        skipped)."""
        res = self._residency
        res.note_debits(chosen, assigned, b.eb.pf.requests,
                        b.decision.free_after)
        ports = np.asarray(b.eb.pf.ports)
        live = assigned & (ports != 0).any(axis=1)
        if live.any():
            idx = np.nonzero(live)[0]
            k = bucket_for(idx.size, 16)
            rows_pad = np.full((k,), -1, dtype=np.int32)
            rows_pad[:idx.size] = chosen[idx]
            ports_pad = np.zeros((k, ports.shape[1]), dtype=ports.dtype)
            ports_pad[:idx.size] = ports[idx]
            self._count_h2d(_count_launches(b, res.note_ports, rows_pad,
                                            ports_pad))

    def _resolve_batch_impl(self, b: _Batch) -> None:
        batch, names = b.batch, b.names
        L = len(batch)
        # The read back blocks on the device. In pipelined mode the next
        # batch's gather sits between dispatch and here; the fetch-start
        # stamp keeps it out of the step window.
        b.t_fetch_start = time.perf_counter()
        (chosen, assigned, gang_rejected, feasible, _feasible_static,
         rejects, sl_repaired) = self._fetch_decision(
            b.packed_dev, b.eb.pf.valid.shape[0], len(self.filter_names))
        if assigned[:L].any():
            ch = chosen[:L][assigned[:L]]
            if int(ch.min()) < 0 or int(ch.max()) >= len(names):
                raise RuntimeError(
                    "decision readback failed its sanity check: chosen "
                    f"node row outside [0, {len(names)})")
        if self._shortlist_k is not None:
            b.sl_repairs += int(sl_repaired[:L].sum())
        if b.res_carried:
            self._replay_on_residency(b, chosen, assigned)
        b.t_fetched = time.perf_counter()
        chosen, assigned = chosen[:L], assigned[:L]
        gang_rejected, feasible = gang_rejected[:L], feasible[:L]
        rejects = rejects[:, :L]

        to_bind: List[tuple] = []  # permit-free (qpi, node_name) pairs
        # With no permit plugins in the profile the per-pod binding cycle
        # reduces to assume + enqueue: one cache-lock acquisition for the
        # whole batch, reusing the encoder's request rows.
        bulk_assume = not self.plugin_set.permit_plugins
        assume_items: List[tuple] = []
        assume_rows: List[int] = []
        assume_incs: List[int] = []
        # Rows whose counted admission vanished after the fact (assume
        # misses, synchronous permit rejections): their gang-mates must
        # not bind at sub-quorum.
        lost_rows: List[int] = []
        n_ghost = 0
        chosen_l = chosen.tolist()
        assigned_l = assigned.tolist()
        gang_rejected_l = gang_rejected.tolist()
        feasible_l = feasible.tolist()
        for i, qpi in enumerate(batch):
            if assigned_l[i]:
                node_name = names[chosen_l[i]]
                inc = int(b.row_incs[chosen_l[i]])
                if bulk_assume:
                    assume_items.append((qpi.pod, node_name))
                    assume_rows.append(i)
                    assume_incs.append(inc)
                    to_bind.append((qpi, node_name))
                else:
                    pair, ghost, rej = self._start_binding_cycle(
                        qpi, node_name, expected_inc=inc)
                    if ghost:
                        n_ghost += 1
                    if ghost or rej:
                        lost_rows.append(i)
                    if pair is not None:
                        to_bind.append(pair)
            elif gang_rejected_l[i]:
                # The pod's gang missed quorum — park the member under
                # Coscheduling (plus any real filter rejections).
                plugins = {COSCHEDULING}
                if feasible_l[i] == 0:
                    plugins |= {self.filter_names[f]
                                for f in range(rejects.shape[0])
                                if rejects[f, i] > 0}
                self._handle_failure(
                    qpi, plugins,
                    f"gang {qpi.pod.spec.pod_group} missed quorum "
                    f"{qpi.pod.spec.pod_group_min}", retryable=False)
            elif feasible_l[i] > 0:
                # Nodes were feasible but earlier pods in the batch took
                # the capacity — retryable, not unschedulable.
                self._handle_failure(
                    qpi, {BATCH_CAPACITY},
                    "ran out of capacity within scheduling batch",
                    retryable=True)
            else:
                plugins = {self.filter_names[f]
                           for f in range(rejects.shape[0])
                           if rejects[f, i] > 0} or {BATCH_CAPACITY}
                self._handle_failure(
                    qpi, plugins,
                    f"0/{self.cache.node_count()} nodes are available: "
                    f"rejected by {sorted(plugins)}", retryable=False)

        if assume_items:
            missed = self.cache.account_bind_bulk(
                assume_items, req_rows=b.eb.pf.requests[assume_rows],
                expected_inc=assume_incs)
            if missed:
                # The chosen node's cache row vanished between the
                # snapshot and this assume (node deleted mid-cycle):
                # requeue instead of binding to a ghost node.
                n_ghost += len(missed)
                dead = set()
                for m in missed:
                    pod, node_name = assume_items[m]
                    dead.add(pod.key)
                    self._handle_failure(
                        batch[assume_rows[m]], {BATCH_CAPACITY},
                        f"chosen node {node_name} was deleted during the "
                        "scheduling cycle", retryable=True)
                lost_rows.extend(assume_rows[m] for m in missed)
                to_bind = [(q, n) for q, n in to_bind
                           if q.pod.key not in dead]

        revoked = 0
        lost_gangs = {gang_key(batch[i].pod) for i in lost_rows
                      if batch[i].pod.spec.pod_group}
        if lost_gangs:
            # Gang atomicity: a lost member's siblings must not bind at
            # sub-quorum. to_bind is not submitted yet, so dropped pairs
            # never bind.
            lost = set(lost_rows)
            bind_keys = {q.pod.key for q, _ in to_bind}
            drop: Set[str] = set()
            for j, qpi in enumerate(batch):
                if (j in lost or not assigned_l[j]
                        or gang_key(qpi.pod) not in lost_gangs):
                    continue
                if self._revoke_post_assume(
                        qpi, {COSCHEDULING, BATCH_CAPACITY},
                        f"gang {qpi.pod.spec.pod_group} member lost its "
                        "placement during the scheduling cycle",
                        in_bind=qpi.pod.key in bind_keys):
                    drop.add(qpi.pod.key)
                    revoked += 1
            to_bind = [(q, n) for q, n in to_bind if q.pod.key not in drop]

        if to_bind:
            # One bulk commit for all permit-free pods: a single store
            # transaction (bind_pods), still async like the reference's
            # per-pod binding goroutine (minisched.go:96-112).
            self._binder.submit(self._bind_many, to_bind)
        b.n_assigned = int(assigned.sum()) - n_ghost - revoked

    def _commit_batch(self, b: _Batch) -> None:
        """Flush the deferred failure verdicts (one store transaction, one
        queue lock hold, one event payload) and fold the metrics. Runs on
        the commit worker in pipelined mode when the batch has failures."""
        t_commit = time.perf_counter()
        if b.failures:
            try:
                self._flush_failures(b.failures)
            except Exception:
                # The pods are popped; nothing else would requeue them.
                log.exception("bulk failure flush failed; requeueing the "
                              "tranche with backoff")
                for qpi, _plugins, _msg, _retry in b.failures:
                    self.queue.requeue_backoff(qpi)
        t_end = time.perf_counter()
        # The step window: dispatch to fetch, less the next batch's
        # gather that ran between them in pipelined mode.
        gather_gap = max(0.0, b.t_fetch_start - b.t_dispatch)
        with self._metrics_lock:
            m = self._metrics
            m["batches"] += 1
            m["pods_seen"] += len(b.batch)
            m["pods_assigned"] += b.n_assigned
            m["pods_failed"] += len(b.batch) - b.n_assigned
            m["prepare_s_total"] += b.t_encode - b.t0
            m["step_s_total"] += b.t_fetched - b.t_encode - gather_gap
            m["resolve_s_total"] += ((b.t_resolved - b.t_fetched)
                                     + (t_end - t_commit))
            m["shortlist_repairs"] += b.sl_repairs
            m["shortlist_certified"] += max(0, len(b.batch) - b.sl_repairs)
            m["last_shortlist_repairs"] = b.sl_repairs
            for name, n in b.launches.items():
                m["kernel_launches"] += n
                m[f"kernel_launches_{name}"] += n
            m["last_batch_size"] = len(b.batch)

    def _flush_failures(self, items: List[tuple]) -> None:
        """Apply a cycle's deferred failure verdicts in bulk. Pods deleted
        mid-flight are forgotten."""
        self.broadcaster.failed_scheduling_many(
            [(qpi.pod.key, qpi.pod.metadata.namespace, msg)
             for qpi, _plugins, msg, _retry in items])
        missing = set(self.store.fail_pods(
            [(qpi.pod.key, plugins, msg)
             for qpi, plugins, msg, _retry in items]))
        retryable: List[QueuedPodInfo] = []
        unsched: List[tuple] = []
        for qpi, plugins, _msg, retry in items:
            if qpi.pod.key in missing:
                self.queue.forget(qpi.pod.key)
            elif retry:
                retryable.append(qpi)
            else:
                unsched.append((qpi, plugins))
        if retryable or unsched:
            self.queue.requeue_failures(retryable, unsched)

    def metrics(self) -> Dict[str, float]:
        """Cumulative scheduling metrics plus current queue depths."""
        with self._metrics_lock:
            out = dict(self._metrics)
        out.update({f"queue_{k}": v for k, v in self.queue.stats().items()})
        out["waiting_pods"] = len(self.waiting_pods)
        out["shortlist_width"] = int(self._shortlist_k or 0)
        return out

    # ---- binding cycle -------------------------------------------------

    def _start_binding_cycle(self, qpi: QueuedPodInfo, node_name: str,
                             expected_inc: Optional[int] = None):
        """Assume + permit. Returns (pair, ghost, rejected): ``pair`` is
        (qpi, node_name) when the pod is permit-free and can join the bulk
        commit, None when it was parked for a permit wait or failed
        permit; ``ghost`` when its chosen node's row vanished mid-cycle;
        ``rejected`` when a permit plugin rejected synchronously."""
        pod = qpi.pod
        # Assume the pod onto the node immediately so the next batch's
        # snapshot sees the capacity taken (upstream assume/forget model).
        if not self.cache.account_bind(pod, node_name=node_name,
                                       expected_inc=expected_inc):
            self._handle_failure(
                qpi, {BATCH_CAPACITY},
                f"chosen node {node_name} was deleted during the "
                "scheduling cycle", retryable=True)
            return None, True, False

        waits = []
        for plugin in self.plugin_set.permit_plugins:
            try:
                status, delay, timeout = plugin.permit(pod, node_name)
            except Exception:
                log.exception("permit plugin %s failed", plugin.name)
                status, delay, timeout = "reject", 0.0, 0.0
            if status == "reject":
                self._unassume(qpi)
                self._handle_failure(
                    qpi, {plugin.name},
                    f"pod rejected by permit plugin {plugin.name}",
                    retryable=False)
                return None, False, True
            if status == "wait":
                waits.append((plugin.name, delay, timeout))

        if waits:
            # Park the pod (reference RunPermitPlugins Wait status →
            # WaitingPod + timers, minisched.go:228-234), then bind async.
            wp = WaitingPod(pod, node_name, waits)
            with self._waiting_lock:
                self.waiting_pods[pod.key] = wp
            max_timeout = max(t for _, _, t in waits)
            self._binder.submit(self._wait_and_bind, qpi, wp, max_timeout)
            return None, False, False
        return (qpi, node_name), False, False

    def _wait_and_bind(self, qpi: QueuedPodInfo, wp: WaitingPod,
                       max_timeout: float) -> None:
        sig = wp.get_signal(timeout=max_timeout + 1.0)
        with self._waiting_lock:
            self.waiting_pods.pop(qpi.pod.key, None)
        revoked = getattr(wp, "engine_revoked", None)
        if sig is None or not sig.allowed or revoked is not None:
            self._unassume(qpi)
            if revoked is not None:
                # Engine-side revocation (_revoke_post_assume), not a
                # permit verdict: retryable with the engine's attribution.
                self._handle_failure(qpi, revoked[0], revoked[1],
                                     retryable=True)
                return
            reason = sig.reason if sig else "permit wait timed out"
            self._handle_failure(
                qpi, {name for name, _, _ in wp.waits},
                f"WaitOnPermit failed: {reason}", retryable=False)
            return
        self._bind(qpi, wp.node_name)

    def _bind(self, qpi: QueuedPodInfo, node_name: str) -> None:
        t0 = time.perf_counter()
        pod = qpi.pod
        try:
            bound = self.store.bind_pod(pod.key, node_name)
        except (ConflictError, NotFoundError) as e:
            self._bind_failed(qpi, node_name, e)
            return
        self.queue.forget(pod.key)
        with self._metrics_lock:
            self._metrics["pods_bound"] += 1
            self._metrics["bind_s_total"] += time.perf_counter() - t0
        self.broadcaster.scheduled(bound, node_name)
        log.info("bound %s to %s", pod.key, node_name)

    def _bind_many(self, items: List[tuple]) -> None:
        """Bulk binding commit with failure containment: an unhandled
        exception on the binder pool would lose the whole tranche, so any
        failure reconciles per pod against store truth instead."""
        try:
            self._bind_many_impl(items)
        except Exception:
            log.exception("bulk bind task failed; reconciling %d "
                          "placement(s) against store truth", len(items))
            self._reconcile_bind_failure(items)

    def _bind_many_impl(self, items: List[tuple]) -> None:
        """One store.bind_pods transaction for the whole tranche, then
        per-pod bookkeeping; pods the store skipped (deleted mid-flight,
        bound elsewhere, node gone) take the per-pod failure path."""
        t0 = time.perf_counter()
        keyed = [(qpi.pod.key, qpi, node_name) for qpi, node_name in items]
        bound_keys = set(self.store.bind_pods(
            [(k, n) for k, _, n in keyed]))
        self.queue.forget_many(bound_keys)
        with self._metrics_lock:
            self._metrics["pods_bound"] += len(bound_keys)
            self._metrics["bind_s_total"] += time.perf_counter() - t0
        ok = keyed
        if len(bound_keys) != len(keyed):
            ok = []
            for k, qpi, node_name in keyed:
                if k in bound_keys:
                    ok.append((k, qpi, node_name))
                else:
                    self._bind_failed(qpi, node_name,
                                      "skipped by bulk commit")
        self.broadcaster.scheduled_many(
            [(k, qpi.pod.metadata.namespace, n) for k, qpi, n in ok])

    def _reconcile_bind_failure(self, items: List[tuple]) -> None:
        """Per-pod recovery for an aborted bulk bind: a pod the store DID
        bind keeps its assume; an unbound pod is unassumed and requeued;
        a deleted pod releases everything."""
        for qpi, node_name in items:
            key = qpi.pod.key
            try:
                fresh = self.store.get("Pod", key)
            except NotFoundError:
                self._unassume(qpi)
                self.queue.forget(key)
                continue
            if fresh.spec.node_name:
                self.queue.forget(key)
                with self._metrics_lock:
                    self._metrics["pods_bound"] += 1
            else:
                self._bind_failed(qpi, node_name, "bulk bind task aborted")

    def _bind_failed(self, qpi: QueuedPodInfo, node_name: str,
                     reason) -> None:
        """Unassume, then drop (pod deleted) or requeue with backoff."""
        self._unassume(qpi)
        with self._metrics_lock:
            self._metrics["bind_conflicts"] += 1
        try:
            self.store.get("Pod", qpi.pod.key)
        except NotFoundError:
            self.queue.forget(qpi.pod.key)
            return
        log.warning("bind of %s to %s failed: %s", qpi.pod.key, node_name,
                    reason)
        self.queue.requeue_backoff(qpi)

    def _revoke_post_assume(self, qpi: QueuedPodInfo, plugins: Set[str],
                            msg: str, *, in_bind: bool) -> bool:
        """Reverse an assume made this cycle. ``in_bind``: the pod sits in
        the unsubmitted bulk list, so unassume + requeue is race-free.
        Otherwise an in-flight permit wait is rejected (its continuation
        unassumes and requeues); a wait that already resolved may have
        bound, and the revocation is declined."""
        if in_bind:
            self._unassume(qpi)
            self._handle_failure(qpi, plugins, msg, retryable=True)
            return True
        with self._waiting_lock:
            wp = self.waiting_pods.get(qpi.pod.key)
            if wp is None:
                return False
            wp.engine_revoked = (set(plugins), msg)
        wp.reject("engine", msg)
        return True

    def _unassume(self, qpi: QueuedPodInfo) -> None:
        self.cache.account_unbind(qpi.pod.key)

    # ---- failure path (reference ErrorFunc minisched.go:283-298) --------

    def _handle_failure(self, qpi: QueuedPodInfo, plugins: Set[str],
                        message: str, *, retryable: bool) -> None:
        sink = self._fail_sink
        if sink is not None and threading.get_ident() == self._fail_sink_tid:
            sink.append((qpi, set(plugins), message, retryable))
            return
        pod = qpi.pod
        self.broadcaster.failed_scheduling(pod, message)
        try:
            fresh = self.store.get("Pod", pod.key)
            if not fresh.spec.node_name:
                fresh.status.unschedulable_plugins = sorted(plugins)
                fresh.status.message = message
                self.store.update(fresh)
                qpi.pod = fresh
        except NotFoundError:
            self.queue.forget(pod.key)
            return
        if retryable:
            self.queue.requeue_backoff(qpi)
        else:
            self.queue.add_unschedulable(qpi, plugins)

"""Per-decision explainability store.

Rebuild of the reference's result-recording capability (reference
scheduler/plugin/resultstore/store.go): for every scheduling attempt, the
per-node, per-plugin filter verdicts and raw/weighted-normalized scores are
published as JSON pod annotations (keys in annotation.py, identical to
reference annotation/annotation.go:5-9), retried with exponential backoff
(reference store.go:120-131 → util/retry.go:18), then evicted from memory
(store.go:134,236-238).

Hot-path cost: in async mode (``async_flush=True``, the engine mode — the
analog of the reference flushing on informer events off the scheduling
thread, store.go:60-68) ``record_batch`` ONLY enqueues the step's output
tensors; the device readback (``.cpu()``) and the per-pod top-k
selection (numpy, float64 ranking, ``np.argpartition``) happen on the
ingest worker, the dict building and the annotation writes on a writer
thread behind it, in the order the batches were ingested. A two-batch
backpressure semaphore bounds how many steps' explain stacks can stay in
device memory awaiting ingestion; it is released after the ingest, and
with the writes on their own thread the next ingest does not wait for
the last batch's 1,024 annotation writes (the JAX package's store runs
both on one worker: at bench-50k on a slow host the scheduling thread
then waited past the 5 s deadline and dropped batches). Synchronous
mode (``flush=True``, the test/table mode) ingests and flushes inline.

The worker's readback runs on the device's default stream, which every
host thread shares: it waits for every launch queued before it, and the
scheduling thread's next slim fetch queues behind the stacks' copy.

Bounding: at ``top_k`` (default 128) the per-pod annotation records only
the k best nodes by weighted normalized score (all nodes when N ≤ k) —
an unbounded record at 50k nodes would be a multi-megabyte annotation per
pod and O(P×N) host work per batch.

Full-N filter coverage: the JSON annotations are top-k bounded, but the
question a scheduler simulator most often answers — "why did node X
specifically reject this pod", for ARBITRARY X (reference
resultstore/store.go:137-168 records every node) — is served by
``filter_verdict``: per pod, bit-plane-packed failing-filter masks
((F, ⌈N/8⌉) uint8 — plane f bit j set ⇔ plugin f rejected node j)
retained for the most recent ``full_n_retain`` pods. One BIT per
(pod, node, filter) instead of the annotation's per-plugin JSON
strings — dense enough that the default 128 MB budget retains every
row of a full 10k×50k headline batch.
"""
from __future__ import annotations

import json
import logging
import queue as queue_mod
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import numpy as np

from ..errors import ConflictError, NotFoundError
from ..obs import span, traced
from ..utils.retry import retry_with_exponential_backoff

log = logging.getLogger(__name__)

PASSED = "passed"
FAILED = "node(s) didn't pass the filter"


class _BatchRecord(NamedTuple):
    """One step's explain output, shared by every pod row in the batch."""

    node_names: List[str]          # per recorded column
    node_cols: np.ndarray          # (K,) column indices into the matrices
    per_pod_cols: Optional[np.ndarray]  # (P,K) per-pod top-k, or None = shared
    fnames: List[str]
    snames: List[str]
    weights: List[float]
    filter_masks: np.ndarray       # (F,P,N) bool
    raw: np.ndarray                # (S,P,N) f32
    norm: np.ndarray               # (S,P,N) f32


class ResultStore:
    """Records batched-step results and flushes them as pod annotations."""

    def __init__(self, store, *, flush: bool = True,
                 async_flush: bool = False, top_k: int = 128,
                 retry_initial_s: float = 0.05, retry_steps: int = 6,
                 full_n_retain: Optional[int] = None,
                 full_n_budget_bytes: int = 128 << 20,
                 max_results: int = 8192):
        self._cluster = store
        self._flush = flush
        self._top_k = top_k
        self._lock = threading.Lock()
        # pod key → (batch record, pod row). Bounded at ``max_results``
        # newest-recorded pods: the flush path evicts on success, but a
        # pod whose flush exhausted its CAS retries keeps a downgraded
        # dict entry until its next update event — and a pod that goes
        # TERMINAL (deleted under lifecycle churn) never gets one, so
        # sustained churn would otherwise grow the store without bound.
        # Terminal pods are also swept eagerly: the service wires pod
        # DELETE events to :meth:`delete_data`. Both paths count into
        # ``evictions`` (stats()/Scheduler.metrics
        # ``resultstore_evictions``), pinned by the churn test.
        self._results: Dict[str, tuple] = {}
        self._max_results = max(1, int(max_results))
        self._evictions = 0
        # pod key → (name→col, (F, ceil(N/8)) uint8 fail bit-planes,
        # fnames); FIFO-bounded by ``full_n_retain`` rows when given,
        # else by a BYTE budget (a fixed row count would silently blow up
        # with N; the budget scales the row cap). Rows are COPIES out of
        # the per-batch packed array (views would pin the whole batch
        # array while the budget counts only the row), so real residency
        # tracks the budgeted bytes.
        self._filter_bits: Dict[str, tuple] = {}
        self._full_n_retain = full_n_retain
        self._full_n_budget = full_n_budget_bytes
        self._warned_overflow = False
        self._retry_initial = retry_initial_s
        self._retry_steps = retry_steps
        self._worker: Optional[threading.Thread] = None
        self._writer: Optional[threading.Thread] = None
        self._q: Optional[queue_mod.Queue] = None
        # The writer's queue: lists of pod keys to flush, in order.
        self._fq: Optional[queue_mod.Queue] = None
        # At most 2 un-ingested batches: their explain-mode device arrays
        # stay pinned until the worker reads them back, and an unbounded
        # backlog of (F/S,P,N) stacks would eat HBM at 50k nodes.
        self._inflight = threading.Semaphore(2)
        self._closed = False
        # Key → count of enqueued-but-not-ingested batches containing it
        # (a pod retried across batches can sit in the queue twice).
        # Without this, queued batches would be invisible to
        # pending_keys() and the shutdown "unflushed results" warning
        # would under-report.
        self._queued_keys: Dict[str, int] = {}
        if async_flush:
            self._q = queue_mod.Queue()
            self._fq = queue_mod.Queue()
            self._worker = threading.Thread(target=self._flush_loop,
                                            daemon=True,
                                            name="resultstore-flusher")
            self._writer = threading.Thread(target=self._write_loop,
                                            daemon=True,
                                            name="resultstore-writer")
            self._worker.start()
            self._writer.start()

    # ---- recording (called by the engine after each step) ---------------

    def record_batch(self, pods, names, decision, plugin_set) -> None:
        """Hot-path entry. Async mode: enqueue-only (the worker does
        readback/top-k/flush); sync mode: ingest and flush inline."""
        if (decision.filter_masks.shape[0] == 0
                and decision.raw_scores.shape[0] == 0):
            return  # engine compiled with explain=False
        if self._q is not None:
            # Bounded backpressure: scheduling does not depend on the
            # recorder, so a worker wedged in flush retries gets a few
            # seconds of grace and then this batch's results are DROPPED
            # (logged) — observability is best-effort, stalling the
            # scheduling loop for it would invert the priorities. close()
            # releases waiting producers immediately.
            deadline = time.monotonic() + 5.0
            while not self._closed and time.monotonic() < deadline:
                if self._inflight.acquire(timeout=0.5):
                    if self._closed:
                        self._inflight.release()
                        return
                    with self._lock:
                        for p in pods:
                            self._queued_keys[p.key] = (
                                self._queued_keys.get(p.key, 0) + 1)
                    self._q.put((pods, names, decision, plugin_set))
                    return
            if not self._closed:
                log.warning(
                    "explain recorder backlogged; dropping results for "
                    "%d pods", len(pods))
            return
        keys = self._ingest(pods, names, decision, plugin_set)
        if self._flush:
            for k in keys:
                self.flush_pod(k)

    @traced("explain.ingest")
    def _ingest(self, pods, names, decision, plugin_set) -> List[str]:
        """Device readback + top-k selection + record registration."""
        # The copies to the host queue on the device's default stream,
        # behind every launch the scheduling thread made before them.
        filter_masks = decision.filter_masks.cpu().numpy()  # (F,P,N)
        raw = decision.raw_scores.cpu().numpy()             # (S,P,N)
        norm = decision.norm_scores.cpu().numpy()           # (S,P,N)
        fnames = [p.name for p in plugin_set.filter_plugins]
        snames = [p.name for p in plugin_set.score_plugins]
        weights = [plugin_set.weight_of(p) for p in plugin_set.score_plugins]

        valid_cols = np.array([j for j, n in enumerate(names)
                               if n is not None], dtype=np.int64)
        per_pod_cols = None
        if len(valid_cols) > self._top_k:
            # The node table's padding rows come last, so the valid
            # columns are usually a prefix: take those by a basic slice
            # (a view), not a gather that copies the (P, N) ranking.
            take = (slice(0, len(valid_cols)) if np.array_equal(
                valid_cols, np.arange(len(valid_cols))) else valid_cols)
            # Rank nodes per pod the way the scheduler ranked them: all
            # FEASIBLE nodes (by weighted normalized score) strictly above
            # infeasible ones — so the chosen node always makes the cut —
            # with infeasible nodes (ranked by score) filling any leftover
            # slots, preserving "didn't pass the filter" examples for pods
            # with few feasible nodes.
            if norm.shape[0]:
                w = np.asarray(weights, dtype=np.float64)
                total = np.einsum("spn,s->pn", norm.astype(np.float64),
                                  w)[:, take]
            else:  # filter-only profile: all-zero scores
                total = np.zeros((filter_masks.shape[1], len(valid_cols)))
            if filter_masks.shape[0]:
                feasible = filter_masks.all(axis=0)[:, take]
                # In place (the ranking is this function's own array):
                # the same sums as total + feasible * 1e12, one (P, N)
                # float64 temporary fewer.
                total += feasible.astype(np.float64) * 1e12
            kth = self._top_k
            part = np.argpartition(np.negative(total, out=total), kth - 1,
                                   axis=1)[:, :kth]
            per_pod_cols = valid_cols[part]                # (P,K)

        batch = _BatchRecord(
            node_names=[names[j] for j in valid_cols]
            if per_pod_cols is None else list(names),
            node_cols=valid_cols, per_pod_cols=per_pod_cols,
            fnames=fnames, snames=snames, weights=weights,
            filter_masks=filter_masks, raw=raw, norm=norm)

        # Full-N failing-plugin record, BIT-PLANE PACKED: per retained pod
        # a (F, ceil(N/8)) uint8 array — plane f bit j set ⇔ filter f
        # rejected node j (np.packbits big-endian bit order). 32/F× denser
        # than the previous one-uint32-per-(pod,node) layout, which is
        # what lets the budget hold EVERY row of a headline batch
        # (10k pods × 50k nodes × 1 filter = 6.25 KB/row → the default
        # 128 MB budget retains >20k rows; the uint32 layout held 668).
        # Only the first 32 filters are recorded; the fnames stored with
        # each row are truncated to the RECORDED plugins so filter_verdict
        # never fabricates PASSED for an unrecorded overflow plugin.
        packed = col_of = None
        bit_fnames = fnames[:32]
        if len(fnames) > 32 and not self._warned_overflow:
            self._warned_overflow = True  # once — fires per batch otherwise
            log.warning(
                "full-N filter bitmask records only the first 32 of %d "
                "filter plugins; verdicts for the rest come from the "
                "top-k annotations only", len(fnames))
        retain = self._full_n_retain
        first_kept = 0
        if filter_masks.shape[0]:
            if retain is None:
                row_bytes = max(
                    1, len(bit_fnames) * ((filter_masks.shape[2] + 7) // 8))
                retain = max(64, self._full_n_budget // row_bytes)
            # Rows below ``first_kept`` would be FIFO-evicted before this
            # batch finishes inserting — don't even compute their
            # bitmasks (at 10k pods x 50k nodes with the default budget
            # ~93% of the packing work would be discarded otherwise).
            # Slice by len(pods), NOT filter_masks.shape[1]: the mask's P
            # axis is the padded bucket, and the pad rows beyond the live
            # pods need no bits either.
            first_kept = max(0, len(pods) - retain)
            kept = filter_masks[:len(bit_fnames),
                                first_kept:len(pods), :]
            packed = np.packbits(~kept, axis=2)  # (F, K, ceil(N/8))
            col_of = {n: j for j, n in enumerate(names) if n is not None}

        keys = []
        with self._lock:
            for i, pod in enumerate(pods):
                # pop-then-insert keeps dict order = recording recency,
                # so the retention bound below evicts the STALEST pod's
                # record, not an arbitrary one (LRU-by-record).
                self._results.pop(pod.key, None)
                self._results[pod.key] = (batch, i)
                keys.append(pod.key)
                if packed is not None:
                    self._filter_bits.pop(pod.key, None)  # refresh order
                    if i >= first_kept:
                        # .copy(): a retained VIEW would pin the whole
                        # kept-rows array while the byte budget only
                        # accounts the row — copies keep real residency
                        # equal to the budgeted bytes.
                        self._filter_bits[pod.key] = (
                            col_of, packed[:, i - first_kept, :].copy(),
                            bit_fnames)
            if packed is not None:
                while len(self._filter_bits) > retain:
                    self._filter_bits.pop(next(iter(self._filter_bits)))
            while len(self._results) > self._max_results:
                self._results.pop(next(iter(self._results)))
                self._evictions += 1
        return keys

    # ---- flushing (reference addSchedulingResultToPod store.go:90-135) --

    def _build(self, batch: _BatchRecord, i: int) -> Dict[str, dict]:
        """Materialize one pod's three annotation dicts (flush-time only)."""
        if batch.per_pod_cols is None:
            cols = batch.node_cols
            names = batch.node_names
        else:
            cols = batch.per_pod_cols[i]
            names = [batch.node_names[j] for j in cols]
        # One gather per stack and .tolist(), not a numpy scalar per
        # (plugin, node): the same Python floats (float32 values widened;
        # the final score's float32 product, as numpy >= 2 computes an
        # array or a scalar times a Python float).
        fm = batch.filter_masks[:, i, cols].tolist()
        raw = batch.raw[:, i, cols].tolist()
        fin = [(batch.norm[s, i, cols] * w).tolist()
               for s, w in enumerate(batch.weights)]
        fr = {n: {f: (PASSED if fm[a][k] else FAILED)
                  for a, f in enumerate(batch.fnames)}
              for k, n in enumerate(names)}
        sr = {n: {sn: raw[a][k] for a, sn in enumerate(batch.snames)}
              for k, n in enumerate(names)}
        fs = {n: {sn: fin[a][k] for a, sn in enumerate(batch.snames)}
              for k, n in enumerate(names)}
        return {"filter": fr, "score": sr, "finalscore": fs}

    def flush_pod(self, key: str) -> bool:
        from .annotation import (FILTER_RESULT_KEY, FINAL_SCORE_RESULT_KEY,
                                 SCORE_RESULT_KEY)

        with self._lock:
            entry = self._results.get(key)
        if entry is None:
            return True
        # entry is (batch, row) normally, or prebuilt dicts if an earlier
        # flush exhausted its retries (see below).
        data = entry if isinstance(entry, dict) else self._build(*entry)

        def attempt() -> bool:
            try:
                pod = self._cluster.get("Pod", key)
            except NotFoundError:
                return True  # pod gone; nothing to annotate
            pod.metadata.annotations[FILTER_RESULT_KEY] = json.dumps(
                data["filter"], sort_keys=True)
            pod.metadata.annotations[SCORE_RESULT_KEY] = json.dumps(
                data["score"], sort_keys=True)
            pod.metadata.annotations[FINAL_SCORE_RESULT_KEY] = json.dumps(
                data["finalscore"], sort_keys=True)
            try:
                # CAS: the flusher races the binder (record happens before
                # the async bulk bind) — an unversioned write here could
                # clobber a fresh binding with this stale copy. On
                # conflict, retry re-reads the bound pod and annotates it.
                self._cluster.update(pod, check_version=True)
                return True
            except (ConflictError, NotFoundError):
                return False

        ok = retry_with_exponential_backoff(
            attempt, initial_duration=self._retry_initial,
            steps=self._retry_steps)
        with self._lock:
            # Evict/downgrade only if the entry we flushed is still the
            # current one — record_batch may have stored a NEWER attempt's
            # result for this pod while we were flushing; that one must
            # survive to be flushed in turn.
            if self._results.get(key) is entry:
                if ok:  # evict on success (store.go:134)
                    del self._results[key]
                else:
                    # Keep the pod's data for a later flush, but as its
                    # small materialized dicts — a retained (batch, row)
                    # entry would pin the whole batch's (F/S,P,N) arrays.
                    self._results[key] = data
        if not ok:
            log.warning("failed to flush scheduling results for %s", key)
        return ok

    def on_pod_events(self, keys) -> None:
        """Bulk form of on_pod_event for MODIFIED bursts (a 10k bulk
        bind emits 10k back-to-back events): ONE lock acquisition to
        find pending keys, then enqueue only the matches."""
        with self._lock:
            pending = [k for k in keys if k in self._results]
        if self._fq is not None:
            if pending and not self._closed:
                self._fq.put(pending)
            return
        for k in pending:
            self.flush_pod(k)

    def on_pod_event(self, key: str) -> None:
        """Informer-event flush trigger (the reference's contract:
        results land on the pod's NEXT update event, then evict —
        store.go:60-68,90-135). The proactive post-ingest flush makes
        this a no-op at steady state; it matters exactly where that
        flush exhausted its retries (CAS races) and downgraded the entry
        — the next pod update re-drives it instead of stranding the
        results until shutdown."""
        self.on_pod_events((key,))

    def _flush_loop(self) -> None:
        """The ingest worker: read each batch back and hand its keys to the
        writer (before this queue's task_done, so drain() never sees both
        queues empty in between)."""
        while True:
            item = self._q.get()
            try:
                if item is None:
                    self._fq.put(None)  # after every batch ingested
                    return
                pods, names, decision, plugin_set = item
                try:
                    keys = self._ingest(pods, names, decision, plugin_set)
                finally:
                    self._inflight.release()
                    # Pair exactly with the enqueue-side increments — on
                    # ingest failure too, else pending_keys() reports
                    # phantom unflushable pods forever.
                    with self._lock:
                        for p in pods:
                            n = self._queued_keys.get(p.key, 0) - 1
                            if n > 0:
                                self._queued_keys[p.key] = n
                            else:
                                self._queued_keys.pop(p.key, None)
                # Ingest copied everything to host: drop the references
                # so the step's device arrays aren't pinned until the
                # writer is done.
                del item, pods, decision
                self._fq.put(keys)
            except Exception:
                log.exception("async explain ingest failed")
            finally:
                self._q.task_done()

    def _write_loop(self) -> None:
        """The writer: flush each ingested batch's pods (and each
        informer-event re-drive) in order."""
        while True:
            keys = self._fq.get()
            try:
                if keys is None:
                    return
                with span("explain.flush", pods=len(keys)):
                    for k in keys:
                        self.flush_pod(k)
            except Exception:
                log.exception("async explain flush failed")
            finally:
                self._fq.task_done()

    def drain(self, timeout: float = 10.0) -> bool:
        """Wait for the async flusher to finish everything enqueued so far."""
        if self._q is None:
            return True
        deadline = time.monotonic() + timeout
        while self._q.unfinished_tasks or self._fq.unfinished_tasks:
            if time.monotonic() >= deadline:
                return False
            time.sleep(0.005)
        return True

    def close(self) -> None:
        self._closed = True
        if self._q is not None:
            self._q.put(None)  # the ingest worker passes it to the writer

    def filter_verdict(self, pod_key: str,
                       node_name: str) -> Optional[Dict[str, str]]:
        """Why did node ``node_name`` accept/reject this pod — answerable
        for EVERY node of the pod's last recorded attempt (full-N
        coverage; reference resultstore/store.go:137-168 records every
        node), not just the top-k annotated ones. Returns plugin →
        PASSED/FAILED, or None if the pod's record was evicted or the
        node wasn't in that attempt's snapshot."""
        with self._lock:
            rec = self._filter_bits.get(pod_key)
        if rec is None:
            return None
        col_of, planes, fnames = rec  # planes: (F, ceil(N/8)) uint8
        j = col_of.get(node_name)
        if j is None:
            return None
        byte, bit = j >> 3, 7 - (j & 7)  # packbits big-endian bit order
        return {fn: (FAILED if (int(planes[f, byte]) >> bit) & 1 else PASSED)
                for f, fn in enumerate(fnames)}

    def delete_data(self, key: str) -> None:
        """Terminal sweep: the pod is gone, so its recorded results can
        never flush (NotFound) or be queried meaningfully — evict both
        tiers now instead of waiting for the retention bound. The
        service wires pod DELETE informer events here, so lifecycle
        churn (evictions, reclamation waves) cannot grow the store.

        Only _results/_filter_bits are purged: _queued_keys counts are
        owned by the enqueue/worker pairing — popping here would make
        the worker's later decrement steal a NEWER queued batch's
        count. A queued record for a deleted pod flushes as a harmless
        no-op (flush_pod → NotFound → evict)."""
        with self._lock:
            evicted = self._results.pop(key, None) is not None
            evicted = (self._filter_bits.pop(key, None)
                       is not None) or evicted
            if evicted:
                self._evictions += 1

    def stats(self) -> Dict[str, int]:
        """Retention observability (surfaced as ``resultstore_*`` in
        Scheduler.metrics): live record/bitmask counts, queued batches'
        pending keys, and the eviction counter (retention bound +
        terminal sweeps)."""
        with self._lock:
            return {"results": len(self._results),
                    "filter_bits": len(self._filter_bits),
                    "queued": len(self._queued_keys),
                    "evictions": self._evictions}

    def pending_keys(self) -> List[str]:
        """Everything not yet flushed: ingested results AND batches still
        waiting in the worker queue (deduplicated)."""
        with self._lock:
            return list(dict.fromkeys(
                list(self._results) + list(self._queued_keys)))

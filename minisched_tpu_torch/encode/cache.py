"""Incremental node-feature cache.

Fixes the reference's per-pod full node List (reference
minisched/minisched.go:40 — an O(nodes) RPC per scheduling cycle): node
features are encoded once on add/update and patched in place as watch events
arrive; pod bind/unbind adjusts per-node free-resource and used-port columns
incrementally. A snapshot padded to a bucketed shape is handed to the XLA
step (bucketing avoids per-batch recompilation — SURVEY §7 "dynamic shapes").
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np

from ..obs import span
from ..state import objects as obj_mod
from ..state.objects import (RESOURCE_INDEX, Node, Pod, claim_keys,
                             gang_key, pod_requests)

_VOL = RESOURCE_INDEX["attachable-volumes"]
from . import features as F
from .features import (AssignedPodFeatures, DEFAULT_ENCODING, EncodingConfig,
                       NodeFeatures, TopologyKeyRegistry)


class OverflowLog(list):
    """Bounded, deduplicating sink for encoding-slot overflow reports.

    Keeps the plain-list interface encode callbacks expect (append/iter)
    but drops repeats — the same pod's overflow re-reports on every
    account_bind during churn — and caps total retained entries so a
    long-lived scheduler cannot leak memory proportional to bind count.
    """

    MAX = 512

    def __init__(self):
        super().__init__()
        self._seen: set = set()
        self._truncated = False
        # Written from both the informer thread (account_bind → _anti_sigs)
        # and the scheduling thread (encode_pods) — the check-then-act
        # dedup must be atomic.
        self._applock = threading.Lock()

    def append(self, msg: str) -> None:  # type: ignore[override]
        with self._applock:
            if msg in self._seen:
                return
            if len(self._seen) >= self.MAX:
                if not self._truncated:
                    self._truncated = True
                    super().append(
                        f"... overflow log truncated at {self.MAX} distinct "
                        "messages; further reports dropped")
                return
            self._seen.add(msg)
            super().append(msg)


def bucket_for(n: int, minimum: int = 16) -> int:
    """Smallest power-of-two bucket ≥ n (≥ minimum)."""
    b = minimum
    while b < n:
        b <<= 1
    return b


class DynDeltaListener:
    """One consumer's registration in the cache's dynamic-leaf elision
    protocol (snapshot_resident): the cache records every node row whose
    ``free``/``used_ports`` column it mutates into ``rows`` (under the
    cache lock), and each collection drains the set into a
    features.DynDelta while bumping ``epoch`` — the divergence counter
    both sides carry so desync is structurally impossible (the consumer
    applies a delta only when its device state sits at exactly
    ``epoch - 1``; anything else forces a full re-upload).

    ``valid``/``pad`` track whether the accumulated rows describe ALL
    mutations since a full base at that pad: the consumer clears
    ``valid`` when it drops its device state (resync), and a snapshot
    resolved at a different pad rebases automatically. Cross-thread
    notes: ``rows`` is only touched under the cache lock; ``valid`` is
    a plain flag written by the consumer thread — a racing mark at
    worst adds rows that the next full rebase discards."""

    __slots__ = ("epoch", "rows", "valid", "pad")

    def __init__(self):
        self.epoch = 0
        self.rows: set = set()
        self.valid = False
        self.pad = -1

    def invalidate(self) -> None:
        """Consumer dropped its device state: the next collection must
        return full leaves (a new base), not a delta."""
        self.valid = False


class IndexDeltaListener(DynDeltaListener):
    """The maintained arbitration index's registration in the delta
    fan-in (ops/index.py; engine/scheduler._ArbIndex): beyond the
    dynamic-leaf ``rows`` every DynDeltaListener receives, the cache
    classifies STATIC node mutations for it —

      * a NARROWING change (cordon, taints grown, allocatable shrunk,
        node removed — ``state.events.node_update_narrows_only``) can
        only LOWER the changed row's scores, so it lands in
        ``static_rows`` and the index repairs that row in place exactly
        like a capacity debit;
      * a WIDENING change (new node, uncordon, labels/images/capacity
        moved, topology-domain refresh) bumps the ``inval`` epoch: the
        consumer compares the epoch at drain time and REBUILDS — the
        conservative rung of the index's repair ladder (a widened node
        may rise anywhere, and a fresh node may even grow the pad past
        the columns the index ever evaluated).

    Drained together with ``rows`` by ``drain_index_rows``; the dyn
    epoch protocol of the base class is untouched (this listener is
    never handed to snapshot_resident)."""

    __slots__ = ("static_rows", "inval")

    def __init__(self):
        super().__init__()
        self.static_rows: set = set()
        self.inval = 0


def step_bucket(n: int, minimum: int = 16) -> int:
    """Padding bucket for the STEP's array shapes: power-of-two up to
    2048, then eighth-steps between octaves (2^k · (8+j)/8, j = 1..8).

    Pure doubling wastes up to ~2× compute at the scales that matter —
    the headline 50k nodes × 10k pods pads to 65536 × 16384, 2.1× the
    cells of a tight pad, and every (P,N) filter/score pass pays it.
    Eighth-steps cap the waste at 12.5% while keeping every value above
    2048 a multiple of 256: lane-tile aligned for the pallas kernel and
    divisible by any power-of-two mesh axis up to 256 for the sharded
    step. The ladder has 8× the distinct buckets per octave (more XLA
    compiles in the worst case), but a steady-state engine sits in one
    or two: batch sizes are max_batch_size-capped and the node count is
    quasi-static, so compiles amortize exactly like the pow2 ladder's.
    """
    # The guarantees above (256-multiples, lane alignment, pow2-mesh
    # divisibility) derive from base/step being built over pow2 octaves —
    # a non-pow2 minimum would silently yield unaligned pads, so round it
    # up to the next power of two first.
    minimum = bucket_for(max(minimum, 1), 1)
    b = bucket_for(n, minimum)
    if b <= 2048 or b <= minimum:
        # Below the ladder, or the caller's floor IS the bucket (a
        # minimum above 2048 pins shapes; stepping below it would flap
        # through sub-floor buckets and recompile on every growth step).
        return b
    base = b >> 1                 # n > base = max(2^(k-1), minimum·2^(k-1))
    step = base >> 3
    return base + step * -(-(n - base) // step)


# Upstream InterPodAffinityArgs.hardPodAffinityWeight's default: the
# weight a bound pod's REQUIRED affinity term gives, in the symmetric
# direction, to each incoming pod it matches.
HARD_POD_AFFINITY_WEIGHT = 1.0


def _selector_sig(sel) -> Optional[tuple]:
    if sel is None:
        return None
    return (tuple(sorted(sel.match_labels.items())),
            tuple(sorted((r.key, r.operator, tuple(r.values))
                         for r in sel.match_expressions)))


def _sym_terms_of(pod: Pod) -> List[tuple]:
    """(topology key, namespace, selector, signed weight) of each term of
    a bound ``pod`` that scores the pods it matches (upstream
    processExistingPod): preferred affinity +weight, preferred
    anti-affinity -weight, required affinity +HARD_POD_AFFINITY_WEIGHT.
    A term's namespace is the pod's own unless it lists namespaces (one
    entry per listed namespace). A term with no selector (None) matches
    no pod, as upstream's nil selector, and is left out."""
    a = pod.spec.affinity
    if a is None:
        return []
    out: List[tuple] = []
    own = pod.metadata.namespace

    def add(term, w: float) -> None:
        if term.label_selector is None:
            return
        for ns in (term.namespaces or [own]):
            out.append((term.topology_key, ns, term.label_selector, w))

    pa, anti = a.pod_affinity, a.pod_anti_affinity
    if pa is not None:
        for wt in pa.preferred:
            add(wt.term, float(wt.weight))
        for term in pa.required:
            add(term, HARD_POD_AFFINITY_WEIGHT)
    if anti is not None:
        for wt in anti.preferred:
            add(wt.term, -float(wt.weight))
    return out


class _SymGroup:
    """The bound pods' terms of one (topology key, namespace, selector):
    node row → summed signed weight of their owners there."""

    __slots__ = ("key", "ns", "selector", "owners", "rows")

    def __init__(self, key: str, ns: str, selector):
        self.key, self.ns, self.selector = key, ns, selector
        self.owners = 0
        self.rows: Dict[int, float] = {}


class SymBatch:
    """One batch's view of the bound pods' symmetric terms, handed to
    ``encode_pods(sym_table=...)``: ``slots_for(pod)`` names the table
    rows of the terms ``pod`` matches (one row per topology key: the
    matched groups of a key share one row), and ``build()`` sums each
    row's groups per domain into the batch's ``SymTerms``. Matching is
    exact on the host (the term's namespace, then its selector against
    the pod's labels; an empty selector matches every pod), memoized by
    (namespace, labels), so its cost follows the distinct term groups and
    label sets, not the bound pods; ``build`` sums each group's node rows
    per domain once a batch. ``seconds`` is the host time it
    spent; ``build`` runs in an ``encode.sym_affinity`` span carrying
    the batch's ``seq``."""

    def __init__(self, cache: "NodeFeatureCache", seq: int = 0):
        self.cache = cache
        self.seq = seq
        with cache._lock:
            self.groups = [(sig, g.key, g.ns, g.selector)
                           for sig, g in cache._sym_groups.items()]
        self._memo: Dict[tuple, List[int]] = {}
        self._rows: Dict[tuple, int] = {}
        self.seconds = 0.0

    def slots_for(self, pod: Pod) -> List[int]:
        if not self.groups:
            return []
        t0 = time.perf_counter()
        labels = pod.metadata.labels
        mk = (pod.metadata.namespace, tuple(labels.items()))
        hit = self._memo.get(mk)
        if hit is None:
            by_key: Dict[int, List[tuple]] = {}
            reg, overflow = self.cache.registry, self.cache.overflow
            for sig, key, ns, sel in self.groups:
                if ns != pod.metadata.namespace:
                    continue
                if not sel.matches(labels):
                    continue
                k = reg.index_of(key, overflow)
                if k >= 0:
                    by_key.setdefault(k, []).append(sig)
            hit = [self._rows.setdefault((k, frozenset(by_key[k])),
                                         len(self._rows))
                   for k in sorted(by_key)]
            self._memo[mk] = hit
        self.seconds += time.perf_counter() - t0
        return hit

    def build(self) -> Optional[F.SymTerms]:
        if not self._rows:
            return None
        t0 = time.perf_counter()
        cache = self.cache
        T = len(self._rows)
        with span("encode.sym_affinity", seq=self.seq, rows=T,
                  groups=len(self.groups)), cache._lock:
            cache._refresh_topology_locked()
            width = max(cache.cfg.domain_buckets, cache._rows_hw)
            key_idx = np.empty(T, dtype=np.int32)
            dom_w = np.zeros((T, width), dtype=np.float32)
            for (k, sigs), r in self._rows.items():
                acc = np.zeros(width)
                for sig in sigs:
                    g = cache._sym_groups.get(sig)
                    if g is not None:
                        acc += cache._sym_dom_locked(g, k, width)
                key_idx[r] = k
                dom_w[r] = acc
        self.seconds += time.perf_counter() - t0
        return F.SymTerms(key_idx=key_idx, dom_w=dom_w)


class NodeFeatureCache:
    """Thread-safe incrementally-maintained node feature arrays."""

    def __init__(self, cfg: EncodingConfig = DEFAULT_ENCODING, capacity: int = 64,
                 registry: Optional[TopologyKeyRegistry] = None):
        self.cfg = cfg
        self._lock = threading.Lock()
        self._feats = F.empty_node_features(capacity, cfg)
        self._capacity = capacity
        self._index: Dict[str, int] = {}  # node name → row
        self._names: List[Optional[str]] = [None] * capacity
        self._free_rows: List[int] = list(range(capacity - 1, -1, -1))
        # High-water marks (max allocated row + 1, monotonic): snapshots
        # may pad to step_bucket(hw) instead of the pow2 capacity — rows
        # beyond the high water are empty by construction, so the tighter
        # pad is always legal. Monotonicity keeps the engine's per-pad
        # compile/device-static caches from flapping under churn.
        self._rows_hw = 0
        self._a_hw = 0
        # Per-row TOPOLOGY incarnation: bumped when a row is (re)allocated
        # to a name or its topo-domain column changes on upsert. The
        # engine assumes pods BY NODE NAME against a snapshot taken
        # earlier in the cycle — a same-named node deleted and re-created
        # with different topology labels mid-cycle would otherwise commit
        # the pod into a domain the scan never judged (observed in chaos
        # as a hard-skew violation under zone-rotating node churn).
        # account_bind* treat an incarnation mismatch as a miss. Values
        # come from ONE global counter (never reused), so a replacement
        # that lands on a different row can never collide with the old
        # row's value.
        self._row_inc = np.zeros(capacity, dtype=np.int64)
        self._inc_counter = 0
        # pod key → (node row, requests vector, host ports, claim keys) for
        # incremental free-resource accounting; only bound pods appear here.
        self._bound: Dict[str, Tuple[int, np.ndarray, List[int], List[str]]] = {}
        # PVC key → {node row: mount count} (VolumeRestrictions RWO
        # exclusivity + NodeVolumeLimits attach counts).
        self._claims: Dict[str, Dict[int, int]] = {}
        # Claim keys backed by a cloud driver (VolumeClaim.volume_type):
        # they charge their per-cloud resource axis via pod_requests and
        # must NOT consume generic attachable-volumes slots in the claim
        # table's per-claim-per-node accounting.
        self._typed_claims: set = set()
        # Gang membership of bound pods: group → live count, pod key →
        # group. Feeds quorum accounting (ops/gang.py): a gang's effective
        # min_count is reduced by members already running cluster-wide, the
        # way upstream coscheduling counts total group membership — without
        # this a replacement member of a running gang could never schedule.
        self._gang_bound: Dict[str, int] = {}
        self._key_gang: Dict[str, str] = {}
        # Required anti-affinity terms of RUNNING pods (upstream symmetric
        # enforcement): sig=(key_idx, ns_hash, sel_pairs) → {node row:
        # [owner priorities]} (a multiset — add/drop stay exact). Feeds
        # anti_forbidden_for → encode.anti_forbid slots incl. the
        # preemption-curability columns (owner row + max priority).
        self._anti_terms: Dict[tuple, Dict[int, List[int]]] = {}
        # pod key → (priority, sigs)
        self._pod_anti: Dict[str, Tuple[int, List[tuple]]] = {}
        # (Anti-)affinity terms of RUNNING pods that score incoming pods
        # (upstream InterPodAffinity's existing-pod direction): sig =
        # repr((topology key, namespace, selector)) → _SymGroup (node row
        # → summed signed weight, and its per-domain sums); pod key →
        # (node row, sig, weight, sig, weight, ...). Feeds SymBatch →
        # encode.sym_slot and EncodedBatch.sym. ``sym_s_total``: host
        # seconds spent keeping it on bind and unbind (SymBatch times the
        # rest).
        self._sym_groups: Dict[str, _SymGroup] = {}
        self._pod_sym: Dict[str, tuple] = {}
        self.sym_s_total = 0.0
        # Owner-spread pairs in the assigned corpus's label rows
        # (SelectorSpread): OFF unless a profile actually runs the
        # plugin — the pair would otherwise fragment the bulk-rebuild
        # label-row memo per controller (100 same-labeled ReplicaSets =
        # 100 rows instead of 1) and emit under-count diagnostics for a
        # plugin nobody enabled. Enable BEFORE any bind accounting
        # (engines construct before their informers start).
        self._owner_pairs = False
        # Encoding-slot overflow reports: deduplicated and bounded — bind
        # churn re-reports the same pod's overflow on every account_bind,
        # and nothing drains this sink in production.
        self.overflow: List[str] = OverflowLog()
        self.version = 0  # bumped on every mutation (cheap staleness check)
        # Bumped only when STATIC node features change (node add/update/
        # remove, topology-domain refresh) — NOT on bind/unbind accounting,
        # which touches only free/used_ports. Consumers keying a
        # device-resident copy of the static feature leaves on this avoid
        # re-uploading ~tens of MB of unchanged matrices every batch.
        self.static_version = 0
        # topology keys shared with pod encoding; new registrations trigger
        # a domain-table refresh at the next snapshot
        self.registry = registry or TopologyKeyRegistry(cfg)
        self._topo_version = self.registry.version
        # assigned-pod corpus for topology-spread / inter-pod-affinity
        a_cap = max(64, capacity)
        self._assigned = F.empty_assigned_features(a_cap, cfg)
        self._a_capacity = a_cap
        self._a_free: List[int] = list(range(a_cap - 1, -1, -1))
        self._a_row: Dict[str, int] = {}  # pod key → assigned row
        # row → pod key (inverse of _a_row): lets per-node victim lookups
        # run as one vectorized mask over the assigned arrays instead of
        # an O(all bound pods) dict walk under the cache lock.
        self._a_key: List[Optional[str]] = [None] * a_cap
        # Dynamic-leaf mutation listeners (device-residency consumers);
        # every mutator of free/used_ports marks the touched rows into
        # each registered listener's set (see DynDeltaListener).
        self._dyn_listeners: List[DynDeltaListener] = []
        # Maintained-index consumers (subset of _dyn_listeners): static
        # node mutations additionally classify into narrowing row marks
        # vs widening invalidation epochs (see IndexDeltaListener).
        self._index_listeners: List[IndexDeltaListener] = []

    def register_dyn_listener(self) -> DynDeltaListener:
        """Register a consumer of the dynamic-leaf elision protocol (one
        per device-resident engine). Listeners are never unregistered —
        engines live as long as their shared cache."""
        lst = DynDeltaListener()
        with self._lock:
            self._dyn_listeners.append(lst)
        return lst

    def _mark_dyn_locked(self, rows) -> None:
        """Record rows whose free/used_ports changed (caller holds the
        lock). ``rows`` is an int, an iterable of ints, or an ndarray."""
        if not self._dyn_listeners:
            return
        if isinstance(rows, (int, np.integer)):
            for lst in self._dyn_listeners:
                lst.rows.add(int(rows))
            return
        if isinstance(rows, np.ndarray):
            rows = rows.tolist()
        for lst in self._dyn_listeners:
            lst.rows.update(rows)

    def register_index_listener(self) -> IndexDeltaListener:
        """Register a maintained-index consumer: receives dynamic-leaf
        row marks like every DynDeltaListener PLUS the static-mutation
        classification (narrowing rows vs widening invalidation epochs
        — see IndexDeltaListener). Never unregistered."""
        lst = IndexDeltaListener()
        with self._lock:
            self._dyn_listeners.append(lst)
            self._index_listeners.append(lst)
        return lst

    def _mark_index_static_locked(self, row: int) -> None:
        """A NARROWING static mutation touched ``row`` (caller holds
        the lock): index consumers repair the row in place."""
        for lst in self._index_listeners:
            lst.static_rows.add(int(row))

    def _inval_index_locked(self, cause: str = "widening") -> None:
        """A WIDENING (or non-row-attributable) static mutation landed
        (caller holds the lock): index consumers must rebuild. The
        journal event names the cause so a postmortem can tell a fresh
        node from a topology refresh when attributing a rebuild."""
        if not self._index_listeners:
            return
        for lst in self._index_listeners:
            lst.inval += 1

    def drain_index_rows(self, lst: IndexDeltaListener):
        """Drain an index listener's accumulated repair rows — dynamic
        marks ∪ narrowing static marks — plus its invalidation epoch and
        the cache ``version`` observed under the same lock hold, WITHOUT
        touching the dyn epoch protocol. The caller must drain BEFORE
        taking the snapshot it refreshes against (the tranche
        validator's baseline-drain discipline) and must NOT serve
        decisions from the index if the version moved between this
        drain and its snapshot: a mutation in that window is marked for
        the NEXT refresh but already inside THIS snapshot's truth, so
        the cached score for its row would be stale exactly for the
        batch about to consume it (the engine falls back to the full
        step for that batch — a counted race, not a desync)."""
        with self._lock:
            rows = lst.rows | lst.static_rows
            lst.rows.clear()
            lst.static_rows.clear()
            if not rows:
                return np.zeros(0, dtype=np.int32), lst.inval, self.version
            out = np.fromiter(rows, dtype=np.int32, count=len(rows))
            out.sort()
            return out, lst.inval, self.version

    def drain_dyn_rows(self, lst: DynDeltaListener):
        """Drain a listener's marked rows WITHOUT advancing its epoch or
        touching its base: returns (rows sorted, authoritative free
        copies, authoritative used_ports copies) for EVERY marked row —
        no filtering, so a node allocated beyond the caller's pad still
        surfaces. The device-loop tranche validator
        (engine/scheduler.py) uses this between loop iterations to ask
        "did host truth move off the carried chain since the last
        slot?" — a mutation whose truth still equals the tranche's
        replay mirror (the steady-state assume) keeps the fused loop
        running; anything else — including a row the tranche's pad
        cannot even represent — breaks it back to per-batch dispatch.
        The listener passed here is loop-private and never fed to
        snapshot_resident, so the epoch protocol is untouched."""
        with self._lock:
            if not lst.rows:
                return (np.zeros(0, dtype=np.int32),
                        np.zeros((0, self._feats.free.shape[1]),
                                 dtype=self._feats.free.dtype),
                        np.zeros((0, self._feats.used_ports.shape[1]),
                                 dtype=self._feats.used_ports.dtype))
            rows = np.fromiter(lst.rows, dtype=np.int32,
                               count=len(lst.rows))
            lst.rows.clear()
            rows.sort()
            return (rows, self._feats.free[rows].copy(),
                    self._feats.used_ports[rows].copy())

    def enable_owner_pairs(self) -> None:
        """Record controller-owner spread pairs in assigned label rows
        (SelectorSpread's population signal). Call before the first bind
        is accounted — rows accounted earlier carry no pair and would be
        under-counted until their pods churn."""
        with self._lock:
            self._owner_pairs = True

    # ---- node lifecycle -------------------------------------------------

    def upsert_node(self, node: Node, bound_pods=(), *,
                    narrows_only: Optional[bool] = None) -> None:
        """Encode (or re-encode) a node row. ``bound_pods``: pods to
        account onto the row INSIDE the same lock hold — for node
        re-creation, where pods of the previous incarnation are still
        bound to the name in the store. Accounting them after a separate
        upsert would leave a window in which a concurrent snapshot sees
        the recreated node at full free capacity and a batch over-commits
        it; snapshot takes this lock, so atomicity follows.

        ``narrows_only``: the informer path's
        ``state.events.node_update_narrows_only`` verdict for an UPDATE
        — True routes the static change to the index listeners as an
        in-place row repair; False/None (unknown, or a fresh node) is
        a widening invalidation (IndexDeltaListener contract)."""
        with self._lock:
            i = self._index.get(node.metadata.name)
            fresh_row = i is None
            if fresh_row:
                i = self._alloc_row()
                self._index[node.metadata.name] = i
                self._names[i] = node.metadata.name
                old_topo = None
            else:
                old_topo = self._feats.topo_domains[:, i].copy()
            # Re-encoding resets static columns; free is derived below.
            F.encode_node_into(self._feats, i, node, self.overflow)
            F.compute_topo_domains_row(self._feats, i, self.registry, self.cfg)
            if fresh_row or not np.array_equal(
                    old_topo, self._feats.topo_domains[:, i]):
                # new incarnation for assume-by-name purposes: a pending
                # assume judged against the previous topology must miss
                self._inc_counter += 1
                self._row_inc[i] = self._inc_counter
            self._recompute_free_row(i)
            for pod in bound_pods:
                self._account_bind_locked(pod, node.metadata.name)
            if narrows_only and not fresh_row:
                self._mark_index_static_locked(i)
            else:
                self._inval_index_locked("fresh-node" if fresh_row
                                         else "widening-update")
            self.version += 1
            self.static_version += 1

    def upsert_nodes_bulk(self, nodes) -> None:
        """Bulk node insert for the informer's initial sync / re-list: one
        lock hold and per-signature MEMOIZED encoding instead of one
        upsert_node per node. A 50k-node cluster carries a handful of
        distinct allocatable/label/taint signatures, so the per-node work
        collapses to dict hits + row assignments — this is the
        restart-to-first-batch cost (VERDICT r4 #7). Nodes already
        present re-route through upsert_node (the re-encode path with its
        incarnation/topology bookkeeping); fresh rows never have bound
        pods or claims, so free = allocatable by construction."""
        existing = []
        with self._lock:
            fresh = []
            batch_names: set = set()
            for node in nodes:
                # A duplicated name WITHIN the batch must take the
                # update path too: two "fresh" rows for one name would
                # leave a ghost valid row (double capacity) only the
                # second of which is indexed/removable.
                if (node.metadata.name in self._index
                        or node.metadata.name in batch_names):
                    existing.append(node)
                else:
                    batch_names.add(node.metadata.name)
                    fresh.append(node)
            self._ensure_node_capacity(len(fresh))
            feats = self._feats
            keys_snapshot = self.registry.keys()
            alloc_memo: Dict[tuple, np.ndarray] = {}
            label_memo: Dict[tuple, tuple] = {}
            taint_memo: Dict[tuple, tuple] = {}
            topo_memo: Dict[tuple, np.ndarray] = {}
            L = feats.label_pairs.shape[1]
            T = feats.taint_pairs.shape[1]
            vol_idx = RESOURCE_INDEX["attachable-volumes"]
            for node in fresh:
                name = node.metadata.name
                i = self._alloc_row()
                self._index[name] = i
                self._names[i] = name
                self._inc_counter += 1
                self._row_inc[i] = self._inc_counter

                feats.valid[i] = True
                feats.unschedulable[i] = node.spec.unschedulable
                alloc = node.status.allocatable
                asig = tuple(sorted(alloc.items()))
                v = alloc_memo.get(asig)
                if v is None:
                    v = F.resources_vector(alloc)
                    if "attachable-volumes" not in alloc:
                        v[vol_idx] = obj_mod.DEFAULT_ATTACHABLE_VOLUMES
                    for axis, limit in (
                            obj_mod.DEFAULT_CLOUD_VOLUME_LIMITS.items()):
                        if axis not in alloc:
                            v[RESOURCE_INDEX[axis]] = limit
                    alloc_memo[asig] = v
                feats.allocatable[i] = v
                feats.free[i] = v  # fresh row: nothing bound, no claims
                self._mark_dyn_locked(i)
                feats.name_suffix[i] = F.name_suffix_digit(name)
                feats.name_hash[i] = F._h(name)
                feats.avoid_pods[i] = (F.PREFER_AVOID_PODS_ANNOTATION
                                       in node.metadata.annotations)

                lsig = tuple(node.metadata.labels.items())
                rows = label_memo.get(lsig)
                if rows is None:
                    pairs = np.zeros(L, dtype=np.int32)
                    lkeys = np.zeros(L, dtype=np.int32)
                    for j, (k, val) in enumerate(lsig[:L]):
                        pairs[j] = F.pair_hash(k, val)
                        lkeys[j] = F.key_hash(k)
                    rows = label_memo[lsig] = (pairs, lkeys)
                if len(lsig) > L:
                    self.overflow.append(
                        f"node {node.key} labels: {len(lsig)} > {L} slots")
                feats.label_pairs[i] = rows[0]
                feats.label_keys[i] = rows[1]

                tsig = tuple((t.key, t.value, t.effect)
                             for t in node.spec.taints)
                trows = taint_memo.get(tsig)
                if trows is None:
                    tp = np.zeros(T, dtype=np.int32)
                    tk = np.zeros(T, dtype=np.int32)
                    te = np.full(T, F.EFFECT_NONE, dtype=np.int32)
                    for j, (k, val, eff) in enumerate(tsig[:T]):
                        tp[j] = F.pair_hash(k, val)
                        tk[j] = F.key_hash(k)
                        te[j] = F._EFFECT_CODE.get(eff, F.EFFECT_NO_SCHEDULE)
                    trows = taint_memo[tsig] = (tp, tk, te)
                if len(tsig) > T:
                    self.overflow.append(f"node {node.key} taints overflow")
                feats.taint_pairs[i] = trows[0]
                feats.taint_keys[i] = trows[1]
                feats.taint_effects[i] = trows[2]

                feats.images[i] = 0
                if node.status.images:
                    F._fill_slots(feats.images[i],
                                  [F._h(im) for im in node.status.images],
                                  f"node {node.key} images", self.overflow)

                tcol = topo_memo.get(lsig)
                if tcol is None:
                    # ONE implementation of the domain derivation: run
                    # the real per-row function on this (first) row, then
                    # memoize its label-dependent output. Slot 0
                    # (hostname — every node its own domain) is
                    # row-dependent: reset in the memo, patched per node.
                    F.compute_topo_domains_row(feats, i, self.registry,
                                               self.cfg,
                                               keys=keys_snapshot)
                    tcol = feats.topo_domains[:, i].copy()
                    tcol[0] = -1
                    topo_memo[lsig] = tcol
                else:
                    feats.topo_domains[:, i] = tcol
                feats.topo_domains[0, i] = i
            if fresh:
                self._inval_index_locked("fresh-nodes-bulk")
                self.version += 1
                self.static_version += 1
        for node in existing:
            self.upsert_node(node)

    def remove_node(self, name: str) -> List[str]:
        """Drop a node row. Returns the keys of bound pods whose accounting
        was dropped with it — the caller decides their fate (the engine
        remembers them: if a SAME-NAMED node reappears while they are
        still bound in the store, their capacity must be re-accounted onto
        the new row, or the recreated node silently over-commits)."""
        with self._lock:
            i = self._index.pop(name, None)
            if i is None:
                return []
            F.clear_node_row(self._feats, i)
            self._mark_dyn_locked(i)
            self._names[i] = None
            self._free_rows.append(i)
            # Bound-pod accounting rows pointing at this node are dropped;
            # their pods will be rescheduled by higher layers.
            gone = [k for k, v in self._bound.items() if v[0] == i]
            for k in gone:
                _, _, _, claims = self._bound.pop(k)
                self._drop_claims(i, claims)
                a = self._a_row.pop(k, None)
                if a is not None:
                    self._assigned.valid[a] = False
                    self._assigned.label_pairs[a] = 0
                    self._assigned.requests[a] = 0.0
                    self._assigned.priority[a] = 0
                    self._a_key[a] = None
                    self._a_free.append(a)
                self._drop_gang_member(k)
                self._anti_drop_locked(k, i)
                self._sym_drop_locked(k)
            # Node removal is NARROWING for the index: the cleared row
            # re-evaluates to statically-infeasible (valid=False → NEG)
            # at the next refresh — an in-place repair, no rebuild.
            self._mark_index_static_locked(i)
            self.version += 1
            self.static_version += 1
            return gone

    # ---- pod accounting -------------------------------------------------

    def account_bind(self, pod: Pod, node_name: str = "",
                     expected_inc: Optional[int] = None) -> bool:
        """Pod became bound: subtract its requests from the node's free row
        and add it to the assigned-pod corpus. ``node_name`` overrides
        ``pod.spec.node_name`` for the assume path, where the engine
        accounts a still-pending pod onto its selected node without
        mutating (or copying) the queued object.

        Returns False when the named node has NO row (deleted between the
        engine's snapshot and this assume, or a pod bound to a node the
        cache never saw) — the accounting did NOT happen and the caller
        must react (requeue the pod, or park it for re-adoption when a
        same-named node returns). A silent miss here is how a pod becomes
        permanently invisible to capacity/topology accounting.

        ``expected_inc`` (snapshot_versioned's row incarnation for the
        chosen row): a mismatch means the NAME now resolves to a node
        with DIFFERENT topology than the one the scheduling step judged
        (deleted + re-created with new labels mid-cycle) — treated as a
        miss, so the caller requeues and the next cycle sees the real
        topology."""
        with self._lock:
            ok = self._account_bind_locked(pod, node_name,
                                           expected_inc=expected_inc)
            self.version += 1
            return ok

    def account_bind_bulk(self, items, req_rows=None,
                          expected_inc=None) -> List[int]:
        """Assume a whole batch in one lock acquisition: ``items`` is a
        list of (pod, node_name). Returns the positions in ``items`` whose
        named node had NO row (deleted between snapshot and assume) — those
        pods were NOT accounted and the caller must requeue or park them
        (see ``account_bind``). ``expected_inc`` (optional, aligned with
        ``items``): per-item snapshot row incarnations; a mismatch is a
        miss (node replaced with different topology mid-cycle).

        ``req_rows`` optionally supplies the
        encoder's request rows (encode.PodFeatures.requests) so the
        dominant per-pod cost — rebuilding the request vector — is skipped.
        Only volume-free pods may reuse their encoded row: for pods with
        volumes the encoder folds unused-claim attach slots into the row,
        which bind accounting must instead route through the claim table.

        Pods without volumes or host ports take a vectorized fast path:
        one order-free per-node debit aggregate for the free-capacity
        update (the residency mirror's I1 form) and
        array-indexed fills of the assigned-pod corpus, with namespace
        hashes and label-pair rows memoized per distinct value (a 10k-pod
        deployment shares one label signature, so the per-pod Python work
        collapses to dict inserts)."""
        with self._lock:
            # Private copy (np.array, not asarray): rows of ``reqs`` are
            # stored in _bound as views, so the backing array must be
            # owned here — a caller-held buffer later mutated/reused would
            # otherwise silently corrupt unbind accounting.
            reqs = (None if req_rows is None
                    else np.array(req_rows, dtype=np.float32, copy=True))
            fast: List[tuple] = []  # (request row k, node row i, pod)
            missed: List[int] = []
            batch_seen: set = set()  # in-batch duplicate keys: sequential
            # accounting early-returns on the second occurrence (it is
            # already in _bound); mirror that by skipping it outright —
            # the fast path defers its _bound inserts, so the membership
            # check alone cannot see an earlier in-batch occurrence.
            for k, (pod, node_name) in enumerate(items):
                key = pod.key  # f-string property: build it ONCE per pod
                if key in batch_seen:
                    continue
                batch_seen.add(key)
                exp = None if expected_inc is None else expected_inc[k]
                if (reqs is None or pod.spec.volumes or pod.spec.ports
                        or self._pod_has_anti(pod)
                        or key in self._bound):
                    if not self._account_bind_locked(
                            pod, node_name,
                            None if reqs is None else reqs[k].copy(),
                            expected_inc=exp):
                        missed.append(k)
                    continue
                i = self._index.get(node_name or pod.spec.node_name)
                if i is None or (exp is not None
                                 and self._row_inc[i] != exp):
                    missed.append(k)
                    continue
                fast.append((k, i, pod, key))
            if fast:
                self._ensure_assigned_capacity(len(fast))
                kk = np.fromiter((k for k, _, _, _ in fast), dtype=np.int64,
                                 count=len(fast))
                ii = np.fromiter((i for _, i, _, _ in fast), dtype=np.int64,
                                 count=len(fast))
                # Several pods may land on one node row — fold them as
                # the ORDER-FREE per-node aggregate (sum the debits per
                # node, one subtract per node), the same form the
                # residency mirror replays (_DeviceResidency I1). Host
                # truth and mirror then perform the identical op
                # sequence by construction, independent of batch order.
                uniq = np.unique(ii)
                agg = np.zeros((uniq.shape[0], reqs.shape[1]),
                               dtype=self._feats.free.dtype)
                np.add.at(agg, np.searchsorted(uniq, ii), reqs[kk])
                self._feats.free[uniq] -= agg
                self._mark_dyn_locked(ii)
                a_rows = self._a_free[-len(fast):]
                del self._a_free[-len(fast):]
                aa = np.asarray(a_rows, dtype=np.int64)
                hw = int(aa.max()) + 1
                if hw > self._a_hw:
                    self._a_hw = hw
                self._assigned.valid[aa] = True
                self._assigned.node_row[aa] = ii
                self._assigned.requests[aa] = reqs[kk]
                self._assigned.priority[aa] = np.fromiter(
                    (pod.spec.priority for _, _, pod, _ in fast),
                    dtype=np.int32, count=len(fast))
                ns_memo: Dict[str, int] = {}
                row_memo: Dict[tuple, np.ndarray] = {}
                max_labels = self.cfg.max_labels
                for (k, i, pod, key), a in zip(fast, a_rows):
                    self._bound[key] = (i, reqs[k], (), [])
                    if pod.spec.affinity is not None:
                        self._sym_add_locked(pod, i)
                    self._a_row[key] = a
                    self._a_key[a] = key
                    group = gang_key(pod)
                    if group:
                        self._key_gang[key] = group
                        self._gang_bound[group] = \
                            self._gang_bound.get(group, 0) + 1
                    ns = pod.metadata.namespace
                    h = ns_memo.get(ns)
                    if h is None:
                        h = ns_memo[ns] = F._h(ns) if ns else 0
                    self._assigned.ns_hash[a] = h
                    # Owner pair in the memo KEY (when enabled):
                    # same-labeled pods of different controllers must not
                    # share a label row — SelectorSpread counts by owner.
                    opair = (F.owner_spread_pair(pod.metadata)
                             if self._owner_pairs else 0)
                    lsig = tuple(pod.metadata.labels.items())
                    sig = (opair, lsig)
                    row = row_memo.get(sig)
                    if row is None:
                        row = np.zeros(max_labels, dtype=np.int32)
                        for j, (lk, lv) in enumerate(lsig[:max_labels]):
                            row[j] = F.pair_hash(lk, lv)
                        if opair and len(lsig) < max_labels:
                            row[len(lsig)] = opair
                        row_memo[sig] = row
                    if len(lsig) > max_labels:
                        self.overflow.append(
                            f"assigned pod {pod.key} labels: "
                            f"{len(lsig)} > {max_labels} slots")
                    if opair and len(lsig) >= max_labels:
                        # same diagnostic as the per-pod path: the owner
                        # pair found no free slot (independent of the
                        # labels-overflow report above)
                        self.overflow.append(
                            f"assigned pod {pod.key}: no label slot left "
                            "for the owner spread pair; SelectorSpread "
                            "under-counts it")
                    self._assigned.label_pairs[a] = row
            self.version += 1
            return missed

    def _account_bind_locked(self, pod: Pod, node_name: str = "",
                             req: Optional[np.ndarray] = None,
                             expected_inc: Optional[int] = None) -> bool:
        """Returns False on a node-row miss (NOT accounted); True when the
        pod is accounted — including the idempotent already-bound case."""
        i = self._index.get(node_name or pod.spec.node_name)
        if i is None:
            return False
        if expected_inc is not None and self._row_inc[i] != expected_inc:
            return False  # same name, different topology incarnation
        if pod.key in self._bound:
            return True
        if req is None:
            req = F.resources_vector(pod_requests(pod))
        ports = [p.host_port for p in pod.spec.ports if p.host_port]
        claims = claim_keys(pod)
        if claims:
            # Attach slots are per-claim-per-node, not per-pod: a claim
            # already mounted on this node costs no new slot; the slot
            # frees only when the LAST mounting pod leaves (see
            # _drop_claims). The stored req's generic volume component
            # is zeroed — the claim table owns that axis. Cloud-typed
            # claims stay per-pod on their own axes (already in req).
            # A claim's typedness is decided at its FIRST mount and is
            # sticky for the mount epoch — charge and release must be
            # symmetric even if later pods reference the same claim
            # with a different volume_type.
            ns = pod.metadata.namespace
            for v in pod.spec.volumes:
                ck = f"{ns}/{v.claim_name}"
                if (ck not in self._claims
                        and v.volume_type in obj_mod.CLOUD_VOLUME_AXES):
                    self._typed_claims.add(ck)
            newly = sum(1 for ck in claims
                        if ck not in self._typed_claims
                        and not self._claims.get(ck, {}).get(i))
            req[_VOL] = 0.0
            self._feats.free[i, _VOL] -= newly
        self._bound[pod.key] = (i, req, ports, claims)
        self._feats.free[i] -= req
        self._add_ports(i, ports)
        self._mark_dyn_locked(i)
        for ck in claims:
            rows = self._claims.setdefault(ck, {})
            rows[i] = rows.get(i, 0) + 1
        group = gang_key(pod)
        if group:
            self._key_gang[pod.key] = group
            self._gang_bound[group] = self._gang_bound.get(group, 0) + 1
        self._anti_add_locked(pod, i)
        self._sym_add_locked(pod, i)

        a = self._alloc_assigned_row()
        self._a_row[pod.key] = a
        self._a_key[a] = pod.key
        self._assigned.valid[a] = True
        self._assigned.node_row[a] = i
        self._assigned.requests[a] = req
        self._assigned.priority[a] = pod.spec.priority
        self._assigned.ns_hash[a] = (F._h(pod.metadata.namespace)
                                     if pod.metadata.namespace else 0)
        self._assigned.label_pairs[a] = 0
        labels = list(pod.metadata.labels.items())
        if len(labels) > self.cfg.max_labels:
            self.overflow.append(
                f"assigned pod {pod.key} labels: {len(labels)} > "
                f"{self.cfg.max_labels} slots")
        for j, (k, v) in enumerate(labels[:self.cfg.max_labels]):
            self._assigned.label_pairs[a, j] = F.pair_hash(k, v)
        # Controller-owner pair (SelectorSpread, gated on the profile —
        # enable_owner_pairs): rides the label row so owner-population
        # counting reuses the selector-group match machinery unchanged.
        # Superset labels never break other groups' matching (a group
        # matches when ITS pairs are all present).
        opair = (F.owner_spread_pair(pod.metadata)
                 if self._owner_pairs else 0)
        if opair:
            if len(labels) < self.cfg.max_labels:
                self._assigned.label_pairs[a, len(labels)] = opair
            else:
                self.overflow.append(
                    f"assigned pod {pod.key}: no label slot left for the "
                    "owner spread pair; SelectorSpread under-counts it")
        return True

    def account_unbind(self, pod_key: str) -> None:
        """Bound pod deleted/unbound: return its requests to the node."""
        with self._lock:
            entry = self._bound.pop(pod_key, None)
            if entry is None:
                return
            i, req, ports, claims = entry
            released = self._drop_claims(i, claims)
            if self._names[i] is not None:
                self._feats.free[i] += req
                self._feats.free[i, _VOL] += released
                self._remove_ports(i, ports)
                self._mark_dyn_locked(i)
            a = self._a_row.pop(pod_key, None)
            if a is not None:
                self._assigned.valid[a] = False
                self._assigned.label_pairs[a] = 0
                self._assigned.requests[a] = 0.0
                self._assigned.priority[a] = 0
                self._a_key[a] = None
                self._a_free.append(a)
            self._drop_gang_member(pod_key)
            self._anti_drop_locked(pod_key, i)
            self._sym_drop_locked(pod_key)
            self.version += 1

    def _drop_gang_member(self, pod_key: str) -> None:
        """Decrement the pod's gang live count (caller holds the lock)."""
        group = self._key_gang.pop(pod_key, None)
        if group is not None:
            left = self._gang_bound.get(group, 0) - 1
            if left > 0:
                self._gang_bound[group] = left
            else:
                self._gang_bound.pop(group, None)

    def gang_bound_count(self, group: str) -> int:
        """Live (bound/assumed) members of a gang (namespaced gang key),
        cluster-wide."""
        with self._lock:
            return self._gang_bound.get(group, 0)

    def _drop_claims(self, row: int, claims: List[str]) -> int:
        """Remove one pod's claim mounts from row (caller holds the lock).
        Returns how many GENERIC claims became UNMOUNTED on this row — the
        number of generic attach slots freed (cloud-typed claims are
        charged per pod on their own axes, not via the claim table)."""
        released = 0
        for ck in claims:
            rows = self._claims.get(ck)
            if rows is None:
                continue
            left = rows.get(row, 0) - 1
            if left > 0:
                rows[row] = left
            else:
                if (rows.pop(row, None) is not None
                        and ck not in self._typed_claims):
                    released += 1
            if not rows:
                del self._claims[ck]
                self._typed_claims.discard(ck)
        return released

    CLAIM_UNUSED = obj_mod.CLAIM_UNUSED
    CLAIM_MULTI = obj_mod.CLAIM_MULTI

    def claim_node_row(self, claim_key: str) -> int:
        """Node row a PVC is exclusively mounted on (VolumeRestrictions RWO
        semantics), CLAIM_UNUSED when nobody mounts it, CLAIM_MULTI when it
        is mounted on several nodes — both negative values are treated as
        unrestricted by the filter, but only CLAIM_UNUSED participates in
        the engine's in-batch RWO arbitration."""
        with self._lock:
            rows = self._claims.get(claim_key)
            if rows is None:
                return self.CLAIM_UNUSED
            if len(rows) == 1:
                return next(iter(rows))
            return self.CLAIM_MULTI

    # ---- snapshot -------------------------------------------------------

    # NodeFeatures leaves written by bind/unbind accounting; everything
    # else changes only with static_version.
    DYNAMIC_NF_FIELDS = ("free", "used_ports")

    def snapshot(self, pad: Union[int, Callable[[int], int], None] = None,
                 ) -> Tuple[NodeFeatures, List[Optional[str]]]:
        """Copy of the feature arrays padded to ``pad`` (default: bucketed
        capacity), plus the row→name mapping (None = empty row).

        ``pad`` may be smaller than capacity when every row beyond it is
        empty (e.g. capacity doubled to 64k for 50k nodes; a 51200 pad
        avoids wasting 30% of the matrices on padding)."""
        feats, names, _sv, _incs = self.snapshot_versioned(pad)
        return feats, names

    def snapshot_versioned(self,
                           pad: Union[int, Callable[[int], int],
                                      None] = None,
                           known_static=None):
        """``snapshot`` that also returns the static version OBSERVED UNDER
        THE SNAPSHOT LOCK — the topology refresh performed here may itself
        bump it, so a version read before the call can be stale while the
        arrays are fresh (a consumer keying device-resident static leaves
        on the early read would then serve old leaves deterministically
        whenever a batch registers a new topology key).

        ``known_static``: the (static_version, pad) key the caller already
        holds device copies for. When it matches, the static leaves are
        returned as ``None`` instead of host copies — the caller replaces
        them anyway, and skipping them drops ~tens of MB of memcpy from
        every steady-state batch.

        ``pad`` may be a CALLABLE ``hw -> int``: it is resolved from the
        row high-water mark UNDER the snapshot lock, so a concurrent
        node add on the informer thread can never allocate a row past a
        pad the caller computed from a stale high-water read (row
        allocation takes the same lock).

        Returns (feats, names, static_version, row_incarnations) — the
        incarnation column (padded with zeros) lets assume-by-name
        detect a node replaced with different topology mid-cycle
        (account_bind's ``expected_inc``).
        """
        feats, names, sv, incs, _delta = self._snapshot_impl(
            pad, known_static, None)
        return feats, names, sv, incs

    def snapshot_resident(self,
                          pad: Union[int, Callable[[int], int],
                                     None] = None,
                          known_static=None,
                          dyn: Optional[DynDeltaListener] = None):
        """snapshot_versioned extended with the DYNAMIC-leaf elision
        protocol: when ``dyn`` (a registered DynDeltaListener) holds a
        valid base at the resolved pad, the returned feats carry ``None``
        for the dynamic leaves and the fifth element is a
        features.DynDelta with exactly the rows mutated since the last
        collection (the consumer corrects its device-resident copies
        from it). Otherwise the dynamic leaves are full host copies, the
        delta is None, and the listener is REBASED to this snapshot
        (epoch bumped, row set cleared) — the consumer must upload the
        full leaves it was just handed.

        Returns (feats, names, static_version, row_incarnations,
        delta_or_None)."""
        if "snapshot_versioned" in self.__dict__:
            # Test instrumentation patches snapshot_versioned on the
            # INSTANCE to inject mid-cycle races (tests/test_ghost_bind)
            # — the same contract the engine honors for instance-patched
            # schedule_batch. Route through the patch and answer with
            # full dynamic leaves (the consumer re-establishes, so the
            # elision protocol never hides a patched snapshot's view).
            if dyn is not None:
                dyn.invalidate()
            feats, names, sv, incs = self.snapshot_versioned(
                pad, known_static)
            return feats, names, sv, incs, None
        return self._snapshot_impl(pad, known_static, dyn)

    def _snapshot_impl(self, pad, known_static, dyn):
        with self._lock:
            self._refresh_topology_locked()
            sv = self.static_version
            n = self._capacity
            if callable(pad):
                target = pad(self._rows_hw)
            else:
                target = pad if pad is not None else bucket_for(n)
            f = self._feats

            delta = None
            skip_dyn = False
            if dyn is not None:
                if dyn.valid and dyn.pad == target:
                    rows = np.fromiter(dyn.rows, dtype=np.int32,
                                       count=len(dyn.rows))
                    rows.sort()
                    # Rows are < rows_hw ≤ target by construction; the
                    # guard keeps a future pad-policy change from
                    # silently shipping out-of-pad corrections.
                    rows = rows[rows < target]
                    dyn.rows.clear()
                    dyn.epoch += 1
                    delta = F.DynDelta(epoch=dyn.epoch, rows=rows,
                                       free=f.free[rows].copy(),
                                       used_ports=f.used_ports[rows].copy())
                    skip_dyn = True
                else:
                    # Rebase: this snapshot's full dynamic leaves are the
                    # listener's new base at this pad.
                    dyn.valid = True
                    dyn.pad = target
                    dyn.rows.clear()
                    dyn.epoch += 1

            skip = (lambda name:
                    (known_static == (sv, target)
                     and name not in self.DYNAMIC_NF_FIELDS)
                    or (skip_dyn and name in self.DYNAMIC_NF_FIELDS))

            if target <= n:
                if target < n and f.valid[target:].any():
                    raise ValueError(
                        f"pad {target} < capacity {n} with live rows "
                        "beyond it")
                # topo_domains is (K, N) — its node axis is axis 1.
                feats = NodeFeatures(*(
                    None if skip(name)
                    else (a[:, :target].copy() if name == "topo_domains"
                          else a[:target].copy())
                    for name, a in zip(f._fields, f)))
                names = list(self._names[:target])
            else:
                # Grow-pad: copy into empty features so padding rows keep
                # the empty defaults (e.g. topo_domains -1 = "no domain").
                empty = F.empty_node_features(target, self.cfg)
                leaves = []
                for name, a, e in zip(f._fields, f, empty):
                    if skip(name):
                        leaves.append(None)
                        continue
                    if name == "topo_domains":
                        e[:, :n] = a
                    else:
                        e[:n] = a
                    leaves.append(e)
                feats = NodeFeatures(*leaves)
                names = list(self._names) + [None] * (target - n)
            incs = np.zeros(target, dtype=np.int64)
            m = min(target, n)
            incs[:m] = self._row_inc[:m]
            return feats, names, sv, incs, delta

    def snapshot_assigned(self, pad: Union[int, Callable[[int], int],
                                         None] = None,
                          ) -> AssignedPodFeatures:
        """Copy of the assigned-pod corpus padded/truncated like
        snapshot(). ``pad`` may be a callable ``hw -> int`` resolved from
        the assigned-row high-water mark under the lock (see
        snapshot_versioned)."""
        with self._lock:
            a = self._a_capacity
            if callable(pad):
                target = pad(self._a_hw)
            else:
                target = pad if pad is not None else bucket_for(a)
            f = self._assigned
            if target < a:
                if f.valid[target:].any():
                    raise ValueError(
                        f"assigned pad {target} < capacity {a} with live rows")
                return AssignedPodFeatures(*(x[:target].copy() for x in f))
            if target == a:
                return AssignedPodFeatures(*(x.copy() for x in f))
            empty = F.empty_assigned_features(target, self.cfg)
            for x, e in zip(f, empty):
                e[:a] = x
            return empty

    def assigned_count(self) -> int:
        with self._lock:
            return len(self._a_row)

    def node_count(self) -> int:
        with self._lock:
            return len(self._index)

    def rows_high_water(self) -> int:
        """Max node row ever allocated + 1 (monotonic; ≤ capacity).
        step_bucket(rows_high_water()) is the tightest legal snapshot pad."""
        with self._lock:
            return self._rows_hw

    def assigned_high_water(self) -> int:
        """Max assigned-corpus row ever allocated + 1 (monotonic)."""
        with self._lock:
            return self._a_hw

    def row_of(self, name: str) -> Optional[int]:
        with self._lock:
            return self._index.get(name)

    # ---- symmetric anti-affinity table ----------------------------------

    @staticmethod
    def _pod_has_anti(pod: Pod) -> bool:
        a = pod.spec.affinity
        return bool(a and a.pod_anti_affinity and a.pod_anti_affinity.required)

    def _anti_sigs(self, pod: Pod) -> List[tuple]:
        """Signatures of the pod's required anti terms, mirroring
        encode.GroupBuilder's (key_idx, ns_hash, sorted sel pairs) —
        the two sides must agree for symmetric matching to line up."""
        if not self._pod_has_anti(pod):
            return []
        ns_h = (F._h(pod.metadata.namespace)
                if pod.metadata.namespace else 0)
        sigs = []
        for term in pod.spec.affinity.pod_anti_affinity.required:
            key_idx = self.registry.index_of(term.topology_key, self.overflow)
            # key_idx < 0 (registry full): the term's domains cannot be
            # represented. Keep the signature with the sentinel key rather
            # than dropping the term — anti_forbidden_for surfaces it as an
            # unrepresentable (-1, -1) pair so the engine FAILS CLOSED for
            # matching pods instead of silently permitting them.
            # Multiple namespaces are exact here (host-side matching): one
            # signature per namespace, each matched independently.
            ns_list = ([F._h(n) for n in term.namespaces]
                       if term.namespaces else [ns_h])
            pairs: tuple = ()
            if term.label_selector is not None:
                raw = sorted(F.pair_hash(k, v) for k, v in
                             term.label_selector.match_labels.items())
                if len(raw) > self.cfg.max_term_selector_pairs:
                    # Truncation BROADENS the match (repels more pods) —
                    # the conservative direction for a hard constraint.
                    self.overflow.append(
                        f"anti-affinity term on {pod.key}: selector pairs "
                        f"overflow ({len(raw)} > "
                        f"{self.cfg.max_term_selector_pairs}); truncated")
                pairs = tuple(raw[: self.cfg.max_term_selector_pairs])
            for ns in ns_list:
                sigs.append((key_idx, ns, pairs))
        return sigs

    def _anti_add_locked(self, pod: Pod, row: int) -> None:
        sigs = self._anti_sigs(pod)
        if sigs:
            pri = int(pod.spec.priority)
            self._pod_anti[pod.key] = (pri, sigs)
            for sig in sigs:
                rows = self._anti_terms.setdefault(sig, {})
                # per-row multiset of owner priorities: O(distinct sigs)
                # aggregation in anti_forbidden_for, exact max on drop
                rows.setdefault(row, []).append(pri)

    def _anti_drop_locked(self, pod_key: str, row: int) -> None:
        entry = self._pod_anti.pop(pod_key, None)
        if entry is None:
            return
        pri, sigs = entry
        for sig in sigs:
            rows = self._anti_terms.get(sig)
            if not rows:
                continue
            pris = rows.get(row)
            if pris:
                try:
                    pris.remove(pri)
                except ValueError:
                    pass
                if not pris:
                    rows.pop(row, None)
            if not rows:
                self._anti_terms.pop(sig, None)

    # ---- symmetric affinity terms (scoring) -----------------------------

    def _sym_add_locked(self, pod: Pod, row: int) -> None:
        terms = _sym_terms_of(pod)
        if not terms:
            return
        t0 = time.perf_counter()
        entry = [row]
        for key, ns, sel, w in terms:
            # The signature as one string: the pod's entry then holds
            # strings and numbers alone, which the collector untracks at
            # its first pass, so the index leaves nothing per bound pod
            # for the older generations to walk.
            sig = repr((key, ns, _selector_sig(sel)))
            g = self._sym_groups.get(sig)
            if g is None:
                g = self._sym_groups[sig] = _SymGroup(key, ns, sel)
            g.owners += 1
            self._sym_move_locked(g, row, w)
            entry += (sig, w)
        self._pod_sym[pod.key] = tuple(entry)
        self.sym_s_total += time.perf_counter() - t0

    def _sym_drop_locked(self, pod_key: str) -> None:
        got = self._pod_sym.pop(pod_key, None)
        if got is None:
            return
        t0 = time.perf_counter()
        row = got[0]
        for sig, w in zip(got[1::2], got[2::2]):
            g = self._sym_groups.get(sig)
            if g is None:
                continue
            g.owners -= 1
            if g.owners <= 0:
                del self._sym_groups[sig]
                continue
            self._sym_move_locked(g, row, -w)
        self.sym_s_total += time.perf_counter() - t0

    @staticmethod
    def _sym_move_locked(g: "_SymGroup", row: int, w: float) -> None:
        """Add ``w`` at node ``row`` to group ``g``."""
        left = g.rows.get(row, 0.0) + w
        if left:
            g.rows[row] = left
        else:
            g.rows.pop(row, None)

    def _sym_dom_locked(self, g: "_SymGroup", key_idx: int,
                        width: int) -> np.ndarray:
        """Group ``g``'s summed weight per domain of key ``key_idx``
        (float64, ``width`` long: ids past it are none of a node's)."""
        rows = np.fromiter(g.rows.keys(), dtype=np.int64, count=len(g.rows))
        w = np.fromiter(g.rows.values(), dtype=np.float64,
                        count=len(g.rows))
        d = self._feats.topo_domains[key_idx, rows]
        ok = (d >= 0) & (d < width)
        return np.bincount(d[ok], weights=w[ok], minlength=width)

    def sym_stats(self) -> Tuple[float, int]:
        """(host seconds spent keeping the symmetric terms, live term
        groups). Read without the cache's lock (a float and a dict's
        length): ``metrics()`` must not wait behind a bulk bind."""
        return self.sym_s_total, len(self._sym_groups)

    def victims_below(self, node_name: str, priority: int) -> List[tuple]:
        """Bound pods on ``node_name`` with priority STRICTLY below
        ``priority``: (pod_key, accounted request row, priority), sorted
        ascending by priority — the DefaultPreemption victim pool (lowest
        victims first, upstream's eviction order). GANG members are never
        offered as victims: evicting one would leave its group running
        below quorum, violating the all-or-nothing contract (cascading
        whole-gang eviction is out of scope)."""
        with self._lock:
            i = self._index.get(node_name)
            if i is None:
                return []
            cap = self._a_capacity
            rows = np.nonzero(
                self._assigned.valid[:cap]
                & (self._assigned.node_row[:cap] == i)
                & (self._assigned.priority[:cap] < priority))[0]
            out = []
            for a in rows.tolist():
                key = self._a_key[a]
                entry = self._bound.get(key) if key is not None else None
                if entry is None or key in self._key_gang:
                    continue
                out.append((key, entry[1].copy(),
                            int(self._assigned.priority[a])))
            out.sort(key=lambda t: t[2])
            return out

    def bound_keys_on(self, node_name: str) -> List[str]:
        """Keys of ALL bound/assumed pods on ``node_name`` — preemption's
        cure verification scans these (not just the evictable victim
        pool) so an unevictable repeller (gang member, priority race)
        fails the cure closed instead of being silently skipped."""
        with self._lock:
            i = self._index.get(node_name)
            if i is None:
                return []
            return [k for k, v in self._bound.items() if v[0] == i]

    def repelling_owners_on(self, node_name: str, pod: Pod) -> List[str]:
        """Keys of bound pods ON ``node_name`` whose required
        anti-affinity term matches ``pod`` (the symmetric existing-pod
        direction) — preemption's mandatory victim set for curing an
        anti_forbid slot at that node (ops/preempt.py). Term semantics
        mirror anti_forbidden_for."""
        with self._lock:
            i = self._index.get(node_name)
            if i is None or not self._pod_anti:
                return []
            ns_h = (F._h(pod.metadata.namespace)
                    if pod.metadata.namespace else 0)
            labels = {F.pair_hash(k, v)
                      for k, v in pod.metadata.labels.items()}
            out: List[str] = []
            for owner_key, (_pri, sigs) in self._pod_anti.items():
                entry = self._bound.get(owner_key)
                if entry is None or entry[0] != i:
                    continue
                for (_key_idx, ns, pairs) in sigs:
                    if ns != 0 and ns != ns_h:
                        continue
                    if all(p in labels for p in pairs):
                        out.append(owner_key)
                        break
            return out

    def free_of(self, node_name: str) -> Optional[np.ndarray]:
        """Current free-resource vector of one node (copy), or None."""
        with self._lock:
            i = self._index.get(node_name)
            return None if i is None else self._feats.free[i].copy()

    def anti_forbidden_for(self, pod: Pod
                           ) -> List[Tuple[int, int, int, int]]:
        """(key_idx, domain, owner_row, owner_maxpri) entries the pod must
        avoid: domains holding a RUNNING pod whose required anti-affinity
        term matches this pod (upstream existing-pod anti-affinity
        symmetry; term semantics mirror the device side: empty selector =
        match-all, term namespace defaults to the owner pod's). Feeds
        encode.anti_forbid slots via the engine's encode callback.

        The two trailing fields feed preemption curability
        (ops/preempt.py): ``owner_row`` is the single node row holding
        EVERY owner of the (key, domain) entry, or -1 when owners span
        nodes — upstream DefaultPreemption evicts node-local victims
        only, so a multi-node ownership cannot be cured;
        ``owner_maxpri`` is the highest owner priority (a preemptor must
        outrank every owner). The sentinel entry is (-1, -1, -1, 0)."""
        with self._lock:
            if not self._anti_terms:
                return []
            self._refresh_topology_locked()
            ns_h = (F._h(pod.metadata.namespace)
                    if pod.metadata.namespace else 0)
            labels = {F.pair_hash(k, v)
                      for k, v in pod.metadata.labels.items()}
            # (key_idx, dom) → [single_row_or_-1, max_priority]
            agg: Dict[Tuple[int, int], list] = {}
            sentinel = False
            for (key_idx, ns, pairs), rows in self._anti_terms.items():
                # ns 0 = any-namespace wildcard, mirroring the device
                # group convention (a term owner with no namespace).
                if ns != 0 and ns != ns_h:
                    continue
                if not all(p in labels for p in pairs):
                    continue
                if key_idx < 0:
                    # Unrepresentable term (registry was full when its
                    # owner bound): forbidden domains unknown — emit the
                    # sentinel so the engine fails closed.
                    sentinel = True
                    continue
                for row, pris in rows.items():
                    dom = int(self._feats.topo_domains[key_idx, row])
                    if dom < 0 or not pris:
                        continue
                    pri = max(pris)
                    cur = agg.get((key_idx, dom))
                    if cur is None:
                        agg[(key_idx, dom)] = [row, pri]
                    else:
                        if cur[0] != row:
                            cur[0] = -1  # owners span nodes: incurable
                        cur[1] = max(cur[1], pri)
            out: List[Tuple[int, int, int, int]] = []
            if sentinel:
                out.append((-1, -1, -1, 0))
            for (key_idx, dom), (row, pri) in agg.items():
                out.append((key_idx, dom, row, pri))
            return out

    # ---- internals ------------------------------------------------------

    def _ensure_node_capacity(self, need: int) -> None:
        while len(self._free_rows) < need:
            new_cap = self._capacity * 2
            grown = F.empty_node_features(new_cap, self.cfg)
            for name, a, g in zip(self._feats._fields, self._feats, grown):
                if name == "topo_domains":  # node axis is axis 1
                    g[:, : self._capacity] = a
                else:
                    g[: self._capacity] = a
            self._feats = grown
            self._names += [None] * (new_cap - self._capacity)
            self._free_rows = list(range(new_cap - 1, self._capacity - 1,
                                         -1)) + self._free_rows
            inc = np.zeros(new_cap, dtype=np.int64)
            inc[: self._capacity] = self._row_inc
            self._row_inc = inc
            self._capacity = new_cap

    def _alloc_row(self) -> int:
        self._ensure_node_capacity(1)
        row = self._free_rows.pop()
        if row >= self._rows_hw:
            self._rows_hw = row + 1
        return row

    def _ensure_assigned_capacity(self, need: int) -> None:
        while len(self._a_free) < need:
            new_cap = self._a_capacity * 2
            grown = F.empty_assigned_features(new_cap, self.cfg)
            for x, g in zip(self._assigned, grown):
                g[: self._a_capacity] = x
            self._assigned = grown
            self._a_free += list(range(new_cap - 1, self._a_capacity - 1, -1))
            self._a_key += [None] * (new_cap - self._a_capacity)
            self._a_capacity = new_cap

    def _alloc_assigned_row(self) -> int:
        self._ensure_assigned_capacity(1)
        row = self._a_free.pop()
        if row >= self._a_hw:
            self._a_hw = row + 1
        return row

    def _refresh_topology_locked(self) -> None:
        """Recompute domain tables if new topology keys registered since the
        last snapshot (pod encoding may grow the shared registry)."""
        # Snapshot the version ONCE at entry: a concurrent index_of on the
        # scheduling thread mid-loop would otherwise mark this refresh
        # current while early rows were computed without the new key.
        v = self.registry.version
        if self._topo_version == v:
            return
        keys = self.registry.keys()  # one lock + copy, not one per row
        for name, i in self._index.items():
            F.compute_topo_domains_row(self._feats, i, self.registry,
                                       self.cfg, keys=keys)
        self._topo_version = v
        # Not row-attributable (every row's domain columns moved) —
        # index-eligible plugins read no topology state, but the
        # conservative rung is an invalidation, not a guess.
        self._inval_index_locked("topology-refresh")
        self.static_version += 1

    def _recompute_free_row(self, i: int) -> None:
        free = self._feats.allocatable[i].copy()
        ports: List[int] = []
        for key, (row, req, p, claims) in self._bound.items():
            if row == i:
                free -= req  # volume component is 0; claim table owns it
                ports += p
        free[_VOL] -= sum(1 for ck, rows in self._claims.items()
                          if rows.get(i) and ck not in self._typed_claims)
        self._feats.free[i] = free
        self._feats.used_ports[i] = 0
        self._add_ports(i, ports)
        self._mark_dyn_locked(i)

    def _add_ports(self, i: int, ports: List[int]) -> None:
        row = self._feats.used_ports[i]
        for p in ports:
            for j in range(row.shape[0]):
                if row[j] == 0:
                    row[j] = p
                    break
            else:
                self.overflow.append(f"node row {i}: used host ports overflow")

    def _remove_ports(self, i: int, ports: List[int]) -> None:
        row = self._feats.used_ports[i]
        for p in ports:
            for j in range(row.shape[0]):
                if row[j] == p:
                    row[j] = 0
                    break


def static_token(leaves: Dict[str, np.ndarray]) -> str:
    """A content hash over a snapshot's STATIC node-feature leaves (host
    numpy arrays, by field name): two tenants with equal tokens may share
    one broadcast static encoding in a fused step."""
    import hashlib

    h = hashlib.blake2b(digest_size=16)
    for f in NodeFeatures._fields:
        if f in NodeFeatureCache.DYNAMIC_NF_FIELDS:
            continue
        arr = np.asarray(leaves[f])
        h.update(f.encode())
        h.update(str(arr.shape).encode())
        h.update(str(arr.dtype).encode())
        h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()


def _leaf_sig(tree) -> tuple:
    """(shape, dtype) of every array leaf of a nest of NamedTuples, in
    field order (numpy arrays or tensors; None for an absent leaf, as
    EncodedBatch.sym)."""
    if tree is None:
        return (None,)
    if isinstance(tree, tuple):
        return tuple(s for x in tree for s in _leaf_sig(x))
    return ((tuple(tree.shape), str(tree.dtype)),)


class _TenantLane:
    """One tenant engine's submitted batch inside a fusion round: the
    fully staged step inputs (exactly what the solo dispatch would have
    consumed, on the engine's device), the cache version at submit (the
    race gate), and the engine's batch (``inf``, its ``_Batch``) that
    the decision planes go back to. An INDEXED lane also carries its
    engine's repaired (C,N) score slab and this batch's class rows on the
    device (idx_slab / idx_cls / idx_k)."""

    __slots__ = ("engine", "inf", "eb", "nf", "af", "key", "version",
                 "w_vec", "group_key", "idx_slab", "idx_cls", "idx_k")


class TenantCacheMux:
    """Fused multi-tenant dispatch rendezvous (MINISCHED_TENANTS_FUSE).

    One mux serves a fusion coordinator's round: the coordinator sets
    ``round_pods`` (the round's common pod pad: ragged tenant batches pad
    to it with invalid rows), drives each tenant engine's prepare (a
    fusable batch SUBMITS its staged step inputs here instead of
    dispatching), then calls ``dispatch()``, which groups compatible
    lanes, runs ONE fused step per group (ops/pipeline.build_tenant_step:
    one selection launch and one scan launch for every lane of the
    group), reads the whole group's decisions back in ONE (T, 6+F, P)
    copy, and hands every lane its unpacked planes and its ``free``
    after, before the coordinator resolves it.

    Contract:

      * submit captures the lane's inputs fully staged (the objects the
        solo dispatch would have consumed), so a cache mutation landing
        mid-round cannot change the fused result. The recorded
        ``cache.version`` still gates dispatch: a moved version
        re-dispatches that lane SOLO through the engine's own step (same
        inputs, same key, so the same decision) and counts a tenant race.
      * lanes fuse only within a compatibility group: equal plugin trace
        keys (weights excluded: they ride the (T,S) weight matrix), the
        shortlist width, the input leaves' shapes and dtypes, and a
        content token over the static node leaves (the fused step
        broadcasts lane 0's statics). The token is the hash of the host
        arrays the engine uploaded them from, computed once per (static
        version, pad) (``Scheduler._with_device_static``): hashing the
        device tensors would make every round wait for the card.
      * per-tenant sparse deltas keep routing through each tenant's own
        listeners: the mux multiplexes dispatch, never the caches.

    Single-threaded: submit and dispatch run on the coordinator's serve
    thread, as the engine's own prepare and resolve phases do.
    """

    def __init__(self):
        self.round_pods = 0          # common P pad for the current round
        self.max_lanes = 0           # fused-tranche width cap (0 = none)
        self.lanes: List[_TenantLane] = []
        # The fusion ledger: tenant_dispatches counts fused dispatches
        # (one per compatibility group per round; solo fallbacks book on
        # their engine's steps_dispatched), tenant_fetches the one
        # read-back per group; tenant_index_* the fused indexed subset;
        # tenant_groups_round_max the most groups one round fused.
        self.counters: Dict[str, float] = {
            "tenant_rounds": 0, "tenant_dispatches": 0,
            "tenant_fetches": 0, "tenant_fetch_bytes": 0.0,
            "tenant_groups": 0, "tenant_lanes_fused": 0,
            "tenant_races": 0, "tenant_solo_fallbacks": 0,
            "tenant_index_dispatches": 0, "tenant_index_lanes": 0,
            "tenant_groups_round_max": 0,
        }
        # Test seam: called at the top of dispatch() so a test can land a
        # mid-round cache mutation between submit and dispatch (the
        # counted race fallback).
        self._pre_dispatch_hook = None

    # ---- compatibility grouping -----------------------------------------

    @staticmethod
    def _static_token(engine) -> object:
        """The content token of the static node leaves the engine's lane
        was staged with; an engine whose statics were uploaded before a
        mux was armed has none, and its lanes group alone."""
        cached = engine._nf_static_device
        tok = cached[2] if cached is not None else None
        return tok if tok is not None else ("engine", id(engine))

    def _compat_key(self, engine, eb, nf, af) -> tuple:
        pset = engine.plugin_set
        dyn_sig = tuple((f,) + _leaf_sig(getattr(nf, f))
                        for f in NodeFeatureCache.DYNAMIC_NF_FIELDS)
        return (
            tuple(p.trace_key() for p in pset.filter_plugins),
            tuple(p.trace_key() for p in pset.score_plugins),
            engine._shortlist_k, _leaf_sig(eb), _leaf_sig(af), dyn_sig,
            str(nf.valid.device), self._static_token(engine),
        )

    # ---- the round --------------------------------------------------------

    def submit(self, engine, inf, eb, nf, af, key,
               index=None) -> _TenantLane:
        """Stage one tenant engine's prepared batch (``eb``/``nf``/``af``
        on the engine's device, ``key`` its PRNG key) for the round's
        fused dispatch. Returns the lane ticket the engine parks on
        ``inf.tenant_ticket``; ``dispatch()`` fills the decision planes
        and clears it. ``index`` is the engine's staged index payload
        ``(score_slab, cls (P,) on the device, k_eff)``
        (Scheduler._tenant_index_stage): indexed lanes group apart from
        full lanes (the slab's class pad and the scan width join the
        group key), so a group is homogeneous and dispatches through
        ops/pipeline.build_tenant_index_step."""
        pset = engine.plugin_set
        lane = _TenantLane()
        lane.engine, lane.inf = engine, inf
        lane.eb, lane.nf, lane.af, lane.key = eb, nf, af, key
        lane.version = engine.cache.version
        lane.w_vec = np.asarray(
            [pset.weight_of(p) for p in pset.score_plugins],
            dtype=np.float32)
        if index is not None:
            lane.idx_slab, lane.idx_cls, lane.idx_k = index
            mode = ("idx", int(lane.idx_slab.shape[0]), int(lane.idx_k))
        else:
            lane.idx_slab = lane.idx_cls = lane.idx_k = None
            mode = ("full",)
        lane.group_key = self._compat_key(engine, eb, nf, af) + mode
        self.lanes.append(lane)
        return lane

    def dispatch(self) -> None:
        """Fire the round: ONE fused dispatch per compatibility group (a
        one-lane group too, so every ticket is filled by the same
        machinery), split into tranches of ``max_lanes``, and a solo
        per-engine dispatch for raced lanes."""
        lanes, self.lanes = self.lanes, []
        if not lanes:
            return
        if self._pre_dispatch_hook is not None:
            self._pre_dispatch_hook()
        self.counters["tenant_rounds"] += 1
        groups: Dict[tuple, List[_TenantLane]] = {}
        for lane in lanes:
            if lane.engine.cache.version != lane.version:
                # A mutation raced the collect window: the staged inputs
                # would still give the same decision, but serving past a
                # moved version is the index's race posture too. Solo,
                # counted, never wrong.
                self._dispatch_solo(lane)
            else:
                groups.setdefault(lane.group_key, []).append(lane)
        fused_this_round = 0
        for group in groups.values():
            cap = self.max_lanes if self.max_lanes > 0 else len(group)
            for i in range(0, len(group), cap):
                tranche = group[i:i + cap]
                if tranche[0].idx_slab is not None:
                    self._dispatch_index_group(tranche)
                else:
                    self._dispatch_group(tranche)
                fused_this_round += 1
        self.counters["tenant_groups_round_max"] = max(
            self.counters["tenant_groups_round_max"], fused_this_round)

    def _dispatch_solo(self, lane: _TenantLane) -> None:
        from ..engine.scheduler import _count_launches

        eng, inf = lane.engine, lane.inf
        self.counters["tenant_races"] += 1
        self.counters["tenant_solo_fallbacks"] += 1
        eng._sup_count("tenant_races")
        eng._sup_count("tenant_solo_fallbacks")
        decision = _count_launches(inf, eng._step, lane.eb, lane.nf,
                                   lane.af, lane.key, has_gang=False,
                                   hard_spread=False)
        eng._sup_count("steps_dispatched")
        inf.decision = decision
        inf.packed_dev = eng._pack(decision)
        inf.scored_rows += (int(lane.eb.pf.valid.shape[0])
                            * int(lane.nf.valid.shape[0]))
        inf.tenant_ticket = None

    def _dispatch_group(self, group: List[_TenantLane]) -> None:
        from ..engine.scheduler import _count_launches
        from ..ops.pipeline import build_tenant_step

        eng0 = group[0].engine
        fused_fn = build_tenant_step(eng0.plugin_set,
                                     shortlist=eng0._shortlist_k)
        # The group's launches are booked on its first lane's batch, so
        # the engines' kernel_launches sum to the process's.
        packed_stack, free_stack = _count_launches(
            group[0].inf, fused_fn, [ln.eb for ln in group],
            [ln.nf for ln in group], [ln.af for ln in group],
            [ln.key for ln in group], np.stack([ln.w_vec for ln in group]))
        self.counters["tenant_dispatches"] += 1
        self.counters["tenant_groups"] += 1
        self.counters["tenant_lanes_fused"] += len(group)
        buf = np.array(packed_stack.cpu().numpy())  # ONE fetch, writable
        self.counters["tenant_fetches"] += 1
        self.counters["tenant_fetch_bytes"] += buf.nbytes
        for i, lane in enumerate(group):
            b = buf[i]
            # The engine's i32 unpack order (unpack_decision_i32): rows
            # chosen, assigned, gang_rejected, feasible, feasible_static,
            # repaired, rejects...
            lane.inf.packed_dev = (
                b[0], b[1].astype(bool), b[2].astype(bool),
                b[3], b[4], b[6:], b[5].astype(bool))
            lane.inf.index_free_after = free_stack[i]
            lane.inf.scored_rows += (int(lane.eb.pf.valid.shape[0])
                                     * int(lane.nf.valid.shape[0]))
            lane.inf.tenant_ticket = None
            lane.engine._sup_count("tenant_fused_lanes")

    def _dispatch_index_group(self, group: List[_TenantLane]) -> None:
        """ONE fused INDEXED dispatch: each lane's class rows gathered
        from its own repaired (C,N) slab into one (T,P,N) buffer, one
        selection and one scan launch (ops/pipeline.
        build_tenant_index_step), no plugin evaluation, one (T,·) fetch.
        Each lane's row lands on ``inf.index_packed_dev`` as a host
        array, which the engine's resolve settles through the same
        _settle_index ladder as a solo indexed batch."""
        from ..engine.scheduler import _count_launches
        from ..faults import FAULTS
        from ..ops.index import corrupt_slab
        from ..ops.pipeline import build_tenant_index_step

        fused_fn = build_tenant_index_step(int(group[0].idx_k))
        slabs = [ln.idx_slab for ln in group]
        # Fault gate: the fused indexed dispatch seam. ``corrupt``
        # scribbles a COPY of lane 0's slab (ops/index.corrupt_slab, the
        # solo index gate's scheme): range-sane, accepted by the scan's
        # certificate, caught only by that lane's index_check_every
        # cross-check. The maintained slab itself stays intact.
        if FAULTS.hit("tenant_index") == "corrupt":
            slabs[0] = corrupt_slab(slabs[0],
                                    int(group[0].nf.valid.shape[0]))
        packed_stack, free_after = _count_launches(
            group[0].inf, fused_fn, slabs, [ln.idx_cls for ln in group],
            [ln.eb.pf.valid for ln in group],
            [ln.eb.pf.requests for ln in group],
            [ln.nf.free for ln in group], [ln.key for ln in group])
        self.counters["tenant_dispatches"] += 1
        self.counters["tenant_groups"] += 1
        self.counters["tenant_lanes_fused"] += len(group)
        self.counters["tenant_index_dispatches"] += 1
        self.counters["tenant_index_lanes"] += len(group)
        buf = np.array(packed_stack.cpu().numpy())  # ONE (T,·) fetch
        self.counters["tenant_fetches"] += 1
        self.counters["tenant_fetch_bytes"] += buf.nbytes
        for i, lane in enumerate(group):
            lane.inf.index_packed_dev = buf[i]
            lane.inf.index_free_after = free_after[i]
            lane.inf.tenant_ticket = None
            lane.engine._sup_count("tenant_fused_lanes")
            lane.engine._sup_count("tenant_index_lanes")

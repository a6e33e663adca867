"""Feature encoding: cluster objects → dense matrices for the XLA step.

The reference evaluates plugins over Go structs one (pod, node) pair at a
time (reference minisched/minisched.go:124-137,167-185). Here pods and nodes
are encoded once into fixed-width numeric arrays so every plugin becomes a
vectorized (P × N) computation:

  * resources → f32 vectors over the RESOURCES axis (cpu milli, mem bytes, …)
  * label selectors / affinity / taints / tolerations → 32-bit string hashes
    (crc32) compared as ints; 0 is the empty-slot sentinel.  SURVEY §7 "hard
    parts" flags collision risk at 50k-node scale: crc32 over the typically
    small label vocabulary makes false matches vanishingly rare, and the
    encoding keeps per-expression slots so semantics stay exact otherwise.
  * arbitrary-length lists (labels, taints, ports, …) → fixed slot counts
    from EncodingConfig, padded with the sentinel; overflow is reported so
    callers can widen the config rather than silently mis-schedule.

All arrays are plain numpy on the host; the scheduler pads them to bucketed
shapes before shipping to the device (avoids per-batch recompilation —
SURVEY §7 "dynamic shapes").
"""
from __future__ import annotations

import functools
import threading
import zlib
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from ..state import objects as obj
from ..state.objects import RESOURCES, Node, Pod

NUM_RESOURCES = len(RESOURCES)

# Upstream NodePreferAvoidPods reads this node annotation (the rebuild
# checks presence; upstream also matches the pod's controller ref).
PREFER_AVOID_PODS_ANNOTATION = "scheduler.alpha.kubernetes.io/preferAvoidPods"

# Taint-effect codes.
EFFECT_NONE = 0
EFFECT_NO_SCHEDULE = 1
EFFECT_PREFER_NO_SCHEDULE = 2
EFFECT_NO_EXECUTE = 3
_EFFECT_CODE = {"NoSchedule": EFFECT_NO_SCHEDULE,
                "PreferNoSchedule": EFFECT_PREFER_NO_SCHEDULE,
                "NoExecute": EFFECT_NO_EXECUTE}

# Node-selector-requirement operator codes.
OP_NONE = 0
OP_IN = 1
OP_NOT_IN = 2
OP_EXISTS = 3
OP_DOES_NOT_EXIST = 4
_OP_CODE = {"In": OP_IN, "NotIn": OP_NOT_IN, "Exists": OP_EXISTS,
            "DoesNotExist": OP_DOES_NOT_EXIST}

# Toleration operator codes.
TOL_NONE = 0
TOL_EQUAL = 1
TOL_EXISTS = 2


@dataclass(frozen=True)
class EncodingConfig:
    """Slot widths for variable-length fields. Widen for exotic clusters."""

    max_labels: int = 8         # label (key,value) pairs per node
    max_taints: int = 4         # taints per node
    max_tolerations: int = 4    # tolerations per pod
    max_selector_pairs: int = 4  # pod.spec.node_selector entries
    max_affinity_terms: int = 2  # ORed NodeSelectorTerms (required affinity)
    max_exprs_per_term: int = 4  # ANDed expressions per term
    max_values_per_expr: int = 4  # values per In/NotIn expression
    max_preferred_terms: int = 2  # preferred node-affinity terms
    max_ports: int = 8          # host ports in use per node
    max_pod_ports: int = 4      # host ports requested per pod
    max_images: int = 4         # images per node / per pod
    # topology-aware plugins (PodTopologySpread / InterPodAffinity)
    max_topology_keys: int = 4   # registered topology keys (slot 0=hostname)
    max_spread_constraints: int = 2  # constraints per pod
    max_pod_affinity_terms: int = 2  # terms per pod per kind (req/pref × aff/anti)
    max_term_selector_pairs: int = 4  # match_labels pairs per term selector
    domain_buckets: int = 4096   # hashed domain space for non-hostname keys
    max_pod_claims: int = 4      # PVC references per pod (volume plugins)
    # forbidden (topology key, domain) slots per pod: domains occupied by a
    # RUNNING pod whose required anti-affinity term matches this pod
    # (upstream existing-pod anti-affinity symmetry)
    max_anti_forbid: int = 4


# Spread when_unsatisfiable codes.
SPREAD_NONE = 0
SPREAD_DO_NOT_SCHEDULE = 1
SPREAD_SCHEDULE_ANYWAY = 2

HOSTNAME_KEY = "kubernetes.io/hostname"


DEFAULT_ENCODING = EncodingConfig()


@functools.lru_cache(maxsize=1 << 16)
def _h(s: str) -> int:
    """Deterministic 32-bit string hash, never the 0 sentinel. Memoized:
    label keys/values repeat massively across a cluster (50k nodes share a
    handful of zone labels), so encoding cost is dominated by dictionary
    hits, not crc32 + encode."""
    v = zlib.crc32(s.encode()) & 0xFFFFFFFF
    v = v if v != 0 else 1
    # map to int32 range
    return v - (1 << 32) if v >= (1 << 31) else v


@functools.lru_cache(maxsize=1 << 16)
def pair_hash(key: str, value: str) -> int:
    return _h(f"{key}={value}")


# Synthetic pair hash carrying a pod's CONTROLLER owner identity
# (SelectorSpread): bind accounting appends it to the assigned corpus's
# label rows, and encode_pods (selector_spread=True) registers owner
# selector groups over the same pair — so owner-population counting
# rides the existing selector-group match/count machinery
# (ops/topology.py) unchanged. The hash input is NUL-separated, which no
# real label pair can produce through pair_hash's "key=value" form
# (labels cannot contain NUL), so a user label can never forge an owner
# pair at the string level — residual 32-bit hash collisions remain, the
# same class every hashed-pair match in the encoder accepts.
_OWNER_SPREAD_TAG = "minisched.io/owner\x00"

# Zone topology key for SelectorSpread's zone-weighted term (the same
# well-known key VolumeZone / the engine use).
SELECTOR_SPREAD_ZONE_KEY = "topology.kubernetes.io/zone"


def owner_spread_pair(meta) -> int:
    """Hashed synthetic pair for the pod's controller owner identity, or
    0 when the pod has no controller ownerReference."""
    owner = obj.controller_owner(meta)
    if owner is None:
        return 0
    return _h(f"{_OWNER_SPREAD_TAG}{owner.kind}/{owner.name}")


def key_hash(key: str) -> int:
    return _h(key)


def name_suffix_digit(name: str) -> int:
    """Trailing decimal suffix of a name, -1 if none (reference
    minisched/plugins/score/nodenumber/nodenumber.go:50-64 uses the LAST
    character only; we keep that exact semantic: last char digit or -1)."""
    if name and name[-1].isdigit():
        return int(name[-1])
    return -1


def resources_vector(rl: obj.ResourceList) -> np.ndarray:
    v = np.zeros(NUM_RESOURCES, dtype=np.float32)
    for name, qty in rl.items():
        idx = obj.RESOURCE_INDEX.get(name)
        if idx is not None:
            v[idx] = float(qty)
    return v


class TopologyKeyRegistry:
    """Stable string→index registry for topology keys referenced by spread
    constraints and pod-affinity terms. Slot 0 is always
    kubernetes.io/hostname (its domains are node rows). The registry is
    shared between node and pod encoding so domain tables and constraint
    indices agree; growing it bumps ``version`` so caches can refresh."""

    def __init__(self, cfg: EncodingConfig = DEFAULT_ENCODING):
        self.max = cfg.max_topology_keys
        self._keys = [HOSTNAME_KEY]
        self._idx = {HOSTNAME_KEY: 0}
        self.version = 1
        # The registry is reached from both the informer thread
        # (cache.account_bind → _anti_sigs) and the scheduling thread
        # (encode_pods / GroupBuilder); the two-step insert below must not
        # interleave or a key is permanently mapped to the wrong slot.
        self._lock = threading.Lock()

    def index_of(self, key: str, overflow: Optional[List[str]] = None) -> int:
        with self._lock:
            idx = self._idx.get(key)
            if idx is not None:
                return idx
            if len(self._keys) >= self.max:
                if overflow is not None:
                    overflow.append(
                        f"topology key registry full ({self.max}); "
                        f"cannot register {key!r}")
                return -1
            idx = len(self._keys)
            self._idx[key] = idx
            self._keys.append(key)
            self.version += 1
            return idx

    def keys(self) -> List[str]:
        with self._lock:
            return list(self._keys)


class NodeFeatures(NamedTuple):
    """Dense per-node features, shape leading dim N (padded)."""

    valid: np.ndarray          # (N,) bool — padding / tombstone mask
    unschedulable: np.ndarray  # (N,) bool
    allocatable: np.ndarray    # (N,R) f32
    free: np.ndarray           # (N,R) f32 — allocatable minus bound requests
    name_suffix: np.ndarray    # (N,) i32
    name_hash: np.ndarray      # (N,) i32 hash(node name)
    label_pairs: np.ndarray    # (N,L) i32 hash(key=value)
    label_keys: np.ndarray     # (N,L) i32 hash(key)
    taint_pairs: np.ndarray    # (N,T) i32
    taint_keys: np.ndarray     # (N,T) i32
    taint_effects: np.ndarray  # (N,T) i32
    used_ports: np.ndarray     # (N,PORT) i32
    images: np.ndarray         # (N,IM) i32
    # scheduler.alpha.kubernetes.io/preferAvoidPods annotation present
    # (NodePreferAvoidPods score input)
    avoid_pods: np.ndarray     # (N,) bool
    # topology domains: row k = this node's domain id under registered
    # topology key k (-1 = key absent). Slot 0 is kubernetes.io/hostname,
    # whose domain id is the node's own row; other keys hash their label
    # value into EncodingConfig.domain_buckets.
    topo_domains: np.ndarray   # (K,N) i32


class DynDelta(NamedTuple):
    """Sparse host-truth correction for the DYNAMIC NodeFeatures leaves
    (``free`` / ``used_ports`` — NodeFeatureCache.DYNAMIC_NF_FIELDS),
    produced by the cache's versioned elision protocol
    (NodeFeatureCache.snapshot_resident) for a consumer that keeps those
    leaves loop-carried on device: only the rows the cache mutated since
    the consumer's last collection, with their current authoritative
    values. ``epoch`` is the cache-side divergence counter — the
    consumer must hold device state at exactly ``epoch - 1`` to apply
    the delta; any mismatch means full re-upload (resync)."""

    epoch: int
    rows: np.ndarray        # (K,) i32 node rows mutated since last collect
    free: np.ndarray        # (K,R) f32 authoritative free rows
    used_ports: np.ndarray  # (K,PORT) i32 authoritative port rows


class AssignedPodFeatures(NamedTuple):
    """Dense features of pods already bound to nodes — the corpus that
    topology-spread / inter-pod-affinity counts are computed against
    (leading dim A, padded)."""

    valid: np.ndarray        # (A,) bool
    node_row: np.ndarray     # (A,) i32 row of the node the pod is bound to
    ns_hash: np.ndarray      # (A,) i32 hash(namespace)
    label_pairs: np.ndarray  # (A,L) i32 hash(key=value) of the pod's labels
    # Preemption inputs (upstream DefaultPreemption victim math): what a
    # victim's eviction would release, and the priority bar it sits under.
    requests: np.ndarray     # (A,R) f32 accounted requests
    priority: np.ndarray     # (A,) i32


class PodFeatures(NamedTuple):
    """Dense per-pod features, shape leading dim P (padded).

    Node-selector / node-affinity constraints live in NodeAffinityGroups
    (na_group column) and topology constraints in GroupFeatures — per-pod
    dense matching would cost O(P×N×…) at 50k nodes; pods sharing a
    deployment share constraint signatures, so matching runs per GROUP."""

    valid: np.ndarray        # (P,) bool
    requests: np.ndarray     # (P,R) f32 (includes the implicit pods:1 slot)
    name_suffix: np.ndarray  # (P,) i32
    priority: np.ndarray     # (P,) i32
    # The pod's OWN namespace hash + label pair hashes — lets the device
    # evaluate "does batch pod i match selector group g" (the in-scan
    # spread-cap membership updates, ops/spreadcap.py) exactly like
    # group_assigned_match does for the running corpus.
    ns_hash: np.ndarray      # (P,) i32
    label_pairs: np.ndarray  # (P,L) i32 hash(key=value)
    na_group: np.ndarray     # (P,) i32 node-affinity group, -1 = unconstrained
    tol_pairs: np.ndarray    # (P,K) i32
    tol_keys: np.ndarray     # (P,K) i32
    tol_ops: np.ndarray      # (P,K) i32
    tol_effects: np.ndarray  # (P,K) i32
    ports: np.ndarray        # (P,PP) i32 host ports requested
    images: np.ndarray       # (P,IM) i32
    required_node: np.ndarray  # (P,) i32 hash of spec.required_node_name (0=none)
    # Pod is controlled by a ReplicationController/ReplicaSet (a
    # controller ownerReference of those kinds) — the scope upstream's
    # NodePreferAvoidPods applies avoidance to.
    rc_owned: np.ndarray       # (P,) bool
    volumes_ready: np.ndarray  # (P,) bool — all referenced PVCs are bound
    # claim_rows[c] = node row the pod's c-th claim is currently mounted on
    # (-1 = unused/unrestricted). VolumeRestrictions' RWO exclusivity.
    claim_rows: np.ndarray     # (P,CV) i32
    # claim_typed[c] — the c-th claim is cloud-typed (charged on its
    # per-cloud axis, objects.CLOUD_VOLUME_AXES), so generic attach-slot
    # logic (NodeVolumeLimits pinned-extra) must skip it.
    claim_typed: np.ndarray    # (P,CV) bool
    # VolumeZone: required (topology key slot, domain id) from the pod's
    # bound PVs' zone labels; -1 = no zone requirement.
    zone_key: np.ndarray       # (P,) i32
    zone_dom: np.ndarray       # (P,) i32
    # Topology-aware constraints reference SELECTOR GROUPS (GroupFeatures):
    # pods in a batch share few distinct (topology key, namespace, selector)
    # combinations — one deployment's replicas all carry the same constraint
    # — so per-group match/count tensors replace per-pod ones (the key to
    # making spread/affinity MXU- and memory-friendly at 50k nodes).
    spread_group: np.ndarray     # (P,C) i32 group index, -1 = unused slot
    spread_max_skew: np.ndarray  # (P,C) i32
    spread_mode: np.ndarray      # (P,C) i32 SPREAD_* code
    # SelectorSpread owner groups (encoded only when the profile enables
    # the plugin — encode_pods(selector_spread=True)): selector groups
    # over the pod's controller-owner pair (owner_spread_pair), slot 0
    # under kubernetes.io/hostname, slot 1 under the zone key. -1 = no
    # controller owner / zone key unavailable. Score-only (upstream
    # SelectorSpread has no filter point), so these groups never enter
    # the hard-spread arbitration.
    selspread_group: np.ndarray  # (P,2) i32
    aff_req_group: np.ndarray    # (P,T) i32 required pod-affinity terms
    aff_req_self: np.ndarray     # (P,T) bool — the pod itself matches the
    #   term's selector+namespace (upstream: a required affinity term with
    #   NO matching pod anywhere is satisfied if the incoming pod matches
    #   its own term — else the first replica of a self-affine workload
    #   could never schedule)
    aff_pref_group: np.ndarray   # (P,T) i32 preferred pod-affinity terms
    aff_pref_weight: np.ndarray  # (P,T) f32
    anti_req_group: np.ndarray   # (P,T) i32 required anti-affinity terms
    anti_pref_group: np.ndarray  # (P,T) i32 preferred anti-affinity terms
    anti_pref_weight: np.ndarray  # (P,T) f32
    # Symmetric existing-pod anti-affinity (upstream parity): domains this
    # pod must avoid because a RUNNING pod's required anti term matches it.
    anti_forbid_key: np.ndarray  # (P,S) i32 topology-key idx, -1 unused
    anti_forbid_dom: np.ndarray  # (P,S) i32 domain id under that key
    # Preemption curability of the slot (ops/preempt.py): the single node
    # row holding ALL owners of the forbidding term(s), -1 when owners
    # span nodes (then no node-local eviction can cure it), and the max
    # owner priority (a preemptor must outrank every owner to evict).
    anti_forbid_row: np.ndarray     # (P,S) i32
    anti_forbid_maxpri: np.ndarray  # (P,S) i32
    # Symmetric existing-pod terms (upstream InterPodAffinity scoring):
    # rows of the batch's SymTerms table whose bound pods' terms this pod
    # matches, one slot per topology key, -1 unused. The width is the
    # most slots any pod of the batch uses (0 when none matches).
    sym_slot: np.ndarray            # (P,S') i32


class GroupFeatures(NamedTuple):
    """Distinct (topology key, namespace, label selector) tuples referenced
    by a batch's spread constraints and pod-(anti-)affinity terms (leading
    dim G, padded)."""

    valid: np.ndarray      # (G,) bool
    key_idx: np.ndarray    # (G,) i32 topology-key registry index
    ns_hash: np.ndarray    # (G,) i32 namespace restriction (0 = any)
    sel_pairs: np.ndarray  # (G,QT) i32 ANDed selector pair hashes (all-zero
    #                        with valid=True means match-all, upstream empty
    #                        selector semantics)


class NodeAffinityGroups(NamedTuple):
    """Distinct (node_selector, required affinity, preferred affinity)
    signatures in a batch (leading dim G2, padded). Matching runs per group
    over nodes, then pods gather their group's row."""

    valid: np.ndarray        # (G2,) bool
    sel_pairs: np.ndarray    # (G2,Q) i32 node_selector ANDed pair hashes
    req_has: np.ndarray      # (G2,) bool — group has required affinity terms
    req_op: np.ndarray       # (G2,T,E) i32
    req_key: np.ndarray      # (G2,T,E) i32
    req_vals: np.ndarray     # (G2,T,E,V) i32
    pref_weight: np.ndarray  # (G2,T2) f32
    pref_op: np.ndarray      # (G2,T2,E) i32
    pref_key: np.ndarray     # (G2,T2,E) i32
    pref_vals: np.ndarray    # (G2,T2,E,V) i32


class GangFeatures(NamedTuple):
    """Gang (coscheduling) groups in a batch (leading dim GG, padded).
    Pods sharing a gang key (objects.gang_key — namespace-scoped) are
    assigned all-or-nothing by ops.gang.gang_assign (BASELINE config 5; no
    reference analog). Padding rows are inert via min_count == 0."""

    group: np.ndarray      # (P,) i32 gang id, -1 = ungrouped
    min_count: np.ndarray  # (GG,) i32 quorum (0 on padding rows)


class SymTerms(NamedTuple):
    """The bound pods' (anti-)affinity terms that a batch's pods match
    (upstream InterPodAffinity's existing-pod scoring), one row per
    distinct (topology key, set of matching term groups) among the
    batch's pods (leading dim T): the summed signed weight of those
    terms' owners in each domain of the key. A pod's ``sym_slot`` names
    its rows; the step gathers each row per node (ops/topology.
    sym_node_rows) into the InterPodAffinity score."""

    key_idx: np.ndarray    # (T,) i32 topology-key registry index
    dom_w: np.ndarray      # (T,W) f32 weight per domain id (W covers
    #                        every hostname row and the hashed buckets)


class EncodedBatch(NamedTuple):
    """Everything encode_pods produces for one scheduling batch."""

    pf: "PodFeatures"
    gf: "GroupFeatures"        # topology-constraint selector groups
    naf: "NodeAffinityGroups"  # node-affinity signature groups
    gang: "GangFeatures"       # gang/coscheduling groups
    # The symmetric term table, None when no pod of the batch matches a
    # bound pod's term (then nothing is uploaded or launched for it).
    sym: Optional["SymTerms"] = None


def empty_node_features(n: int, cfg: EncodingConfig = DEFAULT_ENCODING) -> NodeFeatures:
    return NodeFeatures(
        valid=np.zeros(n, dtype=bool),
        unschedulable=np.zeros(n, dtype=bool),
        allocatable=np.zeros((n, NUM_RESOURCES), dtype=np.float32),
        free=np.zeros((n, NUM_RESOURCES), dtype=np.float32),
        name_suffix=np.full(n, -1, dtype=np.int32),
        name_hash=np.zeros(n, dtype=np.int32),
        label_pairs=np.zeros((n, cfg.max_labels), dtype=np.int32),
        label_keys=np.zeros((n, cfg.max_labels), dtype=np.int32),
        taint_pairs=np.zeros((n, cfg.max_taints), dtype=np.int32),
        taint_keys=np.zeros((n, cfg.max_taints), dtype=np.int32),
        taint_effects=np.zeros((n, cfg.max_taints), dtype=np.int32),
        used_ports=np.zeros((n, cfg.max_ports), dtype=np.int32),
        images=np.zeros((n, cfg.max_images), dtype=np.int32),
        avoid_pods=np.zeros(n, dtype=bool),
        topo_domains=np.full((cfg.max_topology_keys, n), -1, dtype=np.int32),
    )


def empty_assigned_features(a: int, cfg: EncodingConfig = DEFAULT_ENCODING
                            ) -> AssignedPodFeatures:
    return AssignedPodFeatures(
        valid=np.zeros(a, dtype=bool),
        node_row=np.zeros(a, dtype=np.int32),
        ns_hash=np.zeros(a, dtype=np.int32),
        label_pairs=np.zeros((a, cfg.max_labels), dtype=np.int32),
        requests=np.zeros((a, NUM_RESOURCES), dtype=np.float32),
        priority=np.zeros(a, dtype=np.int32),
    )


def compute_topo_domains_row(feats: NodeFeatures, i: int,
                             registry: TopologyKeyRegistry,
                             cfg: EncodingConfig = DEFAULT_ENCODING,
                             keys: Optional[List[str]] = None) -> None:
    """Fill topo_domains[:, i] for one node row from its label slots.
    ``keys`` lets a bulk refresh snapshot registry.keys() once instead of
    taking the registry lock and copying the list per node row."""
    feats.topo_domains[:, i] = -1
    if not feats.valid[i]:
        return
    for k, key in enumerate(registry.keys() if keys is None else keys):
        if k == 0:  # hostname: every node is its own domain
            feats.topo_domains[0, i] = i
            continue
        kh = key_hash(key)
        for l in range(cfg.max_labels):
            if feats.label_keys[i, l] == kh:
                feats.topo_domains[k, i] = (
                    int(feats.label_pairs[i, l]) % cfg.domain_buckets)
                break


def _fill_slots(dst: np.ndarray, values: List[int], what: str,
                overflow: Optional[List[str]] = None) -> None:
    k = min(len(values), dst.shape[0])
    if len(values) > dst.shape[0] and overflow is not None:
        overflow.append(f"{what}: {len(values)} > {dst.shape[0]} slots")
    dst[:k] = values[:k]


def encode_node_into(feats: NodeFeatures, i: int, node: Node,
                     overflow: Optional[List[str]] = None) -> None:
    """Write node's features into row ``i`` of pre-allocated arrays."""
    cfg_labels = feats.label_pairs.shape[1]
    feats.valid[i] = True
    feats.unschedulable[i] = node.spec.unschedulable
    feats.allocatable[i] = resources_vector(node.status.allocatable)
    # Undeclared attach limits → the standard default ceilings, so the
    # volume axes always have real capacity semantics. An EXPLICIT 0 is
    # honored (a node that cannot attach volumes at all).
    if "attachable-volumes" not in node.status.allocatable:
        feats.allocatable[i, obj.RESOURCE_INDEX["attachable-volumes"]] = \
            obj.DEFAULT_ATTACHABLE_VOLUMES
    for axis, limit in obj.DEFAULT_CLOUD_VOLUME_LIMITS.items():
        if axis not in node.status.allocatable:
            feats.allocatable[i, obj.RESOURCE_INDEX[axis]] = limit
    feats.name_suffix[i] = name_suffix_digit(node.metadata.name)
    feats.name_hash[i] = _h(node.metadata.name)
    feats.avoid_pods[i] = PREFER_AVOID_PODS_ANNOTATION in \
        node.metadata.annotations

    labels = list(node.metadata.labels.items())
    if len(labels) > cfg_labels and overflow is not None:
        overflow.append(f"node {node.key} labels: {len(labels)} > {cfg_labels}")
    feats.label_pairs[i] = 0
    feats.label_keys[i] = 0
    for j, (k, v) in enumerate(labels[:cfg_labels]):
        feats.label_pairs[i, j] = pair_hash(k, v)
        feats.label_keys[i, j] = key_hash(k)

    feats.taint_pairs[i] = 0
    feats.taint_keys[i] = 0
    feats.taint_effects[i] = EFFECT_NONE
    taints = node.spec.taints
    if len(taints) > feats.taint_pairs.shape[1] and overflow is not None:
        overflow.append(f"node {node.key} taints overflow")
    for j, t in enumerate(taints[:feats.taint_pairs.shape[1]]):
        feats.taint_pairs[i, j] = pair_hash(t.key, t.value)
        feats.taint_keys[i, j] = key_hash(t.key)
        feats.taint_effects[i, j] = _EFFECT_CODE.get(t.effect, EFFECT_NO_SCHEDULE)

    feats.images[i] = 0
    _fill_slots(feats.images[i], [_h(im) for im in node.status.images],
                f"node {node.key} images", overflow)


def clear_node_row(feats: NodeFeatures, i: int) -> None:
    feats.valid[i] = False
    feats.unschedulable[i] = False
    feats.allocatable[i] = 0
    feats.free[i] = 0
    feats.name_suffix[i] = -1
    feats.name_hash[i] = 0
    feats.label_pairs[i] = 0
    feats.label_keys[i] = 0
    feats.taint_pairs[i] = 0
    feats.taint_keys[i] = 0
    feats.taint_effects[i] = EFFECT_NONE
    feats.used_ports[i] = 0
    feats.images[i] = 0
    feats.topo_domains[:, i] = -1


def _encode_term_exprs(op_row, key_row, val_row, exprs, overflow, what):
    """Encode ANDed NodeSelectorRequirements into one term's slots."""
    e_max, v_max = val_row.shape
    if len(exprs) > e_max and overflow is not None:
        overflow.append(f"{what}: {len(exprs)} exprs > {e_max} slots")
    for e, req in enumerate(exprs[:e_max]):
        code = _OP_CODE.get(req.operator)
        if code is None:
            # Gt/Lt not representable densely; treat as unsupported and
            # record so the caller can fall back (SURVEY hard-parts note).
            if overflow is not None:
                overflow.append(f"{what}: unsupported operator {req.operator}")
            continue
        op_row[e] = code
        key_row[e] = key_hash(req.key)
        vals = [pair_hash(req.key, v) for v in req.values]
        if len(vals) > v_max and overflow is not None:
            overflow.append(f"{what}: {len(vals)} values > {v_max} slots")
        val_row[e, :min(len(vals), v_max)] = vals[:v_max]


class GroupBuilder:
    """Dedupes (topology key index, namespace hash, selector pairs) tuples
    into stable group ids for one batch."""

    def __init__(self, cfg: EncodingConfig = DEFAULT_ENCODING):
        self.cfg = cfg
        self._groups: Dict[tuple, int] = {}
        # Batch-scoped identity memo: a deployment's replicas SHARE their
        # LabelSelector object, so re-hashing + re-sorting its pairs per
        # pod is pure waste (~0.1 s of a 10k-pod config-4 encode). Keyed
        # by object id — safe because the builder lives for ONE
        # encode_pods call and the selector objects are pinned alive by
        # the pods list; stores the weakened flag so replays see the
        # exact original verdict (overflow diagnostics are recorded once
        # per distinct selector object, a dedup).
        self._by_obj: Dict[tuple, tuple] = {}
        # Set by group_of when the returned group's selector was WEAKENED
        # (match_expressions dropped or selector pairs truncated) — the
        # group matches a superset of the real constraint. Callers
        # encoding a HARD constraint must then fail the pod closed.
        self.last_weakened = False

    def group_of(self, key_idx: int, ns_hash: int, selector,
                 overflow: Optional[List[str]], what: str) -> int:
        self.last_weakened = False
        if key_idx < 0:
            return -1
        obj_key = None
        if selector is not None:
            obj_key = (key_idx, ns_hash, id(selector))
            hit = self._by_obj.get(obj_key)
            if hit is not None:
                gid, self.last_weakened = hit
                return gid
        pairs: Tuple[int, ...] = ()
        if selector is not None:
            if selector.match_expressions:
                if overflow is not None:
                    overflow.append(
                        f"{what}: match_expressions in term selector "
                        "unsupported")
                self.last_weakened = True
            raw = sorted(pair_hash(k, v)
                         for k, v in selector.match_labels.items())
            if len(raw) > self.cfg.max_term_selector_pairs:
                if overflow is not None:
                    overflow.append(f"{what}: selector pairs overflow")
                raw = raw[: self.cfg.max_term_selector_pairs]
                self.last_weakened = True
            pairs = tuple(raw)
        sig = (key_idx, ns_hash, pairs)
        gid = self._groups.get(sig)
        if gid is None:
            gid = len(self._groups)
            self._groups[sig] = gid
        if obj_key is not None:
            self._by_obj[obj_key] = (gid, self.last_weakened)
        return gid

    def group_of_pairs(self, key_idx: int, ns_hash: int,
                       pairs: Tuple[int, ...]) -> int:
        """Group id for an already-hashed selector-pair tuple (the
        SelectorSpread owner pair) — same dedup space as group_of, so an
        owner group and a label-selector group with identical signatures
        correctly share one id."""
        if key_idx < 0:
            return -1
        sig = (key_idx, ns_hash, tuple(pairs))
        gid = self._groups.get(sig)
        if gid is None:
            gid = len(self._groups)
            self._groups[sig] = gid
        return gid

    def build(self, pad: Optional[int] = None) -> GroupFeatures:
        n = len(self._groups)
        target = pad if pad is not None else max(8, _next_pow2(n))
        if n > target:
            raise ValueError(f"{n} groups > pad {target}")
        gf = GroupFeatures(
            valid=np.zeros(target, dtype=bool),
            key_idx=np.zeros(target, dtype=np.int32),
            ns_hash=np.zeros(target, dtype=np.int32),
            sel_pairs=np.zeros((target, self.cfg.max_term_selector_pairs),
                               dtype=np.int32))
        for (key_idx, ns_hash, pairs), gid in self._groups.items():
            gf.valid[gid] = True
            gf.key_idx[gid] = key_idx
            gf.ns_hash[gid] = ns_hash
            gf.sel_pairs[gid, :len(pairs)] = pairs
        return gf


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def _term_signature(term: "obj.NodeSelectorTerm") -> tuple:
    return tuple(sorted(
        (r.key, r.operator, tuple(sorted(r.values)))
        for r in term.match_expressions))


class NodeAffinityBuilder:
    """Dedupes (node_selector, required/preferred node affinity) signatures
    into NodeAffinityGroups rows."""

    def __init__(self, cfg: EncodingConfig = DEFAULT_ENCODING):
        self.cfg = cfg
        self._sigs: Dict[tuple, int] = {}
        self._payloads: List[tuple] = []  # (selector_items, na)

    def group_of(self, pod: Pod) -> int:
        na = pod.spec.affinity.node_affinity if pod.spec.affinity else None
        sel = tuple(sorted(pod.spec.node_selector.items()))
        if not sel and na is None:
            return -1
        req = (tuple(_term_signature(t) for t in na.required.node_selector_terms)
               if na and na.required else ())
        pref = (tuple((p.weight, _term_signature(p.preference))
                      for p in na.preferred) if na else ())
        if not sel and not req and not pref:
            return -1
        sig = (sel, req, pref)
        gid = self._sigs.get(sig)
        if gid is None:
            gid = len(self._payloads)
            self._sigs[sig] = gid
            self._payloads.append((sel, na))
        return gid

    def build(self, pad: Optional[int] = None,
              overflow: Optional[List[str]] = None) -> NodeAffinityGroups:
        cfg = self.cfg
        n = len(self._payloads)
        target = pad if pad is not None else max(8, _next_pow2(n))
        if n > target:
            raise ValueError(f"{n} node-affinity groups > pad {target}")
        g = NodeAffinityGroups(
            valid=np.zeros(target, dtype=bool),
            sel_pairs=np.zeros((target, cfg.max_selector_pairs), dtype=np.int32),
            req_has=np.zeros(target, dtype=bool),
            req_op=np.zeros((target, cfg.max_affinity_terms,
                             cfg.max_exprs_per_term), dtype=np.int32),
            req_key=np.zeros((target, cfg.max_affinity_terms,
                              cfg.max_exprs_per_term), dtype=np.int32),
            req_vals=np.zeros((target, cfg.max_affinity_terms,
                               cfg.max_exprs_per_term,
                               cfg.max_values_per_expr), dtype=np.int32),
            pref_weight=np.zeros((target, cfg.max_preferred_terms), dtype=np.float32),
            pref_op=np.zeros((target, cfg.max_preferred_terms,
                              cfg.max_exprs_per_term), dtype=np.int32),
            pref_key=np.zeros((target, cfg.max_preferred_terms,
                               cfg.max_exprs_per_term), dtype=np.int32),
            pref_vals=np.zeros((target, cfg.max_preferred_terms,
                                cfg.max_exprs_per_term,
                                cfg.max_values_per_expr), dtype=np.int32),
        )
        for gid, (sel, na) in enumerate(self._payloads):
            g.valid[gid] = True
            if len(sel) > cfg.max_selector_pairs and overflow is not None:
                overflow.append(f"na group {gid}: node_selector overflow")
            for j, (k, v) in enumerate(sel[:cfg.max_selector_pairs]):
                g.sel_pairs[gid, j] = pair_hash(k, v)
            if na and na.required and na.required.node_selector_terms:
                terms = na.required.node_selector_terms
                if len(terms) > cfg.max_affinity_terms and overflow is not None:
                    overflow.append(f"na group {gid}: affinity terms overflow")
                g.req_has[gid] = True
                for t, term in enumerate(terms[:cfg.max_affinity_terms]):
                    _encode_term_exprs(g.req_op[gid, t], g.req_key[gid, t],
                                       g.req_vals[gid, t],
                                       term.match_expressions, overflow,
                                       f"na group {gid} term {t}")
            if na and na.preferred:
                prefs = na.preferred
                if len(prefs) > cfg.max_preferred_terms and overflow is not None:
                    overflow.append(f"na group {gid}: preferred overflow")
                for t, pt in enumerate(prefs[:cfg.max_preferred_terms]):
                    g.pref_weight[gid, t] = float(pt.weight)
                    _encode_term_exprs(g.pref_op[gid, t], g.pref_key[gid, t],
                                       g.pref_vals[gid, t],
                                       pt.preference.match_expressions,
                                       overflow, f"na group {gid} pref {t}")
        return g


def _encode_pod_affinity_terms(i, terms, group_arr, weight_arr, builder,
                               registry, pod_ns_hash, overflow, what,
                               self_arr=None, pod_labels=None,
                               anti: bool = False) -> bool:
    """Encode PodAffinityTerm list (plain or weighted) into group slots.

    Returns True when a REQUIRED term (weight_arr is None) was weakened in
    the UNSAFE direction, so the caller can fail the pod closed rather
    than schedule it against a silently loosened hard constraint.
    Direction matters: an AFFINITY term admits placements, so any
    broadening (selector pairs truncated, match_expressions dropped) or
    whole-term loss is unsafe, while narrowing to namespaces[0] can only
    reject valid placements (safe). An ANTI term repels placements, so
    broadening the selector over-repels (safe) while narrowing it —
    multi-namespace truncation or losing the term entirely — under-repels
    (unsafe)."""
    T = group_arr.shape[1]
    hard_dropped = False
    if len(terms) > T:
        if overflow is not None:
            overflow.append(f"{what}: {len(terms)} terms > {T} slots")
        # Dropped whole terms loosen both affinity (ANDed requirements
        # lost) and anti (repels lost): unsafe either way.
        hard_dropped = weight_arr is None
    for t, term in enumerate(terms[:T]):
        if weight_arr is not None:
            weight, term = term.weight, term.term
        else:
            weight = None
        k_idx = registry.index_of(term.topology_key, overflow)
        if term.namespaces:
            if len(term.namespaces) > 1:
                if overflow is not None:
                    overflow.append(
                        f"{what}: multiple namespaces unsupported")
                if weight_arr is None and anti:  # anti under-repels ns[1:]
                    hard_dropped = True
            ns = _h(term.namespaces[0])
        else:
            ns = pod_ns_hash
        group_arr[i, t] = builder.group_of(k_idx, ns, term.label_selector,
                                           overflow, what)
        if weight_arr is None:
            if group_arr[i, t] < 0:
                hard_dropped = True  # term unenforced: unsafe either way
            elif builder.last_weakened and not anti:
                hard_dropped = True  # broadened affinity admits too much
        if weight is not None and group_arr[i, t] >= 0:
            weight_arr[i, t] = float(weight)
        if self_arr is not None and group_arr[i, t] >= 0:
            self_arr[i, t] = (ns == pod_ns_hash
                              and (term.label_selector is None
                                   or term.label_selector.matches(pod_labels or {})))
    return hard_dropped


def _make_pod_sig(owner_identity: bool = False):
    """Build a per-batch pod-signature function (see encode_pods): the
    signature covers every pod field the batch encoder reads, so two
    pods with equal signatures produce IDENTICAL feature rows and group
    registrations. Selector/term sub-signatures are memoized BY OBJECT
    IDENTITY for the batch's lifetime (deployments share selector
    objects; a fresh-but-equal selector just recomputes — the value
    tuples still compare equal). Pods with volumes return None (their
    encoding pulls per-pod external state). Unsorted dict-item tuples:
    a different insertion order changes slot order in the encoded row,
    so it must also miss the memo. The whole function is built for
    speed — it runs once per pod and must cost well under the ~15 µs
    encode body it can save."""
    sel_memo: Dict[int, tuple] = {}
    terms_memo: Dict[int, tuple] = {}

    def sel_sig(sel) -> tuple:
        if sel is None:
            return ()
        s = sel_memo.get(id(sel))
        if s is None:
            s = sel_memo[id(sel)] = (
                tuple(sel.match_labels.items()),
                tuple((r.key, r.operator, tuple(r.values))
                      for r in sel.match_expressions)
                if sel.match_expressions else ())
        return s

    def terms_sig(terms, weighted: bool) -> tuple:
        if not terms:
            return ()
        key = id(terms)
        s = terms_memo.get(key)
        if s is None:
            if weighted:
                s = tuple((w.weight, w.term.topology_key,
                           tuple(w.term.namespaces) if w.term.namespaces
                           else (), sel_sig(w.term.label_selector))
                          for w in terms)
            else:
                s = tuple((t.topology_key,
                           tuple(t.namespaces) if t.namespaces else (),
                           sel_sig(t.label_selector)) for t in terms)
            terms_memo[key] = s
        return s

    def pod_sig(pod: Pod) -> Optional[tuple]:
        spec = pod.spec
        if spec.volumes:
            return None
        aff = spec.affinity
        if aff is None:
            aff_sig = ()
        else:
            na = aff.node_affinity
            na_sig = () if na is None else (
                tuple(_term_signature(t)
                      for t in na.required.node_selector_terms)
                if na.required else (),
                tuple((p.weight, _term_signature(p.preference))
                      for p in na.preferred) if na.preferred else ())
            pa = aff.pod_affinity
            pa_sig = () if pa is None else (
                terms_sig(pa.required, False),
                terms_sig(pa.preferred, True))
            anti = aff.pod_anti_affinity
            anti_sig = () if anti is None else (
                terms_sig(anti.required, False),
                terms_sig(anti.preferred, True))
            aff_sig = (na_sig, pa_sig, anti_sig)
        cons = spec.topology_spread_constraints
        return (
            pod.metadata.namespace,
            tuple(spec.requests.items()),
            tuple(pod.metadata.labels.items()),
            spec.priority,
            tuple((t.key, t.operator, t.value, t.effect)
                  for t in spec.tolerations) if spec.tolerations else (),
            tuple(p.host_port for p in spec.ports) if spec.ports else (),
            tuple(spec.images) if spec.images else (),
            spec.required_node_name,
            # only the DERIVED rc_owned bit reaches the encoding — keying
            # on the full refs would fragment the prototype memo per
            # ReplicaSet (100 RS × identical pods = 100 signatures).
            # With selector_spread the owner IDENTITY feeds group
            # registration, so it must key the memo (owner_identity) —
            # that fragmentation is then the plugin's real cost model
            # (replicas of one controller still share a signature).
            (owner_spread_pair(pod.metadata) if owner_identity else
             any(r.controller and r.kind in ("ReplicationController",
                                             "ReplicaSet")
                 for r in pod.metadata.owner_references))
            if pod.metadata.owner_references else False,
            tuple(spec.node_selector.items()) if spec.node_selector else (),
            tuple((c.topology_key, c.max_skew, c.when_unsatisfiable,
                   sel_sig(c.label_selector)) for c in cons)
            if cons else (),
            aff_sig,
        )

    return pod_sig


# PodFeatures fields bulk-copied from a prototype row on a signature hit
# (everything the per-pod encode body writes; valid/name_suffix/gang are
# per-pod, volume fields keep their defaults — volume pods never memoize).
_PROTO_COPY_FIELDS = (
    "requests", "priority", "ns_hash", "label_pairs", "na_group",
    "tol_pairs", "tol_keys", "tol_ops", "tol_effects", "ports", "images",
    "required_node", "rc_owned",
    "spread_group", "spread_max_skew", "spread_mode", "selspread_group",
    "aff_req_group", "aff_req_self", "aff_pref_group", "aff_pref_weight",
    "anti_req_group", "anti_pref_group", "anti_pref_weight",
    "anti_forbid_key", "anti_forbid_dom", "anti_forbid_row",
    "anti_forbid_maxpri", "sym_slot")


def encode_pods(pods: List[Pod], p_pad: int,
                cfg: EncodingConfig = DEFAULT_ENCODING,
                overflow: Optional[List[str]] = None,
                registry: Optional[TopologyKeyRegistry] = None,
                volumes_ready_fn=None,
                group_pad: Optional[int] = None,
                gang_bound_fn=None,
                volume_info_fn=None,
                anti_forbidden_fn=None,
                hard_failed: Optional[Dict[int, List[Tuple[str, str]]]] = None,
                selector_spread: bool = False,
                sym_table=None):
    """Encode a batch of pending pods, padded to ``p_pad`` rows.

    Returns an EncodedBatch: pod features plus the batch's distinct
    topology-constraint selector groups (gf) and node-affinity signature
    groups (naf). ``registry`` maps topology keys to stable indices (shared
    with the node cache); ``volumes_ready_fn(pod) -> bool`` reports whether
    the pod's PVCs are bound (VolumeBinding filter input) — default: ready.
    ``volume_info_fn(pod) -> (claim_rows, zone_key_idx, zone_dom)`` supplies
    the VolumeRestrictions / VolumeZone inputs (engine resolves them from
    the store + node cache) — default: unrestricted, no zone requirement.
    ``anti_forbidden_fn(pod) -> [(key_idx, dom_id), ...]`` supplies domains
    occupied by RUNNING pods whose required anti-affinity terms match this
    pod (cache.anti_forbidden_for) — default: none.
    ``hard_failed`` (optional out-param): pod index → list of
    (plugin name, reason) — one entry per tripped constraint —
    for pods whose HARD constraint (required affinity/anti-affinity term,
    DoNotSchedule spread) could not be represented in the encoding slots —
    the engine fails such pods closed instead of scheduling them against a
    silently weakened constraint.
    ``selector_spread``: also register owner selector groups
    (PodFeatures.selspread_group) for pods with a controller
    ownerReference — gated on the profile actually running the
    SelectorSpread plugin, because every distinct owner in the batch
    grows the group axis (and with it the (G,N) topology tables).
    ``sym_table`` (cache.SymBatch, optional): stamps each pod's
    ``sym_slot`` with the rows of the bound pods' terms it matches
    (``slots_for(pod)``) and supplies the batch's SymTerms
    (``build()``) — default: no symmetric terms.
    """
    if registry is None:
        registry = TopologyKeyRegistry(cfg)

    def _mark_hard(idx: int, plugin: str, reason: str) -> None:
        # One pod can trip several plugins' constraints; record ALL of
        # them — the engine gates by enabled plugin, and a first-write-
        # wins single slot would let a disabled plugin's verdict mask an
        # enabled one's.
        if hard_failed is not None:
            hard_failed.setdefault(idx, []).append((plugin, reason))
    builder = GroupBuilder(cfg)
    na_builder = NodeAffinityBuilder(cfg)
    P = p_pad
    T = cfg.max_pod_affinity_terms
    C = cfg.max_spread_constraints
    f = PodFeatures(
        valid=np.zeros(P, dtype=bool),
        requests=np.zeros((P, NUM_RESOURCES), dtype=np.float32),
        name_suffix=np.full(P, -1, dtype=np.int32),
        priority=np.zeros(P, dtype=np.int32),
        ns_hash=np.zeros(P, dtype=np.int32),
        label_pairs=np.zeros((P, cfg.max_labels), dtype=np.int32),
        na_group=np.full(P, -1, dtype=np.int32),
        tol_pairs=np.zeros((P, cfg.max_tolerations), dtype=np.int32),
        tol_keys=np.zeros((P, cfg.max_tolerations), dtype=np.int32),
        tol_ops=np.zeros((P, cfg.max_tolerations), dtype=np.int32),
        tol_effects=np.zeros((P, cfg.max_tolerations), dtype=np.int32),
        ports=np.zeros((P, cfg.max_pod_ports), dtype=np.int32),
        images=np.zeros((P, cfg.max_images), dtype=np.int32),
        required_node=np.zeros(P, dtype=np.int32),
        rc_owned=np.zeros(P, dtype=bool),
        volumes_ready=np.ones(P, dtype=bool),
        claim_rows=np.full((P, cfg.max_pod_claims), -1, dtype=np.int32),
        claim_typed=np.zeros((P, cfg.max_pod_claims), dtype=bool),
        zone_key=np.full(P, -1, dtype=np.int32),
        zone_dom=np.full(P, -1, dtype=np.int32),
        spread_group=np.full((P, C), -1, dtype=np.int32),
        spread_max_skew=np.ones((P, C), dtype=np.int32),
        spread_mode=np.zeros((P, C), dtype=np.int32),
        selspread_group=np.full((P, 2), -1, dtype=np.int32),
        aff_req_group=np.full((P, T), -1, dtype=np.int32),
        aff_req_self=np.zeros((P, T), dtype=bool),
        aff_pref_group=np.full((P, T), -1, dtype=np.int32),
        aff_pref_weight=np.zeros((P, T), dtype=np.float32),
        anti_req_group=np.full((P, T), -1, dtype=np.int32),
        anti_pref_group=np.full((P, T), -1, dtype=np.int32),
        anti_pref_weight=np.zeros((P, T), dtype=np.float32),
        anti_forbid_key=np.full((P, cfg.max_anti_forbid), -1, dtype=np.int32),
        anti_forbid_dom=np.full((P, cfg.max_anti_forbid), -1, dtype=np.int32),
        anti_forbid_row=np.full((P, cfg.max_anti_forbid), -1, dtype=np.int32),
        anti_forbid_maxpri=np.zeros((P, cfg.max_anti_forbid), dtype=np.int32),
        sym_slot=np.full((P, cfg.max_topology_keys), -1, dtype=np.int32),
    )
    sym_width = 0
    gang_group = np.full(P, -1, dtype=np.int32)
    gang_ids: Dict[str, int] = {}
    gang_mins: List[int] = []
    # Prototype memo: signature → prototype row; signature hits skip the
    # whole per-pod encode body and bulk-copy the prototype's rows after
    # the loop (one vectorized assignment per field per prototype — a
    # deployment-shaped 10k-pod batch is a handful of signatures, and the
    # per-pod Python encode was ~40% of the engine's host time at 10k).
    proto_of: Dict[tuple, int] = {}
    proto_copies: Dict[int, List[int]] = {}
    _pod_sig = _make_pod_sig(owner_identity=selector_spread)
    for i, pod in enumerate(pods):
        if i >= P:
            raise ValueError(f"{len(pods)} pods > pad {P}")
        f.valid[i] = True
        f.name_suffix[i] = name_suffix_digit(pod.metadata.name)
        if pod.spec.pod_group:
            gid = gang_ids.setdefault(obj.gang_key(pod), len(gang_mins))
            if gid == len(gang_mins):
                gang_mins.append(0)
            gang_mins[gid] = max(gang_mins[gid], int(pod.spec.pod_group_min))
            gang_group[i] = gid
        sig = _pod_sig(pod)
        if sig is not None:
            p_row = proto_of.get(sig)
            if p_row is not None:
                proto_copies.setdefault(p_row, []).append(i)
                continue
            proto_of[sig] = i
        f.requests[i] = resources_vector(obj.pod_requests(pod))
        f.priority[i] = pod.spec.priority
        ns = pod.metadata.namespace
        f.ns_hash[i] = _h(ns) if ns else 0
        labels = pod.metadata.labels
        if len(labels) > cfg.max_labels and overflow is not None:
            overflow.append(
                f"pod {pod.key} labels: {len(labels)} > {cfg.max_labels}")
        for j, kv in enumerate(labels.items()):
            if j >= cfg.max_labels:
                break
            f.label_pairs[i, j] = pair_hash(*kv)
        f.na_group[i] = na_builder.group_of(pod)
        aff = pod.spec.affinity

        tols = pod.spec.tolerations
        if len(tols) > cfg.max_tolerations and overflow is not None:
            overflow.append(f"pod {pod.key} tolerations overflow")
        for j, tol in enumerate(tols[:cfg.max_tolerations]):
            f.tol_ops[i, j] = TOL_EXISTS if tol.operator == "Exists" else TOL_EQUAL
            f.tol_keys[i, j] = key_hash(tol.key) if tol.key else 0
            f.tol_pairs[i, j] = pair_hash(tol.key, tol.value) if tol.operator != "Exists" else 0
            f.tol_effects[i, j] = _EFFECT_CODE.get(tol.effect, EFFECT_NONE) if tol.effect else EFFECT_NONE

        if pod.spec.ports:
            host_ports = [p.host_port for p in pod.spec.ports if p.host_port]
            if host_ports:
                _fill_slots(f.ports[i], host_ports,
                            f"pod {pod.key} host ports", overflow)
        if pod.spec.images:
            _fill_slots(f.images[i], [_h(im) for im in pod.spec.images],
                        f"pod {pod.key} images", overflow)

        if pod.spec.required_node_name:
            f.required_node[i] = _h(pod.spec.required_node_name)
        if pod.metadata.owner_references:
            f.rc_owned[i] = any(
                r.controller and r.kind in ("ReplicationController",
                                            "ReplicaSet")
                for r in pod.metadata.owner_references)
            if selector_spread:
                opair = owner_spread_pair(pod.metadata)
                if opair:
                    ns_h0 = (_h(pod.metadata.namespace)
                             if pod.metadata.namespace else 0)
                    # hostname is registry slot 0 by construction; the
                    # zone term only engages when the key registers
                    f.selspread_group[i, 0] = builder.group_of_pairs(
                        0, ns_h0, (opair,))
                    f.selspread_group[i, 1] = builder.group_of_pairs(
                        registry.index_of(SELECTOR_SPREAD_ZONE_KEY,
                                          overflow),
                        ns_h0, (opair,))
        if pod.spec.volumes:
            if volumes_ready_fn is not None:
                f.volumes_ready[i] = bool(volumes_ready_fn(pod))
            if volume_info_fn is not None:
                claim_rows, claim_typed, zk, zd = volume_info_fn(pod)
                # On slot overflow, PINNED rows (>= 0) must survive — they
                # carry RWO placement constraints; unused/multi states are
                # filter no-ops. Two distinct pinned rows correctly make
                # the pod unschedulable (claims on different nodes).
                order = sorted(range(len(claim_rows)),
                               key=lambda c: claim_rows[c] < 0)
                _fill_slots(f.claim_rows[i],
                            [claim_rows[c] for c in order],
                            f"pod {pod.key} volume claims", overflow)
                _fill_slots(f.claim_typed[i],
                            [claim_typed[c] for c in order], None, None)
                f.zone_key[i] = zk
                f.zone_dom[i] = zd
                # Generic attach-slot charge = UNTYPED claims that may need
                # a NEW attachment: pinned claims (row >= 0) cost nothing
                # on their only feasible node; unused and multi-node shared
                # claims charge one slot (for multi-node claims that
                # over-charges nodes already mounting them — the safe
                # direction; under-charging could over-commit a node).
                # Cloud-typed claims charge their own axes via pod_requests.
                f.requests[i, obj.RESOURCE_INDEX["attachable-volumes"]] = \
                    sum(1 for c, r in enumerate(claim_rows)
                        if r < 0 and not claim_typed[c])

        ns_h = _h(pod.metadata.namespace) if pod.metadata.namespace else 0
        cons = pod.spec.topology_spread_constraints
        if len(cons) > C:
            if overflow is not None:
                overflow.append(f"pod {pod.key} spread constraints overflow")
            if any(t.when_unsatisfiable == "DoNotSchedule" for t in cons[C:]):
                _mark_hard(i, "PodTopologySpread",
                           f"DoNotSchedule spread constraints exceed the "
                           f"{C} encoder slots")
        for c, tsc in enumerate(cons[:C]):
            k_idx = registry.index_of(tsc.topology_key, overflow)
            gid = builder.group_of(k_idx, ns_h, tsc.label_selector, overflow,
                                   f"pod {pod.key} spread[{c}]")
            hard = tsc.when_unsatisfiable == "DoNotSchedule"
            if gid < 0:
                if hard:
                    _mark_hard(i, "PodTopologySpread",
                               f"DoNotSchedule spread topology key "
                               f"{tsc.topology_key!r} could not be "
                               "registered (registry full)")
                continue
            if builder.last_weakened and hard:
                _mark_hard(i, "PodTopologySpread",
                           "DoNotSchedule spread selector could not be "
                           "fully represented (pairs/expressions overflow)")
            f.spread_group[i, c] = gid
            f.spread_max_skew[i, c] = int(tsc.max_skew)
            f.spread_mode[i, c] = (SPREAD_DO_NOT_SCHEDULE
                                   if tsc.when_unsatisfiable == "DoNotSchedule"
                                   else SPREAD_SCHEDULE_ANYWAY)

        pa = aff.pod_affinity if aff else None
        if pa:
            if _encode_pod_affinity_terms(
                    i, pa.required, f.aff_req_group, None, builder, registry,
                    ns_h, overflow, f"pod {pod.key} podAffinity",
                    self_arr=f.aff_req_self, pod_labels=pod.metadata.labels):
                _mark_hard(i, "InterPodAffinity",
                           "required pod-affinity term could not be "
                           "represented (slot or registry overflow)")
            _encode_pod_affinity_terms(
                i, pa.preferred, f.aff_pref_group, f.aff_pref_weight, builder,
                registry, ns_h, overflow, f"pod {pod.key} podAffinity.preferred")
        if anti_forbidden_fn is not None:
            pairs = anti_forbidden_fn(pod)
            if len(pairs) > cfg.max_anti_forbid and overflow is not None:
                overflow.append(
                    f"pod {pod.key} anti-affinity forbidden domains: "
                    f"{len(pairs)} > {cfg.max_anti_forbid} slots")
            for s, entry in enumerate(pairs[:cfg.max_anti_forbid]):
                # (key, dom) legacy pairs or (key, dom, owner_row,
                # owner_maxpri) — the extended form feeds preemption
                # curability (ops/preempt.py).
                f.anti_forbid_key[i, s] = entry[0]
                f.anti_forbid_dom[i, s] = entry[1]
                if len(entry) >= 4:
                    f.anti_forbid_row[i, s] = entry[2]
                    f.anti_forbid_maxpri[i, s] = entry[3]
        if sym_table is not None:
            rows = sym_table.slots_for(pod)
            if rows:
                f.sym_slot[i, :len(rows)] = rows
                sym_width = max(sym_width, len(rows))

        anti = aff.pod_anti_affinity if aff else None
        if anti:
            if _encode_pod_affinity_terms(
                    i, anti.required, f.anti_req_group, None, builder,
                    registry, ns_h, overflow, f"pod {pod.key} podAntiAffinity",
                    anti=True):
                _mark_hard(i, "InterPodAffinity",
                           "required pod-anti-affinity term could not be "
                           "represented (slot or registry overflow)")
            _encode_pod_affinity_terms(
                i, anti.preferred, f.anti_pref_group, f.anti_pref_weight,
                builder, registry, ns_h, overflow,
                f"pod {pod.key} podAntiAffinity.preferred")
    # Replay prototype rows onto their signature-equal pods: one
    # vectorized copy per field per prototype, plus the prototype's
    # hard-constraint marks (deterministic per signature).
    for p_row, rows in proto_copies.items():
        idx = np.asarray(rows, dtype=np.int64)
        for field in _PROTO_COPY_FIELDS:
            arr = getattr(f, field)
            arr[idx] = arr[p_row]
        if hard_failed is not None and p_row in hard_failed:
            marks = hard_failed[p_row]
            for j in rows:
                hard_failed[j] = list(marks)
    if gang_bound_fn is not None:
        # Quorum counts cluster-wide membership (upstream coscheduling):
        # members already running reduce the in-batch quorum, so a late or
        # replacement member of a live gang can still schedule.
        for group, gid in gang_ids.items():
            gang_mins[gid] = max(0, gang_mins[gid] - int(gang_bound_fn(group)))
    GG = _next_pow2(max(len(gang_mins), 8))
    gang = GangFeatures(
        group=gang_group,
        min_count=np.array(gang_mins + [0] * (GG - len(gang_mins)),
                           dtype=np.int32))
    sym = None
    if sym_width:
        sym = sym_table.build()
    f = f._replace(sym_slot=np.ascontiguousarray(f.sym_slot[:, :sym_width]))
    return EncodedBatch(pf=f, gf=builder.build(group_pad),
                        naf=na_builder.build(overflow=overflow), gang=gang,
                        sym=sym)

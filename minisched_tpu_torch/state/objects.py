"""Typed cluster objects.

The reference reuses the full upstream Kubernetes API types via client-go and
a 53,911-line generated OpenAPI schema (reference k8sapiserver/openapi/
zz_generated.openapi.go) solely so it can run a real in-process apiserver.
The rebuild keeps the *scheduling-relevant* surface of those types as plain
dataclasses: everything the filter/score plugins, the queue, and the binder
inspect — resources, labels, taints/tolerations, node/pod affinity, topology
spread, ports, volumes — and nothing else.

Conventions:
  * cpu is measured in millicores (int), memory/ephemeral-storage in bytes.
  * a "key" is "namespace/name" for namespaced objects (pods, pvcs), "name"
    for cluster-scoped ones (nodes, pvs) — matching the reference's
    resultstore keys (reference scheduler/plugin/resultstore/store.go:52-58).
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

# Resource dimensions tracked in dense feature vectors, in this order.
# (cpu millicores, memory bytes, max pods, ephemeral storage bytes,
#  generic accelerator count — the TPU-world stand-in for nvidia.com/gpu —
#  and attachable volume slots.) Volumes-as-a-resource makes the
#  capacity-aware greedy assignment respect attach limits WITHIN a batch,
#  not just across batches (SURVEY §7 batch-internal causality).
RESOURCES: Tuple[str, ...] = ("cpu", "memory", "pods", "ephemeral-storage",
                              "accelerator", "attachable-volumes",
                              "attachable-volumes-aws-ebs",
                              "attachable-volumes-gce-pd",
                              "attachable-volumes-azure-disk",
                              "attachable-volumes-cinder")
RESOURCE_INDEX: Dict[str, int] = {r: i for i, r in enumerate(RESOURCES)}

# Nodes that don't declare allocatable["attachable-volumes"] get this
# ceiling (the common cloud attach limit upstream's per-driver plugins
# default to).
DEFAULT_ATTACHABLE_VOLUMES = 26.0

# Per-cloud attach-slot axes (the reference wraps upstream's EBSLimits /
# GCEPDLimits / AzureDiskLimits filters, scheduler/plugin/plugins.go:24-70;
# defaults are upstream's DefaultMaxEBSVolumes=39, DefaultMaxGCEPDVolumes=16,
# DefaultMaxAzureDiskVolumes=16). A pod volume with a matching volume_type
# charges its cloud axis instead of the generic attachable-volumes axis.
CLOUD_VOLUME_AXES: Dict[str, str] = {
    "aws-ebs": "attachable-volumes-aws-ebs",
    "gce-pd": "attachable-volumes-gce-pd",
    "azure-disk": "attachable-volumes-azure-disk",
    "cinder": "attachable-volumes-cinder",
}
DEFAULT_CLOUD_VOLUME_LIMITS: Dict[str, float] = {
    "attachable-volumes-aws-ebs": 39.0,
    "attachable-volumes-gce-pd": 16.0,
    "attachable-volumes-azure-disk": 16.0,
    # upstream nodevolumelimits DefaultMaxCinderVolumes (the OpenStack
    # attach ceiling the CinderLimits plugin defaults to)
    "attachable-volumes-cinder": 256.0,
}


def controller_owner(meta: "ObjectMeta") -> Optional["OwnerReference"]:
    """The object's CONTROLLER ownerReference (kind+name identity), or
    None. SelectorSpread's owner-based spreading scope: upstream lists
    the services/RCs/RSs/StatefulSets selecting the pod; the rebuild
    uses the controller owner identity — replicas of one controller
    share it, which is exactly the population upstream spreads."""
    for r in meta.owner_references:
        if r.controller and r.kind and r.name:
            return r
    return None

ResourceList = Dict[str, float]

_uid_counter = itertools.count(1)


def _next_uid() -> str:
    return f"uid-{next(_uid_counter)}"


def bump_uid_counter(past: int) -> None:
    """Advance the uid counter beyond ``past`` (used after snapshot restore so
    new objects never reuse a restored object's uid)."""
    global _uid_counter
    current = next(_uid_counter)
    _uid_counter = itertools.count(max(current, past + 1))


@dataclass
class OwnerReference:
    """metadata.ownerReferences entry (the subset scheduling reads:
    upstream's NodePreferAvoidPods scopes avoidance to pods whose
    CONTROLLER owner is a ReplicationController/ReplicaSet).
    ``controller`` defaults False like the k8s API (the field is
    optional and absent means not-the-controller): a wire object
    missing the flag must NOT be treated as controller-owned."""

    kind: str = ""
    name: str = ""
    controller: bool = False


@dataclass
class ObjectMeta:
    name: str = ""
    namespace: str = ""
    uid: str = field(default_factory=_next_uid)
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    owner_references: List["OwnerReference"] = field(default_factory=list)
    resource_version: int = 0
    creation_timestamp: float = 0.0


@dataclass
class Taint:
    key: str
    value: str = ""
    effect: str = "NoSchedule"  # NoSchedule | PreferNoSchedule | NoExecute


@dataclass
class Toleration:
    key: str = ""  # empty key + Exists tolerates everything
    operator: str = "Equal"  # Equal | Exists
    value: str = ""
    effect: str = ""  # empty matches all effects

    def tolerates(self, taint: Taint) -> bool:
        """Upstream v1.Toleration.ToleratesTaint semantics."""
        if self.effect and self.effect != taint.effect:
            return False
        if self.key and self.key != taint.key:
            return False
        if self.operator == "Exists":
            return True
        return self.value == taint.value


@dataclass
class NodeSelectorRequirement:
    key: str
    operator: str  # In | NotIn | Exists | DoesNotExist | Gt | Lt
    values: List[str] = field(default_factory=list)

    def matches(self, labels: Dict[str, str]) -> bool:
        has = self.key in labels
        val = labels.get(self.key)
        if self.operator == "In":
            return has and val in self.values
        if self.operator == "NotIn":
            return not has or val not in self.values
        if self.operator == "Exists":
            return has
        if self.operator == "DoesNotExist":
            return not has
        if self.operator == "Gt":
            return has and _is_int(val) and int(val) > int(self.values[0])
        if self.operator == "Lt":
            return has and _is_int(val) and int(val) < int(self.values[0])
        raise ValueError(f"unknown operator {self.operator!r}")


def _is_int(v: Optional[str]) -> bool:
    try:
        int(v)  # type: ignore[arg-type]
        return True
    except (TypeError, ValueError):
        return False


@dataclass
class NodeSelectorTerm:
    match_expressions: List[NodeSelectorRequirement] = field(default_factory=list)

    def matches(self, labels: Dict[str, str]) -> bool:
        return all(r.matches(labels) for r in self.match_expressions)


@dataclass
class NodeSelector:
    """ORed terms, each term ANDs its expressions (upstream v1.NodeSelector)."""

    node_selector_terms: List[NodeSelectorTerm] = field(default_factory=list)

    def matches(self, labels: Dict[str, str]) -> bool:
        return any(t.matches(labels) for t in self.node_selector_terms)


@dataclass
class PreferredSchedulingTerm:
    weight: int
    preference: NodeSelectorTerm


@dataclass
class NodeAffinity:
    required: Optional[NodeSelector] = None
    preferred: List[PreferredSchedulingTerm] = field(default_factory=list)


@dataclass
class LabelSelector:
    match_labels: Dict[str, str] = field(default_factory=dict)
    match_expressions: List[NodeSelectorRequirement] = field(default_factory=list)

    def matches(self, labels: Dict[str, str]) -> bool:
        for k, v in self.match_labels.items():
            if labels.get(k) != v:
                return False
        return all(r.matches(labels) for r in self.match_expressions)

    def empty(self) -> bool:
        return not self.match_labels and not self.match_expressions


@dataclass
class PodAffinityTerm:
    label_selector: LabelSelector = field(default_factory=LabelSelector)
    topology_key: str = "kubernetes.io/hostname"
    namespaces: List[str] = field(default_factory=list)  # empty = pod's own ns


@dataclass
class WeightedPodAffinityTerm:
    weight: int
    term: PodAffinityTerm


@dataclass
class PodAffinity:
    required: List[PodAffinityTerm] = field(default_factory=list)
    preferred: List[WeightedPodAffinityTerm] = field(default_factory=list)


@dataclass
class PodAntiAffinity:
    required: List[PodAffinityTerm] = field(default_factory=list)
    preferred: List[WeightedPodAffinityTerm] = field(default_factory=list)


@dataclass
class Affinity:
    node_affinity: Optional[NodeAffinity] = None
    pod_affinity: Optional[PodAffinity] = None
    pod_anti_affinity: Optional[PodAntiAffinity] = None


@dataclass
class TopologySpreadConstraint:
    max_skew: int = 1
    topology_key: str = "topology.kubernetes.io/zone"
    when_unsatisfiable: str = "DoNotSchedule"  # or ScheduleAnyway
    label_selector: LabelSelector = field(default_factory=LabelSelector)


@dataclass
class ContainerPort:
    host_port: int = 0
    container_port: int = 0
    protocol: str = "TCP"
    host_ip: str = ""


@dataclass
class VolumeClaim:
    """A pod's reference to a PVC by name (pod.spec.volumes[*].pvc).

    ``volume_type`` identifies the backing driver the way upstream's
    per-cloud limit filters classify volumes (aws-ebs | gce-pd |
    azure-disk, CLOUD_VOLUME_AXES); "" = generic, charged to the
    attachable-volumes axis."""

    claim_name: str
    volume_type: str = ""


class PodPhase:
    PENDING = "Pending"
    RUNNING = "Running"
    SUCCEEDED = "Succeeded"
    FAILED = "Failed"


@dataclass
class PodSpec:
    node_name: str = ""
    # Upstream spec.nodeName as a *constraint* evaluated by the NodeName
    # plugin (distinct from node_name, which records the committed binding).
    required_node_name: str = ""
    scheduler_name: str = "default-scheduler"
    priority: int = 0
    requests: ResourceList = field(default_factory=dict)  # aggregated container requests
    node_selector: Dict[str, str] = field(default_factory=dict)
    affinity: Optional[Affinity] = None
    tolerations: List[Toleration] = field(default_factory=list)
    topology_spread_constraints: List[TopologySpreadConstraint] = field(default_factory=list)
    ports: List[ContainerPort] = field(default_factory=list)
    volumes: List[VolumeClaim] = field(default_factory=list)
    images: List[str] = field(default_factory=list)
    # Gang scheduling: pods sharing a non-empty group must be assigned
    # all-or-nothing (coscheduling; no reference analog — BASELINE config 5).
    pod_group: str = ""
    pod_group_min: int = 0


@dataclass
class PodStatus:
    phase: str = PodPhase.PENDING
    # Names of plugins that rejected the pod in its last scheduling attempt;
    # drives event-filtered requeue (reference framework's
    # QueuedPodInfo.UnschedulablePlugins, used at queue/queue.go:167-190).
    unschedulable_plugins: List[str] = field(default_factory=list)
    message: str = ""
    # Wall-clock the binding committed (upstream PodScheduled condition's
    # lastTransitionTime analog). creation_timestamp → scheduled_time is
    # the per-pod schedule latency — the BASELINE "p50 schedule-one
    # latency" metric comes straight from these two stamps.
    scheduled_time: float = 0.0
    # Node this pod preempted victims on (upstream status.nominatedNodeName,
    # set by the DefaultPreemption postfilter): observability of the
    # preemption decision while the pod waits for the victims' capacity.
    nominated_node_name: str = ""


@dataclass
class Pod:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodSpec = field(default_factory=PodSpec)
    status: PodStatus = field(default_factory=PodStatus)

    @property
    def key(self) -> str:
        return f"{self.metadata.namespace}/{self.metadata.name}"

    @property
    def bound(self) -> bool:
        return bool(self.spec.node_name)


@dataclass
class NodeSpec:
    unschedulable: bool = False
    taints: List[Taint] = field(default_factory=list)


@dataclass
class NodeStatus:
    capacity: ResourceList = field(default_factory=dict)
    allocatable: ResourceList = field(default_factory=dict)
    images: List[str] = field(default_factory=list)


@dataclass
class Node:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: NodeSpec = field(default_factory=NodeSpec)
    status: NodeStatus = field(default_factory=NodeStatus)

    @property
    def key(self) -> str:
        return self.metadata.name


@dataclass
class PersistentVolume:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    capacity: ResourceList = field(default_factory=dict)
    claim_ref: str = ""  # bound PVC key, "" if available
    storage_class: str = ""
    phase: str = "Available"  # Available | Bound

    @property
    def key(self) -> str:
        return self.metadata.name


@dataclass
class PersistentVolumeClaim:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    request: ResourceList = field(default_factory=dict)
    storage_class: str = ""
    volume_name: str = ""  # bound PV name, "" if pending
    phase: str = "Pending"  # Pending | Bound
    # Upstream StorageClass.volumeBindingMode, carried on the claim (the
    # rebuild has no StorageClass kind): WaitForFirstConsumer claims are
    # NOT bound by the PV controller until their pod schedules; the
    # scheduler treats them as ready and constrains the pod to zones where
    # a candidate PV exists (volumebinding.py WFFC path).
    binding_mode: str = "Immediate"  # Immediate | WaitForFirstConsumer

    @property
    def key(self) -> str:
        return f"{self.metadata.namespace}/{self.metadata.name}"


@dataclass
class Event:
    """Cluster event record (analog of the k8s Events API the reference's
    broadcaster writes to, reference scheduler/scheduler.go:55-59)."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    type: str = "Normal"  # Normal | Warning
    reason: str = ""
    message: str = ""
    involved_object: str = ""  # "kind:key"
    source: str = "minisched-tpu"
    count: int = 1

    @property
    def key(self) -> str:
        return f"{self.metadata.namespace}/{self.metadata.name}"


@dataclass
class PDBSpec:
    """upstream policy/v1 PodDisruptionBudgetSpec, the min_available
    form (max_unavailable reduces to it given the matched count; only
    min_available is modeled — the simulator has no desired-replica
    source to resolve percentages against)."""

    min_available: int = 0
    selector: Optional[LabelSelector] = None


@dataclass
class PodDisruptionBudget:
    """upstream policy/v1 PodDisruptionBudget: bounds VOLUNTARY
    disruptions (here: preemption evictions) of the matching pods. The
    reference has no preemption and therefore no PDBs; this models the
    upstream semantics DefaultPreemption honors — victims whose eviction
    would drop a budget below min_available are chosen only as a last
    resort (plugins/preemption.py)."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PDBSpec = field(default_factory=PDBSpec)

    @property
    def key(self) -> str:
        return f"{self.metadata.namespace}/{self.metadata.name}"


@dataclass
class Lease:
    """Shard-ownership lease (the coordination.k8s.io/v1 Lease shape
    applied to scheduler-fleet shards, fleet/lease.py): ``holder`` is
    the replica id currently serving the shard, ``epoch`` is the fencing
    token — bumped by CAS on every ownership CHANGE, never on renewal —
    and ``renewed_at`` + ``ttl_s`` define expiry. All ownership writes go
    through the store's optimistic-concurrency update (resource_version
    CAS), so two claimants can never both win an epoch: the loser's
    write raises Conflict and it re-reads the new truth."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    holder: str = ""  # replica id, "" = unheld
    epoch: int = 0  # fencing token: bumped on every ownership change
    ttl_s: float = 3.0
    renewed_at: float = 0.0  # holder's time.monotonic() heartbeat stamp
    shard: int = 0
    # Burn signal published on the lease heartbeat (fleet/election.py):
    # the holder's overload-ladder rung + its burning SLO objectives, so
    # the steward's rebalance trigger reads load straight off the lease
    # records it already scans (scribbles are the election:corrupt gate;
    # the rebalancer's plausibility clamp discards them).
    burn_level: int = 0
    burning: str = ""  # comma-joined burning objective names

    @property
    def key(self) -> str:
        return self.metadata.name

    def expired(self, now: float) -> bool:
        return not self.holder or now - self.renewed_at > self.ttl_s


@dataclass
class ReplicaStatus:
    """One process-fleet replica's heartbeat record (fleet/procfleet.py):
    the replica CAS-writes it every lease tick so the supervisor's
    census, the elastic rebalancer's load signals, and the warm-takeover
    readiness gate all read ONE store object per replica instead of
    scraping N processes. ``incarnation`` bumps on every respawn (the
    exit-code census keys on it); ``ready`` flips only after the
    bucket-ladder pre-warm completes (the admission-gate analog: a
    replica that is still compiling must not claim shards it cannot
    serve at full speed); the load fields feed the rebalancer's
    donor/recipient nomination."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    pid: int = 0
    incarnation: int = 0
    ready: bool = False
    warm: bool = False           # pre-warm completed (compile cache hot)
    queue_depth: int = 0         # pending pods in the replica's queue
    overload_level: int = 0      # overload-ladder rung (burn signal)
    pods_bound: int = 0
    renewed_at: float = 0.0      # replica's time.time() heartbeat stamp
    address: str = ""            # replica's own journal/provenance server
    burning: str = ""            # comma-joined burning SLO objectives

    @property
    def key(self) -> str:
        return self.metadata.name


@dataclass
class ShardMove:
    """One elastic-handoff directive (fleet/procfleet.py): the
    supervisor's rebalancer nominates ``shard`` to move from ``donor``
    to ``recipient``; the donor voluntarily releases the lease (holder
    cleared by CAS, epoch untouched) and flips ``state`` to released;
    the recipient claims through the ordinary lease protocol (epoch+1
    CAS) and deletes the directive. Ownership itself only ever moves
    through the Lease object — the directive is routing intent, so a
    crashed recipient merely leaves a stale directive any peer may
    ignore after ``ttl_s``."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    shard: int = 0
    donor: str = ""
    recipient: str = ""
    state: str = "nominated"     # nominated -> released -> (deleted)
    nominated_at: float = 0.0
    ttl_s: float = 10.0
    # Epoch fence (fleet/election.py): the steward-lease epoch the
    # nominator held when it wrote this directive. Replicas reject a
    # directive fenced below the CURRENT steward epoch — a deposed
    # steward's stale nominations can never move a shard. 0 = unfenced
    # (the supervised procfleet path, where the parent is the only
    # nominator by construction).
    steward_epoch: int = 0

    @property
    def key(self) -> str:
        return self.metadata.name


@dataclass
class Incarnation:
    """One replica's store-visible incarnation ledger
    (fleet/election.py): the census record the STEWARD role reads and
    CAS-advances instead of the parent supervisor's in-memory counters.
    ``incarnation`` is the expected-current incarnation (bumped by the
    mourn CAS — exactly one steward wins each bump, which is the
    exactly-once respawn guarantee); ``state`` tracks the
    alive → respawning → alive loop (a record stuck ``respawning``
    past the grace window is an ORPHANED incarnation the successor
    steward re-adopts); the tallies are the exit-code census."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    replica: str = ""
    incarnation: int = 0
    state: str = "alive"         # alive -> respawning -> alive
    pid: int = 0
    deaths: int = 0
    respawns: int = 0
    exit_codes: Dict[str, int] = field(default_factory=dict)
    backoff_s: float = 0.0       # capped doubling, adopted by successors
    updated_at: float = 0.0      # writer's time.time() stamp
    steward: str = ""            # last steward to mourn/respawn this rid
    steward_epoch: int = 0       # its fencing epoch at that write

    @property
    def key(self) -> str:
        return self.metadata.name


KIND_OF = {
    Pod: "Pod",
    Node: "Node",
    PersistentVolume: "PersistentVolume",
    PersistentVolumeClaim: "PersistentVolumeClaim",
    Event: "Event",
    PodDisruptionBudget: "PodDisruptionBudget",
    Lease: "Lease",
    ReplicaStatus: "ReplicaStatus",
    ShardMove: "ShardMove",
    Incarnation: "Incarnation",
}

NAMESPACED = {"Pod": True, "Node": False, "PersistentVolume": False,
              "PersistentVolumeClaim": True, "Event": True,
              "PodDisruptionBudget": True, "Lease": False,
              "ReplicaStatus": False, "ShardMove": False,
              "Incarnation": False}


def kind_of(obj: Any) -> str:
    try:
        return KIND_OF[type(obj)]
    except KeyError:
        raise TypeError(f"unregistered object type {type(obj)!r}")


def object_key(obj: Any) -> str:
    return obj.key


_ATOMIC_TYPES = frozenset((str, int, float, bool, type(None)))
_DATACLASS_TYPES: set = set()  # observed dataclass types (clone fast path)


def _clone(v):
    # Branch order matters: ~3/4 of the calls on a pod tree are atomic
    # leaves and most of the rest are dataclasses — is_dataclass() per
    # call was the top cost of bulk ingestion (10k-pod create_many).
    t = v.__class__
    if t in _ATOMIC_TYPES:
        return v
    if t in _DATACLASS_TYPES:
        new = t.__new__(t)
        d = new.__dict__
        for k, x in v.__dict__.items():
            d[k] = _clone(x)
        return new
    if t is dict:
        return {k: _clone(x) for k, x in v.items()}
    if t is list:
        return [_clone(x) for x in v]
    if t is tuple:
        return tuple(_clone(x) for x in v)
    if t is set:
        return set(v)  # sets here only ever hold scalars (plugin names)
    if dataclasses.is_dataclass(v):
        _DATACLASS_TYPES.add(t)
        new = t.__new__(t)
        d = new.__dict__
        for k, x in v.__dict__.items():
            d[k] = _clone(x)
        return new
    import copy

    return copy.deepcopy(v)


def shallow_evolve(o: Any, **kw: Any) -> Any:
    """Fast dataclasses.replace: builds the new object via __dict__ instead
    of __init__ and SHARES unchanged field values with the original.
    Safe only under the store's replacement-only convention (stored
    objects are never mutated in place), where structural sharing between
    an object and its superseded version is already the contract —
    dataclasses.replace costs ~5x more on the bulk-bind hot path (one
    full __init__ per evolved sub-object × 4 objects × 10k pods)."""
    new = object.__new__(type(o))
    d = new.__dict__
    d.update(o.__dict__)
    d.update(kw)
    return new


# Every dataclass the API object tree can contain: the clone and codec
# type universe, which the native fastclone registers. Derived from this
# module's definitions, so a dataclass added later cannot be missing
# (a miss would send each of its objects through the Python walk).
_WIRE_TYPES = tuple(
    v for v in list(globals().values())
    if isinstance(v, type) and dataclasses.is_dataclass(v))

_native = None  # (clone, clone_snapshot, untrack), resolved on first use
_native_lock = threading.Lock()


def _try_native():
    """Load the C fastclone (minisched_tpu_torch/native, raising when it
    cannot be built) and register every dataclass type of the object
    tree. Returns its ``(clone, clone_snapshot, untrack)``, or None
    under ``MINISCHED_NO_NATIVE=1``."""
    from ..native import load

    mod = load()
    if mod is None:
        return None
    for cls in _WIRE_TYPES:
        mod.register(cls)
    return mod.clone, mod.clone_snapshot, mod.untrack


def _resolve():
    # One resolver at a time: a thread racing the first build must wait
    # for it, not resolve a second time. The Python walk has no untrack.
    global _native
    with _native_lock:
        if _native is None:
            _native = _try_native() or (_clone, _clone, None)
        return _native


def deepcopy_obj(obj):
    """Structural deep copy of the pure-dataclass API objects.

    Hand-rolled instead of copy.deepcopy: the store isolates every
    create/update/get behind a copy, so this sits on the ingestion hot
    path (50k-node clusters = 10^5 copies before the first scheduling
    cycle). Rebuilding via __dict__ skips deepcopy's memo machinery and
    __init__, ~10x cheaper on these object trees. The native fastclone
    (minisched_tpu_torch/native, the same recursion in C) takes the
    walk unless ``MINISCHED_NO_NATIVE=1``; a type it was never given
    raises TypeError there, and that object takes the Python walk."""
    clone = (_native or _resolve())[0]
    try:
        return clone(obj)
    except TypeError:
        return _clone(obj)  # unregistered type: the Python walk handles it


def snapshot_obj(obj):
    """``deepcopy_obj`` for a copy the store keeps: the same copy, taken
    off the cycle collector's lists as it is built (the native
    ``clone_snapshot``). A stored object is immutable and acyclic by the
    store's copy discipline, so the collector has nothing to find in it;
    its reference count still frees it. The Python walk
    (``MINISCHED_NO_NATIVE=1``) leaves the copy tracked."""
    _, snapshot, untrack = _native or _resolve()
    try:
        return snapshot(obj)
    except TypeError:
        c = _clone(obj)  # unregistered type: the Python walk handles it
        if untrack is not None:
            untrack(c)
        return c


def untrack_obj(o) -> None:
    """Take an object the store keeps, built in Python (an evolved
    version, a decoded snapshot, a watch event), off the cycle
    collector's lists, with every still-tracked container below it (the
    native ``untrack``; objects of unregistered types stay tracked). A
    no-op on the Python walk."""
    untrack = (_native or _resolve())[2]
    if untrack is not None:
        untrack(o)


from .codec import build as _codec_build  # noqa: E402  (after the
from .codec import dump as _codec_dump  # noqa: E402   dataclasses exist)


def to_dict(obj: Any) -> Dict[str, Any]:
    # Compiled codec (state/codec.py): ~10× faster than
    # dataclasses.asdict on the wire/watch hot paths, same output shape,
    # fresh containers at every level. (Module-level import: a per-call
    # ``from .codec import dump`` measured 3× the dump itself.)
    return _codec_dump(obj)


_KIND_CLASS = {v: k for k, v in KIND_OF.items()}


@functools.lru_cache(maxsize=None)
def _field_hints(cls) -> Dict[str, Any]:
    import typing

    return typing.get_type_hints(cls)


def _build_typed(tp: Any, v: Any) -> Any:
    """Recursively rebuild a typed value from its JSON form — the inverse
    of dataclasses.asdict for the API object tree (the wire layer of the
    HTTP front; reference: client-go decodes apiserver JSON the same
    shape-directed way)."""
    import typing

    if v is None:
        return None
    origin = typing.get_origin(tp)
    if origin is typing.Union:  # Optional[X] and friends
        for arg in typing.get_args(tp):
            if arg is type(None):
                continue
            return _build_typed(arg, v)
        return v
    if dataclasses.is_dataclass(tp):
        hints = _field_hints(tp)
        kwargs = {f.name: _build_typed(hints[f.name], v[f.name])
                  for f in dataclasses.fields(tp) if f.name in v}
        return tp(**kwargs)
    if origin in (list, tuple, set):
        args = typing.get_args(tp)
        elem = args[0] if args else Any
        seq = (_build_typed(elem, x) for x in v)
        return origin(seq)
    if origin is dict:
        args = typing.get_args(tp)
        vt = args[1] if len(args) == 2 else Any
        return {k: _build_typed(vt, x) for k, x in v.items()}
    return v  # scalars (str/int/float/bool) and untyped payloads


def from_dict(kind: str, data: Dict[str, Any]) -> Any:
    """JSON dict → API object of ``kind`` (inverse of to_dict). Compiled
    codec; ``_build_typed`` above remains as the readable reference
    implementation (and the codec's behavioral spec)."""
    cls = _KIND_CLASS.get(kind)
    if cls is None:
        raise TypeError(f"unknown kind {kind!r}")
    return _codec_build(cls, data)


def pod_requests(pod: Pod) -> ResourceList:
    """Effective resource requests incl. the implicit one-pod slot and the
    pod's volume-attachment slots. Typed volumes (VolumeClaim.volume_type)
    charge their per-cloud axis; untyped ones the generic axis — so the
    capacity-aware greedy assignment respects every attach limit WITHIN a
    batch, and the per-cloud limit filters are plain axis comparisons."""
    req = dict(pod.spec.requests)
    req.setdefault("pods", 1)
    if pod.spec.volumes:
        generic = 0
        for v in pod.spec.volumes:
            axis = CLOUD_VOLUME_AXES.get(v.volume_type)
            if axis is None:
                generic += 1
            else:
                req[axis] = req.get(axis, 0) + 1
        if generic:
            req.setdefault("attachable-volumes", float(generic))
    return req


# Claim mount states (NodeFeatureCache.claim_node_row): a non-negative
# value is the single node row mounting the claim.
CLAIM_UNUSED = -1   # nobody mounts the claim
CLAIM_MULTI = -2    # mounted on several nodes (shared RWX-style use)


def claim_keys(pod: Pod) -> List[str]:
    """Namespaced PVC keys of the pod's volume claims — the single
    definition every claim-tracking site (cache claim table, engine volume
    info, RWO arbitration) must share. Deduplicated: a pod mounting the
    same PVC through several volume entries (the subPath pattern) attaches
    it once, so it must be tracked/charged once."""
    seen = set()
    out = []
    for v in pod.spec.volumes:
        ck = f"{pod.metadata.namespace}/{v.claim_name}"
        if ck not in seen:
            seen.add(ck)
            out.append(ck)
    return out


def gang_key(pod: Pod) -> str:
    """Canonical namespaced gang identity: ``namespace/pod_group`` ("" when
    ungrouped). Gangs are namespace-scoped like upstream coscheduling's
    PodGroup — same-named groups in different namespaces are distinct."""
    if not pod.spec.pod_group:
        return ""
    return f"{pod.metadata.namespace}/{pod.spec.pod_group}"

"""Device meshes and feature shardings.

The scaling axis of a scheduler is node count × pending-pod count: the
(P × N) filter and score matrices take the role sequence length plays in
a model. The layout is the JAX package's:

  * mesh axes ("pod", "node"): the pod axis is the data-parallel-like
    axis, the node axis the tensor-parallel-like one;
  * NodeFeatures leaves split their leading N dim over "node"
    (``topo_domains`` its second: its leading dim is the key registry);
    PodFeatures leaves and the gang ids split over "pod"; the constraint
    groups, the node-affinity groups, the gang quorums and the
    assigned-pod corpus are small and replicated;
  * (P, N) intermediates split over both.

PyTorch has no GSPMD, so a sharding here is a plain description (which
leading dims of a leaf split over which axis) and ``put`` cuts a whole
tensor into the blocks of the mesh positions this process holds, each on
its position's device. The sharded step (parallel/sharded.py) evaluates
block by block and takes its cross-shard reductions through
parallel/collectives.py.

A ``Mesh`` may name one device more than once: a *virtual* mesh whose
shards share a device (the CPU tests' ``[torch.device("cpu")] * 8``, or
``[torch.device("cuda:0")] * 8`` on one card). A block on the device of
its source is a view, so a virtual mesh copies nothing. A hybrid mesh
spans processes of a ``torch.distributed`` group: its pod axis is the
group's ranks, and each process holds its own pod row's node shards.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

POD_AXIS = "pod"
NODE_AXIS = "node"


def _as_device(d) -> torch.device:
    return d if isinstance(d, torch.device) else torch.device(d)


class Mesh:
    """A ("pod", "node") grid of torch devices.

    ``devices`` is the (pod, node) numpy object array of the grid. On a
    single-process mesh every position is local. On a hybrid mesh
    (``group`` set) row r is the node-axis devices of rank r as that
    process names them; this process holds row ``group`` rank only.
    ``collectives`` carries every cross-shard operation the step takes
    (parallel/collectives.py)."""

    def __init__(self, devices: np.ndarray, group=None):
        from .collectives import make_collectives

        devs = np.empty(devices.shape, dtype=object)
        for idx in np.ndindex(devices.shape):
            devs[idx] = _as_device(devices[idx])
        if devs.ndim != 2 or devs.size == 0:
            raise ValueError(f"a mesh is a non-empty (pod, node) grid, "
                             f"got shape {devs.shape}")
        self.devices = devs
        self.axis_names: Tuple[str, str] = (POD_AXIS, NODE_AXIS)
        self.group = group
        self.collectives = make_collectives(self)

    @property
    def shape(self) -> Dict[str, int]:
        """Axis sizes by name, as ``jax.sharding.Mesh.shape``."""
        return {POD_AXIS: int(self.devices.shape[0]),
                NODE_AXIS: int(self.devices.shape[1])}

    def local_pod_rows(self) -> List[int]:
        """The pod rows whose blocks this process holds: every row in one
        process, the process's rank on a hybrid mesh."""
        if self.group is None:
            return list(range(self.devices.shape[0]))
        return [self.collectives.rank]

    def device_of(self, i: int, j: int) -> torch.device:
        return self.devices[i, j]

    @property
    def device(self) -> torch.device:
        """The mesh's first local device: where the step's replicated
        stages (the assignment, the decision) run."""
        return self.devices[self.local_pod_rows()[0], 0]

    def __repr__(self) -> str:
        kind = "hybrid " if self.group is not None else ""
        return (f"Mesh({kind}{self.devices.shape[0]}x"
                f"{self.devices.shape[1]} over "
                f"{sorted({str(d) for d in self.devices.flat})})")


def _default_devices() -> List[torch.device]:
    """Every CUDA device; the port's entry points never fall back to the
    CPU: ask for it by passing CPU devices."""
    if not torch.cuda.is_available():
        raise RuntimeError("make_mesh() with no devices needs a CUDA device "
                           "and none is available; pass the devices (e.g. "
                           "[torch.device('cpu')] * 8) to mesh the CPU")
    return [torch.device(f"cuda:{k}")
            for k in range(torch.cuda.device_count())]


def make_mesh(devices: Optional[Sequence] = None,
              pod_axis_size: Optional[int] = None) -> Mesh:
    """A ("pod", "node") mesh over ``devices`` (default: every CUDA
    device). The node axis gets the larger share: the node dim dominates
    memory and bandwidth, and the heavy reductions (normalize, the
    domain tables, the chunk gathers) run along it. With no
    ``pod_axis_size``, the pod axis is 2 for an even count of at least 4
    devices, else 1."""
    devs = [_as_device(d) for d in
            (devices if devices is not None else _default_devices())]
    n = len(devs)
    if n == 0:
        raise ValueError("make_mesh needs at least one device")
    if pod_axis_size is None:
        pod_axis_size = 2 if n % 2 == 0 and n >= 4 else 1
    if n % pod_axis_size:
        raise ValueError(f"{n} devices not divisible by pod axis "
                         f"{pod_axis_size}")
    arr = np.empty((pod_axis_size, n // pod_axis_size), dtype=object)
    for k, d in enumerate(devs):
        arr[k // arr.shape[1], k % arr.shape[1]] = d
    return Mesh(arr)


def make_hybrid_mesh(pod_axis_size: Optional[int] = None,
                     devices: Optional[Sequence] = None,
                     group=None) -> Mesh:
    """A ("pod", "node") mesh whose pod axis spans processes: the node
    axis carries the heavy collectives and stays inside a process; the
    pod axis only moves chunk rows and the decision's pod-axis leaves.

    ``group`` is a ``torch.distributed`` process group (default: the
    default group when one is initialized with more than one rank).
    With a group, ``devices`` are this process's node-axis devices
    (every rank passes as many) and the pod axis is pinned to the
    group's size: any other ``pod_axis_size`` raises rather than build
    another layout. With no group, it is ``make_mesh``."""
    import torch.distributed as dist

    if group is None and dist.is_available() and dist.is_initialized():
        if dist.get_world_size() > 1:
            group = dist.group.WORLD
    if group is None:
        return make_mesh(devices, pod_axis_size=pod_axis_size)
    world = dist.get_world_size(group)
    if pod_axis_size is not None and pod_axis_size != world:
        raise ValueError(
            f"hybrid layout pins the pod axis to the process count "
            f"({world}); got pod_axis_size={pod_axis_size}")
    devs = [_as_device(d) for d in
            (devices if devices is not None else _default_devices())]
    if not devs:
        raise ValueError("make_hybrid_mesh needs at least one local device")
    arr = np.empty((world, len(devs)), dtype=object)
    for r in range(world):
        for j, d in enumerate(devs):
            arr[r, j] = d
    return Mesh(arr, group=group)


class Sharding(NamedTuple):
    """Which leading dims of a leaf split over which mesh axis: ``spec``
    holds one entry per leading dim (POD_AXIS, NODE_AXIS or None);
    further dims, and every dim of an empty spec, are replicated."""

    mesh: Mesh
    spec: Tuple[Optional[str], ...]


def node_sharding(mesh: Mesh) -> Sharding:
    return Sharding(mesh, (NODE_AXIS,))


def pod_sharding(mesh: Mesh) -> Sharding:
    return Sharding(mesh, (POD_AXIS,))


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def leaf_sharding(mesh: Mesh, name: str) -> Sharding:
    """The placement of one NodeFeatures leaf by field name: the node
    axis splits the leading dim, except ``topo_domains``, whose node
    axis is its second (its leading dim is the topology-key registry).
    The sharded step cuts the node features with it."""
    if name == "topo_domains":
        return Sharding(mesh, (None, NODE_AXIS))
    return node_sharding(mesh)


def feature_shardings(mesh: Mesh, eb_template, nf_template,
                      af_template) -> Tuple:
    """Per-leaf shardings of one step's inputs: pod-feature leaves and
    the gang ids split over "pod", node features over "node"
    (``topo_domains`` over its second dim); the constraint groups, the
    node-affinity groups, the gang quorums, the symmetric term table
    (when the batch has one) and the assigned-pod corpus are
    replicated."""
    pf, gf, naf, gang = (eb_template.pf, eb_template.gf, eb_template.naf,
                         eb_template.gang)
    rep = replicated(mesh)
    pf_sh = type(pf)(*(pod_sharding(mesh) for _ in pf))
    nf_sh = type(nf_template)(*(leaf_sharding(mesh, name)
                                for name in nf_template._fields))
    gang_sh = type(gang)(group=pod_sharding(mesh), min_count=rep)
    eb_sh = type(eb_template)(pf=pf_sh, gf=type(gf)(*(rep for _ in gf)),
                              naf=type(naf)(*(rep for _ in naf)),
                              gang=gang_sh)
    sym = getattr(eb_template, "sym", None)
    if sym is not None:
        eb_sh = eb_sh._replace(sym=type(sym)(*(rep for _ in sym)))
    af_sh = type(af_template)(*(rep for _ in af_template))
    return eb_sh, nf_sh, af_sh


class ShardedTensor:
    """A global tensor cut over a mesh: ``blocks[(i, j)]`` is the block
    at mesh position (i, j), on that position's device, for the
    positions this process holds. ``source`` is the whole tensor it was
    cut from, when this process has it (every input of the step: each
    process holds the full host copy, as the JAX dryrun's processes do);
    ``full()`` returns it, or gathers the blocks through the mesh's
    collectives."""

    __slots__ = ("sharding", "shape", "dtype", "blocks", "source")

    def __init__(self, sharding: Sharding, shape, dtype, blocks,
                 source=None):
        self.sharding = sharding
        self.shape = tuple(shape)
        self.dtype = dtype
        self.blocks: Dict[Tuple[int, int], torch.Tensor] = blocks
        self.source = source

    @property
    def mesh(self) -> Mesh:
        return self.sharding.mesh

    def block(self, i: int, j: int) -> torch.Tensor:
        return self.blocks[(i, j)]

    def full(self, device=None) -> torch.Tensor:
        """The whole tensor on ``device`` (default: the mesh's first local
        device)."""
        mesh = self.mesh
        dev = _as_device(device) if device is not None else mesh.device
        if self.source is not None:
            return self.source.to(dev)
        coll = mesh.collectives
        spec = self.sharding.spec
        node_dim = spec.index(NODE_AXIS) if NODE_AXIS in spec else None
        pod_dim = spec.index(POD_AXIS) if POD_AXIS in spec else None
        rows = {}
        for i in mesh.local_pod_rows():
            parts = [self.blocks[(i, j)]
                     for j in range(mesh.shape[NODE_AXIS])]
            rows[i] = (coll.node_all_gather(parts, node_dim, dev)
                       if node_dim is not None else parts[0].to(dev))
        if pod_dim is None:
            return rows[mesh.local_pod_rows()[0]]
        return coll.pod_all_gather(rows, pod_dim, dev)


def _split(n: int, parts: int, what: str) -> int:
    if n % parts:
        raise ValueError(f"{what}: size {n} does not divide over "
                         f"{parts} shards")
    return n // parts


def put(tensor: torch.Tensor, sharding: Sharding) -> ShardedTensor:
    """Cut ``tensor`` into the blocks of this process's mesh positions,
    each on its position's device (a view where the device is the
    tensor's own). A split dim must divide evenly over its axis. The
    positions that take the same slice share one view (a pod-split leaf
    is one view per pod row), so a cut costs the host one narrow per
    distinct block."""
    mesh = sharding.mesh
    pm, nm = mesh.shape[POD_AXIS], mesh.shape[NODE_AXIS]
    spec = sharding.spec
    views: Dict[Tuple[int, int], torch.Tensor] = {}
    blocks = {}
    for i in mesh.local_pod_rows():
        for j in range(nm):
            at = (i if POD_AXIS in spec else -1,
                  j if NODE_AXIS in spec else -1)
            b = views.get(at)
            if b is None:
                b = tensor
                for dim, axis in enumerate(spec):
                    if axis is None:
                        continue
                    k, parts = (i, pm) if axis == POD_AXIS else (j, nm)
                    size = _split(b.shape[dim], parts,
                                  f"dim {dim} over {axis!r}")
                    b = b.narrow(dim, k * size, size)
                views[at] = b
            dev = mesh.device_of(i, j)
            blocks[(i, j)] = b if b.device == dev else b.to(dev)
    return ShardedTensor(sharding, tensor.shape, tensor.dtype, blocks,
                         source=tensor)


def _tree_map(fn, tree, shardings):
    if tree is None:
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, t, s)
                            for t, s in zip(tree, shardings)))
    return fn(tree, shardings)


def shard_features(mesh: Mesh, eb, nf, af):
    """Put one step's input trees with their canonical shardings: each
    tensor leaf becomes a ``ShardedTensor``."""
    eb_sh, nf_sh, af_sh = feature_shardings(mesh, eb, nf, af)
    return (_tree_map(put, eb, eb_sh), _tree_map(put, nf, nf_sh),
            _tree_map(put, af, af_sh))

"""The sharded scheduling step: the batched pipeline over a device mesh.

Same computation as ``ops/pipeline.build_step``, cut over the ("pod",
"node") mesh (parallel/mesh.py):

  * the cycle state once per node shard (it reads no pod row): each
    shard's node-affinity rows, and its topology tables as partial
    per-domain sums (ops/topology.topology_partials) made whole by one
    node-axis psum;
  * filters and raw scores per (pod row, node shard) block on the
    block's device; the counts psummed over the node axis; each
    scorer's row statistics (``row_stats``) combined by the node-axis
    pmax / pmin before its ``rescale`` (ops/pipeline.evaluate_shards);
  * the assignment: ``assignment="greedy"`` is the chunked-gather scan
    (parallel/sharded_assign.py, one greedy kernel launch per chunk);
    ``"auction"`` (the default here, as in the JAX package)
    gathers the (P, N) masked totals and runs the dense auction on
    them, once per gang attempt (csrc/auction.cu on a card).

Every cross-shard value goes through the mesh's collectives
(parallel/collectives.py): max and min are exact in any order, and the
sums are of integer-valued counts. So the step's ``Decision`` equals
the single-device step's (unsampled, no shortlist) in every field, bit
for bit. It is whole on the mesh's first local device, every process of
a hybrid mesh holding all of it.
"""
from __future__ import annotations

import functools

import torch

from ..encode.features import DEFAULT_ENCODING
from ..ops import prng
from ..ops.auction import auction_assign
from ..ops.gang import gang_assign
from ..ops.pipeline import build_step, evaluate_shards
from ..ops.topology import (group_assigned_match, sym_node_rows,
                            topology_partials, topology_tables)
from ..plugins.base import BatchedPlugin, PluginSet
from .mesh import (NODE_AXIS, POD_AXIS, Mesh, Sharding, ShardedTensor,
                   leaf_sharding, pod_sharding, put)
from .sharded_assign import make_sharded_assign


def _whole(leaf, device):
    return leaf.full(device) if isinstance(leaf, ShardedTensor) else \
        leaf.to(device)


def _tree(tree, fn):
    return type(tree)(*(fn(f, getattr(tree, f)) for f in tree._fields))


def _remap_claims(pf, row0: int, n: int):
    """Pod features as node shard [row0, row0 + n) sees them: a claim
    mounted on a row of this shard maps to its local row, one mounted
    elsewhere to row n, which matches no local node (the node sampler's
    rule, ops/pipeline.build_step)."""
    cr = pf.claim_rows
    local = torch.where((cr >= row0) & (cr < row0 + n), cr - row0, n)
    return pf._replace(claim_rows=torch.where(cr >= 0, local, cr))


def _check_pads(mesh: Mesh, P: int, N: int) -> None:
    pm, nm = mesh.shape[POD_AXIS], mesh.shape[NODE_AXIS]
    if P % pm or N % nm:
        raise ValueError(f"a ({pm},{nm}) mesh needs the pod pad ({P}) and "
                         f"the node pad ({N}) to divide over its axes")


def _to(value, device):
    """A cycle-state value (a tensor or a tree of them) on ``device``."""
    if isinstance(value, torch.Tensor):
        return value.to(device)
    return _tree(value, lambda f, a: a.to(device))


def _make_evaluate(plugin_set: PluginSet, mesh: Mesh):
    coll = mesh.collectives
    active = plugin_set.filter_plugins + plugin_set.score_plugins
    needs_topology = any(p.needs_topology for p in active)
    needs_node_affinity = any(p.needs_node_affinity for p in active)
    nm = mesh.shape[NODE_AXIS]

    def evaluate(eb, nf, af, explain, w_vec):
        P, N = eb.pf.valid.shape[0], nf.valid.shape[0]
        _check_pads(mesh, P, N)
        nl = N // nm
        rows = mesh.local_pod_rows()
        dev0 = mesh.device
        pf_cut = _tree(eb.pf, lambda f, a: put(a, pod_sharding(mesh)))
        nf_cut = _tree(nf, lambda f, a: put(a, leaf_sharding(mesh, f)))
        match = (group_assigned_match(eb.gf, af).to(torch.float32)
                 if needs_topology else None)
        D = max(N, DEFAULT_ENCODING.domain_buckets)

        # The cycle state reads no pod row: it is built once per node
        # shard j, on the first local pod row's device, and every pod
        # row takes it (moved only where its device differs).
        i0 = rows[0]
        col_ctx, parts = [], []
        for j in range(nm):
            dev = mesh.device_of(i0, j)
            nf_j = _tree(nf_cut, lambda f, st: st.block(i0, j))
            ctx = {"af": _to(af, dev), "gf": _to(eb.gf, dev),
                   "naf": _to(eb.naf, dev)}
            if needs_topology:
                parts.append(topology_partials(
                    nf_j, ctx["af"], ctx["gf"], D, match.to(dev),
                    row0=j * nl, n_total=N))
                if getattr(eb, "sym", None) is not None:
                    # Domain ids are global: the shard's columns read
                    # the whole table.
                    ctx["sym_rows"] = sym_node_rows(nf_j,
                                                    _to(eb.sym, dev))
            if needs_node_affinity:
                from ..plugins.nodeaffinity import (group_preferred_score,
                                                    group_required_match)

                ctx["na_req_match"] = group_required_match(ctx["naf"], nf_j)
                ctx["na_pref_score"] = group_preferred_score(ctx["naf"],
                                                             nf_j)
            col_ctx.append(ctx)
        if needs_topology:
            d0 = mesh.device_of(i0, 0)
            counts_dom = coll.node_sum([p["counts_dom"] for p in parts], d0)
            dom_exists = coll.node_sum([p["dom_count"] for p in parts],
                                       d0) > 0
            has_match = coll.node_max([p["has_match"] for p in parts], d0)
            for j in range(nm):
                dev = mesh.device_of(i0, j)
                col_ctx[j].update(topology_tables(
                    parts[j], counts_dom.to(dev), dom_exists.to(dev),
                    has_match.to(dev)))
        del parts

        def ctx_at(i, j):
            dev = mesh.device_of(i, j)
            if dev == mesh.device_of(i0, j):
                return col_ctx[j]
            return {k: _to(v, dev) for k, v in col_ctx[j].items()}

        # Filters and scores per block; the node-axis reductions inside.
        blocks, counts, rejects = {}, {}, {}
        stacks = ([], [], [])
        row_stacks = {}
        for i in rows:
            pfs = [_remap_claims(_tree(pf_cut, lambda f, st: st.block(i, j)),
                                 j * nl, nl) for j in range(nm)]
            nfs = [_tree(nf_cut, lambda f, st: st.block(i, j))
                   for j in range(nm)]
            (totals, _feas, counts[i], rejects[i],
             shard_stacks) = evaluate_shards(
                plugin_set, pfs, nfs, [ctx_at(i, j) for j in range(nm)],
                explain, w_vec, coll)
            for j in range(nm):
                blocks[(i, j)] = totals[j]
            if explain:
                row_stacks[i] = [[coll.node_all_gather(per_shard, 1, dev0)
                                  for per_shard in kind]
                                 for kind in shard_stacks]
            del totals, _feas, shard_stacks
        if explain:
            for k, out in enumerate(stacks):
                for s in range(len(row_stacks[rows[0]][k])):
                    out.append(coll.pod_all_gather(
                        {i: row_stacks[i][k][s] for i in rows}, 0, dev0))
        masked = ShardedTensor(Sharding(mesh, (POD_AXIS, NODE_AXIS)),
                               (P, N), torch.float32, blocks)
        feasible_counts = coll.pod_all_gather(counts, 0, dev0)
        reject_counts = coll.pod_all_gather(rejects, 1, dev0)

        # The whole node axis' tables the decision reads.
        ctx = {}
        if needs_topology:
            ctx["counts_node"] = coll.node_all_gather(
                [col_ctx[j]["counts_node"] for j in range(nm)], 1, dev0)
            for k in ("min_count", "counts_dom", "dom_exists"):
                ctx[k] = col_ctx[0][k].to(dev0)
        return ctx, masked, feasible_counts, reject_counts, stacks

    return evaluate


def _make_gathered_auction(mesh: Mesh):
    """The auction on a mesh: the (P, N) masked totals gathered on the
    mesh's first local device, then ``gang_assign`` over the dense
    banded auction (the auction kernel on a card), once per attempt."""

    def assign(scores, requests, free0, group_ids, group_min, key,
               has_gang=None, priority=None):
        dev = mesh.device
        whole = _whole(scores, dev)
        return gang_assign(whole, requests.to(dev), free0.to(dev),
                           group_ids.to(dev), group_min.to(dev),
                           prng.bits(key),
                           greedy_fn=functools.partial(
                               auction_assign, priority=priority.to(dev)),
                           has_gang=has_gang)

    return assign


def build_sharded_step(plugin_set: PluginSet, mesh: Mesh, eb_template=None,
                       nf_template=None, af_template=None, *,
                       explain: bool = False, assignment: str = "auction",
                       observe=None):
    """The scheduling step over ``mesh``:
    ``step(eb, nf, af, key, has_gang=None, hard_spread=None, w_vec=None)
    -> Decision``. The inputs are trees of whole tensors or of
    ``ShardedTensor`` leaves (``shard_features``); the step cuts each
    call's inputs with ``put`` (views on a virtual mesh).

    The templates, when given, are checked against the mesh: the pod
    and node pads must divide over its axes (the JAX package reads
    them for its sharding specs; here the cut needs no ranks).

    The default assignment is the banded auction (its rounds partition
    as dense math, one gather a batch); ``assignment="greedy"`` is the
    chunked-gather scan, exact sequential greedy, which the engine
    runs by default (``SchedulerConfig.assignment``). Anything else
    raises, as does a scorer that overrides ``normalize`` itself: a
    sharded row normalizes through ``row_stats`` and ``rescale``.
    ``observe`` is passed to ``make_sharded_assign``."""
    if assignment not in ("greedy", "auction"):
        raise ValueError(
            f"unknown assignment strategy {assignment!r}; "
            "expected 'greedy' or 'auction'")
    if not isinstance(mesh, Mesh):
        raise ValueError(f"build_sharded_step needs a parallel.mesh.Mesh, "
                         f"got {mesh!r}")
    for p in plugin_set.score_plugins:
        if type(p).normalize is not BatchedPlugin.normalize:
            raise ValueError(
                f"{p.name} overrides normalize: on a mesh a scorer "
                "declares row_stats and overrides rescale")
    if eb_template is not None and nf_template is not None:
        _check_pads(mesh, eb_template.pf.valid.shape[0],
                    nf_template.valid.shape[0])
    if assignment == "auction":
        assign_fn = _make_gathered_auction(mesh)
    else:
        assign_fn = make_sharded_assign(mesh, observe)
    inner = build_step(plugin_set, explain=explain, assignment=assignment,
                       assign_fn=assign_fn,
                       evaluate_fn=_make_evaluate(plugin_set, mesh))
    dev = mesh.device

    def step(eb, nf, af, key, has_gang=None, hard_spread=None, w_vec=None):
        # Whole leaves on the mesh's first local device: the replicated
        # stages read them so, and the evaluation cuts them.
        def whole(tree):
            return _tree(tree, lambda f, a: _whole(a, dev))

        eb = eb._replace(pf=whole(eb.pf), gf=whole(eb.gf),
                         naf=whole(eb.naf), gang=whole(eb.gang))
        if getattr(eb, "sym", None) is not None:
            eb = eb._replace(sym=whole(eb.sym))
        return inner(eb, whole(nf), whole(af), key, has_gang=has_gang,
                     w_vec=w_vec)

    step.mesh = mesh
    return step

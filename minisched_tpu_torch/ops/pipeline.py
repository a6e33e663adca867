"""The batched scheduling step for one profile.

    filter masks (AND over plugins) → per-plugin scores → normalize →
    weighted sum → gang-aware capacity-aware greedy assignment.

The step returns per-plugin reject counts per pod, enough to record which
plugins rejected an unschedulable pod (the reference's
UnschedulablePlugins) for event-driven requeue. Weights apply after
normalization, and NormalizeScore runs once per plugin over the whole
matrix.

The step runs eagerly on whatever device its input tensors live on; the
assignment stage goes through ``select.greedy_assign`` or, with a
shortlist, ``select.greedy_assign_shortlist``, which launch their CUDA
kernels for CUDA tensors; a batch whose hard topology spread the in-scan
domain caps enforce takes ``select.greedy_assign(caps=...)``, the caps
scan. ``assignment="auction"`` takes the banded bidding rounds instead
(``auction.auction_assign``, or with a shortlist
``bid_select.auction_assign_shortlist``). With ``sample_nodes=K`` the
step first picks K candidate nodes and runs on them alone (node-axis
sampling). In explain mode it also returns each filter's mask and each
scorer's raw and normalized matrix (the result store's input). Above a
size threshold the filters and scorers run over pod chunks, so only one
chunk's temporaries are live at a time. ``build_loop_step`` runs the
step over the device loop's ring slots, carrying ``free`` on the device
from slot to slot into one stacked decision buffer. ``build_tenant_step``
and ``build_tenant_index_step`` serve T tenants' batches of one shape
(the fused tenant round): each lane's scores land in one (T,P,N) buffer
that one selection launch and one scan launch assign, and every lane's
decision lands in one stacked buffer.
"""
from __future__ import annotations

import functools
from typing import List, NamedTuple, Optional

import torch

from ..encode.features import DEFAULT_ENCODING
from ..plugins.base import PluginSet, row_stats
from . import prng
from .auction import auction_assign
from .bid_select import auction_assign_shortlist
from .gang import gang_assign
from .select import (NEG, fma_f32, greedy_assign, greedy_assign_shortlist,
                     order_key)
from .topology import group_topology_state


class Decision(NamedTuple):
    """Output of one batched scheduling step (padded to the P/N buckets)."""

    chosen: torch.Tensor           # (P,) int32 node row, -1 unassigned
    assigned: torch.Tensor         # (P,) bool
    gang_rejected: torch.Tensor    # (P,) bool — pod's gang missed quorum
    feasible_counts: torch.Tensor  # (P,) int32 nodes passing all filters
    # Nodes passing all filters WITH the undeferred hard-spread check.
    # Where the in-scan domain caps enforce a group (ops/spreadcap.py),
    # the PodTopologySpread filter defers its static skew check to the
    # scan, so a statically over-skew pod shows feasible_counts > 0 yet
    # the scan cannot place it; this count (one extra spread-filter pass,
    # only in such batches) tells real in-batch contention (retry) from
    # a static skew block (terminal). Equal to feasible_counts elsewhere.
    feasible_static: torch.Tensor  # (P,) int32
    reject_counts: torch.Tensor    # (F,P) int32 nodes rejected per filter
    # Explain mode: the (P,N) float32 weighted sum, NEG on infeasible
    # pairs; else a (0,N) placeholder (nothing on the scheduling path
    # reads it).
    total_scores: torch.Tensor
    free_after: torch.Tensor       # (N,R) float32
    # Per-pod × per-selector-group state at the chosen node, for the
    # engine's intra-batch spread arbitration; (P,G)/(G,)/(G,D) when the
    # profile runs a topology plugin, else zero-size (as in JAX):
    spread_pre: torch.Tensor       # (P,G) float32 pre-batch count in the
    #                                chosen node's domain per group
    spread_dom: torch.Tensor       # (P,G) int32 chosen node's domain id
    #                                (-1: node lacks the key / unassigned)
    spread_min: torch.Tensor       # (G,) float32 pre-batch min over domains
    spread_cdom: torch.Tensor      # (G,D) float32 pre-batch count per domain
    spread_dexist: torch.Tensor    # (G,D) bool domain exists on some node
    # (G,) bool — the group's hard skew was enforced by the in-scan
    # domain caps this batch (False everywhere when the caps scan did
    # not run); the host arbitration skips its skew replay for these.
    scan_groups: torch.Tensor
    # Shortlist repair ledger: pods whose step fell back to a full-row
    # rescan (all False without the shortlist and on the caps scan).
    shortlist_repaired: torch.Tensor  # (P,) bool
    # Explain mode only, else zero-size placeholders:
    filter_masks: torch.Tensor     # (F,P,N) bool per-filter pass mask
    raw_scores: torch.Tensor       # (S,P,N) float32 before normalize
    norm_scores: torch.Tensor      # (S,P,N) float32 normalized, unweighted


# Pod-chunked evaluation: where the (P,N) float32 score matrix exceeds
# _CHUNK_WHEN_BYTES, the filters and scorers run over pod chunks of about
# _CHUNK_TARGET_BYTES (never fewer than _CHUNK_MIN_PODS pods), so that
# only one chunk's (C,N) temporaries are live while the (P,N) matrix
# fills. The JAX package's values; module-level so tests can force the
# chunked path at small shapes.
_CHUNK_WHEN_BYTES = 1 << 30
_CHUNK_TARGET_BYTES = 768 << 20
_CHUNK_MIN_PODS = 128


def max_normalize_100(scores: torch.Tensor,
                      feasible: torch.Tensor) -> torch.Tensor:
    """Standard k8s NormalizeScore: scale so the best feasible node gets
    100. Rows with an all-zero max pass through unchanged."""
    masked = torch.where(feasible, scores, 0.0)
    return max_rescale_100(masked, row_stats(masked, ("max",))[0])


def max_rescale_100(masked: torch.Tensor,
                    row_max: torch.Tensor) -> torch.Tensor:
    """``max_normalize_100`` of the scores ``masked`` to 0.0 where
    infeasible, given each row's max of them (plugins/base.row_stats)."""
    # A tensor numerator: ``100.0 / t`` would compute 100 * (1/t), which
    # rounds differently from the true quotient.
    hundred = torch.full_like(row_max, 100.0)
    return torch.where(row_max > 0,
                       masked * (hundred / torch.clamp_min(row_max, 1e-30)),
                       masked)


def cycle_state(plugin_set: PluginSet, eb, nf, af) -> dict:
    """The shared cycle state (the reference's CycleState) the active
    plugins ask for: the topology tables (ops/topology.py) when one
    ``needs_topology``, the node-affinity group rows when one
    ``needs_node_affinity``. Computed on the node axis given, which the
    step keeps whole even under sampling (domain counts and minima must
    be the cluster's)."""
    active = plugin_set.filter_plugins + plugin_set.score_plugins
    ctx = {"af": af, "gf": eb.gf, "naf": eb.naf}
    if any(p.needs_topology for p in active):
        num_domains = max(nf.valid.shape[0], DEFAULT_ENCODING.domain_buckets)
        ctx.update(group_topology_state(nf, af, eb.gf, num_domains))
    if any(p.needs_node_affinity for p in active):
        from ..plugins.nodeaffinity import (group_preferred_score,
                                            group_required_match)

        ctx["na_req_match"] = group_required_match(eb.naf, nf)
        ctx["na_pref_score"] = group_preferred_score(eb.naf, nf)
    return ctx


def _evaluate(plugin_set: PluginSet, pf, nf, ctx, explain: bool = False,
              w_vec=None):
    """Filters and scores of one batch: ``(masked_total, feasible (P,N)
    bool, feasible_counts, reject_counts, (masks, raws, norms))``; the
    three lists hold each filter's mask and each scorer's raw and
    normalized matrix under ``explain``, and are empty otherwise.
    ``w_vec`` (S,) float32 on the host, one weight per scorer, replaces
    the profile's weights (a tenant lane's own); multiplying by equal
    float32 values gives equal bits, so a profile's own weights give the
    same totals either way."""
    (totals, feas, feasible_counts, reject_counts,
     (masks, raws, norms)) = evaluate_shards(plugin_set, [pf], [nf], [ctx],
                                             explain, w_vec)
    return (totals[0], feas[0], feasible_counts, reject_counts,
            ([m[0] for m in masks], [r[0] for r in raws],
             [n[0] for n in norms]))


def evaluate_shards(plugin_set: PluginSet, pfs, nfs, ctxs,
                    explain: bool = False, w_vec=None, collectives=None):
    """Filters and scores of one pod row against J node shards:
    ``pfs[j]``, ``nfs[j]`` and ``ctxs[j]`` are shard j's inputs, on its
    device. Returns ``(masked totals [J], feasible [J], feasible_counts
    (P,), reject_counts (F,P), (masks, raws, norms))``, the counts
    summed over the shards on shard 0's device and each explain list
    holding one per-shard list per plugin.

    With J > 1 the node-axis reductions go through ``collectives``
    (parallel/collectives.py): the counts' psum, and each scorer's row
    statistics' pmax / pmin (``_normalize_shards``). One shard is the
    single-device evaluation."""
    J = len(nfs)
    dev0 = pfs[0].valid.device

    def node_sum(parts):
        return parts[0] if J == 1 else collectives.node_sum(parts, dev0)

    valid_pair = [pfs[j].valid[:, None] & nfs[j].valid[None, :]
                  for j in range(J)]
    # One pass over filters: each (P,N) mask contributes its reject count
    # and the running AND, then dies (outside explain mode no list holds
    # all F masks at once).
    feasible = list(valid_pair)
    rc: List[torch.Tensor] = []
    masks: List[List[torch.Tensor]] = []
    raws: List[List[torch.Tensor]] = []
    norms: List[List[torch.Tensor]] = []
    for p in plugin_set.filter_plugins:
        ms = [p.filter(pfs[j], nfs[j], ctxs[j]) for j in range(J)]
        rc.append(node_sum([(valid_pair[j] & ~ms[j]).sum(dim=1)
                            for j in range(J)]).to(torch.int32))
        feasible = [feasible[j] & ms[j] for j in range(J)]
        if explain:
            masks.append(ms)
        del ms
    feasible_counts = node_sum([f.sum(dim=1) for f in feasible]).to(
        torch.int32)
    P = pfs[0].valid.shape[0]
    reject_counts = (torch.stack(rc) if rc else torch.zeros(
        (0, P), dtype=torch.int32, device=dev0))
    del valid_pair

    totals = [torch.zeros(f.shape, dtype=torch.float32, device=f.device)
              for f in feasible]
    for i, p in enumerate(plugin_set.score_plugins):
        raw = [p.score(pfs[j], nfs[j], ctxs[j]).to(torch.float32)
               for j in range(J)]
        norm = _normalize_shards(p, raw, feasible, collectives)
        w = plugin_set.weight_of(p) if w_vec is None else float(w_vec[i])
        totals = [totals[j] + w * norm[j] for j in range(J)]
        if explain:
            raws.append(raw)
            norms.append(norm)
        del raw, norm
    return ([torch.where(feasible[j], totals[j], NEG) for j in range(J)],
            feasible, feasible_counts, reject_counts, (masks, raws, norms))


def _normalize_shards(p, raws, feasible, collectives):
    """Scorer ``p``'s normalize on each node shard of a pod row. One
    shard is ``p.normalize``. Across J shards each shard takes its row
    statistics (``p.row_stats``) over its own columns, the node axis
    combines them (pmax / pmin, exact), and each shard rescales with
    the combined values."""
    J = len(raws)
    if J == 1:
        return [p.normalize(raws[0], feasible[0]).to(torch.float32)]
    if not p.row_stats:
        return [p.rescale(raws[j], None, []).to(torch.float32)
                for j in range(J)]
    masked = [torch.where(feasible[j], raws[j], 0.0) for j in range(J)]
    local = [row_stats(m, p.row_stats) for m in masked]
    dev0 = raws[0].device
    combined = [(collectives.node_max if op == "max" else
                 collectives.node_min)([local[j][k] for j in range(J)], dev0)
                for k, op in enumerate(p.row_stats)]
    del local
    return [p.rescale(raws[j], masked[j],
                      [c.to(raws[j].device) for c in combined]
                      ).to(torch.float32) for j in range(J)]


def _chunk_pods(P: int, N: int) -> Optional[int]:
    """The pod-chunk size C for a (P,N) evaluation, or None when the
    batch is evaluated whole. C = P halved through even values while
    above _CHUNK_MIN_PODS and C x N x 4 bytes exceeds
    _CHUNK_TARGET_BYTES, so C divides P."""
    if P * N * 4 <= _CHUNK_WHEN_BYTES:
        return None
    C = P
    while (C > _CHUNK_MIN_PODS and C % 2 == 0
           and C * N * 4 > _CHUNK_TARGET_BYTES):
        C //= 2
    return C


def _pod_rows(pf, start: int, stop: int):
    """PodFeatures restricted to pod rows [start, stop) (every leaf leads
    with P)."""
    return pf._replace(**{f: getattr(pf, f)[start:stop]
                          for f in pf._fields})


def _evaluate_chunks(plugin_set: PluginSet, pf, nf, ctx, w_vec,
                     out: torch.Tensor, C: int, static_counts=None):
    """Filters and scores of pods ``pf`` in chunks of C rows, each
    chunk's masked total written into its rows of ``out`` (P,N): the
    step's evaluation past ``_CHUNK_WHEN_BYTES`` and each tenant lane's.
    ``static_counts(feasible, pf_rows)``, when given, fills the third
    result. Returns (feasible_counts (P,), reject_counts (F,P),
    feasible_static (P,) or None)."""
    P = out.shape[0]
    dev = out.device
    feasible_counts = torch.empty((P,), dtype=torch.int32, device=dev)
    reject_counts = torch.empty((len(plugin_set.filter_plugins), P),
                                dtype=torch.int32, device=dev)
    feasible_static = (None if static_counts is None else
                       torch.empty((P,), dtype=torch.int32, device=dev))
    for start in range(0, P, C):
        rows = slice(start, start + C)
        pf_c = pf if C >= P else _pod_rows(pf, start, start + C)
        mt, feasible, fc, rc, _ = _evaluate(plugin_set, pf_c, nf, ctx,
                                            w_vec=w_vec)
        out[rows] = mt
        feasible_counts[rows] = fc
        reject_counts[:, rows] = rc
        if feasible_static is not None:
            feasible_static[rows] = static_counts(feasible, pf_c)
        del mt, feasible, fc, rc
    return feasible_counts, reject_counts, feasible_static


def evaluate(plugin_set: PluginSet, eb, nf, af):
    """Filters and scores of one batch against every node:
    ``(masked_total (P,N) float32 with NEG on infeasible pairs,
    feasible_counts (P,) int32, reject_counts (F,P) int32)``."""
    ctx = cycle_state(plugin_set, eb, nf, af)
    total, _feasible, counts, rejects, _ = _evaluate(plugin_set, eb.pf, nf,
                                                    ctx)
    return total, counts, rejects


def _sample_proxy(nf, key) -> torch.Tensor:
    """The node sample's ranking value per node row: a cheap
    LeastAllocated-flavoured proxy (mean free fraction over the resource
    axes) plus uniform jitter in [0, 0.05) drawn with ``key``, and -inf
    on unschedulable and padded rows.

    It is the JAX package's value on XLA's CPU backend bit for bit: the
    columns summed left to right, then ``fma(sum, float32(1/R), jitter)``
    (XLA contracts the mean's multiply and the jitter's add into one
    fused multiply-add). ``torch.mean``, ``torch.sum`` and an unfused
    multiply-add all round differently, and a one-ulp difference
    reorders the sample and every placement after it."""
    frac = (torch.clamp_min(nf.free, 0.0)
            / torch.clamp_min(nf.allocatable, 1e-9))
    acc = frac[:, 0]
    for j in range(1, frac.shape[1]):
        acc = acc + frac[:, j]
    # torch.full fills on the device; torch.tensor would copy from the
    # host and make the step wait for the card.
    inv_r = torch.full((), 1.0 / frac.shape[1], dtype=torch.float32,
                       device=frac.device)
    noise = prng.uniform(key, acc.shape[0], 0.05, device=frac.device)
    ok = nf.valid & ~nf.unschedulable
    return torch.where(ok, fma_f32(acc, inv_r, noise), float("-inf"))


def _select_node_sample(nf, key, k: int) -> torch.Tensor:
    """The K candidate node rows of a sampled step: the top K of
    ``_sample_proxy`` in ``lax.top_k``'s order (value descending, lowest
    row first on ties, the -inf rows of unschedulable and padded nodes
    included). The sample's column order is read by later tie-breaks."""
    v = _sample_proxy(nf, key)
    # A unique int64 key: the value's total order above, the row's
    # complement below, so ties go to the lowest row.
    rows = torch.arange(v.shape[0], dtype=torch.int64, device=v.device)
    key64 = order_key(v).to(torch.int64) * (1 << 32) + (0xFFFFFFFF - rows)
    return torch.topk(key64, k).indices


def _gather_nodes(nf, idx: torch.Tensor):
    """NodeFeatures restricted to rows ``idx`` (topo_domains' node axis
    is axis 1; every other leaf leads with N). Domain ids are not
    remapped: they stay global."""
    return nf._replace(
        topo_domains=nf.topo_domains[:, idx],
        **{f: getattr(nf, f)[idx]
           for f in nf._fields if f != "topo_domains"})


def build_step(plugin_set: PluginSet, shortlist: Optional[int] = None,
               sample_nodes: Optional[int] = None,
               assignment: str = "greedy", explain: bool = False,
               assign_fn=None, evaluate_fn=None):
    """The scheduling step for a plugin profile:
    ``step(eb, nf, af, key, has_gang=None, hard_spread=None, w_vec=None)
    -> Decision`` where ``eb`` is an EncodedBatch, ``nf`` the
    NodeFeatures and ``af`` the AssignedPodFeatures, all as tensors on
    one device (encode.to_torch), and ``key`` the batch's PRNG key
    (ops/prng). ``w_vec`` (S,) float32 on the host replaces the scorers'
    weights (ops/pipeline._evaluate); None keeps the profile's.

    ``shortlist=K`` (K >= 1) assigns with the shortlist-compressed scan
    (select.greedy_assign_shortlist, K clamped to the node pad); None or
    K < 1 keeps the full greedy assignment. Decisions are bit-identical
    either way; only ``shortlist_repaired`` tells them apart.

    ``assignment="auction"`` assigns with the priority-banded bidding
    rounds (auction.auction_assign with the batch's priorities), through
    the bid shortlist (bid_select.auction_assign_shortlist at K clamped
    to the step's node axis) when ``shortlist`` is given; "greedy" is the
    default, and anything else raises.

    ``sample_nodes=K`` (K < the node pad) evaluates the batch against K
    candidate nodes (_select_node_sample, drawn with the second half of
    ``split(key)``; the first half breaks the step's ties). The topology
    and node-affinity state is computed on the full node axis first and
    its per-node tables gathered. A volume claim mounted on a node
    outside the sample maps to row K, which matches no node. Outputs are
    remapped to global node rows and ``free_after`` is returned
    full-size, a new tensor (the input ``free`` may be the engine's
    carried device state). A pod with no feasible node in the sample
    must be re-evaluated against the full axis before it is declared
    unschedulable (the engine's residual pass).

    Hard topology spread: an unsampled greedy step of a profile with a
    topology plugin builds the in-scan domain caps (ops/spreadcap.py).
    Where they enforce a slot (``caps.any_enforced``) the assignment is
    the caps scan (select.greedy_assign with ``caps``, the caps kernel on
    a card) instead of the shortlist scan or the greedy kernel: the JAX
    package's
    ``lax.cond``. PyTorch has no branch on the device, so the host
    decides. ``hard_spread`` is what the caller knows of the batch on
    the host: False (no DoNotSchedule slot on a live pod, so no slot can
    be enforced) skips the caps without reading the card; True or None
    builds them and reads ``any_enforced`` once, the step's one wait on
    the card in such a batch. Under the auction the caps never run (only
    the greedy scan carries running counts): a hard-spread batch keeps
    the static filter and the engine's arbitration. ``has_gang=False``
    likewise lets the gang admission skip its read (ops/gang.py).

    ``explain=True`` also returns ``total_scores`` (P,N) and the
    per-plugin stacks ``filter_masks`` (F,P,N), ``raw_scores`` and
    ``norm_scores`` (S,P,N); otherwise they are zero-size placeholders.
    The caps never run under explain (the recorded spread verdict is
    upstream's static one), and it cannot be combined with
    ``sample_nodes`` (the recorded columns must be the full node table).

    Pod chunks: outside explain mode, a batch whose (P,N) float32
    matrix exceeds ``_CHUNK_WHEN_BYTES`` is filtered and scored over
    pod chunks (``_chunk_pods``); each chunk's rows are written into
    preallocated (P,N), (P,) and (F,P) outputs, and the undeferred
    spread pass of ``feasible_static`` runs per chunk. Every plugin op
    is row-wise, so the result equals the unchunked one.

    ``assign_fn(masked_total, requests, free0, group_ids, group_min,
    key, has_gang=None, priority=None) -> GangResult`` replaces the
    whole assignment stage (``build_sharded_step``'s chunked-gather scan,
    parallel/sharded_assign.py, or its gathered auction). A custom
    stage keeps full (P,N) rows, so it
    takes no node sampling, no shortlist and no in-scan caps (the
    host arbitration alone enforces hard spread), and the batch is
    evaluated whole. ``evaluate_fn(eb, nf, af, explain, w_vec) -> (ctx,
    masked_total, feasible_counts, reject_counts, (masks, raws,
    norms))`` replaces the evaluation: ``build_sharded_step``'s per-shard
    filters and scores (parallel/sharded.py), whose ``masked_total`` is
    a ``ShardedTensor`` the ``assign_fn`` reads block by block and
    whose ``ctx`` holds the whole node axis' topology tables."""
    if assignment not in ("greedy", "auction"):
        raise ValueError(f"unknown assignment strategy {assignment!r}; "
                         "expected 'greedy' or 'auction'")
    if sample_nodes is not None and (explain or assign_fn is not None):
        raise ValueError(
            "sample_nodes is incompatible with explain mode / assign_fn")
    if shortlist is not None and shortlist < 1:
        shortlist = None
    if shortlist is not None and assign_fn is not None:
        # A custom stage keeps full (P,N) rows: a silently ignored knob
        # would let a config claim shortlist numbers it never ran.
        raise ValueError(
            "shortlist compression applies to the built-in assignments "
            "only (a custom assign_fn keeps full rows)")
    if evaluate_fn is not None and assign_fn is None:
        raise ValueError("evaluate_fn needs an assign_fn that reads its "
                         "masked_total")
    base_fn = greedy_assign
    if shortlist is not None:
        base_fn = functools.partial(greedy_assign_shortlist, k=shortlist)
    active = plugin_set.filter_plugins + plugin_set.score_plugins
    needs_topology = any(p.needs_topology for p in active)
    spread_plugin = next((f for f in plugin_set.filter_plugins
                          if f.name == "PodTopologySpread"), None)

    def step(eb, nf, af, key, has_gang: Optional[bool] = None,
             hard_spread: Optional[bool] = None, w_vec=None) -> Decision:
        if evaluate_fn is not None:
            return _finish(*evaluate_fn(eb, nf, af, explain, w_vec),
                           eb=eb, nf=nf, key=key, has_gang=has_gang)
        n = nf.valid.shape[0]
        ctx = cycle_state(plugin_set, eb, nf, af)
        sample_idx = None
        N = n
        if sample_nodes is not None and sample_nodes < n:
            key, skey = prng.split(key)
            sample_idx = _select_node_sample(nf, skey, sample_nodes)
            inv = torch.full((n,), sample_nodes, dtype=torch.int32,
                             device=sample_idx.device)
            inv[sample_idx] = torch.arange(sample_nodes, dtype=torch.int32,
                                           device=sample_idx.device)
            cr = eb.pf.claim_rows
            eb = eb._replace(pf=eb.pf._replace(claim_rows=torch.where(
                cr >= 0, inv[torch.clamp(cr, 0, n - 1).long()], cr)))
            free_full = nf.free
            nf = _gather_nodes(nf, sample_idx)
            for k2 in ("counts_node", "dom_valid", "na_req_match",
                       "na_pref_score"):
                if k2 in ctx:
                    ctx[k2] = ctx[k2][:, sample_idx]
            N = sample_nodes
        pf = eb.pf

        # In-scan hard-spread enforcement: unsampled steps only (a
        # sampled running min would cover the sampled nodes' domains
        # alone, while the filter's global-min check stands down).
        caps, enforced = None, False
        if (needs_topology and sample_idx is None and assignment == "greedy"
                and assign_fn is None and hard_spread is not False
                and not explain):
            from .spreadcap import build_domain_caps

            caps = build_domain_caps(pf, eb.gf, nf, ctx["counts_dom"],
                                     ctx["dom_exists"])
            enforced = bool(caps.any_enforced)  # the one read of the card
            if enforced:
                ctx["spread_scan_groups"] = caps.scan_groups

        ctx_static = None
        if enforced and spread_plugin is not None:
            # The undeferred spread verdict, for the engine's terminal-
            # versus-contention classification.
            ctx_static = dict(ctx)
            ctx_static.pop("spread_scan_groups")

        def static_counts(feasible, pf_rows):
            if ctx_static is None:
                return None
            m_static = spread_plugin.filter(pf_rows, nf, ctx_static)
            return (feasible & m_static).sum(dim=1).to(torch.int32)

        P = pf.valid.shape[0]
        C = None if explain or assign_fn is not None else _chunk_pods(P, N)
        if C is None:
            (masked_total, feasible, feasible_counts, reject_counts,
             (masks, raws, norms)) = _evaluate(plugin_set, pf, nf, ctx,
                                               explain, w_vec)
            feasible_static = static_counts(feasible, pf)
            del feasible
        else:
            masked_total = torch.empty((P, N), dtype=torch.float32,
                                       device=pf.valid.device)
            feasible_counts, reject_counts, feasible_static = (
                _evaluate_chunks(plugin_set, pf, nf, ctx, w_vec,
                                 masked_total, C,
                                 None if ctx_static is None
                                 else static_counts))
            masks, raws, norms = [], [], []
        if feasible_static is None:
            feasible_static = feasible_counts
        if assign_fn is not None:
            return _finish(ctx, masked_total, feasible_counts,
                           reject_counts, (masks, raws, norms), eb=eb,
                           nf=nf, key=key, has_gang=has_gang)
        if assignment == "auction":
            greedy_fn = (functools.partial(auction_assign,
                                           priority=pf.priority)
                         if shortlist is None else
                         functools.partial(auction_assign_shortlist,
                                           priority=pf.priority,
                                           k=min(shortlist, N)))
        elif enforced:
            greedy_fn = functools.partial(greedy_assign, caps=caps)
        else:
            greedy_fn = base_fn
        assign = gang_assign(masked_total, pf.requests, nf.free,
                             eb.gang.group, eb.gang.min_count,
                             prng.bits(key), greedy_fn=greedy_fn,
                             has_gang=has_gang)

        chosen, free_after = assign.chosen, assign.free_after
        if sample_idx is not None:
            safe = torch.clamp(chosen, 0, sample_nodes - 1).long()
            chosen = torch.where(assign.assigned,
                                 sample_idx[safe].to(torch.int32), chosen)
            free_after = free_full.index_copy(0, sample_idx, free_after)
        return _decision(ctx, assign, chosen, free_after, eb, nf,
                         masked_total, feasible_counts, feasible_static,
                         reject_counts, (masks, raws, norms),
                         caps.scan_groups if enforced else None)

    def _finish(ctx, masked_total, feasible_counts, reject_counts,
                stacks, *, eb, nf, key, has_gang):
        """The step after a custom evaluation or assignment stage:
        ``assign_fn`` on the masked totals, then the decision (no caps,
        no sample: every table is the whole node axis')."""
        pf = eb.pf
        assign = assign_fn(masked_total, pf.requests, nf.free,
                           eb.gang.group, eb.gang.min_count, key,
                           has_gang=has_gang, priority=pf.priority)
        return _decision(ctx, assign, assign.chosen, assign.free_after, eb,
                         nf, masked_total, feasible_counts, feasible_counts,
                         reject_counts, stacks, None)

    def _decision(ctx, assign, chosen, free_after, eb, nf, masked_total,
                  feasible_counts, feasible_static, reject_counts, stacks,
                  scan_groups) -> Decision:
        # Spread-arbitration inputs, per (pod, group) at the chosen node.
        gf = eb.gf
        G = gf.valid.shape[0]
        P = eb.pf.valid.shape[0]
        N = assign.free_after.shape[0]
        dev = assign.chosen.device
        if scan_groups is None:
            scan_groups = torch.zeros((G,), dtype=torch.bool, device=dev)
        if needs_topology:
            safe_row = torch.clamp(assign.chosen, 0, N - 1).long()
            live = assign.assigned[:, None] & gf.valid[None, :]
            spread_pre = torch.where(
                live, ctx["counts_node"][:, safe_row].T, 0.0)
            gkey = torch.clamp(gf.key_idx, 0,
                               nf.topo_domains.shape[0] - 1).long()
            spread_dom = torch.where(
                live, nf.topo_domains[gkey][:, safe_row].T, -1)
            spread_min = ctx["min_count"]
            spread_cdom = ctx["counts_dom"]
            spread_dexist = ctx["dom_exists"]
        else:
            spread_pre = torch.zeros((0, G), dtype=torch.float32, device=dev)
            spread_dom = torch.full((0, G), -1, dtype=torch.int32,
                                    device=dev)
            spread_min = torch.zeros((0,), dtype=torch.float32, device=dev)
            spread_cdom = torch.zeros((0, 0), dtype=torch.float32,
                                      device=dev)
            spread_dexist = torch.zeros((0, 0), dtype=torch.bool, device=dev)

        # The explain stacks (the lists are empty outside explain mode:
        # zero-size placeholders, as in JAX).
        masks, raws, norms = stacks

        def stack(parts, dtype):
            return (torch.stack(parts) if parts else
                    torch.zeros((0, P, N), dtype=dtype, device=dev))

        if not explain:
            total_scores = torch.zeros((0, N), dtype=torch.float32,
                                       device=dev)
        elif isinstance(masked_total, torch.Tensor):
            total_scores = masked_total
        else:
            total_scores = masked_total.full()
        return Decision(
            chosen=chosen,
            assigned=assign.assigned,
            gang_rejected=assign.gang_rejected,
            feasible_counts=feasible_counts,
            feasible_static=feasible_static,
            reject_counts=reject_counts,
            total_scores=total_scores,
            free_after=free_after,
            spread_pre=spread_pre,
            spread_dom=spread_dom,
            spread_min=spread_min,
            spread_cdom=spread_cdom,
            spread_dexist=spread_dexist,
            scan_groups=scan_groups,
            shortlist_repaired=assign.repaired,
            filter_masks=stack(masks, torch.bool),
            raw_scores=stack(raws, torch.float32),
            norm_scores=stack(norms, torch.float32),
        )

    return step


def build_loop_step(plugin_set: PluginSet, *, assignment: str = "greedy",
                    shortlist: Optional[int] = None, slim: bool = True):
    """The device loop's tranche runner:
    ``loop(slot_ebs, nf, af, slot_seeds) -> (packed_stack, free_final)``.

    ``slot_ebs`` are D EncodedBatches on the step's device, all at one
    pod pad, ``nf``/``af`` shared by the tranche, and ``slot_seeds`` the
    D PRNG keys each slot would draw on the per-batch path (the engine's
    ``fold_in(base_key, counter)``, computed on the host with ops/prng).
    Each slot runs ``build_step``'s step, in order; slot k+1's
    ``nf.free`` is slot k's ``free_after``, the device tensor itself.
    Each slot's packed decision (``pack_decision_slim``, or
    ``pack_decision_i32`` with ``slim=False``) is written into row k of
    one preallocated (D, ...) device buffer, so the host reads the whole
    tranche back with one copy; ``free_final`` is the last slot's
    ``free_after``.

    The ring carries loop-safe batches only (the engine stages no gang,
    no spread constraint, no host port): each slot runs with
    ``has_gang=False, hard_spread=False``, so no slot waits on the card
    between the first launch and the stacked read back. ``used_ports``
    is shared, not carried (no slot inserts a port). Both assignments
    ride the ring: the auction's slot k+1 starts its prices fresh while
    its ``free`` is slot k's ``free_after``."""
    if assignment not in ("greedy", "auction"):
        raise ValueError(f"unknown assignment strategy {assignment!r}; "
                         "expected 'greedy' or 'auction'")
    if shortlist is not None and shortlist < 1:
        shortlist = None
    step = build_step(plugin_set, shortlist=shortlist, assignment=assignment)
    from .residency import (pack_decision_i32, pack_decision_slim,
                            slim_buffer_bytes)

    pack = pack_decision_slim if slim else pack_decision_i32
    n_filters = len(plugin_set.filter_plugins)

    def loop(slot_ebs, nf, af, slot_seeds):
        P = slot_ebs[0].pf.valid.shape[0]
        row = ((slim_buffer_bytes(P, n_filters),) if slim
               else (6 + n_filters, P))
        out = torch.empty((len(slot_ebs),) + row,
                          dtype=torch.uint8 if slim else torch.int32,
                          device=nf.valid.device)
        free = nf.free
        for j, (eb, key) in enumerate(zip(slot_ebs, slot_seeds)):
            d = step(eb, nf._replace(free=free), af, key, has_gang=False,
                     hard_spread=False)
            out[j] = pack(d.chosen, d.assigned, d.gang_rejected,
                          d.feasible_counts, d.feasible_static,
                          d.reject_counts, d.shortlist_repaired)
            free = d.free_after
        return out, free

    return loop


_TENANT_CACHE: dict = {}


def build_tenant_step(plugin_set: PluginSet, *,
                      shortlist: Optional[int] = None):
    """The fused multi-tenant step: ``tenant_step(ebs, nfs, afs, keys,
    w_stack) -> (packed_stack, free_stack)`` serves T tenants' batches
    (lanes) of one shape in one call.

    ``ebs`` / ``afs`` are the T lanes' EncodedBatch and
    AssignedPodFeatures on one device, all at one pod pad; ``nfs`` their
    NodeFeatures, of which only lane 0's static leaves are read (the
    mux groups only lanes whose static node encodings are equal, so they
    are broadcast) and every lane's own dynamic ``free`` / ``used_ports``;
    ``keys`` the lanes' PRNG keys and ``w_stack`` the (T,S) float32
    host matrix of their scorer weights (the ``w_vec`` seam: lanes whose
    weights differ share this one step, memoized without weights).

    Each lane's filters and scores are evaluated in turn into one
    (T,P,N) buffer; then one selection launch and one scan launch assign
    every lane (select.greedy_assign_shortlist_lanes; with the shortlist
    off, the greedy kernel once per lane). Each lane's decision is
    packed with ``pack_decision_i32`` into row t of one (T,6+F,P) int32
    buffer, so the host reads the group back in one copy; ``free_stack``
    is the (T,N,R) free after every lane. Lane t's outputs equal the
    per-batch step's on lane t's inputs and key, bit for bit (the JAX
    package's ``jax.vmap`` of its raw step).

    Greedy only, no explain and no node sampling, as in the JAX package;
    and the lanes are ring-safe batches (the engine submits no gang, no
    spread constraint, no host port), so the gang admission and the
    domain caps have nothing to do: ``gang_rejected`` is all False and
    ``feasible_static`` equals ``feasible_counts``."""
    if shortlist is not None and shortlist < 1:
        shortlist = None
    cache_key = (tuple(p.trace_key() for p in plugin_set.filter_plugins),
                 tuple(p.trace_key() for p in plugin_set.score_plugins),
                 shortlist)
    cached = _TENANT_CACHE.get(cache_key)
    if cached is not None:
        return cached
    from .residency import pack_decision_i32
    from .select import greedy_assign_shortlist_lanes

    n_filters = len(plugin_set.filter_plugins)

    def tenant_step(ebs, nfs, afs, keys, w_stack):
        T = len(ebs)
        nf0 = nfs[0]
        P = ebs[0].pf.valid.shape[0]
        N = nf0.valid.shape[0]
        dev = nf0.valid.device
        scores = torch.empty((T, P, N), dtype=torch.float32, device=dev)
        planes = []
        for t in range(T):
            nf_t = nf0._replace(free=nfs[t].free,
                                used_ports=nfs[t].used_ports)
            ctx = cycle_state(plugin_set, ebs[t], nf_t, afs[t])
            planes.append(_evaluate_chunks(
                plugin_set, ebs[t].pf, nf_t, ctx, w_stack[t], scores[t],
                _chunk_pods(P, N) or P)[:2])
        requests = torch.stack([eb.pf.requests for eb in ebs])
        free0 = torch.stack([nf.free for nf in nfs])
        seeds = [prng.bits(key) for key in keys]
        if shortlist is not None:
            r = greedy_assign_shortlist_lanes(scores, requests, free0,
                                              seeds, k=shortlist)
            chosen, assigned, free_after, repaired = r
        else:
            rs = [greedy_assign(scores[t], requests[t], free0[t], seeds[t])
                  for t in range(T)]
            chosen = torch.stack([r.chosen for r in rs])
            assigned = torch.stack([r.assigned for r in rs])
            free_after = torch.stack([r.free_after for r in rs])
            repaired = torch.zeros_like(assigned)
        del scores
        packed = torch.empty((T, 6 + n_filters, P), dtype=torch.int32,
                             device=dev)
        no_gang = torch.zeros((P,), dtype=torch.bool, device=dev)
        for t, (counts, rejects) in enumerate(planes):
            packed[t] = pack_decision_i32(chosen[t], assigned[t], no_gang,
                                          counts, counts, rejects,
                                          repaired[t])
        return packed, free_after

    _TENANT_CACHE[cache_key] = tenant_step
    return tenant_step


_TENANT_INDEX_CACHE: dict = {}


def build_tenant_index_step(k_eff: int):
    """The fused indexed tenant step: ``tenant_index_step(slabs, cls,
    valid, requests, free0, keys) -> (packed_stack, free_after_stack)``
    serves T index-eligible lanes from their maintained index slabs with
    no plugin evaluation.

    ``slabs`` are the lanes' (C,N) ``IndexState.score`` matrices (one C
    and N across a group: the mux's group key pins them), ``cls`` the
    lanes' (P,) class rows on the device, and ``valid`` / ``requests`` /
    ``free0`` / ``keys`` the per-lane inputs the solo ``ops/index``
    assign takes. Each lane's class rows, masked by ``valid``, are
    gathered straight into one (T,P,N) buffer (no slab is copied whole);
    then one selection launch and one scan launch at ``k = min(k_eff,
    N)`` assign every lane. Row t of the (T, 4P + 2*ceil(P/8)) uint8
    ``packed_stack`` is exactly the solo assign's buffer [chosen i32 × P
    | assigned bits | repaired bits], so ``ops/index.unpack_index_decision``
    reads a stacked fetch row by row. Memoized on ``k_eff`` alone."""
    if k_eff < 1:
        raise ValueError(f"index scan width {k_eff} must be >= 1")
    cached = _TENANT_INDEX_CACHE.get(k_eff)
    if cached is not None:
        return cached
    from .residency import _bytes_of, _packbits
    from .select import greedy_assign_shortlist_lanes

    def tenant_index_step(slabs, cls, valid, requests, free0, keys):
        T = len(slabs)
        P = valid[0].shape[0]
        N = slabs[0].shape[1]
        dev = slabs[0].device
        scores = torch.empty((T, P, N), dtype=torch.float32, device=dev)
        for t in range(T):
            torch.index_select(slabs[t], 0, cls[t].long(), out=scores[t])
            scores[t].masked_fill_(~valid[t][:, None], NEG)
        free0 = torch.stack(list(free0))
        r = greedy_assign_shortlist_lanes(
            scores, torch.stack(list(requests)), free0,
            [prng.bits(key) for key in keys], k=min(k_eff, N))
        del scores
        packed = torch.stack([
            torch.cat([_bytes_of(r.chosen[t].to(torch.int32)),
                       _packbits(r.assigned[t]), _packbits(r.repaired[t])])
            for t in range(T)])
        return packed, r.free_after

    _TENANT_INDEX_CACHE[k_eff] = tenant_index_step
    return tenant_index_step

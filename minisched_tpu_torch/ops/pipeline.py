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
kernels for CUDA tensors.
"""
from __future__ import annotations

import functools
from typing import List, NamedTuple, Optional

import torch

from ..plugins.base import PluginSet
from . import prng
from .gang import gang_assign
from .select import NEG, greedy_assign, greedy_assign_shortlist


class Decision(NamedTuple):
    """Output of one batched scheduling step (padded to the P/N buckets)."""

    chosen: torch.Tensor           # (P,) int32 node row, -1 unassigned
    assigned: torch.Tensor         # (P,) bool
    gang_rejected: torch.Tensor    # (P,) bool — pod's gang missed quorum
    feasible_counts: torch.Tensor  # (P,) int32 nodes passing all filters
    # Nodes passing all filters with the undeferred hard-spread check;
    # equal to feasible_counts in this package (no in-scan spread caps).
    feasible_static: torch.Tensor  # (P,) int32
    reject_counts: torch.Tensor    # (F,P) int32 nodes rejected per filter
    free_after: torch.Tensor       # (N,R) float32
    # Shortlist repair ledger: pods whose step fell back to a full-row
    # rescan (all False without the shortlist).
    shortlist_repaired: torch.Tensor  # (P,) bool


def max_normalize_100(scores: torch.Tensor,
                      feasible: torch.Tensor) -> torch.Tensor:
    """Standard k8s NormalizeScore: scale so the best feasible node gets
    100. Rows with an all-zero max pass through unchanged."""
    masked = torch.where(feasible, scores, 0.0)
    row_max = masked.max(dim=1, keepdim=True).values
    # A tensor numerator: ``100.0 / t`` would compute 100 * (1/t), which
    # rounds differently from the true quotient.
    hundred = torch.full_like(row_max, 100.0)
    return torch.where(row_max > 0,
                       masked * (hundred / torch.clamp_min(row_max, 1e-30)),
                       masked)


def evaluate(plugin_set: PluginSet, eb, nf, af):
    """Filters and scores of one batch against every node:
    ``(masked_total (P,N) float32 with NEG on infeasible pairs,
    feasible_counts (P,) int32, reject_counts (F,P) int32)``."""
    pf = eb.pf
    P = pf.valid.shape[0]
    ctx = {"af": af, "gf": eb.gf, "naf": eb.naf}
    valid_pair = pf.valid[:, None] & nf.valid[None, :]
    # One pass over filters: each (P,N) mask contributes its reject count
    # and the running AND, then dies.
    feasible = valid_pair
    rc: List[torch.Tensor] = []
    for p in plugin_set.filter_plugins:
        m = p.filter(pf, nf, ctx)
        rc.append((valid_pair & ~m).sum(dim=1).to(torch.int32))
        feasible = feasible & m
    feasible_counts = feasible.sum(dim=1).to(torch.int32)
    reject_counts = (torch.stack(rc) if rc else torch.zeros(
        (0, P), dtype=torch.int32, device=feasible.device))
    del valid_pair

    total = torch.zeros(feasible.shape, dtype=torch.float32,
                        device=feasible.device)
    for p in plugin_set.score_plugins:
        raw = p.score(pf, nf, ctx).to(torch.float32)
        norm = p.normalize(raw, feasible).to(torch.float32)
        total = total + plugin_set.weight_of(p) * norm
    return torch.where(feasible, total, NEG), feasible_counts, reject_counts


def build_step(plugin_set: PluginSet, shortlist: Optional[int] = None):
    """The scheduling step for a plugin profile:
    ``step(eb, nf, af, key) -> Decision`` where ``eb`` is an EncodedBatch,
    ``nf`` the NodeFeatures and ``af`` the AssignedPodFeatures, all as
    tensors on one device (encode.to_torch), and ``key`` the batch's
    PRNG key (ops/prng).

    ``shortlist=K`` (K >= 1) assigns with the shortlist-compressed scan
    (select.greedy_assign_shortlist, K clamped to the node pad); None or
    K < 1 keeps the full greedy assignment. Decisions are bit-identical
    either way; only ``shortlist_repaired`` tells them apart."""
    greedy_fn = greedy_assign
    if shortlist is not None and shortlist >= 1:
        greedy_fn = functools.partial(greedy_assign_shortlist, k=shortlist)

    def step(eb, nf, af, key) -> Decision:
        masked_total, feasible_counts, reject_counts = evaluate(
            plugin_set, eb, nf, af)
        assign = gang_assign(masked_total, eb.pf.requests, nf.free,
                             eb.gang.group, eb.gang.min_count,
                             prng.bits(key), greedy_fn=greedy_fn)
        return Decision(
            chosen=assign.chosen,
            assigned=assign.assigned,
            gang_rejected=assign.gang_rejected,
            feasible_counts=feasible_counts,
            feasible_static=feasible_counts,
            reject_counts=reject_counts,
            free_after=assign.free_after,
            shortlist_repaired=assign.repaired,
        )

    return step

"""Gang (all-or-nothing) assignment around the greedy assignment.

``gang_assign`` runs the capacity-aware greedy assignment (select.py)
inside a two-phase loop over group admission:

  1. EVICT: assign with every group admitted; while an admitted group
     places fewer than ``min_count`` members, evict the lowest-priority
     failing group (largest first-member row; rows are priority-ordered)
     and assign again with the survivors.
  2. RE-ADMIT (only if anything was evicted): in priority order, try
     each evicted group again and keep it iff every admitted group still
     meets quorum.

Ungrouped pods (group id -1) are always admitted. With no gangs in the
batch this is one greedy assignment plus one count, and the caller that
knows it on the host (``has_gang=False``) skips the count: the host
never waits for the card.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from .hostread import host_read
from .select import NEG, AssignResult, greedy_assign

_I32_MAX = 2 ** 31 - 1


class GangResult(NamedTuple):
    chosen: torch.Tensor         # (P,) int32 node row, -1 unassigned
    assigned: torch.Tensor       # (P,) bool
    free_after: torch.Tensor     # (N,R) float32 remaining free resources
    gang_rejected: torch.Tensor  # (P,) bool — pod's group missed quorum
    group_ok: torch.Tensor       # (G,) bool — group met min_count
    repaired: torch.Tensor       # (P,) bool — shortlist repair ledger of
    #   the kept attempt; all False when the inner assignment has no
    #   shortlist stage


def gang_assign(scores: torch.Tensor, requests: torch.Tensor,
                free0: torch.Tensor, group_ids: torch.Tensor,
                group_min: torch.Tensor, seed: int,
                greedy_fn: Callable[..., AssignResult] = greedy_assign,
                has_gang: Optional[bool] = None) -> GangResult:
    """Jointly assign pods to nodes with all-or-nothing group semantics.

    scores:    (P,N) float32 with NEG on infeasible pairs (rows in
               priority order)
    requests:  (P,R) float32
    free0:     (N,R) float32
    group_ids: (P,) int32 gang id in [0,G), -1 for ungrouped pods
    group_min: (G,) int32 quorum per gang (0 for padding rows)
    seed:      the batch's u32 tie-break seed
    has_gang:  whether any live pod has a group id, as the caller knows
               it on the host; None reads it from the card
    """

    def attempt_fn(pod_ok: torch.Tensor) -> AssignResult:
        # A Python float, not a tensor made from one: torch.tensor would
        # copy from the host and make the step wait for the card.
        return greedy_fn(torch.where(pod_ok[:, None], scores, NEG),
                         requests, free0, seed)

    return gang_admission(attempt_fn, group_ids, group_min, has_gang)


def gang_admission(attempt_fn: Callable[[torch.Tensor], AssignResult],
                   group_ids: torch.Tensor,
                   group_min: torch.Tensor,
                   has_gang: Optional[bool] = None) -> GangResult:
    """The evict / re-admit loop around an opaque assignment.
    ``attempt_fn(pod_ok)`` assigns with non-admitted pods masked out.
    ``has_gang=False`` (no pod of the batch has a group) returns the
    first attempt with every group admitted, without reading the card:
    with no grouped pod no group can fail, which is what the loop would
    have read. Batches with gangs keep the host loop, which reads the
    card once per attempt (each read through ``hostread.host_read``, so
    the engine counts it)."""
    P = group_ids.shape[0]
    G = group_min.shape[0]
    device = group_ids.device
    grouped = group_ids >= 0
    gidx = torch.where(grouped, group_ids, 0).long()
    def attempt(ok: torch.Tensor):
        pod_ok = torch.where(grouped, ok[gidx], True)
        res = attempt_fn(pod_ok)
        placed = (res.assigned & grouped).to(torch.int32)
        counts = torch.zeros((G,), dtype=torch.int32, device=device)
        counts = counts.index_add(0, gidx, placed)
        return res, ok & (counts < group_min)

    ok = torch.ones((G,), dtype=torch.bool, device=device)
    res, failing = attempt(ok)
    if has_gang is False:
        return _result(res, grouped, gidx, ok)
    # Group priority = its best member's row; an empty group reads
    # int32 max, like jax.ops.segment_min over an empty segment.
    rows = torch.arange(P, dtype=torch.int32, device=device)
    first_row = torch.full((G,), _I32_MAX, dtype=torch.int32, device=device)
    first_row = first_row.scatter_reduce(
        0, gidx, torch.where(grouped, rows, P), reduce="amin",
        include_self=True)
    # Phase 1: evict the lowest-priority failing group until every
    # admitted group meets quorum.
    while host_read(bool, failing.any()):
        victim = host_read(int, torch.argmax(torch.where(failing, first_row,
                                                         -1)))
        ok = ok.clone()
        ok[victim] = False
        res, failing = attempt(ok)

    # Phase 2: re-admit evicted groups in priority order (stable sort,
    # as jnp.argsort).
    if not host_read(bool, ok.all()):
        order = host_read(torch.Tensor.tolist,
                          torch.sort(first_row, stable=True).indices)
        for g in order:
            if host_read(bool, ok[g]):
                continue
            ok2 = ok.clone()
            ok2[g] = True
            res2, failing2 = attempt(ok2)
            if not host_read(bool, failing2.any()):
                ok, res = ok2, res2

    return _result(res, grouped, gidx, ok)


def _result(res, grouped, gidx, ok) -> GangResult:
    gang_rejected = grouped & ~ok[gidx]
    repaired = getattr(res, "repaired", None)
    if repaired is None:
        repaired = torch.zeros_like(res.assigned)
    return GangResult(chosen=res.chosen, assigned=res.assigned,
                      free_after=res.free_after,
                      gang_rejected=gang_rejected, group_ok=ok,
                      repaired=repaired)

"""NodeAffinity: required filter + preferred score.

Batched counterpart of the upstream nodeaffinity plugin. Matching runs
per node-affinity GROUP (distinct node_selector + affinity signatures —
see encode.NodeAffinityGroups) and pods gather their group's row, keeping
the cost O(G2 × N) instead of O(P × N) term evaluations.
"""
from __future__ import annotations

import torch

from ..ops import matchers
from ..ops.topology import gather_group_rows
from ..state.events import ActionType, ClusterEvent, GVK
from .base import BatchedPlugin


def group_required_match(naf, nf) -> torch.Tensor:
    """(G2, N): node_selector pairs ⊆ labels AND (required terms match if
    present)."""
    sel_ok = matchers.pairs_subset(naf.sel_pairs, nf.label_pairs)
    terms_ok = matchers.term_matches(naf.req_op, naf.req_key, naf.req_vals,
                                     nf.label_pairs, nf.label_keys)
    return sel_ok & (terms_ok | ~naf.req_has[:, None])


def group_preferred_score(naf, nf) -> torch.Tensor:
    """(G2, N): Σ weight × [preferred term matches] (upstream scoring).
    Integer weights times 0/1: every product is exact, so a fused
    multiply-add would round the same."""
    score = torch.zeros((naf.valid.shape[0], nf.valid.shape[0]),
                        dtype=torch.float32, device=nf.valid.device)
    for t in range(naf.pref_op.shape[1]):
        m = matchers.term_matches(naf.pref_op[:, t:t + 1],
                                  naf.pref_key[:, t:t + 1],
                                  naf.pref_vals[:, t:t + 1],
                                  nf.label_pairs, nf.label_keys)
        score = score + naf.pref_weight[:, t:t + 1] * m
    return score


class NodeAffinity(BatchedPlugin):
    name = "NodeAffinity"
    needs_node_affinity = True
    column_local = False  # group-match state + max-normalized score
    normalize_row_local = True  # max_normalize_100 reads its own row

    def events_to_register(self):
        return [ClusterEvent(GVK.NODE,
                             ActionType.ADD | ActionType.UPDATE_NODE_LABEL)]

    def filter(self, pf, nf, ctx) -> torch.Tensor:
        return gather_group_rows(pf.na_group, ctx["na_req_match"]
                                 .to(torch.float32), fill=1.0) > 0

    def score(self, pf, nf, ctx) -> torch.Tensor:
        return gather_group_rows(pf.na_group, ctx["na_pref_score"], fill=0.0)

    def normalize(self, scores, feasible):
        from ..ops.pipeline import max_normalize_100

        return max_normalize_100(scores, feasible)

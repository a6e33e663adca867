"""SelectorSpread: spread replicas of one controller across nodes/zones.

Batched counterpart of upstream's SelectorSpread score plugin
(registered, not in the default profile, as upstream ships it). The
population is scoped by controller owner identity: bind accounting
appends the synthetic owner pair to the assigned corpus's label rows,
``encode_pods(selector_spread=True)`` registers per-owner selector
groups (slot 0 under kubernetes.io/hostname, slot 1 under the zone key),
and the shared topology cycle state counts them like any other group.

Score: fewer same-owner pods in the node's domain → higher, weighted
1/3 node + 2/3 zone (upstream's zoneWeighting). Score-only.
"""
from __future__ import annotations

import torch

from ..ops.topology import gather_group_rows
from ..state.events import ActionType, ClusterEvent, GVK
from .base import BatchedPlugin

# upstream zoneWeighting = 2.0/3.0
_ZONE_WEIGHT = 2.0 / 3.0
_NODE_WEIGHT = 1.0 - _ZONE_WEIGHT


class SelectorSpread(BatchedPlugin):
    name = "SelectorSpread"
    needs_topology = True
    column_local = False  # reads corpus-derived domain counts
    normalize_row_local = True  # max_normalize_100 reads its own row
    row_stats = ("max",)

    def events_to_register(self):
        return [ClusterEvent(GVK.POD, ActionType.ALL),
                ClusterEvent(GVK.NODE,
                             ActionType.ADD | ActionType.UPDATE_NODE_LABEL)]

    def score(self, pf, nf, ctx) -> torch.Tensor:
        P, N = pf.valid.shape[0], nf.valid.shape[0]
        dom_valid = ctx["dom_valid"].to(torch.float32)
        score = torch.zeros((P, N), dtype=torch.float32,
                            device=nf.valid.device)
        for c, w in ((0, _NODE_WEIGHT), (1, _ZONE_WEIGHT)):
            g = pf.selspread_group[:, c]
            counts = gather_group_rows(g, ctx["counts_node"])
            dom_ok = gather_group_rows(g, dom_valid) > 0
            gsafe = torch.clamp(g, 0, ctx["max_count"].shape[0] - 1).long()
            spread = ctx["max_count"][gsafe][:, None] - counts
            # float32(w) is not a power of two, so the product rounds;
            # XLA's CPU backend leaves this multiply and add unfused
            # (held by tests/test_torch_plugins_full.py).
            score = score + w * torch.where((g >= 0)[:, None] & dom_ok,
                                            spread, 0.0)
        return score

    def rescale(self, scores, masked, stats):
        from ..ops.pipeline import max_rescale_100

        return max_rescale_100(masked, stats[0])

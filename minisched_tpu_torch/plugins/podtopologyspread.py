"""PodTopologySpread: DoNotSchedule filter + ScheduleAnyway score.

Batched counterpart of the upstream podtopologyspread plugin (BASELINE
config 4 names it for the 50k-node configuration). Consumes the shared
topology cycle state (ops.topology.group_topology_state): for constraint
slot c with selector group g,

  filter:  placing the pod must keep skew within max_skew —
           count(node's domain) + 1 - min(count over existing domains)
           ≤ max_skew; nodes missing the topology key are filtered
           (upstream semantics).
  score:   domains with fewer matching pods score higher
           (max_count - count, normalized 0..100).

Counts see pods bound before this batch. Within a batch, the in-scan
domain caps (ops/spreadcap.py) judge enforced DoNotSchedule groups
against running counts, and the engine's arbitration the rest.
"""
from __future__ import annotations

import torch

from ..encode import features as F
from ..ops.topology import gather_group_rows
from ..state.events import ActionType, ClusterEvent, GVK
from .base import BatchedPlugin


class PodTopologySpread(BatchedPlugin):
    name = "PodTopologySpread"
    default_weight = 2.0  # upstream default
    needs_topology = True
    column_local = False  # reads corpus-derived domain counts
    normalize_row_local = True  # max_normalize_100 reads its own row
    row_stats = ("max",)

    def events_to_register(self):
        return [ClusterEvent(GVK.POD, ActionType.ALL),
                ClusterEvent(GVK.NODE,
                             ActionType.ADD | ActionType.UPDATE_NODE_LABEL)]

    def filter(self, pf, nf, ctx) -> torch.Tensor:
        P, N = pf.valid.shape[0], nf.valid.shape[0]
        scan_g = ctx.get("spread_scan_groups")
        dom_valid = ctx["dom_valid"].to(torch.float32)
        ok = torch.ones((P, N), dtype=torch.bool, device=nf.valid.device)
        for c in range(pf.spread_group.shape[1]):
            g = pf.spread_group[:, c]
            active = (g >= 0) & (pf.spread_mode[:, c]
                                 == F.SPREAD_DO_NOT_SCHEDULE)
            counts = gather_group_rows(g, ctx["counts_node"])
            dom_ok = gather_group_rows(g, dom_valid) > 0
            gsafe = torch.clamp(g, 0, ctx["min_count"].shape[0] - 1).long()
            skew_after = counts + 1.0 - ctx["min_count"][gsafe][:, None]
            within = skew_after <= pf.spread_max_skew[:, c][:, None]
            if scan_g is not None:
                # Groups the greedy scan enforces with running counts
                # (ops/spreadcap.py) skip the frozen pre-batch check; the
                # missing-key rejection (dom_ok) stays.
                within = within | scan_g[gsafe][:, None]
            ok = ok & torch.where(active[:, None], dom_ok & within, True)
        return ok

    def score(self, pf, nf, ctx) -> torch.Tensor:
        P, N = pf.valid.shape[0], nf.valid.shape[0]
        dom_valid = ctx["dom_valid"].to(torch.float32)
        score = torch.zeros((P, N), dtype=torch.float32,
                            device=nf.valid.device)
        for c in range(pf.spread_group.shape[1]):
            g = pf.spread_group[:, c]
            counts = gather_group_rows(g, ctx["counts_node"])
            dom_ok = gather_group_rows(g, dom_valid) > 0
            gsafe = torch.clamp(g, 0, ctx["max_count"].shape[0] - 1).long()
            spread = ctx["max_count"][gsafe][:, None] - counts
            # nodes missing the topology key score 0 (upstream), not max
            score = score + torch.where((g >= 0)[:, None] & dom_ok,
                                        spread, 0.0)
        return score

    def rescale(self, scores, masked, stats):
        from ..ops.pipeline import max_rescale_100

        return max_rescale_100(masked, stats[0])

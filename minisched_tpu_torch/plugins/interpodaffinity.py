"""InterPodAffinity: required filter + weighted preference score.

Batched counterpart of the upstream interpodaffinity plugin (BASELINE
config 4 pairs it with PodTopologySpread at 50k nodes). Uses the shared
topology cycle state: for a term with selector group g, "a matching pod
exists in the node's domain" ⇔ counts_node[g] > 0.

  required affinity:      node's domain must contain ≥1 matching pod.
  required anti-affinity: node's domain must contain none (nodes missing
                          the topology key can't violate — allowed).
  preferred (anti-)affinity: ± weight × matching-pod count per domain.

Counts see pods bound before this batch; required anti-affinity between
two pods of one batch, direct and symmetric, is arbitrated by the engine
(engine.scheduler.arbitrate_spread). The symmetric check against running
pods uses the per-pod forbidden-domain slots the encoder stamps
(encode.anti_forbid, fed by cache.anti_forbidden_for).
"""
from __future__ import annotations

import torch

from ..ops.topology import gather_group_rows
from ..state.events import ActionType, ClusterEvent, GVK
from .base import BatchedPlugin


class InterPodAffinity(BatchedPlugin):
    name = "InterPodAffinity"
    default_weight = 2.0  # upstream default
    needs_topology = True
    column_local = False  # reads corpus-derived domain counts
    normalize_row_local = True  # per-row min/max shift-and-scale
    row_stats = ("min", "max")

    def events_to_register(self):
        return [ClusterEvent(GVK.POD, ActionType.ALL),
                ClusterEvent(GVK.NODE,
                             ActionType.ADD | ActionType.UPDATE_NODE_LABEL)]

    def filter(self, pf, nf, ctx) -> torch.Tensor:
        P, N = pf.valid.shape[0], nf.valid.shape[0]
        dom_valid = ctx["dom_valid"].to(torch.float32)
        ok = torch.ones((P, N), dtype=torch.bool, device=nf.valid.device)
        for t in range(pf.aff_req_group.shape[1]):
            g = pf.aff_req_group[:, t]
            counts = gather_group_rows(g, ctx["counts_node"])
            dom_ok = gather_group_rows(g, dom_valid) > 0
            gsafe = torch.clamp(g, 0, ctx["has_match"].shape[0] - 1).long()
            # Upstream special case: if no pod anywhere matches the term
            # but the incoming pod matches its own selector, the term
            # passes (else the first replica of a self-affine workload
            # could never schedule).
            self_ok = (pf.aff_req_self[:, t]
                       & ~ctx["has_match"][gsafe])[:, None]
            ok = ok & torch.where((g >= 0)[:, None],
                                  (dom_ok & (counts > 0)) | self_ok, True)

            ag = pf.anti_req_group[:, t]
            acounts = gather_group_rows(ag, ctx["counts_node"])
            adom = gather_group_rows(ag, dom_valid) > 0
            ok = ok & torch.where((ag >= 0)[:, None],
                                  ~(adom & (acounts > 0)), True)

        # Symmetric existing-pod anti-affinity: mask the domains a running
        # pod's required anti term forbids for this pod.
        K = nf.topo_domains.shape[0]
        for s in range(pf.anti_forbid_key.shape[1]):
            k = pf.anti_forbid_key[:, s]
            d = pf.anti_forbid_dom[:, s]
            node_dom = nf.topo_domains.index_select(
                0, torch.clamp(k, 0, K - 1).long())          # (P,N)
            ok = ok & torch.where((k >= 0)[:, None],
                                  node_dom != d[:, None], True)
        return ok

    def score(self, pf, nf, ctx) -> torch.Tensor:
        P, N = pf.valid.shape[0], nf.valid.shape[0]
        score = torch.zeros((P, N), dtype=torch.float32,
                            device=nf.valid.device)
        # Integer weights times integer counts: every product is exact,
        # so a fused multiply-add would round the same.
        for t in range(pf.aff_pref_group.shape[1]):
            g = pf.aff_pref_group[:, t]
            score = score + (pf.aff_pref_weight[:, t:t + 1]
                             * gather_group_rows(g, ctx["counts_node"]))
            ag = pf.anti_pref_group[:, t]
            score = score - (pf.anti_pref_weight[:, t:t + 1]
                             * gather_group_rows(ag, ctx["counts_node"]))
        return score

    def rescale(self, scores, masked, stats):
        # Scores can be negative (anti-affinity), so shift-and-scale the
        # feasible range into 0..100, in the JAX package's order.
        lo, hi = stats
        span = torch.clamp_min(hi - lo, 1e-30)
        return torch.where(hi > lo, 100.0 * (scores - lo) / span,
                           torch.zeros_like(scores))

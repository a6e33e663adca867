"""VolumeRestrictions filter.

Batched counterpart of the upstream plugin the reference wraps as
VolumeRestrictionsForSimulator (reference scheduler/plugin/plugins.go:24-70
registry): a read-write-once claim already mounted by a running pod pins
any other pod using that claim to the same node.

Encoding: pf.claim_rows[p, c] is the node row the pod's c-th PVC is
currently mounted on (-1 = unused or shared/multi-node — unrestricted),
resolved host-side by the engine from the node cache's claim table. The
filter is a per-claim-slot AND of (unrestricted | same node) — CV
sequential (P, N) ops, no (P, CV, N) temporary.
"""
from __future__ import annotations

import torch

from ..state.events import ActionType, ClusterEvent, GVK
from .base import BatchedPlugin


class VolumeRestrictions(BatchedPlugin):
    name = "VolumeRestrictions"
    # NOT column-local: the filter compares claim rows against the node
    # AXIS POSITION (arange over N), which a gathered re-evaluation does
    # not preserve (the sampled step remaps claim_rows for this).
    column_local = False

    def events_to_register(self):
        # A pod deletion can release a claim; a PVC update can rebind it.
        return [ClusterEvent(GVK.POD, ActionType.DELETE),
                ClusterEvent(GVK.PERSISTENT_VOLUME_CLAIM,
                             ActionType.ADD | ActionType.UPDATE)]

    def filter(self, pf, nf, ctx) -> torch.Tensor:
        P = pf.valid.shape[0]
        N = nf.valid.shape[0]
        node_idx = torch.arange(N, dtype=torch.int32,
                                device=pf.valid.device)[None, :]   # (1,N)
        ok = torch.ones((P, N), dtype=torch.bool, device=pf.valid.device)
        for c in range(pf.claim_rows.shape[1]):
            row = pf.claim_rows[:, c:c + 1]                          # (P,1)
            ok = ok & ((row < 0) | (row == node_idx))
        return ok

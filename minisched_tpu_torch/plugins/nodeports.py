"""NodePorts filter: requested host ports must be free on the node.

Batched counterpart of the upstream nodeports plugin: a pod conflicts
with a node iff one of its nonzero requested host ports equals a port in
the node's ``used_ports`` row (0 = empty slot). One boolean mask column
in the batched filter matrix.
"""
from __future__ import annotations

import torch

from ..state.events import ActionType, ClusterEvent, GVK
from .base import BatchedPlugin


class NodePorts(BatchedPlugin):
    name = "NodePorts"
    column_local = True  # reads only nf.used_ports per column

    def events_to_register(self):
        return [ClusterEvent(GVK.POD, ActionType.DELETE),
                ClusterEvent(GVK.NODE, ActionType.ADD)]

    def filter(self, pf, nf, ctx) -> torch.Tensor:
        # One requested slot at a time: (P,N,PORT) per slot instead of the
        # whole (P,PP,N,PORT) comparison.
        used = nf.used_ports[None, :, :]                     # (1,N,PORT)
        conflict = torch.zeros((pf.ports.shape[0], used.shape[1]),
                               dtype=torch.bool, device=used.device)
        for t in range(pf.ports.shape[1]):
            want = pf.ports[:, t, None, None]                # (P,1,1)
            conflict |= ((want != 0) & (want == used)).any(dim=2)
        return ~conflict

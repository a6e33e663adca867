"""VolumeZone filter.

Batched counterpart of the upstream plugin the reference wraps as
VolumeZoneForSimulator (reference scheduler/plugin/plugins.go:24-70
registry): a pod using a PV that carries a zone topology label may only run
on nodes in that zone.

Encoding: the engine resolves the pod's bound PVs' zone label host-side
into (pf.zone_key, pf.zone_dom) — the topology-key registry slot for the
zone key and the hashed domain id of the required zone value (the same
hash the node cache uses for nf.topo_domains). The filter is one gather
over the (K, N) domain table plus an equality.
"""
from __future__ import annotations

import torch

from ..state.events import ActionType, ClusterEvent, GVK
from .base import BatchedPlugin


class VolumeZone(BatchedPlugin):
    name = "VolumeZone"
    column_local = True  # reads nf.topo_domains per column (gather-safe)
    needs_topology = False  # uses the raw domain table, not group counts

    def events_to_register(self):
        # PVC events too: rebinding a claim to a PV in a reachable zone
        # must revive pods parked by this plugin.
        return [ClusterEvent(GVK.PERSISTENT_VOLUME,
                             ActionType.ADD | ActionType.UPDATE),
                ClusterEvent(GVK.PERSISTENT_VOLUME_CLAIM,
                             ActionType.ADD | ActionType.UPDATE),
                ClusterEvent(GVK.NODE,
                             ActionType.ADD | ActionType.UPDATE_NODE_LABEL)]

    def filter(self, pf, nf, ctx) -> torch.Tensor:
        zk = pf.zone_key                                        # (P,)
        # Per-pod row of the node domain table under the pod's zone key
        # (a device gather: no host read of the keys).
        dom_rows = nf.topo_domains[torch.clamp(zk, min=0).long()]  # (P,N)
        required = zk >= 0
        match = (dom_rows == pf.zone_dom[:, None]) & (dom_rows >= 0)
        return torch.where(required[:, None], match, True)

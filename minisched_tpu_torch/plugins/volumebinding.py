"""VolumeBinding filter (simplified): a pod whose PVCs are not yet bound is
unschedulable until the PV controller binds them — the scheduling-side
contract of the reference's PV controller pairing
(pvcontroller/pvcontroller.go; upstream volumebinding plugin's
pre-bound-PVC check). Volume topology constraints are not modeled."""
from __future__ import annotations

import torch

from ..state.events import ActionType, ClusterEvent, GVK
from .base import BatchedPlugin


class VolumeBinding(BatchedPlugin):
    name = "VolumeBinding"
    column_local = True  # column-uniform broadcast of pf.volumes_ready

    def events_to_register(self):
        return [ClusterEvent(GVK.PERSISTENT_VOLUME_CLAIM,
                             ActionType.ADD | ActionType.UPDATE),
                ClusterEvent(GVK.PERSISTENT_VOLUME,
                             ActionType.ADD | ActionType.UPDATE)]

    def filter(self, pf, nf, ctx) -> torch.Tensor:
        return pf.volumes_ready[:, None].expand(pf.valid.shape[0],
                                               nf.valid.shape[0])

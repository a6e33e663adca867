"""NodePreferAvoidPods score plugin.

Batched counterpart of upstream's NodePreferAvoidPods: nodes carrying the
``scheduler.alpha.kubernetes.io/preferAvoidPods`` annotation score 0 for
pods controlled by a ReplicationController or ReplicaSet (pf.rc_owned),
everything else scores the max. Upstream gives it weight 10000 so it
dominates other scorers — effectively a soft filter; the default_weight
here mirrors that.
"""
from __future__ import annotations

import torch

from ..state.events import ActionType, ClusterEvent, GVK
from .base import BatchedPlugin


class NodePreferAvoidPods(BatchedPlugin):
    name = "NodePreferAvoidPods"
    column_local = True  # reads only nf.avoid_pods per column
    default_weight = 10000.0

    def events_to_register(self):
        return [ClusterEvent(GVK.NODE, ActionType.ADD | ActionType.UPDATE)]

    def score(self, pf, nf, ctx) -> torch.Tensor:
        avoid = nf.avoid_pods[None, :] & pf.rc_owned[:, None]
        return torch.where(avoid, 0.0, 100.0).to(torch.float32)

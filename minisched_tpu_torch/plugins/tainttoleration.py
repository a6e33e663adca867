"""TaintToleration: filter on untolerated NoSchedule/NoExecute taints,
score by untolerated PreferNoSchedule taints (fewer = better) — upstream
tainttoleration, wrapped by the reference's registry
(scheduler/plugin/plugins.go:24-70)."""
from __future__ import annotations

import torch

from ..encode import features as F
from ..ops import matchers
from ..state.events import ActionType, ClusterEvent, GVK
from .base import BatchedPlugin


class TaintToleration(BatchedPlugin):
    name = "TaintToleration"
    column_local = True
    normalize_row_local = True
    row_stats = ("min",)
    default_weight = 3.0  # upstream default weight

    def events_to_register(self):
        return [ClusterEvent(GVK.NODE,
                             ActionType.ADD | ActionType.UPDATE_NODE_TAINT)]

    def filter(self, pf, nf, ctx) -> torch.Tensor:
        return matchers.tolerations_cover(
            pf, nf.taint_pairs, nf.taint_keys, nf.taint_effects,
            (F.EFFECT_NO_SCHEDULE, F.EFFECT_NO_EXECUTE))

    def score(self, pf, nf, ctx) -> torch.Tensor:
        intolerable = matchers.untolerated_count(
            pf, nf.taint_pairs, nf.taint_keys, nf.taint_effects,
            F.EFFECT_PREFER_NO_SCHEDULE)
        return -intolerable

    def rescale(self, scores, masked, stats):
        # Upstream: score = 100 × (1 - count/max_count). With negated
        # counts: shift so the best (0 untolerated) = 100.
        (worst,) = stats  # the most negative feasible score
        return torch.where(worst < 0, 100.0 * (1.0 - scores / worst), 100.0)

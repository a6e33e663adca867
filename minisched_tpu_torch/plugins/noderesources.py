"""Node-resources plugins: Fit filter + allocation scorers.

Batched counterparts of the upstream plugins the reference wraps for the
simulator (reference scheduler/plugin/plugins.go:24-70 registry rows
NodeResourcesFit / NodeResourcesLeastAllocated / NodeResourcesMostAllocated /
NodeResourcesBalancedAllocation; BASELINE config 3 names Fit+LeastAllocated
as the dense-matrix benchmark pair).

All operate on the free/allocatable columns of NodeFeatures against pod
request vectors — pure (P × N) arithmetic on the resource axis.
"""
from __future__ import annotations

import torch

from ..state.events import ActionType, ClusterEvent, GVK
from ..state.objects import RESOURCE_INDEX
from .base import BatchedPlugin

_EPS = 1e-9

# Upstream's allocation scorers default to cpu+memory (scoring every axis
# would let utilization-free axes like max-pods or attach slots skew the
# mean/stddev); the Fit FILTER still checks every tracked axis.
DEFAULT_SCORED_RESOURCES = ("cpu", "memory")


class NodeResourcesFit(BatchedPlugin):
    """Filter: node's free resources cover the pod's requests on every
    tracked dimension (upstream noderesources.Fit). The same plugin also
    SCORES in upstream's default v1beta2 profile (the reference's golden
    config lists NodeResourcesFit in Score.Enabled,
    scheduler/scheduler_test.go:325-333); ``score_strategy`` selects the
    scoring function (upstream ScoringStrategy): "LeastAllocated" (the
    default), "MostAllocated", or None to disable the score point."""

    name = "NodeResourcesFit"
    column_local = True  # per-column free/allocatable math only
    # Rejections are purely free-vs-request on the accounted axes —
    # exactly what evicting victims credits back (preemption-curable).
    capacity_only = True

    def __init__(self, score_strategy: str | None = "LeastAllocated",
                 resources=DEFAULT_SCORED_RESOURCES):
        self._strategy = score_strategy
        self.score_active = score_strategy is not None
        self._scorer = None
        if score_strategy == "LeastAllocated":
            self._scorer = NodeResourcesLeastAllocated(resources)
        elif score_strategy == "MostAllocated":
            self._scorer = NodeResourcesMostAllocated(resources)
        elif score_strategy is not None:
            raise ValueError(f"unknown score_strategy {score_strategy!r}")

    def trace_key(self) -> tuple:
        extra = (self._strategy,
                 self._scorer._resources if self._scorer else ())
        return super().trace_key() + extra

    def events_to_register(self):
        # Upstream: {Pod, Delete} (capacity freed) + {Node, Add|Update}.
        return [ClusterEvent(GVK.POD, ActionType.DELETE),
                ClusterEvent(GVK.NODE, ActionType.ADD | ActionType.UPDATE)]

    def filter(self, pf, nf, ctx) -> torch.Tensor:
        # (P,1,R) <= (1,N,R) reduced over R, one axis at a time so no
        # (P,N,R) temporary is held
        free = nf.free + _EPS
        fits = pf.requests[:, None, 0] <= free[None, :, 0]
        for r in range(1, free.shape[1]):
            fits &= pf.requests[:, None, r] <= free[None, :, r]
        return fits

    def score(self, pf, nf, ctx) -> torch.Tensor:
        return self._scorer.score(pf, nf, ctx)


class _AllocationScorer(BatchedPlugin):
    """Shared math: per-resource utilization after placing the pod, over a
    configurable scored-resource set (upstream's `resources` plugin arg;
    defaults to cpu+memory like upstream)."""

    column_local = True  # per-column utilization math only

    def __init__(self, resources=DEFAULT_SCORED_RESOURCES):
        self._resources = tuple(resources)
        self._axes = [RESOURCE_INDEX[r] for r in self._resources]
        # Indexing with a Python list copies an index tensor from the
        # host at every call, and the copy makes the step wait for the
        # card. Contiguous axes take a slice; others an index tensor
        # made once per device.
        lo = self._axes[0] if self._axes else 0
        self._slice = (slice(lo, lo + len(self._axes))
                       if self._axes == list(range(lo, lo + len(self._axes)))
                       else None)
        self._index = {}

    def _scored(self, a: torch.Tensor) -> torch.Tensor:
        """``a[..., self._axes]`` without a host-to-device copy."""
        if self._slice is not None:
            return a[..., self._slice]
        idx = self._index.get(a.device)
        if idx is None:
            idx = self._index[a.device] = torch.tensor(
                self._axes, dtype=torch.long, device=a.device)
        return a.index_select(-1, idx)

    def trace_key(self) -> tuple:
        return super().trace_key() + (self._resources,)

    def events_to_register(self):
        return [ClusterEvent(GVK.POD, ActionType.DELETE),
                ClusterEvent(GVK.NODE, ActionType.ADD | ActionType.UPDATE)]

    def _utilization(self, pf, nf):
        """(P,N,S) requested fraction of allocatable after hypothetical
        placement over the scored axes, plus the (1,N,S) presence mask."""
        alloc = self._scored(nf.allocatable)[None, :, :]
        used = (alloc - self._scored(nf.free)[None, :, :]
                + self._scored(pf.requests)[:, None, :])
        util = torch.where(alloc > 0, used / torch.clamp_min(alloc, _EPS),
                           0.0)
        return util, alloc > 0


class NodeResourcesLeastAllocated(_AllocationScorer):
    """Score 0..100, higher for emptier nodes (upstream leastAllocatedScorer:
    mean over scored resources of (capacity - used)/capacity × 100)."""

    name = "NodeResourcesLeastAllocated"

    def score(self, pf, nf, ctx) -> torch.Tensor:
        util, present = self._utilization(pf, nf)
        frac_free = torch.where(present, 1.0 - util, 0.0)
        denom = torch.clamp_min(present.sum(dim=2), 1)
        return 100.0 * frac_free.sum(dim=2) / denom


class NodeResourcesMostAllocated(_AllocationScorer):
    """Score 0..100, higher for fuller nodes (bin-packing preference)."""

    name = "NodeResourcesMostAllocated"

    def score(self, pf, nf, ctx) -> torch.Tensor:
        util, present = self._utilization(pf, nf)
        denom = torch.clamp_min(present.sum(dim=2), 1)
        return 100.0 * torch.where(present, torch.clamp(util, 0.0, 1.0), 0.0).sum(dim=2) / denom


def sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root, on every device.

    torch's CPU ``sqrt`` is not IEEE: it misses the correctly rounded
    result in about a fifth of random float32 inputs, so a score would
    sit one ulp off XLA's and flip a tie-break. The root taken in float64
    and rounded once to float32 is exact: double rounding is harmless for
    sqrt because 53 >= 2*24 + 2."""
    return torch.sqrt(x.double()).float()


class NodeResourcesBalancedAllocation(_AllocationScorer):
    """Score 0..100, higher when per-resource utilizations are mutually
    close (upstream balanced-allocation: 100 - stddev×100 over fractions)."""

    name = "NodeResourcesBalancedAllocation"

    def score(self, pf, nf, ctx) -> torch.Tensor:
        util, present = self._utilization(pf, nf)
        count = torch.clamp_min(present.sum(dim=2), 1)
        u = torch.where(present, torch.clamp(util, 0.0, 1.0), 0.0)
        mean = u.sum(dim=2) / count
        d = u - mean[:, :, None]
        var = torch.where(present, d * d, 0.0).sum(dim=2) / count
        return 100.0 - sqrt_f32(var) * 100.0

"""Batched plugin framework.

The reference's plugin layer implements the k8s framework extension points
Filter / PreScore / Score / NormalizeScore / Permit, called per (pod, node)
pair in nested loops (reference minisched/minisched.go:115-237, plugin
construction at minisched/initialize.go:80-138). Here a plugin is a pure
function bundle over whole feature batches:

  * ``filter(pf, nf) -> (P,N) bool``      — the Filter point, one mask column
  * ``score(pf, nf) -> (P,N) f32``        — PreScore+Score fused (PreScore's
    per-pod precomputation is just broadcasting in the batched world)
  * ``normalize(scores, feasible) -> (P,N)`` — NormalizeScore, run ONCE per
    plugin after scoring (the reference calls it inside the node loop over a
    partially-filled list — a quirk SURVEY §3.3 flags; we implement the
    correct upstream semantics)
  * ``permit(pod, node_name)``            — host-side async Permit (timers
    don't belong in XLA; reference waitingpod machinery stays host-side)

Framework-applied weights fix the reference's TODO (minisched.go:187).
Per-plugin masks/scores stay separate for attribution (SURVEY §7: requeue
gating needs "which plugin rejected this pod"; don't fuse it away).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ..state.events import ClusterEvent


# Row statistics over the feasible nodes alone (row_stats' "fmax" and
# "fmin"); a row with none reads -inf / +inf.
FEASIBLE_ONLY = {"fmax": float("-inf"), "fmin": float("inf")}


def row_stats(masked: Optional[torch.Tensor], ops: Sequence[str],
              scores: Optional[torch.Tensor] = None,
              feasible: Optional[torch.Tensor] = None
              ) -> List[torch.Tensor]:
    """Each row's ``ops`` (in order), (P,1) each: the row statistics a
    scorer's NormalizeScore reads (``row_stats`` on the plugin). "max"
    and "min" reduce ``masked``, the scores with 0.0 where infeasible;
    "fmax" and "fmin" reduce ``scores`` over the ``feasible`` nodes alone
    (upstream's NormalizeScore sees only the nodes that passed the
    filters). On a mesh each node shard reduces its own columns and the
    node axis combines them by pmax / pmin (parallel/sharded.py), exact
    in any order, so the statistics have the same bits either way."""
    out = []
    infeasible = own = None
    for op in ops:
        if op in FEASIBLE_ONLY:
            # One copy of the scores, refilled in place for each
            # feasible-only statistic: masked_fill takes the constant as
            # a scalar, where torch.where would first fill a tensor with
            # it (launches the step pays every batch).
            if own is None:
                infeasible = ~feasible
                own = scores.masked_fill(infeasible, FEASIBLE_ONLY[op])
            else:
                own.masked_fill_(infeasible, FEASIBLE_ONLY[op])
            src = own
        else:
            src = masked
        out.append((src.max(dim=1, keepdim=True) if op.endswith("max")
                    else src.min(dim=1, keepdim=True)).values)
    return out


class BatchedPlugin:
    """Base plugin. Subclasses override any subset of the extension points;
    the framework detects overrides to classify filter/score plugins.

    ``ctx`` is the shared cycle state (the reference's framework.CycleState,
    built by RunPreScorePlugins at minisched.go:153-162): a dict the
    pipeline fills once per step with cross-plugin inputs — assigned-pod
    corpus, topology-domain counts (needs_topology), node-affinity group
    matches (needs_node_affinity)."""

    name: str = "Base"
    default_weight: float = 1.0
    # shared-cycle-state requirements (computed once per step if any
    # enabled plugin asks)
    needs_topology: bool = False
    needs_node_affinity: bool = False
    # The filter rejects ONLY on free-resource-vs-request axes (the ones
    # bind accounting credits back on eviction). Preemption's candidate
    # math may assume such rejections are curable by evicting victims;
    # every other filter stays a hard blocker for the preemptor.
    capacity_only: bool = False
    # filter/score at node column n read ONLY that node's feature column
    # (no reduction or gather over the node axis, no ctx state derived
    # from other nodes). The maintained arbitration index (ops/index.py)
    # may then re-evaluate a changed column in isolation and get the
    # full-matrix value bitwise. FAIL-CLOSED default: a plugin must
    # explicitly declare True to unlock the index for its profile — a
    # new plugin that couples columns and forgets the declaration must
    # degrade to the per-batch dataflow, never to stale certified
    # decisions.
    column_local: bool = False
    # ``normalize`` row i reads ONLY row i of (scores, feasible) — any
    # in-row reduction (max/min/sum) is fine, coupling ACROSS pod rows
    # is not. The maintained index (ops/index.py) recomputes normalize
    # from its stored raw planes, so row-local overrides stay
    # index-eligible; a cross-row normalize would make one class row's
    # cached value depend on which OTHER classes share the matrix.
    # FAIL-CLOSED like column_local: the flag only matters for plugins
    # that OVERRIDE normalize or rescale (the inherited identity is trivially
    # row-local), and such a plugin must explicitly declare True.
    normalize_row_local: bool = False

    # -- event interest (drives requeue gating, reference
    #    minisched/initialize.go:140-157 + nodenumber.go:66-70)
    def events_to_register(self) -> List[ClusterEvent]:
        return []

    # -- device-side extension points (tensor functions of the batch)
    def filter(self, pf, nf, ctx) -> torch.Tensor:  # pragma: no cover
        raise NotImplementedError

    def score(self, pf, nf, ctx) -> torch.Tensor:  # pragma: no cover
        raise NotImplementedError

    def deferred_filter(self, pf, nf, ctx) -> Optional[torch.Tensor]:
        """The verdict, on the batch's starting state, of the checks
        ``filter`` left to the assignment in this step (PodTopologySpread's
        skew check, which the caps scan makes with running counts), or
        None when it deferred none. The scorers normalize over the nodes
        that pass it too: upstream scores only the nodes that passed
        every filter."""
        return None

    # NormalizeScore in two halves, so that a row split over node shards
    # normalizes as a whole row: ``row_stats`` names the row statistics
    # it reads (module-level ``row_stats``), ``rescale`` applies them
    # given the scores, the scores masked to 0.0 where infeasible (None
    # when every statistic is a feasible-only one), and the statistics.
    # A plugin overrides these two, not ``normalize``.
    row_stats: Tuple[str, ...] = ()

    def normalize(self, scores: torch.Tensor,
                  feasible: torch.Tensor) -> torch.Tensor:
        if not self.row_stats:
            return self.rescale(scores, None, [])
        masked = (torch.where(feasible, scores, 0.0)
                  if set(self.row_stats) - set(FEASIBLE_ONLY) else None)
        return self.rescale(scores, masked,
                            row_stats(masked, self.row_stats, scores,
                                      feasible))

    def rescale(self, scores: torch.Tensor, masked: Optional[torch.Tensor],
                stats: List[torch.Tensor]) -> torch.Tensor:
        return scores

    # -- host-side extension points
    def permit(self, pod, node_name: str) -> Tuple[str, float, float]:
        """Return (status, auto_allow_delay_s, timeout_s).

        status "allow" binds immediately; "reject" fails the pod; "wait"
        parks it — the framework Allows it after auto_allow_delay_s unless
        timeout_s expires first and Rejects it (reference waitingpod timers,
        waitingpod.go:42-49, and nodenumber's AfterFunc, nodenumber.go:112-118).
        """
        return ("allow", 0.0, 0.0)

    def trace_key(self) -> tuple:
        """Hashable identity of this plugin's *traced* behavior. Two plugins
        with equal trace keys must produce identical filter/score/normalize
        computations — lets compiled steps be shared across scheduler
        instances. Include any constructor arg that changes device-side
        math; host-only knobs (permit delays etc.) stay out."""
        return (type(self).__module__, type(self).__qualname__)

    # -- capability detection
    # Instance-level opt-outs: a plugin class may implement an extension
    # point but disable it per instance (e.g. NodeResourcesFit with
    # score_strategy=None, or a profile disabling one extension point of a
    # multi-point plugin — upstream's per-point Plugins.Score.Disabled).
    score_active: bool = True
    filter_active: bool = True

    @property
    def is_filter(self) -> bool:
        return (type(self).filter is not BatchedPlugin.filter
                and self.filter_active)

    @property
    def is_score(self) -> bool:
        return (type(self).score is not BatchedPlugin.score
                and self.score_active)

    @property
    def is_permit(self) -> bool:
        return type(self).permit is not BatchedPlugin.permit

    # PostFilter (upstream DefaultPreemption): marker capability — the
    # engine runs the batched preemption pass for terminally-unschedulable
    # pods when the profile enables a postfilter plugin.
    is_postfilter: bool = False


class PluginSet:
    """An ordered, weighted set of plugins forming one scheduling profile
    (the analog of the reference's hardcoded plugin slices,
    minisched/initialize.go:18-29, and of KubeSchedulerConfiguration
    profiles)."""

    def __init__(self, plugins: Sequence[BatchedPlugin],
                 weights: Optional[dict] = None):
        self.plugins = list(plugins)
        self.weights = dict(weights or {})
        self.filter_plugins = [p for p in self.plugins if p.is_filter]
        self.score_plugins = [p for p in self.plugins if p.is_score]
        self.permit_plugins = [p for p in self.plugins if p.is_permit]
        self.postfilter_plugins = [p for p in self.plugins
                                   if p.is_postfilter]

    def weight_of(self, plugin: BatchedPlugin) -> float:
        return float(self.weights.get(plugin.name, plugin.default_weight))

    def cluster_event_map(self) -> dict:
        """ClusterEvent → {plugin names} (reference initialize.go:140-157)."""
        out: dict = {}
        for p in self.plugins:
            for ev in p.events_to_register():
                out.setdefault(ev, set()).add(p.name)
        return out

    def names(self) -> List[str]:
        return [p.name for p in self.plugins]

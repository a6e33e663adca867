"""DefaultPreemption — the PostFilter extension point.

Upstream kube-scheduler's DefaultPreemption plugin: when a pod is
terminally unschedulable, find nodes where evicting strictly-lower-
priority pods would make it feasible, evict the cheapest victim set, and
record status.nominatedNodeName while the preemptor waits for the freed
capacity. The REFERENCE has no preemption at all (its minisched wraps
only Filter/Score/Permit — SURVEY §2); this is upstream-semantics
capability beyond reference parity.

The plugin itself is a marker (``is_postfilter``): the candidate math is
batched on device (ops/preempt.py — per-(pod, node) victim-release
feasibility over the assigned-pod corpus) and the engine commits the
minimal victim set host-side (engine/scheduler.py preemption pass).

Anti-affinity and topology-spread rejections ARE curable by eviction
(upstream parity, node-local victim scope exactly like upstream's
``SelectVictimsOnNode``): ops/preempt.py admits a candidate node when
evicting lower-priority pods ON THAT NODE removes the rejection — the
preemptor's own required anti-affinity matches, the symmetric
repelling-term owners (encode.anti_forbid_row/_maxpri carry their
location and rank), and enough spread-matching pods to bring the domain
back under max_skew (``spread_evict`` counts) — and the engine's victim
selection evicts those pods as a MANDATORY set before the
capacity-driven top-up. Remaining documented deviations: other
non-capacity filter rejections (taints, node affinity, required pod
AFFINITY — eviction cannot create a match) stay incurable, curability is
validated at step-snapshot freshness (the host re-validates capacity and
mandatory-victim availability, not domain-wide topology), and victim
ordering does not protect a pod that supplies the preemptor's own
required affinity. PodDisruptionBudgets
ARE modeled (policy/v1 min_available form, state/objects.py): a victim
whose eviction would drop a matching budget below min_available is
chosen only when no non-violating victim set suffices — upstream
DefaultPreemption's minimize-violations ordering (engine
_select_victims; budgets are debited across every preemptor of a
cycle). Gang members neither preempt
nor are offered as victims (group-level victim math is out of scope — evicting
one member would strand its gang below quorum); the device-side
candidate search counts all lower-priority pods (including gang members)
when sizing feasibility, so a candidate that only works by evicting gang
pods fails at the host's victim-selection stage and the pod parks
terminally. nominatedNodeName both records the decision AND reserves the
freed capacity: the engine debits outstanding nominations from every
other pod's view of the node until the preemptor binds, vanishes, or a
TTL lapses (engine/scheduler.py ``_nomination_debits``).
"""
from __future__ import annotations

from typing import List

from ..state.events import ActionType, ClusterEvent, GVK
from .base import BatchedPlugin


class DefaultPreemption(BatchedPlugin):
    name = "DefaultPreemption"
    is_postfilter = True

    def events_to_register(self) -> List[ClusterEvent]:
        # The preemptor revives when its victims' deletions land.
        return [ClusterEvent(GVK.POD, ActionType.DELETE)]

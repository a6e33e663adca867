"""Upstream's InterPodAffinity and PodTopologySpread scores, written
plainly: loops over nodes, bound pods and terms, in float32 PyTorch.

It imports nothing of JAX, of the JAX package, or of the port: it reads
the attributes of the object types it is handed (nodes, pods, their
labels, affinity terms and spread constraints) and returns one row of
scores per incoming pod. The tests hold the port's ``score`` and
``normalize`` to it bit for bit: integer weights times integer counts
are exact in float32, and the normalization below takes the port's
float32 steps in the port's order.

InterPodAffinity follows k8s 1.22
``pkg/scheduler/framework/plugins/interpodaffinity/scoring.go``:

* PreScore, ``processExistingPod`` for every bound pod, adds in the
  bound pod's node's domain under each term's topology key:
  - each preferred affinity term of the incoming pod that the bound pod
    matches: +weight; each preferred anti-affinity term: -weight;
  - each preferred affinity term of the bound pod that the incoming pod
    matches: +weight; each preferred anti-affinity term: -weight; each
    required affinity term: +hardPodAffinityWeight (1, the default).
  A term matches a pod when the pod's namespace is among the term's
  (the term owner's own namespace unless the term lists namespaces)
  and its selector matches the pod's labels (an empty selector matches
  every pod; a nil one, ``None``, matches none). A node lacking the key
  adds nothing.
* Score: a node's sum, over the keys, of its domain's total; nothing
  from a key the node lacks.
* NormalizeScore: ``100 * (s - min) / (max - min)`` with min and max
  over the nodes that passed the filters (the scored list: with a
  DoNotSchedule spread, only the nodes that pass its skew check), 0
  where max == min.

PodTopologySpread: only ScheduleAnyway constraints are scored
(PreScore keeps no DoNotSchedule one); a pod with none scores 0.

Departures from scoring.go, each the port's and the reference's alike:

1. Scores stay continuous: upstream truncates each normalized score to
   an integer (``int64(fScore)``).
2. The normalization runs in float32 as ``(100 * (s - min)) / (max -
   min)``; upstream divides first, in float64.
3. The kubernetes.io/hostname domain is the node itself, whether or not
   the node carries the label (every node in the tests does).
4. PodTopologySpread's score is the port's: for each ScheduleAnyway
   constraint, the largest matching count over the key's domains that
   exist on some node minus the count in the node's domain (0 on a node
   lacking the key), normalized so the row's largest over the feasible
   nodes is 100. Upstream weighs each constraint by the log of its
   domain count, adds ``maxSkew - 1`` and normalizes against the
   smallest score.

A departure of the port's alone: a nil selector (``None``) matches no
pod here, as upstream's (``LabelSelectorAsSelector(nil)`` is
``labels.Nothing()``), and in the port's index of the bound pods' terms;
the port's encoder, the JAX package's, reads ``None`` on the incoming
pod's own terms and constraints as matching every pod. The object types
default to an empty selector, so only a caller that sets ``None`` meets
it; the tests pin the difference.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

HOSTNAME = "kubernetes.io/hostname"
HARD_POD_AFFINITY_WEIGHT = 1
SCHEDULE_ANYWAY = "ScheduleAnyway"


def _value(node, key: str) -> Optional[str]:
    if key == HOSTNAME:
        return node.metadata.name
    return node.metadata.labels.get(key)


def _term_matches(term, owner_ns: str, pod) -> bool:
    namespaces = term.namespaces or [owner_ns]
    if pod.metadata.namespace not in namespaces:
        return False
    sel = term.label_selector
    return sel is not None and sel.matches(pod.metadata.labels)


def _terms(pod, kind: str, mode: str) -> List[Tuple[object, int]]:
    """(term, weight) of ``pod``'s ``kind`` ("pod_affinity" or
    "pod_anti_affinity") ``mode`` ("preferred" or "required") terms."""
    aff = pod.spec.affinity
    part = getattr(aff, kind, None) if aff is not None else None
    if part is None:
        return []
    if mode == "preferred":
        return [(w.term, int(w.weight)) for w in part.preferred]
    return [(t, HARD_POD_AFFINITY_WEIGHT) for t in part.required]


def inter_pod_affinity_raw(pod, nodes: Sequence,
                           bound: Sequence[Tuple[object, int]]
                           ) -> torch.Tensor:
    """(N,) float32: upstream's InterPodAffinity score of ``pod`` on each
    of ``nodes`` before normalization; ``bound`` lists (bound pod, index
    of its node in ``nodes``)."""
    # topology key → domain value → summed weight (PreScore's topoScore)
    topo: Dict[str, Dict[str, int]] = {}

    def add(key: str, node, weight: int) -> None:
        value = _value(node, key)
        if value is None:
            return
        per = topo.setdefault(key, {})
        per[value] = per.get(value, 0) + weight

    own_ns = pod.metadata.namespace
    for other, j in bound:
        node = nodes[j]
        # The incoming pod's preferred terms, matched by the bound pod.
        for term, w in _terms(pod, "pod_affinity", "preferred"):
            if _term_matches(term, own_ns, other):
                add(term.topology_key, node, w)
        for term, w in _terms(pod, "pod_anti_affinity", "preferred"):
            if _term_matches(term, own_ns, other):
                add(term.topology_key, node, -w)
        # The bound pod's terms, matched by the incoming pod.
        their_ns = other.metadata.namespace
        for term, w in _terms(other, "pod_affinity", "required"):
            if _term_matches(term, their_ns, pod):
                add(term.topology_key, node, w)
        for term, w in _terms(other, "pod_affinity", "preferred"):
            if _term_matches(term, their_ns, pod):
                add(term.topology_key, node, w)
        for term, w in _terms(other, "pod_anti_affinity", "preferred"):
            if _term_matches(term, their_ns, pod):
                add(term.topology_key, node, -w)
    out = torch.zeros(len(nodes), dtype=torch.float32)
    for n, node in enumerate(nodes):
        total = 0
        for key, per in topo.items():
            value = _value(node, key)
            if value is not None:
                total += per.get(value, 0)
        out[n] = float(total)
    return out


def inter_pod_affinity_normalize(raw: torch.Tensor,
                                 feasible: torch.Tensor) -> torch.Tensor:
    """(N,) float32: NormalizeScore over the nodes in ``feasible``."""
    lo = hi = None
    for n in range(raw.shape[0]):
        if feasible[n]:
            v = raw[n]
            lo = v if lo is None or v < lo else lo
            hi = v if hi is None or v > hi else hi
    out = torch.zeros_like(raw)
    if lo is None or not hi > lo:
        return out
    hundred = torch.tensor(100.0, dtype=torch.float32)
    for n in range(raw.shape[0]):
        out[n] = hundred * (raw[n] - lo) / (hi - lo)
    return out


def _spread_count(nodes, bound, key: str, value: str, pod, sel) -> int:
    count = 0
    for other, j in bound:
        if other.metadata.namespace != pod.metadata.namespace:
            continue
        if sel is None or not sel.matches(other.metadata.labels):
            continue
        if _value(nodes[j], key) == value:
            count += 1
    return count


def pod_topology_spread_raw(pod, nodes: Sequence,
                            bound: Sequence[Tuple[object, int]]
                            ) -> torch.Tensor:
    """(N,) float32: the ScheduleAnyway constraints' spread score of
    ``pod`` on each node before normalization (departure 4)."""
    out = torch.zeros(len(nodes), dtype=torch.float32)
    for c in pod.spec.topology_spread_constraints:
        if c.when_unsatisfiable != SCHEDULE_ANYWAY:
            continue
        values = {_value(node, c.topology_key) for node in nodes}
        values.discard(None)
        counts = {v: _spread_count(nodes, bound, c.topology_key, v, pod,
                                   c.label_selector) for v in values}
        top = max(counts.values(), default=0)
        for n, node in enumerate(nodes):
            value = _value(node, c.topology_key)
            if value is not None:
                out[n] = out[n] + float(top - counts[value])
    return out


def pod_topology_spread_normalize(raw: torch.Tensor,
                                  feasible: torch.Tensor) -> torch.Tensor:
    """(N,) float32: each feasible node's score times 100 over the
    feasible nodes' largest, 0 at infeasible nodes, the row unchanged
    where that largest is 0."""
    masked = torch.where(feasible, raw, torch.zeros_like(raw))
    top = torch.tensor(0.0, dtype=torch.float32)
    for n in range(raw.shape[0]):
        top = masked[n] if masked[n] > top else top
    if not top > 0:
        return masked
    scale = torch.tensor(100.0, dtype=torch.float32) / top
    out = torch.zeros_like(raw)
    for n in range(raw.shape[0]):
        out[n] = masked[n] * scale
    return out

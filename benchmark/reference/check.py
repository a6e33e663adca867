"""The plain reference: the scheduler's guarantees and its choices,
recomputed from the cell's own inputs with NumPy (and, for the control,
PyTorch's bfloat16 on the host).

It imports nothing of the program. It is handed numbers: the nodes the
benchmark made, the pods it created, and, as the program's output to be
judged, the node each pod was bound to with the store's bind stamp and
resource version. From those it rebuilds the order of decisions: pods
bound in one bulk commit share one stamp and form one batch, batches
follow the order in which their pods were created (the queue is first in,
first out at one priority), and a batch's pods follow their resource
versions, which the bulk commit gives in the batch's row order.

Two kinds of numbers come out:

* counts of broken guarantees (exact: their limit is 0): a node over its
  allocatable cpu, memory, pods or attach slots, a pod on a cordoned
  node, a claim's pod outside its volume's zone, a claim on two nodes, a
  DoNotSchedule group's zones more than ``max_skew`` apart after a batch,
  a choice that was not feasible when it was made, a pod never bound;
* each sampled pod's score gap: how far the reference's score of the
  chosen node lies below the best score among all the nodes that were
  feasible for that pod when its batch ran it. Feasibility reads the
  state after the batch's earlier pods; the scores read the state the
  batch started from, as upstream's default scorers (v1beta2 weights)
  give them in continuous form:

  - NodeResourcesFit (LeastAllocated) and BalancedAllocation over cpu
    and memory;
  - InterPodAffinity: for each node, the weight of every preferred term
    of the pod times the matching bound pods in the node's zone, plus,
    symmetrically, the weight of every bound pod's preferred term that
    the pod matches, in that pod's zone; min-max normalized to 0..100
    over the nodes feasible at the batch's start;
  - PodTopologySpread scores ScheduleAnyway constraints only: a pod whose
    constraints are all DoNotSchedule gets no spread score;
  - ImageLocality, NodeAffinity and TaintToleration give every node the
    same score under these cells' pods and nodes (no images, no affinity
    to nodes, no taints), so they move no choice.

A ``Scoring`` names the weights; ``variants`` of it score the same
choices under other rules (a diagnostic that locates a departure, never
part of ``correct``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np


@dataclass
class Nodes:
    cpu: np.ndarray        # allocatable millicores
    memory: np.ndarray     # allocatable bytes
    pods: np.ndarray       # allocatable pod slots
    volumes: np.ndarray    # attach slots
    cordoned: np.ndarray   # bool
    zone: np.ndarray       # int


@dataclass
class Pods:
    """Every pod the run created, in creation order (``seq``)."""

    seq: np.ndarray        # creation index
    cpu: np.ndarray
    memory: np.ndarray
    claim_zone: np.ndarray  # -1: no claim
    spread: np.ndarray     # bool: carries the DoNotSchedule zone constraint
    affinity: np.ndarray   # bool: carries the preferred zone affinity
    node: np.ndarray       # bound node index, -1 unbound (the output)
    stamp: np.ndarray      # the store's bind stamp (nan unbound)
    version: np.ndarray    # the store's resource version at the bind
    claim_nodes: np.ndarray  # distinct nodes mounting the pod's claim


@dataclass
class Scoring:
    weight_fit: float       # NodeResourcesFit (LeastAllocated)
    weight_balanced: float  # NodeResourcesBalancedAllocation
    max_skew: int = 0       # of the DoNotSchedule constraint (0: none)
    weight_affinity: float = 0.0  # InterPodAffinity
    term_weight: float = 0.0      # each preferred zone term's weight
    # Departures from upstream a variant may take: score DoNotSchedule
    # constraints (PodTopologySpread at ``weight_spread``, max - count
    # over the max, normalized over the batch's start without the skew
    # filter), and leave out the bound pods' own preferred terms.
    weight_spread: float = 0.0
    score_do_not_schedule: bool = False
    symmetric_affinity: bool = True


def batches(p: Pods):
    """The bound pods' indices, one array per batch, in decision order."""
    bound = np.flatnonzero(p.node >= 0)
    if not len(bound):
        return []
    stamps, inv = np.unique(p.stamp[bound], return_inverse=True)
    groups = [[] for _ in range(len(stamps))]
    for k, i in zip(inv, bound):
        groups[k].append(i)
    out = [np.asarray(g)[np.argsort(p.version[g], kind="stable")]
           for g in groups]
    out.sort(key=lambda g: int(p.seq[g].min()))
    return out


def resource_scores(n: Nodes, used_cpu, used_mem, cpu, mem, w: Scoring,
                    dtype=np.float64) -> np.ndarray:
    """The weighted resource scores of placing a pod asking ``cpu`` and
    ``mem`` on every node whose use is ``used_*``, computed in ``dtype``
    (float64, or "bfloat16" for the control)."""
    if dtype == "bfloat16":
        return _resource_scores_bf16(n, used_cpu, used_mem, cpu, mem, w)
    ucpu = (used_cpu + cpu) / n.cpu
    umem = (used_mem + mem) / n.memory
    least = 100.0 * ((1.0 - ucpu) + (1.0 - umem)) / 2.0
    a, b = np.clip(ucpu, 0.0, 1.0), np.clip(umem, 0.0, 1.0)
    balanced = 100.0 - np.abs(a - b) / 2.0 * 100.0
    return w.weight_fit * least + w.weight_balanced * balanced


def _resource_scores_bf16(n, used_cpu, used_mem, cpu, mem, w):
    import torch

    def t(x):
        return torch.as_tensor(np.asarray(x, dtype=np.float64)).to(
            torch.bfloat16)

    ucpu = (t(used_cpu) + t(cpu)) / t(n.cpu)
    umem = (t(used_mem) + t(mem)) / t(n.memory)
    one, hundred = t(1.0), t(100.0)
    least = hundred * ((one - ucpu) + (one - umem)) / t(2.0)
    a, b = ucpu.clamp(0.0, 1.0), umem.clamp(0.0, 1.0)
    balanced = hundred - (a - b).abs() / t(2.0) * hundred
    s = t(w.weight_fit) * least + t(w.weight_balanced) * balanced
    return s.float().numpy().astype(np.float64)


class _State:
    """Per-node use, and per-zone counts of the pods that carry the
    traffic's labels (the DoNotSchedule group) and of those that carry
    the preferred zone term."""

    def __init__(self, n: Nodes, zones: int):
        N = len(n.cpu)
        self.cpu = np.zeros(N)
        self.mem = np.zeros(N)
        self.pods = np.zeros(N)
        self.vols = np.zeros(N)
        self.zone_counts = np.zeros(zones)
        self.aff_counts = np.zeros(zones)

    def add(self, n: Nodes, p: Pods, idx) -> None:
        nodes = p.node[idx]
        np.add.at(self.cpu, nodes, p.cpu[idx])
        np.add.at(self.mem, nodes, p.memory[idx])
        np.add.at(self.pods, nodes, 1.0)
        np.add.at(self.vols, nodes, (p.claim_zone[idx] >= 0).astype(float))
        sp = idx[p.spread[idx]]
        np.add.at(self.zone_counts, n.zone[p.node[sp]], 1.0)
        af = idx[p.affinity[idx]]
        np.add.at(self.aff_counts, n.zone[p.node[af]], 1.0)

    def copy(self) -> "_State":
        c = object.__new__(_State)
        for k, v in vars(self).items():
            setattr(c, k, v.copy())
        return c


def feasible(n: Nodes, p: Pods, i: int, run: _State, w: Scoring,
             skew: bool = True) -> np.ndarray:
    """The nodes pod ``i`` could take in state ``run`` (``skew``: with
    the DoNotSchedule constraint's check)."""
    ok = ~n.cordoned
    ok &= n.cpu - run.cpu >= p.cpu[i]
    ok &= n.memory - run.mem >= p.memory[i]
    ok &= n.pods - run.pods >= 1.0
    if p.claim_zone[i] >= 0:
        ok &= n.zone == p.claim_zone[i]
        ok &= n.volumes - run.vols >= 1.0
    if skew and p.spread[i] and w.max_skew:
        after = run.zone_counts + 1.0 - run.zone_counts.min()
        ok &= (after <= w.max_skew)[n.zone]
    return ok


def zone_scores(n: Nodes, p: Pods, i: int, start: _State, w: Scoring,
                ok0: np.ndarray) -> np.ndarray:
    """The weighted topology scores of pod ``i`` on every node, from the
    batch's starting state, normalized over ``ok0`` (the nodes feasible
    at the batch's start)."""
    out = np.zeros(len(n.cpu))
    if not ok0.any():
        return out
    if w.weight_affinity and w.term_weight:
        raw = np.zeros_like(start.zone_counts)
        if p.affinity[i]:
            raw += w.term_weight * start.zone_counts
        if p.spread[i] and w.symmetric_affinity:
            raw += w.term_weight * start.aff_counts
        per_node = raw[n.zone]
        lo, hi = per_node[ok0].min(), per_node[ok0].max()
        if hi > lo:
            out += w.weight_affinity * 100.0 * (per_node - lo) / (hi - lo)
    if w.score_do_not_schedule and w.weight_spread and p.spread[i]:
        zc = start.zone_counts
        per_node = (zc.max() - zc)[n.zone]
        hi = np.where(ok0, per_node, 0.0).max()
        if hi > 0:
            out += w.weight_spread * 100.0 * per_node / hi
    return out


def compare(n: Nodes, p: Pods, w: Scoring, sample: np.ndarray,
            controls: tuple = (), tie_seed: int = 0,
            variants: Optional[Dict[str, Scoring]] = None
            ) -> Dict[str, float]:
    """Every guarantee count, and the widest score gap over the pods in
    ``sample`` (indices into ``p``). ``controls`` names lower precisions
    ("bfloat16") whose own first choices are judged on the same pods and
    states; each adds ``score_gap.<precision>``. Each of ``variants``
    (name: Scoring) scores the program's choices under its own rules and
    adds ``score_gap.<name>``."""
    variants = variants or {}
    zones = int(n.zone.max()) + 1
    out: Dict[str, float] = {}
    bound = p.node >= 0
    out["unbound"] = float((~bound).sum())
    b = np.flatnonzero(bound)
    N = len(n.cpu)
    use = {k: np.bincount(p.node[b], weights=v[b], minlength=N)
           for k, v in (("cpu", p.cpu), ("mem", p.memory))}
    count = np.bincount(p.node[b], minlength=N)
    vols = np.bincount(p.node[b], weights=(p.claim_zone[b] >= 0)
                       .astype(float), minlength=N)
    over = ((use["cpu"] > n.cpu) | (use["mem"] > n.memory)
            | (count > n.pods) | (vols > n.volumes))
    out["overcommitted_nodes"] = float(over.sum())
    out["cordoned_binds"] = float(n.cordoned[p.node[b]].sum())
    claimed = b[p.claim_zone[b] >= 0]
    out["zone_mismatches"] = float(
        (n.zone[p.node[claimed]] != p.claim_zone[claimed]).sum())
    out["shared_claims"] = float((p.claim_nodes[b] > 1).sum())

    sampled = set(int(i) for i in sample)
    state = _State(n, zones)
    gaps = []
    other_gaps = {k: [] for k in list(controls) + list(variants)}
    infeasible = 0
    skew_excess = 0.0
    rs = np.random.default_rng([tie_seed % (1 << 64), 7])
    for batch in batches(p):
        start = state.copy()
        picks = [j for j, i in enumerate(batch) if int(i) in sampled]
        for j in picks:
            i = int(batch[j])
            run = start.copy()
            if j:
                run.add(n, p, batch[:j])
            ok = feasible(n, p, i, run, w)
            chosen = int(p.node[i])
            if not ok[chosen]:
                infeasible += 1
                continue
            res = resource_scores(n, start.cpu, start.mem, p.cpu[i],
                                  p.memory[i], w)
            topo = zone_scores(n, p, i, start, w,
                               feasible(n, p, i, start, w))
            s = res + topo
            best = s[ok].max()
            gaps.append(best - s[chosen])
            for c in controls:
                sc = _round(resource_scores(
                    n, start.cpu, start.mem, p.cpu[i], p.memory[i], w,
                    dtype=c) + _round(topo, c), c)
                sc = np.where(ok, sc, -np.inf)
                top = np.flatnonzero(sc == sc.max())
                pick = int(top[rs.integers(len(top))])
                other_gaps[c].append(best - s[pick])
            for name, v in variants.items():
                ok0 = feasible(n, p, i, start, v,
                               skew=not v.score_do_not_schedule)
                sv = res + zone_scores(n, p, i, start, v, ok0)
                other_gaps[name].append(sv[ok].max() - sv[chosen])
        state.add(n, p, batch)
        if w.max_skew:
            zc = state.zone_counts
            skew_excess = max(skew_excess,
                              float(zc.max() - zc.min() - w.max_skew))
    out["skew_excess"] = skew_excess if w.max_skew else 0.0
    out["infeasible_choices"] = float(infeasible)
    out["score_gap"] = float(max(gaps)) if gaps else 0.0
    out["gaps_judged"] = float(len(gaps))
    for k, g in other_gaps.items():
        out[f"score_gap.{k}"] = float(max(g)) if g else 0.0
    return out


def _round(x: np.ndarray, dtype: str) -> np.ndarray:
    import torch

    return torch.as_tensor(x).to(getattr(torch, dtype)).double().numpy()


def sample(p: Pods, size: int, seed: int,
           among: Optional[np.ndarray] = None) -> np.ndarray:
    """A seeded sample of the bound pods (of ``among`` when given)."""
    pool = np.flatnonzero(p.node >= 0)
    if among is not None:
        pool = np.intersect1d(pool, among)
    if len(pool) <= size:
        return pool
    r = np.random.default_rng([seed % (1 << 64), 11])
    return np.sort(r.choice(pool, size=size, replace=False))

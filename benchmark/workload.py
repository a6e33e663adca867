"""The cluster and the pods of a cell, made from ``--seed``.

Frozen copies of the repository's generators (``bench_workload.py``,
``chip_smoke.bench_workload``, ``full_workload`` and ``c4_pods``), driven
by the data of one configuration file and one traffic file, so that a
later change to those generators cannot move this benchmark. A seed
changes the order of the sizes and arrivals and never their multiset:
every seed schedules the same work.

The objects are the port's own types (``minisched_tpu_torch.state.
objects``): the benchmark creates them in the system's store. The
plain reference (``benchmark/reference``) reads them back as numbers.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

ZONE_KEY = "topology.kubernetes.io/zone"
NAMESPACE = "bench"


def rng(seed: int, stream: int) -> np.random.Generator:
    """One named stream of the run's seed (any whole number)."""
    return np.random.default_rng([seed % (1 << 64), stream])


def node_name(i: int) -> str:
    return f"node-{i}"


def node_arrays(cluster: dict, seed: int):
    """(cpu millis, cordoned, zone index) per node: the four core counts
    in equal numbers in a seeded order, every ``cordon_every``-th node
    cordoned, zones round-robin."""
    n = cluster["nodes"]
    choices = np.asarray(cluster["node_cpu_millis"], dtype=np.float64)
    cpu = np.resize(choices, n)
    cpu = cpu[rng(seed, 1).permutation(n)]
    idx = np.arange(n)
    cordoned = idx % cluster["cordon_every"] == 0
    return cpu, cordoned, idx % cluster["zones"]


def make_nodes(cluster: dict, seed: int, objects) -> list:
    cpu, cordoned, zone = node_arrays(cluster, seed)
    out = []
    for i in range(cluster["nodes"]):
        z = f"z{zone[i]}"
        out.append(objects.Node(
            metadata=objects.ObjectMeta(
                name=node_name(i),
                labels={key: z for key in cluster["zone_labels"]}),
            spec=objects.NodeSpec(unschedulable=bool(cordoned[i])),
            status=objects.NodeStatus(allocatable={
                "cpu": float(cpu[i]),
                "memory": float(cluster["node_memory_bytes"]),
                "pods": float(cluster["node_max_pods"]),
                "attachable-volumes": float(cluster["attachable_volumes"]),
            })))
    return out


@dataclass
class PodShape:
    """What the reference needs of one created pod."""

    seq: int
    cpu: float
    memory: float
    claim_zone: int       # -1: no claim
    spread: bool          # carries the traffic's DoNotSchedule constraint
    affinity: bool        # carries the preferred pod affinity


class PodSource:
    """The cell's pods in creation order: pod ``seq`` has a cpu request
    from a seeded order of the mix's sizes (each size equally often in
    every block of ``len(sizes) * 64`` pods), ``memory_bytes``, and the
    mix's claim and spread terms by its index."""

    def __init__(self, pod: dict, zones: int, seed: int):
        self.pod = pod
        self.zones = zones
        self.seed = seed
        sizes = np.asarray(pod["cpu_millis"], dtype=np.float64)
        self._block = np.resize(sizes, len(sizes) * 64)
        self._blocks: dict = {}

    def cpu(self, seq: int) -> float:
        b, i = divmod(seq, len(self._block))
        perm = self._blocks.get(b)
        if perm is None:
            perm = self._blocks[b] = rng(self.seed, 1000 + b).permutation(
                len(self._block))
        return float(self._block[perm[i]])

    def shape(self, seq: int) -> PodShape:
        p = self.pod
        every = p.get("claim_every", 0)
        spread = p.get("spread")
        return PodShape(
            seq=seq, cpu=self.cpu(seq), memory=float(p["memory_bytes"]),
            claim_zone=(seq % self.zones if every and seq % every == 0
                        else -1),
            spread=spread is not None,
            affinity=bool(spread and spread.get("affinity_every")
                          and seq % spread["affinity_every"] == 0))

    def objects(self, seqs, objects) -> List:
        """The store objects for pods ``seqs``: each claim's PV and PVC
        (Bound) first, then the pods."""
        first, pods = [], []
        spread = self.pod.get("spread")
        sel = (objects.LabelSelector(match_labels=dict(spread["labels"]))
               if spread else None)
        for seq in seqs:
            s = self.shape(seq)
            spec = objects.PodSpec(requests={"cpu": s.cpu,
                                             "memory": s.memory})
            labels = {}
            if s.claim_zone >= 0:
                first.append(objects.PersistentVolume(
                    metadata=objects.ObjectMeta(
                        name=f"pv{seq}",
                        labels={ZONE_KEY: f"z{s.claim_zone}"}),
                    capacity={"ephemeral-storage":
                              float(self.pod["claim_bytes"])},
                    phase="Bound", claim_ref=f"{NAMESPACE}/c{seq}"))
                first.append(objects.PersistentVolumeClaim(
                    metadata=objects.ObjectMeta(name=f"c{seq}",
                                                namespace=NAMESPACE),
                    request={"ephemeral-storage":
                             float(self.pod["claim_bytes"])},
                    volume_name=f"pv{seq}", phase="Bound"))
                spec.volumes = [objects.VolumeClaim(claim_name=f"c{seq}")]
            if s.spread:
                labels.update(spread["labels"])
                spec.topology_spread_constraints = [
                    objects.TopologySpreadConstraint(
                        max_skew=spread["max_skew"],
                        topology_key=spread["topology_key"],
                        when_unsatisfiable=spread["when_unsatisfiable"],
                        label_selector=sel)]
            if s.affinity:
                spec.affinity = objects.Affinity(
                    pod_affinity=objects.PodAffinity(preferred=[
                        objects.WeightedPodAffinityTerm(
                            weight=spread["affinity_weight"],
                            term=objects.PodAffinityTerm(
                                label_selector=sel,
                                topology_key=spread["topology_key"]))]))
            pods.append(objects.Pod(
                metadata=objects.ObjectMeta(name=f"p{seq}",
                                            namespace=NAMESPACE,
                                            labels=labels),
                spec=spec))
        return first + pods


def pod_seq(name: str) -> int:
    """The creation index of the pod named ``name`` (``p<seq>``)."""
    return int(name[1:])

"""The cell's inputs are made from the seed alone: the same seed gives the
same inputs, another seed the same work in another order."""
import numpy as np
import pytest

from benchmark import spec, workload
from minisched_tpu_torch.state import objects as O

SEEDS = (0, 2**31 + 12345, 98765432109)


def cluster():
    c = dict(spec.cell(spec.benchmark()["workloads"][0]["name"])
             .config["cluster"])
    c["nodes"] = 1000
    return c


@pytest.mark.parametrize("seed", SEEDS)
def test_nodes_deterministic_and_same_multiset(seed):
    c = cluster()
    a = workload.node_arrays(c, seed)
    b = workload.node_arrays(c, seed)
    for x, y in zip(a, b):
        assert np.array_equal(x, y)
    base = workload.node_arrays(c, 1)
    assert np.array_equal(np.sort(a[0]), np.sort(base[0]))
    assert a[1].sum() == base[1].sum() == 11   # every 97th of 1,000
    nodes = workload.make_nodes(c, seed, O)
    assert [n.status.allocatable["cpu"] for n in nodes] == list(a[0])
    assert nodes[0].spec.unschedulable and not nodes[1].spec.unschedulable
    assert nodes[5].metadata.labels == {"zone": "z5", workload.ZONE_KEY: "z5"}


@pytest.mark.parametrize("seed", SEEDS)
def test_pods_deterministic(seed):
    t = spec.cell("kube-default-50k.backlog10k-claims").traffic
    a = workload.PodSource(t["pod"], 16, seed)
    b = workload.PodSource(t["pod"], 16, seed)
    seqs = range(0, 3000)
    assert [a.cpu(s) for s in seqs] == [b.cpu(s) for s in seqs]
    block = len(t["pod"]["cpu_millis"]) * 64
    one = sorted(a.cpu(s) for s in range(block))
    other = sorted(workload.PodSource(t["pod"], 16, 7).cpu(s)
                   for s in range(block))
    assert one == other
    objs = a.objects(range(10), O)
    pods = [o for o in objs if isinstance(o, O.Pod)]
    assert [p.metadata.name for p in pods] == [f"p{i}" for i in range(10)]
    assert pods[0].spec.volumes and pods[5].spec.volumes
    assert not pods[1].spec.volumes
    pvs = [o for o in objs if isinstance(o, O.PersistentVolume)]
    assert [pv.metadata.labels[workload.ZONE_KEY] for pv in pvs] == [
        "z0", "z5"]


def test_spread_pods():
    t = spec.cell("kube-default-50k-adaptive.backlog10k-spread-hard").traffic
    src = workload.PodSource(t["pod"], 16, 3)
    pods = src.objects(range(4), O)
    assert all(p.metadata.labels == {"app": "bench"} for p in pods)
    c = pods[0].spec.topology_spread_constraints[0]
    assert (c.max_skew, c.when_unsatisfiable, c.topology_key) == (
        1, "DoNotSchedule", "zone")
    assert pods[0].spec.affinity and not pods[1].spec.affinity
    assert not any(p.spec.volumes for p in pods)

"""Shared inputs for the parity tests of the PyTorch port (test_torch_*.py).

Each recipe takes an objects module (``minisched_tpu.state.objects`` or
``minisched_tpu_torch.state.objects``) so both packages get the same
cluster from the same seed, built from their own object types.
"""
from __future__ import annotations

import numpy as np

BENCH_PLUGINS = ["NodeUnschedulable", "NodeResourcesFit",
                 "NodeResourcesLeastAllocated",
                 "NodeResourcesBalancedAllocation"]
# Profile kwargs shared by minisched_tpu's and the port's Profile.
BENCH_PROFILE = dict(name="bench", plugins=BENCH_PLUGINS,
                     plugin_args={"NodeResourcesFit": {"score_strategy": None}})
LIVE_PROFILE = dict()  # NodeUnschedulable + NodeNumber (the default)


def bench_cluster(O, n_nodes: int, n_pods: int, seed: int = 0):
    """bench_workload.make_workload's cluster: node CPU 4-32 cores, ~1%
    unschedulable, 16 zones; pods of 0.25-1.75 cores + 2 GiB."""
    rng = np.random.default_rng(seed)
    node_cpus = np.array([4000, 8000, 16000, 32000])[
        rng.integers(0, 4, n_nodes)]
    pod_cpus = rng.integers(1, 8, n_pods) * 250
    nodes = [O.Node(metadata=O.ObjectMeta(name=f"node-{i}-{i % 10}",
                                          labels={"zone": f"z{i % 16}"}),
                    spec=O.NodeSpec(unschedulable=bool(i % 97 == 0)),
                    status=O.NodeStatus(allocatable={
                        "cpu": float(node_cpus[i]),
                        "memory": float(64 << 30), "pods": 110.0}))
             for i in range(n_nodes)]
    pods = [O.Pod(metadata=O.ObjectMeta(name=f"pod-{i}-{i % 10}",
                                        namespace="bench"),
                  spec=O.PodSpec(requests={"cpu": float(pod_cpus[i]),
                                           "memory": float(2 << 30)}))
            for i in range(n_pods)]
    return nodes, pods


def mixed_cluster(O, n_nodes: int, n_pods: int, seed: int = 0):
    """A harder cluster for the step: mixed node shapes (some without
    memory), cordoned nodes, pods with priorities, unschedulable
    tolerations, gangs and tight capacity, plus pods already bound.
    Returns (nodes, pending pods, [(bound pod, node name)])."""
    rng = np.random.default_rng(seed)
    nodes = []
    for i in range(n_nodes):
        alloc = {"cpu": float(rng.choice([1000, 2000, 3000, 4000])),
                 "pods": float(rng.integers(2, 8))}
        if i % 3:
            alloc["memory"] = float(rng.choice([4, 8, 16]) << 30)
        nodes.append(O.Node(
            metadata=O.ObjectMeta(name=f"n{i}-{i % 10}",
                                  labels={"zone": f"z{i % 4}"}),
            spec=O.NodeSpec(unschedulable=bool(rng.random() < 0.1)),
            status=O.NodeStatus(allocatable=alloc)))

    def pod(name, i):
        req = {"cpu": float(rng.integers(1, 9) * 125)}
        if rng.random() < 0.7:
            req["memory"] = float(rng.integers(1, 5) << 29)
        tol = []
        if rng.random() < 0.2:
            tol = [O.Toleration(key="node.kubernetes.io/unschedulable",
                                operator="Exists", effect="NoSchedule")]
        kw = {}
        if i % 7 == 3:
            kw = dict(pod_group=f"g{i % 3}", pod_group_min=3)
        return O.Pod(metadata=O.ObjectMeta(name=name, namespace="ns"),
                     spec=O.PodSpec(requests=req, tolerations=tol,
                                    priority=int(rng.integers(0, 3)), **kw))

    pending = [pod(f"p{i}-{i % 10}", i) for i in range(n_pods)]
    bound = [(pod(f"b{i}", 0), nodes[int(rng.integers(0, n_nodes))]
              .metadata.name) for i in range(n_nodes // 4)]
    return nodes, pending, bound


NEG = -3.0e38  # the masked-score sentinel of both packages

# Greedy-assignment shapes (P, N, cpu_free): tests/test_pallas_select.py's
# cases, P not a multiple of 8 and N not a multiple of 128.
GREEDY_SHAPES = [
    (16, 128, 500.0), (24, 128, 300.0), (16, 64, 500.0),
    (256, 127, 500.0), (256, 129, 500.0), (3, 1, 500.0),
    (13, 200, 500.0), (21, 300, 300.0),
]


def greedy_case(rng, P, N, R=4, quant=4, infeasible=0.2, cpu_free=500.0):
    """tests/test_pallas_select.py's random assignment case, drawn with
    numpy: quantized scores (ties), NEG on infeasible pairs, contended
    CPU. Returns float32 (scores, requests, free)."""
    s = rng.random((P, N), dtype=np.float32)
    if quant:
        s = (np.round(s * quant) / quant).astype(np.float32)
    s[rng.random((P, N)) < infeasible] = NEG
    req = np.concatenate([rng.random((P, 1)) * 300 + 100,
                          np.ones((P, R - 1))], axis=1).astype(np.float32)
    free = np.concatenate([np.full((N, 1), cpu_free),
                           np.full((N, R - 1), 50.0)],
                          axis=1).astype(np.float32)
    return s, req, free


def scarce_case(rng, P, N, R=10, quant=8):
    """Each node fits one pod (CPU 400 against requests of 300-399), and
    a node's score varies little from pod to pod, so consecutive pods
    want the same node: the winner of pod i is often the best fitting
    node of pod i+1 too, until pod i takes it. Returns float32 (scores,
    requests, free)."""
    base = rng.random((1, N))
    s = (np.round((base + 0.05 * rng.random((P, N))) * quant) / quant)
    s = s.astype(np.float32)
    req = np.concatenate([300 + np.floor(rng.random((P, 1)) * 100),
                          np.ones((P, R - 1))], axis=1).astype(np.float32)
    free = np.concatenate([np.full((N, 1), 400.0), np.full((N, R - 1), 50.0)],
                          axis=1).astype(np.float32)
    return s, req, free


def build_cache(cache_cls, nodes, bound=()):
    cache = cache_cls()
    cache.upsert_nodes_bulk(nodes)
    for pod, node_name in bound:
        cache.account_bind(pod, node_name=node_name)
    return cache


def leaves(tree):
    """Flat numpy leaves of a (nested) NamedTuple, in field order."""
    out = []
    for leaf in tree:
        if isinstance(leaf, tuple):
            out.extend(leaves(leaf))
        else:
            out.append(np.asarray(leaf))
    return out


def bits_equal(a, b) -> bool:
    """Exact equality including float bit patterns."""
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype.kind == "f":
        return np.array_equal(a.view(np.uint8), b.view(np.uint8))
    return np.array_equal(a, b)


def shortlist_problem(P, N, R, seed, *, plateau=False, contend=False):
    """tests/test_shortlist.py's random problem: scores in steps of 25
    (ties), NEG on 5% of pairs, requests and free in steps of 0.25/0.5;
    ``plateau`` makes every score 100 (the regime the noise-ordered
    boundary selection exists for), ``contend`` starves every node but a
    few so the shortlists run out and the scan repairs. Returns float32
    (scores, requests, free)."""
    rng = np.random.default_rng(seed)
    scores = rng.integers(0, 5, (P, N)).astype(np.float32) * 25.0
    if plateau:
        scores[:] = 100.0
    scores[rng.random((P, N)) < 0.05] = NEG
    requests = (rng.integers(1, 4, (P, R)) * 0.25).astype(np.float32)
    free = (rng.integers(1, 6, (N, R)) * 0.5).astype(np.float32)
    if contend:
        free[:] = 0.25
        free[: max(2, N // 64)] = 1000.0
    return scores, requests, free


# Shortlist scan cases (name, P, N, R, seed, K, kwargs): the cases of
# tests/test_shortlist.py (seeds x K, the plateau that stays certified,
# contention with repairs, the degenerate widths) plus rows of NEG only.
SHORTLIST_CASES = (
    [(f"random-s{s}-k{k}", 96, 384, 3, s, k, {})
     for s in (0, 1, 2) for k in (1, 16, 128)]
    + [("plateau", 128, 512, 3, 7, 16, {"plateau": True}),
       ("contention", 128, 512, 3, 3, 8, {"contend": True})]
    + [(f"width-k{k}", 64, 384, 3, 9, k, {}) for k in (1, 384, 4096)]
    + [("all-neg-rows", 48, 200, 3, 4, 16, {"neg_rows": (0, 5, 47)})])


def shortlist_case(P, N, R, seed, neg_rows=(), **kw):
    scores, requests, free = shortlist_problem(P, N, R, seed, **kw)
    scores[list(neg_rows)] = NEG
    return scores, requests, free


# Rows for the selection kernel's list path (csrc/shortlist_select.cu),
# each aimed at one of its branches: (scores (P,N) float32, K). The card
# also takes "rows-walked", too large for the CPU models.
SELECT_LIST_KINDS = ["one-wider-than-k", "all-distinct", "top-exactly-k",
                     "bench-like", "rebuilt", "exact-after-overflow"]
SELECT_CARD_LIST_KINDS = SELECT_LIST_KINDS + ["rows-walked"]


def select_list_case(kind, rng, P=4):
    k, N = 128, 3000
    if kind in ("one-wider-than-k", "top-exactly-k"):
        # The K-th value held by K+1 nodes (all but one are taken), or
        # exactly K nodes at the top.
        s = rng.integers(0, 50, (P, N)).astype(np.float32)
        for row in s:
            row[rng.choice(N, k + (kind == "one-wider-than-k"),
                           replace=False)] = 100.0
    elif kind == "all-distinct":  # kth lies above L: compaction helps least
        N = 20000
        s = np.stack([rng.permutation(N) for _ in range(P)]) * 0.25
    elif kind == "bench-like":  # a quarter of the row at each of 4 values
        N = 8192
        s = rng.choice(np.float32([181.25, 190.625, 195.3125, 196.875]),
                       (P, N))
        s[rng.random((P, N)) < 0.01] = NEG
    elif kind == "rebuilt":
        # Threads 0..K-2 (column j is thread j mod 1024) hold one node at
        # 10 and otherwise nodes at 5; thread K-1 one node at 5: L = 5,
        # whose count the thread maxima underestimate 5000-fold, so the
        # first list overflows and the rebuilt one fits.
        N = 1024 * 40
        s = np.ones((P, N), np.float32)
        s[:, np.arange(N) % 1024 < k - 1] = 5.0
        s[:, :k - 1] = 10.0
        s[:, k - 1] = 5.0
    elif kind == "exact-after-overflow":
        # K=384 threads hold four values above 10 each: about 1,200 nodes
        # lie above L, more than the list holds, so the row takes the
        # exact path.
        k, N = 384, 1024 * 4
        s = rng.random((P, N))
        s[:, np.arange(N) % 1024 < k] += 10.0
    elif kind == "rows-walked":
        # 203 cached rows of 53,248 columns over 132 SMs: blocks walk one
        # or two rows, each of another branch (a bench plateau, distinct
        # values, signed zeros at L for the exact path, NEG only).
        P, N = 203, 53248
        s = rng.choice(np.float32([181.25, 190.625, 195.3125, 196.875]),
                       (P, N))
        s[1::4] = rng.random((len(range(1, P, 4)), N), dtype=np.float32)
        s[2::4] = np.where(rng.random((len(range(2, P, 4)), N)) < 0.5,
                           0.0, -0.0)
        s[2::4, ::5000] = 5.0
        s[3::4] = NEG
    else:
        raise ValueError(kind)
    return s.astype(np.float32), k


def ports_case(rng, N=40, PORT=8, P=48, PP=4):
    """A port-heavy batch for the port-insertion op: node rows partly
    filled (some full, so ports overflow), pods with 0-4 nonzero ports on
    a few hot rows, -1 rows skipped. Returns int32 (state, rows, ports)."""
    state = rng.integers(0, 3, (N, PORT)).astype(np.int32) * rng.integers(
        1000, 2000, (N, PORT)).astype(np.int32)
    state[:3] = 7  # full rows: every insertion there is dropped
    rows = rng.integers(-1, 8, P).astype(np.int32)
    ports = rng.integers(0, 9000, (P, PP)).astype(np.int32)
    ports[rng.random((P, PP)) < 0.3] = 0
    return state, rows, ports



PORTS_DESIGN_KINDS = ["one-row", "distinct-rows", "full-rows", "padding",
                      "duplicates", "port-3", "port-40"]


def ports_design_case(kind, rng, P=64):
    """Batches for the port-insertion kernel's grouping by node: every
    pod on one row (the longest chain), every pod on its own row, rows
    so full that ports drop, -1 padding after the live pods, duplicate
    port values, and PORT = 3 or 40. Returns int32 (state, rows, ports)."""
    N, PORT, PP = 200, 8, 4
    if kind == "port-3":
        PORT = 3
    elif kind == "port-40":
        PORT, PP = 40, 6
    state = (rng.integers(0, 2, (N, PORT))
             * rng.integers(1000, 2000, (N, PORT))).astype(np.int32)
    rows = rng.integers(0, 24, P).astype(np.int32)
    ports = rng.integers(20000, 40000, (P, PP)).astype(np.int32)
    ports[rng.random((P, PP)) < 0.3] = 0
    if kind == "one-row":
        rows[:] = 7
        state[7] = 0
        state[7, ::3] = 99
    elif kind == "distinct-rows":
        rows = rng.permutation(N)[:P].astype(np.int32)
    elif kind == "full-rows":
        state[: N // 2] = 5
        state[N // 2:, : PORT - 1] = 5  # one free slot per row
        rows = rng.integers(0, N, P).astype(np.int32)
    elif kind == "padding":
        rows[P // 2:] = -1
        ports[P // 2:] = 0
        rows[: P // 2: 5] = -1
    elif kind == "duplicates":
        ports = rng.choice(np.int32([0, 80, 443]), (P, PP))
    return state, rows, ports


# The NodePorts profile and port-heavy burst of the JAX package's own
# residency test (tests/test_device_residency.py:491): four 64-core nodes,
# 24 pods of decreasing priority, each asking for two distinct host ports.
PORTS_PROFILE = dict(name="ports",
                     plugins=["NodeUnschedulable", "NodeResourcesFit",
                              "NodePorts"],
                     plugin_args={"NodeResourcesFit": {"score_strategy": None}})


def port_heavy_cluster(O, n_nodes: int = 4, n_pods: int = 24):
    # The nodes of Cluster.create_node(f"pn{i}", cpu=64000).
    nodes = [O.Node(metadata=O.ObjectMeta(name=f"pn{i}"),
                    status=O.NodeStatus(allocatable={
                        "cpu": 64000, "memory": 16 << 30, "pods": 110,
                        "accelerator": 0}))
             for i in range(n_nodes)]
    pods = [O.Pod(metadata=O.ObjectMeta(name=f"pp-{i}", namespace="default"),
                  spec=O.PodSpec(requests={"cpu": 100 + i},
                                 priority=200 - i,
                                 ports=[O.ContainerPort(host_port=20000 + i),
                                        O.ContainerPort(host_port=30000 + i)]))
            for i in range(n_pods)]
    return nodes, pods


def ports_cluster(O, seed: int):
    """mixed_cluster with host ports from a small pool on the bound and
    the pending pods, so that NodePorts rejects some (pod, node) pairs."""
    nodes, pending, bound = mixed_cluster(O, 96, 40, seed)
    rng = np.random.default_rng(seed + 100)
    pool = [8080, 8081, 9090, 9091, 30000]
    for pod in pending + [p for p, _ in bound]:
        k = int(rng.integers(0, 3))
        pod.spec.ports = [O.ContainerPort(host_port=int(h))
                          for h in rng.choice(pool, k, replace=False)]
    return nodes, pending, bound


def sampled_cluster(O, n_nodes: int = 1200, n_pods: int = 256,
                    seed: int = 0):
    """bench_cluster at a size where the default config samples nodes,
    plus one pod the sample cannot place: a 200-core node whose memory
    and CPU a pod already bound there mostly use (so its free-capacity
    proxy ranks it far below the K sampled nodes) and a pending pod of
    100 cores that fits only there. The sampled step finds that pod
    0-feasible and the same-cycle full-axis residual pass places it.
    Returns (objects to create first: nodes and the bound pod, pending
    pods)."""
    nodes, pods = bench_cluster(O, n_nodes, n_pods, seed)
    big = O.Node(metadata=O.ObjectMeta(name="big-node",
                                       labels={"zone": "z0"}),
                 status=O.NodeStatus(allocatable={
                     "cpu": 200000.0, "memory": float(64 << 30),
                     "pods": 110.0}))
    resident = O.Pod(metadata=O.ObjectMeta(name="resident", namespace="bench"),
                     spec=O.PodSpec(node_name="big-node", requests={
                         "cpu": 60000.0, "memory": float(127 << 29)}))
    pinned = O.Pod(metadata=O.ObjectMeta(name="only-fits-big",
                                         namespace="bench"),
                   spec=O.PodSpec(requests={"cpu": 100000.0,
                                            "memory": float(1 << 28)}))
    return nodes + [big, resident], pods[:100] + [pinned] + pods[100:]


ZONE = "topology.kubernetes.io/zone"
HOST = "kubernetes.io/hostname"
AVOID = "scheduler.alpha.kubernetes.io/preferAvoidPods"


def full_cluster(O, n_nodes: int, n_pods: int, seed: int = 0,
                 hard: bool = True):
    """A cluster for the eight label and topology plugins: nodes with
    zone, rack and disk labels (some without a zone), taints of every
    effect, cached images and the avoid annotation; pending pods with
    spread constraints (DoNotSchedule when ``hard``, else ScheduleAnyway,
    over zone or hostname), required and preferred pod (anti-)affinity,
    node selectors and node affinity, tolerations, images, controller
    owners and a required node name; bound pods with the same labels,
    some with a required anti-affinity term (the symmetric slots).
    Returns (nodes, pending pods, [(bound pod, node name)])."""
    rng = np.random.default_rng(seed)
    apps = ["web", "cache", "db"]
    images = ["img/a:1", "img/b:2", "img/c:3", "img/d:4"]
    nodes = []
    for i in range(n_nodes):
        labels = {"disk": str(rng.choice(["ssd", "hdd"])),
                  "rack": f"r{i % 5}"}
        if rng.random() < 0.9:
            labels[ZONE] = f"z{i % 4}"
        taints = []
        if rng.random() < 0.25:
            taints.append(O.Taint(
                key=str(rng.choice(["dedicated", "maint", "gpu"])),
                value=str(rng.choice(["ml", "web", ""])),
                effect=str(rng.choice(["NoSchedule", "PreferNoSchedule",
                                       "NoExecute"]))))
        if rng.random() < 0.15:
            taints.append(O.Taint(key="maint", value="",
                                  effect="PreferNoSchedule"))
        annotations = {AVOID: "x"} if rng.random() < 0.2 else {}
        nodes.append(O.Node(
            metadata=O.ObjectMeta(name=f"fn{i}", labels=labels,
                                  annotations=annotations),
            spec=O.NodeSpec(unschedulable=bool(rng.random() < 0.05),
                            taints=taints),
            status=O.NodeStatus(
                allocatable={"cpu": float(rng.choice([2000, 4000, 8000])),
                             "memory": float(16 << 30), "pods": 110.0},
                images=[str(x) for x in rng.choice(images,
                                                   int(rng.integers(0, 3)),
                                                   replace=False)])))

    def sel(app):
        return O.LabelSelector(match_labels={"app": app})

    def term(app, key):
        return O.PodAffinityTerm(label_selector=sel(app), topology_key=key)

    def make_pod(name, i, bound=False):
        app = str(rng.choice(apps))
        spec = dict(requests={"cpu": float(rng.integers(1, 8) * 100)},
                    priority=int(rng.integers(0, 3)))
        key = ZONE if rng.random() < 0.7 else HOST
        if not bound and rng.random() < 0.6:
            spec["topology_spread_constraints"] = [
                O.TopologySpreadConstraint(
                    max_skew=int(rng.integers(1, 3)), topology_key=key,
                    when_unsatisfiable=("DoNotSchedule"
                                        if hard and rng.random() < 0.7
                                        else "ScheduleAnyway"),
                    label_selector=sel(app))]
        pa = O.PodAffinity()
        anti = O.PodAntiAffinity()
        r = rng.random()
        if not bound and r < 0.15:
            pa.required = [term(str(rng.choice(apps)), ZONE)]
        if not bound and rng.random() < 0.4:
            pa.preferred = [O.WeightedPodAffinityTerm(
                weight=int(rng.integers(1, 20)),
                term=term(str(rng.choice(apps)), ZONE))]
        if rng.random() < 0.12:
            anti.required = [term(str(rng.choice(apps)),
                                  HOST if rng.random() < 0.5 else ZONE)]
        if not bound and rng.random() < 0.2:
            anti.preferred = [O.WeightedPodAffinityTerm(
                weight=int(rng.integers(1, 20)), term=term(app, HOST))]
        na = None
        if not bound and rng.random() < 0.3:
            na = O.NodeAffinity(
                required=(O.NodeSelector(node_selector_terms=[
                    O.NodeSelectorTerm(match_expressions=[
                        O.NodeSelectorRequirement(
                            key="rack", operator=str(rng.choice(
                                ["In", "NotIn"])),
                            values=["r0", "r1", "r2"])]),
                    O.NodeSelectorTerm(match_expressions=[
                        O.NodeSelectorRequirement(key="gpu",
                                                  operator="Exists")])])
                    if rng.random() < 0.5 else None),
                preferred=[O.PreferredSchedulingTerm(
                    weight=int(rng.integers(1, 50)),
                    preference=O.NodeSelectorTerm(match_expressions=[
                        O.NodeSelectorRequirement(
                            key="disk", operator="In", values=["ssd"])]))])
        if not bound and rng.random() < 0.2:
            spec["node_selector"] = {"disk": str(rng.choice(["ssd", "hdd"]))}
        spec["affinity"] = O.Affinity(node_affinity=na, pod_affinity=pa,
                                      pod_anti_affinity=anti)
        if rng.random() < 0.4:
            spec["tolerations"] = [O.Toleration(
                key=str(rng.choice(["dedicated", "maint", ""])),
                operator=str(rng.choice(["Equal", "Exists"])),
                value=str(rng.choice(["ml", "web", ""])),
                effect=str(rng.choice(["", "NoSchedule",
                                       "PreferNoSchedule"])))]
        if rng.random() < 0.4:
            spec["images"] = [str(x) for x in rng.choice(
                images, int(rng.integers(1, 3)), replace=False)]
        if not bound and rng.random() < 0.03:
            spec["required_node_name"] = f"fn{int(rng.integers(0, n_nodes))}"
        owners = []
        if rng.random() < 0.5:
            owners = [O.OwnerReference(
                kind=str(rng.choice(["ReplicaSet", "ReplicationController",
                                     "StatefulSet"])),
                name=f"o{int(rng.integers(0, 3))}", controller=True)]
        return O.Pod(metadata=O.ObjectMeta(
            name=name, namespace=str(rng.choice(["default", "prod"])),
            labels={"app": app}, owner_references=owners),
            spec=O.PodSpec(**spec))

    pending = [make_pod(f"fp{i}", i) for i in range(n_pods)]
    bound = [(make_pod(f"fb{i}", i, bound=True),
              f"fn{int(rng.integers(0, n_nodes))}")
             for i in range(max(1, n_nodes // 2))]
    return nodes, pending, bound


CAPS_KINDS = ["spreadcap-burst", "prebatch-imbalance", "random-hard-0",
              "random-hard-1", "hostname-overflow", "all-unenforced",
              "multi-block"]


def caps_problem(kind: str, seed: int = 0):
    """A caps-scan input built with the port's own encoder, topology
    tables and spreadcap (CPU tensors): (scores, requests, free, u32
    seed, DomainCaps). Scores are random in steps of 25 (ties) with NEG
    on 10% of pairs; requests and free are the encoded pods' and nodes'.
    Kinds: tests/test_spreadcap.py's 48-pod burst over 4 zones and its
    pre-batch imbalance; random full_cluster batches (zone and hostname
    groups, both compact); hostname spread over 200 nodes (more domains
    than the caps compact: those slots are not enforced); a soft-only
    batch (no slot enforced); and a 512-pod DoNotSchedule burst over
    3,000 nodes in 16 zones (many blocks on a card)."""
    import torch

    from minisched_tpu_torch.encode import (NodeFeatureCache, encode_pods,
                                            to_torch)
    from minisched_tpu_torch.ops.spreadcap import build_domain_caps
    from minisched_tpu_torch.ops.topology import group_topology_state
    from minisched_tpu_torch.state import objects as O

    def spread(name, key=ZONE, skew=1, mode="DoNotSchedule", app="s"):
        return O.Pod(metadata=O.ObjectMeta(name=name, namespace="default",
                                           labels={"app": app}),
                     spec=O.PodSpec(requests={"cpu": 100.0},
                                    topology_spread_constraints=[
                                        O.TopologySpreadConstraint(
                                            max_skew=skew, topology_key=key,
                                            when_unsatisfiable=mode,
                                            label_selector=O.LabelSelector(
                                                match_labels={"app": app}))]))

    def zone_nodes(n, zones, cpu=64000.0):
        return [O.Node(metadata=O.ObjectMeta(name=f"n{i:04d}", labels={
            ZONE: f"z{i % zones}", HOST: f"n{i:04d}"}),
            status=O.NodeStatus(allocatable={"cpu": cpu, "pods": 110.0}))
            for i in range(n)]

    bound = []
    if kind == "spreadcap-burst":
        nodes, pods = zone_nodes(16, 4), [spread(f"p{i}") for i in range(48)]
    elif kind == "prebatch-imbalance":
        nodes, pods = zone_nodes(16, 4), [spread(f"q{i}") for i in range(13)]
        bound = [(O.Pod(metadata=O.ObjectMeta(name=f"pre{j}",
                                              namespace="default",
                                              labels={"app": "s"}),
                        spec=O.PodSpec(requests={"cpu": 100.0})), "n0000")
                 for j in range(3)]
    elif kind.startswith("random-hard-"):
        nodes, pods, bound = full_cluster(O, 48, 40, int(kind[-1]) + seed)
    elif kind == "hostname-overflow":
        nodes = zone_nodes(200, 4)
        pods = ([spread(f"h{i}", key=HOST) for i in range(40)]
                + [spread(f"z{i}", app="t") for i in range(24)])
    elif kind == "all-unenforced":
        nodes = zone_nodes(40, 4)
        pods = [spread(f"u{i}", mode="ScheduleAnyway") for i in range(48)]
    elif kind == "multi-block":
        nodes = zone_nodes(3000, 16, cpu=4000.0)
        pods = [spread(f"m{i}") for i in range(512)]
    else:
        raise ValueError(kind)
    cache = NodeFeatureCache()
    cache.upsert_nodes_bulk(nodes)
    for pod, node_name in bound:
        pod.spec.node_name = node_name
        cache.account_bind(pod)
    eb = encode_pods(pods, max(16, 1 << (len(pods) - 1).bit_length()),
                     cfg=cache.cfg, registry=cache.registry)
    nf, _names, _sv, _incs = cache.snapshot_versioned()
    af = cache.snapshot_assigned()
    eb, nf, af = (to_torch(x, "cpu") for x in (eb, nf, af))
    num = max(nf.valid.shape[0], cache.cfg.domain_buckets)
    topo = group_topology_state(nf, af, eb.gf, num)
    caps = build_domain_caps(eb.pf, eb.gf, nf, topo["counts_dom"],
                             topo["dom_exists"])
    rng = np.random.default_rng(seed + 11)
    P, N = eb.pf.valid.shape[0], nf.valid.shape[0]
    scores = (rng.integers(0, 4, (P, N)) * 25.0).astype(np.float32)
    scores[rng.random((P, N)) < 0.1] = NEG
    scores[~eb.pf.valid.numpy()] = NEG
    return (torch.from_numpy(scores), eb.pf.requests.clone(),
            nf.free.clone(), int(rng.integers(0, 1 << 32)), caps)


def volume_cluster(O, n_nodes: int = 120, n_pods: int = 240, seed: int = 0):
    """A cluster for the full default profile: bench-like nodes in four
    zones with attach limits, a few tainted PreferNoSchedule; a
    zone-labelled PV per pod that wants one; bound holder pods pinning
    claims to nodes; and pending pods with pinned, unused, zone-bound and
    cloud-typed claims (no claim shared within a batch: an RWO revocation
    retries on the backoff's clock, which would make later batches
    timing-dependent), and (among the pods without claims) host ports,
    with tolerations beside plain pods. Everything fits.
    Returns (nodes, PVs, claims and holders; pending pods)."""
    rng = np.random.default_rng(seed)
    first = []
    for i in range(n_nodes):
        taints = ([O.Taint(key="maint", value="", effect="PreferNoSchedule")]
                  if rng.random() < 0.1 else [])
        first.append(O.Node(
            metadata=O.ObjectMeta(name=f"vn{i}",
                                  labels={ZONE: f"z{i % 4}"}),
            spec=O.NodeSpec(taints=taints),
            status=O.NodeStatus(allocatable={
                "cpu": float(rng.choice([8000, 16000])),
                "memory": float(32 << 30), "pods": 110.0,
                "attachable-volumes": float(rng.choice([4, 8]))})))
    n_pin = max(4, n_nodes // 10)
    for k in range(n_pods):  # one zone-labelled PV per pod that wants one
        first.append(O.PersistentVolume(
            metadata=O.ObjectMeta(name=f"pv-z{k}",
                                  labels={ZONE: f"z{k % 4}"}),
            capacity={"ephemeral-storage": float(1 << 30)}, phase="Bound",
            claim_ref=f"default/zc{k}"))
        first.append(O.PersistentVolumeClaim(
            metadata=O.ObjectMeta(name=f"zc{k}", namespace="default"),
            request={"ephemeral-storage": float(1 << 30)},
            volume_name=f"pv-z{k}", phase="Bound"))
    for k in range(n_pin):
        first.append(O.PersistentVolumeClaim(
            metadata=O.ObjectMeta(name=f"pin{k}", namespace="default"),
            phase="Bound"))
        first.append(O.Pod(
            metadata=O.ObjectMeta(name=f"holder{k}", namespace="default"),
            spec=O.PodSpec(requests={"cpu": 100.0},
                           volumes=[O.VolumeClaim(claim_name=f"pin{k}")],
                           node_name=f"vn{(7 * k) % n_nodes}")))
    for k in range(n_pods):
        first.append(O.PersistentVolumeClaim(
            metadata=O.ObjectMeta(name=f"u{k}", namespace="default"),
            phase="Bound"))
    pods = []
    for i in range(n_pods):
        r = rng.random()
        vols, spec = [], {}
        if r < 0.2:
            k = int(rng.integers(0, n_pin))
            vols = [O.VolumeClaim(claim_name=f"pin{k}")]
        elif r < 0.35:
            vols = [O.VolumeClaim(claim_name=f"zc{i}")]
        elif r < 0.55:
            vols = [O.VolumeClaim(claim_name=f"u{i}")]
        elif r < 0.7:
            vols = [O.VolumeClaim(claim_name=f"u{i}", volume_type="aws-ebs")]
        if not vols and rng.random() < 0.4:
            spec["ports"] = [O.ContainerPort(
                host_port=int(rng.choice([8080, 8443, 9090])))]
        if rng.random() < 0.2:
            spec["tolerations"] = [O.Toleration(key="maint",
                                                operator="Exists")]
        pods.append(O.Pod(
            metadata=O.ObjectMeta(name=f"vp{i}", namespace="default",
                                  labels={"app": "bench"}),
            spec=O.PodSpec(requests={"cpu": float(rng.integers(1, 5) * 100),
                                     "memory": float(1 << 30)},
                           priority=int(rng.integers(0, 3)),
                           volumes=vols, **spec)))
    return first, pods

"""Shared inputs for the parity tests of the PyTorch port (test_torch_*.py).

Each recipe takes an objects module (``minisched_tpu.state.objects`` or
``minisched_tpu_torch.state.objects``) so both packages get the same
cluster from the same seed, built from their own object types.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from minisched_tpu_torch.encode import features as F
from minisched_tpu_torch.plugins.base import PluginSet
from minisched_tpu_torch.plugins.interpodaffinity import InterPodAffinity
from minisched_tpu_torch.plugins.podtopologyspread import PodTopologySpread
from minisched_tpu_torch.service.defaultconfig import Profile, make_plugin

BENCH_PLUGINS = ["NodeUnschedulable", "NodeResourcesFit",
                 "NodeResourcesLeastAllocated",
                 "NodeResourcesBalancedAllocation"]
# Profile kwargs shared by minisched_tpu's and the port's Profile.
BENCH_PROFILE = dict(name="bench", plugins=BENCH_PLUGINS,
                     plugin_args={"NodeResourcesFit": {"score_strategy": None}})
LIVE_PROFILE = dict()  # NodeUnschedulable + NodeNumber (the default)

# The JAX package's InterPodAffinity and PodTopologySpread rules, as
# subclasses of the port's plugins (whose rules are upstream's); a parity
# case builds the port's side with them (``jax_rules``, ``port_plugin``).


class JaxInterPodAffinity(InterPodAffinity):
    """No symmetric existing-pod term, and the normalization range
    counting 0.0 at every infeasible node."""

    row_stats = ("min", "max")

    def score(self, pf, nf, ctx):
        return super().score(pf, nf, {k: v for k, v in ctx.items()
                                      if k != "sym_rows"})


class JaxPodTopologySpread(PodTopologySpread):
    """DoNotSchedule constraints scored as ScheduleAnyway ones, and no
    check deferred from the nodes the scorers normalize over."""

    def score(self, pf, nf, ctx):
        live = pf.spread_group >= 0
        mode = torch.where(
            live, torch.full_like(pf.spread_mode, F.SPREAD_SCHEDULE_ANYWAY),
            torch.full_like(pf.spread_mode, F.SPREAD_DO_NOT_SCHEDULE))
        return super().score(pf._replace(spread_mode=mode), nf, ctx)

    def deferred_filter(self, pf, nf, ctx):
        return None


JAX_RULES = {"InterPodAffinity": JaxInterPodAffinity,
             "PodTopologySpread": JaxPodTopologySpread}


def on_jax_rules(plugin):
    """``plugin``, or its JAX-rules twin with the same instance state."""
    cls = JAX_RULES.get(plugin.name)
    if cls is None or isinstance(plugin, cls):
        return plugin
    twin = cls.__new__(cls)
    twin.__dict__.update(plugin.__dict__)
    return twin


@dataclasses.dataclass
class JaxRulesProfile(Profile):
    """A port profile whose topology plugins follow the JAX package's
    rules (``JAX_RULES``)."""

    def build(self) -> PluginSet:
        built = super().build()
        return PluginSet([on_jax_rules(p) for p in built.plugins],
                         built.weights)


def jax_rules(profile):
    """The port's ``profile`` (service.defaultconfig.Profile) on the JAX
    package's rules."""
    return JaxRulesProfile(**{f.name: getattr(profile, f.name)
                              for f in dataclasses.fields(profile)})


def port_plugin(name: str, **args):
    """The port's plugin ``name`` (service.defaultconfig.make_plugin) on
    the JAX package's rules, for a parity case."""
    return on_jax_rules(make_plugin(name, **args))


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


def leaves(tree, like=None):
    """Flat numpy leaves of a (nested) NamedTuple, in field order. With
    ``like`` (the JAX package's tree of the same type), the leaves of
    ``like``'s fields, in its order: a field only the port has (the
    symmetric term's ``sym_slot`` and ``sym``) must then be empty, a
    zero-size array or None, as an encoding without that term leaves
    it."""
    if like is None:
        out = []
        for leaf in tree:
            if isinstance(leaf, tuple):
                out.extend(leaves(leaf))
            else:
                out.append(np.asarray(leaf))
        return out
    out = []
    for name in tree._fields:
        leaf = getattr(tree, name)
        if name not in like._fields:
            assert leaf is None or np.asarray(leaf).size == 0, name
            continue
        other = getattr(like, name)
        if isinstance(leaf, tuple):
            out.extend(leaves(leaf, other))
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
              "multi-block", "zone-chase", "two-groups", "one-fit-nodes",
              "mixed-enforced"]


def caps_problem(kind: str, seed: int = 0):
    """A caps-scan input built with the port's own encoder, topology
    tables and spreadcap (CPU tensors): (scores, requests, free, u32
    seed, DomainCaps). Scores are random in steps of 25 (ties) with NEG
    on 10% of pairs; requests and free are the encoded pods' and nodes'.
    Kinds: tests/test_spreadcap.py's 48-pod burst over 4 zones and its
    pre-batch imbalance; random full_cluster batches (zone and hostname
    groups, both compact); hostname spread over 200 nodes (more domains
    than the caps compact: those slots are not enforced); a soft-only
    batch (no slot enforced); a 512-pod DoNotSchedule burst over
    3,000 nodes in 16 zones (many blocks on a card); and the cases of
    the caps kernel's look-ahead: a skew-1 burst over 16 zones whose
    pods all prefer the same zones in the same order (the winner's zone
    closes on the next pod's best candidate nearly every pod, the
    minimum rises every 16th), pods with two enforced slots in two
    groups of which each pod matches one, nodes that fit exactly one pod
    and score highest (the next pod's candidate is debited away), and a
    batch mixing enforced, unconstrained and ScheduleAnyway pods."""
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

    def zone_nodes(n, zones, cpu=64000.0, racks=0):
        return [O.Node(metadata=O.ObjectMeta(name=f"n{i:04d}", labels={
            ZONE: f"z{i % zones}", HOST: f"n{i:04d}",
            **({"rack": f"r{i % racks}"} if racks else {})}),
            status=O.NodeStatus(allocatable={"cpu": cpu, "pods": 110.0}))
            for i in range(n)]

    def plain(name, app="s"):
        return O.Pod(metadata=O.ObjectMeta(name=name, namespace="default",
                                           labels={"app": app}),
                     spec=O.PodSpec(requests={"cpu": 100.0}))

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
    elif kind == "zone-chase":
        nodes, pods = zone_nodes(320, 16), [spread(f"c{i}")
                                            for i in range(100)]
    elif kind == "two-groups":
        nodes = zone_nodes(60, 4, racks=5)
        pods = []
        for i in range(40):
            app = "s" if i % 3 else "t"
            pod = spread(f"g{i}", app=app)
            pod.spec.topology_spread_constraints = [
                O.TopologySpreadConstraint(
                    max_skew=1, topology_key=key,
                    when_unsatisfiable="DoNotSchedule",
                    label_selector=O.LabelSelector(match_labels={"app": a}))
                for key, a in ((ZONE, "s"), ("rack", "t"))]
            pods.append(pod)
    elif kind == "one-fit-nodes":
        nodes = zone_nodes(64, 4, cpu=4000.0)
        for n in nodes[:8]:
            n.status.allocatable["cpu"] = 150.0
        pods = [spread(f"o{i}", skew=50) for i in range(48)]
    elif kind == "mixed-enforced":
        nodes = zone_nodes(48, 4)
        pods = [spread(f"x{i}") if i % 3 == 0 else plain(f"x{i}")
                if i % 3 == 1 else spread(f"x{i}", mode="ScheduleAnyway")
                for i in range(60)]
    else:
        raise ValueError(kind)
    cache = NodeFeatureCache()
    cache.upsert_nodes_bulk(nodes)
    for pod, node_name in bound:
        pod.spec.node_name = node_name
        cache.account_bind(pod)
    eb = encode_pods(pods, max(16, 1 << (len(pods) - 1).bit_length()),
                     cfg=cache.cfg, registry=cache.registry)
    nf, names, _sv, _incs = cache.snapshot_versioned()
    af = cache.snapshot_assigned()
    eb, nf, af = (to_torch(x, "cpu") for x in (eb, nf, af))
    num = max(nf.valid.shape[0], cache.cfg.domain_buckets)
    topo = group_topology_state(nf, af, eb.gf, num)
    caps = build_domain_caps(eb.pf, eb.gf, nf, topo["counts_dom"],
                             topo["dom_exists"])
    rng = np.random.default_rng(seed + 11)
    P, N = eb.pf.valid.shape[0], nf.valid.shape[0]
    scores = (rng.integers(0, 4, (P, N)) * 25.0).astype(np.float32)
    # Node row -> the index in its name (zone_nodes' n0000...), -1 for
    # padding and other names.
    node_ix = np.full((N,), -1, np.int64)
    for row, name in enumerate(names[:N]):
        if name and name[0] == "n" and name[1:].isdigit():
            node_ix[row] = int(name[1:])
    if kind == "zone-chase":  # every pod ranks the zones alike
        zone = np.where(node_ix >= 0, node_ix % 16, 99)
        scores = (100.0 - 4.0 * zone[None, :]
                  + rng.integers(0, 2, (P, N))).astype(np.float32)
    elif kind == "one-fit-nodes":  # the one-pod nodes score highest
        scores = np.where((node_ix >= 0) & (node_ix < 8), 100.0,
                          scores).astype(np.float32)
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


# ---- the auction's instances (tests/test_auction.py's shapes) ------------


def auction_instance(P, N, R=4, seed=0, infeasible_frac=0.2, cap_lo=2,
                     cap_hi=6):
    """tests/test_auction.py's random instance: scores in [0, 100), NEG on
    a fifth of the pairs, requests of 100-300 and free of cap_lo-cap_hi
    times 300 per axis."""
    rng = np.random.default_rng(seed)
    scores = rng.random((P, N)).astype(np.float32) * 100.0
    scores[rng.random((P, N)) < infeasible_frac] = np.float32(NEG)
    requests = (rng.integers(1, 4, (P, R)) * 100).astype(np.float32)
    free = (rng.integers(cap_lo, cap_hi, (N, R)) * 300).astype(np.float32)
    return scores, requests, free


def auction_contention(seed=2):
    """32 pods on 4 nodes that each fit about three of them."""
    rng = np.random.default_rng(seed)
    scores = (rng.random((32, 4)) * 10).astype(np.float32)
    return (scores, np.full((32, 2), 100.0, np.float32),
            np.full((4, 2), 300.0, np.float32))


def auction_adversarial(seed):
    """Deep contention on two-level plateaus: 24 pods, 8 nodes of exactly
    three slots each."""
    rng = np.random.default_rng(seed)
    scores = (np.round(rng.random((24, 8)) * 2) * 50).astype(np.float32)
    return (scores, np.full((24, 1), 100.0, np.float32),
            np.full((8, 1), 300.0, np.float32))


def auction_plateau():
    """Two score levels over 96 nodes with room for every pod: the fold's
    noise certifies a K=8 shortlist every round."""
    rng = np.random.default_rng(31)
    scores = np.where(rng.random((16, 96)) < 0.5, 50.0, 25.0).astype(
        np.float32)
    return (scores, np.full((16, 2), 100.0, np.float32),
            np.full((96, 2), 400.0, np.float32))


def auction_signed_zero():
    """Rows of -0.0 and +0.0 with three 5.0 entries on every other row."""
    rng = np.random.default_rng(4)
    scores = np.where(rng.random((12, 300)) < 0.5, 0.0, -0.0).astype(
        np.float32)
    for row in scores[::2]:
        row[rng.choice(300, 3, replace=False)] = 5.0
    return (scores, np.ones((12, 2), np.float32),
            np.full((300, 2), 1.0, np.float32))


def auction_padded():
    """Two everywhere-infeasible pods and four padded rows (NEG, zero
    requests) in two bands."""
    scores, req, free = auction_instance(20, 30, seed=8)
    scores[[2, 9]] = NEG
    scores[16:] = NEG
    req[16:] = 0.0
    return scores, req, free


def auction_kth_ties():
    """Rows whose K-th folded key falls in a run of equal keys: scores of
    1e6 and 2e6 fold to themselves (the noise times eps is below half
    their ulp), so the set takes the lowest tied columns."""
    rng = np.random.default_rng(12)
    scores = (rng.random((24, 300)) * 100).astype(np.float32)
    scores[rng.random((24, 300)) < 0.2] = np.float32(NEG)
    for row in scores:
        row[rng.choice(300, 100, replace=False)] = 1e6
        row[rng.choice(300, 3, replace=False)] = 2e6
    return (scores, np.full((24, 2), 100.0, np.float32),
            np.full((300, 2), 300.0, np.float32))


def auction_row_plateau():
    """Every column of a row holds the same folded key (1e6): the set is
    the row's first K columns."""
    scores = np.full((16, 256), 1e6, np.float32)
    scores[8:, :40] = np.float32(NEG)
    return (scores, np.full((16, 2), 100.0, np.float32),
            np.full((256, 2), 200.0, np.float32))


def auction_select_case(name: str):
    """Rows that take each path of the bid-shortlist kernel's threshold
    selection at card sizes: (scores, requests, free, k).

    ties walked      K=128 cuts a run of ~1,200 equal keys spread from
                     column 450 on (more ties than the list holds: the
                     ordered walk crosses 512-column strides), and rows
                     whose ties fit the list;
    plateau walked   whole rows of one key, and rows whose first 1,000
                     columns are infeasible;
    zeros at kth     rows of +0.0 and -0.0 around the K-th key;
    K = N            every column is in the set;
    uncached paths   rows of 65,536 columns (their keys do not fit in
                     shared memory) in one launch: a random row (ranked),
                     a row whose 128 largest thread maxima hold all their
                     columns' largest keys (the list overflows: the exact
                     path), a plateau, a row with fewer feasible columns
                     than K, and tied keys at the K-th."""
    rng = np.random.default_rng(len(name))
    if name == "ties walked":
        P, N, k = 8, 4096, 128
        scores = (rng.random((P, N)) * 100).astype(np.float32)
        scores[:, :20] = 3e6
        for r in range(P):
            step = 3 if r % 2 == 0 else 17
            scores[r, 450::step] = 1e6
    elif name == "plateau walked":
        P, N, k = 8, 4096, 128
        scores = np.full((P, N), 1e6, np.float32)
        scores[4:, :1000] = np.float32(NEG)
    elif name == "zeros at kth":
        P, N, k = 8, 2048, 64
        scores = np.where(rng.random((P, N)) < 0.5, 0.0, -0.0).astype(
            np.float32)
        for row in scores:
            row[rng.choice(N, 10, replace=False)] = 5.0
    elif name == "K = N":
        P, N = 8, 2048
        k = N
        scores = (rng.random((P, N)) * 100).astype(np.float32)
        scores[rng.random((P, N)) < 0.3] = np.float32(NEG)
    elif name == "uncached paths":
        P, N, k = 6, 65536, 128
        scores = (rng.random((P, N)) * 100).astype(np.float32)
        # Thread t of the kernel folds float4 t, t + 512, ...: give the
        # first 128 threads' columns the row's largest scores.
        cols = np.arange(N)
        scores[1, (cols // 4) % 512 < 128] += 1000.0
        scores[2] = 1e6
        scores[3, 50:] = np.float32(NEG)
        scores[4, 3000::7] = 1e6
        scores[4, :64] = 2e6
    else:
        raise ValueError(name)
    return (scores, np.full((P, 2), 100.0, np.float32),
            np.full((N, 2), 300.0, np.float32), k)


AUCTION_SELECT_CASES = ["ties walked", "plateau walked", "zeros at kth",
                        "K = N", "uncached paths"]

# The auction kernels once refused batches over 32 x 512 pods.
OLD_AUCTION_CAP = 16384


def auction_past_cap(P=OLD_AUCTION_CAP + 1, N=24, n_feasible=64, seed=41):
    """A batch past the old cap whose feasible rows are its last
    ``n_feasible`` (row P - 1 among them): every earlier row is NEG. The
    feasible pods contend in three priority bands for N nodes of two
    slots each (fewer slots than pods). Returns (scores, requests, free,
    priority)."""
    rng = np.random.default_rng(seed)
    scores = np.full((P, N), NEG, np.float32)
    tail = (rng.random((n_feasible, N)) * 100).astype(np.float32)
    tail[rng.random((n_feasible, N)) < 0.2] = np.float32(NEG)
    scores[P - n_feasible:] = tail
    requests = (rng.integers(1, 4, (P, 2)) * 100).astype(np.float32)
    free = np.full((N, 2), 600.0, np.float32)
    prio = np.zeros((P,), np.int32)
    prio[P - n_feasible:] = (np.arange(n_feasible) % 3) * 5
    return scores, requests, free, prio


def auction_past_cap_cluster(O, n_pods=OLD_AUCTION_CAP + 1, n_nodes=64,
                             n_feasible=65, seed=43):
    """A cluster and a batch past the old cap for build_step: bench_cluster
    nodes (no unschedulable one) and n_pods pods of which only the last
    ``n_feasible`` fit any node (the others ask for more CPU than any
    node has), in three priorities."""
    nodes, _ = bench_cluster(O, n_nodes, 0, seed)
    for n in nodes:
        n.spec.unschedulable = False
    rng = np.random.default_rng(seed)
    pods = []
    for i in range(n_pods):
        fits = i >= n_pods - n_feasible
        cpu = float(rng.integers(1, 8) * 250) if fits else 1e9
        pods.append(O.Pod(
            metadata=O.ObjectMeta(name=f"cap-{i}", namespace="bench"),
            spec=O.PodSpec(requests={"cpu": cpu, "memory": float(2 << 30)},
                           priority=int(i % 3) if fits else 0)))
    return nodes, pods

# name -> (builder, priorities or None, bid-shortlist widths)
AUCTION_CASES = {
    "abundant 64x256": (lambda: auction_instance(64, 256, seed=1), None,
                        (1, 16, 256)),
    "scarce 48x40": (lambda: auction_instance(48, 40, seed=3, cap_lo=1,
                                              cap_hi=3), None, (2, 40)),
    "contention 32x4": (auction_contention, None, (1, 2, 4)),
    "three bands": (lambda: auction_instance(40, 64, seed=20, cap_lo=1,
                                             cap_hi=3),
                    (np.arange(40) % 3) * 7, (1, 16, 64)),
    "bands, scarce": (lambda: auction_instance(30, 12, seed=5, cap_lo=1,
                                               cap_hi=2),
                      np.array([5, 1, 3] * 10), (2, 12)),
    "adversarial": (lambda: auction_adversarial(0), None, (2,)),
    "plateau": (auction_plateau, None, (8,)),
    "signed zeros": (auction_signed_zero, None, (1, 7, 300)),
    "padded": (auction_padded, np.array([3] * 8 + [1] * 12), (4,)),
    "kth ties": (auction_kth_ties, None, (8, 64, 300)),
    "row plateau": (auction_row_plateau, None, (4, 64, 256)),
    "past the old cap": (lambda: auction_past_cap()[:3],
                         auction_past_cap()[3], (1, 16)),
}

FOLD_EPS, HALF_EPS = np.float32(0.01), np.float32(0.005)


def fma32(a, b, c) -> np.float32:
    """float32(a * b + c) rounded once (exact rational arithmetic)."""
    from fractions import Fraction

    exact = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    f = np.float32(float(exact))
    near = (f, np.nextafter(f, np.float32(-np.inf)),
            np.nextafter(f, np.float32(np.inf)))
    return np.float32(min(near, key=lambda x: (
        abs(Fraction(float(x)) - exact), int(x.view(np.int32)) & 1)))


def sep32(a, b, c) -> np.float32:
    """float32(a * b + c) rounded twice: the product, then the sum."""
    return np.float32(np.float32(np.float32(a) * np.float32(b))
                      + np.float32(c))


def auction_fold_case(noise):
    """One pod, two nodes whose noise fold ranks the nodes one way rounded
    once and the other way rounded twice. ``noise(i, cols)`` is the tie
    noise lattice of the batch's seed. Returns (scores, the node one
    rounding picks)."""
    n = noise(0, np.arange(2))
    s0 = np.float32(0.011)
    f0 = fma32(n[0], FOLD_EPS, s0)
    assert f0 == sep32(n[0], FOLD_EPS, s0)
    base = np.float32(s0 + n[0] * FOLD_EPS - n[1] * FOLD_EPS)
    for d in range(-400, 400):
        s1 = np.float32(base + np.float32(d) * np.spacing(base))
        fused = 1 if fma32(n[1], FOLD_EPS, s1) > f0 else 0
        split = 1 if sep32(n[1], FOLD_EPS, s1) > f0 else 0
        if fused != split:
            return np.array([[s0, s1]], np.float32), fused
    raise AssertionError("no fold case for this seed")


def auction_strength_case(noise, P=16):
    """Two pods bidding on node 0 in round 0 whose strengths order one way
    rounded once and the other way rounded twice (their folds agree).
    Returns (scores (P,2), the winning pod rounded once, rounded
    twice)."""
    rows = np.arange(P)
    rn, fn = noise(0, rows), noise(rows, 0)
    s1 = np.float32(0.011)
    for r1 in range(P):
        v1 = fma32(fn[r1], FOLD_EPS, s1)
        a, b = fma32(rn[r1], HALF_EPS, v1), sep32(rn[r1], HALF_EPS, v1)
        if a == b:
            continue
        hi = max(a, b)
        for r0 in range(P):
            if r0 == r1:
                continue
            guess = np.float32(hi - rn[r0] * HALF_EPS - fn[r0] * FOLD_EPS)
            for d in range(-8, 9):
                s0 = np.float32(guess + np.float32(d) * np.spacing(guess))
                v0 = fma32(fn[r0], FOLD_EPS, s0)
                c = fma32(rn[r0], HALF_EPS, v0)
                if c == hi == sep32(rn[r0], HALF_EPS, v0):
                    def winner(st1):
                        return r1 if (st1, r1) > (c, r0) else r0
                    scores = np.full((P, 2), NEG, np.float32)
                    scores[r0, 0], scores[r1, 0] = s0, s1
                    return scores, winner(a), winner(b)
    raise AssertionError("no strength case for this seed")


def auction_tie_case(noise):
    """Pods 1 and 3 bid on node 0 with exactly equal strengths in round 0
    (node 0 fits one pod; node 2 takes the other). Returns (scores, req,
    free)."""
    rows = np.arange(4)
    rn, fn = noise(0, rows), noise(rows, 0)
    target = fma32(rn[3], HALF_EPS, fma32(fn[3], FOLD_EPS, np.float32(40.0)))
    guess = np.float32(target - rn[1] * HALF_EPS - fn[1] * FOLD_EPS)
    for d in range(-64, 65):
        s1 = np.float32(guess + np.float32(d) * np.spacing(guess))
        if fma32(rn[1], HALF_EPS, fma32(fn[1], FOLD_EPS, s1)) == target:
            scores = np.full((4, 3), NEG, np.float32)
            scores[1, 0], scores[3, 0] = s1, 40.0
            scores[:, 2] = 1.0
            return (scores, np.ones((4, 1), np.float32),
                    np.array([[1.0], [0.0], [8.0]], np.float32))
    raise AssertionError("no tie case for this seed")

"""The port's engine on BASELINE config 4 (topology spread + inter-pod
affinity, bench_workload.make_c4_workload) against the JAX engine: the
same store, seed and SchedulerConfig give the same placements and the
same shared counters, soft (ScheduleAnyway, max_skew 8) and hard
(DoNotSchedule, max_skew 1: the caps scan, the host arbitration and its
in-cycle repair), in the six modes of test_torch_engine.py, at 120
nodes and at 1,200 (the soft burst samples nodes and takes a residual
pass). Then the scenarios of tests/test_spread_arbitration.py on the
port's arbitration, with spread_repair_iters 0 and 8, and chip_smoke's
config-4 recipe encoded equal to make_c4_workload's."""
import numpy as np
import pytest

import chip_smoke
from bench_workload import C4_PLUGINS, make_c4_workload
from minisched_tpu.config import SchedulerConfig as JConfig
from minisched_tpu.encode import NodeFeatureCache as JCache
from minisched_tpu.encode import encode_pods as jencode
from minisched_tpu.scenario.runner import Cluster as JCluster
from minisched_tpu.service.defaultconfig import Profile as JProfile
from minisched_tpu.state import objects as JO
from minisched_tpu_torch.config import SchedulerConfig
from minisched_tpu_torch.encode import NodeFeatureCache, encode_pods
from minisched_tpu_torch.engine.queue import QueuedPodInfo
from minisched_tpu_torch.engine.scheduler import (Scheduler,
                                                  _SpreadGroupState,
                                                  arbitrate_spread)
from minisched_tpu_torch.scenario.runner import Cluster
from minisched_tpu_torch.service.defaultconfig import Profile
from minisched_tpu_torch.state import objects as TO
from test_torch_engine import MODES, SHARED_METRICS, _run_cluster
from torch_parity import bits_equal, leaves, sampled_cluster

C4 = list(C4_PLUGINS)  # with DefaultPreemption, as bench.py runs it
ZONE = "topology.kubernetes.io/zone"


def _c4(O, n_nodes, n_pods, hard):
    skew = 1 if hard else 8
    if O is JO:
        make_nodes, make_pods = make_c4_workload(n_nodes, n_pods,
                                                 max_skew=skew, hard=hard)
        return make_nodes(), make_pods()
    return chip_smoke.c4_workload(n_nodes, n_pods, max_skew=skew,
                                  hard=hard)


def _c4_sampled(O):
    """sampled_cluster's 1,200 bench nodes, big node and resident pod,
    its pods (one fits only outside every sample) with config 4's soft
    constraints."""
    first, pods = sampled_cluster(O)
    return first, chip_smoke.c4_pods(pods, objects=O)


def _both(recipe, kw, seed=0):
    want, jm = _run_cluster(JCluster, JO, JProfile(name="c4", plugins=C4),
                            JConfig(**kw), 0, 0, seed, recipe=recipe)
    got, m = _run_cluster(Cluster, TO, Profile(name="c4", plugins=C4),
                          SchedulerConfig(platform="cpu", **kw), 0, 0, seed,
                          recipe=recipe)
    assert got == want
    for k in SHARED_METRICS:
        assert m[k] == jm[k], (k, m[k], jm[k])
    return m


@pytest.mark.parametrize("pipeline,resident,shortlist", MODES)
@pytest.mark.parametrize("hard", [False, True])
def test_c4_engine_matches_jax(hard, pipeline, resident, shortlist):
    """Config 4 at 120 nodes x 300 pods in batches of 64."""
    kw = dict(max_batch_size=64, seed=2, pipeline=pipeline,
              device_resident=resident, shortlist=shortlist, shortlist_k=8)
    m = _both(lambda O: _c4(O, 120, 300, hard), kw)
    assert m["pods_bound"] == 300
    assert m["hard_spread_batches"] == (m["batches"] if hard else 0)
    assert m["spread_revoked_enforced"] == 0


@pytest.mark.parametrize("pipeline,resident,shortlist", MODES)
def test_c4_sampled_engine_matches_jax(pipeline, resident, shortlist,
                                       monkeypatch):
    """Config 4 soft at 1,200 nodes: the default config samples K=512
    nodes per batch (the topology tables on the full axis), and one pod
    takes the full-axis residual pass."""
    residuals = []
    orig = Scheduler._run_residual

    def counted(self, b, rows, *a):
        residuals.append(len(rows))
        return orig(self, b, rows, *a)

    monkeypatch.setattr(Scheduler, "_run_residual", counted)
    kw = dict(max_batch_size=64, pipeline=pipeline,
              device_resident=resident, shortlist=shortlist)
    _both(_c4_sampled, kw)
    assert residuals and sum(residuals) >= 1


@pytest.mark.parametrize("pipeline,resident,shortlist", MODES)
def test_c4_hard_1200_matches_jax(pipeline, resident, shortlist):
    """Config 4 hard at 1,200 nodes: every batch keeps the full axis (the
    caps scan) where the default config would sample."""
    kw = dict(max_batch_size=64, pipeline=pipeline,
              device_resident=resident, shortlist=shortlist)
    m = _both(lambda O: _c4(O, 1200, 256, True), kw)
    assert m["hard_spread_batches"] == m["batches"]
    assert m["sampled_batches"] == 0


def test_chip_smoke_c4_recipe_encodes_like_make_c4_workload():
    """chip_smoke.c4_workload builds the port's objects of the JAX
    package's make_c4_workload: both encode to the same leaves, soft and
    hard."""
    for hard, skew in ((False, 8), (True, 1)):
        make_nodes, make_pods = make_c4_workload(300, 200, max_skew=skew,
                                                 hard=hard)
        nodes_t, pods_t = chip_smoke.c4_workload(300, 200, max_skew=skew,
                                                 hard=hard)
        out = []
        for nodes, pods, cache_cls, enc in (
                (make_nodes(), make_pods(), JCache, jencode),
                (nodes_t, pods_t, NodeFeatureCache, encode_pods)):
            cache = cache_cls()
            cache.upsert_nodes_bulk(nodes)
            nf, names, _sv, _incs = cache.snapshot_versioned()
            eb = enc(pods, 256, cfg=cache.cfg, registry=cache.registry)
            out.append((names, leaves(nf) + leaves(eb)))
        assert out[0][0] == out[1][0]
        for a, b in zip(out[0][1], out[1][1]):
            assert bits_equal(a, b)


# ---- tests/test_spread_arbitration.py on the port ----------------------

def _spread_pod(name, max_skew=1):
    return TO.Pod(
        metadata=TO.ObjectMeta(name=name, namespace="default",
                               labels={"app": "s"}),
        spec=TO.PodSpec(
            requests={"cpu": 100},
            topology_spread_constraints=[TO.TopologySpreadConstraint(
                max_skew=max_skew, topology_key=ZONE,
                when_unsatisfiable="DoNotSchedule",
                label_selector=TO.LabelSelector(
                    match_labels={"app": "s"}))]))


def _setup(n_pods, n_domains, chosen_dom, pre_counts):
    pods = [_spread_pod(f"p{i}") for i in range(n_pods)]
    eb = encode_pods(pods, n_pods)
    batch = [QueuedPodInfo(pod=p) for p in pods]
    assigned = np.ones(n_pods, dtype=bool)
    G = eb.gf.valid.shape[0]
    g = int(eb.pf.spread_group[0, 0])
    spread_dom = np.full((n_pods, G), -1, dtype=np.int32)
    spread_pre = np.zeros((n_pods, G), dtype=np.float32)
    for i in range(n_pods):
        spread_dom[i, g] = chosen_dom[i]
        spread_pre[i, g] = pre_counts[chosen_dom[i]]
    spread_min = np.zeros(G, dtype=np.float32)
    spread_min[g] = min(pre_counts)
    cdom = np.zeros((G, n_domains), dtype=np.float32)
    cdom[g] = pre_counts
    dexist = np.zeros((G, n_domains), dtype=bool)
    dexist[g] = True
    return batch, assigned, eb, g, spread_pre, spread_dom, spread_min, \
        cdom, dexist


def _sequential(chosen, counts, skew=1):
    ok = []
    counts = list(counts)
    for d in chosen:
        if counts[d] + 1 - min(counts) <= skew:
            counts[d] += 1
            ok.append(True)
        else:
            ok.append(False)
    return {i for i, v in enumerate(ok) if not v}


ARB_CASES = {
    # (n, domains, chosen, pre-counts, dead, scan-enforced)
    "alternating-balanced": (32, 2, [i % 2 for i in range(32)], [0, 0],
                             set(), False),
    "one-domain-pile": (8, 2, [0] * 8, [0, 0], set(), False),
    "prebatch-imbalance": (8, 2, [1, 1, 1, 1, 0, 0, 0, 0], [3, 0], set(),
                           False),
    "dead-contribute-nothing": (4, 2, [0] * 4, [0, 0], {0, 1}, False),
    "scan-enforced-skips-replay": (6, 3, [0] * 6, [0, 0, 0], set(), True),
    "unenforced-replays": (6, 3, [0] * 6, [0, 0, 0], set(), False),
    "dead-revocation-invalidates-scan": (2, 2, [1, 0], [1, 0], {0}, True),
}


@pytest.mark.parametrize("case", sorted(ARB_CASES))
def test_arbitration_scenarios(case):
    n, doms, chosen, pre, dead, enforced = ARB_CASES[case]
    batch, assigned, eb, g, sp_pre, sp_dom, sp_min, cdom, dexist = _setup(
        n, doms, chosen, [float(c) for c in pre])
    scan = np.zeros(eb.gf.valid.shape[0], dtype=bool)
    scan[g] = enforced
    fetched = []

    def tables():
        fetched.append(1)
        return cdom, dexist

    revoked = arbitrate_spread(batch, assigned, eb.pf, eb.gf, sp_pre, sp_dom,
                               sp_min, dead=set(dead), exact_tables=tables,
                               scan_enforced=scan)
    if enforced and not dead:
        assert revoked == set() and not fetched
    else:
        live = [i for i in range(n) if i not in dead]
        want = _sequential([chosen[i] for i in live], pre)
        assert revoked == {live[j] for j in want}
    if case == "alternating-balanced":
        # the conservative fallback (no tables) over-revokes the batch
        fallback = arbitrate_spread(batch, assigned, eb.pf, eb.gf, sp_pre,
                                    sp_dom, sp_min, dead=set())
        assert len(fallback) == n - doms


def test_group_state_histogram_min_tracking():
    st = _SpreadGroupState(np.array([2.0, 0.0, 0.0, 5.0]),
                           np.array([True, True, True, False]))
    assert st.min == 0
    st.admit(1)
    assert st.min == 0
    st.admit(2)
    assert st.min == 1
    st.admit(1)
    st.admit(2)
    assert st.min == 2 and int(st.counts[3]) == 5


@pytest.mark.parametrize("iters", [0, 8])
def test_engine_repair_matches_jax(iters):
    """tests/test_spread_arbitration.py's e2e burst (48 max_skew=1 pods
    over 4 balanced zones of 16 nodes, batches of 64 over a window) with
    the caps scan off the path: hostname-free zones compact, so the scan
    enforces; both engines bind all, with the same placements, under
    spread_repair_iters 0 and 8, and the zones end within skew 1."""
    def recipe(O):
        nodes = [O.Node(metadata=O.ObjectMeta(name=f"rn{i:02d}",
                                              labels={ZONE: f"z{i % 4}"}),
                        status=O.NodeStatus(allocatable={"cpu": 64000.0,
                                                         "pods": 110.0}))
                 for i in range(16)]
        pods = [O.Pod(metadata=O.ObjectMeta(name=f"sk{i:02d}",
                                            namespace="default",
                                            labels={"app": "s"}),
                      spec=O.PodSpec(requests={"cpu": 100},
                                     topology_spread_constraints=[
                                         O.TopologySpreadConstraint(
                                             max_skew=1, topology_key=ZONE,
                                             when_unsatisfiable=
                                             "DoNotSchedule",
                                             label_selector=O.LabelSelector(
                                                 match_labels={"app": "s"}))]))
                for i in range(48)]
        return nodes, pods

    prof = ["NodeUnschedulable", "NodeResourcesFit", "PodTopologySpread"]
    kw = dict(max_batch_size=64, spread_repair_iters=iters)
    want, jm = _run_cluster(JCluster, JO, JProfile(plugins=prof),
                            JConfig(**kw), 0, 0, 0, recipe=recipe)
    got, m = _run_cluster(Cluster, TO, Profile(plugins=prof),
                          SchedulerConfig(platform="cpu", **kw), 0, 0, 0,
                          recipe=recipe)
    assert got == want
    for k in SHARED_METRICS:
        assert m[k] == jm[k], k
    counts = {}
    for node in got.values():
        z = int(node[2:]) % 4
        counts[z] = counts.get(z, 0) + 1
    assert max(counts.values()) - min(counts.values()) <= 1


def _host_spread_recipe(O, n_nodes=160, n_pods=256):
    """Hard spread over kubernetes.io/hostname on 160 nodes (more domains
    than the caps compact, so the host arbitration and the in-cycle
    repair judge it), plus pods with a required anti-affinity term over
    zone against each other (direct and symmetric) and soft pods."""
    rng = np.random.default_rng(5)
    nodes = [O.Node(metadata=O.ObjectMeta(
        name=f"hn{i:03d}", labels={ZONE: f"z{i % 6}"}),
        status=O.NodeStatus(allocatable={
            "cpu": float(rng.choice([4000, 8000])), "pods": 110.0}))
        for i in range(n_nodes)]
    pods = []
    for i in range(n_pods):
        kind = i % 4
        spec = dict(requests={"cpu": float(rng.integers(1, 6) * 100)},
                    priority=int(rng.integers(0, 3)))
        labels = {"app": "h"}
        if kind in (0, 1):
            spec["topology_spread_constraints"] = [O.TopologySpreadConstraint(
                max_skew=1, topology_key="kubernetes.io/hostname",
                when_unsatisfiable="DoNotSchedule",
                label_selector=O.LabelSelector(match_labels={"app": "h"}))]
        elif kind == 2:
            labels = {"app": f"solo{i % 3}"}
            spec["affinity"] = O.Affinity(pod_anti_affinity=O.PodAntiAffinity(
                required=[O.PodAffinityTerm(
                    label_selector=O.LabelSelector(
                        match_labels={"app": f"solo{i % 3}"}),
                    topology_key=ZONE)]))
        pods.append(O.Pod(metadata=O.ObjectMeta(name=f"hp{i:03d}",
                                                namespace="default",
                                                labels=labels),
                          spec=O.PodSpec(**spec)))
    return nodes, pods


@pytest.mark.parametrize("iters", [0, 8])
@pytest.mark.parametrize("pipeline,resident,shortlist",
                         [MODES[0], MODES[1]])
def test_host_arbitration_and_repair_match_jax(pipeline, resident,
                                               shortlist, iters):
    """The host arbitration revokes in-batch breaches of hostname skew
    and of required anti-affinity (direct and symmetric), the in-cycle
    repair re-places them, and what still conflicts is requeued: the
    four batches of the burst give the placements and counters of the
    JAX engine. The backoff outlasts the test, so no requeued pod forms
    a later batch whose timing would differ. With spread_repair_iters 0
    the revoked pods are requeued instead of repaired."""
    from minisched_tpu_torch.scenario.runner import wait_until

    prof = ["NodeUnschedulable", "NodeResourcesFit", "PodTopologySpread",
            "InterPodAffinity"]
    kw = dict(max_batch_size=64, pipeline=pipeline, device_resident=resident,
              shortlist=shortlist, backoff_initial_s=60.0,
              backoff_max_s=60.0, spread_repair_iters=iters)
    out = []
    for c, O, P, cfg in ((JCluster(), JO, JProfile, JConfig(**kw)),
                         (Cluster(), TO, Profile,
                          SchedulerConfig(platform="cpu", **kw))):
        nodes, pods = _host_spread_recipe(O)
        c.create_objects(nodes)
        c.create_objects(pods)
        c.start(P(plugins=prof), cfg)
        try:
            sched = c.service.scheduler

            def settled():
                m = sched.metrics()
                return (m["batches"] >= 4 and m["pods_bound"]
                        == m["pods_assigned"])

            assert wait_until(settled, timeout=60)
            out.append(({p.key: p.spec.node_name for p in c.list_pods()
                         if p.spec.node_name}, sched.metrics()))
        finally:
            c.shutdown()
    (want, jm), (got, m) = out
    assert got == want
    for k in SHARED_METRICS:
        assert m[k] == jm[k], k
    assert m["batches"] == 4
    assert m["spread_revoked"] > 0
    assert (m["spread_repaired"] > 0) == (iters > 0)
    assert 0 < m["pods_failed"] < 256


def test_caps_follow_the_profile_not_the_arbitration():
    """A profile whose only topology plugin is SelectorSpread has no
    spread arbitration, yet its step still builds the in-scan caps and
    enforces a batch's DoNotSchedule slots there, as the JAX step does:
    placements equal the JAX engine's."""
    prof = ["NodeUnschedulable", "NodeResourcesFit", "SelectorSpread"]
    kw = dict(max_batch_size=64)

    def recipe(O):
        nodes, pods = _c4(O, 120, 300, True)
        for i, p in enumerate(pods):
            p.metadata.owner_references = [O.OwnerReference(
                kind="ReplicaSet", name=f"rs{i % 3}", controller=True)]
        return nodes, pods

    want, jm = _run_cluster(JCluster, JO, JProfile(plugins=prof),
                            JConfig(**kw), 0, 0, 0, recipe=recipe)
    got, m = _run_cluster(Cluster, TO, Profile(plugins=prof),
                          SchedulerConfig(platform="cpu", **kw), 0, 0, 0,
                          recipe=recipe)
    assert got == want
    for k in SHARED_METRICS:
        assert m[k] == jm[k], k

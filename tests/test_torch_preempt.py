"""DefaultPreemption on the port against the JAX package: the batched
candidate op (ops/preempt.py) bitwise on random corpora and on cases aimed
at each topology cure, the required-affinity block and ties; the engine's
victim selection with PodDisruptionBudgets; and the engine scenarios of
tests/test_preemption.py on both engines, with their own assertions."""
import time

import jax
import numpy as np
import pytest
import torch

from minisched_tpu.config import SchedulerConfig as JConfig
from minisched_tpu.encode import NodeFeatureCache as JCache
from minisched_tpu.encode import encode_pods as jencode
from minisched_tpu.engine.scheduler import Scheduler as JScheduler
from minisched_tpu.ops.preempt import build_preempt_op as jbuild_op
from minisched_tpu.plugins import PluginSet as JPluginSet
from minisched_tpu.scenario.runner import Cluster as JCluster
from minisched_tpu.scenario.runner import wait_until as jwait
from minisched_tpu.service.defaultconfig import Profile as JProfile
from minisched_tpu.service.defaultconfig import full_scheduler_profile as jfull
from minisched_tpu.service.defaultconfig import make_plugin as jmake
from minisched_tpu.state import objects as JO
from minisched_tpu.state.store import ClusterStore as JStore
from minisched_tpu_torch.config import SchedulerConfig
from minisched_tpu_torch.encode import NodeFeatureCache, encode_pods, to_torch
from minisched_tpu_torch.engine.scheduler import Scheduler
from minisched_tpu_torch.ops.preempt import build_preempt_op
from minisched_tpu_torch.plugins import PluginSet
from minisched_tpu_torch.scenario.runner import Cluster, wait_until
from minisched_tpu_torch.service.defaultconfig import (Profile,
                                                       full_scheduler_profile,
                                                       make_plugin)
from minisched_tpu_torch.state import objects as TO
from minisched_tpu_torch.state.store import ClusterStore
from torch_parity import HOST, ZONE, bits_equal, full_cluster

# Per package: (objects, cache, encode, op builder, PluginSet, make_plugin,
# Cluster, Profile, config factory, wait_until, Scheduler, store).
JAX = (JO, JCache, jencode, jbuild_op, JPluginSet, jmake, JCluster,
       JProfile, lambda **kw: JConfig(**kw), jwait, JScheduler, JStore)
PORT = (TO, NodeFeatureCache, encode_pods, build_preempt_op, PluginSet,
        make_plugin, Cluster, Profile,
        lambda **kw: SchedulerConfig(platform="cpu", **kw), wait_until,
        Scheduler, ClusterStore)
PACKAGES = pytest.mark.parametrize("pkg", [JAX, PORT], ids=["jax", "port"])

TOPO = ["NodeUnschedulable", "NodeResourcesFit", "InterPodAffinity",
        "PodTopologySpread"]


# ---- the candidate op ---------------------------------------------------

def _op_outputs(pkg, recipe, plugins, p_pad=8):
    """Encode one cluster in ``pkg`` and run its preemption op → the four
    outputs as numpy arrays, with the node row names."""
    O, cache_cls, enc, build, pset, make = pkg[:6]
    nodes, bound, pending = recipe(O)
    cache = cache_cls()
    cache.upsert_nodes_bulk(nodes)
    for p, node_name in bound:
        p.spec.node_name = node_name
        assert cache.account_bind(p)
    eb = enc(pending, p_pad, cfg=cache.cfg, registry=cache.registry,
             gang_bound_fn=cache.gang_bound_count,
             anti_forbidden_fn=cache.anti_forbidden_for)
    nf, names, _sv, _incs = cache.snapshot_versioned()
    af = cache.snapshot_assigned()
    ps = (plugins(pkg) if callable(plugins)
          else pset([make(n) for n in plugins]))
    op = build(ps, cfg=cache.cfg)
    if pkg is PORT:
        out = op(*(to_torch(x, "cpu") for x in (eb, nf, af)))
        return [t.numpy() for t in out], names
    return [np.asarray(t) for t in op(eb, nf, af)], names


def op_both(recipe, plugins, p_pad=8):
    """Both packages' op outputs on one cluster, held bitwise equal →
    the port's (chosen, ok, victim_count, spread_evict), names."""
    want, names = _op_outputs(JAX, recipe, plugins, p_pad)
    got, names_t = _op_outputs(PORT, recipe, plugins, p_pad)
    assert names == names_t
    for w, g, field in zip(want, got, ("chosen", "ok", "victim_count",
                                       "spread_evict")):
        assert w.dtype == g.dtype, field
        assert bits_equal(w, g), field
    return got, names


def _preempt_cluster(seed):
    """full_cluster's topology-heavy corpus (taints, selectors, node
    affinity, spread, required (anti-)affinity, symmetric owners), with
    pending pods that outrank most bound pods and ask for more CPU than
    most nodes have free."""
    def recipe(O):
        nodes, pending, bound = full_cluster(O, 40, 24, seed)
        rng = np.random.default_rng(seed + 100)
        for n in nodes:
            n.status.allocatable["cpu"] = 1200.0
        extra = []
        for i in range(200):
            p = O.Pod(metadata=O.ObjectMeta(
                name=f"fill{i}", namespace=str(rng.choice(["default",
                                                           "prod"])),
                labels={"app": str(rng.choice(["web", "cache", "db"]))}),
                spec=O.PodSpec(requests={"cpu": float(rng.integers(1, 4)
                                                      * 100)},
                               priority=int(rng.integers(0, 4))))
            extra.append((p, f"fn{int(rng.integers(0, 40))}"))
        for p in pending:
            p.spec.priority = int(rng.integers(1, 6))
            p.spec.requests["cpu"] = float(rng.integers(4, 16) * 100)
        return nodes, bound + extra, pending
    return recipe


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_op_matches_jax_on_random_corpora(seed):
    """The full default profile's filters (every topology cure on) over a
    random corpus: chosen, ok, victim_count and spread_evict bitwise."""
    (chosen, ok, cnt, _sev), _names = op_both(
        _preempt_cluster(seed),
        lambda pkg: (jfull if pkg is JAX else full_scheduler_profile)()
        .build(), p_pad=32)
    assert ok.any() and not ok[:24].all()
    assert (cnt[ok] > 0).any()
    assert (chosen[~ok] == -1).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_op_matches_jax_topology_filters(seed):
    """bench.py's candidate-search profile on the same corpora."""
    (_c, ok, _n, _s), _names = op_both(_preempt_cluster(seed), TOPO,
                                       p_pad=32)
    assert ok.any()


def _node(O, name, cpu=4000.0, labels=None):
    return O.Node(metadata=O.ObjectMeta(name=name, labels=labels or {}),
                  status=O.NodeStatus(allocatable={
                      "cpu": cpu, "memory": float(16 << 30),
                      "pods": 110.0}))


def _pod(O, name, cpu=100.0, prio=0, labels=None, **spec):
    return O.Pod(metadata=O.ObjectMeta(name=name, namespace="default",
                                       labels=labels or {}),
                 spec=O.PodSpec(requests={"cpu": cpu}, priority=prio,
                                **spec))


def _anti(O, app, key=HOST):
    return O.Affinity(pod_anti_affinity=O.PodAntiAffinity(required=[
        O.PodAffinityTerm(label_selector=O.LabelSelector(
            match_labels={"app": app}), topology_key=key)]))


def test_op_own_anti_affinity_cure():
    """Node a holds the only repeller (evictable); node b's repeller
    outranks the preemptor; zone z2's repeller sits on another node."""
    def recipe(O):
        nodes = [_node(O, "a", labels={ZONE: "z1"}),
                 _node(O, "b", labels={ZONE: "z1"}),
                 _node(O, "c", labels={ZONE: "z2"}),
                 _node(O, "d", labels={ZONE: "z2"})]
        bound = [(_pod(O, "ra", prio=1, labels={"app": "db"}), "a"),
                 (_pod(O, "rb", prio=50, labels={"app": "db"}), "b"),
                 (_pod(O, "rc", prio=1, labels={"app": "db"}), "c")]
        pending = [_pod(O, "vip", prio=10, affinity=_anti(O, "db")),
                   _pod(O, "zvip", prio=10, affinity=_anti(O, "db", ZONE))]
        return nodes, bound, pending
    (chosen, ok, cnt, _s), names = op_both(recipe, TOPO)
    # hostname term: node d has no repeller at all (no eviction), a is
    # curable; zone term: z1 has a matcher on b (unevictable) and z2's
    # only matcher sits on c, evictable there.
    assert ok[:2].all()
    assert names[chosen[0]] == "d" and cnt[0] == 0
    assert names[chosen[1]] == "c" and cnt[1] == 1


def test_op_symmetric_anti_cure_at_owner_row():
    """A running pod's required anti term repels the preemptor: curable
    only on the owner's node, and only against a lower-priority owner."""
    def recipe(O):
        nodes = [_node(O, "a", cpu=200.0), _node(O, "b", cpu=200.0)]
        bound = [(_pod(O, "hermit", cpu=100.0, prio=1,
                       affinity=_anti(O, "web")), "a"),
                 (_pod(O, "boss", cpu=100.0, prio=90,
                       affinity=_anti(O, "web")), "b"),
                 (_pod(O, "fill", cpu=100.0, prio=95), "a")]
        pending = [_pod(O, "vip", cpu=100.0, prio=10, labels={"app": "web"}),
                   _pod(O, "top", cpu=100.0, prio=99,
                        labels={"app": "web"})]
        return nodes, bound, pending
    (chosen, ok, cnt, _s), names = op_both(recipe, TOPO)
    assert ok[0] and names[chosen[0]] == "a" and cnt[0] == 1
    # the top pod outranks both owners: either node is curable, a has
    # two lower-priority pods, b one
    assert ok[1] and names[chosen[1]] == "b"


def test_op_spread_cure_needs_several_evictions():
    """DoNotSchedule max_skew 1 over zone: za holds 3 matching pods, zb
    (cordoned) none, so placing in za is over by 3: the cure evicts
    three matching pods there."""
    def recipe(O):
        nodes = [_node(O, "a", cpu=64000.0, labels={ZONE: "za"}),
                 O.Node(metadata=O.ObjectMeta(name="b",
                                              labels={ZONE: "zb"}),
                        spec=O.NodeSpec(unschedulable=True),
                        status=O.NodeStatus(allocatable={"cpu": 64000.0,
                                                         "pods": 110.0}))]
        bound = [(_pod(O, f"m{i}", prio=1, labels={"app": "s"}), "a")
                 for i in range(3)]
        bound.append((_pod(O, "other", prio=1, labels={"app": "x"}), "a"))
        cons = [O.TopologySpreadConstraint(
            max_skew=1, topology_key=ZONE, when_unsatisfiable="DoNotSchedule",
            label_selector=O.LabelSelector(match_labels={"app": "s"}))]
        pending = [_pod(O, "vip", prio=100, labels={"app": "s"},
                        topology_spread_constraints=cons),
                   _pod(O, "low", prio=0, labels={"app": "s"},
                        topology_spread_constraints=cons)]
        return nodes, bound, pending
    (chosen, ok, cnt, sev), names = op_both(recipe, TOPO)
    assert ok[0] and names[chosen[0]] == "a" and cnt[0] == 4
    assert sev[0, 0] == 3.0
    assert not ok[1] and (sev[1] == 0).all()


def test_op_required_affinity_stays_incurable():
    """A required pod affinity with no matching pod anywhere: eviction
    cannot create the match, so no candidate even with victims."""
    def recipe(O):
        nodes = [_node(O, "a", cpu=100.0, labels={ZONE: "z"})]
        bound = [(_pod(O, "low", prio=1, labels={"app": "x"}), "a")]
        aff = O.Affinity(pod_affinity=O.PodAffinity(required=[
            O.PodAffinityTerm(label_selector=O.LabelSelector(
                match_labels={"app": "db"}), topology_key=ZONE)]))
        pending = [_pod(O, "vip", prio=10, affinity=aff),
                   _pod(O, "plain", prio=10)]
        return nodes, bound, pending
    (_c, ok, cnt, _s), _names = op_both(recipe, TOPO)
    assert not ok[0]
    assert ok[1] and cnt[1] == 1


def test_op_every_row_ties_takes_the_first_node():
    """Every node full of one lower-priority pod: each preemptor's
    candidates tie on one victim, and the first node row wins, as
    jnp.argmax's first maximum."""
    def recipe(O):
        nodes = [_node(O, f"n{i}", cpu=200.0) for i in range(6)]
        bound = [(_pod(O, f"f{i}", cpu=200.0, prio=0), f"n{i}")
                 for i in range(6)]
        pending = [_pod(O, f"hi{i}", cpu=200.0, prio=100) for i in range(5)]
        return nodes, bound, pending
    (chosen, ok, cnt, _s), names = op_both(recipe, TOPO)
    assert ok[:5].all() and (cnt[:5] == 1).all()
    assert {names[c] for c in chosen[:5]} == {"n0"}


# ---- engine: victim selection with PodDisruptionBudgets ----------------

def _pdb(O, name, min_available, labels):
    return O.PodDisruptionBudget(
        metadata=O.ObjectMeta(name=name, namespace="default"),
        spec=O.PDBSpec(min_available=min_available,
                       selector=O.LabelSelector(match_labels=labels)))


def _engine(pkg):
    O = pkg[0]
    store = pkg[11]()
    ps = pkg[4]([pkg[5]("NodeUnschedulable"),
                 pkg[5]("NodeResourcesFit", score_strategy=None),
                 pkg[5]("DefaultPreemption")])
    eng = pkg[10](store, ps, pkg[8]())
    return O, store, eng


def _bound(O, store, eng, name, node_name, labels, prio):
    p = _pod(O, name, labels=labels, prio=prio)
    p.spec.node_name = node_name
    store.create(p)
    eng.cache.account_bind(store.get("Pod", p.key), node_name=node_name)


@PACKAGES
def test_pdb_budget_shared_across_preemptors_in_one_cycle(pkg):
    O, store, eng = _engine(pkg)
    try:
        for n in ("sh-a", "sh-b"):
            store.create(_node(O, n, cpu=200.0))
            eng.cache.upsert_node(store.get("Node", n))
        _bound(O, store, eng, "m1", "sh-a", {"app": "web"}, 1)
        _bound(O, store, eng, "x1", "sh-a", {}, 2)
        _bound(O, store, eng, "m2", "sh-b", {"app": "web"}, 1)
        _bound(O, store, eng, "x2", "sh-b", {}, 2)
        store.create(_pdb(O, "web-pdb", 1, {"app": "web"}))
        pre0 = _pod(O, "vip0", prio=100)
        pdb_state = eng._pdb_state()
        assert eng._select_victims(pre0, "sh-a", set(), pdb_state) == [
            "default/m1"]
        assert eng._select_victims(pre0, "sh-b", {"default/m1"},
                                   pdb_state) == ["default/x2"]
        assert eng._select_victims(pre0, "sh-b",
                                   {"default/m1", "default/x2"},
                                   pdb_state) == ["default/m2"]
    finally:
        eng.shutdown()


@PACKAGES
def test_pdb_last_resort_minimizes_violations(pkg):
    O, store, eng = _engine(pkg)
    try:
        store.create(_node(O, "lr-a", cpu=300.0))
        eng.cache.upsert_node(store.get("Node", "lr-a"))
        _bound(O, store, eng, "p1", "lr-a", {"app": "web"}, 1)
        _bound(O, store, eng, "p2", "lr-a", {"app": "web"}, 2)
        _bound(O, store, eng, "u", "lr-a", {}, 3)
        store.create(_pdb(O, "web-pdb", 2, {"app": "web"}))
        v = eng._select_victims(_pod(O, "vip", cpu=200.0, prio=100), "lr-a",
                                set(), eng._pdb_state())
        assert v is not None and len(v) == 2
        assert "default/u" in v
        assert sorted(v) != ["default/p1", "default/p2"]
    finally:
        eng.shutdown()


# ---- engine scenarios (tests/test_preemption.py) on both engines -------

def _cluster(pkg, plugins=("NodeUnschedulable", "NodeResourcesFit",
                           "NodeResourcesLeastAllocated",
                           "DefaultPreemption"), **kw):
    kw.setdefault("max_batch_size", 64)
    kw.setdefault("batch_window_s", 0.0)
    c = pkg[6]()
    c.start(profile=pkg[7](plugins=list(plugins)),
            config=pkg[8](backoff_initial_s=0.05, backoff_max_s=0.2, **kw),
            with_pv_controller=False)
    return c


def _names(c, prefix=""):
    return sorted(p.metadata.name for p in c.list_pods()
                  if p.metadata.name.startswith(prefix))


def _placements(c):
    return {p.metadata.name: p.spec.node_name for p in c.list_pods()}


def _both(scenario):
    """Run ``scenario(pkg)`` on both engines; their final placements must
    be equal (every scenario here has one preemption round on one
    deterministic candidate)."""
    want = scenario(JAX)
    got = scenario(PORT)
    assert got == want


def _preempts_lowest(pkg):
    c = _cluster(pkg)
    try:
        c.create_node("pe-n0", cpu=300)
        for i in range(3):
            c.create_pod(f"low{i}", cpu=100, priority=1)
        for i in range(3):
            c.wait_for_pod_bound(f"low{i}", timeout=20)
        c.create_pod("vip", cpu=100, priority=100)
        bound = c.wait_for_pod_bound("vip", timeout=30)
        assert bound.spec.node_name == "pe-n0"
        assert bound.status.nominated_node_name == "pe-n0"
        assert len(_names(c, "low")) == 2
        assert pkg[9](lambda: any(
            e.reason == "Preempted" and "vip" in e.message
            for e in c.store.list("Event")), timeout=10)
        return _placements(c)
    finally:
        c.shutdown()


def test_engine_preempts_lowest_priority_victims_end_to_end():
    _both(_preempts_lowest)


def _no_lower_victims(pkg):
    c = _cluster(pkg)
    try:
        c.create_node("pn-n0", cpu=300)
        for i in range(3):
            c.create_pod(f"peer{i}", cpu=100, priority=50)
        for i in range(3):
            c.wait_for_pod_bound(f"peer{i}", timeout=20)
        c.create_pod("equal", cpu=100, priority=50)
        p = c.wait_for_pod_pending("equal", timeout=20)
        assert "preemption found no candidates" in p.status.message
        time.sleep(0.3)
        assert len(_names(c, "peer")) == 3
        return _placements(c)
    finally:
        c.shutdown()


def test_engine_no_preemption_without_lower_priority_victims():
    _both(_no_lower_victims)


@PACKAGES
def test_engine_preemption_disabled_without_plugin(pkg):
    c = _cluster(pkg, plugins=("NodeUnschedulable", "NodeResourcesFit"))
    try:
        c.create_node("pd-n0", cpu=300)
        for i in range(3):
            c.create_pod(f"prey{i}", cpu=100, priority=1)
        for i in range(3):
            c.wait_for_pod_bound(f"prey{i}", timeout=20)
        c.create_pod("wolf", cpu=100, priority=100)
        c.wait_for_pod_pending("wolf", timeout=20)
        time.sleep(0.3)
        assert len(_names(c, "prey")) == 3
    finally:
        c.shutdown()


@PACKAGES
def test_nominated_capacity_protected_from_racing_lower_priority_pod(pkg):
    c = _cluster(pkg)
    try:
        c.create_node("nr-n0", cpu=300)
        for i in range(3):
            c.create_pod(f"base{i}", cpu=100, priority=10)
        for i in range(3):
            c.wait_for_pod_bound(f"base{i}", timeout=20)
        c.create_pod("vip2", cpu=100, priority=100)
        pkg[9](lambda: len(_names(c, "base")) == 2, timeout=20)
        c.create_pod("thief", cpu=100, priority=1)
        bound = c.wait_for_pod_bound("vip2", timeout=30)
        assert bound.spec.node_name == "nr-n0"
        assert c.get_pod("thief").spec.node_name == ""
    finally:
        c.shutdown()


def _gang_never_victims(pkg):
    c = _cluster(pkg)
    try:
        c.create_node("gv-n0", cpu=300)
        for i in range(3):
            c.create_pod(f"gmember{i}", cpu=100, priority=1,
                         pod_group="sacred", pod_group_min=3)
        for i in range(3):
            c.wait_for_pod_bound(f"gmember{i}", timeout=20)
        c.create_pod("bully", cpu=100, priority=100)
        p = c.wait_for_pod_pending("bully", timeout=20)
        assert "preemption found no candidates" in p.status.message
        time.sleep(0.3)
        assert len(_names(c, "gmember")) == 3
        return _placements(c)
    finally:
        c.shutdown()


def test_gang_members_are_never_victims():
    _both(_gang_never_victims)


@PACKAGES
def test_preemption_composes_with_node_sampling(pkg):
    """64 nodes exactly full of low-priority pods under a 10% sample: the
    residual pass renders the terminal verdict and preemption fires off
    it (placements depend on batch timing: not compared)."""
    O = pkg[0]
    c = _cluster(pkg, max_batch_size=128, batch_window_s=0.05,
                 percentage_of_nodes_to_score=10, min_sample_nodes=16)
    try:
        c.create_objects([O.Node(
            metadata=O.ObjectMeta(name=f"sp-n{i:03d}"),
            status=O.NodeStatus(allocatable={"cpu": 200, "pods": 110}))
            for i in range(64)])
        c.create_objects([O.Pod(
            metadata=O.ObjectMeta(name=f"sp-f{i}", namespace="default"),
            spec=O.PodSpec(requests={"cpu": 100}, priority=1))
            for i in range(128)])
        assert pkg[9](lambda: all(p.spec.node_name for p in c.list_pods()),
                      timeout=60)
        c.create_pod("sp-vip", cpu=200, priority=100)
        bound = c.wait_for_pod_bound("sp-vip", timeout=30)
        assert bound.status.nominated_node_name == bound.spec.node_name
        assert pkg[9](lambda: len([e for e in c.store.list("Event")
                                   if e.reason == "Preempted"]) == 2,
                      timeout=10)
    finally:
        c.shutdown()


def _label(c, name, labels):
    p = c.store.get("Pod", f"default/{name}")
    p.metadata.labels = labels
    c.store.update(p)


def _pdb_skips_protected(pkg):
    c = _cluster(pkg)
    try:
        c.create_node("pdb-n0", cpu=300)
        c.create_pod("guarded", cpu=100, priority=1)
        _label(c, "guarded", {"app": "db"})
        c.create_pod("loose", cpu=100, priority=2)
        c.create_pod("other", cpu=100, priority=50)
        for n in ("guarded", "loose", "other"):
            c.wait_for_pod_bound(n, timeout=20)
        c.store.create(_pdb(pkg[0], "db-pdb", 1, {"app": "db"}))
        c.create_pod("vip", cpu=100, priority=100)
        c.wait_for_pod_bound("vip", timeout=30)
        names = set(_names(c))
        assert "guarded" in names and "loose" not in names
        return _placements(c)
    finally:
        c.shutdown()


def test_pdb_protected_victims_skipped_when_alternatives_exist():
    _both(_pdb_skips_protected)


def _pdb_last_resort(pkg):
    c = _cluster(pkg)
    try:
        c.create_node("pdb2-n0", cpu=200)
        for i in range(2):
            c.create_pod(f"db{i}", cpu=100, priority=1)
            _label(c, f"db{i}", {"app": "db"})
        for i in range(2):
            c.wait_for_pod_bound(f"db{i}", timeout=20)
        c.store.create(_pdb(pkg[0], "db-pdb", 2, {"app": "db"}))
        c.create_pod("vip", cpu=100, priority=100)
        c.wait_for_pod_bound("vip", timeout=30)
        assert len(_names(c, "db")) == 1
        return _placements(c)
    finally:
        c.shutdown()


def test_pdb_violated_only_as_last_resort():
    _both(_pdb_last_resort)


# -- topology cures

def _topo(pkg, extra=()):
    return _cluster(pkg, plugins=("NodeUnschedulable", "NodeResourcesFit",
                                  "InterPodAffinity", "PodTopologySpread",
                                  "DefaultPreemption", *extra))


def _own_anti_cure(pkg):
    c = _topo(pkg)
    try:
        c.create_node("ca-n0", cpu=64000)
        c.create_pod("victim", cpu=100, priority=1, labels={"app": "db"})
        c.wait_for_pod_bound("victim", timeout=20)
        c.create_pod("vip", cpu=100, priority=100,
                     affinity=_anti(pkg[0], "db"))
        assert c.wait_for_pod_bound("vip", timeout=30).spec.node_name == (
            "ca-n0")
        assert "victim" not in _names(c)
        return _placements(c)
    finally:
        c.shutdown()


def test_engine_preemption_cures_own_anti_affinity():
    _both(_own_anti_cure)


def _anti_outrank(pkg):
    c = _topo(pkg)
    try:
        c.create_node("cb-n0", cpu=64000)
        c.create_pod("guard", cpu=100, priority=100, labels={"app": "db"})
        c.wait_for_pod_bound("guard", timeout=20)
        c.create_pod("mid", cpu=100, priority=10,
                     affinity=_anti(pkg[0], "db"))
        p = c.wait_for_pod_pending("mid", timeout=10)
        assert "InterPodAffinity" in p.status.unschedulable_plugins
        assert "guard" in _names(c)
        return _placements(c)
    finally:
        c.shutdown()


def test_engine_anti_cure_requires_outranking_every_repeller():
    _both(_anti_outrank)


def _anti_offnode(pkg):
    c = _topo(pkg)
    try:
        c.create_node("cz-n0", cpu=64000, labels={ZONE: "z1"})
        c.create_node("cz-n1", cpu=64000, labels={ZONE: "z1"})
        c.create_pod("m0", cpu=100, priority=1, labels={"app": "db"},
                     node_selector={HOST: "cz-n0"})
        c.create_pod("m1", cpu=100, priority=1, labels={"app": "db"},
                     node_selector={HOST: "cz-n1"})
        c.wait_for_pod_bound("m0", timeout=20)
        c.wait_for_pod_bound("m1", timeout=20)
        c.create_pod("vip", cpu=100, priority=100,
                     affinity=_anti(pkg[0], "db", ZONE))
        p = c.wait_for_pod_pending("vip", timeout=10)
        assert "InterPodAffinity" in p.status.unschedulable_plugins
        assert len(_names(c, "m")) == 2
        return _placements(c)
    finally:
        c.shutdown()


def test_engine_anti_cure_blocked_by_offnode_domain_matcher():
    _both(_anti_offnode)


def _symmetric_cure(pkg):
    c = _topo(pkg)
    try:
        c.create_node("cs-n0", cpu=64000)
        c.create_pod("hermit", cpu=100, priority=1,
                     affinity=_anti(pkg[0], "web"))
        c.wait_for_pod_bound("hermit", timeout=20)
        c.create_pod("vip", cpu=100, priority=100, labels={"app": "web"})
        assert c.wait_for_pod_bound("vip", timeout=30).spec.node_name == (
            "cs-n0")
        assert "hermit" not in _names(c)
        return _placements(c)
    finally:
        c.shutdown()


def test_engine_preemption_cures_symmetric_anti_affinity():
    _both(_symmetric_cure)


def _symmetric_higher(pkg):
    c = _topo(pkg)
    try:
        c.create_node("ch-n0", cpu=64000)
        c.create_pod("hermit", cpu=100, priority=100,
                     affinity=_anti(pkg[0], "web"))
        c.wait_for_pod_bound("hermit", timeout=20)
        c.create_pod("mid", cpu=100, priority=10, labels={"app": "web"})
        p = c.wait_for_pod_pending("mid", timeout=10)
        assert "InterPodAffinity" in p.status.unschedulable_plugins
        assert "hermit" in _names(c)
        return _placements(c)
    finally:
        c.shutdown()


def test_engine_symmetric_anti_not_cured_against_higher_owner():
    _both(_symmetric_higher)


def _spread_cons(O):
    return [O.TopologySpreadConstraint(
        max_skew=1, topology_key=ZONE, when_unsatisfiable="DoNotSchedule",
        label_selector=O.LabelSelector(match_labels={"app": "s"}))]


def _spread_cure(pkg):
    c = _topo(pkg)
    try:
        c.create_node("sp-n0", cpu=64000, labels={ZONE: "za"})
        c.create_node("sp-n1", cpu=64000, labels={ZONE: "zb"},
                      unschedulable=True)
        for i in range(2):
            c.create_pod(f"m{i}", cpu=100, priority=1, labels={"app": "s"})
            c.wait_for_pod_bound(f"m{i}", timeout=20)
        c.create_pod("vip", cpu=100, priority=100, labels={"app": "s"},
                     topology_spread_constraints=_spread_cons(pkg[0]))
        assert c.wait_for_pod_bound("vip", timeout=30).spec.node_name == (
            "sp-n0")
        assert _names(c, "m") == []
        return _placements(c)
    finally:
        c.shutdown()


def test_engine_preemption_cures_spread_skew():
    _both(_spread_cure)


@PACKAGES
def test_engine_spread_block_parks_terminally_without_preemption(pkg):
    c = _cluster(pkg, plugins=("NodeUnschedulable", "NodeResourcesFit",
                               "PodTopologySpread"))
    try:
        c.create_node("st-n0", cpu=64000, labels={ZONE: "za"})
        c.create_node("st-n1", cpu=64000, labels={ZONE: "zb"},
                      unschedulable=True)
        for i in range(2):
            c.create_pod(f"m{i}", cpu=100, priority=1, labels={"app": "s"})
            c.wait_for_pod_bound(f"m{i}", timeout=20)
        c.create_pod("late", cpu=100, labels={"app": "s"},
                     topology_spread_constraints=_spread_cons(pkg[0]))
        p = c.wait_for_pod_pending("late", timeout=10)
        assert "PodTopologySpread" in p.status.unschedulable_plugins
        c.delete_pod("m0")
        c.delete_pod("m1")
        c.wait_for_pod_bound("late", timeout=20)
    finally:
        c.shutdown()


def _gang_repeller(pkg):
    c = _topo(pkg)
    try:
        c.create_node("cg-n0", cpu=64000)
        c.create_pod("gmember", cpu=100, priority=1, labels={"app": "db"},
                     pod_group="g1", pod_group_min=1)
        c.wait_for_pod_bound("gmember", timeout=20)
        c.create_pod("bystander", cpu=100, priority=1)
        c.wait_for_pod_bound("bystander", timeout=20)
        c.create_pod("vip", cpu=100, priority=100,
                     affinity=_anti(pkg[0], "db"))
        p = c.wait_for_pod_pending("vip", timeout=10)
        assert "InterPodAffinity" in p.status.unschedulable_plugins
        assert {"gmember", "bystander"} <= set(_names(c))
        return _placements(c)
    finally:
        c.shutdown()


def test_engine_anti_cure_fails_closed_on_unevictable_gang_repeller():
    _both(_gang_repeller)


def test_preemption_reserve_carries_through_residency():
    """A batch that runs while a nomination is outstanding (the nominee
    waits out a 1 s backoff) subtracts the reserve from the carried free
    input and adds it back before adopting free_after: the carried array
    then equals the host mirror, and the low-priority pod of that batch
    goes to the new node instead of the nominated capacity."""
    c = Cluster()
    c.start(profile=Profile(plugins=["NodeUnschedulable", "NodeResourcesFit",
                                     "DefaultPreemption"]),
            config=SchedulerConfig(platform="cpu", backoff_initial_s=1.0,
                                   backoff_max_s=2.0, batch_window_s=0.0),
            with_pv_controller=False)
    try:
        c.create_node("rc-n0", cpu=300)
        for i in range(3):
            c.create_pod(f"base{i}", cpu=100, priority=10)
        for i in range(3):
            c.wait_for_pod_bound(f"base{i}", timeout=20)
        c.create_pod("vip", cpu=100, priority=100)
        assert wait_until(lambda: len(_names(c, "base")) == 2, timeout=20)
        c.create_node("rc-n1", cpu=100)
        c.create_pod("thief", cpu=100, priority=1)
        assert c.wait_for_pod_bound("thief", timeout=30).spec.node_name == (
            "rc-n1")
        assert c.wait_for_pod_bound("vip", timeout=30).spec.node_name == (
            "rc-n0")
        sched = c.service.scheduler
        assert sched.metrics()["residency_nomination_carries"] >= 1
        res = sched._residency
        assert np.array_equal(res.free_dev.numpy(), res.mirror_free)
    finally:
        c.shutdown()

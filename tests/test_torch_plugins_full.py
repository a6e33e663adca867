"""The eight label and topology plugins of the port (PodTopologySpread,
InterPodAffinity, SelectorSpread, TaintToleration, NodeAffinity,
NodeName, ImageLocality, NodePreferAvoidPods) against the JAX package's:
filter, score and normalize bitwise on the same numpy leaves, on a
random cluster that exercises every feature they read, and the scenario
cases of tests/test_plugins_full.py and tests/test_plugin_parity.py run
through both packages' steps, every Decision field bitwise."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minisched_tpu.encode import NodeFeatureCache as JCache
from minisched_tpu.encode import encode_pods as jencode
from minisched_tpu.ops.pipeline import build_step as jbuild_step
from minisched_tpu.ops.topology import group_topology_state as jtopo
from minisched_tpu.plugins import PluginSet as JPluginSet
from minisched_tpu.plugins.nodeaffinity import (
    group_preferred_score as jpref, group_required_match as jreq)
from minisched_tpu.service.defaultconfig import make_plugin as jmake
from minisched_tpu.state import objects as JO
from minisched_tpu_torch.encode import NodeFeatureCache, encode_pods, to_torch
from minisched_tpu_torch.ops import prng
from minisched_tpu_torch.ops.pipeline import build_step
from minisched_tpu_torch.ops.topology import group_topology_state
from minisched_tpu_torch.plugins import PluginSet
from minisched_tpu_torch.plugins.nodeaffinity import (group_preferred_score,
                                                      group_required_match)
from minisched_tpu_torch.service.defaultconfig import make_plugin
from minisched_tpu_torch.state import objects as TO
from torch_parity import (AVOID, HOST, ZONE, bits_equal, full_cluster,
                          port_plugin)

EIGHT = ["PodTopologySpread", "InterPodAffinity", "SelectorSpread",
         "TaintToleration", "NodeAffinity", "NodeName", "ImageLocality",
         "NodePreferAvoidPods"]


def encode_both(recipe, p_pad=64, n_pad=None, selspread=True, anti=True):
    """One cluster built in both packages: per package (eb, nf, af,
    names), numpy leaves."""
    out = []
    for O, cache_cls, enc in ((JO, JCache, jencode),
                              (TO, NodeFeatureCache, encode_pods)):
        nodes, pods, bound = recipe(O)
        cache = cache_cls()
        if selspread:
            cache.enable_owner_pairs()
        cache.upsert_nodes_bulk(nodes)
        for pod, node_name in bound:
            pod.spec.node_name = node_name
            cache.account_bind(pod)
        kw = {}
        if anti:
            kw["anti_forbidden_fn"] = cache.anti_forbidden_for
        # Encode first, as the engine does: the pods' constraints register
        # their topology keys, which the node snapshot's domains reflect.
        eb = enc(pods, p_pad, cfg=cache.cfg, registry=cache.registry,
                 gang_bound_fn=cache.gang_bound_count,
                 selector_spread=selspread, **kw)
        nf, names, _sv, _incs = cache.snapshot_versioned(pad=n_pad)
        af = cache.snapshot_assigned()
        out.append((eb, nf, af, names))
    return out


def contexts(jx, tx):
    """The shared cycle state of both packages for one batch."""
    (jeb, jnf, jaf, _), (teb, tnf, taf, _) = jx, tx
    num = max(jnf.valid.shape[0], 4096)
    ctx_j = {"af": jaf, "gf": jeb.gf, "naf": jeb.naf}
    ctx_j.update(jtopo(jnf, jaf, jeb.gf, num))
    ctx_j["na_req_match"] = jreq(jeb.naf, jnf)
    ctx_j["na_pref_score"] = jpref(jeb.naf, jnf)
    eb, nf, af = (to_torch(x, "cpu") for x in (teb, tnf, taf))
    ctx_t = {"af": af, "gf": eb.gf, "naf": eb.naf}
    ctx_t.update(group_topology_state(nf, af, eb.gf, num))
    ctx_t["na_req_match"] = group_required_match(eb.naf, nf)
    ctx_t["na_pref_score"] = group_preferred_score(eb.naf, nf)
    return ctx_j, (eb, nf, af), ctx_t


@pytest.mark.parametrize("name", EIGHT)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plugin_matches_jax(name, seed):
    jx, tx = encode_both(lambda O: full_cluster(O, 96, 48, seed))
    jeb, jnf = jx[0], jx[1]
    ctx_j, (eb, nf, _af), ctx_t = contexts(jx, tx)
    jp, tp = jmake(name), port_plugin(name)
    assert (jp.is_filter, jp.is_score, jp.is_permit, jp.needs_topology,
            jp.needs_node_affinity, jp.default_weight) == (
        tp.is_filter, tp.is_score, tp.is_permit, tp.needs_topology,
        tp.needs_node_affinity, tp.default_weight)
    assert [(e.resource, int(e.action_type))
            for e in jp.events_to_register()] == [
        (e.resource, int(e.action_type)) for e in tp.events_to_register()]
    feasible = np.asarray(jeb.pf.valid)[:, None] & np.asarray(
        jnf.valid)[None, :]
    if tp.is_filter:
        want = np.asarray(jp.filter(jeb.pf, jnf, ctx_j))
        got = tp.filter(eb.pf, nf, ctx_t).numpy()
        assert bits_equal(want, got)
        assert 0 < got.sum() < got.size
        feasible = feasible & want
    if tp.is_score:
        want = np.asarray(jp.score(jeb.pf, jnf, ctx_j)).astype(np.float32)
        got = tp.score(eb.pf, nf, ctx_t).to(torch.float32)
        assert bits_equal(want, got.numpy())
        assert len(np.unique(want)) > 1
        want_n = np.asarray(jp.normalize(jnp.asarray(want), feasible))
        got_n = tp.normalize(got, torch.from_numpy(feasible))
        assert bits_equal(want_n.astype(np.float32),
                          got_n.to(torch.float32).numpy())


def test_unported_plugins_name_their_slice():
    """Every plugin of the JAX package's registry is ported: the port's
    registry lists the same names, and an unknown name still raises."""
    from minisched_tpu.service.defaultconfig import (
        registered_plugins as jregistered)
    from minisched_tpu_torch.service.defaultconfig import registered_plugins

    assert registered_plugins() == jregistered()
    for name in registered_plugins():
        assert make_plugin(name).name == jmake(name).name
    with pytest.raises(KeyError, match="unknown plugin"):
        make_plugin("NoSuchPlugin")


def step_both(recipe, plugins, *, p_pad=16, selspread=False, seed=0,
              weights=None):
    """Both packages' unsampled steps on one batch: the JAX Decision and
    the port's, with the names of the node rows."""
    jx, tx = encode_both(recipe, p_pad=p_pad, selspread=selspread)
    (jeb, jnf, jaf, names), (teb, tnf, taf, _) = jx, tx
    jps = JPluginSet([jmake(n) for n in plugins], weights)
    tps = PluginSet([port_plugin(n) for n in plugins], weights)
    want = jbuild_step(jps)(jeb, jnf, jaf, jax.random.fold_in(
        jax.random.PRNGKey(seed), 1))
    got = build_step(tps)(*(to_torch(x, "cpu") for x in (teb, tnf, taf)),
                          prng.fold_in(prng.PRNGKey(seed), 1))
    return want, got, names


def assert_decisions_equal(want, got):
    for f in got._fields:
        assert bits_equal(np.asarray(getattr(want, f)),
                          getattr(got, f).numpy()), f


def _node(O, name, labels=None, taints=None, images=None, annotations=None):
    return O.Node(metadata=O.ObjectMeta(name=name, labels=labels or {},
                                        annotations=annotations or {}),
                  spec=O.NodeSpec(taints=taints or []),
                  status=O.NodeStatus(allocatable={
                      "cpu": 4000, "memory": 16 << 30, "pods": 110},
                      images=images or []))


def _pod(O, name, ns="default", labels=None, **spec):
    return O.Pod(metadata=O.ObjectMeta(name=name, namespace=ns,
                                       labels=labels or {}),
                 spec=O.PodSpec(requests={"cpu": 100}, **spec))


def _zones(O):
    return [_node(O, n, {ZONE: z}) for z, n in
            (("a", "na1"), ("a", "na2"), ("b", "nb1"), ("c", "nc1"))]


def _spread(O, name, mode="DoNotSchedule", skew=1):
    return _pod(O, name, labels={"app": "web"},
                topology_spread_constraints=[O.TopologySpreadConstraint(
                    max_skew=skew, topology_key=ZONE, when_unsatisfiable=mode,
                    label_selector=O.LabelSelector(
                        match_labels={"app": "web"}))])


def _aff(O, name, required=(), anti=(), preferred=(), topo=ZONE, **kw):
    t = lambda s: O.PodAffinityTerm(  # noqa: E731
        label_selector=O.LabelSelector(match_labels=s), topology_key=topo)
    return _pod(O, name, affinity=O.Affinity(
        pod_affinity=O.PodAffinity(
            required=[t(s) for s in required],
            preferred=[O.WeightedPodAffinityTerm(weight=w, term=t(s))
                       for w, s in preferred]),
        pod_anti_affinity=O.PodAntiAffinity(
            required=[t(s) for s in anti])), **kw)


def _na(O, terms=None, preferred=None):
    req = None
    if terms:
        req = O.NodeSelector(node_selector_terms=[
            O.NodeSelectorTerm(match_expressions=[
                O.NodeSelectorRequirement(key=k, operator=op,
                                          values=list(v))
                for k, op, v in term]) for term in terms])
    pref = [O.PreferredSchedulingTerm(
        weight=w, preference=O.NodeSelectorTerm(match_expressions=[
            O.NodeSelectorRequirement(key=k, operator=op, values=list(v))]))
        for w, (k, op, v) in (preferred or [])]
    return O.Affinity(node_affinity=O.NodeAffinity(required=req,
                                                   preferred=pref))


def _labeled(O, name, app, ns="default", owner=None):
    p = _pod(O, name, ns=ns, labels={"app": app})
    if owner:
        p.metadata.owner_references = [O.OwnerReference(
            kind="ReplicaSet", name=owner, controller=True)]
    return p


# The cases of tests/test_plugins_full.py and tests/test_plugin_parity.py
# as recipes over either package's objects: (nodes, pending, bound).
CASES = {
    "nodename": (["NodeName"], lambda O: (
        [_node(O, "alpha"), _node(O, "beta")],
        [_pod(O, "p", required_node_name="beta"), _pod(O, "q")], [])),
    "selector-and-required-affinity": (["NodeAffinity"], lambda O: (
        [_node(O, "ssd-zone-a", {"disk": "ssd", "zone": "a"}),
         _node(O, "hdd-zone-a", {"disk": "hdd", "zone": "a"}),
         _node(O, "ssd-zone-b", {"disk": "ssd", "zone": "b"})],
        [_pod(O, "selector", node_selector={"disk": "ssd"}),
         _pod(O, "affinity", affinity=_na(
             O, [[("zone", "In", ("b", "c"))]]))], [])),
    "terms-ored": (["NodeAffinity"], lambda O: (
        [_node(O, n, {"k": v}) for n, v in (("a", "1"), ("b", "2"),
                                            ("c", "3"))],
        [_pod(O, "p", affinity=_na(O, [[("k", "In", ("1",))],
                                       [("k", "In", ("3",))]]))], [])),
    "exists-and-notin": (["NodeAffinity"], lambda O: (
        [_node(O, "gpu", {"accelerator": "tpu"}), _node(O, "plain")],
        [_pod(O, "exists", affinity=_na(O, [[("accelerator", "Exists",
                                              ())]])),
         _pod(O, "notin", affinity=_na(O, [[("accelerator", "NotIn",
                                             ("tpu",))]]))], [])),
    "preferred-affinity": (["NodeUnschedulable", "NodeAffinity"], lambda O: (
        [_node(O, "preferred", {"tier": "fast"}), _node(O, "other")],
        [_pod(O, "p", affinity=_na(O, preferred=[
            (10, ("tier", "In", ("fast",)))]))], [])),
    "taint-filter": (["TaintToleration"], lambda O: (
        [_node(O, "tainted", taints=[O.Taint(key="dedicated", value="ml",
                                             effect="NoSchedule")]),
         _node(O, "open")],
        [_pod(O, "plain"),
         _pod(O, "tolerates", tolerations=[O.Toleration(
             key="dedicated", operator="Equal", value="ml",
             effect="NoSchedule")]),
         _pod(O, "wrongval", tolerations=[O.Toleration(
             key="dedicated", operator="Equal", value="web",
             effect="NoSchedule")])], [])),
    "prefer-no-schedule": (["NodeUnschedulable", "TaintToleration"],
                           lambda O: (
        [_node(O, "soft-tainted", taints=[O.Taint(
            key="maint", value="", effect="PreferNoSchedule")]),
         _node(O, "clean")], [_pod(O, "p")], [])),
    "imagelocality": (["NodeUnschedulable", "ImageLocality"], lambda O: (
        [_node(O, "warm", images=["registry/app:v1"]), _node(O, "cold")],
        [_pod(O, "p", images=["registry/app:v1"])], [])),
    "spread-blocks-skewed-zone": (["PodTopologySpread"], lambda O: (
        _zones(O), [_spread(O, "new")],
        [(_labeled(O, "existing0", "web"), "na1"),
         (_labeled(O, "existing1", "web"), "na2")])),
    "spread-ignores-nonmatching": (["PodTopologySpread"], lambda O: (
        _zones(O), [_spread(O, "new")],
        [(_labeled(O, "other", "db"), "na1")])),
    "spread-score-prefers-empty": (["NodeUnschedulable", "PodTopologySpread"],
                                   lambda O: (
        _zones(O), [_spread(O, "new", mode="ScheduleAnyway")],
        [(_labeled(O, "existing", "web"), "na1")])),
    "spread-missing-key": (["PodTopologySpread"], lambda O: (
        _zones(O) + [_node(O, "nolabel")], [_spread(O, "new")], [])),
    "required-affinity-colocates": (["InterPodAffinity"], lambda O: (
        _zones(O), [_aff(O, "web", required=[{"app": "cache"}])],
        [(_labeled(O, "cache-server", "cache"), "nb1")])),
    "required-anti-excludes-domain": (["InterPodAffinity"], lambda O: (
        _zones(O), [_aff(O, "web2", anti=[{"app": "web"}],
                         labels={"app": "web"})],
        [(_labeled(O, "enemy", "web"), "na1")])),
    "anti-by-hostname": (["InterPodAffinity"], lambda O: (
        _zones(O), [_aff(O, "web2", anti=[{"app": "web"}], topo=HOST)],
        [(_labeled(O, "enemy", "web"), "na1")])),
    "preferred-pod-affinity": (["NodeUnschedulable", "InterPodAffinity"],
                               lambda O: (
        _zones(O), [_aff(O, "web", preferred=[(5, {"app": "cache"})])],
        [(_labeled(O, "buddy", "cache"), "nc1")])),
    "self-affine-first-replica": (["InterPodAffinity"], lambda O: (
        _zones(O), [_aff(O, "web-0", required=[{"app": "web"}],
                         labels={"app": "web"})], [])),
    "self-affine-with-peer": (["InterPodAffinity"], lambda O: (
        _zones(O), [_aff(O, "web-0", required=[{"app": "web"}],
                         labels={"app": "web"})],
        [(_labeled(O, "web-1", "web"), "nb1")])),
    "spread-score-zero-missing-key": (["PodTopologySpread"], lambda O: (
        _zones(O) + [_node(O, "unlabeled")],
        [_spread(O, "new", mode="ScheduleAnyway")],
        [(_labeled(O, "existing", "web"), "na1")])),
    "namespace-restriction": (["InterPodAffinity"], lambda O: (
        _zones(O), [_aff(O, "web", required=[{"app": "cache"}])],
        [(_labeled(O, "other", "cache", ns="production"), "nb1")])),
    "selector-spread-empty-domains": (["NodeUnschedulable", "SelectorSpread"],
                                      lambda O: (
        _zones(O), [_labeled(O, "new", "x", owner="rs-a")],
        [(_labeled(O, f"existing{i}", "x", owner="rs-a"), n)
         for i, n in enumerate(["na1", "na2"])])),
    "selector-spread-other-owner": (["NodeUnschedulable", "SelectorSpread"],
                                    lambda O: (
        _zones(O), [_labeled(O, "new", "x", owner="rs-a")],
        [(_labeled(O, "other", "x", owner="rs-b"), "nb1")])),
    "selector-spread-ownerless": (["NodeUnschedulable", "SelectorSpread"],
                                  lambda O: (
        _zones(O), [_pod(O, "solo")],
        [(_labeled(O, "existing", "x", owner="rs-a"), "na1")])),
    "prefer-avoid-pods": (["NodeUnschedulable", "NodePreferAvoidPods"],
                          lambda O: (
        [_node(O, "avoid", annotations={AVOID: "x"}), _node(O, "fine")],
        [_labeled(O, "owned", "x", owner="rs-a"), _pod(O, "bare")], [])),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_scenario_step_matches_jax(case):
    plugins, recipe = CASES[case]
    want, got, _ = step_both(recipe, plugins,
                             selspread="SelectorSpread" in plugins)
    assert_decisions_equal(want, got)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("weights", [None, {"TaintToleration": 3.0,
                                            "SelectorSpread": 0.7}])
def test_eight_plugin_step_matches_jax(seed, weights):
    """The eight plugins with NodeResourcesFit in one step on the random
    cluster, hard and soft spread mixed, with the default weights
    (10,000 for NodePreferAvoidPods, 3 for TaintToleration) and with
    weights whose products round."""
    plugins = ["NodeUnschedulable", "NodeResourcesFit"] + EIGHT
    want, got, _ = step_both(lambda O: full_cluster(O, 64, 40, seed),
                             plugins, p_pad=64, selspread=True, seed=seed,
                             weights=weights)
    assert_decisions_equal(want, got)
    assert int(np.asarray(want.assigned).sum()) > 5

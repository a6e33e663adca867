"""The caps scan (ops/select.greedy_assign with ops/spreadcap.DomainCaps)
against the JAX package's ``greedy_assign(caps=...)``, and build_step's
topology path on both of its branches (the caps scan where a slot is
enforced, else the shortlist scan or the greedy assignment), sampled
and unsampled: every Decision field bitwise. The scenarios are those of
tests/test_spreadcap.py, plus random clusters."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minisched_tpu.ops.pipeline import build_step as jbuild_step
from minisched_tpu.ops.select import greedy_assign as jgreedy
from minisched_tpu.ops.select import seed_from_key
from minisched_tpu.ops.spreadcap import DomainCaps as JDomainCaps
from minisched_tpu.ops.spreadcap import build_domain_caps as jcaps
from minisched_tpu.ops.topology import group_topology_state as jtopo
from minisched_tpu.plugins import PluginSet as JPluginSet
from minisched_tpu.service.defaultconfig import make_plugin as jmake
from minisched_tpu_torch.encode import to_torch
from minisched_tpu_torch.ops import prng
from minisched_tpu_torch.ops.pipeline import build_step
from minisched_tpu_torch.ops.select import greedy_assign, greedy_assign_plain
from minisched_tpu_torch.ops.spreadcap import build_domain_caps
from minisched_tpu_torch.ops.topology import group_topology_state
from minisched_tpu_torch.plugins import PluginSet
from test_torch_plugins_full import assert_decisions_equal, encode_both
from torch_parity import (CAPS_KINDS, ZONE, bits_equal, caps_problem,
                          full_cluster, port_plugin)

SPREAD_PLUGINS = ["NodeUnschedulable", "NodeResourcesFit",
                  "PodTopologySpread"]


def _cluster_nodes(O, n_nodes=16, zones=4, pods_cap=110.0):
    return [O.Node(metadata=O.ObjectMeta(name=f"n{i:02d}",
                                         labels={ZONE: f"z{i % zones}"}),
                   status=O.NodeStatus(allocatable={"cpu": 64000.0,
                                                    "pods": pods_cap}))
            for i in range(n_nodes)]


def _spread_pod(O, name, max_skew=1, mode="DoNotSchedule", priority=0):
    return O.Pod(
        metadata=O.ObjectMeta(name=name, namespace="default",
                              labels={"app": "s"}),
        spec=O.PodSpec(
            requests={"cpu": 100.0}, priority=priority,
            topology_spread_constraints=[O.TopologySpreadConstraint(
                max_skew=max_skew, topology_key=ZONE,
                when_unsatisfiable=mode,
                label_selector=O.LabelSelector(
                    match_labels={"app": "s"}))]))


def _plain(O, name, labels=None, cpu=100.0, priority=0):
    return O.Pod(metadata=O.ObjectMeta(name=name, namespace="default",
                                       labels=labels or {}),
                 spec=O.PodSpec(requests={"cpu": cpu}, priority=priority))


# tests/test_spreadcap.py's scenarios: (recipe, pod pad).
SCENARIOS = {
    "skew-burst": (lambda O: (
        _cluster_nodes(O), [_spread_pod(O, f"p{i:02d}") for i in range(48)],
        []), 64),
    "prebatch-imbalance": (lambda O: (
        _cluster_nodes(O), [_spread_pod(O, f"q{i:02d}") for i in range(13)],
        [(_plain(O, f"pre{j}", {"app": "s"}), "n00") for j in range(3)]),
        16),
    "unconstrained-matching-moves-counts": (lambda O: (
        _cluster_nodes(O, 4, 4, 1.0),
        [_plain(O, "rider", {"app": "s"}, priority=100)]
        + [_spread_pod(O, f"c{i}") for i in range(4)], []), 16),
    "single-domain": (lambda O: (
        _cluster_nodes(O, 4, 1), [_spread_pod(O, f"v{i}", 2)
                                  for i in range(8)], []), 8),
    "one-zone-full": (lambda O: (
        _cluster_nodes(O, 8, 2),
        [_spread_pod(O, f"w{i}", 2) for i in range(8)],
        [(_plain(O, f"b{i}-{s}", cpu=1.0), f"n{i:02d}")
         for i in range(1, 8, 2) for s in range(110)]), 8),
    "mixed-soft-hard": (lambda O: (
        _cluster_nodes(O, 12, 3),
        [_spread_pod(O, f"m{i}", 1 + i % 2,
                     "DoNotSchedule" if i % 3 else "ScheduleAnyway")
         for i in range(20)], []), 32),
    "soft-only": (lambda O: (
        _cluster_nodes(O), [_spread_pod(O, f"s{i}", mode="ScheduleAnyway")
                            for i in range(8)], []), 16),
}


def _steps(recipe, p_pad, plugins, *, shortlist=None, sample=None, seed=0,
           selspread=False):
    jx, tx = encode_both(recipe, p_pad=p_pad, selspread=selspread)
    (jeb, jnf, jaf, _), (teb, tnf, taf, _) = jx, tx
    jps = JPluginSet([jmake(n) for n in plugins])
    tps = PluginSet([port_plugin(n) for n in plugins])
    key_j = jax.random.fold_in(jax.random.PRNGKey(seed), 7)
    key_t = prng.fold_in(prng.PRNGKey(seed), 7)
    want = jbuild_step(jps, shortlist=shortlist, sample_nodes=sample)(
        jeb, jnf, jaf, key_j)
    step = build_step(tps, shortlist=shortlist, sample_nodes=sample)
    args = [to_torch(x, "cpu") for x in (teb, tnf, taf)]
    return want, step, args, key_t


@pytest.mark.parametrize("shortlist", [None, 4])
@pytest.mark.parametrize("case", sorted(SCENARIOS))
def test_scenario_step_matches_jax(case, shortlist):
    recipe, p_pad = SCENARIOS[case]
    want, step, args, key = _steps(recipe, p_pad, SPREAD_PLUGINS,
                                   shortlist=shortlist)
    got = step(*args, key)
    assert_decisions_equal(want, got)
    hard = case != "soft-only"
    assert bool(np.asarray(want.scan_groups).any()) == hard
    # The engine's host flags give the same decision, and hard_spread
    # False is only ever passed for a batch with no DoNotSchedule slot.
    got2 = step(*args, key, has_gang=False, hard_spread=hard or None)
    assert_decisions_equal(want, got2)
    if not hard:
        assert_decisions_equal(want, step(*args, key, has_gang=False,
                                          hard_spread=False))


def _random_caps_case(seed, n_nodes=40, n_pods=32):
    """JAX and port DomainCaps from one random hard batch, with random
    scores of many ties and contended capacity."""
    jx, tx = encode_both(lambda O: full_cluster(O, n_nodes, n_pods, seed),
                         p_pad=32)
    (jeb, jnf, jaf, _), (teb, tnf, taf, _) = jx, tx
    eb, nf, af = (to_torch(x, "cpu") for x in (teb, tnf, taf))
    num = max(n_nodes, 4096)
    jt = jtopo(jnf, jaf, jeb.gf, num)
    tt = group_topology_state(nf, af, eb.gf, num)
    jc = jcaps(jeb.pf, jeb.gf, jnf, jt["counts_dom"], jt["dom_exists"])
    jc = type(jc)(*[jnp.asarray(x) for x in jc])
    tc = build_domain_caps(eb.pf, eb.gf, nf, tt["counts_dom"],
                           tt["dom_exists"])
    rng = np.random.default_rng(seed)
    P, N = eb.pf.valid.shape[0], nf.valid.shape[0]
    scores = (rng.integers(0, 4, (P, N)) * 25.0).astype(np.float32)
    scores[rng.random((P, N)) < 0.1] = -3.0e38
    req = np.asarray(jeb.pf.requests)
    free = np.asarray(jnf.free).copy()
    free[:, 0] = rng.choice([300.0, 500.0, 900.0], N)
    return jc, tc, scores, req, free


@pytest.mark.parametrize("seed", range(6))
def test_caps_scan_matches_jax(seed):
    """The plain caps scan against JAX's greedy_assign(caps=...) on the
    same DomainCaps content, scores, requests, free and key."""
    jc, tc, scores, req, free = _random_caps_case(seed)
    assert bool(tc.any_enforced)
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
    want = jgreedy(scores, req, free, key, caps=jc)
    seed32 = int(np.asarray(seed_from_key(key)))
    args = (torch.from_numpy(scores), torch.from_numpy(req),
            torch.from_numpy(free), seed32, tc)
    got = greedy_assign_plain(*args)
    for w, g in zip(want, got):
        assert bits_equal(np.asarray(w), g.numpy())
    # greedy_assign dispatches CPU tensors with caps to the plain scan.
    for w, g in zip(want, greedy_assign(*args[:4], caps=tc)):
        assert bits_equal(np.asarray(w), g.numpy())
    assert int(np.asarray(want.assigned).sum()) > 0
    # The running counts changed some choice against the unmasked scan.
    plain = jgreedy(scores, req, free, key)
    assert not np.array_equal(np.asarray(plain.chosen),
                              np.asarray(want.chosen))


@pytest.mark.parametrize("kind", CAPS_KINDS)
def test_caps_problem_matches_jax(kind):
    """Every caps problem the card tests hold the kernel to
    (tests/torch_parity.caps_problem): the plain caps scan against JAX's
    greedy_assign(caps=...) on the same DomainCaps, scores, requests,
    free and key."""
    scores, req, free, _seed, tc = caps_problem(kind)
    jc = JDomainCaps(*[jnp.asarray(t.numpy()) for t in tc])
    key = jax.random.fold_in(jax.random.PRNGKey(17), len(kind))
    want = jgreedy(jnp.asarray(scores.numpy()), jnp.asarray(req.numpy()),
                   jnp.asarray(free.numpy()), key, caps=jc)
    seed32 = int(np.asarray(seed_from_key(key)))
    got = greedy_assign_plain(scores, req, free, seed32, tc)
    for w, g in zip(want, got):
        assert bits_equal(np.asarray(w), g.numpy())
    assert int(np.asarray(want.assigned).sum()) > 0


@pytest.mark.parametrize("shortlist", [None, 8])
@pytest.mark.parametrize("hard", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_random_topology_step_matches_jax(seed, hard, shortlist):
    """The config-4 plugin pair with NodeResourcesFit on random clusters:
    hard (the caps branch where a slot is enforced) and soft (the
    shortlist or greedy branch), unsampled."""
    plugins = ["NodeUnschedulable", "NodeResourcesFit", "PodTopologySpread",
               "InterPodAffinity"]
    want, step, args, key = _steps(
        lambda O: full_cluster(O, 48, 40, seed, hard=hard), 64, plugins,
        shortlist=shortlist, seed=seed)
    assert_decisions_equal(want, step(*args, key))
    assert bool(np.asarray(want.scan_groups).any()) == hard


@pytest.mark.parametrize("shortlist", [None, 8])
@pytest.mark.parametrize("seed", [0, 1])
def test_sampled_topology_step_matches_jax(seed, shortlist):
    """A sampled soft topology step: the topology and node-affinity
    tables on the full axis, their per-node rows gathered by the sample,
    every Decision field (spread rows in the sample's columns) equal."""
    plugins = ["NodeUnschedulable", "NodeResourcesFit", "PodTopologySpread",
               "InterPodAffinity", "NodeAffinity", "SelectorSpread"]
    want, step, args, key = _steps(
        lambda O: full_cluster(O, 96, 40, seed, hard=False), 64, plugins,
        shortlist=shortlist, sample=32, seed=seed, selspread=True)
    got = step(*args, key)
    assert_decisions_equal(want, got)
    assert got.spread_pre.shape[0] == 64 and not got.scan_groups.any()

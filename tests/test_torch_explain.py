"""Explain mode and the pod-chunked evaluation of the port's step against
the JAX package's.

``build_step(explain=True)`` gives every Decision field bitwise equal to
the JAX step's, the three per-plugin stacks and ``total_scores``
included, for the README profile, the bench profile,
``full_scheduler_profile()`` and config 4 hard (whose caps never run in
explain mode), with the greedy scan and with the auction; explain with
node sampling raises in both packages. The pod-chunked evaluation,
forced with tests/test_pipeline.py's knobs in both packages, equals the
JAX package's chunked step and the port's unchunked one, on that test's
topology batch and on a config-4-hard batch whose enforced slot makes
``feasible_static`` differ from ``feasible_counts``. The README
scenario's explain test and the demo scenario run on the CPU.
"""
import jax
import numpy as np
import pytest

from bench_workload import C4_PLUGINS
from minisched_tpu.ops import pipeline as jpl
from minisched_tpu.ops.pipeline import build_step as jbuild_step
from minisched_tpu.plugins import PluginSet as JPluginSet
from minisched_tpu.service.defaultconfig import Profile as JProfile
from minisched_tpu.service.defaultconfig import \
    full_scheduler_profile as jfull_profile
from minisched_tpu.service.defaultconfig import make_plugin as jmake
from minisched_tpu.state import objects as JO
from minisched_tpu_torch.config import SchedulerConfig
from minisched_tpu_torch.encode import to_torch
from minisched_tpu_torch.ops import pipeline as tpl
from minisched_tpu_torch.ops import prng, spreadcap
from minisched_tpu_torch.ops.pipeline import Decision, build_step
from minisched_tpu_torch.plugins import PluginSet
from minisched_tpu_torch.scenario.runner import Cluster, wait_until
from minisched_tpu_torch.service.defaultconfig import (Profile,
                                                       full_scheduler_profile,
                                                       make_plugin)
from minisched_tpu_torch.state import objects as TO
from test_torch_caps import SCENARIOS, SPREAD_PLUGINS
from test_torch_plugins_full import encode_both
from torch_parity import (BENCH_PROFILE, LIVE_PROFILE, ZONE, bench_cluster,
                          bits_equal, full_cluster, jax_rules,
                          mixed_cluster, port_plugin)

import chip_smoke


def _no_caps(*_a, **_k):
    raise AssertionError("the in-scan domain caps ran in explain mode")


def _c4_hard(O):
    """Config 4 hard (DoNotSchedule max_skew 1 over 16 zones, preferred
    affinity on every other pod) on 96 bench nodes, with 12 pods of
    app=bench already bound on a node of zone z0: the static skew check
    rejects z0 for every pod of the batch."""
    nodes, pods = bench_cluster(O, 96, 60, 4)
    pods = chip_smoke.c4_pods(pods, max_skew=1, hard=True, objects=O)
    return nodes, pods[:48], [(p, "node-0-0") for p in pods[48:]]


PROFILES = {
    "readme": (lambda: JProfile(**LIVE_PROFILE).build(),
               lambda: Profile(**LIVE_PROFILE).build(),
               lambda O: mixed_cluster(O, 90, 40, 2)),
    "bench": (lambda: JProfile(**BENCH_PROFILE).build(),
              lambda: Profile(**BENCH_PROFILE).build(),
              lambda O: (*bench_cluster(O, 150, 48, 3), [])),
    "full": (lambda: jfull_profile().build(),
             lambda: jax_rules(full_scheduler_profile()).build(),
             lambda O: full_cluster(O, 96, 48, 1)),
    "c4-hard": (lambda: JPluginSet([jmake(n) for n in C4_PLUGINS]),
                lambda: PluginSet([port_plugin(n) for n in C4_PLUGINS]),
                _c4_hard),
}


def _explain_both(jps, tps, recipe, *, assignment="greedy", shortlist=None,
                  p_pad=64, seed=0, counter=5, selspread=True,
                  contracted=False):
    """Both packages' explain steps on one cluster: every Decision field
    bitwise. ``contracted``: the JAX step's raw and normalized stacks
    are held against the JAX plugins' un-jitted values instead (see
    _check_stacks_against_eager)."""
    jx, tx = encode_both(recipe, p_pad=p_pad, selspread=selspread)
    (jeb, jnf, jaf, _names), (teb, tnf, taf, _) = jx, tx
    want = jbuild_step(jps, explain=True, pallas=False, assignment=assignment,
                       shortlist=shortlist)(
        jeb, jnf, jaf, jax.random.fold_in(jax.random.PRNGKey(seed), counter))
    got = build_step(tps, explain=True, assignment=assignment,
                     shortlist=shortlist)(
        *(to_torch(x, "cpu") for x in (teb, tnf, taf)),
        prng.fold_in(prng.PRNGKey(seed), counter))
    assert isinstance(got, Decision)
    assert got._fields == jpl.Decision._fields
    stacks = ("raw_scores", "norm_scores") if contracted else ()
    for f in got._fields:
        if f not in stacks:
            assert bits_equal(np.asarray(getattr(want, f)),
                              getattr(got, f).numpy()), f
    if contracted:
        _check_stacks_against_eager(want, got, jps, jeb, jnf)
    return got


def _check_stacks_against_eager(want, got, jps, jeb, jnf):
    """XLA's CPU backend contracts BalancedAllocation's ``100 -
    sqrt(var) * 100`` into one fused multiply-add where that value is a
    program output (the JAX step's raw and normalized stacks, or a
    jitted score alone) but not inside the fusion that sums the
    weighted total, so the JAX step's stacks can sit one float32 ulp
    from its own ``total_scores``' inputs. The port rounds as the JAX
    plugin does un-jitted (and as the JAX total does): its stacks equal
    the JAX plugins' eager values bitwise, and the JAX step's stacks
    differ from those only on BalancedAllocation, by at most one ulp."""
    import jax.numpy as jnp

    feasible = (np.asarray(want.filter_masks).all(axis=0)
                & np.asarray(jeb.pf.valid)[:, None]
                & np.asarray(jnf.valid)[None, :])
    for s, jp in enumerate(jps.score_plugins):
        raw = np.asarray(jp.score(jeb.pf, jnf, {})).astype(np.float32)
        norm = np.asarray(jp.normalize(jnp.asarray(raw), feasible)).astype(
            np.float32)
        assert bits_equal(raw, got.raw_scores[s].numpy()), jp.name
        assert bits_equal(norm, got.norm_scores[s].numpy()), jp.name
        for mine, theirs in ((raw, want.raw_scores[s]),
                             (norm, want.norm_scores[s])):
            ulps = np.abs(mine.view(np.int32).astype(np.int64)
                          - np.asarray(theirs).view(np.int32))
            if jp.name == "NodeResourcesBalancedAllocation":
                assert ulps.max() <= 1
            else:
                assert ulps.max() == 0, jp.name


@pytest.mark.parametrize("shortlist", [None, 16])
@pytest.mark.parametrize("profile", sorted(PROFILES))
def test_explain_step_matches_jax(profile, shortlist, monkeypatch):
    """Every Decision field bitwise, the stacks and total_scores
    included; for config 4 hard the caps never run (the step would
    otherwise read any_enforced with hard_spread=None)."""
    jps_fn, tps_fn, recipe = PROFILES[profile]
    monkeypatch.setattr(spreadcap, "build_domain_caps", _no_caps)
    tps = tps_fn()
    d = _explain_both(jps_fn(), tps, recipe, shortlist=shortlist)
    F, S = len(tps.filter_plugins), len(tps.score_plugins)
    P, N = d.chosen.shape[0], d.free_after.shape[0]
    assert tuple(d.filter_masks.shape) == (F, P, N)
    assert tuple(d.raw_scores.shape) == tuple(d.norm_scores.shape) == (S, P, N)
    assert tuple(d.total_scores.shape) == (P, N)
    assert d.assigned.any()
    if profile == "c4-hard":
        assert not d.scan_groups.any()
        # the static verdict rejects zone z0 for the spread pods
        spread = next(i for i, p in enumerate(tps.filter_plugins)
                      if p.name == "PodTopologySpread")
        assert (~d.filter_masks[spread]).any()


def test_explain_placeholders_without_explain():
    """Outside explain mode the four fields are zero-size placeholders of
    the JAX package's shapes and types."""
    tps = Profile(**BENCH_PROFILE).build()
    _jx, (teb, tnf, taf, _) = encode_both(
        lambda O: (*bench_cluster(O, 40, 10, 0), []), p_pad=16)
    d = build_step(tps)(*(to_torch(x, "cpu") for x in (teb, tnf, taf)),
                        prng.PRNGKey(0))
    P, N = d.chosen.shape[0], d.free_after.shape[0]
    assert tuple(d.total_scores.shape) == (0, N)
    assert tuple(d.filter_masks.shape) == (0, P, N)
    assert tuple(d.raw_scores.shape) == tuple(d.norm_scores.shape) == (
        0, P, N)
    assert str(d.filter_masks.dtype) == "torch.bool"


@pytest.mark.parametrize("assignment,shortlist", [
    ("greedy", None), ("greedy", 16), ("auction", None), ("auction", 8)])
def test_explain_step_on_mixed_nodes(assignment, shortlist):
    """The bench profile on mixed_cluster (nodes without memory, pods
    without a memory request, gangs), greedy and under the auction:
    every field bitwise but the raw and normalized stacks, which the
    JAX step's FMA contraction moves by one ulp on BalancedAllocation
    (_check_stacks_against_eager)."""
    _explain_both(JProfile(**BENCH_PROFILE).build(),
                  Profile(**BENCH_PROFILE).build(),
                  lambda O: mixed_cluster(O, 80, 40, 5), assignment=assignment,
                  shortlist=shortlist, contracted=True)


@pytest.mark.parametrize("shortlist", [None, 8])
def test_explain_auction_step_matches_jax(shortlist):
    _explain_both(JProfile(**BENCH_PROFILE).build(),
                  Profile(**BENCH_PROFILE).build(),
                  lambda O: (*bench_cluster(O, 120, 40, 6), []),
                  assignment="auction", shortlist=shortlist)


def test_sampling_incompatible_with_explain_in_both_packages():
    with pytest.raises(ValueError):
        jbuild_step(JPluginSet([jmake("NodeUnschedulable")]), explain=True,
                    sample_nodes=8)
    with pytest.raises(ValueError, match="explain"):
        build_step(PluginSet([make_plugin("NodeUnschedulable")]),
                   explain=True, sample_nodes=8)


# ---- pod-chunked evaluation ----------------------------------------------

def _topology_batch(O):
    """tests/test_pipeline.py:128's batch: 12 nodes over three zones, 8
    pods with a ScheduleAnyway zone spread."""
    nodes = [O.Node(metadata=O.ObjectMeta(name=f"zn{i}",
                                          labels={ZONE: f"z{i % 3}"}),
                    status=O.NodeStatus(allocatable={
                        "cpu": 4000.0, "memory": float(16 << 30),
                        "pods": 110.0}))
             for i in range(12)]
    pods = []
    for i in range(8):
        p = O.Pod(metadata=O.ObjectMeta(name=f"cp{i}", namespace="default",
                                        labels={"app": "chunk"}),
                  spec=O.PodSpec(requests={"cpu": 100.0 + 50 * (i % 2)}))
        p.spec.topology_spread_constraints = [O.TopologySpreadConstraint(
            max_skew=1, topology_key=ZONE, when_unsatisfiable="ScheduleAnyway",
            label_selector=O.LabelSelector(match_labels={"app": "chunk"}))]
        pods.append(p)
    return nodes, pods, []


CHUNK_CASES = {
    "topology": (_topology_batch, ["NodeUnschedulable", "NodeResourcesFit",
                                   "PodTopologySpread", "InterPodAffinity"],
                 {"NodeResourcesFit": {"score_strategy": None}}, 8),
    "c4-hard-enforced": (SCENARIOS["prebatch-imbalance"][0], SPREAD_PLUGINS,
                         {}, 16),
}


def _plugins(make, names, fit_args):
    return [make(n, **fit_args.get(n, {})) for n in names]


def _force_chunks(monkeypatch, module, forced):
    if forced:
        monkeypatch.setattr(module, "_CHUNK_WHEN_BYTES", 0)
        monkeypatch.setattr(module, "_CHUNK_TARGET_BYTES", 2 * 16 * 4)
        monkeypatch.setattr(module, "_CHUNK_MIN_PODS", 2)
    else:
        monkeypatch.setattr(module, "_CHUNK_WHEN_BYTES", 1 << 30)


@pytest.mark.parametrize("case", sorted(CHUNK_CASES))
def test_chunked_step_matches_jax_and_unchunked(case, monkeypatch):
    recipe, names, fit_args, p_pad = CHUNK_CASES[case]
    jx, tx = encode_both(recipe, p_pad=p_pad, selspread=False)
    (jeb, jnf, jaf, _n), (teb, tnf, taf, _) = jx, tx
    targs = [to_torch(x, "cpu") for x in (teb, tnf, taf)]
    jps = JPluginSet(_plugins(jmake, names, fit_args))
    tps = PluginSet(_plugins(port_plugin, names, fit_args))
    key = prng.fold_in(prng.PRNGKey(3), 2)
    chunk_sizes = []
    orig = tpl._chunk_pods

    def spy(P, N):
        chunk_sizes.append(orig(P, N))
        return chunk_sizes[-1]

    monkeypatch.setattr(tpl, "_chunk_pods", spy)
    _force_chunks(monkeypatch, tpl, False)
    base = build_step(tps, shortlist=4)(*targs, key)
    _force_chunks(monkeypatch, tpl, True)
    chunked = build_step(tps, shortlist=4)(*targs, key)
    assert chunk_sizes == [None, 2]
    jpl._STEP_CACHE.clear()  # the knobs are read when the step traces
    try:
        _force_chunks(monkeypatch, jpl, True)
        want = jbuild_step(jps, pallas=False, shortlist=4)(
            jeb, jnf, jaf, jax.random.fold_in(jax.random.PRNGKey(3), 2))
    finally:
        jpl._STEP_CACHE.clear()
    for f in Decision._fields:
        assert bits_equal(getattr(base, f).numpy(),
                          getattr(chunked, f).numpy()), f
        assert bits_equal(np.asarray(getattr(want, f)),
                          getattr(chunked, f).numpy()), f
    assert chunked.assigned.any()
    if case == "c4-hard-enforced":
        assert chunked.scan_groups.any()
        assert (chunked.feasible_static != chunked.feasible_counts).any()


def test_chunk_rule_matches_jax_at_full_size():
    """At 8,192 x 53,248 the default knobs chunk at C = 2,048 (four
    chunks); below 1 GiB of scores nothing chunks; C halves only
    through even values."""
    assert tpl._chunk_pods(8192, 53248) == 2048
    assert tpl._chunk_pods(1024, 53248) is None
    assert tpl._chunk_pods(4608 + 16, 65536) == 4624 // 2
    assert (tpl._CHUNK_WHEN_BYTES, tpl._CHUNK_TARGET_BYTES,
            tpl._CHUNK_MIN_PODS) == (jpl._CHUNK_WHEN_BYTES,
                                     jpl._CHUNK_TARGET_BYTES,
                                     jpl._CHUNK_MIN_PODS)


# ---- the scenarios --------------------------------------------------------

def test_explain_annotations_recorded():
    """tests/test_scenario.py's explain test on the port."""
    import json

    from minisched_tpu_torch.explain import (FILTER_RESULT_KEY,
                                             FINAL_SCORE_RESULT_KEY,
                                             SCORE_RESULT_KEY)

    c = Cluster()
    try:
        c.start(config=SchedulerConfig(platform="cpu", explain=True,
                                       backoff_initial_s=0.05,
                                       backoff_max_s=0.2))
        c.create_node("good1")
        c.create_node("bad2", unschedulable=True)
        c.create_pod("query1")
        c.wait_for_pod_bound("query1", timeout=5)
        assert wait_until(
            lambda: FILTER_RESULT_KEY in c.get_pod(
                "query1").metadata.annotations, timeout=3)
        pod = c.get_pod("query1")
        fr = json.loads(pod.metadata.annotations[FILTER_RESULT_KEY])
        assert fr["good1"]["NodeUnschedulable"] == "passed"
        assert fr["bad2"]["NodeUnschedulable"] != "passed"
        sr = json.loads(pod.metadata.annotations[SCORE_RESULT_KEY])
        assert sr["good1"]["NodeNumber"] == 10.0  # suffix match
        fs = json.loads(pod.metadata.annotations[FINAL_SCORE_RESULT_KEY])
        assert fs["good1"]["NodeNumber"] == 10.0
    finally:
        c.shutdown()


def test_demo_scenario_on_the_cpu(capsys):
    from minisched_tpu_torch.scenario import demo

    demo.main(platform="cpu")
    out = capsys.readouterr().out
    assert "spread: 6 replicas balanced" in out
    assert "explain: full-N verdict for web-0" in out
    assert out.strip().splitlines()[-1] == "demo OK"

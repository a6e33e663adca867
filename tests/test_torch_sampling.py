"""Node-axis sampling in the port against the JAX package, bitwise.

The cases of tests/test_sampling.py on both packages: pct=100 is the
unsampled step, the sampled step assigns within its sample and remaps
rows to global ones, a sample covering every node decides as the full
step, an engine under sampling binds everything, the residual pass
rescues a pod that fits only outside the sample, and a terminal verdict
comes from the full axis. The port has no explain mode, so the explain
case is left out, and no NodeName plugin, so the pod outside the sample
is pinned by capacity (it fits only on a nearly full node) instead of by
name. Below them: the sample's node choice against the JAX function on
ties and -inf rows, and its proxy against XLA's on random shapes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from hypothesis.extra import numpy as hnp

from minisched_tpu.config import SchedulerConfig as JConfig
from minisched_tpu.encode import NodeFeatureCache as JCache
from minisched_tpu.encode import encode_pods as jencode
from minisched_tpu.encode.features import NodeFeatures as JNodeFeatures
from minisched_tpu.ops.pipeline import _select_node_sample as jselect
from minisched_tpu.ops.pipeline import build_step as jbuild_step
from minisched_tpu.scenario.runner import Cluster as JCluster
from minisched_tpu.service.defaultconfig import Profile as JProfile
from minisched_tpu.state import objects as JO
from minisched_tpu_torch.config import SchedulerConfig
from minisched_tpu_torch.encode import NodeFeatureCache, encode_pods, to_torch
from minisched_tpu_torch.ops import prng
from minisched_tpu_torch.ops.pipeline import (_sample_proxy,
                                              _select_node_sample,
                                              build_step)
from minisched_tpu_torch.scenario.runner import Cluster, wait_until
from minisched_tpu_torch.service.defaultconfig import Profile
from minisched_tpu_torch.state import objects as TO

PLUGINS = ["NodeUnschedulable", "NodeResourcesFit",
           "NodeResourcesLeastAllocated"]
FIELDS = ("chosen", "assigned", "gang_rejected", "feasible_counts",
          "feasible_static", "reject_counts", "free_after",
          "shortlist_repaired")


def _setup(O, cache_cls, enc, n_nodes, n_pods):
    """tests/test_sampling.py's setup: n nodes of 4 cores, 8 pods of 0.1
    core, encoded by one package."""
    cache = cache_cls()
    for i in range(n_nodes):
        cache.upsert_node(O.Node(
            metadata=O.ObjectMeta(name=f"s-n{i:03d}"),
            status=O.NodeStatus(allocatable={"cpu": 4000,
                                             "memory": 16 << 30,
                                             "pods": 110})))
    pods = [O.Pod(metadata=O.ObjectMeta(name=f"s-p{i}", namespace="default"),
                  spec=O.PodSpec(requests={"cpu": 100}))
            for i in range(n_pods)]
    eb = enc(pods, 8, registry=cache.registry)
    nf, _names = cache.snapshot()
    return eb, nf, cache.snapshot_assigned()


def _steps(n_nodes, sample_nodes, seed, shortlist=None):
    """One sampled (or unsampled) step on both packages: (jax Decision,
    port Decision)."""
    jps = JProfile(plugins=PLUGINS).build()
    tps = Profile(plugins=PLUGINS).build()
    jd = jbuild_step(jps, sample_nodes=sample_nodes, shortlist=shortlist)(
        *_setup(JO, JCache, jencode, n_nodes, 8), jax.random.PRNGKey(seed))
    eb, nf, af = _setup(TO, NodeFeatureCache, encode_pods, n_nodes, 8)
    td = build_step(tps, sample_nodes=sample_nodes, shortlist=shortlist)(
        to_torch(eb, "cpu"), to_torch(nf, "cpu"), to_torch(af, "cpu"),
        prng.PRNGKey(seed))
    return jd, td


def _assert_same(jd, td):
    for f in FIELDS:
        a, b = np.asarray(getattr(jd, f)), getattr(td, f).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), f


def test_pct_100_is_exactly_the_unsampled_step():
    """sample_nodes=None is the unsampled step (JAX's, bitwise), and
    pct=100 never samples: the engine keeps its full-axis step."""
    jd, td = _steps(64, None, 0)
    _assert_same(jd, td)
    eb, nf, af = _setup(TO, NodeFeatureCache, encode_pods, 64, 8)
    _assert_same(td, build_step(Profile(plugins=PLUGINS).build())(
        to_torch(eb, "cpu"), to_torch(nf, "cpu"), to_torch(af, "cpu"),
        prng.PRNGKey(0)))

    c = Cluster()
    c.start(Profile(plugins=PLUGINS),
            SchedulerConfig(platform="cpu", percentage_of_nodes_to_score=100,
                            min_sample_nodes=16))
    try:
        for i in range(64):
            c.create_node(f"p-n{i}", cpu=1000)
        sched = c.service.scheduler
        assert wait_until(lambda: sched.cache.node_count() == 64, timeout=10)
        assert sched._sampled_step(64, 8, False) == (None, None)
        sched.config.percentage_of_nodes_to_score = 25
        step, k = sched._sampled_step(64, 8, False)
        assert k == 16 and step is not None
        assert sched._sampled_step(64, 8, True) == (None, None)  # gangs
    finally:
        c.shutdown()


@pytest.mark.parametrize("shortlist", [None, 4])
@pytest.mark.parametrize("seed", [0, 1])
def test_sampled_step_assigns_within_sample_and_remaps_rows(seed, shortlist):
    jd, td = _steps(64, 16, seed, shortlist)
    _assert_same(jd, td)
    chosen = td.chosen.numpy()[:8]
    assert td.assigned.numpy()[:8].all()
    assert ((chosen >= 0) & (chosen < 64)).all()  # global rows
    assert td.free_after.shape[0] == 64  # full-size
    _, tnf, _ = _setup(TO, NodeFeatureCache, encode_pods, 64, 8)
    skey = prng.split(prng.PRNGKey(seed))[1]
    sample = _select_node_sample(to_torch(tnf, "cpu"), skey, 16).numpy()
    assert set(chosen.tolist()) <= set(sample.tolist())


def test_sampled_step_equality_when_sample_covers_all_nodes():
    """K >= N evaluates every node: the same feasibility and assignment
    as the unsampled step, and every field equal to JAX's."""
    jd, td = _steps(16, 16, 3)
    _assert_same(jd, td)
    _, full = _steps(16, None, 3)
    assert torch.equal(full.feasible_counts, td.feasible_counts)
    assert torch.equal(full.assigned, td.assigned)


def _engine(cluster_cls, O, profile, config, objects, bound, parked=()):
    """Every object in the store before the engine starts; wait until
    ``bound`` pods are bound and ``parked`` ones carry a verdict.
    Returns ({pod: node}, {pod: (plugins, message)}, metrics)."""
    c = cluster_cls()
    c.create_objects(objects)
    c.start(profile, config)
    try:
        def done():
            pods = {p.metadata.name: p for p in c.list_pods()}
            return (all(pods[n].spec.node_name for n in bound)
                    and all(pods[n].status.unschedulable_plugins
                            for n in parked))

        assert wait_until(done, timeout=60)
        sched = c.service.scheduler
        assert wait_until(lambda: sched.metrics()["pods_seen"]
                          >= len(bound) + len(parked), timeout=30)
        pods = c.list_pods()
        return ({p.metadata.name: p.spec.node_name for p in pods
                 if p.spec.node_name},
                {p.metadata.name: (tuple(p.status.unschedulable_plugins),
                                   p.status.message)
                 for p in pods if p.metadata.name in parked},
                sched.metrics())
    finally:
        c.shutdown()


@pytest.fixture
def sampled(monkeypatch):
    """Records the sample width of every port batch (None = unsampled)
    and the residual pass's pod counts."""
    from minisched_tpu_torch.engine.scheduler import Scheduler

    seen = {"k": [], "residual": []}
    sampled_step, run_residual = (Scheduler._sampled_step,
                                  Scheduler._run_residual)

    def record_k(self, *a):
        out = sampled_step(self, *a)
        seen["k"].append(out[1])
        return out

    def record_residual(self, b, rows, *a):
        seen["residual"].append(len(rows))
        return run_residual(self, b, rows, *a)

    monkeypatch.setattr(Scheduler, "_sampled_step", record_k)
    monkeypatch.setattr(Scheduler, "_run_residual", record_residual)
    return seen


def _both_engines(make_objects, bound, parked=(), **cfg):
    """Batches of 8 against 64+ nodes at pct=25 and min_sample_nodes=16:
    every batch samples K=16 nodes."""
    kw = dict(max_batch_size=8, backoff_initial_s=0.05, backoff_max_s=0.2,
              percentage_of_nodes_to_score=25, min_sample_nodes=16, **cfg)
    want = _engine(JCluster, JO, JProfile(plugins=PLUGINS), JConfig(**kw),
                   make_objects(JO), bound, parked)
    got = _engine(Cluster, TO, Profile(plugins=PLUGINS),
                  SchedulerConfig(platform="cpu", **kw), make_objects(TO),
                  bound, parked)
    assert got[0] == want[0] and got[1] == want[1]
    return got


def _nodes(O, n, cpu=1000):
    return [O.Node(metadata=O.ObjectMeta(name=f"e-n{i:03d}"),
                   status=O.NodeStatus(allocatable={
                       "cpu": cpu, "memory": 16 << 30, "pods": 110}))
            for i in range(n)]


def _pods(O, names, cpu, **spec_kw):
    return [O.Pod(metadata=O.ObjectMeta(name=n, namespace="default"),
                  spec=O.PodSpec(requests={"cpu": cpu}, **spec_kw))
            for n in names]


@pytest.mark.parametrize("pipeline", [False, True])
def test_engine_sampled_batch_binds_everything(pipeline, sampled):
    """With ample capacity every sampled batch binds all its pods, where
    the JAX engine binds them."""
    names = [f"e-p{i}" for i in range(32)]
    placed, _, m = _both_engines(
        lambda O: _nodes(O, 64) + _pods(O, names, 100), names,
        pipeline=pipeline)
    assert len(placed) == 32 and m["pods_failed"] == 0
    assert sampled["k"] == [16] * 4 and sampled["residual"] == []


@pytest.mark.parametrize("pipeline", [False, True])
def test_engine_residual_rescues_pod_outside_sample(pipeline, sampled):
    """A pod that fits only on a nearly full node (the free-capacity
    proxy ranks it last, so no sample of 16 holds it) binds in its first
    cycle through the residual full-axis pass, on the JAX engine's
    node."""

    def objects(O):
        # r-pinned (150) fits only on e-tight: 200 of its 4000 free, the
        # other nodes 120 each.
        tight = O.Node(metadata=O.ObjectMeta(name="e-tight"),
                       status=O.NodeStatus(allocatable={
                           "cpu": 4000, "memory": 16 << 30, "pods": 110}))
        filler = O.Pod(metadata=O.ObjectMeta(name="filler",
                                             namespace="default"),
                       spec=O.PodSpec(node_name="e-tight",
                                      requests={"cpu": 3800}))
        return (_nodes(O, 64, cpu=120) + [tight, filler]
                + _pods(O, [f"r-p{i}" for i in range(31)], 10)
                + _pods(O, ["r-pinned"], 150))

    bound = [f"r-p{i}" for i in range(31)] + ["r-pinned"]
    placed, _, m = _both_engines(objects, bound, pipeline=pipeline)
    assert placed["r-pinned"] == "e-tight"
    assert m["pods_failed"] == 0, m  # one attempt: the residual pass
    assert set(sampled["k"]) == {16} and sampled["residual"] == [1]


def test_engine_sampled_terminal_verdict_comes_from_full_axis(sampled):
    """A pod that fits nowhere takes its verdict from the full axis
    (0/65 nodes), not from the sample, with JAX's plugins and message."""
    _, parked, _ = _both_engines(
        lambda O: (_nodes(O, 65) + _pods(O, [f"ok{i}" for i in range(8)], 10)
                   + _pods(O, ["huge"], 5000)),
        [f"ok{i}" for i in range(8)], parked=("huge",))
    plugins, message = parked["huge"]
    assert "NodeResourcesFit" in plugins
    assert "0/65" in message, message
    assert set(sampled["k"]) == {16} and 1 in sampled["residual"]


# ---- the sample itself ----------------------------------------------------


def _node_features(rng, N, R, *, ties=0, invalid=0.05, unsched=0.05):
    """Random node leaves for the sample's proxy: allocatable with zero
    axes, free partly negative or zero; the first ``ties`` rows have a
    proxy so large that the jitter is below its ulp, so their values tie
    exactly; some rows padded or cordoned (-inf)."""
    alloc = (rng.integers(0, 5, (N, R)) * rng.random((N, R)) * 1000)
    free = alloc * rng.random((N, R)) - rng.random((N, R)) * 10
    free[rng.random((N, R)) < 0.1] = 0
    free[: N // 4] = alloc[: N // 4]
    alloc[:ties] = 0.0
    free[:ties] = 1.0
    fields = {f: np.zeros((N, 1), np.int32) for f in JNodeFeatures._fields}
    fields.update(valid=rng.random(N) >= invalid,
                  unschedulable=rng.random(N) < unsched,
                  allocatable=alloc.astype(np.float32),
                  free=free.astype(np.float32),
                  topo_domains=np.zeros((1, N), np.int32))
    return JNodeFeatures(**fields)


def _jax_sample(nf, seed, k):
    return np.asarray(jax.jit(lambda nf, key: jselect(nf, key, k))(
        nf, jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("N,R,K,kw", [
    (53248, 10, 4096, {}),                      # the bench-50k sample
    (2048, 10, 512, {"ties": 300}),             # ties across the boundary
    (1000, 7, 999, {"ties": 50}),               # nearly all rows
    (300, 3, 300, {"invalid": 0.3, "unsched": 0.3}),  # -inf rows taken
    (64, 10, 16, {"ties": 64}),                 # every row tied
])
def test_select_node_sample_matches_jax(N, R, K, kw):
    nf = _node_features(np.random.default_rng(N), N, R, **kw)
    want = _jax_sample(nf, 3, K)
    got = _select_node_sample(to_torch(nf, "cpu"), prng.PRNGKey(3), K)
    assert np.array_equal(got.numpy(), want)


def _jax_proxy(free, alloc, key):
    """jnp's proxy as minisched_tpu/ops/pipeline.py:119-124 computes it
    (all rows schedulable)."""
    a = jnp.maximum(alloc, 1e-9)
    score = (jnp.clip(free, 0.0, None) / a).mean(axis=1)
    return score + jax.random.uniform(key, score.shape, maxval=0.05)


@settings(max_examples=40, deadline=None)
@given(st.data())
def test_sample_proxy_matches_xla(data):
    """The column-loop mean and fused jitter against XLA's on random
    shapes and values (zeros, negatives, subnormal-sized allocations)."""
    n = data.draw(st.integers(1, 257), label="N")
    r = data.draw(st.integers(1, 12), label="R")
    vals = st.floats(-1e4, 1e6, width=32, allow_nan=False)
    free = data.draw(hnp.arrays(np.float32, (n, r), elements=vals))
    alloc = np.abs(data.draw(hnp.arrays(np.float32, (n, r), elements=vals)))
    seed = data.draw(st.integers(0, 2**32 - 1), label="seed")
    want = np.asarray(jax.jit(_jax_proxy)(free, alloc,
                                          jax.random.PRNGKey(seed)))
    fields = {f: np.zeros((n, 1), np.int32) for f in JNodeFeatures._fields}
    fields.update(valid=np.ones(n, bool), unschedulable=np.zeros(n, bool),
                  allocatable=alloc, free=free)
    got = _sample_proxy(to_torch(JNodeFeatures(**fields), "cpu"),
                        prng.PRNGKey(seed)).numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))

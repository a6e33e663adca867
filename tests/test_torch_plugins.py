"""The port's copied encoder and cache produce the JAX package's arrays,
and each ported plugin's filter / score / normalize is bitwise the JAX
plugin's on the same numpy leaves."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minisched_tpu.encode import NodeFeatureCache as JCache
from minisched_tpu.encode import encode_pods as jencode
from minisched_tpu.ops.pipeline import max_normalize_100 as jnormalize
from minisched_tpu.service.defaultconfig import make_plugin as jmake
from minisched_tpu.state import objects as JO
from minisched_tpu_torch.encode import NodeFeatureCache, encode_pods, to_torch
from minisched_tpu_torch.ops.pipeline import max_normalize_100
from minisched_tpu_torch.service.defaultconfig import make_plugin
from minisched_tpu_torch.state import objects as TO
from torch_parity import (bits_equal, build_cache, leaves, mixed_cluster,
                          ports_cluster)

PLUGINS = [
    ("NodeUnschedulable", {}),
    ("NodeNumber", {}),
    ("NodeResourcesFit", {}),
    ("NodeResourcesFit", {"score_strategy": "MostAllocated"}),
    ("NodeResourcesLeastAllocated", {}),
    ("NodeResourcesMostAllocated", {}),
    ("NodeResourcesBalancedAllocation", {}),
    ("NodeResourcesBalancedAllocation",
     {"resources": ("cpu", "memory", "pods")}),
]


def _both(seed, n_nodes=96, n_pods=40, p_pad=48, n_pad=128,
          recipe=None):
    """One cluster built in both packages: (jax leaves, port leaves)."""
    out = []
    for O, cache_cls, enc in ((JO, JCache, jencode),
                              (TO, NodeFeatureCache, encode_pods)):
        if recipe is None:
            nodes, pods, bound = mixed_cluster(O, n_nodes, n_pods, seed)
        else:
            nodes, pods, bound = recipe(O, seed)
        cache = build_cache(cache_cls, nodes, bound)
        nf, names, _sv, _incs = cache.snapshot_versioned(pad=n_pad)
        af = cache.snapshot_assigned(pad=64)
        eb = enc(pods, p_pad, cfg=cache.cfg, registry=cache.registry,
                 gang_bound_fn=cache.gang_bound_count)
        out.append((eb, nf, af, names))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_copied_encoder_and_cache_match_jax(seed):
    (jeb, jnf, jaf, jnames), (teb, tnf, taf, tnames) = _both(seed)
    assert jnames == tnames
    for a, b in ((jeb, teb), (jnf, tnf), (jaf, taf)):
        la, lb = leaves(a), leaves(b, like=a)
        assert len(la) == len(lb)
        for x, y in zip(la, lb):
            assert bits_equal(x, y)


@pytest.mark.parametrize("name,args", PLUGINS)
@pytest.mark.parametrize("seed", [0, 3])
def test_plugin_matches_jax(name, args, seed):
    (jeb, jnf, jaf, _), _ = _both(seed)
    jp, tp = jmake(name, **args), make_plugin(name, **args)
    assert (jp.is_filter, jp.is_score, jp.is_permit) == (
        tp.is_filter, tp.is_score, tp.is_permit)
    eb, nf, af = (to_torch(x, "cpu") for x in (jeb, jnf, jaf))
    ctx_t = {"af": af, "gf": eb.gf, "naf": eb.naf}
    ctx_j = {"af": jaf, "gf": jeb.gf, "naf": jeb.naf}
    feasible = np.asarray(jeb.pf.valid)[:, None] & np.asarray(
        jnf.valid)[None, :]
    if tp.is_filter:
        want = np.asarray(jp.filter(jeb.pf, jnf, ctx_j))
        got = tp.filter(eb.pf, nf, ctx_t).numpy()
        assert bits_equal(want, got)
        assert 0 < got.sum() < got.size or name == "NodeUnschedulable"
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


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_nodeports_matches_jax(seed):
    """Bound and pending pods hold host ports from a small pool: the
    filter rejects some pairs and agrees with the JAX plugin bitwise."""
    (jeb, jnf, _jaf, _), (teb, tnf, _taf, _) = _both(seed,
                                                      recipe=ports_cluster)
    assert int(np.asarray(jnf.used_ports).astype(bool).sum()) > 0
    want = np.asarray(jmake("NodePorts").filter(jeb.pf, jnf, {}))
    eb, nf = to_torch(teb, "cpu"), to_torch(tnf, "cpu")
    got = make_plugin("NodePorts").filter(eb.pf, nf, {}).numpy()
    assert bits_equal(want, got)
    assert 0 < got.sum() < got.size


def test_nodenumber_permit_matches_jax():
    jp, tp = jmake("NodeNumber"), make_plugin("NodeNumber")
    pod = TO.Pod(metadata=TO.ObjectMeta(name="pod1"))
    for node in ("node0", "node10", "node3", "n9", "nodeX"):
        assert tp.permit(pod, node) == jp.permit(pod, node)


@pytest.mark.parametrize("seed", [0, 1])
def test_max_normalize_100_matches_jax(seed):
    rng = np.random.default_rng(seed)
    s = (rng.random((32, 200)) * rng.choice([0, 1, 37.5], (32, 1))
         ).astype(np.float32)
    feas = rng.random((32, 200)) < 0.7
    want = np.asarray(jnormalize(jnp.asarray(s), jnp.asarray(feas)))
    got = max_normalize_100(torch.from_numpy(s), torch.from_numpy(feas))
    assert bits_equal(want, got.numpy())


def test_sqrt_f32_is_correctly_rounded():
    """BalancedAllocation's square root equals numpy's correctly rounded
    float32 sqrt on random floats in [0, 4) (the range of its variance
    and beyond) and on the edges: zeros, subnormals, the smallest and
    largest normal values, the largest finite value and infinity."""
    from minisched_tpu_torch.plugins.noderesources import sqrt_f32

    rng = np.random.default_rng(0)
    x = (rng.random(1 << 20, dtype=np.float32) * 4).astype(np.float32)
    tiny = np.finfo(np.float32).tiny
    edges = np.array([0.0, -0.0, tiny, np.float32(tiny) / 2,
                      np.float32(1.4e-45), np.finfo(np.float32).max,
                      1.0, 2.0, 0.25, np.inf], dtype=np.float32)
    sub = rng.integers(1, 1 << 23, 4096).astype(np.int32).view(np.float32)
    for a in (x, edges, sub):
        got = sqrt_f32(torch.from_numpy(a)).numpy()
        assert got.dtype == np.float32
        assert np.array_equal(got.view(np.int32), np.sqrt(a).view(np.int32))

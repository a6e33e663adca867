"""The shortlist-compressed assignment of the port against the JAX
package, bitwise (tolerance 0: a one-ulp difference moves a tie-break):
shortlist_select's candidates and bound, the plain shortlist scan on
every output, and build_step(shortlist=K) on every Decision field."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _semantics_inputs
from minisched_tpu.encode import NodeFeatureCache as JCache
from minisched_tpu.encode import encode_pods as jencode
from minisched_tpu.ops.pipeline import build_step as jbuild
from minisched_tpu.ops.select import greedy_assign as jgreedy
from minisched_tpu.ops.select import greedy_assign_shortlist as jshortlist
from minisched_tpu.ops.select import seed_from_key
from minisched_tpu.ops.select import shortlist_select as jselect
from minisched_tpu.service.defaultconfig import Profile as JProfile
from minisched_tpu.state import objects as JO
from minisched_tpu_torch.encode import to_torch
from minisched_tpu_torch.ops import prng
from minisched_tpu_torch.ops import select as S
from minisched_tpu_torch.ops.pipeline import build_step
from minisched_tpu_torch.service.defaultconfig import Profile
from torch_parity import (BENCH_PROFILE, LIVE_PROFILE, NEG, SHORTLIST_CASES,
                          bits_equal, build_cache, mixed_cluster,
                          shortlist_case)


def _keys(seed, counter):
    return (jax.random.fold_in(jax.random.PRNGKey(seed), counter),
            prng.bits(prng.fold_in(prng.PRNGKey(seed), counter)))


def _select_rows(kind, rng, P=12, N=300):
    s = (rng.integers(0, 6, (P, N)) * 20.0).astype(np.float32)
    if kind == "plateau":  # every node ties: only the noise orders them
        s[:] = 100.0
    elif kind == "exact-tie":  # K-th value shared far past K
        s[:, ::2] = 60.0
        s[:, 1::2] = 40.0
    elif kind == "neg":
        s[rng.random((P, N)) < 0.6] = NEG
        s[3] = NEG
    elif kind == "signed-zero":  # lax.top_k orders +0.0 above -0.0
        s[:] = np.where(rng.random((P, N)) < 0.5, 0.0, -0.0)
        for row in s:
            row[rng.choice(N, 3, replace=False)] = 5.0
    return s


@pytest.mark.parametrize("kind", ["random", "plateau", "exact-tie", "neg",
                                  "signed-zero"])
@pytest.mark.parametrize("k", [1, 7, 128, 300])
def test_shortlist_select_matches_jax(kind, k):
    """cand (column for column, in lax.top_k's order), kth and
    kth_noise."""
    scores = _select_rows(kind, np.random.default_rng(k))
    jkey, seed = _keys(k, 3)
    want = jselect(jnp.asarray(scores), seed_from_key(jkey), k)
    got = S.shortlist_select(torch.from_numpy(scores), seed, k)
    for w, g, name in zip(want, got, ("cand", "kth", "kth_noise")):
        assert bits_equal(np.asarray(w), g.numpy()), name


@pytest.mark.parametrize("name,P,N,R,seed,k,kw", SHORTLIST_CASES,
                         ids=[c[0] for c in SHORTLIST_CASES])
def test_shortlist_scan_matches_jax(name, P, N, R, seed, k, kw):
    """The plain shortlist scan against JAX greedy_assign_shortlist on
    all four outputs, and against the full scan on the three it shares."""
    scores, req, free = shortlist_case(P, N, R, seed, **kw)
    jkey, tseed = _keys(seed, k)
    want = jshortlist(scores, req, free, jkey, k=k)
    got = S.greedy_assign_shortlist(
        *(torch.from_numpy(a) for a in (scores, req, free)), tseed, k=k)
    for f in ("chosen", "assigned", "free_after", "repaired"):
        assert bits_equal(np.asarray(getattr(want, f)),
                          getattr(got, f).numpy()), f
    full = jgreedy(scores, req, free, jkey)
    for f in ("chosen", "assigned", "free_after"):
        assert bits_equal(np.asarray(getattr(full, f)),
                          getattr(got, f).numpy()), f
    repaired = got.repaired.numpy()
    if name == "plateau":
        assert not repaired.any()
    if name == "contention" or (name.startswith("width") and k == 1):
        assert repaired.sum() > 0
    if name == "all-neg-rows":
        assert not got.assigned.numpy()[list(kw["neg_rows"])].any()


def _check_step(profile, eb, nf, af, seed, counter, k):
    jstep = jbuild(JProfile(**profile).build(), pallas=False, shortlist=k)
    want = jstep(eb, nf, af,
                 jax.random.fold_in(jax.random.PRNGKey(seed), counter))
    step = build_step(Profile(**profile).build(), shortlist=k)
    got = step(*(to_torch(x, "cpu") for x in (eb, nf, af)),
               prng.fold_in(prng.PRNGKey(seed), counter))
    for f in got._fields:
        assert bits_equal(np.asarray(getattr(want, f)),
                          getattr(got, f).numpy()), f
    return got


PROFILES = {"bench": BENCH_PROFILE, "live": LIVE_PROFILE}


@pytest.mark.parametrize("profile", sorted(PROFILES))
@pytest.mark.parametrize("k", [1, 4, 128])
@pytest.mark.parametrize("seed", [0, 2])
def test_step_shortlist_matches_jax(profile, k, seed):
    """build_step(shortlist=K): every Decision field, shortlist_repaired
    included, on a tight mixed cluster with gangs and pre-bound pods."""
    nodes, pods, bound = mixed_cluster(JO, 100, 40, seed)
    cache = build_cache(JCache, nodes, bound)
    nf, _names, _sv, _incs = cache.snapshot_versioned(pad=112)
    eb = jencode(pods, 48, cfg=cache.cfg, registry=cache.registry,
                 gang_bound_fn=cache.gang_bound_count)
    d = _check_step(PROFILES[profile], eb, nf,
                    cache.snapshot_assigned(pad=64), seed, 7, k)
    assert d.assigned.any()
    if k == 1:
        assert d.shortlist_repaired.any()


@pytest.mark.parametrize("k", [1, 2, 16])
def test_step_shortlist_gang_case_matches_jax(k):
    """__graft_entry__'s hard-semantics batch: gangs evicted and
    readmitted around the shortlist scan; the repair ledger is the kept
    attempt's."""
    eb, nf, af, _names = _semantics_inputs()
    d = _check_step(BENCH_PROFILE, eb, nf, af, 0, 3, k)
    assert d.gang_rejected.any()


def test_step_without_shortlist_has_no_repairs():
    eb, nf, af, _names = _semantics_inputs()
    step = build_step(Profile(**BENCH_PROFILE).build(), shortlist=None)
    d = step(*(to_torch(x, "cpu") for x in (eb, nf, af)),
             prng.fold_in(prng.PRNGKey(0), 3))
    assert not d.shortlist_repaired.any()
    assert d.shortlist_repaired.shape == d.assigned.shape

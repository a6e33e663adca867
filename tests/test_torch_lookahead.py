"""A numpy model of the CUDA greedy kernel's schedule, held bitwise
against the plain greedy assignment and the JAX scan.

csrc/greedy_assign.cu splits the node columns into contiguous slices, one
per block. While pod i is being exchanged, every block reduces its slice
for pod i+1 against the free rows as they stand before pod i's debit (the
look-ahead), and afterwards only the block owning pod i's winner fixes its
pending best: it rescans when its pending best is the winner's column and
that column no longer fits, joins the winner's column when it still (or
newly) fits, and keeps its pending best otherwise. The kernel is exact
only if that rule is; this file checks the rule on the CPU, with the same
slices, pending triples and fix-up as the kernel.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from minisched_tpu.ops.select import greedy_assign as jgreedy
from minisched_tpu_torch.ops import prng
from minisched_tpu_torch.ops import select as S
from torch_parity import NEG, bits_equal, greedy_case, scarce_case

NEG32 = float(np.float32(NEG))
EMPTY = (-np.inf, -1.0, -(2 ** 31))  # (score, noise, -column): loses to any column


def _slice_best(s_row, n_row, free, req, lo, hi):
    """The best fitting column of [lo, hi) as (score, noise, -column)."""
    cols = lo + np.nonzero((free[lo:hi] >= req).all(axis=1))[0]
    if cols.size == 0:
        return EMPTY
    sc = s_row[cols]
    cand = cols[sc == sc.max()]
    nz = n_row[cand]
    col = int(cand[nz == nz.max()].min())
    return float(s_row[col]), float(n_row[col]), -col


def lookahead_model(s, req, free0, noise, nblocks):
    """The kernel's schedule. Returns (chosen, assigned, free_after,
    counts of the fix-up's three cases)."""
    P, N = s.shape
    width = -(-N // nblocks)
    bounds = [(min(b * width, N), min(b * width + width, N))
              for b in range(nblocks)]
    free = free0.copy()
    chosen = np.full(P, -1, np.int32)
    assigned = np.zeros(P, bool)
    cases = {"rescan": 0, "join": 0, "stand": 0}

    def best(i, b):
        return _slice_best(s[i], noise[i], free, req[i], *bounds[b])

    pend = [best(0, b) for b in range(nblocks)] if P else []
    for i in range(P):
        win = max(pend)
        nxt = [best(i + 1, b) for b in range(nblocks)] if i + 1 < P else []
        if win[0] > NEG32:
            col = -win[2]
            chosen[i], assigned[i] = col, True
            free[col] = free[col] - req[i]  # one float32 subtraction per axis
            if nxt:
                b = col // width
                fits = bool((free[col] >= req[i + 1]).all())
                if nxt[b][2] == -col and not fits:
                    nxt[b] = best(i + 1, b)
                    cases["rescan"] += 1
                elif fits:
                    nxt[b] = max(nxt[b], (float(s[i + 1, col]),
                                          float(noise[i + 1, col]), -col))
                    cases["join"] += 1
                else:
                    cases["stand"] += 1
        pend = nxt
    return chosen, assigned, free, cases


def sequential(s, req, free0, noise):
    """The greedy assignment itself, one pod at a time over all columns."""
    P, N = s.shape
    free = free0.copy()
    chosen = np.full(P, -1, np.int32)
    for i in range(P):
        win = _slice_best(s[i], noise[i], free, req[i], 0, N)
        if win[0] > NEG32:
            chosen[i] = -win[2]
            free[-win[2]] = free[-win[2]] - req[i]
    return chosen, chosen >= 0, free


def noise_matrix(seed, P, N):
    rows = torch.arange(P, dtype=torch.int64)[:, None]
    cols = torch.arange(N, dtype=torch.int64)[None, :]
    return S.tie_noise_from_cols(seed, rows, cols).numpy()


def case(kind, rng):
    if kind == "ties":
        return greedy_case(rng, 48, 256)
    if kind == "scarce":
        return scarce_case(rng, 128, 300, R=4)
    if kind == "off-tile":
        return greedy_case(rng, 13, 200)
    if kind == "negative-request":
        s, req, free = greedy_case(rng, 64, 257, cpu_free=300.0)
        req[3, 1] = -2.0
        req[7, 0] = -250.0
        return s, req, free
    if kind == "all-neg-rows":
        s, req, free = greedy_case(rng, 32, 129)
        s[[0, 5, 31]] = NEG
        return s, req, free
    if kind == "signed-zero-ties":  # scores 0 or 1, half the zeros -0.0
        s, req, free = greedy_case(rng, 64, 300, quant=1, infeasible=0.0)
        s[(s == 0) & (rng.random(s.shape) < 0.5)] = -0.0
        return s, req, free
    raise ValueError(kind)


KINDS = ["ties", "scarce", "off-tile", "negative-request", "all-neg-rows",
         "signed-zero-ties"]


def _run(kind, nblocks, seed):
    rng = np.random.default_rng(1000 * seed + sum(map(ord, kind)))
    s, req, free = case(kind, rng)
    seed_u32 = prng.bits(prng.fold_in(prng.PRNGKey(seed), len(kind)))
    model = lookahead_model(s, req, free, noise_matrix(seed_u32, *s.shape),
                            nblocks)
    return (s, req, free), seed_u32, model


@pytest.mark.parametrize("nblocks", [1, 3, 7, 16])
@pytest.mark.parametrize("kind", KINDS)
def test_lookahead_matches_plain(kind, nblocks):
    args, seed_u32, model = _run(kind, nblocks, seed=0)
    plain = S.greedy_assign_plain(*(torch.from_numpy(a) for a in args),
                                  seed_u32)
    for got, want in zip(model[:3], plain):
        assert bits_equal(got, want.numpy())


@pytest.mark.parametrize("kind", KINDS)
def test_lookahead_matches_jax_scan(kind):
    seed = 1
    args, _, model = _run(kind, 5, seed)
    key = jax.random.fold_in(jax.random.PRNGKey(seed), len(kind))
    ref = jgreedy(*(jnp.asarray(a) for a in args), key)
    for got, field in zip(model[:3], ("chosen", "assigned", "free_after")):
        assert bits_equal(got, np.asarray(getattr(ref, field))), field


def test_scarce_case_takes_every_fixup_branch():
    """Where each node fits one pod and consecutive pods want the same
    node, the owner's pending best is often pod i's winner, which no
    longer fits: the rescan branch runs, besides the other two."""
    *_, cases = _run("scarce", 10, seed=0)[2]
    assert cases["rescan"] > 10
    _, _, (*_, neg_cases) = _run("negative-request", 4, seed=0)
    assert neg_cases["join"] > 0 and neg_cases["stand"] > 0


@pytest.mark.parametrize("nblocks", [2, 4, 9])
def test_forced_noise_collisions_break_on_the_column(nblocks):
    """Noise drawn from four values, scores from two: many fitting
    columns tie on score and noise, across slices, so the smallest column
    decides. Held against the one-pod-at-a-time assignment."""
    rng = np.random.default_rng(nblocks)
    s, req, free = greedy_case(rng, 40, 90, quant=1, infeasible=0.1)
    noise = (rng.integers(0, 4, s.shape) / 4).astype(np.float32)
    model = lookahead_model(s, req, free, noise, nblocks)
    want = sequential(s, req, free, noise)
    for got, ref in zip(model[:3], want):
        assert bits_equal(got, ref)
    assert model[1].sum() > 20


@settings(max_examples=40, deadline=None)
@given(P=st.integers(1, 30), N=st.integers(1, 120), R=st.integers(1, 4),
       nblocks=st.integers(1, 12), quant=st.sampled_from([1, 2, 4]),
       cpu_free=st.sampled_from([150.0, 300.0, 500.0]),
       negative=st.booleans(), seed=st.integers(0, 2 ** 32 - 1),
       data_seed=st.integers(0, 2 ** 16))
def test_lookahead_matches_plain_hypothesis(P, N, R, nblocks, quant,
                                            cpu_free, negative, seed,
                                            data_seed):
    rng = np.random.default_rng(data_seed)
    s, req, free = greedy_case(rng, P, N, R=R, quant=quant,
                               cpu_free=cpu_free)
    if negative:
        req[rng.integers(0, P), rng.integers(0, R)] *= -1.0
    model = lookahead_model(s, req, free, noise_matrix(seed, P, N),
                            min(nblocks, N))
    plain = S.greedy_assign_plain(torch.from_numpy(s), torch.from_numpy(req),
                                  torch.from_numpy(free), seed)
    for got, want in zip(model[:3], plain):
        assert bits_equal(got, want.numpy())


@settings(max_examples=40, deadline=None)
@given(P=st.integers(1, 30), N=st.integers(1, 80), nblocks=st.integers(1, 9),
       levels=st.integers(1, 3), data_seed=st.integers(0, 2 ** 16))
def test_forced_collisions_hypothesis(P, N, nblocks, levels, data_seed):
    rng = np.random.default_rng(data_seed)
    s, req, free = greedy_case(rng, P, N, quant=1, infeasible=0.2,
                               cpu_free=300.0)
    noise = (rng.integers(0, levels, s.shape) / 4).astype(np.float32)
    model = lookahead_model(s, req, free, noise, min(nblocks, N))
    for got, ref in zip(model[:3], sequential(s, req, free, noise)):
        assert bits_equal(got, ref)

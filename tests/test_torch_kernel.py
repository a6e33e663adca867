"""The CUDA kernels (greedy assignment, shortlist scan, port insertion)
against their plain PyTorch versions.

This file imports neither jax nor minisched_tpu, so it also runs on a
machine that has only the port's dependencies. The card tests skip
without a CUDA device; on the card:

    python -m pytest --noconftest -m card tests/test_torch_kernel.py
"""
import numpy as np
import pytest
import torch

from minisched_tpu_torch.ops import prng
from minisched_tpu_torch.ops import residency as RES
from minisched_tpu_torch.ops import select as S
from minisched_tpu_torch.ops._cuda_build import LAUNCHES
from minisched_tpu_torch.ops.greedy_kernel import greedy_assign_cuda
from minisched_tpu_torch.ops.ports_kernel import insert_ports_cuda
from minisched_tpu_torch.ops.shortlist_kernel import shortlist_scan_cuda
from torch_parity import (GREEDY_SHAPES, NEG, SHORTLIST_CASES, bits_equal,
                          greedy_case, ports_case, scarce_case,
                          shortlist_case)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")


def test_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        greedy_assign_cuda(torch.zeros((2, 3)), torch.zeros((2, 4)),
                           torch.zeros((3, 4)), 0)
    with pytest.raises(ValueError, match="CUDA"):
        shortlist_scan_cuda(torch.zeros((2, 3)),
                            torch.zeros((2, 1), dtype=torch.int32),
                            torch.zeros(2), torch.zeros(2),
                            torch.zeros((2, 4)), torch.zeros((3, 4)), 0)
    with pytest.raises(ValueError, match="CUDA"):
        insert_ports_cuda(*(torch.zeros(shape, dtype=torch.int32)
                            for shape in ((3, 8), (2,), (2, 4))))


def test_shortlist_and_ports_on_cpu_take_the_plain_versions():
    rng = np.random.default_rng(1)
    args = [torch.from_numpy(a) for a in shortlist_case(32, 100, 3, 1)]
    n0 = dict(LAUNCHES)
    got = S.greedy_assign_shortlist(*args, 77, k=4)
    cand, kth, kthn = S.shortlist_select(args[0], 77, 4)
    want = S.greedy_assign_shortlist_plain(*args, 77, cand, kth, kthn)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    state, rows, ports = ports_case(rng)
    assert torch.equal(RES.insert_ports(torch.from_numpy(state), rows, ports),
                       RES.insert_ports_plain(*(torch.from_numpy(a) for a in
                                                (state, rows, ports))))
    assert LAUNCHES == n0


def test_dispatch_on_cpu_is_the_plain_version():
    rng = np.random.default_rng(0)
    args = [torch.from_numpy(a) for a in greedy_case(rng, 16, 128)]
    n0 = LAUNCHES["greedy_assign"]
    got = S.greedy_assign(*args, 12345)
    want = S.greedy_assign_plain(*args, 12345)
    assert LAUNCHES["greedy_assign"] == n0
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.card
@pytest.mark.parametrize("P,N,cpu_free", GREEDY_SHAPES)
def test_kernel_matches_plain_on_card(P, N, cpu_free):
    _need_card()
    rng = np.random.default_rng(P * 7 + N)
    args = [torch.from_numpy(a)
            for a in greedy_case(rng, P, N, cpu_free=cpu_free)]
    seed = prng.bits(prng.fold_in(prng.PRNGKey(3), P))
    plain = S.greedy_assign_plain(*args, seed)
    n0 = LAUNCHES["greedy_assign"]
    got = S.greedy_assign(*(a.cuda() for a in args), seed)
    torch.cuda.synchronize()
    assert LAUNCHES["greedy_assign"] == n0 + 1
    assert got.chosen.is_cuda
    for field in ("chosen", "assigned", "free_after"):
        assert bits_equal(getattr(plain, field).numpy(),
                          getattr(got, field).cpu().numpy()), field


def _multiblock_case(kind, rng):
    """Cases that run up to 132 blocks of the kernel (one per SM of an
    H100), with uneven or empty column slices."""
    if kind == "wide":
        return greedy_case(rng, 512, 20000, R=10)
    if kind == "uneven":  # slices of 65 columns: the last two blocks are empty
        return greedy_case(rng, 256, 8449, R=10)
    if kind == "scarce":  # the owner's look-ahead often has to rescan
        return scarce_case(rng, 1024, 9000)
    if kind == "ties":  # scores 0 or 1: many equal scores across blocks
        return greedy_case(rng, 512, 16384, R=10, quant=1, infeasible=0.0)
    if kind == "all-neg-row":
        s, req, free = greedy_case(rng, 64, 5000, R=10)
        s[[0, 7, 63]] = NEG
        return s, req, free
    if kind == "negative-request":
        s, req, free = greedy_case(rng, 128, 5000, R=10, cpu_free=300.0)
        req[5, 2] = -3.0
        req[9, 0] = -250.0
        return s, req, free
    if kind == "empty-batch":
        s, req, free = greedy_case(rng, 1, 5000, R=10)
        return s[:0], req[:0], free
    if kind == "max-r":
        return greedy_case(rng, 96, 20000, R=32)
    if kind == "no-ring":  # the free slices leave no room for the score ring
        return greedy_case(rng, 64, 500000, R=10)
    raise ValueError(kind)


@pytest.mark.card
@pytest.mark.parametrize("kind", ["wide", "uneven", "scarce", "ties",
                                  "all-neg-row", "negative-request",
                                  "empty-batch", "max-r", "no-ring"])
def test_kernel_matches_plain_on_card_multiblock(kind):
    _need_card()
    rng = np.random.default_rng(sum(map(ord, kind)))
    args = [torch.from_numpy(a) for a in _multiblock_case(kind, rng)]
    seed = prng.bits(prng.fold_in(prng.PRNGKey(5), len(kind)))
    plain = S.greedy_assign_plain(*args, seed)
    n0 = LAUNCHES["greedy_assign"]
    got = greedy_assign_cuda(*(a.cuda() for a in args), seed)
    torch.cuda.synchronize()
    # An empty batch only copies free0: no launch, so no count.
    assert LAUNCHES["greedy_assign"] == n0 + (kind != "empty-batch")
    for field in ("chosen", "assigned", "free_after"):
        assert bits_equal(getattr(plain, field).numpy(),
                          getattr(got, field).cpu().numpy()), field
    if kind not in ("empty-batch", "all-neg-row"):
        assert int(plain.assigned.sum()) > 0
    if kind == "all-neg-row":
        assert not plain.assigned[[0, 7, 63]].any()


@pytest.mark.card
def test_kernel_rejects_bad_inputs_on_card():
    _need_card()
    s, req, free = (torch.zeros(shape, device="cuda")
                    for shape in ((4, 8), (4, 3), (8, 3)))
    with pytest.raises(ValueError, match="float32"):
        greedy_assign_cuda(s, req, free.double(), 0)
    with pytest.raises(ValueError, match="shape"):
        greedy_assign_cuda(s, req[:3], free, 0)


def _scan_on_card(scores, req, free, seed, k):
    """The shortlist scan kernel and its plain version on one input."""
    args = [torch.from_numpy(a) for a in (scores, req, free)]
    k = min(max(k, 1), scores.shape[1])
    cand, kth, kthn = S.shortlist_select(args[0], seed, k)
    plain = S.greedy_assign_shortlist_plain(*args, seed, cand, kth, kthn)
    n0 = LAUNCHES["shortlist_scan"]
    dev = [a.cuda() for a in args]
    got = S.greedy_assign_shortlist(*dev, seed, k=k)
    torch.cuda.synchronize()
    # An empty batch only copies free0: no launch, so no count.
    assert LAUNCHES["shortlist_scan"] == n0 + (scores.shape[0] > 0)
    for field in ("chosen", "assigned", "free_after", "repaired"):
        assert bits_equal(getattr(plain, field).numpy(),
                          getattr(got, field).cpu().numpy()), field
    # The selection on the card equals the selection on the CPU.
    for a, b in zip(S.shortlist_select(dev[0], seed, k), (cand, kth, kthn)):
        assert bits_equal(a.cpu().numpy(), b.numpy())
    return plain


@pytest.mark.card
@pytest.mark.parametrize("name,P,N,R,seed,k,kw", SHORTLIST_CASES,
                         ids=[c[0] for c in SHORTLIST_CASES])
def test_shortlist_scan_matches_plain_on_card(name, P, N, R, seed, k, kw):
    _need_card()
    plain = _scan_on_card(*shortlist_case(P, N, R, seed, **kw),
                          prng.bits(prng.fold_in(prng.PRNGKey(seed), k)), k)
    if name == "contention":
        assert int(plain.repaired.sum()) > 0


@pytest.mark.card
@pytest.mark.parametrize("kind", ["contention-wide", "k1", "k-equals-n",
                                  "max-r", "scarce", "empty-batch"])
def test_shortlist_scan_edge_cases_on_card(kind):
    _need_card()
    rng = np.random.default_rng(sum(map(ord, kind)))
    seed = prng.bits(prng.fold_in(prng.PRNGKey(11), len(kind)))
    if kind == "contention-wide":  # repairs over a row wider than the block
        case, k = shortlist_case(256, 20000, 10, 5, contend=True), 16
    elif kind == "k1":  # every live pod repairs
        case, k = shortlist_case(64, 3000, 4, 6), 1
    elif kind == "k-equals-n":  # the shortlist is the row
        case, k = shortlist_case(64, 700, 4, 7), 700
    elif kind == "max-r":
        case, k = greedy_case(rng, 96, 5000, R=32), 128
    elif kind == "scarce":
        case, k = scarce_case(rng, 512, 4000), 32
    else:
        s, req, free = greedy_case(rng, 1, 500, R=10)
        case, k = (s[:0], req[:0], free), 16
    plain = _scan_on_card(*case, seed, k)
    if kind in ("contention-wide", "k1"):
        assert int(plain.repaired.sum()) > 0


@pytest.mark.card
@pytest.mark.parametrize("seed,P", [(0, 200), (1, 200), (2, 0)],
                         ids=["0", "1", "empty"])
def test_insert_ports_matches_plain_on_card(seed, P):
    _need_card()
    state, rows, ports = ports_case(np.random.default_rng(seed), N=300,
                                    PORT=40, P=max(P, 1), PP=6)
    rows, ports = rows[:P], ports[:P]
    want = RES.insert_ports_plain(*(torch.from_numpy(a)
                                    for a in (state, rows, ports)))
    n0 = LAUNCHES["insert_ports"]
    got = RES.insert_ports(torch.from_numpy(state).cuda(), rows, ports)
    torch.cuda.synchronize()
    # With no pods the launcher only copies the state: no count.
    assert LAUNCHES["insert_ports"] == n0 + (P > 0)
    assert bits_equal(want.numpy(), got.cpu().numpy())
    mirror = state.copy()
    RES.replay_ports_host(mirror, rows, ports)
    assert bits_equal(mirror, got.cpu().numpy())

"""The CUDA greedy-assignment kernel against its plain PyTorch version.

This file imports neither jax nor minisched_tpu, so it also runs on a
machine that has only the port's dependencies. The card tests skip
without a CUDA device; on the card:

    python -m pytest --noconftest -m card tests/test_torch_kernel.py
"""
import numpy as np
import pytest
import torch

from minisched_tpu_torch.ops import prng
from minisched_tpu_torch.ops import select as S
from minisched_tpu_torch.ops.greedy_kernel import LAUNCHES, greedy_assign_cuda
from torch_parity import (GREEDY_SHAPES, NEG, bits_equal, greedy_case,
                          scarce_case)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")


def test_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        greedy_assign_cuda(torch.zeros((2, 3)), torch.zeros((2, 4)),
                           torch.zeros((3, 4)), 0)


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
    assert LAUNCHES["greedy_assign"] == n0 + 1
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

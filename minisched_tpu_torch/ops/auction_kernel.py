"""Launch the CUDA auction kernels (csrc/auction.cu, the dense rounds;
csrc/bid_auction.cu, the rounds over bid shortlists).

Each kernel is built at first use by ops/_cuda_build.py (nvcc, sm_90a,
ctypes) and runs the whole banded loop in one launch, with no read on
the host per round. ``auction_cuda`` and ``bid_auction_cuda`` are their
wrappers: they check their inputs, allocate the outputs and the scratch,
launch on PyTorch's current stream and count the launch in
``_cuda_build.LAUNCHES["auction"]`` / ``["bid_auction"]``. They never
fall back to the plain versions (auction.auction_assign_plain,
bid_select.auction_assign_shortlist_plain).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ._cuda_build import check_launch, load
from .auction import EPS, HALF_EPS, max_rounds_for, priorities
from .select import AssignResult, ShortlistAssignResult

_MAX_R = 32
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def _bind_auction(lib: ctypes.CDLL) -> None:
    lib.auction_scratch_bytes.restype = ctypes.c_longlong
    lib.auction_scratch_bytes.argtypes = [_I, _I]
    fn = lib.auction_launch
    fn.restype = _I
    fn.argtypes = ([_P] * 4 + [ctypes.c_uint32, _F, _F] + [_I] * 4
                   + [_P] * 6)


def _bind_bid(lib: ctypes.CDLL) -> None:
    lib.bid_auction_scratch_bytes.restype = ctypes.c_longlong
    lib.bid_auction_scratch_bytes.argtypes = [_I, _I, _I]
    fn = lib.bid_auction_launch
    fn.restype = _I
    fn.argtypes = ([_P] * 4 + [ctypes.c_uint32, _F, _F] + [_I] * 5
                   + [_P] * 7)


def _inputs(name, scores, requests, free0, priority):
    """Checked, contiguous (scores, requests, free0, priority)."""
    if scores.device.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {scores.device}")
    if scores.dim() != 2 or requests.dim() != 2 or free0.dim() != 2:
        raise ValueError("scores, requests and free0 must be 2-D")
    dev = scores.device
    P, N = scores.shape
    R = requests.shape[1]
    if N < 1 or not 1 <= R <= _MAX_R:
        raise ValueError(f"need N >= 1 and 1 <= R <= {_MAX_R}, got N={N} "
                         f"R={R}")
    prio = priorities(priority, P, dev)
    out = []
    for what, t, dtype, shape in (("scores", scores, torch.float32, (P, N)),
                                  ("requests", requests, torch.float32,
                                   (P, R)),
                                  ("free0", free0, torch.float32, (N, R)),
                                  ("priority", prio, torch.int32, (P,))):
        if t.device != dev:
            raise ValueError(f"{what} is on {t.device}, scores on {dev}")
        if t.dtype != dtype:
            raise ValueError(f"{what} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{what} has shape {tuple(t.shape)}, expected "
                             f"{shape}")
        out.append(t.contiguous())
    return out


def _outputs(P, N, R, dev, rounds):
    chosen = torch.empty((P,), dtype=torch.int32, device=dev)
    assigned = torch.empty((P,), dtype=torch.bool, device=dev)
    free_after = torch.empty((N, R), dtype=torch.float32, device=dev)
    if rounds is None:
        rounds = torch.empty((1,), dtype=torch.int32, device=dev)
    elif (rounds.device != dev or rounds.dtype != torch.int32
          or rounds.numel() != 1):
        raise ValueError("rounds must be an int32 (1,) tensor on the "
                         "scores' device")
    return chosen, assigned, free_after, rounds


def auction_cuda(scores: torch.Tensor, requests: torch.Tensor,
                 free0: torch.Tensor, seed: int,
                 max_rounds: Optional[int] = None, priority=None,
                 rounds: Optional[torch.Tensor] = None) -> AssignResult:
    """The dense kernel's wrapper: auction.auction_assign_plain's
    contract on CUDA tensors, for any batch that device memory holds.
    ``rounds`` (int32 (1,), on the card) receives the rounds run."""
    scores, requests, free0, prio = _inputs("auction_cuda", scores,
                                            requests, free0, priority)
    dev = scores.device
    P, N = scores.shape
    R = requests.shape[1]
    budget = max_rounds_for(P) if max_rounds is None else int(max_rounds)
    lib = load("auction", _bind_auction)
    chosen, assigned, free_after, rounds = _outputs(P, N, R, dev, rounds)
    scratch = torch.empty((lib.auction_scratch_bytes(P, N),),
                          dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.auction_launch(
            scores.data_ptr(), requests.data_ptr(), free0.data_ptr(),
            prio.data_ptr(), int(seed) & 0xFFFFFFFF, EPS, HALF_EPS, budget,
            P, N, R, chosen.data_ptr(), assigned.data_ptr(),
            free_after.data_ptr(), rounds.data_ptr(), scratch.data_ptr(),
            stream)
    check_launch(lib, "auction", err, f"P={P} N={N} R={R}")
    return AssignResult(chosen, assigned, free_after)


def bid_auction_cuda(scores: torch.Tensor, requests: torch.Tensor,
                     free0: torch.Tensor, seed: int,
                     max_rounds: Optional[int] = None, priority=None,
                     k: int = 128, rounds: Optional[torch.Tensor] = None
                     ) -> ShortlistAssignResult:
    """The bid-shortlist kernel's wrapper:
    bid_select.auction_assign_shortlist_plain's contract on CUDA tensors
    (``k`` clamped to [1, N]; ``rounds`` as auction_cuda's)."""
    scores, requests, free0, prio = _inputs("bid_auction_cuda", scores,
                                            requests, free0, priority)
    dev = scores.device
    P, N = scores.shape
    R = requests.shape[1]
    K = min(max(int(k), 1), N)
    budget = max_rounds_for(P) if max_rounds is None else int(max_rounds)
    lib = load("bid_auction", _bind_bid)
    chosen, assigned, free_after, rounds = _outputs(P, N, R, dev, rounds)
    repaired = torch.empty((P,), dtype=torch.bool, device=dev)
    scratch = torch.empty((lib.bid_auction_scratch_bytes(P, N, K),),
                          dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.bid_auction_launch(
            scores.data_ptr(), requests.data_ptr(), free0.data_ptr(),
            prio.data_ptr(), int(seed) & 0xFFFFFFFF, EPS, HALF_EPS, budget,
            P, N, R, K, chosen.data_ptr(), assigned.data_ptr(),
            free_after.data_ptr(), repaired.data_ptr(), rounds.data_ptr(),
            scratch.data_ptr(), stream)
    check_launch(lib, "bid_auction", err, f"P={P} N={N} R={R} K={K}")
    return ShortlistAssignResult(chosen, assigned, free_after, repaired)


def bid_auction_layout(P: int, N: int) -> dict:
    """How the bid-shortlist kernel would lay out a P x N launch on the
    current card: whether each row's keys are cached in shared memory,
    whether each block's pods are kept there too (else in device
    memory), the dynamic shared memory a block takes and the blocks."""
    lib = load("bid_auction", _bind_bid)
    fn = lib.bid_auction_layout
    fn.restype = _I
    fn.argtypes = [_I, _I, _P]
    out = (ctypes.c_int * 4)()
    err = fn(int(P), int(N), ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"bid_auction layout failed: cudaError {err} "
                           f"at P={P} N={N}")
    return {"cache_keys": bool(out[0]), "shared_pods": bool(out[1]),
            "smem_bytes": int(out[2]), "blocks": int(out[3])}

"""Launch the CUDA shortlist selection kernel (csrc/shortlist_select.cu).

The kernel is built at first use by ops/_cuda_build.py (nvcc, sm_90a,
ctypes). ``shortlist_select_cuda`` (one batch) and
``shortlist_select_lanes_cuda`` (T batches of one shape in one launch,
the fused tenant step's lanes) are its wrappers: they check their inputs,
allocate the outputs, launch on PyTorch's current stream and count each
launch once in ``_cuda_build.LAUNCHES["shortlist_select"]``. They never
fall back to the plain version (select.shortlist_select_plain).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ._cuda_build import check_launch, load


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.shortlist_select_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint32]
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 5)


def _launch(scores: torch.Tensor, seeds: Optional[torch.Tensor], seed: int,
            k: int):
    """One launch over ``scores`` (T,P,N): ``seeds`` a (T,) int32 CUDA
    tensor of the lanes' u32 seeds, or None for T = 1 with ``seed``."""
    if scores.device.type != "cuda":
        raise ValueError(f"the selection kernel needs CUDA tensors, got "
                         f"{scores.device}")
    if scores.dim() != 3 or scores.dtype != torch.float32:
        raise ValueError(f"scores must be a (T,P,N) float32 tensor, got "
                         f"{scores.dtype} of shape {tuple(scores.shape)}")
    T, P, N = scores.shape
    k = int(k)
    if N < 1 or not 1 <= k <= N:
        raise ValueError(f"need N >= 1 and 1 <= k <= N, got N={N} k={k}")
    dev = scores.device
    if seeds is not None:
        if (seeds.device != dev or seeds.dtype != torch.int32
                or tuple(seeds.shape) != (T,)):
            raise ValueError(f"seeds must be a ({T},) int32 tensor on {dev}")
        seeds = seeds.contiguous()
    elif T != 1:
        raise ValueError("more than one lane needs a seeds tensor")
    scores = scores.contiguous()
    lib = load("shortlist_select", _bind)
    cand = torch.empty((T, P, k), dtype=torch.int32, device=dev)
    kth = torch.empty((T, P), dtype=torch.float32, device=dev)
    kth_noise = torch.empty((T, P), dtype=torch.float32, device=dev)
    cand_scores = torch.empty((T, P, k), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.shortlist_select_launch(
            scores.data_ptr(), None if seeds is None else seeds.data_ptr(),
            int(seed) & 0xFFFFFFFF, T, P, N, k, cand.data_ptr(),
            kth.data_ptr(), kth_noise.data_ptr(), cand_scores.data_ptr(),
            stream)
    check_launch(lib, "shortlist_select", err, f"T={T} P={P} N={N} K={k}")
    return cand, kth, kth_noise, cand_scores


def shortlist_select_cuda(scores: torch.Tensor, seed: int, k: int):
    """The kernel's wrapper: select.shortlist_select_plain's outputs
    ``(cand (P,K) int32, kth (P,) float32, kth_noise (P,) float32)``,
    bit for bit, plus ``cand_scores`` (P,K) float32, the candidates'
    scores, on CUDA tensors."""
    if scores.dim() != 2:
        raise ValueError(f"scores must be 2-D, got shape "
                         f"{tuple(scores.shape)}")
    return tuple(x[0] for x in _launch(scores[None], None, seed, k))


def shortlist_select_lanes_cuda(scores: torch.Tensor, seeds: torch.Tensor,
                                k: int):
    """The lane form: ``scores`` (T,P,N), ``seeds`` the lanes' u32 seeds
    as a (T,) int32 CUDA tensor; lane t's outputs equal
    ``shortlist_select_cuda(scores[t], seed_t, k)``'s, with a leading T
    axis. One launch, counted once."""
    return _launch(scores, seeds, 0, k)

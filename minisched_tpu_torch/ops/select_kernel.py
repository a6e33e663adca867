"""Launch the CUDA shortlist selection kernel (csrc/shortlist_select.cu).

The kernel is built at first use by ops/_cuda_build.py (nvcc, sm_90a,
ctypes). ``shortlist_select_cuda`` is its wrapper: it checks its inputs,
allocates the outputs, launches on PyTorch's current stream and counts
the launch in ``_cuda_build.LAUNCHES["shortlist_select"]``. It never
falls back to the plain version (select.shortlist_select_plain).
"""
from __future__ import annotations

import ctypes

import torch

from ._cuda_build import check_launch, load


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.shortlist_select_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_uint32] + [ctypes.c_int] * 3
                   + [ctypes.c_void_p] * 5)


def shortlist_select_cuda(scores: torch.Tensor, seed: int, k: int):
    """The kernel's wrapper: select.shortlist_select_plain's outputs
    ``(cand (P,K) int32, kth (P,) float32, kth_noise (P,) float32)``,
    bit for bit, plus ``cand_scores`` (P,K) float32, the candidates'
    scores, on CUDA tensors."""
    if scores.device.type != "cuda":
        raise ValueError(f"shortlist_select_cuda needs CUDA tensors, got "
                         f"{scores.device}")
    if scores.dim() != 2 or scores.dtype != torch.float32:
        raise ValueError(f"scores must be a 2-D float32 tensor, got "
                         f"{scores.dtype} of shape {tuple(scores.shape)}")
    P, N = scores.shape
    k = int(k)
    if N < 1 or not 1 <= k <= N:
        raise ValueError(f"need N >= 1 and 1 <= k <= N, got N={N} k={k}")
    scores = scores.contiguous()
    dev = scores.device
    lib = load("shortlist_select", _bind)
    cand = torch.empty((P, k), dtype=torch.int32, device=dev)
    kth = torch.empty((P,), dtype=torch.float32, device=dev)
    kth_noise = torch.empty((P,), dtype=torch.float32, device=dev)
    cand_scores = torch.empty((P, k), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.shortlist_select_launch(
            scores.data_ptr(), int(seed) & 0xFFFFFFFF, P, N, k,
            cand.data_ptr(), kth.data_ptr(), kth_noise.data_ptr(),
            cand_scores.data_ptr(), stream)
    check_launch(lib, "shortlist_select", err, f"P={P} N={N} K={k}")
    return cand, kth, kth_noise, cand_scores

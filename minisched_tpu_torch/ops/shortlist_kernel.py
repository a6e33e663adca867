"""Launch the CUDA shortlist scan kernel (csrc/shortlist_scan.cu).

The kernel is built at first use by ops/_cuda_build.py (nvcc, sm_90a,
ctypes). ``shortlist_scan_cuda`` (one batch) and
``shortlist_scan_lanes_cuda`` (T batches of one shape in one launch, one
block a lane: the fused tenant step's lanes) are its wrappers: they
check their inputs, gather the candidates' scores unless the selection
kernel handed them over, allocate the outputs, launch on PyTorch's
current stream and count each launch once in
``_cuda_build.LAUNCHES["shortlist_scan"]``. They never fall back to the
plain version (select.greedy_assign_shortlist_plain).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ._cuda_build import check_launch, load
from .select import ShortlistAssignResult

_MAX_R = 32


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.shortlist_scan_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 8
                   + [ctypes.c_uint32] + [ctypes.c_int] * 5
                   + [ctypes.c_void_p] * 5)


def _check(name: str, t: torch.Tensor, dtype, shape, device) -> torch.Tensor:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, scores on {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{shape}")
    return t.contiguous()


def _launch(scores, cand, kth, kth_noise, requests, free0,
            seeds: Optional[torch.Tensor], seed: int,
            cand_scores: Optional[torch.Tensor]) -> ShortlistAssignResult:
    """One launch over T lanes (every array with a leading T axis):
    ``seeds`` a (T,) int32 CUDA tensor of the lanes' u32 seeds, or None
    for T = 1 with ``seed``."""
    if scores.device.type != "cuda":
        raise ValueError(f"the scan kernel needs CUDA tensors, got "
                         f"{scores.device}")
    if scores.dim() != 3 or cand.dim() != 3 or requests.dim() != 3:
        raise ValueError("scores, cand and requests must be (T,P,·)")
    dev = scores.device
    T, P, N = scores.shape
    K = cand.shape[2]
    R = requests.shape[2]
    if N < 1 or not 1 <= K <= N or not 1 <= R <= _MAX_R:
        raise ValueError(f"need N >= 1, 1 <= K <= N and 1 <= R <= {_MAX_R}, "
                         f"got N={N} K={K} R={R}")
    scores = _check("scores", scores, torch.float32, (T, P, N), dev)
    cand = _check("cand", cand, torch.int32, (T, P, K), dev)
    kth = _check("kth", kth, torch.float32, (T, P), dev)
    kth_noise = _check("kth_noise", kth_noise, torch.float32, (T, P), dev)
    requests = _check("requests", requests, torch.float32, (T, P, R), dev)
    free0 = _check("free0", free0, torch.float32, (T, N, R), dev)
    if seeds is not None:
        seeds = _check("seeds", seeds, torch.int32, (T,), dev)
    elif T != 1:
        raise ValueError("more than one lane needs a seeds tensor")
    if cand_scores is None:
        cand_scores = torch.gather(scores, 2, cand.long())
    cand_scores = _check("cand_scores", cand_scores, torch.float32,
                         (T, P, K), dev)
    lib = load("shortlist_scan", _bind)
    chosen = torch.empty((T, P), dtype=torch.int32, device=dev)
    assigned = torch.empty((T, P), dtype=torch.bool, device=dev)
    repaired = torch.empty((T, P), dtype=torch.bool, device=dev)
    free_after = torch.empty((T, N, R), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.shortlist_scan_launch(
            scores.data_ptr(), cand.data_ptr(), cand_scores.data_ptr(),
            kth.data_ptr(), kth_noise.data_ptr(), requests.data_ptr(),
            free0.data_ptr(), None if seeds is None else seeds.data_ptr(),
            int(seed) & 0xFFFFFFFF, T, P, N, K, R, chosen.data_ptr(),
            assigned.data_ptr(), free_after.data_ptr(), repaired.data_ptr(),
            stream)
    check_launch(lib, "shortlist_scan", err,
                 f"T={T} P={P} N={N} K={K} R={R}")
    return ShortlistAssignResult(chosen, assigned, free_after, repaired)


def shortlist_scan_cuda(scores: torch.Tensor, cand: torch.Tensor,
                        kth: torch.Tensor, kth_noise: torch.Tensor,
                        requests: torch.Tensor, free0: torch.Tensor,
                        seed: int, cand_scores: torch.Tensor | None = None
                        ) -> ShortlistAssignResult:
    """The kernel's wrapper: same contract as
    select.greedy_assign_shortlist_plain, on CUDA tensors. ``cand``,
    ``kth`` and ``kth_noise`` are select.shortlist_select's outputs;
    ``cand_scores`` (P,K), the candidates' scores, is gathered here when
    not given (ops/select_kernel.py returns it)."""
    if scores.dim() != 2 or cand.dim() != 2 or requests.dim() != 2:
        raise ValueError("scores, cand and requests must be 2-D")
    r = _launch(scores[None], cand[None], kth[None], kth_noise[None],
                requests[None], free0[None], None, seed,
                None if cand_scores is None else cand_scores[None])
    return ShortlistAssignResult(*(x[0] for x in r))


def shortlist_scan_lanes_cuda(scores: torch.Tensor, cand: torch.Tensor,
                              kth: torch.Tensor, kth_noise: torch.Tensor,
                              requests: torch.Tensor, free0: torch.Tensor,
                              seeds: torch.Tensor,
                              cand_scores: torch.Tensor | None = None
                              ) -> ShortlistAssignResult:
    """The lane form: every input with a leading T axis (scores (T,P,N),
    free0 (T,N,R), ...) and ``seeds`` the lanes' u32 seeds as a (T,)
    int32 CUDA tensor; lane t's outputs equal ``shortlist_scan_cuda`` on
    lane t's inputs. One launch, one block a lane, counted once."""
    return _launch(scores, cand, kth, kth_noise, requests, free0, seeds, 0,
                   cand_scores)

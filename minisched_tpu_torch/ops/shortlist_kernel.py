"""Launch the CUDA shortlist scan kernel (csrc/shortlist_scan.cu).

The kernel is built at first use by ops/_cuda_build.py (nvcc, sm_90a,
ctypes). ``shortlist_scan_cuda`` is its wrapper: it checks its inputs,
gathers the candidates' scores unless the selection kernel handed them
over, allocates the outputs, launches on PyTorch's current stream and
counts the launch in ``_cuda_build.LAUNCHES["shortlist_scan"]``. It
never falls back to the plain version
(select.greedy_assign_shortlist_plain).
"""
from __future__ import annotations

import ctypes

import torch

from ._cuda_build import check_launch, load
from .select import ShortlistAssignResult

_MAX_R = 32


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.shortlist_scan_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 7
                   + [ctypes.c_uint32] + [ctypes.c_int] * 4
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
    if scores.device.type != "cuda":
        raise ValueError(f"shortlist_scan_cuda needs CUDA tensors, got "
                         f"{scores.device}")
    if scores.dim() != 2 or cand.dim() != 2 or requests.dim() != 2:
        raise ValueError("scores, cand and requests must be 2-D")
    dev = scores.device
    P, N = scores.shape
    K = cand.shape[1]
    R = requests.shape[1]
    if N < 1 or not 1 <= K <= N or not 1 <= R <= _MAX_R:
        raise ValueError(f"need N >= 1, 1 <= K <= N and 1 <= R <= {_MAX_R}, "
                         f"got N={N} K={K} R={R}")
    scores = _check("scores", scores, torch.float32, (P, N), dev)
    cand = _check("cand", cand, torch.int32, (P, K), dev)
    kth = _check("kth", kth, torch.float32, (P,), dev)
    kth_noise = _check("kth_noise", kth_noise, torch.float32, (P,), dev)
    requests = _check("requests", requests, torch.float32, (P, R), dev)
    free0 = _check("free0", free0, torch.float32, (N, R), dev)
    if cand_scores is None:
        cand_scores = torch.gather(scores, 1, cand.long())
    cand_scores = _check("cand_scores", cand_scores, torch.float32, (P, K),
                         dev)
    lib = load("shortlist_scan", _bind)
    chosen = torch.empty((P,), dtype=torch.int32, device=dev)
    assigned = torch.empty((P,), dtype=torch.bool, device=dev)
    repaired = torch.empty((P,), dtype=torch.bool, device=dev)
    free_after = torch.empty((N, R), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.shortlist_scan_launch(
            scores.data_ptr(), cand.data_ptr(), cand_scores.data_ptr(),
            kth.data_ptr(), kth_noise.data_ptr(), requests.data_ptr(),
            free0.data_ptr(), int(seed) & 0xFFFFFFFF, P, N, K, R,
            chosen.data_ptr(), assigned.data_ptr(), free_after.data_ptr(),
            repaired.data_ptr(), stream)
    check_launch(lib, "shortlist_scan", err, f"P={P} N={N} K={K} R={R}")
    return ShortlistAssignResult(chosen, assigned, free_after, repaired)

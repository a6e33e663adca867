"""Launch the CUDA greedy-assignment kernel (csrc/greedy_assign.cu).

The kernel is built at first use by ops/_cuda_build.py (nvcc, sm_90a,
ctypes). ``greedy_assign_cuda`` is its wrapper: it checks its inputs,
allocates the outputs, launches on PyTorch's current stream and counts
the launch in ``_cuda_build.LAUNCHES["greedy_assign"]``. It never falls
back to the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from ._cuda_build import check_launch, load
from .select import AssignResult

_MAX_BLOCKS = 256  # grid-size cap; the scratch holds 2 slots per block
_MAX_R = 32


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.greedy_assign_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_uint32, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p]
    lib.greedy_assign_slot_bytes.restype = ctypes.c_int
    lib.greedy_assign_slot_bytes.argtypes = []


def greedy_assign_cuda(scores: torch.Tensor, requests: torch.Tensor,
                       free0: torch.Tensor, seed: int) -> AssignResult:
    """The kernel's wrapper: same contract as select.greedy_assign_plain,
    on CUDA tensors."""
    if scores.device.type != "cuda":
        raise ValueError(f"greedy_assign_cuda needs CUDA tensors, got "
                         f"{scores.device}")
    for name, t in (("scores", scores), ("requests", requests),
                    ("free0", free0)):
        if t.device != scores.device:
            raise ValueError(f"{name} is on {t.device}, scores on "
                             f"{scores.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if t.dim() != 2:
            raise ValueError(f"{name} must be 2-D, got shape "
                             f"{tuple(t.shape)}")
    P, N = scores.shape
    R = requests.shape[1]
    if requests.shape[0] != P or tuple(free0.shape) != (N, R):
        raise ValueError(f"shape mismatch: scores {tuple(scores.shape)}, "
                         f"requests {tuple(requests.shape)}, free0 "
                         f"{tuple(free0.shape)}")
    if N < 1 or not 1 <= R <= _MAX_R:
        raise ValueError(f"need N >= 1 and 1 <= R <= {_MAX_R}, got N={N} "
                         f"R={R}")
    scores = scores.contiguous()
    requests = requests.contiguous()
    free0 = free0.contiguous()
    lib = load("greedy_assign", _bind)
    dev = scores.device
    chosen = torch.empty((P,), dtype=torch.int32, device=dev)
    assigned = torch.empty((P,), dtype=torch.bool, device=dev)
    free_after = torch.empty((N, R), dtype=torch.float32, device=dev)
    scratch = torch.empty(
        (2 * _MAX_BLOCKS * lib.greedy_assign_slot_bytes(),),
        dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.greedy_assign_launch(
            scores.data_ptr(), requests.data_ptr(), free0.data_ptr(),
            int(seed) & 0xFFFFFFFF, P, N, R, chosen.data_ptr(),
            assigned.data_ptr(), free_after.data_ptr(), scratch.data_ptr(),
            _MAX_BLOCKS, stream)
    check_launch(lib, "greedy_assign", err, f"P={P} N={N} R={R}")
    return AssignResult(chosen, assigned, free_after)

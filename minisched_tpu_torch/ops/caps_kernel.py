"""Launch the CUDA caps scan kernel (csrc/caps_scan.cu): the greedy
assignment under in-scan hard-spread domain caps.

The kernel is built at first use by ops/_cuda_build.py (nvcc, sm_90a,
ctypes). ``caps_scan_cuda`` is its wrapper: it checks its inputs,
allocates the outputs, launches on PyTorch's current stream and counts
the launch in ``_cuda_build.LAUNCHES["caps_scan"]``. It never falls back
to the plain version (select.greedy_assign_plain with ``caps``).
"""
from __future__ import annotations

import ctypes

import torch

from ._cuda_build import check_launch, load
from .select import AssignResult

_MAX_BLOCKS = 256  # grid-size cap; the scratch holds 6 slots per block
_MAX_R, _MAX_C, _MAX_H, _MAX_K = 32, 8, 14, 255


def bind(lib: ctypes.CDLL) -> None:
    fn = lib.caps_scan_launch
    fn.restype = ctypes.c_int
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, ctypes.c_uint32, p, p, p, p, p, p,
                   i, i, i, i, i, i, p, p, p, p, i, p]
    lib.caps_scan_slot_bytes.restype = ctypes.c_int
    lib.caps_scan_slot_bytes.argtypes = []


def caps_scan_cuda(scores: torch.Tensor, requests: torch.Tensor,
                   free0: torch.Tensor, seed: int, caps) -> AssignResult:
    """The kernel's wrapper: same contract as select.greedy_assign_plain
    with ``caps``, on CUDA tensors."""
    if scores.device.type != "cuda":
        raise ValueError(f"caps_scan_cuda needs CUDA tensors, got "
                         f"{scores.device}")
    P, N = scores.shape
    R = requests.shape[1]
    C = caps.slot_h.shape[1]
    H, K = caps.counts0.shape
    want = {"scores": (scores, torch.float32, (P, N)),
            "requests": (requests, torch.float32, (P, R)),
            "free0": (free0, torch.float32, (N, R)),
            "slot_h": (caps.slot_h, torch.int32, (P, C)),
            "slot_skew": (caps.slot_skew, torch.float32, (P, C)),
            "domc": (caps.domc, torch.int32, (H, N)),
            "counts0": (caps.counts0, torch.float32, (H, K)),
            "dexist": (caps.dexist, torch.bool, (H, K)),
            "match": (caps.match, torch.bool, (P, H))}
    for name, (t, dtype, shape) in want.items():
        if t.device != scores.device:
            raise ValueError(f"{name} is on {t.device}, scores on "
                             f"{scores.device}")
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {dtype} of shape {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if (N < 1 or not 1 <= R <= _MAX_R or C > _MAX_C
            or not 1 <= H <= _MAX_H or not 1 <= K <= _MAX_K):
        raise ValueError(f"need N >= 1, 1 <= R <= {_MAX_R}, C <= {_MAX_C}, "
                         f"1 <= H <= {_MAX_H}, 1 <= K <= {_MAX_K}; got N={N} "
                         f"R={R} C={C} H={H} K={K}")
    args = [t.contiguous() for t, _d, _s in want.values()]
    lib = load("caps_scan", bind)
    dev = scores.device
    chosen = torch.empty((P,), dtype=torch.int32, device=dev)
    assigned = torch.empty((P,), dtype=torch.bool, device=dev)
    free_after = torch.empty((N, R), dtype=torch.float32, device=dev)
    scratch = torch.empty((6 * _MAX_BLOCKS * lib.caps_scan_slot_bytes(),),
                          dtype=torch.uint8, device=dev)
    s, rq, f0, sh, sk, dc, c0, de, mt = args
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.caps_scan_launch(
            s.data_ptr(), rq.data_ptr(), f0.data_ptr(),
            int(seed) & 0xFFFFFFFF, sh.data_ptr(), sk.data_ptr(),
            dc.data_ptr(), c0.data_ptr(), de.data_ptr(), mt.data_ptr(),
            P, N, R, C, H, K, chosen.data_ptr(), assigned.data_ptr(),
            free_after.data_ptr(), scratch.data_ptr(), _MAX_BLOCKS, stream)
    check_launch(lib, "caps_scan", err, f"P={P} N={N} R={R} C={C} H={H} "
                 f"K={K}")
    return AssignResult(chosen, assigned, free_after)

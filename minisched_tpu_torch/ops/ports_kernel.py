"""Launch the CUDA port-insertion kernel (csrc/insert_ports.cu).

The kernel is built at first use by ops/_cuda_build.py (nvcc, sm_90a,
ctypes). ``insert_ports_cuda`` is its wrapper: it checks its inputs,
allocates the output, launches on PyTorch's current stream and counts
the launch in ``_cuda_build.LAUNCHES["insert_ports"]``. It never falls
back to the plain version (residency.insert_ports_plain).
"""
from __future__ import annotations

import ctypes

import torch

from ._cuda_build import check_launch, load


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.insert_ports_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p] * 2)


def insert_ports_cuda(state: torch.Tensor, rows: torch.Tensor,
                      ports: torch.Tensor) -> torch.Tensor:
    """The kernel's wrapper: same contract as residency.insert_ports_plain
    (state (N,PORT) int32, rows (P,) int32 with -1 = skip, ports (P,PP)
    int32 with 0 = empty), on CUDA tensors. Returns the new state; the
    input is not written."""
    if state.device.type != "cuda":
        raise ValueError(f"insert_ports_cuda needs CUDA tensors, got "
                         f"{state.device}")
    for name, t, dim in (("state", state, 2), ("rows", rows, 1),
                         ("ports", ports, 2)):
        if t.device != state.device:
            raise ValueError(f"{name} is on {t.device}, state on "
                             f"{state.device}")
        if t.dtype != torch.int32 or t.dim() != dim:
            raise ValueError(f"{name} must be {dim}-D int32, got "
                             f"{t.dtype} of shape {tuple(t.shape)}")
    N, PORT = state.shape
    P, PP = ports.shape
    if rows.shape[0] != P or PORT < 1:
        raise ValueError(f"shape mismatch: state {tuple(state.shape)}, rows "
                         f"{tuple(rows.shape)}, ports {tuple(ports.shape)}")
    state, rows, ports = state.contiguous(), rows.contiguous(), \
        ports.contiguous()
    lib = load("insert_ports", _bind)
    out = torch.empty_like(state)
    with torch.cuda.device(state.device):
        stream = torch.cuda.current_stream(state.device).cuda_stream
        err = lib.insert_ports_launch(
            state.data_ptr(), rows.data_ptr(), ports.data_ptr(), N, PORT, P,
            PP, out.data_ptr(), stream)
    check_launch(lib, "insert_ports", err, f"N={N} PORT={PORT} P={P} PP={PP}")
    return out

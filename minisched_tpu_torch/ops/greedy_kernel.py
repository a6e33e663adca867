"""Build, load and launch the CUDA greedy-assignment kernel.

The kernel (csrc/greedy_assign.cu) is compiled with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, at first use,
into ``_build/`` beside the package sources, and loaded with ``ctypes``.
The library's file name carries a hash of the source, so an edited
source is rebuilt. Nothing is compiled when this module is imported.

``greedy_assign_cuda`` is the kernel's wrapper: it checks its inputs,
allocates the outputs, launches on PyTorch's current stream and counts
the launch in ``LAUNCHES``. It never falls back to the plain version.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

from .select import AssignResult

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "greedy_assign.cu")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_MAX_BLOCKS = 256  # grid-size cap; the scratch holds 2 slots per block
_MAX_R = 32

# Launches of the kernel since the last reset: the main path's evidence
# that it ran through the kernel. Only greedy_assign_cuda increments it.
LAUNCHES = {"greedy_assign": 0}

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                       "build the greedy-assignment kernel")


def library_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"libgreedy_assign-{digest}.so")


def build() -> str:
    """Compile the kernel library unless this source's build exists.
    Returns the library path; raises with nvcc's output on failure."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp, SOURCE]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    with open(out + ".log", "w") as f:  # ptxas: registers, smem, spills
        f.write(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            fn = lib.greedy_assign_launch
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_uint32, ctypes.c_int, ctypes.c_int,
                           ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                           ctypes.c_void_p]
            lib.greedy_assign_slot_bytes.restype = ctypes.c_int
            lib.greedy_assign_slot_bytes.argtypes = []
            lib.greedy_assign_error_string.restype = ctypes.c_char_p
            lib.greedy_assign_error_string.argtypes = [ctypes.c_int]
            _lib = lib
        return _lib


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
    lib = _load()
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
    if err != 0:
        msg = lib.greedy_assign_error_string(err).decode()
        raise RuntimeError(f"greedy_assign kernel launch failed: cudaError "
                           f"{err} ({msg}) at P={P} N={N} R={R}")
    LAUNCHES["greedy_assign"] += 1
    return AssignResult(chosen, assigned, free_after)

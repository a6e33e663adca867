"""Build and load the package's CUDA kernels, and count their launches.

Each kernel source in ``csrc/`` is compiled with ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface, at first use, into
``_build/`` beside the package sources, and loaded with ``ctypes``. The
library's file name carries a hash of the source and of the shared
headers (``csrc/*.cuh``), so an edited source is rebuilt. Nothing is
compiled when this module is imported.

``LAUNCHES`` counts the launches of every kernel by name since the last
reset: the main path's evidence that it ran through the kernels. Only a
kernel's wrapper increments its entry, right after a launch that the
CUDA runtime accepted. A launcher that had no work (an empty batch)
launches nothing and returns ``NO_LAUNCH``, which is not counted.
``thread_launches()`` counts the same launches per host thread: an
engine books the launches of its own scheduling thread from it, so two
engines of one process (a fleet's replicas) never book each other's.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Callable, Dict

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

KERNELS = ("greedy_assign", "shortlist_select", "shortlist_scan",
           "insert_ports", "caps_scan", "auction", "bid_auction")
NO_LAUNCH = -1  # a launcher's return when it had no work to launch
LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# Not _lock: that one is held through a build, which takes seconds.
_count_lock = threading.Lock()
_tls = threading.local()


def thread_launches() -> Dict[str, int]:
    """The calling thread's launches by kernel (its live counter: copy
    it to take a "before"). Wrappers launch on the calling thread, so
    the delta around a call is exactly that call's launches."""
    counts = getattr(_tls, "counts", None)
    if counts is None:
        counts = _tls.counts = {name: 0 for name in KERNELS}
    return counts


def note_launch(prefix: str) -> None:
    """Count one launch of kernel ``prefix`` process-wide and on the
    calling thread."""
    with _count_lock:
        LAUNCHES[prefix] += 1
    thread_launches()[prefix] += 1


def source(name: str) -> str:
    return os.path.join(CSRC_DIR, f"{name}.cu")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                       "build the package's kernels")


def library_path(name: str) -> str:
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for path in [source(name)] + [os.path.join(CSRC_DIR, f)
                                  for f in headers]:
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def build(name: str) -> str:
    """Compile kernel ``name`` unless this source's build exists. Returns
    the library path; raises with nvcc's output on failure. The ptxas
    report (registers, shared memory, spills) lands beside the library
    as ``<library>.log``. Safe to call from several threads at once:
    each writes its own temporary file and renames it into place."""
    out = library_path(name)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp, source(name)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name} ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    with open(out + ".log", "w") as f:
        f.write(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def load(name: str, bind: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The kernel's library, built and loaded at first use; ``bind``
    sets the C functions' argument and result types once."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name))
            bind(lib)
            _libs[name] = lib
        return lib


def check_launch(lib: ctypes.CDLL, prefix: str, err: int, where: str
                 ) -> None:
    """Raise on a refused launch (``err`` is the launch's cudaError_t);
    count it if it launched (``err`` is 0, not ``NO_LAUNCH``)."""
    if err == NO_LAUNCH:
        return
    if err != 0:
        fn = getattr(lib, f"{prefix}_error_string")
        fn.restype = ctypes.c_char_p
        fn.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{prefix} kernel launch failed: cudaError {err} "
                           f"({fn(err).decode()}) at {where}")
    note_launch(prefix)

"""Build and load the package's CUDA kernels, and count their launches.

Each kernel source in ``csrc/`` is compiled with ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface, at first use, into
``_build/`` beside the package sources, and loaded with ``ctypes``. The
library's file name carries a hash of the source and of the shared
headers (``csrc/*.cuh``), so an edited source is rebuilt. Nothing is
compiled when this module is imported. ``enable_compile_cache`` (the
``SchedulerConfig.compile_cache`` knob) moves the build directory, so
that every process naming one directory shares one set of libraries.

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
from concurrent.futures import ThreadPoolExecutor
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

#: Builds and launches that failed in this process (a process fleet's
#: replica exits on either: no kernel failure is ever served around).
FAILURES: Dict[str, int] = {"build": 0, "launch": 0}

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


def enable_compile_cache(path: str) -> bool:
    """Build into and load from ``path`` instead of the package's
    ``_build/`` (the counterpart of the JAX package's persistent
    compilation cache; the port has no XLA cache). Process-wide and
    idempotent. Returns True when the directory is in use, False for an
    empty path or a directory that cannot be made (logged; the kernels
    then build where they did)."""
    global BUILD_DIR
    if not path:
        return False
    path = os.path.abspath(path)
    if BUILD_DIR == path:
        return True
    try:
        os.makedirs(path, exist_ok=True)
    except OSError:
        import logging

        logging.getLogger(__name__).warning(
            "MINISCHED_COMPILE_CACHE=%s: the directory cannot be made; "
            "kernels build in %s", path, BUILD_DIR, exc_info=True)
        return False
    BUILD_DIR = path
    return True


def library_path(name: str, directory: str = "") -> str:
    """The library of kernel ``name`` in ``directory`` (default: the
    build directory in use)."""
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for path in [source(name)] + [os.path.join(CSRC_DIR, f)
                                  for f in headers]:
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(directory or BUILD_DIR,
                        f"lib{name}-{h.hexdigest()[:12]}.so")


def build(name: str, directory: str = "") -> str:
    """Compile kernel ``name`` unless this source's build exists. Returns
    the library path; raises with nvcc's output on failure. The ptxas
    report (registers, shared memory, spills) lands beside the library
    as ``<library>.log``. Safe to call from several threads at once:
    each writes its own temporary file and renames it into place.
    ``directory`` defaults to the build directory in use."""
    out = library_path(name, directory)
    if os.path.exists(out):
        return out
    os.makedirs(os.path.dirname(out), exist_ok=True)
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


def build_all(directory: str = "") -> Dict[str, str]:
    """Build every kernel at once, one ``nvcc`` a source, into
    ``directory`` (default: the build directory in use). A process fleet
    calls it before spawning replicas that share the directory, so no
    replica pays the builds (or races them) while it should be renewing
    its leases. Raises on the first failed build."""
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        return dict(zip(KERNELS, pool.map(lambda n: build(n, directory),
                                          KERNELS)))


def load(name: str, bind: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The kernel's library, built and loaded at first use; ``bind``
    sets the C functions' argument and result types once."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            try:
                path = build(name)
            except Exception:
                FAILURES["build"] += 1
                raise
            lib = ctypes.CDLL(path)
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
        FAILURES["launch"] += 1
        fn = getattr(lib, f"{prefix}_error_string")
        fn.restype = ctypes.c_char_p
        fn.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{prefix} kernel launch failed: cudaError {err} "
                           f"({fn(err).decode()}) at {where}")
    note_launch(prefix)

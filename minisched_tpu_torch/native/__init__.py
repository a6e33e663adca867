"""Native runtime primitives (CPython C extensions, built on first use).

``fastclone`` (fastclone.c) is the structural clone behind the store's
copy-on-read and ingestion isolation (state/objects.py::deepcopy_obj):
about 300k recursive clone calls per 10k-pod submission, on the
create-to-bound path. It is the same recursion as the Python walk, in C.
``clone_snapshot`` (the store's copies) and ``untrack`` (the store's trees
built in Python, its watch events) also take every container they reach
off the cycle collector's lists: the store's objects are immutable and
acyclic, and reference counts free them.

Build: plain CPython C API compiled with the system ``g++``/``cc``/``gcc``
(``-O2 -shared -fPIC``, about a second) into ``minisched_tpu_torch/_build/``
on first use, never at import. The file name carries a hash of the
source, the Python version and the extension suffix, so an edited source
is rebuilt. Each builder compiles to a per-pid temporary file and
renames it into place, so concurrent builders (test workers, two
services on one host) never load a half-written library.

A failed build or load raises with the compiler's output: there is no
silent fallback. ``MINISCHED_NO_NATIVE=1`` is the one explicit switch to
the Python walk; ``load()`` then returns None.
"""
from __future__ import annotations

import hashlib
import importlib.util
import logging
import os
import subprocess
import sys
import sysconfig
import threading
import time

log = logging.getLogger(__name__)

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "fastclone.c")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
# Tried in order; a name that is not installed is skipped, a compiler
# that runs and fails raises.
COMPILERS = ("g++", "cc", "gcc")
MODULE = "minisched_tpu_torch.native._fastclone"

_mod = None
_status = {"native": False, "built": False, "build_s": 0.0, "path": None}
_load_lock = threading.Lock()


class NativeBuildError(RuntimeError):
    """The native clone could not be built or loaded."""


def disabled() -> bool:
    """True when ``MINISCHED_NO_NATIVE`` selects the Python walk."""
    return os.environ.get("MINISCHED_NO_NATIVE", "") not in ("", "0")


def so_path() -> str:
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    h = hashlib.sha256()
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    h.update(sys.version.encode())
    return os.path.join(BUILD_DIR,
                        f"_fastclone-{h.hexdigest()[:12]}{suffix}")


def _compile(out: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    include = sysconfig.get_paths()["include"]
    tmp = f"{out}.tmp.{os.getpid()}"
    errors = []
    try:
        for cc in COMPILERS:
            try:
                r = subprocess.run(
                    [cc, "-O2", "-shared", "-fPIC", f"-I{include}", SOURCE,
                     "-o", tmp], capture_output=True, text=True,
                    timeout=120)
            except FileNotFoundError:
                errors.append(f"{cc}: not found")
                continue
            if r.returncode != 0:
                raise NativeBuildError(
                    f"building {SOURCE} with {cc} failed "
                    f"(rc {r.returncode}):\n{r.stderr}")
            os.replace(tmp, out)
            return
        raise NativeBuildError(
            f"no C compiler to build {SOURCE}: {'; '.join(errors)}")
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load():
    """The ``_fastclone`` module, built on first use; None only under
    ``MINISCHED_NO_NATIVE=1``. Raises NativeBuildError when the build,
    the load or its smoke test fails. Thread-safe: concurrent first
    callers wait on one build."""
    global _mod
    if disabled():
        return None
    with _load_lock:
        if _mod is not None:
            return _mod
        so = so_path()
        if not os.path.exists(so):
            t = time.perf_counter()
            _compile(so)
            _status.update(built=True, build_s=time.perf_counter() - t)
        try:
            spec = importlib.util.spec_from_file_location(MODULE, so)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
        except ImportError as e:
            raise NativeBuildError(f"loading {so} failed: {e}") from e
        sample = {"a": [1, "b", (2.0, None)]}
        if mod.clone(sample) != sample:
            raise NativeBuildError(f"{so} failed its smoke test")
        _mod = mod
        _status.update(native=True, path=so)
        log.info("fastclone native extension loaded from %s", so)
        return _mod


def status() -> dict:
    """Whether the native clone is loaded, whether this process built it
    and in how many seconds, and the library's path."""
    with _load_lock:
        return dict(_status)

"""Build kernel sources for the kernel timing tools, and split a kernel's
time by phase with clock64 stamps in a copy of its source.

Used by tools/caps_kernel_timing.py and tools/auction_kernel_timing.py;
not a tool of its own. Needs nvcc (and a CUDA card to run the builds).

A build is a set of files (a kernel source and the headers it includes)
written into its own directory under minisched_tpu_torch/_build/timing/
(gitignored) and compiled there, so an older kernel builds against its
own older headers.

A stamped copy is such a set with PRELUDE inserted after the first
`#include <stdint.h>` of one file and text edits applied (each anchor
must occur exactly once); it is built beside the other builds and never
committed. In the copy, thread 0 of every block adds the clock64 cycles
since its previous mark to a 64-bit slot per (block, phase) with one
atomic whose result is unused (a fire-and-forget reduction), and counts
events in other slots (another thread may stamp phases of its own); the kernel's first and last marks record the SM
clock and the global timer in slots 30 and 31, so cycles convert to
time. The stamps add their own cost: the copy's total is printed beside.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD = os.path.join(ROOT, "minisched_tpu_torch", "_build", "timing")
SLOTS = 32

PRELUDE = r'''
__constant__ unsigned long long* g_stamps;
extern "C" int stamps_set(void* p) {
  return static_cast<int>(cudaMemcpyToSymbol(g_stamps, &p, sizeof(p)));
}
// Thread `who` adds the cycles since t to phase slot k and restarts t.
__device__ __forceinline__ void st_mark(long long& t, int k, int who = 0) {
  const long long n = clock64();
  if (threadIdx.x == who)
    atomicAdd(g_stamps + blockIdx.x * 32 + k,
              static_cast<unsigned long long>(n - t));
  t = n;
}
__device__ __forceinline__ void st_count(int k) {
  if (threadIdx.x == 0) atomicAdd(g_stamps + blockIdx.x * 32 + k, 1ull);
}
__device__ __forceinline__ unsigned long long st_ns() {
  unsigned long long g;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g));
  return g;
}
__device__ __forceinline__ void st_open(long long& t) {
  t = clock64();
  if (threadIdx.x == 0) {
    g_stamps[blockIdx.x * 32 + 30] = static_cast<unsigned long long>(t);
    g_stamps[blockIdx.x * 32 + 31] = st_ns();
  }
}
__device__ __forceinline__ void st_close() {
  if (threadIdx.x == 0) {
    unsigned long long* o = g_stamps + blockIdx.x * 32;
    o[30] = static_cast<unsigned long long>(clock64()) - o[30];
    o[31] = st_ns() - o[31];
  }
}
'''


def nvcc() -> str:
    from minisched_tpu_torch.ops import _cuda_build

    return _cuda_build._nvcc()


def edit(src: str, pairs: Iterable[Tuple[str, str]]) -> str:
    for old, new in pairs:
        if src.count(old) != 1:
            raise SystemExit(f"edit anchor not found once: {old!r}")
        src = src.replace(old, new)
    return src


def read_dir(path: str, exts=(".cu", ".cuh")) -> Dict[str, str]:
    """The kernel sources and headers of a directory, by file name."""
    out = {}
    for f in sorted(os.listdir(path)):
        if f.endswith(exts):
            with open(os.path.join(path, f)) as fh:
                out[f] = fh.read()
    return out


def stamped(files: Dict[str, str], edits: Dict[str, Sequence]) -> Dict[
        str, str]:
    """A stamped copy of ``files``: PRELUDE after the first `#include
    <stdint.h>` of the first file (in ``edits``' order) that has one,
    then each file's edits."""
    out = dict(files)
    anchor = "#include <stdint.h>\n"
    for name in edits:
        if anchor in out[name]:
            out[name] = out[name].replace(anchor, anchor + PRELUDE, 1)
            break
    else:
        raise SystemExit("no file to take the stamp prelude")
    for name, pairs in edits.items():
        out[name] = edit(out[name], pairs)
    return out


def build(tag: str, files: Dict[str, str], main: str,
          bind) -> ctypes.CDLL:
    """Compile ``files[main]`` with the other files beside it, in a
    directory of its own named by ``tag`` and a hash of every file;
    ``bind`` sets the library's C types. Prints ptxas's registers and
    spills once per build."""
    h = hashlib.sha256()
    for name in sorted(files):
        h.update(name.encode() + b"\0" + files[name].encode())
    d = os.path.join(BUILD, f"{tag}-{h.hexdigest()[:12]}")
    so = os.path.join(d, "lib.so")
    if not os.path.exists(so):
        from minisched_tpu_torch.ops import _cuda_build

        os.makedirs(d, exist_ok=True)
        for name, text in files.items():
            with open(os.path.join(d, name), "w") as f:
                f.write(text)
        p = subprocess.run([nvcc(), *_cuda_build.NVCC_FLAGS, "-I", d,
                            "-Xptxas", "-v", "-o", so + ".tmp",
                            os.path.join(d, main)],
                           capture_output=True, text=True)
        if p.returncode:
            raise SystemExit(f"nvcc failed for {tag}:\n{p.stderr}")
        os.replace(so + ".tmp", so)
        print(f"ptxas {tag}: " + " | ".join(
            ln.strip() for ln in p.stderr.splitlines()
            if "registers" in ln or "spill" in ln), flush=True)
    lib = ctypes.CDLL(so)
    bind(lib)
    return lib


class Stamps:
    """The stamp buffer of a stamped library: zero(), then a launch, then
    read()."""

    def __init__(self, lib: ctypes.CDLL, blocks: int = 1024):
        self.buf = torch.zeros((blocks, SLOTS), dtype=torch.int64,
                               device="cuda")
        lib.stamps_set.restype = ctypes.c_int
        lib.stamps_set.argtypes = [ctypes.c_void_p]
        err = lib.stamps_set(self.buf.data_ptr())
        if err:
            raise SystemExit(f"stamps_set failed: cudaError {err}")

    def zero(self) -> None:
        self.buf.zero_()

    def read(self):
        """(per-block slots of the blocks that ran, SM cycles per ns)."""
        torch.cuda.synchronize()
        st = self.buf.cpu().numpy().astype(np.float64)
        st = st[st[:, 31] > 0]
        return st, st[:, 30] / st[:, 31]


def report(label: str, st, ghz, phases: Dict[int, Tuple[str, float]],
           counts: Dict[int, str] = None, unit: str = "") -> List[str]:
    """Lines of mean / min / max over blocks of each phase in us divided
    by the phase's divisor (e.g. pods or rounds), then the counts summed
    over blocks."""
    lines = [f"  split of {label}: {len(st)} blocks, SM clock "
             f"{ghz.mean():.3f} GHz, stamped kernel "
             f"{(st[:, 31] / 1e3).mean():.1f} us per block"]
    for k, (name, per) in phases.items():
        us = st[:, k] / ghz / 1e3 / per
        lines.append(f"    {name:44s} mean {us.mean():9.4f} min "
                     f"{us.min():9.4f} max {us.max():9.4f} us{unit}")
    for k, name in (counts or {}).items():
        lines.append(f"    {name}: {int(st[:, k].sum())} in all blocks, "
                     f"{st[:, k].mean():.1f} per block")
    return lines

"""Time the CUDA caps scan kernel (csrc/caps_scan.cu) against another
build of it, in turns. Needs a CUDA card and nvcc.

    python tools/caps_kernel_timing.py [--other OLD.cu]

Input: config 4 hard at full width, as chip_smoke.py's caps phase builds
it (chip_smoke.c4_hard_problem: the first 1,024 pods of
c4_workload(50,000, 10,000, max_skew=1, hard=True), scored by the
config-4 profile with the caps' groups deferred to the scan), and
tests/torch_parity.py's "multi-block" caps problem (512 pods over 3,000
nodes). Every build is first held bitwise
against the plain version (chosen, assigned, free_after).

--other  a kernel source with the same C interface (for instance an
         earlier commit's csrc/caps_scan.cu, extracted with `git show
         <commit>:minisched_tpu_torch/csrc/caps_scan.cu` first: the chip
         machine has no git); timed beside the package's kernel in turns:
         other, package, package, other (CUDA events, 10 launches each).

Every build, the package's too, is launched here through caps_launch,
outside the package's wrapper, so no launch is counted in
_cuda_build.LAUNCHES.

Builds go to minisched_tpu_torch/_build/timing/ (gitignored).
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
import chip_smoke as cs  # noqa: E402
from minisched_tpu_torch.ops import _cuda_build  # noqa: E402
from minisched_tpu_torch.ops.caps_kernel import _MAX_BLOCKS, bind  # noqa: E402
from minisched_tpu_torch.ops.select import (AssignResult,  # noqa: E402
                                            greedy_assign_plain)
from torch_parity import caps_problem  # noqa: E402

BUILD = os.path.join(ROOT, "minisched_tpu_torch", "_build", "timing")


def build(name: str, src: str) -> ctypes.CDLL:
    digest = hashlib.sha256(src.encode()).hexdigest()[:12]
    os.makedirs(BUILD, exist_ok=True)
    cu = os.path.join(BUILD, f"caps-{name}-{digest}.cu")
    so = cu[:-3] + ".so"
    if not os.path.exists(so):
        with open(cu, "w") as f:
            f.write(src)
        p = subprocess.run([_cuda_build._nvcc(), *_cuda_build.NVCC_FLAGS,
                            "-Xptxas", "-v", "-o", so, cu],
                           capture_output=True, text=True)
        if p.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{p.stderr}")
        print(f"ptxas {name}: " + " | ".join(
            ln.strip() for ln in p.stderr.splitlines()
            if "registers" in ln or "spill" in ln))
    lib = ctypes.CDLL(so)
    bind(lib)
    return lib


def caps_launch(lib, scores, req, free, seed, caps) -> AssignResult:
    """One launch of ``lib``'s caps scan on contiguous CUDA inputs."""
    P, N = scores.shape
    R, C = req.shape[1], caps.slot_h.shape[1]
    H, K = caps.counts0.shape
    dev = scores.device
    out = AssignResult(torch.empty((P,), dtype=torch.int32, device=dev),
                       torch.empty((P,), dtype=torch.bool, device=dev),
                       torch.empty((N, R), device=dev))
    scratch = torch.empty((6 * _MAX_BLOCKS * lib.caps_scan_slot_bytes(),),
                          dtype=torch.uint8, device=dev)
    ins = [t.contiguous() for t in (
        scores, req, free, caps.slot_h, caps.slot_skew, caps.domc,
        caps.counts0, caps.dexist, caps.match)]
    err = lib.caps_scan_launch(
        *(t.data_ptr() for t in ins[:3]), seed & 0xFFFFFFFF,
        *(t.data_ptr() for t in ins[3:]), P, N, R, C, H, K,
        *(t.data_ptr() for t in out), scratch.data_ptr(), _MAX_BLOCKS,
        torch.cuda.current_stream().cuda_stream)
    if err not in (0, _cuda_build.NO_LAUNCH):
        raise SystemExit(f"launch failed: cudaError {err}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", help="another kernel source, same interface")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("FAILED: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    with open(_cuda_build.source("caps_scan")) as f:
        builds = {"package": build("package", f.read())}
    if opts.other:
        with open(opts.other) as f:
            builds["other"] = build("other", f.read())
    order = (["other"] if opts.other else []) + ["package", "package"] + (
        ["other"] if opts.other else [])
    args, seed, caps, _zones = cs.c4_hard_problem()
    mb = caps_problem("multi-block")
    problems = {
        "config 4 hard full width": (*args, seed, caps),
        "multi-block": tuple(t.cuda() for t in mb[:3]) + (
            mb[3], type(mb[4])(*[t.cuda() for t in mb[4]]))}
    for name, (scores, req, free, seed, caps) in problems.items():
        plain = greedy_assign_plain(scores, req, free, seed, caps)
        for b, lib in builds.items():
            got = caps_launch(lib, scores, req, free, seed, caps)
            for f in ("chosen", "assigned", "free_after"):
                if not torch.equal(cs.bits(getattr(got, f)),
                                   cs.bits(getattr(plain, f))):
                    raise SystemExit(f"FAILED: {b} {name}: {f} != plain")
        P, N = scores.shape
        times = [(b, cs.cuda_ms(lambda lib=builds[b]: caps_launch(
            lib, scores, req, free, seed, caps), reps=10))
            for b in order]
        print(f"{name} {P}x{N}x{req.shape[1]}: every build = plain bitwise "
              f"({int(plain.assigned.sum())} assigned); "
              + ", ".join(f"{b} {ms:.4f} ms ({ms * 1e3 / P:.3f} us/pod)"
                          for b, ms in times) + f" ({smi})")
    return 0


if __name__ == "__main__":
    sys.exit(main())

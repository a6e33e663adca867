"""Time the CUDA greedy-assignment kernel against other builds, and split
its time per pod by phase. Needs a CUDA card and nvcc.

    python tools/greedy_kernel_timing.py [--other OLD.cu] [--variants a,b]
                                         [--split]

Inputs: the bench workload's first full-width batch (1024 pods x 53248
nodes x R=10, as chip_smoke.py builds it) and a scarce batch of the same
shape where each node fits one pod and consecutive pods want the same
node. Every build is first held bitwise against the plain version.

--other     a kernel source with the same C interface (for instance an
            earlier commit's csrc/greedy_assign.cu, extracted with
            `git show <commit>:minisched_tpu_torch/csrc/greedy_assign.cu`);
            it is timed beside the package's kernel in turns: other,
            package, [variants], package, other (CUDA events, 20 launches).
--variants  named edits of the package's source, timed in the same turns:
            threads256 (7 scan warps instead of 15), early-issue (the ring
            copies issued before the scan instead of after it),
            poll-backoff (a 100 ns sleep after a poll round that saw no new
            slot), weak-poll (L2-cached weak loads instead of relaxed .gpu
            loads for the poll).
--split     a copy of each source with clock64 stamps around its phases
            (lane 0 of two warps per block), run once; prints the mean,
            min and max over blocks of each phase in us per pod. The stamps
            add their own cost; the copy's total time is printed beside.

Builds go to minisched_tpu_torch/_build/timing/ (gitignored).
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
import chip_smoke as cs  # noqa: E402
from minisched_tpu_torch.encode import to_torch  # noqa: E402
from minisched_tpu_torch.ops import _cuda_build, prng  # noqa: E402
from minisched_tpu_torch.ops.pipeline import evaluate  # noqa: E402
from minisched_tpu_torch.ops.select import (AssignResult,  # noqa: E402
                                            greedy_assign_plain)
from torch_parity import scarce_case  # noqa: E402

BUILD = os.path.join(ROOT, "minisched_tpu_torch", "_build", "timing")
MAX_BLOCKS = 256
SLOT_BYTES = 16  # enough for either kernel's slot
STAMPS = 16      # per recorded warp: phase sums, then [14] clock, [15] ns


def edit(src: str, pairs) -> str:
    for old, new in pairs:
        if src.count(old) != 1:
            raise SystemExit(f"edit anchor not found once: {old!r}")
        src = src.replace(old, new)
    return src


VARIANTS = {
    "threads256": [("constexpr int kThreads = 512;",
                    "constexpr int kThreads = 256;")],
    "early-issue": [
        ("      cp_async_wait<kStages - 4>();  // pods up to i+1\n",
         "      issue(i + kStages - 2);\n"
         "      cp_async_wait<kStages - 3>();  // pods up to i+1\n"),
        ("      issue(i + kStages - 2);  // after the scan: its loads do not "
         "queue behind\n", "")],
    "poll-backoff": [
        ("    uint64_t v[kPollPerLane];\n",
         "    const uint32_t before = todo;\n    uint64_t v[kPollPerLane];\n"),
        ("        todo &= ~(1u << t);\n      }\n    }\n",
         "        todo &= ~(1u << t);\n      }\n    }\n"
         "    if (todo && todo == before) __nanosleep(100);\n")],
    "weak-poll": [('asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];\\n"',
                   'asm volatile("ld.global.cg.b64 %0, [%1];\\n"')],
}

# Stamps. acc[] sums clock64 deltas; the end of the kernel writes them.
_PROLOGUE = ("  long long acc[14] = {0};\n"
             "  const long long c_start = clock64();\n"
             "  uint64_t g_start;\n"
             "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(g_start));\n")


def _epilogue(cond: str, which: str) -> str:
    return (f"  if ({cond}) {{\n"
            f"    long long* o = stamps + (blockIdx.x * 2 + ({which})) * 16;\n"
            "    for (int k = 0; k < 14; ++k) o[k] = acc[k];\n"
            "    o[14] = clock64() - c_start;\n"
            "    uint64_t g_end;\n"
            "    asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(g_end));\n"
            "    o[15] = static_cast<long long>(g_end - g_start);\n  }\n")


# The grid-barrier kernel (one __syncthreads added after the scan, so the
# scan and the block reduction are timed apart). Thread 0 of each block.
BARRIER_PHASES = {0: "request load + sync", 1: "scan (scores from HBM) + sync",
                  2: "block_best", 3: "store slot + grid.sync",
                  4: "slot re-read + block_best", 5: "debit + sync"}
BARRIER_EDITS = [
    ("float* __restrict__ free_after, Triple* slots) {",
     "float* __restrict__ free_after, Triple* slots, long long* stamps) {\n"
     + _PROLOGUE),
    ("  for (int i = 0; i < P; ++i) {\n",
     "  for (int i = 0; i < P; ++i) {\n    long long t0 = clock64();\n"),
    ("    __syncthreads();\n\n    const float* srow",
     "    __syncthreads();\n    long long t1 = clock64();\n\n"
     "    const float* srow"),
    ("    best = block_best(best, warp_slots);\n",
     "    __syncthreads();\n    long long t2 = clock64();\n"
     "    best = block_best(best, warp_slots);\n    long long t3 = clock64();\n"),
    ("    grid.sync();\n", "    grid.sync();\n    long long t4 = clock64();\n"),
    ("    w = block_best(w, warp_slots);\n",
     "    w = block_best(w, warp_slots);\n    long long t5 = clock64();\n"),
    ("    __syncthreads();\n  }\n",
     "    __syncthreads();\n    long long t6 = clock64();\n"
     "    acc[0] += t1 - t0; acc[1] += t2 - t1; acc[2] += t3 - t2;\n"
     "    acc[3] += t4 - t3; acc[4] += t5 - t4; acc[5] += t6 - t5;\n  }\n"),
    ("      free_after[static_cast<size_t>(lo + j) * R + r] = "
     "free_s[r * slice + j];\n}",
     "      free_after[static_cast<size_t>(lo + j) * R + r] = "
     "free_s[r * slice + j];\n" + _epilogue("threadIdx.x == 0", "0") + "}"),
]

# The exchange kernel: lane 0 of the exchange warp and of scan warp 1.
EXCHANGE_PHASES = {0: "exchange warp: publish + poll",
                   1: "exchange warp: wait look-ahead + gather",
                   2: "exchange warp: debit + fix-up + arrive",
                   3: "scan warp: issue ring copies",
                   4: "scan warp: cp.async wait",
                   5: "scan warp: wait for the debit",
                   6: "scan warp: scan loop", 7: "scan warp: warp_best",
                   8: "scan warp: put + arrive", 9: "rescans"}
EXCHANGE_EDITS = [
    ("float* __restrict__ free_after, uint64_t* slots) {",
     "float* __restrict__ free_after, uint64_t* slots, long long* stamps) {\n"
     + _PROLOGUE),
    ("    const float* rq = req_s[pod % kStages];\n    Best best = kEmpty;\n",
     "    const long long p0 = clock64();\n"
     "    const float* rq = req_s[pod % kStages];\n    Best best = kEmpty;\n"),
    ("      if (better(t, best)) best = t;\n    }\n    return warp_best(best);\n",
     "      if (better(t, best)) best = t;\n    }\n"
     "    const long long p1 = clock64();\n"
     "    const Best wb = warp_best(best);\n"
     "    acc[6] += p1 - p0;\n    acc[7] += clock64() - p1;\n"
     "    return wb;\n"),
    ("      if (rescan) {\n        bar_sync(kBarRescan);",
     "      const long long t0 = clock64();\n"
     "      if (rescan) {\n        acc[9] += 1;\n        bar_sync(kBarRescan);"),
    ("      const uint64_t key = poll(buf, nblocks, tag);\n",
     "      const uint64_t key = poll(buf, nblocks, tag);\n"
     "      const long long t1 = clock64();\n"),
    ("      Best next = gather(look_s);  // pod i+1, free before pod i's "
     "debit\n",
     "      Best next = gather(look_s);  // pod i+1, free before pod i's "
     "debit\n      const long long t2 = clock64();\n"),
    ("        bar_arrive(kBarDebit);\n      }\n      pend = next;\n",
     "        bar_arrive(kBarDebit);\n      }\n"
     "      acc[0] += t1 - t0; acc[1] += t2 - t1; acc[2] += clock64() - t2;\n"
     "      pend = next;\n"),
    ("      cp_async_wait<kStages - 4>();  // pods up to i+1\n"
     "      if (i > 0) bar_sync(kBarDebit);  // pod i-1 debited\n",
     "      const long long u1 = clock64();\n"
     "      cp_async_wait<kStages - 4>();  // pods up to i+1\n"
     "      const long long u2 = clock64();\n"
     "      if (i > 0) bar_sync(kBarDebit);  // pod i-1 debited\n"
     "      acc[4] += u2 - u1; acc[5] += clock64() - u2;\n"),
    ("      put(look_s, i + 1 < P ? scan(i + 1) : kEmpty);\n"
     "      bar_arrive(kBarLook);\n"
     "      issue(i + kStages - 2);  // after the scan: its loads do not "
     "queue behind\n",
     "      const Best nx = i + 1 < P ? scan(i + 1) : kEmpty;\n"
     "      const long long u4 = clock64();\n"
     "      put(look_s, nx);\n      bar_arrive(kBarLook);\n"
     "      const long long u5 = clock64();\n"
     "      issue(i + kStages - 2);\n"
     "      acc[8] += u5 - u4; acc[3] += clock64() - u5;\n"),
    ("  __syncthreads();\n  for (int k = tid; k < width * R; k += kThreads) {\n"
     "    const int j = k / R;\n    free_after",
     _epilogue("tid == 0 || tid == 32", "tid == 32")
     + "  __syncthreads();\n  for (int k = tid; k < width * R; k += kThreads) {\n"
     "    const int j = k / R;\n    free_after"),
]
LAUNCH_EDITS = [
    ("                                    void* stream) {",
     "                                    void* stream, long long* stamps) {"),
    ("&free_after, &slots};", "&free_after, &slots, &stamps};"),
]


def build(name: str, src: str, stamped: bool = False):
    digest = hashlib.sha256(src.encode()).hexdigest()[:12]
    os.makedirs(BUILD, exist_ok=True)
    cu = os.path.join(BUILD, f"{name}-{digest}.cu")
    so = cu[:-3] + ".so"
    if not os.path.exists(so):
        with open(cu, "w") as f:
            f.write(src)
        p = subprocess.run([_cuda_build._nvcc(), *_cuda_build.NVCC_FLAGS,
                            "-o", so, cu], capture_output=True, text=True)
        if p.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{p.stderr}")
    lib = ctypes.CDLL(so)
    fn = lib.greedy_assign_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_uint32] + [ctypes.c_int] * 3
                   + [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]
                   + [ctypes.c_void_p] * stamped)
    return fn


def launch(fn, scores, req, free, seed, *stamps) -> AssignResult:
    P, N = scores.shape
    R = req.shape[1]
    dev = scores.device
    chosen = torch.empty((P,), dtype=torch.int32, device=dev)
    assigned = torch.empty((P,), dtype=torch.bool, device=dev)
    free_after = torch.empty((N, R), dtype=torch.float32, device=dev)
    scratch = torch.zeros((2 * MAX_BLOCKS * SLOT_BYTES,), dtype=torch.uint8,
                          device=dev)
    err = fn(scores.data_ptr(), req.data_ptr(), free.data_ptr(), seed, P, N,
             R, chosen.data_ptr(), assigned.data_ptr(), free_after.data_ptr(),
             scratch.data_ptr(), MAX_BLOCKS,
             torch.cuda.current_stream().cuda_stream, *stamps)
    if err:
        raise SystemExit(f"launch failed: cudaError {err}")
    return AssignResult(chosen, assigned, free_after)


def split(name, src, args, seed, smi):
    kind = "barrier" if "grid.sync()" in src else "exchange"
    edits = (BARRIER_EDITS if kind == "barrier" else EXCHANGE_EDITS)
    fn = build(name + "-stamped", edit(src, edits + LAUNCH_EDITS),
               stamped=True)
    phases = BARRIER_PHASES if kind == "barrier" else EXCHANGE_PHASES
    P = args[0].shape[0]
    stamps = torch.zeros((MAX_BLOCKS, 2, STAMPS), dtype=torch.int64,
                         device="cuda")
    ms = cs.cuda_ms(lambda: launch(fn, *args, seed, stamps.data_ptr()),
                    reps=5)
    stamps.zero_()
    cs.compare(launch(fn, *args, seed, stamps.data_ptr()),
               greedy_assign_plain(*args, seed))
    st = stamps.cpu().numpy().astype(np.float64)
    st = st[st[:, 0, 14] > 0]
    ghz = st[:, 0, 14] / st[:, 0, 15]  # cycles per ns
    print(f"  split of {name} (stamped copy {ms:.4f} ms, {len(st)} blocks, "
          f"SM clock {ghz.mean():.3f} GHz) ({smi})")
    for k, label in phases.items():
        w = 1 if label.startswith("scan warp") else 0
        if label == "rescans":
            print(f"    rescans: {st[:, 0, k].sum():.0f} in all blocks")
            continue
        us = st[:, w, k] / ghz / 1e3 / P
        print(f"    {label:42s} mean {us.mean():.4f} min {us.min():.4f} "
              f"max {us.max():.4f} us/pod")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", help="another kernel source, same interface")
    ap.add_argument("--variants", default="",
                    help=f"comma-separated, of {sorted(VARIANTS)}")
    ap.add_argument("--split", action="store_true")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("FAILED: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    with open(_cuda_build.source("greedy_assign")) as f:
        pkg_src = f.read()
    builds = {"package": (pkg_src, build("package", pkg_src))}
    if opts.other:
        with open(opts.other) as f:
            other_src = f.read()
        builds["other"] = (other_src, build("other", other_src))
    for v in filter(None, opts.variants.split(",")):
        src = edit(pkg_src, VARIANTS[v])
        builds[v] = (src, build(v, src))

    seed = prng.bits(prng.fold_in(prng.PRNGKey(0), 1))
    nodes, pods = cs.bench_workload(cs.N_NODES, cs.N_PODS)
    eb, nf, af = cs.full_width_batch(nodes, pods)
    eb_d, nf_d, af_d = (to_torch(x, "cuda") for x in (eb, nf, af))
    scores, _fc, _rc = evaluate(cs.BENCH_PROFILE.build(), eb_d, nf_d, af_d)
    P, N = scores.shape
    batches = {"bench": (scores, eb_d.pf.requests.contiguous(),
                         nf_d.free.contiguous()),
               "scarce": tuple(torch.from_numpy(a).cuda() for a in
                               scarce_case(np.random.default_rng(0), P, N))}
    middle = [b for b in builds if b not in ("package", "other")]
    order = (["other"] if opts.other else []) + ["package", *middle,
                                                  "package"] + (
        ["other"] if opts.other else [])
    for name, args in batches.items():
        plain = greedy_assign_plain(*args, seed)
        for b, (_src, fn) in builds.items():
            cs.compare(launch(fn, *args, seed), plain)
        times = [(b, cs.cuda_ms(lambda fn=builds[b][1]: launch(fn, *args,
                                                              seed), reps=20))
                 for b in order]
        print(f"{name} {P}x{N}x{args[1].shape[1]}: every build = plain "
              f"bitwise ({int(plain.assigned.sum())} assigned); "
              + ", ".join(f"{b} {ms:.4f} ms ({ms * 1e3 / P:.3f} us/pod)"
                          for b, ms in times) + f" ({smi})")
        if opts.split:
            for b in ("other", "package"):
                if b in builds:
                    split(b, builds[b][0], args, seed, smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())

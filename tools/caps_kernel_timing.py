"""Time the CUDA caps scan kernel (csrc/caps_scan.cu) against another
build of it, in turns, and split its time per pod by phase. Needs a CUDA
card and nvcc.

    python tools/caps_kernel_timing.py [--other OLD.cu] [--split]

Input: config 4 hard at full width, as chip_smoke.py's caps phase builds
it (chip_smoke.c4_hard_problem: the first 1,024 pods of
c4_workload(50,000, 10,000, max_skew=1, hard=True), scored by the
config-4 profile with the caps' groups deferred to the scan, 1024 x
53248), and tests/torch_parity.py's "multi-block" caps problem (512 pods
over 3,000 nodes in a pad of 4,096). Every build is first held bitwise
against the plain version (chosen, assigned, free_after).

--other  a kernel source with the same C interface (for instance an
         earlier commit's csrc/caps_scan.cu, extracted with `git show
         <commit>:minisched_tpu_torch/csrc/caps_scan.cu` into a directory
         first: the chip machine has no git), built with the headers of
         its own directory; timed beside the package's kernel in turns:
         other, package, package, other (CUDA events, 10 launches each).
--split  a copy of each build with clock64 stamps on its phases
         (tools/split_timing.py), run once per input after a warm-up:
         mean, min and max over blocks of each phase in us per pod, and
         the look-ahead's fix-ups and rescans where the source has them.

Every build, the package's too, is launched here through caps_launch,
outside the package's wrapper, so no launch is counted in
_cuda_build.LAUNCHES.

Builds go to minisched_tpu_torch/_build/timing/ (gitignored).
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests"),
                os.path.dirname(os.path.abspath(__file__))]
import chip_smoke as cs  # noqa: E402
import split_timing as sp  # noqa: E402
from minisched_tpu_torch.ops import _cuda_build  # noqa: E402
from minisched_tpu_torch.ops.caps_kernel import _MAX_BLOCKS, bind  # noqa: E402
from minisched_tpu_torch.ops.select import (AssignResult,  # noqa: E402
                                            greedy_assign_plain)
from torch_parity import caps_problem  # noqa: E402

# Stamps for the per-pod loop of 0e0228d's kernel (no look-ahead): thread
# 0, which is in warp 0, the exchange warp, and scans like every thread.
PR7_PHASES = {0: "set-up before the loop", 1: "copy issue + slice scan",
              2: "warp_best + barrier C", 3: "reduce, publish, poll",
              4: "debit, count update, minima",
              5: "wait for copies + barrier D"}
PR7_EDITS = [
    ("  const int nwords = (H + kGroupsPerWord - 1) / kGroupsPerWord;\n",
     "  const int nwords = (H + kGroupsPerWord - 1) / kGroupsPerWord;\n"
     "  long long _st;\n  st_open(_st);\n"),
    ("  for (int i = 0; i < P; ++i) {\n    // Pod i's inputs landed",
     "  st_mark(_st, 0);\n"
     "  for (int i = 0; i < P; ++i) {\n    // Pod i's inputs landed"),
    ("    best = warp_best(best);\n    if (lane == 0) {\n",
     "    st_mark(_st, 1);\n"
     "    best = warp_best(best);\n    if (lane == 0) {\n"),
    ("    __syncthreads();  // (C)\n",
     "    __syncthreads();  // (C)\n    st_mark(_st, 2);\n"),
    ("      const uint64_t key = poll(kbuf, dbuf, nblocks, nwords, tag, dom);\n",
     "      const uint64_t key = poll(kbuf, dbuf, nblocks, nwords, tag, dom);\n"
     "      st_mark(_st, 3);\n"),
    ("    cp_async_wait_all();  // this thread's copies of pod i+1\n",
     "    st_mark(_st, 4);\n"
     "    cp_async_wait_all();  // this thread's copies of pod i+1\n"),
    ("    __syncthreads();  // (D) counts, minima and free updated\n",
     "    __syncthreads();  // (D) counts, minima and free updated\n"
     "    st_mark(_st, 5);\n"),
    ("  }\n}\n\n}  // namespace\n", "  }\n  st_close();\n}\n\n}  // namespace\n"),
]
# Stamps for the look-ahead kernel: thread 0, in the exchange warp, and
# thread 32, in the first scan warp.
LOOK_PHASES = {0: "set-up + pod 0's scan", 1: "wait for a rescan",
               2: "(publish after a rescan) + poll",
               3: "wait for the look-ahead + gather",
               4: "debit + the update's effect", 5: "candidate + fix-ups",
               14: "publish + apply the update",
               6: "scan warp: wait for copies",
               7: "scan warp: wait for the update",
               8: "scan warp: rescan (its reduction and barrier)",
               16: "scan warp: the columns' loop (rescans and look-aheads)",
               9: "scan warp: look-ahead reduction, put and arrive",
               13: "scan warp: issue copies"}
LOOK_COUNTS = {10: "rescans", 11: "p2 taken (p1's domain closed)",
               12: "pods whose update raised a minimum"}
LOOK_EDITS = [
    ("  const uint32_t neg_key = score_key(kNeg);\n",
     "  const uint32_t neg_key = score_key(kNeg);\n"
     "  long long _st;\n  st_open(_st);\n"),
    ("    Best pend = gather(rescan_s).b1;\n"
     "    bool rescan = false, published = false;\n",
     "    Best pend = gather(rescan_s).b1;\n"
     "    bool rescan = false, published = false;\n    st_mark(_st, 0);\n"),
    ("      if (rescan) {\n        bar_sync(kBarRescan);\n"
     "        pend = gather(rescan_s).b1;\n      }\n",
     "      if (rescan) {\n        st_count(10);\n        bar_sync(kBarRescan);\n"
     "        pend = gather(rescan_s).b1;\n      }\n      st_mark(_st, 1);\n"),
    ("      bar_sync(kBarLook);\n"
     "      const Pair next = gather(look_s);  // pod i+1, before pod i's update\n",
     "      st_mark(_st, 2);\n      bar_sync(kBarLook);\n"
     "      const Pair next = gather(look_s);  // pod i+1, before pod i's update\n"
     "      st_mark(_st, 3);\n"),
    ("      const uint32_t risen = __ballot_sync(kFull, holder && atmin_s[lane] == 1);\n",
     "      const uint32_t risen = __ballot_sync(kFull, holder && atmin_s[lane] == 1);\n"
     "      if (risen) st_count(12);\n"),
    ("      // Pod i+1's candidate from the look-ahead.",
     "      st_mark(_st, 4);\n      // Pod i+1's candidate from the look-ahead."),
    ("          if (closed && dom_of(next.b1) == dw) cand = next.b2;\n",
     "          if (closed && dom_of(next.b1) == dw) {\n"
     "            cand = next.b2;\n            st_count(11);\n          }\n"),
    ("        // Publish pod i+1 first:",
     "        st_mark(_st, 5);\n        // Publish pod i+1 first:"),
    ("        if (lane == 0) rescan_flag = rescan;\n"
     "        bar_arrive(kBarDebit);\n",
     "        if (lane == 0) rescan_flag = rescan;\n"
     "        st_mark(_st, 14);\n        bar_arrive(kBarDebit);\n"),
    ("      cp_async_wait<kStages - 5>();  // pods up to i+2\n"
     "      if (i > 0) bar_sync(kBarDebit);  // pod i-1's update applied\n",
     "      cp_async_wait<kStages - 5>();  // pods up to i+2\n"
     "      st_mark(_st, 6, 32);\n"
     "      if (i > 0) bar_sync(kBarDebit);  // pod i-1's update applied\n"
     "      st_mark(_st, 7, 32);\n"),
    ("        put(rescan_s, scan(i));\n        bar_arrive(kBarRescan);\n"
     "      }\n",
     "        put(rescan_s, scan(i));\n        bar_arrive(kBarRescan);\n"
     "      }\n      st_mark(_st, 8, 32);\n"),
    ("      bar_arrive(kBarLook);\n      issue(i + kStages - 2);",
     "      bar_arrive(kBarLook);\n      st_mark(_st, 9, 32);\n"
     "      issue(i + kStages - 2);"),
    ("queue behind\n    }\n  }\n",
     "queue behind\n      st_mark(_st, 13, 32);\n    }\n  }\n"),
    ("      best = add(best, t);\n    }\n    return warp_pair(best);\n",
     "      best = add(best, t);\n    }\n    st_mark(_st, 16, 32);\n"
     "    return warp_pair(best);\n"),
    PR7_EDITS[-1],
]
SPLITS = {"(C)": (PR7_EDITS, PR7_PHASES, {}),
          "const Pair next = gather(look_s);": (LOOK_EDITS, LOOK_PHASES,
                                          LOOK_COUNTS)}


def build(name: str, files, stamp: bool = False):
    """The library of ``files`` (caps_scan.cu and its directory's
    headers), or of its stamped copy: (library, phases, counts); None for
    a stamped copy that no stamp edits fit."""
    phases = counts = None
    if stamp:
        for anchor, (edits, phases, counts) in SPLITS.items():
            if anchor in files["caps_scan.cu"]:
                files = sp.stamped(files, {"caps_scan.cu": edits})
                break
        else:
            print(f"no stamp edits fit the {name} source: not split")
            return None
    lib = sp.build(f"caps-{name}{'-stamped' if stamp else ''}", files,
                   "caps_scan.cu", bind)
    return lib, phases, counts


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


def check(got, plain, what) -> None:
    for f in ("chosen", "assigned", "free_after"):
        if not torch.equal(cs.bits(getattr(got, f)),
                           cs.bits(getattr(plain, f))):
            raise SystemExit(f"FAILED: {what}: {f} != plain")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", help="another kernel source, same interface")
    ap.add_argument("--split", action="store_true",
                    help="split each build per phase (stamped copies)")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("FAILED: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    sources = {"package": sp.read_dir(_cuda_build.CSRC_DIR)}
    if opts.other:
        sources["other"] = sp.read_dir(os.path.dirname(
            os.path.abspath(opts.other)))
        with open(opts.other) as f:
            sources["other"]["caps_scan.cu"] = f.read()
    builds = {b: build(b, files)[0] for b, files in sources.items()}
    stamped = {}
    if opts.split:
        stamped = {b: out for b, out in ((b, build(b, files, stamp=True))
                                         for b, files in sources.items())
                   if out is not None}
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
            check(caps_launch(lib, scores, req, free, seed, caps), plain,
                  f"{b} {name}")
        P, N = scores.shape
        times = [(b, cs.cuda_ms(lambda lib=builds[b]: caps_launch(
            lib, scores, req, free, seed, caps), reps=10))
            for b in order]
        print(f"{name} {P}x{N}x{req.shape[1]}: every build = plain bitwise "
              f"({int(plain.assigned.sum())} assigned); "
              + ", ".join(f"{b} {ms:.4f} ms ({ms * 1e3 / P:.3f} us/pod)"
                          for b, ms in times) + f" ({smi})", flush=True)
        for b, (lib, phases, counts) in stamped.items():
            stamps = sp.Stamps(lib)
            caps_launch(lib, scores, req, free, seed, caps)
            stamps.zero()
            check(caps_launch(lib, scores, req, free, seed, caps), plain,
                  f"{b} stamped {name}")
            st, ghz = stamps.read()
            print("\n".join(sp.report(
                f"{b} on {name} ({smi})", st, ghz,
                {k: (v, P) for k, v in phases.items()}, counts, "/pod")),
                flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

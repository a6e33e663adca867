"""Time the shortlist stage on one CUDA card: the CUDA shortlist scan
kernel beside other builds of it, and the CUDA selection kernel beside
shortlist_select_plain by part.

    python tools/shortlist_timing.py [--other OLD.cu ...]
                                     [--variants stages8,producers8]
                                     [--split] [--other-select OLD.cu]
                                     [--split-select]
                                     [--other-ports OLD.cu]

Inputs: the bench workload's first full-width batch (1024 pods x 53248
nodes x R=10, as chip_smoke.py builds it, K=128) and a contention batch
of the same shape (tests/test_shortlist.py's contention recipe: every
node starved but N/64, so about one pod in eight repairs). Every build
is first held bitwise against the plain version on all four outputs.

--other     a scan kernel source with the same C interface (for instance
            an earlier commit's csrc/shortlist_scan.cu, written out with
            ``git show <commit>:minisched_tpu_torch/csrc/shortlist_scan.cu``
            on a machine with git), repeatable;
--variants  named edits of the package's scan source (VARIANTS below);
            every build is timed beside the package's kernel in turns:
            others, package, package, others reversed (CUDA events, 20
            launches each);
--split     a copy of the package's scan with clock64 stamps (SPLIT):
            the walker's cycles per pod waiting for a full stage, on the
            candidates, on the reduction and certificate, on the debit,
            outputs and release, in repairs and in all; a producer warp's
            cycles waiting for an empty stage and in all.

--other-select  a selection kernel source with the same C interface
            (for instance an earlier commit's csrc/shortlist_select.cu),
            held bitwise against shortlist_select_plain and timed beside
            the package's selection in turns (CUDA events, 20 launches
            each), repeatable: on the bench batch at K=128 (the list
            path) and K=1000 (the exact path, row cached), and on a
            batch of +0.0 rows at K=128 (a signed zero at L: the exact
            path on the list path's cached row);
--split-select  a copy of the package's selection with clock64 stamps
            (SELECT_SPLIT): thread 0's cycles per row of the bench batch
            in pass 1 (and waiting for the row), L, pass 2 and the list;
--other-ports   a port-insertion kernel source with the same C interface,
            held bitwise against insert_ports_plain and timed beside the
            package's in turns at chip_smoke.py's port shapes (the
            engine's 128 bucket, a 1024-pod batch, 1024 pods on one row):
            device time from torch.profiler (the state copy and the
            kernel), and per call back to back with CUDA events.

The selection is timed as the kernel and as shortlist_select_plain's
parts (CUDA events, 10 calls each): the first top-k over the order key
(kth), the noise lattice, the composite key, the second top-k (cand),
and the whole plain function; one torch.topk of the scores beside them.

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
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402
from minisched_tpu_torch.encode import to_torch  # noqa: E402
from minisched_tpu_torch.ops import _cuda_build, prng  # noqa: E402
from minisched_tpu_torch.ops import residency as RES  # noqa: E402
from minisched_tpu_torch.ops import select as S  # noqa: E402
from minisched_tpu_torch.ops.pipeline import evaluate  # noqa: E402
from minisched_tpu_torch.ops.select_kernel import \
    shortlist_select_cuda  # noqa: E402
from minisched_tpu_torch.ops.ports_kernel import \
    _bind as bind_ports  # noqa: E402
from minisched_tpu_torch.ops.select_kernel import \
    _bind as bind_select  # noqa: E402
from minisched_tpu_torch.ops.shortlist_kernel import _bind  # noqa: E402

BUILD = os.path.join(ROOT, "minisched_tpu_torch", "_build", "timing")
FIELDS = ("chosen", "assigned", "free_after", "repaired")

VARIANTS = {
    # A ring of at most 8 stages.
    "stages8": [("constexpr int kMaxStages = 32;",
                 "constexpr int kMaxStages = 8;")],
    # Eight producer warps, seven helpers.
    "producers8": [("constexpr int kProducerWarps = 4;",
                    "constexpr int kProducerWarps = 8;")],
}

# The stamps of --split (cycles summed over the pods): the walker's
# [0] wait for a full stage, [1] repairs, [2] all, [3] candidates, of
# which [8] the best candidate's check, [9] the pods that looked at every
# candidate (a count), [6] reduction and certificate, [7] debit, outputs
# and release (repairs included); producer warp 0's [4] wait for an empty
# stage, [5] all.
SPLIT = [
    ("struct Best {", "__device__ long long g_stamps[10];\n\nstruct Best {"),
    ("  int nc[kQ];\n  float ns[kQ];\n",
     "  int nc[kQ];\n  float ns[kQ];\n"
     "  long long pe = 0;\n  const long long p0 = clock64();\n"),
    ("    if (round > 0) mbar_wait(&empty[s], (round - 1) & 1);\n",
     "    const long long e0 = clock64();\n"
     "    if (round > 0) mbar_wait(&empty[s], (round - 1) & 1);\n"
     "    pe += clock64() - e0;\n"),
    ("      ++round;\n    }\n  }\n}\n",
     "      ++round;\n    }\n  }\n"
     "  if (w == 0 && lane == 0) {\n    g_stamps[4] = pe;\n"
     "    g_stamps[5] = clock64() - p0;\n  }\n}\n"),
    ("    const uint32_t kneg = score_key(kNeg);\n",
     "    const uint32_t kneg = score_key(kNeg);\n"
     "    long long aw = 0, ar = 0, ac = 0, ab = 0, ad = 0;\n"
     "    long long ad0 = 0, ad1 = 0;\n"
     "    const long long a0 = clock64();\n"),
    ("      mbar_wait(&s_full[s], phase);\n",
     "      const long long w0 = clock64();\n"
     "      mbar_wait(&s_full[s], phase);\n"
     "      aw += clock64() - w0;\n"),
    ("      const float kth_i = st.bound[0], kthn_i = st.bound[1];\n",
     "      const float kth_i = st.bound[0], kthn_i = st.bound[1];\n"
     "      const long long c0 = clock64();\n"),
    ("      if (!top_fits) {\n        auto consider",
     "      ad0 += clock64() - c0;\n      ad1 += !top_fits;\n"
     "      if (!top_fits) {\n        auto consider"),
    ("      Best w = top_fits ? best : warp_best(best);\n",
     "      const long long c1 = clock64();\n      ac += c1 - c0;\n"
     "      Best w = top_fits ? best : warp_best(best);\n"),
    ("      if (certified) {\n        if (ok && best.col",
     "      const long long c2 = clock64();\n      ab += c2 - c1;\n"
     "      if (certified) {\n        if (ok && best.col"),
    ("        mbar_arrive(&s_empty[s]);\n      }\n",
     "        mbar_arrive(&s_empty[s]);\n      }\n"
     "      ad += clock64() - c2;\n"),
    ("        __syncwarp();\n        bar_sync(kBarPost, kRepairThreads);\n"
     "        w = repair_pick",
     "        const long long r0 = clock64();\n        __syncwarp();\n"
     "        bar_sync(kBarPost, kRepairThreads);\n        w = repair_pick"),
    ("        ok = w.skey > kneg;\n        if (ok && lane == 0) {",
     "        ok = w.skey > kneg;\n        ar += clock64() - r0;\n"
     "        if (ok && lane == 0) {"),
    ("    if (lane == 0) s_post[0] = -1;\n",
     "    if (lane == 0) {\n      g_stamps[0] = aw;\n      g_stamps[1] = ar;\n"
     "      g_stamps[2] = clock64() - a0;\n      g_stamps[3] = ac;\n"
     "      g_stamps[6] = ab;\n      g_stamps[7] = ad;\n"
     "      g_stamps[8] = ad0;\n      g_stamps[9] = ad1;\n    }\n"
     "    if (lane == 0) s_post[0] = -1;\n"),
    ('extern "C" const char* shortlist_scan_error_string',
     'extern "C" int shortlist_scan_stamps(long long* out) {\n'
     "  return cudaMemcpyFromSymbol(out, g_stamps, sizeof(g_stamps));\n}\n\n"
     'extern "C" const char* shortlist_scan_error_string'),
]


# The stamps of --split-select (thread 0's cycles summed over the list
# path's rows): [0] pass 1, of which [4] waiting for the row's chunks,
# [1] L and the sums, [2] pass 2 (compaction, a rebuild), the list: [6]
# kth and the composite keys, [7] their sort, [3] the outputs; [5] the
# rows.
SELECT_SPLIT = [
    ("__global__ void __launch_bounds__(kThreads, 1)\n"
     "    shortlist_select_kernel(",
     "__device__ unsigned long long g_stamps[8];\n\n"
     "__global__ void __launch_bounds__(kThreads, 1)\n"
     "    shortlist_select_kernel("),
    ("  uint32_t parity = 0;\n",
     "  uint32_t parity = 0;\n"
     "  unsigned long long st[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n"
     "  long long c0 = 0, w0 = 0;\n"),
    ("    uint32_t mx = 0, cm = 0;\n",
     "    uint32_t mx = 0, cm = 0;\n    c0 = clock64();\n"),
    ("      if (cached) mbar_wait(&sh.bar[c], parity);\n",
     "      w0 = clock64();\n"
     "      if (cached) mbar_wait(&sh.bar[c], parity);\n"
     "      st[4] += clock64() - w0;\n"),
    ("    // L: the K-th largest thread maximum",
     "    st[0] += clock64() - c0;\n    c0 = clock64();\n"
     "    // L: the K-th largest thread maximum"),
    ("    // Pass 2: the list of every node above L",
     "    st[1] += clock64() - c0;\n    c0 = clock64();\n"
     "    // Pass 2: the list of every node above L"),
    ("    if (!ok) {\n      select_exact(",
     "    st[2] += clock64() - c0;\n    c0 = clock64();\n"
     "    if (!ok) {\n      select_exact("),
    ("    __syncthreads();\n    sort_list(lkeys, lpay, n);\n",
     "    __syncthreads();\n"
     "    st[6] += clock64() - c0;\n    c0 = clock64();\n"
     "    sort_list(lkeys, lpay, n);\n"
     "    st[7] += clock64() - c0;\n    c0 = clock64();\n"),
    ("    __syncthreads();\n  }\n}\n\n// The device's attributes",
     "    __syncthreads();\n    st[3] += clock64() - c0;\n    st[5] += 1;\n"
     "  }\n  if (tid == 0)\n"
     "    for (int q = 0; q < 8; ++q) atomicAdd(&g_stamps[q], st[q]);\n"
     "}\n\n// The device's attributes"),
    ('extern "C" const char* shortlist_select_error_string',
     'extern "C" int shortlist_select_stamps(unsigned long long* out) {\n'
     "  return cudaMemcpyFromSymbol(out, g_stamps, 8 * 8);\n}\n\n"
     'extern "C" const char* shortlist_select_error_string'),
]


def edit(src: str, pairs) -> str:
    for old, new in pairs:
        if src.count(old) != 1:
            raise SystemExit(f"edit anchor not found once: {old!r}")
        src = src.replace(old, new)
    return src


def _bind_solo_scan(lib: ctypes.CDLL) -> None:
    """The scan's C interface before the lane axis (PR 14 and earlier)."""
    fn = lib.shortlist_scan_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_uint32]
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 5)


def _bind_solo_select(lib: ctypes.CDLL) -> None:
    """The selection's C interface before the lane axis."""
    fn = lib.shortlist_select_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_uint32] + [ctypes.c_int] * 3
                   + [ctypes.c_void_p] * 5)


# A source without the lane axis binds its own, older interface.
_SOLO_BINDS = {_bind: _bind_solo_scan, bind_select: _bind_solo_select}


def build(name: str, src: str, bind=_bind) -> ctypes.CDLL:
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
    lib.lanes = "const uint32_t* seeds" in src
    (bind if lib.lanes else _SOLO_BINDS.get(bind, bind))(lib)
    return lib


def builds_of(kernel: str, others, bind):
    """The package's source of ``kernel`` and each other source, built;
    the names in turns: others, package, package, others reversed."""
    src = open(_cuda_build.source(kernel)).read()
    libs = {"package": build(f"{kernel}-package", src, bind)}
    for path in others:
        name = os.path.splitext(os.path.basename(path))[0]
        libs[name] = build(f"{kernel}-{name}", open(path).read(), bind)
    names = [n for n in libs if n != "package"]
    return libs, names + ["package", "package"] + names[::-1]


def checked(err: int) -> None:
    if err not in (0, _cuda_build.NO_LAUNCH):
        raise SystemExit(f"launch failed: cudaError {err}")


def select_launch(lib, scores, seed, k):
    P, N = scores.shape
    dev = scores.device
    out = (torch.empty((P, k), dtype=torch.int32, device=dev),
           torch.empty((P,), device=dev), torch.empty((P,), device=dev),
           torch.empty((P, k), device=dev))
    lanes = (None, seed & 0xFFFFFFFF, 1) if lib.lanes else (
        seed & 0xFFFFFFFF,)
    checked(lib.shortlist_select_launch(
        scores.data_ptr(), *lanes, P, N, k,
        *(t.data_ptr() for t in out), torch.cuda.current_stream().cuda_stream))
    return out


def ports_launch(lib, state, rows, ports):
    out = torch.empty_like(state)
    checked(lib.insert_ports_launch(
        state.data_ptr(), rows.data_ptr(), ports.data_ptr(), state.shape[0],
        state.shape[1], ports.shape[0], ports.shape[1], out.data_ptr(),
        torch.cuda.current_stream().cuda_stream))
    return out


def select_ab(others, scores, seed, smi):
    """The package's selection beside other sources, bitwise against the
    plain version, then in turns: the bench batch at K=128 and K=1000,
    and a batch of +0.0 rows at K=128."""
    libs, order = builds_of("shortlist_select", others, bind_select)
    for label, sc, k in (("bench", scores, cs.K),
                         ("bench", scores, 1000),
                         ("+0.0 rows", torch.zeros_like(scores), cs.K)):
        want = S.shortlist_select_plain(sc, seed, k)
        want = (*want, torch.gather(sc, 1, want[0].long()))
        for name, lib in libs.items():
            for a, b in zip(select_launch(lib, sc, seed, k), want):
                if not torch.equal(cs.bits(a), cs.bits(b)):
                    raise SystemExit(f"selection {name} differs from plain "
                                     f"({label}, K={k})")
        P, N = sc.shape
        times = [(b, cs.cuda_ms(lambda lib=libs[b]: select_launch(
            lib, sc, seed, k), reps=20)) for b in order]
        print(f"selection A/B {label} {P}x{N} K={k}: every build = plain "
              f"bitwise; " + ", ".join(f"{b} {ms:.4f} ms" for b, ms in times)
              + f" ({smi})")


def select_split(scores, seed, k, smi):
    """One stamped launch of the selection: thread 0's cycles per row."""
    src = edit(open(_cuda_build.source("shortlist_select")).read(),
               SELECT_SPLIT)
    lib = build("shortlist_select-split", src, bind_select)
    select_launch(lib, scores, seed, k)
    torch.cuda.synchronize()
    out = (ctypes.c_ulonglong * 8)()
    lib.shortlist_select_stamps.restype = ctypes.c_int
    if lib.shortlist_select_stamps(out):
        raise SystemExit("reading the stamps failed")
    st = list(out)
    rows = max(st[5], 1)
    print(f"split selection {tuple(scores.shape)} K={k}: {st[5]} rows on "
          f"the list path; cycles per row: pass 1 {st[0] / rows:.0f} (of "
          f"which waiting for the row {st[4] / rows:.0f}), L and sums "
          f"{st[1] / rows:.0f}, pass 2 {st[2] / rows:.0f}, list "
          f"{(st[6] + st[7] + st[3]) / rows:.0f} (kth and keys "
          f"{st[6] / rows:.0f}, sort {st[7] / rows:.0f}, outputs "
          f"{st[3] / rows:.0f}) ({smi})")


def ports_ab(others, N, smi):
    """The package's port insertion beside other sources at chip_smoke's
    port shapes, bitwise against the plain version, then in turns."""
    libs, order = builds_of("insert_ports", others, bind_ports)
    for name, state, rows, ports in cs.port_cases(
            N, np.random.default_rng(6)):
        args = [torch.from_numpy(a).cuda() for a in (state, rows, ports)]
        want = RES.insert_ports_plain(*args)
        for b, lib in libs.items():
            if not torch.equal(ports_launch(lib, *args), want):
                raise SystemExit(f"port insertion {b} differs ({name})")
        times = [(b, cs.device_ms(lambda lib=libs[b]: ports_launch(
            lib, *args), reps=20), cs.cuda_ms(lambda lib=libs[b]: ports_launch(
                lib, *args), reps=20)) for b in order]
        print(f"port insertion A/B {name}: {int((rows >= 0).sum())} pods in "
              f"a bucket of {len(rows)} x {ports.shape[1]} ports into "
              f"{N}x{state.shape[1]}: every build = plain bitwise; device "
              f"time (copy and kernel; per call back to back): "
              + ", ".join(f"{b} {dev:.4f} ms ({call:.4f})"
                          for b, dev, call in times) + f" ({smi})")


def launch(lib, scores, sel, cand_scores, req, free, seed):
    P, N = scores.shape
    K, R = sel[0].shape[1], req.shape[1]
    dev = scores.device
    out = S.ShortlistAssignResult(
        torch.empty((P,), dtype=torch.int32, device=dev),
        torch.empty((P,), dtype=torch.bool, device=dev),
        torch.empty((N, R), dtype=torch.float32, device=dev),
        torch.empty((P,), dtype=torch.bool, device=dev))
    err = lib.shortlist_scan_launch(
        scores.data_ptr(), sel[0].data_ptr(), cand_scores.data_ptr(),
        sel[1].data_ptr(), sel[2].data_ptr(), req.data_ptr(),
        free.data_ptr(), *((None, seed, 1) if lib.lanes else (seed,)),
        P, N, K, R, out.chosen.data_ptr(),
        out.assigned.data_ptr(), out.free_after.data_ptr(),
        out.repaired.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err:
        raise SystemExit(f"launch failed: cudaError {err}")
    return out


def select_parts(scores, seed, k, smi):
    """CUDA-event times of the selection kernel, of one torch.topk, and of
    shortlist_select_plain's parts as that function computes them."""
    P, N = scores.shape
    cols = torch.arange(N, dtype=torch.int64, device=scores.device)[None, :]
    rows = torch.arange(P, dtype=torch.int64, device=scores.device)[:, None]

    def lattice():
        x = (cols * S._COL_MULT + seed + (rows * S.GOLDEN) % (1 << 32)) \
            & S._M32
        return S.fmix32(x) >> 8

    def first():
        kkey = torch.topk(S.order_key(scores), k, dim=1).values[:, -1]
        return S.order_key(kkey).view(torch.float32).contiguous()

    noise = lattice()
    kth = first()

    def key():
        kcol = kth[:, None]
        key2 = torch.where(scores > kcol, S._NOISE_ONE,
                           torch.where(scores == kcol, noise, -1))
        return key2 * (1 << 32) + (S._M32 - cols)

    key2 = key()
    parts = {
        "selection kernel": lambda: shortlist_select_cuda(scores, seed, k),
        "one torch.topk of the scores": lambda: torch.topk(scores, k, dim=1),
        "plain: first top-k (kth, order key)": first,
        "noise lattice": lattice,
        "composite key": key,
        "second top-k (cand)": lambda: torch.topk(key2, k, dim=1),
        "shortlist_select_plain": lambda: S.shortlist_select_plain(
            scores, seed, k),
    }
    print(f"selection {P}x{N} K={k}: " + ", ".join(
        f"{name} {cs.cuda_ms(fn, reps=10):.4f} ms"
        for name, fn in parts.items()) + f" ({smi})")


def split(lib, scores, sel, cand_scores, req, free, seed, label, smi):
    """One stamped launch: the walker's and a producer's cycles per pod."""
    P = scores.shape[0]
    launch(lib, scores, sel, cand_scores, req, free, seed)
    torch.cuda.synchronize()
    out = (ctypes.c_longlong * 10)()
    lib.shortlist_scan_stamps.restype = ctypes.c_int
    if lib.shortlist_scan_stamps(out):
        raise SystemExit("reading the stamps failed")
    st = list(out)
    print(f"split {label}: walker {st[2] / P:.0f} cycles per pod: waiting "
          f"for a full stage {st[0] / P:.0f}, candidates {st[3] / P:.0f} "
          f"(the best candidate {st[8] / P:.0f}, every candidate in "
          f"{st[9]} of {P} pods {(st[3] - st[8]) / max(st[9], 1):.0f} per "
          f"such pod), "
          f"reduction and certificate {st[6] / P:.0f}, debit, outputs and "
          f"release {(st[7] - st[1]) / P:.0f}, repairs {st[1] / P:.0f}; "
          f"producer warp 0 {st[5] / P:.0f} cycles per pod, of which "
          f"waiting for an empty stage {st[4] / P:.0f} ({smi})")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", action="append", default=[],
                    help="another kernel source, same interface")
    ap.add_argument("--variants", default="",
                    help=f"comma-separated, of {sorted(VARIANTS)}")
    ap.add_argument("--split", action="store_true")
    ap.add_argument("--other-select", action="append", default=[],
                    help="another selection kernel source, same interface")
    ap.add_argument("--split-select", action="store_true")
    ap.add_argument("--other-ports", action="append", default=[],
                    help="another port kernel source, same interface")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("FAILED: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    with open(_cuda_build.source("shortlist_scan")) as f:
        pkg_src = f.read()
    builds = {"package": build("package", pkg_src)}
    others = []
    for path in opts.other:
        name = os.path.splitext(os.path.basename(path))[0]
        with open(path) as f:
            builds[name] = build(name, f.read())
        others.append(name)
    for v in filter(None, opts.variants.split(",")):
        builds[v] = build(v, edit(pkg_src, VARIANTS[v]))
        others.append(v)
    order = others + ["package", "package"] + others[::-1]
    stamped = build("split", edit(pkg_src, SPLIT)) if opts.split else None

    seed = prng.bits(prng.fold_in(prng.PRNGKey(0), 1))
    nodes, pods = cs.bench_workload(cs.N_NODES, cs.N_PODS)
    eb, nf, af = cs.full_width_batch(nodes, pods)
    eb_d, nf_d, af_d = (to_torch(x, "cuda") for x in (eb, nf, af))
    scores, _fc, _rc = evaluate(cs.BENCH_PROFILE.build(), eb_d, nf_d, af_d)
    P, N = scores.shape
    R = eb_d.pf.requests.shape[1]
    batches = {"bench": (scores, eb_d.pf.requests.contiguous(),
                         nf_d.free.contiguous()),
               "contention": tuple(cs.shortlist_case(P, N, R, 3,
                                                     contend=True))}
    for name, (sc, req, free) in batches.items():
        cand, kth, kthn, cand_scores = shortlist_select_cuda(sc, seed, cs.K)
        sel = (cand, kth, kthn)
        plain = S.greedy_assign_shortlist_plain(sc, req, free, seed, *sel)
        for b, lib in builds.items():
            cs.compare(launch(lib, sc, sel, cand_scores, req, free, seed),
                       plain, FIELDS)
        times = [(b, cs.cuda_ms(lambda lib=builds[b]: launch(
            lib, sc, sel, cand_scores, req, free, seed), reps=20))
            for b in order]
        print(f"{name} {P}x{N}x{R} K={cs.K}: every build = plain bitwise "
              f"({int(plain.assigned.sum())} assigned, "
              f"{int(plain.repaired.sum())} repaired); "
              + ", ".join(f"{b} {ms:.4f} ms ({ms * 1e3 / P:.3f} us/pod)"
                          for b, ms in times) + f" ({smi})")
        if stamped is not None:
            split(stamped, sc, sel, cand_scores, req, free, seed, name, smi)
    select_parts(scores, seed, cs.K, smi)
    if opts.other_select:
        select_ab(opts.other_select, scores, seed, smi)
    if opts.split_select:
        select_split(scores, seed, cs.K, smi)
    if opts.other_ports:
        ports_ab(opts.other_ports, N, smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Time the shortlist stage on one CUDA card: the CUDA shortlist scan
kernel against another build of it, and shortlist_select by part.

    python tools/shortlist_timing.py [--other OLD.cu ...]

Inputs: the bench workload's first full-width batch (1024 pods x 53248
nodes x R=10, as chip_smoke.py builds it, K=128) and a contention batch
of the same shape (tests/test_shortlist.py's contention recipe: every
node starved but N/64, so about one pod in eight repairs). Every build
is first held bitwise against the plain version on all four outputs.

--other  a kernel source with the same C interface (for instance an
         earlier commit's csrc/shortlist_scan.cu), repeatable; each is
         timed beside the package's kernel in turns: others, package,
         package, others reversed (CUDA events, 20 launches each).

shortlist_select is split into its parts (CUDA events, 10 calls each):
the noise lattice, the first top-k (kth), the composite key, the second
top-k (cand), and the whole function.

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
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402
from minisched_tpu_torch.encode import to_torch  # noqa: E402
from minisched_tpu_torch.ops import _cuda_build, prng  # noqa: E402
from minisched_tpu_torch.ops import select as S  # noqa: E402
from minisched_tpu_torch.ops.pipeline import evaluate  # noqa: E402
from minisched_tpu_torch.ops.shortlist_kernel import _bind  # noqa: E402

BUILD = os.path.join(ROOT, "minisched_tpu_torch", "_build", "timing")
FIELDS = ("chosen", "assigned", "free_after", "repaired")


def build(name: str, src: str):
    digest = hashlib.sha256(src.encode()).hexdigest()[:12]
    os.makedirs(BUILD, exist_ok=True)
    cu = os.path.join(BUILD, f"scan-{name}-{digest}.cu")
    so = cu[:-3] + ".so"
    if not os.path.exists(so):
        with open(cu, "w") as f:
            f.write(src)
        p = subprocess.run([_cuda_build._nvcc(), *_cuda_build.NVCC_FLAGS,
                            "-o", so, cu], capture_output=True, text=True)
        if p.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{p.stderr}")
    lib = ctypes.CDLL(so)
    _bind(lib)
    return lib.shortlist_scan_launch


def launch(fn, scores, sel, cand_scores, req, free, seed):
    P, N = scores.shape
    K, R = sel[0].shape[1], req.shape[1]
    dev = scores.device
    out = S.ShortlistAssignResult(
        torch.empty((P,), dtype=torch.int32, device=dev),
        torch.empty((P,), dtype=torch.bool, device=dev),
        torch.empty((N, R), dtype=torch.float32, device=dev),
        torch.empty((P,), dtype=torch.bool, device=dev))
    err = fn(scores.data_ptr(), sel[0].data_ptr(), cand_scores.data_ptr(),
             sel[1].data_ptr(), sel[2].data_ptr(), req.data_ptr(),
             free.data_ptr(), seed, P, N, K, R, out.chosen.data_ptr(),
             out.assigned.data_ptr(), out.free_after.data_ptr(),
             out.repaired.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err:
        raise SystemExit(f"launch failed: cudaError {err}")
    return out


def select_parts(scores, seed, k, smi):
    """CUDA-event times of shortlist_select's parts, as the function
    computes them."""
    P, N = scores.shape
    cols = torch.arange(N, dtype=torch.int64, device=scores.device)[None, :]
    rows = torch.arange(P, dtype=torch.int64, device=scores.device)[:, None]

    def lattice():
        x = (cols * S._COL_MULT + seed + (rows * S.GOLDEN) % (1 << 32)) \
            & S._M32
        return S.fmix32(x) >> 8

    noise = lattice()
    kth = torch.topk(scores, k, dim=1).values[:, -1].contiguous()

    def key():
        kcol = kth[:, None]
        key2 = torch.where(scores > kcol, S._NOISE_ONE,
                           torch.where(scores == kcol, noise, -1))
        return key2 * (1 << 32) + (S._M32 - cols)

    key2 = key()
    parts = {
        "noise lattice": lattice,
        "first top-k (kth)": lambda: torch.topk(scores, k, dim=1),
        "composite key": key,
        "second top-k (cand)": lambda: torch.topk(key2, k, dim=1),
        "shortlist_select": lambda: S.shortlist_select(scores, seed, k),
    }
    print(f"shortlist_select parts {P}x{N} K={k}: " + ", ".join(
        f"{name} {cs.cuda_ms(fn, reps=10):.3f} ms"
        for name, fn in parts.items()) + f" ({smi})")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", action="append", default=[],
                    help="another kernel source, same interface")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("FAILED: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    with open(_cuda_build.source("shortlist_scan")) as f:
        builds = {"package": build("package", f.read())}
    others = []
    for path in opts.other:
        name = os.path.splitext(os.path.basename(path))[0]
        with open(path) as f:
            builds[name] = build(name, f.read())
        others.append(name)
    order = others + ["package", "package"] + others[::-1]

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
        sel = S.shortlist_select(sc, seed, cs.K)
        cand_scores = torch.gather(sc, 1, sel[0].long())
        plain = S.greedy_assign_shortlist_plain(sc, req, free, seed, *sel)
        for b, fn in builds.items():
            cs.compare(launch(fn, sc, sel, cand_scores, req, free, seed),
                       plain, FIELDS)
        times = [(b, cs.cuda_ms(lambda fn=builds[b]: launch(
            fn, sc, sel, cand_scores, req, free, seed), reps=20))
            for b in order]
        print(f"{name} {P}x{N}x{R} K={cs.K}: every build = plain bitwise "
              f"({int(plain.assigned.sum())} assigned, "
              f"{int(plain.repaired.sum())} repaired); "
              + ", ".join(f"{b} {ms:.4f} ms ({ms * 1e3 / P:.3f} us/pod)"
                          for b, ms in times) + f" ({smi})")
    select_parts(scores, seed, cs.K, smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Time the CUDA auction kernels (csrc/auction.cu, the dense rounds;
csrc/bid_auction.cu, the rounds over bid shortlists) on the bench batch,
against other builds of them, in turns. Needs a CUDA card and nvcc.

    python tools/auction_kernel_timing.py [--other OLD.cu]
                                          [--other-dense OLD.cu]

Inputs: chip_smoke.py's bench batch (the first 1,024 pods of the bench
workload against 50,000 nodes, scored by the bench profile) at full width
(1,024 x 53,248 x 10) with one priority band and with three, and on the
node sample the bench burst runs (K=4,096 of the pad); and the
full-width contention batch of chip_smoke.py's phase 20 (deep price
wars, many repairs). Every build is first held bitwise against the plain
version (chosen, assigned, free_after, repaired) and in the rounds it
ran.

For each input and build: the launch's time (CUDA events over 10
launches back to back); for the bid shortlist also the selection alone
(a launch with a round budget of 0) and the rounds' share per round.
For the package's build also its device time two ways: the profiler's
CUDA activity and CUDA events around launches queued behind a spin
kernel (chip_smoke.device_ms, chip_smoke.queued_ms).

--other        another bid_auction source with the same C interface (for
               instance an earlier commit's csrc/bid_auction.cu,
               extracted with `git show <commit>:minisched_tpu_torch/
               csrc/bid_auction.cu` first: the chip machine has no git),
               built against the package's csrc/ headers and timed beside
               the package's kernel in turns: other, package, package,
               other.
--other-dense  the same for csrc/auction.cu.

Every build, the package's too, is launched here through its own C
entry point, outside the package's wrappers, so no launch is counted in
_cuda_build.LAUNCHES. Builds go to minisched_tpu_torch/_build/timing/
(gitignored).
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
from minisched_tpu_torch.encode import to_torch  # noqa: E402
from minisched_tpu_torch.ops import _cuda_build, prng  # noqa: E402
from minisched_tpu_torch.ops.auction import (EPS, HALF_EPS,  # noqa: E402
                                             auction_assign_plain,
                                             max_rounds_for)
from minisched_tpu_torch.ops.auction_kernel import (_bind_auction,  # noqa: E402
                                                    _bind_bid)
from minisched_tpu_torch.ops.bid_select import (  # noqa: E402
    auction_assign_shortlist_plain)
from minisched_tpu_torch.ops.pipeline import (_gather_nodes,  # noqa: E402
                                              _select_node_sample, evaluate)

BUILD = os.path.join(ROOT, "minisched_tpu_torch", "_build", "timing")


def build(name: str, src: str, dense: bool) -> ctypes.CDLL:
    headers = "".join(open(os.path.join(_cuda_build.CSRC_DIR, f)).read()
                      for f in sorted(os.listdir(_cuda_build.CSRC_DIR))
                      if f.endswith(".cuh"))
    digest = hashlib.sha256((src + headers).encode()).hexdigest()[:12]
    os.makedirs(BUILD, exist_ok=True)
    cu = os.path.join(BUILD, f"auction-{name}-{digest}.cu")
    so = cu[:-3] + ".so"
    if not os.path.exists(so):
        with open(cu, "w") as f:
            f.write(src)
        p = subprocess.run([_cuda_build._nvcc(), *_cuda_build.NVCC_FLAGS,
                            "-I", _cuda_build.CSRC_DIR, "-Xptxas", "-v",
                            "-o", so, cu], capture_output=True, text=True)
        if p.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{p.stderr}")
        print(f"ptxas {name}: " + " | ".join(
            ln.strip() for ln in p.stderr.splitlines()
            if "registers" in ln or "spill" in ln))
    lib = ctypes.CDLL(so)
    (_bind_auction if dense else _bind_bid)(lib)
    return lib


def launch(lib, scores, req, free, seed, prio, k=None, max_rounds=None):
    """One launch of ``lib``'s kernel (dense for ``k`` None) on contiguous
    CUDA inputs: (chosen, assigned, free_after, repaired or None,
    rounds)."""
    P, N = scores.shape
    R = req.shape[1]
    dev = scores.device
    budget = max_rounds_for(P) if max_rounds is None else max_rounds
    chosen = torch.empty((P,), dtype=torch.int32, device=dev)
    assigned = torch.empty((P,), dtype=torch.bool, device=dev)
    free_after = torch.empty((N, R), device=dev)
    rounds = torch.empty((1,), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    if k is None:
        scratch = torch.empty((lib.auction_scratch_bytes(P, N),),
                              dtype=torch.uint8, device=dev)
        err = lib.auction_launch(
            scores.data_ptr(), req.data_ptr(), free.data_ptr(),
            prio.data_ptr(), seed, EPS, HALF_EPS, budget, P, N, R,
            chosen.data_ptr(), assigned.data_ptr(), free_after.data_ptr(),
            rounds.data_ptr(), scratch.data_ptr(), stream)
        repaired = None
    else:
        scratch = torch.empty((lib.bid_auction_scratch_bytes(P, N, k),),
                              dtype=torch.uint8, device=dev)
        repaired = torch.empty((P,), dtype=torch.bool, device=dev)
        err = lib.bid_auction_launch(
            scores.data_ptr(), req.data_ptr(), free.data_ptr(),
            prio.data_ptr(), seed, EPS, HALF_EPS, budget, P, N, R, k,
            chosen.data_ptr(), assigned.data_ptr(), free_after.data_ptr(),
            repaired.data_ptr(), rounds.data_ptr(), scratch.data_ptr(),
            stream)
    if err not in (0, _cuda_build.NO_LAUNCH):
        raise SystemExit(f"launch failed: cudaError {err}")
    return chosen, assigned, free_after, repaired, rounds


def inputs():
    """name -> (scores, requests, free, priority), on the card."""
    nodes, pods = cs.bench_workload(cs.N_NODES, cs.N_PODS)
    eb, nf, af = (to_torch(x, "cuda")
                  for x in cs.full_width_batch(nodes, pods))
    plugin_set = cs.BENCH_PROFILE.build()
    scores = evaluate(plugin_set, eb, nf, af)[0]
    P = scores.shape[0]
    one = torch.zeros((P,), dtype=torch.int32, device="cuda")
    three = (torch.arange(P, device="cuda") % 3).to(torch.int32)
    _, skey = prng.split(prng.fold_in(prng.PRNGKey(0), 1))
    nf_s = _gather_nodes(nf, _select_node_sample(nf, skey, cs.SAMPLE_K))
    s_scores = evaluate(plugin_set, eb, nf_s, af)[0]
    cont = cs.shortlist_case(cs.BATCH, scores.shape[1], nf.free.shape[1], 3,
                             contend=True)
    return {
        "full width": (scores, eb.pf.requests, nf.free, one),
        "full width, 3 bands": (scores, eb.pf.requests, nf.free, three),
        "sampled": (s_scores, eb.pf.requests, nf_s.free, one),
        "contention": (*[t.contiguous() for t in cont], one),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", help="another bid_auction.cu")
    ap.add_argument("--other-dense", help="another auction.cu")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("FAILED: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    seed = prng.bits(prng.fold_in(prng.PRNGKey(0), 21))
    kernels = {}
    for dense, pkg, other in ((True, "auction", opts.other_dense),
                              (False, "bid_auction", opts.other)):
        with open(_cuda_build.source(pkg)) as f:
            builds = {"package": build(pkg, f.read(), dense)}
        if other:
            with open(other) as f:
                builds["other"] = build(f"{pkg}-other", f.read(), dense)
        kernels[pkg] = builds
    for name, (scores, req, free, prio) in inputs().items():
        P, N = scores.shape
        for pkg, builds in kernels.items():
            k = None if pkg == "auction" else cs.K
            st = torch.zeros((3,), dtype=torch.int32, device="cuda")
            if k is None:
                plain = auction_assign_plain(scores, req, free, seed,
                                             priority=prio, stats=st)
            else:
                plain = auction_assign_shortlist_plain(
                    scores, req, free, seed, priority=prio, k=k, stats=st)
            for b, lib in builds.items():
                got = launch(lib, scores, req, free, seed, prio, k)
                pairs = list(zip(("chosen", "assigned", "free_after"),
                                 got[:3], plain[:3]))
                if k is not None:
                    pairs.append(("repaired", got[3], plain.repaired))
                for f, a, w in pairs + [("rounds", got[4], st[:1])]:
                    if not torch.equal(cs.bits(a), cs.bits(w)):
                        raise SystemExit(f"FAILED: {pkg} {b} {name}: {f} "
                                         "!= plain")
            order = (["other"] if "other" in builds else []) + [
                "package", "package"] + (["other"] if "other" in builds
                                         else [])
            rounds = int(st[0])
            parts = []
            for b in order:
                lib = builds[b]
                ms = cs.cuda_ms(lambda: launch(lib, scores, req, free, seed,
                                               prio, k), reps=10)
                part = f"{b} {ms:.4f} ms"
                if k is not None:
                    sel = cs.cuda_ms(lambda: launch(
                        lib, scores, req, free, seed, prio, k, 0), reps=10)
                    part += (f" (selection {sel:.4f} ms, "
                             f"{(ms - sel) * 1e3 / max(rounds, 1):.1f} us "
                             "per round)")
                parts.append(part)
            lib = builds["package"]
            prof = cs.profiler_ms(lambda: launch(lib, scores, req, free, seed,
                                                 prio, k), reps=5)
            spin = cs.queued_ms(lambda: launch(lib, scores, req, free, seed,
                                               prio, k), reps=5)
            parts.append(f"package device time {cs.fmt_ms(prof, 4)} "
                         f"(profiler), {cs.fmt_ms(spin, 4)} (spin clock)")
            print(f"{pkg} {name} {P}x{N}x{req.shape[1]}"
                  f"{'' if k is None else f' K={k}'}: every build = plain "
                  f"bitwise, {rounds} rounds, {int(st[1])} bids ({int(st[2])} "
                  f"over full rows), "
                  f"{int(plain.assigned.sum())} assigned; "
                  + ", ".join(parts) + f" ({smi})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

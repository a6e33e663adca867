"""Time the CUDA auction kernels (csrc/auction.cu, the dense rounds;
csrc/bid_auction.cu, the rounds over bid shortlists) on the bench batch,
against other builds of them, in turns. Needs a CUDA card and nvcc.

    python tools/auction_kernel_timing.py [--other OLD.cu]
                                          [--other-dense OLD.cu] [--split]
                                          [--only "sampled/contention"]

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
               csrc/bid_auction.cu` into a directory with that commit's
               csrc/*.cuh first: the chip machine has no git), built
               against the headers of its own directory and timed beside
               the package's kernel in turns: other, package, package,
               other.
--other-dense  the same for csrc/auction.cu.
--split        a copy of each build with clock64 stamps on its phases
               (tools/split_timing.py), run once per input after a
               warm-up: mean, min and max over blocks of each selection
               phase in us per block and of each round phase in us per
               round; for the dense kernel also warp 0's part of each
               bid phase (the open prices staged, its tiles reduced, its
               pods counted in, merged and posted) and its counts.
--only         the inputs to run, separated by '/'.

First it prints the bid-shortlist kernel's shared-memory layout
(ops.auction_kernel.bid_auction_layout) at the bench shapes and past the
old batch cap, and where its row cache and its pods leave shared memory.

Every build, the package's too, is launched here through its own C
entry point, outside the package's wrappers, so no launch is counted in
_cuda_build.LAUNCHES. Builds go to minisched_tpu_torch/_build/timing/
(gitignored).
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

# Stamps for 0e0228d's kernels (thread 0 of every block): the radix
# selection per row, then the three grid barriers of each round.
PR9_SELECT = {0: "selection: fill the key cache", 1: "selection: 4 radix passes",
              2: "selection: collection", 3: "init + every row's selection",
              4: "grid barrier after the selection"}
PR9_ROUND = {5: "round: control + node walk", 6: "round: grid barrier A",
             7: "round: bids", 8: "round: grid barrier B",
             9: "round: settle", 10: "round: grid barrier C",
             11: "round: advance (loop state)"}
PR9_HEADER = [
    ("  while (s.rnd < p.max_rounds && s.band > kNegBand) {\n"
     "    open_nodes(p, s);\n    grid_sync(p.bar, target);\n",
     "  long long _st = clock64();\n"
     "  while (s.rnd < p.max_rounds && s.band > kNegBand) {\n"
     "    open_nodes(p, s);\n    st_mark(_st, 5);\n"
     "    grid_sync(p.bar, target);\n    st_mark(_st, 6);\n"),
    ("    grid_sync(p.bar, target);\n    settle(p, s);\n"
     "    grid_sync(p.bar, target);\n    advance(p, s);\n  }\n",
     "    st_mark(_st, 7);\n    grid_sync(p.bar, target);\n"
     "    st_mark(_st, 8);\n    settle(p, s);\n    st_mark(_st, 9);\n"
     "    grid_sync(p.bar, target);\n    st_mark(_st, 10);\n"
     "    advance(p, s);\n    st_mark(_st, 11);\n  }\n"),
]
PR9_BID = [
    ("  if (p.cache_keys) cache_row(p, row, srow, keys_s);\n",
     "  long long _st = clock64();\n"
     "  if (p.cache_keys) cache_row(p, row, srow, keys_s);\n"
     "  st_mark(_st, 0);\n"),
    ("  feas = __syncthreads_or(feas);\n",
     "  feas = __syncthreads_or(feas);\n  st_mark(_st, 1);\n"),
    ("  // The cache is rewritten for the block's next row.\n"
     "  __syncthreads();\n}\n",
     "  // The cache is rewritten for the block's next row.\n"
     "  __syncthreads();\n  st_mark(_st, 2);\n}\n"),
    ("  unsigned target = 0;\n  init_state(p);\n",
     "  long long _st;\n  st_open(_st);\n"
     "  unsigned target = 0;\n  init_state(p);\n"),
    ("  grid_sync(p.bar, target);\n  run_rounds(",
     "  st_mark(_st, 3);\n  grid_sync(p.bar, target);\n"
     "  st_mark(_st, 4);\n  run_rounds("),
    ("return shortlist_top2(p, i); });\n}\n",
     "return shortlist_top2(p, i); });\n  st_close();\n}\n"),
]
PR9_DENSE = [
    ("  unsigned target = 0;\n  init_state(p);\n",
     "  long long _st;\n  st_open(_st);\n"
     "  unsigned target = 0;\n  init_state(p);\n"),
    ("  grid_sync(p.bar, target);\n  run_rounds(",
     "  st_mark(_st, 3);\n  grid_sync(p.bar, target);\n"
     "  st_mark(_st, 4);\n  run_rounds("),
    ("return dense_top2(p, i); });\n}\n",
     "return dense_top2(p, i); });\n  st_close();\n}\n"),
]
# Stamps for the threshold selection and the two-barrier round.
NEW_SELECT = {0: "selection: pass 1 (fold, keys, maxima)",
              1: "selection: reductions + L", 2: "selection: pass 2 (list)",
              15: "selection: rank / ties / exact path",
              3: "init + every row's selection",
              4: "local state + first control barrier"}
NEW_ROUND = {5: "round: node walk (per round, when walked)",
             6: "round: grid barrier A (per round, when walked)",
             7: "round: bids", 8: "round: grid barrier B",
             9: "round: settle", 12: "round: control partial",
             10: "round: control barrier + read"}
NEW_COUNTS = {14: "rounds that walked the nodes", 16: "rows ranked",
              17: "rows whose ties at L were walked",
              18: "rows on the exact path"}
NEW_HEADER = [
    ("  control_sync(p, s, target, gen, true);\n"
     "  while (s.rnd < p.max_rounds && s.band > kNegBand) {\n"
     "    if (s.walk) {\n      walk_nodes(p, s);\n"
     "      grid_sync(p.bar, target);\n    }\n    bid_phase(s);\n"
     "    grid_sync(p.bar, target);\n"
     "    const bool fit = settle(p, L, s);\n"
     "    publish_partial(p, L, s.band, false, fit, gen);\n"
     "    control_sync(p, s, target, gen, false);\n  }\n",
     "  long long _st = clock64();\n"
     "  control_sync(p, s, target, gen, true);\n  st_mark(_st, 4);\n"
     "  while (s.rnd < p.max_rounds && s.band > kNegBand) {\n"
     "    if (s.walk) {\n      st_count(14);\n      walk_nodes(p, s);\n"
     "      st_mark(_st, 5);\n      grid_sync(p.bar, target);\n"
     "      st_mark(_st, 6);\n    }\n    bid_phase(s);\n"
     "    st_mark(_st, 7);\n    grid_sync(p.bar, target);\n"
     "    st_mark(_st, 8);\n    const bool fit = settle(p, L, s);\n"
     "    st_mark(_st, 9);\n"
     "    publish_partial(p, L, s.band, false, fit, gen);\n"
     "    st_mark(_st, 12);\n    control_sync(p, s, target, gen, false);\n"
     "    st_mark(_st, 10);\n  }\n"),
]
_NEW_KERNEL = [
    ("  init_state(p);\n",
     "  long long _st;\n  st_open(_st);\n  init_state(p);\n"),
    ("  init_local(p, L);\n",
     "  st_mark(_st, 3);\n  init_local(p, L);\n"),
]
NEW_BID = _NEW_KERNEL + [
    ("  uint32_t mx, mn;\n  fold_row(p, row, srow, keys_s, mx, mn);\n",
     "  long long _st = clock64();\n"
     "  uint32_t mx, mn;\n  fold_row(p, row, srow, keys_s, mx, mn);\n"
     "  st_mark(_st, 0);\n"),
    ("    uint32_t above, equal;\n"
     "    compact(p, row, srow, keys_s, L, false, list, above, equal);\n",
     "    st_mark(_st, 1);\n    uint32_t above, equal;\n"
     "    compact(p, row, srow, keys_s, L, false, list, above, equal);\n"
     "    st_mark(_st, 2);\n"),
    ("      emit_ranked(p, row, list, static_cast<int>(above + equal));\n",
     "      st_count(16);\n"
     "      emit_ranked(p, row, list, static_cast<int>(above + equal));\n"),
    ("        emit_ties(p, row, srow, keys_s, L,",
     "        st_count(17);\n        emit_ties(p, row, srow, keys_s, L,"),
    ("      kth = select_exact(p, row, srow, keys_s);\n",
     "      st_count(18);\n      kth = select_exact(p, row, srow, keys_s);\n"),
    ("  if (threadIdx.x == 0) {\n    if (!ranked)",
     "  st_mark(_st, 15);\n  if (threadIdx.x == 0) {\n    if (!ranked)"),
    ("  });\n}\n\nextern \"C\" long long bid_auction_scratch_bytes",
     "  });\n  st_close();\n}\n\n"
     "extern \"C\" long long bid_auction_scratch_bytes"),
]
NEW_DENSE = _NEW_KERNEL + [
    ("  });\n}\n\nextern \"C\" long long auction_scratch_bytes",
     "  });\n  st_close();\n}\n\nextern \"C\" long long auction_scratch_bytes"),
]
# Stamps for the round with active lists and the dense kernel's bid
# units (warp 0 of each block stamps its own units).
LIST_HEADER = [
    ("  control_sync(p, s, target, gen, true);\n"
     "  while (s.rnd < p.max_rounds && s.band > kNegBand) {\n"
     "    if (s.walk) {\n      walk_nodes(p, s);\n",
     "  long long _st = clock64();\n"
     "  control_sync(p, s, target, gen, true);\n  st_mark(_st, 4);\n"
     "  while (s.rnd < p.max_rounds && s.band > kNegBand) {\n"
     "    if (s.walk) {\n      st_count(14);\n      walk_nodes(p, s);\n"),
    ("      grid_sync(p.bar, target);\n    }\n    bid_phase(s);\n"
     "    grid_sync(p.bar, target);\n"
     "    const bool fit = settle(p, L, s);\n",
     "      st_mark(_st, 5);\n      grid_sync(p.bar, target);\n"
     "      st_mark(_st, 6);\n    }\n    bid_phase(s);\n"
     "    st_mark(_st, 7);\n    grid_sync(p.bar, target);\n"
     "    st_mark(_st, 8);\n    const bool fit = settle(p, L, s);\n"
     "    st_mark(_st, 9);\n"),
    ("    control_sync(p, s, target, gen, false);\n",
     "    st_mark(_st, 12);\n    control_sync(p, s, target, gen, false);\n"
     "    st_mark(_st, 10);\n"),
]
UNIT_PHASES = {19: "bids: list count + open prices staged",
               20: "bids: warp 0's tiles, reduce + next loads",
               21: "bids: warp 0's pods, count in, merge, post"}
UNIT_COUNTS = {22: "tiles of warp 0", 26: "segments warp 0 counted in",
               23: "merges by warp 0 (last segment)",
               24: "full-row repairs of certified-path pods",
               25: "bid phases that staged the open prices"}
UNIT_DENSE = _NEW_KERNEL + [
    ("  const unsigned A = __ldcg(list_count(p, s.rnd, s.reset));\n",
     "  long long _sb = clock64();\n"
     "  const unsigned A = __ldcg(list_count(p, s.rnd, s.reset));\n"),
    ("  if (staged) {\n", "  if (staged) {\n    st_count(25);\n"),
    ("  // Pipelined: the next tile's pod is looked up while this tile is\n",
     "  st_mark(_sb, 19);\n"
     "  // Pipelined: the next tile's pod is looked up while this tile is\n"),
    ("    const bool more = u + 1 < end;\n",
     "    st_count(22);\n    const bool more = u + 1 < end;\n"),
    ("    if (!more || na != a) {\n      finish_segment(",
     "    st_mark(_sb, 20);\n    if (!more || na != a) {\n"
     "      finish_segment("),
    ("      t = top2_empty();\n      seg = 0;\n    }\n",
     "      t = top2_empty();\n      seg = 0;\n    }\n"
     "    st_mark(_sb, 21);\n"),
    ("  if (n < p.tiles) {\n", "  if (n < p.tiles) {\n    st_count(26);\n"),
    ("    if (!__shfl_sync(kFull, last, 0)) return;\n",
     "    if (!__shfl_sync(kFull, last, 0)) return;\n    st_count(23);\n"),
    ("             [&](const Loop& s) { dense_bids(p, L, s, ops_s); });\n}\n",
     "             [&](const Loop& s) { dense_bids(p, L, s, ops_s); });\n"
     "  st_close();\n}\n"),
]
LIST_BID = NEW_BID[:-1] + [
    ("            const Top2 t = dense_top2(p, i);\n",
     "            st_count(24);\n"
     "            const Top2 t = dense_top2(p, i);\n"),
    ("  });\n}\n\nnamespace {\n\n// A launch's shape",
     "  });\n  st_close();\n}\n\nnamespace {\n\n// A launch's shape"),
]
# anchor in the header -> (header edits, {main: edits}, phases, counts)
SPLITS = {
    "list_count(p, s.rnd, true)": (
        LIST_HEADER, {"bid_auction.cu": LIST_BID, "auction.cu": UNIT_DENSE},
        {**NEW_SELECT, **NEW_ROUND, **UNIT_PHASES},
        {**NEW_COUNTS, **UNIT_COUNTS}),
    "    advance(p, s);\n  }\n": (PR9_HEADER, {"bid_auction.cu": PR9_BID,
                                            "auction.cu": PR9_DENSE},
                                 {**PR9_SELECT, **PR9_ROUND}, {}),
    "control_sync(p, s, target, gen, false);": (
        NEW_HEADER, {"bid_auction.cu": NEW_BID, "auction.cu": NEW_DENSE},
        {**NEW_SELECT, **NEW_ROUND}, NEW_COUNTS),
}


def build(name: str, files, main: str, stamp: bool = False):
    """The library of ``files[main]`` built with the other files (its
    directory's headers), or of its stamped copy: (library, phases,
    counts); None for a stamped copy that no stamp edits fit."""
    phases = counts = None
    if stamp:
        for anchor, (hdr, mains, phases, counts) in SPLITS.items():
            if anchor in files["auction_rounds.cuh"]:
                files = sp.stamped(files, {"auction_rounds.cuh": hdr,
                                           main: mains[main]})
                break
        else:
            print(f"no stamp edits fit the {name} source: not split")
            return None
    lib = sp.build(f"{name}{'-stamped' if stamp else ''}", files, main,
                   _bind_auction if main == "auction.cu" else _bind_bid)
    return lib, phases, counts


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


def layout_lines(smi: str):
    """The bid-shortlist kernel's shared-memory layout at the bench shapes
    and past the old cap, and where it changes: the widest row whose keys
    it caches (1,024 pods), and the largest batch whose pods it keeps in
    shared memory beside a cached row of 53,248 keys."""
    from minisched_tpu_torch.ops.auction_kernel import bid_auction_layout

    def last(lo, hi, ok):  # the largest x in [lo, hi) with ok(x)
        while hi - lo > 1:
            mid = (lo + hi) // 2
            lo, hi = (mid, hi) if ok(mid) else (lo, mid)
        return lo

    lines = []
    for P, N in ((1024, 4096), (1024, 53248), (18432, 53248),
                 (1_300_000, 2)):
        lines.append(f"bid_auction layout {P}x{N}: {bid_auction_layout(P, N)}")
    n = last(4, 1 << 20, lambda x: bid_auction_layout(1024, x)["cache_keys"])
    p = last(1, 1 << 24, lambda x: bid_auction_layout(x, 53248)["shared_pods"])
    lines.append(f"bid_auction layout: row keys cached up to N = {n} (1,024 "
                 f"pods); pods in shared memory beside a cached 53,248-key "
                 f"row up to P = {p} ({smi})")
    return lines


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", help="another bid_auction.cu")
    ap.add_argument("--other-dense", help="another auction.cu")
    ap.add_argument("--split", action="store_true",
                    help="split each build per phase (stamped copies)")
    ap.add_argument("--only", help="the inputs to run, separated by '/' "
                    "(of: full width; full width, 3 bands; sampled; "
                    "contention)")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("FAILED: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    print("\n".join(layout_lines(smi)), flush=True)
    seed = prng.bits(prng.fold_in(prng.PRNGKey(0), 21))
    kernels, stamped = {}, {}
    for main, pkg, other in (("auction.cu", "auction", opts.other_dense),
                             ("bid_auction.cu", "bid_auction", opts.other)):
        sources = {"package": sp.read_dir(_cuda_build.CSRC_DIR)}
        if other:
            sources["other"] = sp.read_dir(os.path.dirname(
                os.path.abspath(other)))
            with open(other) as f:
                sources["other"][main] = f.read()
        kernels[pkg] = {b: build(f"{pkg}-{b}", files, main)[0]
                        for b, files in sources.items()}
        if opts.split:
            stamped[pkg] = {b: lib for b, lib in (
                (b, build(f"{pkg}-{b}", files, main, True))
                for b, files in sources.items()) if lib is not None}
    only = opts.only.split("/") if opts.only else None
    for name, (scores, req, free, prio) in inputs().items():
        if only is not None and name not in only:
            continue
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
            lines = []
            for b, (slib, phases, counts) in stamped.get(pkg, {}).items():
                stamps = sp.Stamps(slib)
                launch(slib, scores, req, free, seed, prio, k)
                stamps.zero()
                launch(slib, scores, req, free, seed, prio, k)
                stamp, ghz = stamps.read()
                lines += sp.report(
                    f"{pkg} {b} on {name} ({rounds} rounds; selection in us "
                    f"per block, rounds in us per round) ({smi})", stamp, ghz,
                    {j: (v, max(rounds, 1) if j >= 5 and j != 15 else 1)
                     for j, v in phases.items()
                     if k is not None or j not in (0, 1, 2, 15)}, counts)
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
            if lines:
                print("\n".join(lines), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

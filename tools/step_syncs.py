"""List where the port's step makes the host wait on the card, at
bench-50k, on one CUDA card.

    python tools/step_syncs.py

Builds chip_smoke.py's full-width bench batch (the first 1,024 pods of
the bench workload against 50,000 nodes), warms each function, then
calls it once under torch's sync debug mode ("warn") and prints every
synchronizing operation it reports, by the port's source lines on the
stack: the node sample (K=4,096), the filters and scores at full width,
the sampled step and the unsampled step (shortlist K=128), each step
called as the engine calls it (the host's flags: no gang, no
DoNotSchedule slot); then config 4's batch (chip_smoke.c4_workload) on
its profile with DefaultPreemption (bench_workload.C4_PLUGINS): the soft
step sampled, and the hard step (DoNotSchedule, max_skew 1) unsampled,
whose one read of the caps' any_enforced is expected; then
full_scheduler_profile()'s sampled step on chip_smoke's claim-carrying
batch (pinned, unused, zone-bound and cloud-typed claims, host ports,
taints); the preemption pass's device work at bench.py's shape
(chip_smoke.preempt_bench_inputs): the candidate op alone, then the op
with the engine's one read of its outputs (ops/preempt.fetch_preempt),
which is the one sync expected; and last the auction step
(assignment="auction", the bid shortlist) sampled on the bench batch,
and unsampled on BASELINE config 5's batch (gangs of 8 at quorum 8,
chip_smoke.c5_pods) with the host's has_gang=True, whose gang admission
reads the card once per attempt. Each line ends with the card's name and
power limit. The debug mode is a prototype in torch: it may miss a sync,
never invents one.
"""
from __future__ import annotations

import collections
import os
import subprocess
import sys
import traceback
import warnings
from concurrent.futures import ThreadPoolExecutor

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from minisched_tpu_torch.encode import to_torch  # noqa: E402
from minisched_tpu_torch.ops import _cuda_build, prng  # noqa: E402
from minisched_tpu_torch.ops.pipeline import (_select_node_sample,  # noqa: E402
                                              build_step, evaluate)
from minisched_tpu_torch.ops.preempt import (build_preempt_op,  # noqa: E402
                                             fetch_preempt)


def sync_sites(fn) -> collections.Counter:
    """The synchronizing operations of one call of ``fn``: a count per
    (message, innermost three port frames)."""
    sites = collections.Counter()

    def note(message, *_args, **_kw):
        if "called a synchronizing" not in str(message):
            return
        frames = [f for f in traceback.extract_stack()[:-1]
                  if "minisched_tpu_torch" in f.filename][-3:]
        where = " <- ".join(f"{os.path.relpath(f.filename, ROOT)}:{f.lineno}"
                            for f in reversed(frames)) or "outside the port"
        sites[(str(message).split(" (Triggered")[0], where)] += 1

    fn()
    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = note
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sites


def main() -> int:
    if not torch.cuda.is_available():
        print("FAILED: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    with ThreadPoolExecutor(len(_cuda_build.KERNELS)) as pool:
        list(pool.map(_cuda_build.build, _cuda_build.KERNELS))
    plugin_set = cs.BENCH_PROFILE.build()
    nodes, pods = cs.bench_workload(cs.N_NODES, cs.N_PODS)
    eb, nf, af = (to_torch(x, "cuda")
                  for x in cs.full_width_batch(nodes, pods))
    key = prng.fold_in(prng.PRNGKey(0), 1)
    _, skey = prng.split(key)
    sampled = build_step(plugin_set, shortlist=cs.K, sample_nodes=cs.SAMPLE_K)
    full = build_step(plugin_set, shortlist=cs.K)
    c4_set = cs.C4_PROFILE.build()
    c4 = {}
    for hard in (False, True):
        nodes, pods = cs.c4_workload(cs.N_NODES, cs.N_PODS, hard=hard,
                                     max_skew=1 if hard else 8)
        c4[hard] = [to_torch(x, "cuda")
                    for x in cs.full_width_batch(nodes, pods)]
    c4_soft = build_step(c4_set, shortlist=cs.K, sample_nodes=cs.SAMPLE_K)
    c4_hard = build_step(c4_set, shortlist=cs.K)
    full_batch = [to_torch(x, "cuda")
                  for x in cs.full_profile_batch(cs.BATCH)]
    full_sampled = build_step(cs.FULL_PROFILE.build(), shortlist=cs.K,
                              sample_nodes=cs.SAMPLE_K)
    p_eb, p_nf, p_af, p_cfg = cs.preempt_bench_inputs()
    p_in = [to_torch(x, "cuda") for x in (p_eb, p_nf, p_af)]
    p_op = build_preempt_op(cs.PREEMPT_PROFILE.build(), cfg=p_cfg)
    au_sampled = build_step(plugin_set, shortlist=cs.K,
                            sample_nodes=cs.SAMPLE_K, assignment="auction")
    au_full = build_step(plugin_set, shortlist=cs.K, assignment="auction")
    nodes, pods = cs.bench_workload(cs.N_NODES, cs.N_PODS)
    c5 = [to_torch(x, "cuda")
          for x in cs.full_width_batch(nodes, cs.c5_pods(pods))]
    # The engine's host flags for a batch with no gang and no
    # DoNotSchedule slot.
    no_host = {"has_gang": False, "hard_spread": False}
    for name, fn in (
            ("node sample", lambda: _select_node_sample(nf, skey,
                                                        cs.SAMPLE_K)),
            ("filters and scores", lambda: evaluate(plugin_set, eb, nf, af)),
            ("sampled step", lambda: sampled(eb, nf, af, key, **no_host)),
            ("unsampled step", lambda: full(eb, nf, af, key, **no_host)),
            ("config 4 soft step, sampled",
             lambda: c4_soft(*c4[False], key, **no_host)),
            ("config 4 hard step, unsampled",
             lambda: c4_hard(*c4[True], key, has_gang=False,
                             hard_spread=True)),
            ("full-profile step, sampled",
             lambda: full_sampled(*full_batch, key, **no_host)),
            ("preemption op", lambda: p_op(*p_in)),
            ("preemption op and the pass's read",
             lambda: fetch_preempt(p_op(*p_in))),
            ("auction step, sampled",
             lambda: au_sampled(eb, nf, af, key, **no_host)),
            ("auction step on config 5's gangs, unsampled",
             lambda: au_full(*c5, key, has_gang=True, hard_spread=False))):
        sites = sync_sites(fn)
        print(f"{name}: {sum(sites.values())} host syncs ({smi})")
        for (message, where), n in sites.items():
            print(f"  {n} x {where}: {message}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

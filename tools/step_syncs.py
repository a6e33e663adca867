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
DoNotSchedule slot); then config 4's batch (chip_smoke.c4_workload):
the soft step sampled, and the hard step (DoNotSchedule, max_skew 1)
unsampled, whose one read of the caps' any_enforced is expected. Each
line ends with the card's name and power limit. The debug mode is a
prototype in torch: it may miss a sync, never invents one.
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
                             hard_spread=True))):
        sites = sync_sites(fn)
        print(f"{name}: {sum(sites.values())} host syncs ({smi})")
        for (message, where), n in sites.items():
            print(f"  {n} x {where}: {message}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Time the single-device main path of two checkouts in turns, on one
CUDA card: the bench step, the full-profile step and one engine burst.

    python tools/step_ab_timing.py --base DIR [--rounds 1] [--reps 10]
                                   [--blocks 5] [--pods 10000]

A is this checkout, B the tree at ``--base`` (for example a parent
commit unpacked there with ``git archive``). Every run is a fresh
process that imports its own tree's ``minisched_tpu_torch`` and
``chip_smoke`` (each tree builds its kernels into its own build
directory). A run:

  * builds the bench batch (``chip_smoke.full_width_batch``: the first
    1,024 bench pods against the 53,248-row pad of bench-50k) and times
    the bench profile's step with CUDA events: the median over
    ``blocks`` blocks of the mean of ``reps`` calls back to back, after
    one warm call (a step whose host side outlasts its device work is
    timed on the host's pace): sampled (shortlist K=128 over the default
    config's node sample, SAMPLE_K = 4,096) and unsampled (shortlist
    K=128, every node);
  * builds the full-profile batch (``chip_smoke.full_profile_batch``:
    15 filters, 7 scorers, the topology state and every scorer's
    normalize) and times its step the same way, sampled and unsampled;
  * drives one burst of ``pods`` bench pods on bench-50k through
    ``SchedulerConfig()`` (``chip_smoke.drive``, after a 2,000-node
    warm-up burst) and reports create-to-bound and the step seconds per
    batch.

Runs go A B B A per round; the medians per tree come last, with the
card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("bench_sampled_ms", "bench_unsampled_ms", "full_sampled_ms",
          "full_unsampled_ms", "burst_c2b_s", "burst_step_ms_per_batch")


def one(root: str, reps: int, blocks: int, n_pods: int) -> dict:
    """One run against the tree at ``root``; returns its numbers."""
    sys.path.insert(0, root)
    import chip_smoke as cs
    from minisched_tpu_torch.config import SchedulerConfig
    from minisched_tpu_torch.encode import to_torch
    from minisched_tpu_torch.ops import prng
    from minisched_tpu_torch.ops.pipeline import build_step

    if not os.path.abspath(cs.__file__).startswith(os.path.abspath(root)):
        raise SystemExit(f"FAILED: chip_smoke imported from {cs.__file__}")
    key = prng.fold_in(prng.PRNGKey(0), 1)
    out = {}

    def timed(tag, plugin_set, batch):
        dev = [to_torch(x, "cuda") for x in batch]
        for label, sample in (("sampled", cs.SAMPLE_K), ("unsampled", None)):
            step = build_step(plugin_set, shortlist=cs.K,
                              sample_nodes=sample)
            out[f"{tag}_{label}_ms"] = float(np.median([cs.cuda_ms(
                lambda: step(*dev, key, has_gang=False, hard_spread=False),
                reps=reps) for _ in range(blocks)]))
        del dev

    nodes, pods = cs.bench_workload(cs.N_NODES, cs.N_PODS)
    timed("bench", cs.BENCH_PROFILE.build(), cs.full_width_batch(nodes, pods))
    timed("full", cs.FULL_PROFILE.build(), cs.full_profile_batch(cs.BATCH))
    cfg = SchedulerConfig(platform="")
    w_nodes, w_pods = cs.bench_workload(2_000, 1_024, seed=1)
    cs.drive(cfg, w_nodes, w_pods, "warm-up")
    nodes, pods = cs.bench_workload(cs.N_NODES, n_pods)
    m, _launches, c2b, _per_pod, _ = cs.drive(cfg, nodes, pods, "burst")
    out["burst_c2b_s"] = c2b
    out["burst_step_ms_per_batch"] = m["step_s_total"] / m["batches"] * 1e3
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--base", required=True,
                    help="root of the other checkout (B)")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--blocks", type=int, default=5)
    ap.add_argument("--pods", type=int, default=10_000)
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("FAILED: no CUDA device", file=sys.stderr)
        return 2
    if args.one:
        print(json.dumps(one(args.one, args.reps, args.blocks, args.pods)))
        return 0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    trees = {"A": HERE, "B": os.path.abspath(args.base)}
    print(f"card: {smi}; A = {trees['A']}, B = {trees['B']}", flush=True)
    results = {"A": [], "B": []}
    for tag in ["A", "B", "B", "A"] * args.rounds:
        run = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--base",
             args.base, "--one", trees[tag], "--reps", str(args.reps),
             "--blocks", str(args.blocks), "--pods", str(args.pods)],
            capture_output=True, text=True,
            cwd=trees[tag])
        if run.returncode:
            print(run.stdout[-4000:] + run.stderr[-4000:], file=sys.stderr)
            raise SystemExit(f"FAILED: the {tag} run exited "
                             f"{run.returncode}")
        row = json.loads(run.stdout.strip().splitlines()[-1])
        results[tag].append(row)
        print(f"{tag}: " + ", ".join(f"{k} {row[k]!r}" for k in FIELDS),
              flush=True)
    for tag, rows in results.items():
        med = {k: float(np.median([r[k] for r in rows])) for k in FIELDS}
        print(f"median {tag} over {len(rows)} runs: "
              + ", ".join(f"{k} {v!r}" for k, v in med.items())
              + f" ({smi})")
    return 0


if __name__ == "__main__":
    sys.exit(main())

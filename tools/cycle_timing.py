"""Time the port's engine cycle end to end at bench-50k under several
configurations, in turns, on one CUDA card.

    python tools/cycle_timing.py [--modes default,unsampled,full-kernel,sync]
                                 [--rounds 2] [--pods 10000] [--profile]

Every run is a fresh process (a long-lived process slows its host
phases as clusters accumulate): it first drives a small warm-up burst
under the same mode (2,000 nodes x 1,024 pods: kernel builds, CUDA
context and allocator), then boots a fresh Cluster with the bench
profile, loads 50,000 nodes, zeroes the kernel launch counts, creates
the pods (chip_smoke.py's main-path workload) and waits until all are
bound. Each run prints the burst create-to-bound,
the per-pod p50/p99, the engine's phase clocks, per-batch transfer
bytes and the kernel launches. Modes run in the order given, then
reversed, ``--rounds`` times (A B C C B A ...); the medians per mode
come last.

--profile runs each mode once instead, under torch.profiler (CUDA
activity): the device's busy time over the burst (the sum of its kernel
and copy times, one stream) and the five kernels that took the most.

Modes: default (SchedulerConfig(): pipelined, device-resident,
shortlist K=128, node sampling at its auto percentage: K=4,096 of the
53,248-row pad at bench-50k); unsampled (the same with
percentage_of_nodes_to_score=100: every node evaluated); full-kernel
(the default with shortlist=False: the greedy kernel); sync (pipeline,
residency and shortlist off: the earlier path); c4-soft and c4-hard
(the default config on BASELINE config 4: chip_smoke.py's C4_PROFILE,
bench_workload.C4_PLUGINS with DefaultPreemption, and c4_workload,
ScheduleAnyway max_skew 8, or DoNotSchedule max_skew 1, the caps scan);
full (the default config under full_scheduler_profile() on
chip_smoke.full_workload: the bench cluster, every fifth pod with a
Bound claim on a zone-labelled PV, without the PV controller, as
bench.py runs its engine cells); full-pv (the same with the PV
controller on, which relists every claim and PV on each claim-carrying
pod event). The default list is default,unsampled.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402
from minisched_tpu_torch.config import SchedulerConfig  # noqa: E402

MODES = {
    "default": {},
    "unsampled": {"percentage_of_nodes_to_score": 100},
    "full-kernel": {"shortlist": False},
    "sync": {"pipeline": False, "device_resident": False,
             "shortlist": False},
    "c4-soft": {},
    "c4-hard": {},
    "full": {},
    "full-pv": {},
}
# Modes with another workload and profile than the bench's.
WORKLOADS = {
    "c4-soft": (cs.c4_workload, cs.C4_PROFILE),
    "c4-hard": (lambda n, p, seed=0: cs.c4_workload(n, p, seed, max_skew=1,
                                                    hard=True),
                cs.C4_PROFILE),
    "full": (cs.full_workload, cs.FULL_PROFILE),
    "full-pv": (cs.full_workload, cs.FULL_PROFILE),
}


def device_busy(prof, c2b: float, smi: str) -> str:
    """The profile's device time (kernels and copies, summed) against the
    burst, and its five largest kernels."""
    evts = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in evts)
    top = sorted(evts, key=lambda e: -e.self_device_time_total)[:5]
    return (f"device busy {busy_us / 1e3:.1f} ms of the {c2b:.3f} s burst "
            f"({busy_us / 1e4 / c2b:.1f}%); largest: " + "; ".join(
                f"{e.key[:60]} {e.self_device_time_total / 1e3:.1f} ms "
                f"x{e.count}" for e in top) + f" ({smi})")


def one(mode: str, n_pods: int, smi: str, profile: bool = False) -> None:
    """One run in this process: warm up, then the measured burst; the
    last line is the run's numbers as JSON."""
    cfg = SchedulerConfig(platform="", **MODES[mode])
    workload, prof_ = WORKLOADS.get(mode, (cs.bench_workload,
                                           cs.BENCH_PROFILE))
    # The full profile's claims are Bound up front: no PV controller, as
    # in chip_smoke.py's full-profile burst; full-pv runs it beside.
    pv = mode != "full"
    nodes, pods = workload(2_000, 1_024, seed=1)
    cs.drive(cfg, nodes, pods, f"{mode} warm-up", prof_,
             with_pv_controller=pv)
    nodes, pods = workload(cs.N_NODES, n_pods)
    if profile:
        from torch.profiler import ProfilerActivity
        with torch.profiler.profile(
                activities=[ProfilerActivity.CUDA]) as prof:
            m, launches, c2b, per_pod, _ = cs.drive(
                cfg, nodes, pods, mode, prof_, with_pv_controller=pv)
        print(f"{mode} under the profiler: " + device_busy(prof, c2b, smi))
    else:
        m, launches, c2b, per_pod, _ = cs.drive(cfg, nodes, pods, mode,
                                                prof_, with_pv_controller=pv)
    print(cs.path_line(f"{mode} {cs.N_NODES} nodes x {n_pods} pods", m,
                       launches, c2b, per_pod, n_pods, smi))
    b = m["batches"]
    print(json.dumps([c2b, m["step_s_total"] / b, m["prepare_s_total"],
                      m["step_s_total"], m["resolve_s_total"],
                      m["bind_s_total"]]))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--modes", default="default,unsampled")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--pods", type=int, default=cs.N_PODS)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("FAILED: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    if args.one:
        one(args.one, args.pods, smi, args.profile)
        return 0
    print(f"card: {smi}")
    modes = args.modes.split(",")
    order = list(modes)
    if not args.profile:
        order = []
        for _ in range(args.rounds):
            order += modes + modes[::-1]
    results = {m: [] for m in modes}
    for mode in order:
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one", mode,
             "--pods", str(args.pods)] + ["--profile"] * args.profile,
            capture_output=True, text=True)
        if out.returncode:
            print(out.stdout + out.stderr, file=sys.stderr)
            raise SystemExit(f"FAILED: the {mode} run exited "
                             f"{out.returncode}")
        lines = out.stdout.strip().splitlines()
        print("\n".join(lines[-3 if args.profile else -2:-1]), flush=True)
        results[mode].append(json.loads(lines[-1]))
    for mode, rows in results.items():
        med = np.median(np.array(rows), axis=0)
        print(f"median {mode} over {len(rows)} runs: create-to-bound "
              f"{med[0]:.3f} s, step {med[1] * 1e3:.2f} ms per batch; "
              f"prepare {med[2]:.3f} s, step {med[3]:.3f} s, resolve "
              f"{med[4]:.3f} s, bind {med[5]:.3f} s ({smi})")
    return 0


if __name__ == "__main__":
    sys.exit(main())

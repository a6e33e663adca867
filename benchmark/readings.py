"""The readings a comparison's limits are set from: several seeds of one
cell in one process, each a full run at the cell's own size (a short
window at the cell's own load), with the bfloat16 control judged on the
same pods and states.

    python3 -m benchmark.readings --workload <cell> --seeds 1,2,3 \\
        [--seconds 10] [--variants]

Prints one JSON line per seed: the seed, whether the program's run is
correct under the current limits, the numbers compared, and for the
control the same judgement with its own score gap in ``score_gap``'s
place (``control``: it has to come out not correct). ``--variants``
adds the gap of the program's choices under the scoring rules the
program documents where they depart from upstream's (DoNotSchedule
constraints scored, no symmetric preferred terms): a diagnostic, never
part of ``correct``. ``--workload`` may name ``<config>.<traffic>``
that BENCHMARK.json does not list. A machine without a CUDA card gets no
readings.
"""
import argparse
import dataclasses
import json
import sys
import time

from . import harness, run, spec

CONTROL = "bfloat16"   # the precision below the configurations' float32


def judge_controls(compared: dict, lim: dict, controls) -> dict:
    """Each control judged as the program is, with its gap in
    ``score_gap``'s place."""
    out = {}
    for c in controls:
        as_program = dict(compared, score_gap=compared[f"score_gap.{c}"])
        correct, shown = run.judge(as_program, lim)
        out[c] = {"correct": correct, "score_gap": shown["score_gap"]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--variants", action="store_true")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    cell = spec.cell(args.workload)
    lim = run.limits(args.workload)
    variants = None
    if args.variants:
        rules = harness.scoring(cell.config, cell.traffic)
        variants = {"documented": dataclasses.replace(
            rules, score_do_not_schedule=True, symmetric_affinity=False)}
    for seed in (int(s) for s in args.seeds.split(",")):
        rec = harness.run(cell, seed, args.seconds, False, "cuda:0",
                          time.time(), controls=(CONTROL,),
                          variants=variants)
        correct, _shown = run.judge(rec["compared"], lim)
        print(json.dumps({
            "seed": seed, "correct": correct, "compared": rec["compared"],
            "control": judge_controls(rec["compared"], lim, (CONTROL,))}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

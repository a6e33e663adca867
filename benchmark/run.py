"""The benchmark of the PyTorch and CUDA port, one run of one cell.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Runs from the root of a checkout on a machine with a CUDA card. Set-up,
the measured window, the drain and the judgement are in ``harness.py``.
The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer metrics), ``device``, with
``--trace 1`` ``breakdown``, and last ``compared``: each number the
reference compared beside its limit, also printed as the last lines of
standard error. Exits non-zero, printing no result, without enough CUDA
cards, or if JAX or the JAX package was loaded.
"""
import time

T_PROCESS = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "minisched_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def limits(cell_name: str) -> dict:
    from . import spec

    ref = os.path.join(spec.HERE, "reference")
    out = spec.load_json(os.path.join(ref, "limits.json"))
    own = os.path.join(ref, "limits", f"{cell_name}.json")
    if os.path.exists(own):
        out.update(spec.load_json(own))
    return out


def judge(compared: dict, lim: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}) over every limited number."""
    shown = {}
    ok = True
    for name, limit in lim.items():
        if name not in compared:
            continue
        v = compared[name]
        shown[name] = {"value": v, "limit": limit}
        ok &= v <= limit
    return bool(ok), shown


def describe(values, qs=(0.5, 0.95, 0.99)) -> str:
    from .layers import nearest_rank

    if not len(values):
        return "-"
    return "/".join(f"{nearest_rank(values, q):.4f}" for q in qs)


def end_to_end(cell, rec: dict) -> dict:
    return {m["name"]: {"value": cell.readers[m["name"]](rec),
                        "unit": m["unit"]} for m in cell.end_to_end}


def per_layer(cell, rec: dict) -> dict:
    out = {}
    for m in cell.per_layer:
        v = cell.readers[m["name"]](rec)
        if v is not None and math.isfinite(v):
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def result_line(cell, rec: dict, trace: bool, device: dict,
                lim: dict) -> dict:
    correct, shown = judge(rec["compared"], lim)
    out = {"correct": correct, "attempted": rec["attempted"],
           "failed": int(rec["compared"]["unbound"]),
           "metrics": per_layer(cell, rec) if trace else end_to_end(
               cell, rec),
           "device": device}
    prof = rec.get("profile")
    if trace and prof:
        device["busy_s"] = prof["busy_s"]
        device["window_s"] = prof["window_s"]
        out["breakdown"] = {"device_ops": prof["device_ops"],
                            "idle_gaps": prof["idle_gaps"]}
    out["compared"] = shown
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from . import spec

    cell = spec.cell(args.workload)
    import torch

    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell.chips):
        print(f"{args.workload} needs {cell.chips} CUDA card(s); "
              f"available: {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    from . import harness

    rec = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda:0", T_PROCESS)
    bad = forbidden_modules()
    if bad:
        print(f"loaded in the run's process: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips,
              "memory_peak_bytes": rec["memory_peak_bytes"]}
    line = result_line(cell, rec, bool(args.trace), device,
                       limits(args.workload))
    c = rec["counters"]
    print(f"window {rec['seconds']:.3f} s: {rec['bound_in_window']} pods "
          f"bound, {c.get('batches', 0):.0f} batches, "
          f"{c.get('pods_seen', 0):.0f} pods seen, "
          f"{rec['pending_at_close']} pending at the close; create-to-bound "
          f"of the pods bound in it p50/p95/p99 {describe(rec['c2b_s'])} s; "
          f"bound in each fifth of it {rec['bound_by_fifth']}",
          file=sys.stderr)
    h, per = rec["host"], lambda k: 1e3 * c.get(k, 0) / max(
        c.get("batches", 0), 1)
    print(f"host over the window: gc pauses {h['gc_s']:.3f} s "
          f"(gen0/1/2 " + "/".join(f"{h['gc'][g]['n']}:{h['gc'][g]['s']:.3f}"
                                   for g in ("gen0", "gen1", "gen2"))
          + f", longest {h['gc_longest_s']:.3f} s, by fifth "
          f"{[round(x, 3) for x in h['gc_s_by_part']]}); process cpu "
          f"user {h.get('cpu_user_s', 0):.2f} s sys "
          f"{h.get('cpu_sys_s', 0):.2f} s; {h['threads']} threads on "
          f"{h['cores']} cores; a batch's prepare/step/resolve/bind "
          f"{per('prepare_s_total'):.1f}/{per('step_s_total'):.1f}/"
          f"{per('resolve_s_total'):.1f}/{per('bind_s_total'):.1f} ms",
          file=sys.stderr)
    for name, v in line["compared"].items():
        print(f"compared {name} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

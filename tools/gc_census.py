"""What the interpreter's collector walks while the port schedules a
backlog: the tracked objects promoted into the oldest generation per
bound pod, by type, and the collections' cost per pod.

    python tools/gc_census.py --nodes 600 --pods 4096 [--seed N] \\
        [--workload kube-default-50k.backlog10k-claims] [--top 12]

Runs on the CPU (``SchedulerConfig(platform="cpu")``: the kernels'
plain versions). The cell's configuration and traffic mix come from
``BENCHMARK.json`` with the cluster cut to ``--nodes``; the nodes and
pods come from the benchmark's own generator (``benchmark/workload.py``)
through its harness's set-up (``benchmark/harness.Run``). After set-up
and one full collection it keeps the mix's backlog standing until
``--pods`` more pods are created, waits for every one to bind, and
prints one JSON line:

- ``promoted_per_pod``: objects that survived a gen-1 or gen-2
  collection out of the young generations, over the pods bound, by type;
- ``retained_per_pod``: tracked objects left after a full collection at
  the end against the count after set-up, over the pods bound, by type;
- ``gc``: each generation's collections and pause seconds, and the
  gen-2 microseconds per bound pod;
- ``store``: the store's snapshot counters, where it has them.

CPython (3.12) runs a gen-2 pass once the objects promoted since the
last one exceed a quarter of those already in the oldest generation, so
the gen-2 cost per pod is about four times the promotions per pod times
the cost to walk one object, whatever the heap's size. The census of
each collection (listing the young generations before it and the oldest
after it) runs outside the timed pause, but it allocates, so compare
its timings only with another census run.
"""
from __future__ import annotations

import argparse
import collections
import copy
import gc
import itertools
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

CELL = "kube-default-50k.backlog10k-claims"


def _objects(*generations):
    """The objects of ``generations``, as a lazy iterator for a C
    consumer: every reference to them is dropped before control returns
    to Python code (a list of them held across bytecode would let
    another thread find a refcount of 2 on a tuple it is still building
    and fail in ``_PyTuple_Resize``)."""
    return itertools.chain.from_iterable(map(gc.get_objects, generations))


def _count_types(counts: dict, *generations) -> dict:
    collections._count_elements(counts, map(type, _objects(*generations)))
    return counts


class Census:
    """A ``gc.callbacks`` hook: times every collection and, for the
    gen-1 and gen-2 ones, counts by type the young objects that survive
    into the oldest generation (by id: it holds no reference to them)."""

    def __init__(self):
        self.n = [0, 0, 0]
        self.s = [0.0, 0.0, 0.0]
        self.promoted: dict = {}
        self._young = None
        self._t = 0.0

    def __call__(self, phase: str, info: dict) -> None:
        gen = int(info["generation"])
        if phase == "start":
            if gen >= 1:
                self._young = set(map(id, _objects(0, 1)))
            self._t = time.perf_counter()
            return
        self.n[gen] += 1
        self.s[gen] += time.perf_counter() - self._t
        if self._young is not None:
            young, self._young = self._young, None
            # Two listings of the oldest generation, in one C call: the
            # same objects in the same order (the first listing lives in
            # the youngest generation).
            collections._count_elements(self.promoted, itertools.compress(
                map(type, _objects(2)),
                map(young.__contains__, map(id, _objects(2)))))


def by_name(counts: dict) -> collections.Counter:
    out = collections.Counter()
    for t, n in counts.items():
        out[t.__name__] += n
    return out


def per_pod(counter: collections.Counter, pods: int, top: int) -> dict:
    total = sum(counter.values())
    out = {"total": round(total / max(pods, 1), 2)}
    for name, n in counter.most_common(top):
        out[name] = round(n / max(pods, 1), 2)
    return out


def run(workload: str, nodes: int, pods: int, seed: int, top: int) -> dict:
    from benchmark import harness, spec

    cell = spec.cell(workload)
    cell.config = copy.deepcopy(cell.config)
    cell.traffic = copy.deepcopy(cell.traffic)
    cell.config["cluster"]["nodes"] = nodes
    r = harness.Run(cell, seed, 0.0, False, "cpu")
    census = Census()
    try:
        r.setup()
        gc.collect()
        before = by_name(_count_types({}, None))
        target = r.created + pods
        backlog = int(cell.traffic["backlog"])
        chunk = int(cell.traffic["chunk"])
        bound0 = r.bound()
        gc.callbacks.append(census)
        while r.created < target:
            if r.created - r.bound() < backlog:
                n = min(chunk, target - r.created)
                r.create(range(r.created, r.created + n))
                r.created += n
            else:
                time.sleep(harness.CLOSED_POLL_S)
        if not harness.wait_until(lambda: r.bound() >= target, 600.0):
            raise RuntimeError(f"{r.bound()} of {target} pods bound")
        gc.callbacks.remove(census)
        bound = r.bound() - bound0
        stats = getattr(r.cluster.store, "stats", dict)()
        gc.collect()
        retained = by_name(_count_types({}, None))
        retained.subtract(before)
    finally:
        if census in gc.callbacks:
            gc.callbacks.remove(census)
        r.shutdown()
    return {
        "workload": workload, "nodes": nodes, "pods_bound": bound,
        "seed": seed,
        "python": sys.version.split()[0],
        "promoted_per_pod": per_pod(by_name(census.promoted), bound, top),
        "retained_per_pod": per_pod(retained, bound, top),
        "gc": {"collections": census.n,
               "pause_s": [round(s, 4) for s in census.s],
               "gen2_us_per_pod": round(1e6 * census.s[2] / max(bound, 1),
                                        1),
               "gen01_us_per_pod": round(
                   1e6 * (census.s[0] + census.s[1]) / max(bound, 1), 1)},
        "store": {k: v for k, v in stats.items()
                  if k.startswith("snapshots_")},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", default=CELL)
    ap.add_argument("--nodes", type=int, default=600)
    ap.add_argument("--pods", type=int, default=4096)
    ap.add_argument("--seed", type=int, default=9700000001)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)
    print(json.dumps(run(args.workload, args.nodes, args.pods, args.seed,
                         args.top)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

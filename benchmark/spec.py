"""Find a cell's parts by name.

``BENCHMARK.json`` at the checkout's root names each cell's
configuration and traffic mix; the files are found by those names:

    benchmark/configs/<config>.json
    benchmark/traffic/<traffic>.json
    benchmark/end_to_end/<metric>.py   (end-to-end metrics: ``read(record)``)
    benchmark/metrics/<metric>.py      (per-layer metrics: ``read(record)``)

A per-layer metric named ``<stem>.<suffix>`` (``prepare_ms.backlog``)
reads ``metrics/<stem>.py`` unless a file of its whole name is there, so
the same quantity moving another end-to-end metric needs only an entry.
A later change adds a configuration, a mix, a cell or a metric by adding
files and entries, and edits none of these.
"""
from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    readers: Dict[str, Callable] = field(default_factory=dict)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def _applies(metric: dict, cell: str, reported: set) -> bool:
    """A metric is read in the cells its ``workloads`` lists; without the
    key, in every cell that reports the end-to-end metric it moves (for
    an end-to-end metric: in every cell)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") is None or metric["moves"] in reported


def load_reader(kind: str, metric: str) -> Callable:
    """``read`` of ``<kind>/<metric>.py``, else of ``<kind>/<stem>.py``
    (the metric's name before its first dot)."""
    path = os.path.join(HERE, kind, f"{metric}.py")
    if not os.path.exists(path):
        path = os.path.join(HERE, kind, f"{metric.split('.')[0]}.py")
    name = f"benchmark_{kind}_" + os.path.basename(path)[:-3].replace(
        ".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell(name: str, root: str = ROOT,
         bench: Optional[dict] = None) -> Cell:
    """Cell ``name`` of ``BENCHMARK.json`` with its parts loaded. A name
    ``<config>.<traffic>`` that BENCHMARK.json does not list is built
    from those two files alone, with no metric (for the readings of a
    cell that is not, or not yet, in the benchmark)."""
    bench = bench if bench is not None else benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        config, _, traffic = name.partition(".")
        paths = (os.path.join(HERE, "configs", f"{config}.json"),
                 os.path.join(HERE, "traffic", f"{traffic}.json"))
        if not all(os.path.exists(p) for p in paths):
            raise KeyError(f"no cell {name!r} in BENCHMARK.json; cells: "
                           f"{sorted(cells)}")
        return Cell(name=name, chips=1, config=load_json(paths[0]),
                    traffic=load_json(paths[1]), end_to_end=[],
                    per_layer=[])
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(os.path.join(root, configs[w["config"]]["file"]))
    traffic = load_json(os.path.join(HERE, "traffic",
                                     f"{w['traffic']}.json"))
    e2e = [m for m in bench["end_to_end"] if _applies(m, name, set())]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _applies(m, name, reported)]
    readers = {m["name"]: load_reader("end_to_end", m["name"])
               for m in e2e}
    readers.update({m["name"]: load_reader("metrics", m["name"])
                    for m in per_layer})
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic, end_to_end=e2e, per_layer=per_layer,
                readers=readers)

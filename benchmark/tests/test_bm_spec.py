"""BENCHMARK.json and every part it names load by name, and the file
keeps to the contract's shapes and limits."""
import json
import os
import re

import pytest

from benchmark import harness, run, spec

from .tiny import SPREAD

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_keys():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += CELLS + [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert "\n" not in m["layer"] and 0 < len(m["layer"]) <= 200
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        for w in m.get("workloads", ()):
            assert w in CELLS
    assert {m["name"] for m in BENCH["end_to_end"]} >= {"setup_s"}


def test_layers_are_named_alike():
    by_layer = {}
    for m in BENCH["per_layer"]:
        by_layer.setdefault(m["layer"].split(":")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values()), by_layer


def test_run_seconds_fit_a_full_check():
    cells = 24
    total = (2 + 14 * cells) * (BENCH["run_seconds"] + 60) + cells * 180
    assert 1 <= BENCH["run_seconds"] <= 51 and total + 1200 <= 43200


@pytest.mark.parametrize("name", CELLS)
def test_cell_loads_by_name(name):
    cell = spec.cell(name)
    assert cell.chips == 1
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert cell.per_layer, "every cell reports a per-layer metric"
    for m in cell.per_layer:
        assert callable(cell.readers[m["name"]])
        assert m["moves"] in reported


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(cfg):
    path = os.path.join(spec.ROOT, cfg["file"])
    assert cfg["file"].startswith("benchmark/configs/")
    c = spec.load_json(path)
    assert c["name"] == cfg["name"] and cfg["reduced"] == []
    assert c["cluster"]["nodes"] == 50000
    assert c["guarantees"] and c["assumed"]
    assert any(w["config"] == cfg["name"] for w in BENCH["workloads"])


def test_every_metric_reader_file_exists():
    """Each metric's reader: its own file, or its stem's."""
    for kind, metrics in (("end_to_end", BENCH["end_to_end"]),
                          ("metrics", BENCH["per_layer"])):
        for m in metrics:
            assert any(os.path.exists(os.path.join(spec.HERE, kind,
                                                   f"{n}.py"))
                       for n in (m["name"], m["name"].split(".")[0]))


def test_every_end_to_end_metric_has_a_definition():
    rec = {"setup_s": 1.0, "bound_in_window": 10, "seconds": 2.0}
    for name in CELLS:
        cell = spec.cell(name)
        out = run.end_to_end(cell, rec)
        assert set(out) == {m["name"] for m in cell.end_to_end}
        assert all(v["value"] > 0 for v in out.values())
    assert run.end_to_end(spec.cell(CELLS[0]), rec)["pods_per_s"][
        "value"] == 5.0


def test_a_suffixed_metric_reads_its_stems_file():
    """``<stem>.<suffix>`` needs no file of its own: a later cell's
    ``prepare_ms.open`` reads ``metrics/prepare_ms.py``."""
    read = spec.load_reader("metrics", "prepare_ms.open")
    rec = {"counters": {"batches": 4.0, "prepare_s_total": 0.2}}
    assert read(rec) == pytest.approx(50.0)
    with pytest.raises(FileNotFoundError):
        spec.load_reader("metrics", "no_such_metric.backlog")


def test_a_cell_outside_the_benchmark_loads_from_its_files():
    cell = spec.cell(SPREAD)
    assert cell.config["name"] == "kube-default-50k-adaptive"
    assert cell.traffic["pod"]["spread"]["when_unsatisfiable"] == (
        "DoNotSchedule")
    assert cell.end_to_end == [] and cell.per_layer == []
    with pytest.raises(KeyError):
        spec.cell("kube-default-50k.no-such-mix")


@pytest.mark.parametrize("config", ["kube-default-50k",
                                    "kube-default-50k-adaptive"])
def test_profile_is_found_by_its_path(config):
    c = spec.load_json(os.path.join(spec.HERE, "configs", f"{config}.json"))
    prof = harness.profile(c)
    assert set(c["score_weights"].items()) <= set(prof.weights.items())
    assert set(c["filters"]) <= set(prof.plugins)


def test_limits_name_compared_numbers():
    lim = run.limits(CELLS[0])
    assert lim["score_gap"] > 0
    assert all(v == 0 for k, v in lim.items() if k != "score_gap")

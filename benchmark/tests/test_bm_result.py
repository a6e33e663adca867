"""The result line's shape, and the traced run's reduction."""
import json

import pytest

from benchmark import layers, run, spec, tracing

from .tiny import tiny_cell, tiny_run

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


def _device():
    return {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
            "memory_peak_bytes": 1}


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_last_line_shape(name, trace):
    rec = tiny_run(name, trace=trace)
    cell = tiny_cell(name)
    line = run.result_line(cell, rec, trace, _device(), run.limits(name))
    json.loads(json.dumps(line))
    keys = list(line)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"] and keys[-1] == "compared"
    assert line["correct"] is True and line["attempted"] > 0
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    for v in line["compared"].values():
        assert set(v) == {"value", "limit"}
    want = {m["name"] for m in (cell.per_layer if trace
                                else cell.end_to_end)}
    got = set(line["metrics"])
    if trace:
        # the CPU run has no device trace: only the counters' metrics
        assert got and got <= want
        assert "breakdown" in line and "busy_s" in line["device"]
    else:
        assert got == want


SELECT = "(anonymous namespace)::shortlist_select_kernel(float const*, int)"


def _trace():
    # wall ns = baseTimeNanoseconds + 1000 * ts; two kernels and a copy
    ev = [
        {"ph": "X", "cat": "kernel",
         "name": SELECT,
         "ts": 100.0, "dur": 200.0},
        {"ph": "X", "cat": "kernel", "name": "add", "ts": 250.0,
         "dur": 100.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH",
         "ts": 600.0, "dur": 100.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 0.0,
         "dur": 10.0},
    ]
    return {"traceEvents": ev, "baseTimeNanoseconds": 1_000_000}


def test_reduce_trace():
    w0, w1 = 1_000_000, 1_000_000 + 1_000_000   # 1,000 us
    host = [("resolve", w0 + 350_000, w0 + 600_000),
            ("prepare", w0 + 700_000, w1)]
    r = tracing.reduce_trace(_trace(), w0, w1, host)
    assert r["window_s"] == pytest.approx(1e-3)
    assert r["busy_s"] == pytest.approx(350e-6)   # [100,350] + [600,700]
    assert r["ops"][SELECT] == {
        "s": pytest.approx(2e-4), "n": 1}
    gaps = dict(r["idle_gaps"])
    assert gaps["resolve"] == pytest.approx(250e-6)
    assert gaps["prepare"] == pytest.approx(300e-6)
    assert gaps["none"] == pytest.approx(100e-6)
    assert tracing.kernel_name(r["device_ops"][0][0]) == (
        "shortlist_select_kernel")


def test_layer_readers():
    w0 = 1_000_000
    prof = tracing.reduce_trace(_trace(), w0, w0 + 1_000_000, [])
    prof["counters"] = {"batches": 1.0, "scored_rows_total": 1024.0 * 53248}
    rec = {"profile": prof, "shapes": (1024, 53248, 0),
           "config": spec.cell(CELLS[0]).config,
           "counters": {"batches": 2.0, "pods_seen": 1024.0,
                        "prepare_s_total": 0.1},
           "max_batch_size": 1024}
    assert layers.device_idle(rec) == pytest.approx(65.0)
    assert layers.step_device_ms(rec) == pytest.approx(0.2)
    assert layers.batch_fill(rec) == pytest.approx(50.0)
    assert layers.per_batch_ms(rec, "prepare_s_total") == pytest.approx(50)
    share = layers.kernel_roofline(rec, "shortlist_select_kernel",
                                   layers.select_bound_s)
    moved = 4 * 1024 * 53248 + 8 * 1024 * 128 + 8 * 1024
    assert share == pytest.approx(100 * moved / 3.35e12 / 2e-4)
    assert layers.kernel_roofline(rec, "caps_scan_kernel",
                                  layers.caps_bound_s) is None
    assert layers.device_idle({"profile": None}) is None

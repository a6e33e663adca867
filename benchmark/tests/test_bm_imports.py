"""What a run loads: no JAX and no JAX package in the run's process, and
nothing of the program in the reference. A run without a CUDA card, or
without the program beside the benchmark, exits non-zero and prints no
result."""
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import spec

ROOT = spec.ROOT
CELL = spec.benchmark()["workloads"][0]["name"]


def _py(code: str, cwd: str = ROOT, env=None):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd,
                          capture_output=True, text=True, timeout=600,
                          env=env)


def test_dry_run_loads_no_jax():
    code = (
        "import sys\n"
        "from benchmark.tests.tiny import tiny_run\n"
        "from benchmark import run\n"
        f"rec = tiny_run({CELL!r}, seconds=1.0)\n"
        "assert rec['compared']['unbound'] == 0\n"
        "print('FORBIDDEN', run.forbidden_modules())\n"
        "print('TOP', sorted({m.split('.')[0] for m in sys.modules}))\n")
    p = _py(code)
    assert p.returncode == 0, p.stderr[-3000:]
    assert "FORBIDDEN []" in p.stdout
    top = eval(p.stdout.split("TOP ", 1)[1].strip())
    assert not {"jax", "jaxlib", "flax", "minisched_tpu"} & set(top)
    assert "minisched_tpu_torch" in top


def test_reference_loads_nothing_of_the_program():
    p = _py("import sys\nimport benchmark.reference.check\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    assert p.returncode == 0, p.stderr
    top = eval(p.stdout.strip())
    assert not {"minisched_tpu_torch", "minisched_tpu", "jax"} & set(top)


def _main(cwd: str):
    return subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", CELL,
         "--seed", "2147483659", "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=600)


def test_without_a_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    p = _main(ROOT)
    assert p.returncode != 0 and p.stdout == ""


def test_benchmark_alone_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _main(str(tmp_path))
    assert p.returncode != 0 and p.stdout == ""


@pytest.mark.card
def test_one_short_run_on_the_card(card):
    p = _main(ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    import json

    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"

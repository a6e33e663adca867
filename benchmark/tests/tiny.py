"""The benchmark's cells at a size a CPU test holds, run on the CPU
(``SchedulerConfig(platform="cpu")``: the kernels' plain versions)."""
import copy
import time

# A cell at a size a CPU test holds: 400 nodes, batches of 64.
TINY_NODES, TINY_BATCH = 400, 64

# The hard-spread cell, left out of BENCHMARK.json (PERF.md, Open
# questions): its configuration and mix stay, and the reference's
# topology terms are tested on it.
SPREAD = "kube-default-50k-adaptive.backlog10k-spread-hard"


def tiny_cell(name: str):
    """Cell ``name`` (of BENCHMARK.json, or ``<config>.<traffic>``) cut to
    a CPU test's size."""
    from benchmark import spec

    cell = spec.cell(name)
    cell.config = copy.deepcopy(cell.config)
    cell.traffic = copy.deepcopy(cell.traffic)
    cell.config["cluster"]["nodes"] = TINY_NODES
    cell.config["scheduler"]["max_batch_size"] = TINY_BATCH
    t = cell.traffic
    t["warm_pods"] = TINY_BATCH
    t["backlog"], t["chunk"] = 4 * TINY_BATCH, TINY_BATCH
    t["sample"], t["profile_s"], t["drain_s"] = 200, 1, 30
    return cell


def tiny_run(name: str, seed: int = 12345678901, seconds: float = 2.0,
             trace: bool = False, controls: tuple = (), variants=None):
    from benchmark import harness

    return harness.run(tiny_cell(name), seed, seconds, trace, "cpu",
                       time.time(), controls=controls, variants=variants)

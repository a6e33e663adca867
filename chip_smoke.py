"""Drive the PyTorch/CUDA port on one GPU and check it end to end.

    python3 chip_smoke.py

Needs a CUDA card and the CUDA toolkit (nvcc); exits non-zero without
them, and on any mismatch. Phases, each printing its own lines:

  1. the card (nvidia-smi name and power limit) and the torch/CUDA build;
  2. build the greedy-assignment kernel with nvcc;
  3. kernel vs its plain PyTorch version on the card, bitwise, at the
     shapes of tests/test_pallas_select.py, at a shape that runs 132
     blocks with uneven slices, and at full width (one 1024-pod batch
     against 50,000 nodes, R=10, bench workload), with the kernel's time
     per pod beside the earlier grid-barrier kernel's time;
  4. one full-width build_step batch (bench profile) on cuda vs on cpu,
     every Decision field bitwise;
  5. the main path: Cluster(...).start() on the card with the bench
     profile, 50,000 nodes x 10,000 pods, all bound, no node over its
     allocatable, the kernel launched in every batch;
  6. the reference's README scenario on the card.

The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from minisched_tpu_torch.config import SchedulerConfig
from minisched_tpu_torch.encode import NodeFeatureCache, encode_pods, to_torch
from minisched_tpu_torch.encode.cache import step_bucket
from minisched_tpu_torch.ops import greedy_kernel, prng
from minisched_tpu_torch.ops.pipeline import build_step, evaluate
from minisched_tpu_torch.ops.select import NEG, greedy_assign_plain
from minisched_tpu_torch.scenario.runner import (Cluster, default_scenario,
                                                 run_scenario, wait_until)
from minisched_tpu_torch.service.defaultconfig import Profile
from minisched_tpu_torch.state import objects as O

N_NODES, N_PODS, BATCH = 50_000, 10_000, 1024
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
# The earlier kernel (one grid barrier per pod, commit 969202e) at the
# full-width shape, for reference: PERF.md, NVIDIA H100 80GB HBM3, 700 W.
GRID_BARRIER_KERNEL_MS = 5.059
F32_OPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
BENCH_PROFILE = Profile(
    name="bench",
    plugins=["NodeUnschedulable", "NodeResourcesFit",
             "NodeResourcesLeastAllocated",
             "NodeResourcesBalancedAllocation"],
    plugin_args={"NodeResourcesFit": {"score_strategy": None}})


def bench_workload(n_nodes: int, n_pods: int, seed: int = 0):
    """The repo's benchmark cluster (bench_workload.make_workload): node
    CPU 4-32 cores, ~1% unschedulable, 16 zones; pods of 0.25-1.75 cores
    + 2 GiB."""
    rng = np.random.default_rng(seed)
    node_cpus = np.array([4000, 8000, 16000, 32000])[
        rng.integers(0, 4, n_nodes)]
    pod_cpus = rng.integers(1, 8, n_pods) * 250
    nodes = [O.Node(metadata=O.ObjectMeta(name=f"node-{i}-{i % 10}",
                                          labels={"zone": f"z{i % 16}"}),
                    spec=O.NodeSpec(unschedulable=bool(i % 97 == 0)),
                    status=O.NodeStatus(allocatable={
                        "cpu": float(node_cpus[i]),
                        "memory": float(64 << 30), "pods": 110.0}))
             for i in range(n_nodes)]
    pods = [O.Pod(metadata=O.ObjectMeta(name=f"pod-{i}-{i % 10}",
                                        namespace="bench"),
                  spec=O.PodSpec(requests={"cpu": float(pod_cpus[i]),
                                           "memory": float(2 << 30)}))
            for i in range(n_pods)]
    return nodes, pods


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"FAILED: {what}")


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn) -> float:
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3


def compare(kernel, plain) -> float:
    """Bitwise equality of two AssignResults; returns the max abs error
    (0.0 when equal)."""
    check(torch.equal(kernel.chosen, plain.chosen), "chosen differs")
    check(torch.equal(kernel.assigned, plain.assigned), "assigned differs")
    check(torch.equal(kernel.free_after.view(torch.int32),
                      plain.free_after.view(torch.int32)),
          "free_after differs bitwise")
    return max(float((kernel.chosen - plain.chosen).abs().max()),
               float((kernel.free_after - plain.free_after).abs().max()))


def random_case(rng, P, N, R=4, quant=4, infeasible=0.2, cpu_free=500.0):
    """The random shapes of tests/test_pallas_select.py: quantized scores
    (ties), NEG on infeasible pairs, contended CPU."""
    s = rng.random((P, N), dtype=np.float32)
    s = (np.round(s * quant) / quant).astype(np.float32)
    s[rng.random((P, N)) < infeasible] = NEG
    req = np.concatenate([rng.random((P, 1)) * 300 + 100,
                          np.ones((P, R - 1))], axis=1).astype(np.float32)
    free = np.concatenate([np.full((N, 1), cpu_free),
                           np.full((N, R - 1), 50.0)],
                          axis=1).astype(np.float32)
    return [torch.from_numpy(a).cuda() for a in (s, req, free)]


def full_width_batch(nodes, pods):
    """The first 1024-pod batch of the bench workload against every node,
    encoded by the port's own cache and encoder (host numpy)."""
    cache = NodeFeatureCache()
    cache.upsert_nodes_bulk(nodes)
    pad = step_bucket(len(nodes))
    nf, _names, _sv, _incs = cache.snapshot_versioned(pad=pad)
    af = cache.snapshot_assigned(pad=16)
    eb = encode_pods(pods[:BATCH], step_bucket(BATCH), cfg=cache.cfg,
                     registry=cache.registry)
    return eb, nf, af


def main() -> int:
    if not torch.cuda.is_available():
        print("FAILED: no CUDA device", file=sys.stderr)
        return 2
    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build
    t = time.perf_counter()
    lib = greedy_kernel.build()
    print(f"build: greedy_assign {time.perf_counter() - t:.2f} s ({smi})")
    with open(lib + ".log") as f:
        print("ptxas: " + " | ".join(
            ln.strip() for ln in f if "registers" in ln or "spill" in ln))

    # 3. kernel vs plain version on the card
    rng = np.random.default_rng(0)
    seed = prng.bits(prng.fold_in(prng.PRNGKey(0), 1))
    err = 0.0
    for name, P, N, kw in (("ties", 16, 128, {}),
                           ("scarce", 24, 128, {"cpu_free": 300.0}),
                           ("off-tile", 13, 200, {}),
                           ("uneven 132-block", 256, 8449, {"R": 10})):
        args = random_case(rng, P, N, **kw)
        k = greedy_kernel.greedy_assign_cuda(*args, seed)
        p = greedy_assign_plain(*args, seed)
        torch.cuda.synchronize()
        err = max(err, compare(k, p))
        print(f"kernel vs plain {name} {P}x{N}x{args[1].shape[1]}: bitwise "
              f"equal, {int(p.assigned.sum())} assigned")

    plugin_set = BENCH_PROFILE.build()
    nodes, pods = bench_workload(N_NODES, N_PODS)
    eb, nf, af = full_width_batch(nodes, pods)
    eb_d, nf_d, af_d = (to_torch(x, "cuda") for x in (eb, nf, af))
    scores, _fc, _rc = evaluate(plugin_set, eb_d, nf_d, af_d)
    eval_ms = cuda_ms(lambda: evaluate(plugin_set, eb_d, nf_d, af_d), reps=5)
    args = (scores, eb_d.pf.requests, nf_d.free)
    P, N = scores.shape
    R = args[1].shape[1]
    k = greedy_kernel.greedy_assign_cuda(*args, seed)
    p = greedy_assign_plain(*args, seed)
    torch.cuda.synchronize()
    err = max(err, compare(k, p))
    kernel_ms = cuda_ms(lambda: greedy_kernel.greedy_assign_cuda(*args, seed),
                        reps=20)
    plain_ms = host_ms(lambda: greedy_assign_plain(*args, seed))
    moved = 4 * (P * N + P * R + N * R) + 4 * P + P + 4 * N * R
    compares = P * N * (R + 2)  # fits per axis, score and noise order
    bound_s = max(moved / HBM_BYTES_PER_S, compares / F32_OPS_PER_S)
    bound_by = ("bytes" if moved / HBM_BYTES_PER_S
                >= compares / F32_OPS_PER_S else "operations")
    print(f"kernel vs plain full width {P}x{N}x{R}: bitwise equal, "
          f"{int(p.assigned.sum())} assigned; kernel {kernel_ms:.3f} ms "
          f"({kernel_ms * 1e3 / P:.3f} us per pod; grid-barrier kernel "
          f"{GRID_BARRIER_KERNEL_MS} ms), plain {plain_ms:.1f} ms, bound "
          f"{bound_s * 1e3:.4f} ms ({bound_by}) ({smi})")
    print(f"step parts at full width: filters+scores {eval_ms:.3f} ms, "
          f"greedy kernel {kernel_ms:.3f} ms ({smi})")
    del scores, args, k, p

    # 4. one full-width step, cuda vs cpu
    step = build_step(plugin_set)
    key = prng.fold_in(prng.PRNGKey(0), 1)
    t = time.perf_counter()
    d_gpu = step(eb_d, nf_d, af_d, key)
    torch.cuda.synchronize()
    gpu_s = time.perf_counter() - t
    t = time.perf_counter()
    d_cpu = step(to_torch(eb, "cpu"), to_torch(nf, "cpu"),
                 to_torch(af, "cpu"), key)
    cpu_s = time.perf_counter() - t
    for field in d_cpu._fields:
        a, b = getattr(d_gpu, field).cpu(), getattr(d_cpu, field)
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        check(torch.equal(a, b), f"step field {field}: cuda != cpu")
    print(f"step full width {P}x{N}: every Decision field bitwise equal "
          f"cuda vs cpu; cuda {gpu_s:.3f} s, cpu {cpu_s:.3f} s ({smi})")
    del eb_d, nf_d, af_d, d_gpu, d_cpu

    # 5. the main path
    cfg = SchedulerConfig(platform="")
    cluster = Cluster()
    try:
        cluster.create_objects(nodes)
        cluster.start(BENCH_PROFILE, cfg)
        check(wait_until(lambda: cluster.service.scheduler.cache.node_count()
                         == N_NODES, timeout=120),
              "informers did not sync the nodes")
        greedy_kernel.LAUNCHES["greedy_assign"] = 0
        cluster.create_objects(pods)
        sched = cluster.service.scheduler

        def settled() -> bool:
            # A batch's pods may all be bound by the binder thread before
            # the scheduling thread folds that batch into its metrics.
            m = sched.metrics()
            return m["cycle_errors"] > 0 or (
                m["pods_bound"] >= N_PODS and m["kernel_launches"]
                == greedy_kernel.LAUNCHES["greedy_assign"])

        wait_until(settled, timeout=300, interval=0.05)
        launches = greedy_kernel.LAUNCHES["greedy_assign"]
        m = sched.metrics()
        check(m["cycle_errors"] == 0, "a scheduling cycle failed")
        check(m["pods_bound"] >= N_PODS,
              f"only {m['pods_bound']} of {N_PODS} pods bound")
        placed = [p for p in cluster.list_pods() if p.spec.node_name]
        check(len(placed) == N_PODS, f"{len(placed)} pods bound in the store")
        # Store stamps: creation_timestamp at create, scheduled_time at bind.
        created = np.array([p.metadata.creation_timestamp for p in placed])
        bound_at = np.array([p.status.scheduled_time for p in placed])
        c2b = float(bound_at.max() - created.min())
        per_pod = bound_at - created
        used: dict = {}
        for pod in placed:
            u = used.setdefault(pod.spec.node_name, [0.0, 0.0, 0])
            u[0] += pod.spec.requests["cpu"]
            u[1] += pod.spec.requests["memory"]
            u[2] += 1
        for node in cluster.list_nodes():
            u = used.get(node.metadata.name)
            if u is None:
                continue
            alloc = node.status.allocatable
            check(u[0] <= alloc["cpu"] and u[1] <= alloc["memory"]
                  and u[2] <= alloc["pods"],
                  f"node {node.metadata.name} over-committed: {u}")
            check(not node.spec.unschedulable,
                  f"pod bound to unschedulable {node.metadata.name}")
        check(launches >= m["batches"] > 0 and m["kernel_launches"]
              == launches, f"kernel launches {launches} for "
              f"{m['batches']} batches")
        print(f"main path {N_NODES} nodes x {N_PODS} pods: all bound, none "
              f"over-committed, {m['batches']} batches, {launches} kernel "
              f"launches; create-to-bound {c2b:.3f} s for all, "
              f"{N_PODS / c2b:.1f} pods/s, per pod p50 "
              f"{np.percentile(per_pod, 50):.3f} s p99 "
              f"{np.percentile(per_pod, 99):.3f} s; prepare "
              f"{m['prepare_s_total']:.3f} s, step {m['step_s_total']:.3f} s,"
              f" resolve {m['resolve_s_total']:.3f} s, bind "
              f"{m['bind_s_total']:.3f} s ({smi})")
    finally:
        cluster.shutdown()

    # 6. the README scenario on the card
    run_scenario(default_scenario, config=SchedulerConfig(platform=""))
    print("README scenario: pod1 pending on NodeUnschedulable, then bound "
          "to node10")

    print(json.dumps({"kernels": [{
        "name": "greedy_assign",
        "route": "cuda",
        "source": "minisched_tpu_torch/csrc/greedy_assign.cu",
        "replaces": "minisched_tpu/ops/pallas_select.py:151",
        "launches": launches,
        "max_abs_err": err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_s * 1e3,
        "bound_by": bound_by,
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Drive the PyTorch/CUDA port on one GPU and check it end to end.

    python3 chip_smoke.py

Needs a CUDA card and the CUDA toolkit (nvcc); exits non-zero without
them, and on any mismatch. Phases, each printing its own lines:

  1. the card (nvidia-smi name and power limit) and the torch/CUDA build;
  2. build the five kernels with nvcc, one process each, all at once,
     and print each ptxas report;
  3. the greedy-assignment kernel vs its plain PyTorch version on the
     card, bitwise, at the shapes of tests/test_pallas_select.py, at a
     shape that runs 132 blocks with uneven slices, and at full width
     (one 1024-pod batch against 50,000 nodes, R=10, bench workload);
  4. the shortlist selection kernel vs shortlist_select_plain and the
     shortlist scan kernel vs its plain version, bitwise on all four
     outputs each, at the shapes of tests/test_shortlist.py (random,
     plateau, contention, K in {1, 16, 128, N}), off-tile (13x200), a
     6,000-pod batch whose overlay does not fit in shared memory (the
     scan's device layout), rows of signed zeros, of NEG only and K = N,
     rows aimed at each branch of the selection's list path (a plateau
     served in one pass, distinct values, a list rebuilt, a list that
     overflows into the exact path, 203 rows walked by 132 blocks:
     tests/torch_parity.py select_list_case), and at full width (the
     bench batch, K=128, and K=1000 for the selection's exact path on a
     cached row) with each kernel's time,
     plain time and bound and one torch.topk's time; then a full-width
     contention batch that forces repairs;
  5. one full-width build_step batch with shortlist=128 against
     shortlist=None on the card (chosen, assigned, free_after bitwise),
     then cuda vs cpu for each, every Decision field bitwise;
  6. the sampled step at bench-50k, as the default config runs it (K =
     4,096 of the 53,248-row pad): the sample's rows cuda vs cpu,
     picked with no host-device sync (torch's sync debug mode), the
     greedy, selection and scan kernels vs their plain versions on the
     sampled 1024 x 4096 scores (each kernel's time, plain time and
     bound at this shape, which the main path runs), every Decision
     field of the sampled step cuda vs cpu with and without the
     shortlist, and the sampled against the unsampled step in CUDA
     events and in device time (the profiler's; where it records none,
     CUDA events around calls queued behind a spin kernel, or "not
     measured" for a call that waits on the host);
  7. BalancedAllocation's score at full width on the card equal to the
     CPU's bitwise, and torch.sqrt of float32 on the card equal to
     numpy's correctly rounded sqrt;
  8. the port-insertion kernel vs the host replay and its plain version
     at the engine's shapes (a 128-pod bucket of port pods x 4 requested
     ports into the bench cluster's 53248 x 8 used_ports), on a
     port-heavy 1024-pod batch and with 1024 pods on one row;
  9. the caps scan kernel vs its plain version, bitwise on chosen,
     assigned and free_after: tests/torch_parity.py's caps problems (the
     shapes of tests/test_spreadcap.py, random hard batches, hostname
     groups that do not compact, a batch with no slot enforced, 512 pods
     over 3,000 nodes), and config 4 hard at full width (1,024 pods,
     DoNotSchedule max_skew 1 over 16 zones, against 50,000 nodes) with
     its time, plain time and bound; then the step of the eight label
     and topology plugins at full width (tests/torch_parity.py
     full_cluster: 50,000 nodes, 25,000 bound pods), every Decision field
     cuda = cpu for a soft batch on the node sample and a hard batch
     unsampled (the caps scan);
 10. this slice at full width: full_scheduler_profile()'s step (15
     filters, 7 scorers) on a batch that mixes pinned, unused,
     zone-bound and aws-ebs claims, host ports and tolerated taints
     beside bench pods, encoded by the engine's own volume state, every
     Decision field cuda = cpu on the node sample (1,024 x K=4,096 of
     53,248) and unsampled (256 x 53,248), no host sync in the sampled
     step; then bench.py's preemption candidate search (50,000 nodes, a
     corpus of 100,000 priority-0 pods, 256 priority-100 preemptors,
     NodeUnschedulable + NodeResourcesFit + PodTopologySpread +
     InterPodAffinity): its four outputs cuda = cpu bitwise, its time,
     bound and candidates;
 11. the bench main path: Cluster(...).start() with SchedulerConfig()
     (the pipelined, device-resident, shortlist cycle, sampling K nodes
     per batch) on the card, bench profile, 50,000 nodes x 10,000 pods,
     all bound, no node over its allocatable, the K the engine picks,
     the selection and scan kernels launched in every batch, one
     residency resync and hits after it, and the carried device state
     equal to its host mirror bitwise at the end;
 12. this slice's main path: the same with full_scheduler_profile()
     and a fifth of the pods holding a Bound claim on a zone-labelled
     PV (every claim Bound up front, no PV controller): all bound, no node over its allocatable (attach slots
     included), no claim mounted on two nodes, each zone-bound pod in
     its PV's zone, the selection and scan kernels in every batch, the
     carried device state equal to its host mirror;
 13. config 4 soft: the same with BASELINE config 4's profile
     (NodeUnschedulable, NodeResourcesFit, PodTopologySpread,
     InterPodAffinity, DefaultPreemption) and make_c4_workload's pods
     (ScheduleAnyway max_skew 8, preferred affinity on every other pod):
     every batch sampled, the selection and scan kernels in each, no
     host sync in its step, the ten 1,024-pod batches (no pod fails, so
     the PostFilter never runs);
 14. config 4 hard (DoNotSchedule max_skew 1): every batch unsampled,
     the caps kernel launched in each, no pod revoked by the host
     arbitration on a scan-enforced group, all bound in ten batches,
     app=bench per zone within 1 of the least; create-to-bound;
 15. a smaller hard burst (1,200 nodes x 512 pods): placements on the
     card equal those on the CPU;
 16. a preemption burst: 1,200 nodes exactly full of priority-1 pods,
     then 8 priority-100 pods that each need two evictions (default
     config, fast backoff): every preemptor bound on its
     nominated_node_name, no victim evicted twice, no node over its
     allocatable, a batch run with a nomination outstanding
     (residency_nomination_carries), the first pass's op outputs cuda =
     cpu on its snapshot;
 17. the port path: the JAX package's port-heavy residency burst
     (tests/test_device_residency.py:491: 4 nodes, 24 pods with two host
     ports each, NodeUnschedulable + NodeResourcesFit + NodePorts) with
     SchedulerConfig(): the port insertion kernel launched, the device
     used_ports equal to the host mirror, placements equal to the
     synchronous upload-every-batch run, no host port twice on a node;
 18. the earlier path: pipeline, residency and shortlist off, 50,000
     nodes x 2,048 pods, the greedy kernel launched in every batch;
 19. faults on the card: a 1,201-node bench cluster (sampled, with one
     pod only the residual pass places and two pods that fit nowhere),
     pipeline on and then off, fault-free and then under
     step:err@2,fetch:corrupt@3,commit:err@1,informer:err@1: each gate
     fires once, the ladder ends at "resident", the placements equal
     the fault-free run's; then a fault-free run with
     shortlist_check_every=1 and resident_check_every=1 (the cross-check
     launches the greedy kernel, the carry check runs, no desync);
 20. the reference's README scenario on the card (default config).

Phase 6 also runs the bench step, sampled and unsampled, under torch's
sync debug mode "error" with the engine's host flags (no gang, no
DoNotSchedule slot): the step never waits on the card.

The line before the last is the kernel table as JSON (the shortlist
kernels' launches are the full-profile burst's, with each path's beside
them; the preemption op, PyTorch ops and no kernel, under "stages"); the
last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from minisched_tpu_torch import faults
from minisched_tpu_torch.config import SchedulerConfig
from minisched_tpu_torch.encode import NodeFeatureCache, encode_pods, to_torch
from minisched_tpu_torch.encode.cache import step_bucket
from minisched_tpu_torch.ops import _cuda_build, prng
from minisched_tpu_torch.ops import residency as RES
from minisched_tpu_torch.ops._cuda_build import LAUNCHES
from minisched_tpu_torch.ops.caps_kernel import caps_scan_cuda
from minisched_tpu_torch.ops.greedy_kernel import greedy_assign_cuda
from minisched_tpu_torch.ops.pipeline import (_evaluate, _gather_nodes,
                                              _select_node_sample,
                                              build_step, cycle_state,
                                              evaluate)
from minisched_tpu_torch.ops.ports_kernel import insert_ports_cuda
from minisched_tpu_torch.ops.preempt import build_preempt_op, fetch_preempt
from minisched_tpu_torch.ops.select import (NEG, greedy_assign_plain,
                                            greedy_assign_shortlist_plain,
                                            shortlist_select,
                                            shortlist_select_plain)
from minisched_tpu_torch.ops.select_kernel import shortlist_select_cuda
from minisched_tpu_torch.ops.shortlist_kernel import shortlist_scan_cuda
from minisched_tpu_torch.ops.spreadcap import build_domain_caps
from minisched_tpu_torch.scenario.runner import (Cluster, default_scenario,
                                                 run_scenario, wait_until)
from minisched_tpu_torch.service.defaultconfig import (Profile,
                                                       full_scheduler_profile)
from minisched_tpu_torch.state import objects as O

# The tests' numpy case builders (tests/torch_parity.py imports numpy only).
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "tests"))
from torch_parity import (CAPS_KINDS, SELECT_CARD_LIST_KINDS,  # noqa: E402
                          caps_problem, full_cluster, sampled_cluster,
                          select_list_case)

N_NODES, N_PODS, BATCH, K = 50_000, 10_000, 1024, 128
# The node sample of the default config at bench-50k: pct = max(5, 50 -
# 50,000 / 125) = 5, want = max(256, 2,500, 2 x 1,024) = 2,500, K = its
# power-of-two bucket (engine/scheduler.py _sampled_step).
SAMPLE_K = 4096
# The default before node sampling (commit 9577057) on this workload
# (PERF.md, NVIDIA H100 80GB HBM3, 700 W): the full-width step and the
# main-path bursts.
UNSAMPLED_STEP_MS, UNSAMPLED_BURSTS_S = 14.865, (2.787, 1.643)
FAULT_SPEC = "step:err@2,fetch:corrupt@3,commit:err@1,informer:err@1"
EARLIER_PODS = 2048
PORT_BUCKET, POD_PORTS, NODE_PORTS = 128, 4, 8  # the engine's port shapes
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
# The NodePorts profile of the JAX package's port-heavy residency test
# (tests/test_device_residency.py:491).
PORTS_PROFILE = Profile(
    name="ports",
    plugins=["NodeUnschedulable", "NodeResourcesFit", "NodePorts"],
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


# BASELINE config 4 (BASELINE.md:33): topology spread + inter-pod
# affinity over the fit filter with upstream's default PostFilter, the
# JAX package's C4_PLUGINS (bench_workload.py:51).
C4_PROFILE = Profile(
    name="c4",
    plugins=["NodeUnschedulable", "NodeResourcesFit", "PodTopologySpread",
             "InterPodAffinity", "DefaultPreemption"])
# The upstream default lists, every plugin on (service/defaultconfig.py).
FULL_PROFILE = full_scheduler_profile()
# bench.py's preemption candidate search (bench.py:605-669): a corpus of
# 100,000 priority-0 pods of 250 m bound round-robin over the 50,000
# bench nodes, 256 priority-100 pods of 4,000 m, and its filter set.
PREEMPT_CORPUS, PREEMPT_PODS = 100_000, 256
PREEMPT_PROFILE = Profile(
    name="preempt",
    plugins=["NodeUnschedulable", "NodeResourcesFit", "PodTopologySpread",
             "InterPodAffinity"],
    plugin_args={"NodeResourcesFit": {"score_strategy": None}})
# The preemption burst: tests/test_preemption.py:211's shape, scaled
# (1,200 nodes exactly full of priority-1 pods, then 8 priority-100 pods
# that each need two evictions).
PREEMPT_NODES, PREEMPTORS = 1200, 8
ZONE = "topology.kubernetes.io/zone"


def c4_workload(n_nodes: int, n_pods: int, seed: int = 0, *,
                max_skew: int = 8, hard: bool = False):
    """Config 4's cluster (bench_workload.make_c4_workload): the bench
    cluster, pods labelled app=bench with a topology-spread constraint
    over zone (DoNotSchedule when ``hard``, else ScheduleAnyway) and
    preferred inter-pod affinity (weight 10, zone) on every other pod."""
    nodes, pods = bench_workload(n_nodes, n_pods, seed)
    return nodes, c4_pods(pods, max_skew=max_skew, hard=hard)


def c4_pods(pods, *, max_skew: int = 8, hard: bool = False, objects=O):
    """Give ``pods`` config 4's labels, spread constraint and (on every
    other pod) preferred affinity, in place; returns them. ``objects`` is
    the module whose object types to build."""
    sel = objects.LabelSelector(match_labels={"app": "bench"})
    when = "DoNotSchedule" if hard else "ScheduleAnyway"
    for i, p in enumerate(pods):
        p.metadata.labels["app"] = "bench"
        p.spec.topology_spread_constraints = [
            objects.TopologySpreadConstraint(
                max_skew=max_skew, topology_key="zone",
                when_unsatisfiable=when, label_selector=sel)]
        if i % 2 == 0:
            p.spec.affinity = objects.Affinity(
                pod_affinity=objects.PodAffinity(preferred=[
                    objects.WeightedPodAffinityTerm(
                        weight=10, term=objects.PodAffinityTerm(
                            label_selector=sel, topology_key="zone"))]))
    return pods


def port_heavy_workload(n_nodes: int = 4, n_pods: int = 24):
    """The port-heavy burst of tests/test_device_residency.py:491: nodes
    of Cluster.create_node(f"pn{i}", cpu=64000), pods of decreasing
    priority asking for two distinct host ports each."""
    nodes = [O.Node(metadata=O.ObjectMeta(name=f"pn{i}"),
                    status=O.NodeStatus(allocatable={
                        "cpu": 64000, "memory": 16 << 30, "pods": 110,
                        "accelerator": 0}))
             for i in range(n_nodes)]
    pods = [O.Pod(metadata=O.ObjectMeta(name=f"pp-{i}", namespace="default"),
                  spec=O.PodSpec(requests={"cpu": 100 + i},
                                 priority=200 - i,
                                 ports=[O.ContainerPort(host_port=20000 + i),
                                        O.ContainerPort(host_port=30000 + i)]))
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


def device_ms(fn, reps: int) -> float | None:
    """Mean device time of ``fn()`` over ``reps`` calls, for a call whose
    host side outlasts its device work (where CUDA events around
    back-to-back calls time the host). The profiler's CUDA activity
    (kernels and copies) where it records any; a process whose CUPTI
    is taken records none, and then ``queued_ms`` times the calls."""
    prof_ms = profiler_ms(fn, reps)
    if prof_ms is not None:
        return prof_ms
    print("device time: the profiler recorded none; CUDA events around "
          "calls queued behind a spin kernel instead")
    return queued_ms(fn, reps)


def profiler_ms(fn, reps: int) -> float | None:
    """Mean device time of ``fn()`` as the profiler's CUDA activity
    records it, or None where it records none."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages())
    return us / 1e3 / reps if us > 0 else None


def queued_ms(fn, reps: int, tries: int = 4) -> float | None:
    """Mean device time of ``fn()`` by CUDA events, each call queued
    behind a spin kernel so that the card runs it without waiting on the
    host. A call counts only if the spin was still running when the host
    had queued it all; the spin doubles until it is. None if a call
    still waits on the host (a readback, or a full launch queue): then
    nothing here times its device work alone."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    # Cycles at about 2 GHz for twice a call's host time, plus 1 ms.
    cycles = int((2 * (time.perf_counter() - t) + 1e-3) * 2e9)
    total = 0.0
    for _ in range(reps):
        for _ in range(tries):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(cycles)
            start.record()
            fn()
            end.record()
            ahead = not start.query()
            torch.cuda.synchronize()
            if ahead:
                total += start.elapsed_time(end)
                break
            cycles *= 2
        else:
            return None
    return total / reps


def fmt_ms(ms: float | None, digits: int) -> str:
    return "not measured" if ms is None else f"{ms:.{digits}f} ms"


def host_ms(fn) -> float:
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3


def bits(t: torch.Tensor) -> torch.Tensor:
    t = t.cpu()
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def compare(kernel, plain, fields=("chosen", "assigned", "free_after")
            ) -> float:
    """Bitwise equality of two assignment results on ``fields``; returns
    the max abs error (0.0 when equal)."""
    err = 0.0
    for f in fields:
        a, b = getattr(kernel, f), getattr(plain, f)
        check(torch.equal(bits(a), bits(b)), f"{f} differs bitwise")
        if a.numel() and f in ("chosen", "free_after"):
            err = max(err, float((a.cpu().double() - b.cpu().double())
                                 .abs().max()))
    return err


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


def shortlist_case(P, N, R, seed, *, plateau=False, contend=False):
    """The random problem of tests/test_shortlist.py: scores in steps of
    25 (ties), NEG on 5% of pairs; ``plateau`` makes every score 100,
    ``contend`` starves all but a few nodes so the shortlists run out."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, 5, (P, N)).astype(np.float32) * 25.0
    if plateau:
        s[:] = 100.0
    s[rng.random((P, N)) < 0.05] = NEG
    req = (rng.integers(1, 4, (P, R)) * 0.25).astype(np.float32)
    free = (rng.integers(1, 6, (N, R)) * 0.5).astype(np.float32)
    if contend:
        free[:] = 0.25
        free[: max(2, N // 64)] = 1000.0
    return [torch.from_numpy(a).cuda() for a in (s, req, free)]


def full_width_batch(nodes, pods, bound=(), selector_spread=False):
    """The first 1024-pod batch of a workload against every node, encoded
    by the port's own cache and encoder (host numpy). The pods are
    encoded first, as the engine does: their constraints register the
    topology keys the node snapshot's domains reflect."""
    cache = NodeFeatureCache()
    if selector_spread:
        cache.enable_owner_pairs()
    cache.upsert_nodes_bulk(nodes)
    for pod, node_name in bound:
        pod.spec.node_name = node_name
        cache.account_bind(pod)
    eb = encode_pods(pods[:BATCH], step_bucket(BATCH), cfg=cache.cfg,
                     registry=cache.registry,
                     anti_forbidden_fn=cache.anti_forbidden_for,
                     selector_spread=selector_spread)
    pad = step_bucket(len(nodes))
    nf, _names, _sv, _incs = cache.snapshot_versioned(pad=pad)
    af = cache.snapshot_assigned(pad=None if bound else 16)
    return eb, nf, af


def select_pair(scores, seed, k) -> float:
    """The selection kernel against shortlist_select_plain on one input,
    bitwise on all four outputs (cand_scores against a gather of the
    plain cand); returns the max abs error (0.0 when equal)."""
    got = shortlist_select_cuda(scores, seed, k)
    want = shortlist_select_plain(scores, seed, k)
    want = (*want, torch.gather(scores, 1, want[0].long()))
    err = 0.0
    for name, a, b in zip(("cand", "kth", "kth_noise", "cand_scores"),
                          got, want):
        check(torch.equal(bits(a), bits(b)),
              f"shortlist_select {name} differs bitwise "
              f"({tuple(scores.shape)}, K={k})")
        err = max(err, float((a.double() - b.double()).abs().max()))
    return err


def select_bound_s(P, N, K_):
    """Least time for the selection's work, whatever the kernel's passes:
    the scores read once and the outputs written once over the memory
    rate, against one order-key compare per score over the float32
    rate."""
    moved = 4 * P * N + 8 * P * K_ + 8 * P
    ops = P * N
    return max(moved / HBM_BYTES_PER_S, ops / F32_OPS_PER_S), (
        "bytes" if moved / HBM_BYTES_PER_S >= ops / F32_OPS_PER_S
        else "operations")


def scan_pair(scores, requests, free, seed, k):
    """The shortlist scan kernel and its plain version on one input:
    (kernel result, plain result, selection, plain ms)."""
    sel = shortlist_select(scores, seed, k)
    got = shortlist_scan_cuda(scores, sel[0], sel[1], sel[2], requests,
                              free, seed)
    t = time.perf_counter()
    plain = greedy_assign_shortlist_plain(scores, requests, free, seed, *sel)
    torch.cuda.synchronize()
    return got, plain, sel, (time.perf_counter() - t) * 1e3


def scan_bound_s(P, N, K_, R, repairs):
    """Least time for the scan's work on this input: bytes it must move
    (candidates and their scores, the P*K*R gathered free values, the
    requests and bounds, free in and out, the outputs, and each repaired
    row's scores) over the memory rate, against its compares over the
    float32 rate."""
    moved = (8 * P * K_ + 4 * P * K_ * R + 4 * P * R + 8 * P
             + 8 * N * R + 6 * P + 4 * repairs * N)
    ops = (P * K_ + repairs * N) * (R + 2)
    return max(moved / HBM_BYTES_PER_S, ops / F32_OPS_PER_S), (
        "bytes" if moved / HBM_BYTES_PER_S >= ops / F32_OPS_PER_S
        else "operations")


def port_cases(N, rng):
    """The port insertion at the engine's shape (113 port pods in a
    bucket of 128, -1 rows after them, x 4 ports into N x 8 used_ports,
    half the rows partly filled), on a port-heavy 1024-pod batch over 300
    hot rows, and with 1024 pods on one row (the longest chain):
    (name, state, rows, ports)."""
    cases = []
    for name, P_, live, hot in (("engine shape", PORT_BUCKET, 113, N),
                                ("port-heavy", BATCH, BATCH - 24, 300),
                                ("one row", BATCH, BATCH, 1)):
        state = np.zeros((N, NODE_PORTS), dtype=np.int32)
        state[: N // 2] = rng.integers(0, 2, (N // 2, NODE_PORTS)) * 30000
        rows = np.full(P_, -1, dtype=np.int32)
        rows[:live] = rng.integers(0, hot, live)
        ports = rng.integers(20000, 40000, (P_, POD_PORTS)).astype(np.int32)
        ports[rng.random((P_, POD_PORTS)) < 0.25] = 0
        ports[live:] = 0
        cases.append((name, state, rows, ports))
    return cases


def drive(cfg, nodes, pods, label, profile=BENCH_PROFILE, probe=None,
          with_pv_controller=True):
    """Boot a cluster with ``cfg``, load the nodes, zero the launch
    counts, create the pods and wait until every pod is bound and every
    batch folded into the metrics. With residency on, the carried device
    free/used_ports must then equal their host mirrors bitwise (the
    kernels' outputs at the path's own shapes against the host replay).
    ``probe(scheduler)`` runs once the nodes are synced;
    ``with_pv_controller=False`` boots without the PV controller, as
    bench.py runs its engine cells (bench.py:1457). Returns
    (metrics, launches, burst create-to-bound, per-pod create-to-bound,
    placements)."""
    cluster = Cluster()
    try:
        cluster.create_objects(nodes)
        cluster.start(profile, cfg, with_pv_controller=with_pv_controller)
        n_nodes = sum(isinstance(o, O.Node) for o in nodes)
        check(wait_until(lambda: cluster.service.scheduler.cache.node_count()
                         == n_nodes, timeout=120),
              f"{label}: informers did not sync the nodes")
        if probe is not None:
            probe(cluster.service.scheduler)
        for name in LAUNCHES:
            LAUNCHES[name] = 0
        cluster.create_objects(pods)
        sched = cluster.service.scheduler

        def settled() -> bool:
            # A batch's pods may all be bound by the binder thread before
            # the scheduling thread folds that batch into its metrics.
            m = sched.metrics()
            return m["batch_faults"] > 0 or (
                m["pods_bound"] >= len(pods) and m["kernel_launches"]
                == sum(LAUNCHES.values()))

        wait_until(settled, timeout=300, interval=0.05)
        launches = dict(LAUNCHES)
        m = sched.metrics()
        check(m["batch_faults"] == 0, f"{label}: a scheduling cycle failed")
        check(m["pods_bound"] >= len(pods),
              f"{label}: only {m['pods_bound']} of {len(pods)} pods bound")
        for name, n in launches.items():
            check(m[f"kernel_launches_{name}"] == n,
                  f"{label}: {name} launches {n} vs engine "
                  f"{m[f'kernel_launches_{name}']}")
        res = sched._residency
        if res is not None:
            def mirrored() -> bool:
                return (torch.equal(bits(res.free_dev),
                                    torch.from_numpy(res.mirror_free)
                                    .view(torch.int32))
                        and torch.equal(res.ports_dev.cpu(),
                                        torch.from_numpy(res.mirror_ports)))

            check(wait_until(mirrored, timeout=10),
                  f"{label}: device free/used_ports != host mirror")
        placed = [p for p in cluster.list_pods() if p.spec.node_name]
        check(len(placed) == len(pods),
              f"{label}: {len(placed)} pods bound in the store")
        # Store stamps: creation_timestamp at create, scheduled_time at bind.
        created = np.array([p.metadata.creation_timestamp for p in placed])
        bound_at = np.array([p.status.scheduled_time for p in placed])
        used: dict = {}
        mounts: dict = {}   # claim key → nodes mounting it
        for pod in placed:
            u = used.setdefault(pod.spec.node_name, [0.0, 0.0, 0, [], set()])
            u[0] += pod.spec.requests["cpu"]
            u[1] += pod.spec.requests.get("memory", 0.0)
            u[2] += 1
            u[3] += [p.host_port for p in pod.spec.ports if p.host_port]
            for v in pod.spec.volumes:
                ck = f"{pod.metadata.namespace}/{v.claim_name}"
                mounts.setdefault(ck, set()).add(pod.spec.node_name)
                if v.volume_type not in O.CLOUD_VOLUME_AXES:
                    u[4].add(ck)
        check(all(len(n) == 1 for n in mounts.values()),
              f"{label}: a read-write-once claim mounted on two nodes")
        pv_zone = {pv.metadata.name: pv.metadata.labels.get(ZONE)
                   for pv in cluster.store.list("PersistentVolume")}
        claim_zone = {c.key: pv_zone.get(c.volume_name)
                      for c in cluster.store.list("PersistentVolumeClaim")
                      if c.volume_name}
        zone_of = {n.metadata.name: n.metadata.labels.get(ZONE)
                   for n in cluster.list_nodes()}
        n_zoned = 0
        for pod in placed:
            for v in pod.spec.volumes:
                z = claim_zone.get(f"{pod.metadata.namespace}/"
                                   f"{v.claim_name}")
                if z is not None:
                    n_zoned += 1
                    check(zone_of[pod.spec.node_name] == z,
                          f"{label}: {pod.key} outside its volume's zone")
        for node in cluster.list_nodes():
            u = used.get(node.metadata.name)
            if u is None:
                continue
            alloc = node.status.allocatable
            check(u[0] <= alloc["cpu"] and u[1] <= alloc["memory"]
                  and u[2] <= alloc["pods"]
                  and len(u[4]) <= alloc.get("attachable-volumes",
                                             O.DEFAULT_ATTACHABLE_VOLUMES),
                  f"{label}: node {node.metadata.name} over-committed: "
                  f"{u[:3]}, {len(u[4])} attached volumes")
            check(len(set(u[3])) == len(u[3]),
                  f"{label}: a host port taken twice on "
                  f"{node.metadata.name}")
            check(not node.spec.unschedulable,
                  f"{label}: pod bound to unschedulable "
                  f"{node.metadata.name}")
        m["zone_bound_claims"] = n_zoned
        return (m, launches, float(bound_at.max() - created.min()),
                bound_at - created,
                {p.key: p.spec.node_name for p in placed})
    finally:
        cluster.shutdown()


def fault_burst(spec: str, cfg: SchedulerConfig, label: str):
    """tests/test_torch_faults.py's burst on a cluster that samples:
    sampled_cluster's 1,200 bench nodes, a big node and its resident pod,
    then, with ``spec`` armed, its 257 pending pods (one placed only by
    the residual pass) and two pods that fit nowhere (the last batch: a
    failure tranche for the commit gate), in batches of 64 gathered over
    a 0.3 s window. Waits until every pod is bound or parked, then
    creates probe pods until the ladder is back at "resident". Returns
    (placements, metrics)."""
    first, pods = sampled_cluster(O)
    doomed = [O.Pod(metadata=O.ObjectMeta(name=f"doom{i}", namespace="bench"),
                    spec=O.PodSpec(requests={"cpu": 1e9}))
              for i in range(2)]
    cluster = Cluster()
    try:
        cluster.create_objects(first)
        cluster.start(BENCH_PROFILE, cfg, with_pv_controller=False)
        sched = cluster.service.scheduler
        check(wait_until(lambda: sched.cache.node_count() == 1201,
                         timeout=60), f"{label}: nodes not synced")
        faults.configure(spec, 0)
        cluster.create_objects(pods + doomed)
        names = {p.metadata.name for p in pods}

        def settled():
            ps = cluster.list_pods()
            return (sum(1 for p in ps if p.metadata.name in names
                        and p.spec.node_name) == len(names)
                    and sum(1 for p in ps if p.metadata.name.startswith(
                        "doom") and p.status.unschedulable_plugins) == 2)

        check(wait_until(settled, timeout=120), f"{label}: pods not settled")
        placed = {p.metadata.name: p.spec.node_name
                  for p in cluster.list_pods()
                  if p.metadata.name in names}
        check(sched.metrics()["pods_bound"] == len(placed),
              f"{label}: a pod bound twice or lost")
        probe = 0
        while (sched.metrics()["degradation_state"] != "resident"
               and probe < 40):
            cluster.create_pod(f"probe{probe}", cpu=10)
            cluster.wait_for_pod_bound(f"probe{probe}", timeout=30)
            probe += 1
        return placed, sched.metrics()
    finally:
        faults.configure("")
        cluster.shutdown()


def check_no_sync(fn, label) -> None:
    """``fn()`` (warmed first) runs under torch's sync debug mode
    "error": the host never waits for the card in it."""
    fn()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    except RuntimeError as e:
        check(False, f"{label} waits on the card: {e}")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def caps_bound_s(P, N, R, C, H, K_):
    """Least time for the caps scan's work: the scores, requests, slots,
    matches, domain rows and count tables read once, free in and out and
    the outputs written once, over the memory rate, against its compares
    (R fits, C domain verdicts, score and noise order per pair) over the
    float32 rate."""
    moved = (4 * P * N + 4 * P * R + 8 * N * R + 8 * P * C + P * H
             + 4 * H * N + 5 * H * K_ + 5 * P)
    ops = P * N * (R + C + 2)
    return max(moved / HBM_BYTES_PER_S, ops / F32_OPS_PER_S), (
        "bytes" if moved / HBM_BYTES_PER_S >= ops / F32_OPS_PER_S
        else "operations")


def caps_on_card(scores, req, free, seed, caps, label):
    """The caps scan kernel against its plain version on the card, bitwise
    on chosen, assigned and free_after: (kernel result, plain ms, max
    abs error)."""
    caps_d = type(caps)(*[t.cuda() for t in caps])
    args = [t.cuda() for t in (scores, req, free)]
    got = caps_scan_cuda(*args, seed, caps_d)
    torch.cuda.synchronize()
    t = time.perf_counter()
    plain = greedy_assign_plain(*args, seed, caps_d)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t) * 1e3
    err = 0.0
    for f in ("chosen", "assigned", "free_after"):
        a, b = getattr(got, f), getattr(plain, f)
        check(torch.equal(bits(a), bits(b)),
              f"caps scan {label}: {f} differs bitwise from the plain "
              "version")
        if a.numel() and f != "assigned":
            err = max(err, float((a.cpu().double() - b.cpu().double())
                                 .abs().max()))
    return got, plain_ms, err


def c4_hard_problem():
    """The caps scan's input at full width, as the step builds it: the
    first 1,024 pods of config 4 hard (DoNotSchedule, max_skew 1, 16
    zones) against 50,000 nodes on the card, scored by the config-4
    profile with the caps' groups deferred to the scan. Returns
    ((scores, requests, free), seed, caps, the zone of each node row)."""
    nodes, pods = c4_workload(N_NODES, BATCH, max_skew=1, hard=True)
    eb, nf, af = full_width_batch(nodes, pods)
    eb_d, nf_d, af_d = (to_torch(x, "cuda") for x in (eb, nf, af))
    plugin_set = C4_PROFILE.build()
    ctx = cycle_state(plugin_set, eb_d, nf_d, af_d)
    caps = build_domain_caps(eb_d.pf, eb_d.gf, nf_d, ctx["counts_dom"],
                             ctx["dom_exists"])
    ctx["spread_scan_groups"] = caps.scan_groups
    scores = _evaluate(plugin_set, eb_d.pf, nf_d, ctx)[0]
    seed = prng.bits(prng.fold_in(prng.PRNGKey(0), 1))
    return ((scores, eb_d.pf.requests, nf_d.free), seed, caps,
            nf.topo_domains[int(eb.gf.key_idx[0])])


def caps_phase(smi):
    """The caps scan kernel vs its plain version: tests/torch_parity.py's
    caps problems (tests/test_spreadcap.py's shapes, groups that do not
    compact, no slot enforced, many blocks), then config 4 hard at full
    width: the first 1,024 pods (DoNotSchedule, max_skew 1, 16 zones)
    against 50,000 nodes, scored by the config-4 profile with the caps'
    groups deferred to the scan, as the step scores them. Returns the
    kernel table's numbers."""
    err = 0.0
    for kind in CAPS_KINDS:
        scores, req, free, seed, caps = caps_problem(kind)
        got, _ms, e = caps_on_card(scores, req, free, seed, caps, kind)
        err = max(err, e)
        print(f"caps scan kernel vs plain {kind} "
              f"{tuple(scores.shape)}x{req.shape[1]} (H={caps.domc.shape[0]},"
              f" K={caps.counts0.shape[1]}, {int((caps.slot_h >= 0).sum())} "
              f"enforced slots): bitwise equal, {int(got.assigned.sum())} "
              "assigned")
    args, seed, caps, zone_of = c4_hard_problem()
    check(bool(caps.any_enforced), "config 4 hard: no slot enforced")
    scores = args[0]
    got, plain_ms, e = caps_on_card(*args, seed, caps, "full width")
    err = max(err, e)
    P, N = scores.shape
    R, C = args[1].shape[1], caps.slot_h.shape[1]
    H, K_ = caps.counts0.shape
    ms = cuda_ms(lambda: caps_scan_cuda(*args, seed, caps), reps=10)
    bound_s, bound_by = caps_bound_s(P, N, R, C, H, K_)
    zones = zone_of[got.chosen.cpu().numpy()[got.assigned.cpu().numpy()]]
    _, per_zone = np.unique(zones, return_counts=True)
    check(int(got.assigned.sum()) == BATCH
          and per_zone.max() - per_zone.min() <= 1,
          f"config 4 hard full width: {int(got.assigned.sum())} assigned, "
          f"per-zone counts {per_zone.tolist()}")
    print(f"caps scan kernel vs plain config 4 hard full width "
          f"{P}x{N}x{R} (H={H}, K={K_}, C={C}): bitwise equal, "
          f"{int(got.assigned.sum())} assigned over {len(per_zone)} zones "
          f"within skew 1; kernel {ms:.4f} ms ({ms * 1e3 / P:.3f} us per "
          f"pod), plain {plain_ms:.1f} ms, bound {bound_s * 1e3:.4f} ms "
          f"({bound_by}; the real limit is the chain of {P} dependent "
          f"steps) ({smi})")
    return {"ms": ms, "plain_ms": plain_ms, "bound_s": bound_s,
            "bound_by": bound_by, "err": err}


def eight_plugin_phase(smi):
    """The step of the eight label and topology plugins (with
    NodeUnschedulable and NodeResourcesFit) at full width on
    tests/torch_parity.py's full_cluster (50,000 nodes, 25,000 bound
    pods, 1,024 pending): every Decision field cuda = cpu bitwise, spread
    fields included, for a soft batch on the default config's node
    sample and a hard batch unsampled (the caps scan)."""
    profile = Profile(name="eight", plugins=[
        "NodeUnschedulable", "NodeResourcesFit", "PodTopologySpread",
        "InterPodAffinity", "SelectorSpread", "TaintToleration",
        "NodeAffinity", "NodeName", "ImageLocality", "NodePreferAvoidPods"])
    plugin_set = profile.build()
    key = prng.fold_in(prng.PRNGKey(0), 1)
    for hard, sample in ((False, SAMPLE_K), (True, None)):
        nodes, pods, bound = full_cluster(O, N_NODES, BATCH, 7, hard=hard)
        eb, nf, af = full_width_batch(nodes, pods, bound,
                                      selector_spread=True)
        step = build_step(plugin_set, shortlist=K, sample_nodes=sample)
        d_gpu = step(*(to_torch(x, "cuda") for x in (eb, nf, af)), key)
        torch.cuda.synchronize()
        t = time.perf_counter()
        d_cpu = step(*(to_torch(x, "cpu") for x in (eb, nf, af)), key)
        cpu_s = time.perf_counter() - t
        for field in d_cpu._fields:
            check(torch.equal(bits(getattr(d_gpu, field)),
                              bits(getattr(d_cpu, field))),
                  f"eight-plugin step hard={hard} field {field}: "
                  "cuda != cpu")
        check(bool(d_cpu.scan_groups.any()) == hard,
              f"eight-plugin step hard={hard}: scan groups "
              f"{int(d_cpu.scan_groups.sum())}")
        what = ("hard, unsampled (caps scan)" if hard
                else f"soft, sampled K={sample}")
        print(f"eight-plugin step {what} "
              f"{eb.pf.valid.shape[0]}x{nf.valid.shape[0]}: every Decision "
              f"field bitwise equal cuda vs cpu, {int(d_cpu.assigned.sum())}"
              f" assigned, {int(d_cpu.scan_groups.sum())} groups enforced "
              f"in the scan; cpu {cpu_s:.1f} s ({smi})")
        del d_gpu, d_cpu, nodes, pods, bound


def full_workload(n_nodes: int, n_pods: int, seed: int = 0):
    """The full-profile burst: the bench cluster with each node's zone
    also under the well-known zone key, and every fifth pod holding its
    own Bound claim on a PV in zone ``i % 16``. Returns (nodes, PVs and
    claims; pods)."""
    nodes, pods = bench_workload(n_nodes, n_pods, seed)
    for n in nodes:
        n.metadata.labels[ZONE] = n.metadata.labels["zone"]
    first = list(nodes)
    for i, p in enumerate(pods):
        if i % 5:
            continue
        first.append(O.PersistentVolume(
            metadata=O.ObjectMeta(name=f"fpv{i}",
                                  labels={ZONE: f"z{i % 16}"}),
            capacity={"ephemeral-storage": float(1 << 30)}, phase="Bound",
            claim_ref=f"bench/fc{i}"))
        first.append(O.PersistentVolumeClaim(
            metadata=O.ObjectMeta(name=f"fc{i}", namespace="bench"),
            request={"ephemeral-storage": float(1 << 30)},
            volume_name=f"fpv{i}", phase="Bound"))
        p.spec.volumes = [O.VolumeClaim(claim_name=f"fc{i}")]
    return first, pods


def full_profile_batch(n_pods: int):
    """The first ``n_pods`` of a batch that mixes, beside bench pods,
    claims pinned by a bound holder pod, unused claims, zone-bound claims
    on PVs, cloud-typed (aws-ebs) claims, host ports and tolerations of a
    NoSchedule taint that every 13th node carries, encoded by the
    engine's own volume state (a Scheduler on the CPU over a store that
    holds the claims and PVs) against the 50,000-node cluster: (eb, nf,
    af), host numpy."""
    from minisched_tpu_torch.engine.scheduler import Scheduler
    from minisched_tpu_torch.engine.queue import QueuedPodInfo
    from minisched_tpu_torch.state.store import ClusterStore

    nodes, pods = bench_workload(N_NODES, n_pods)
    for i, n in enumerate(nodes):
        n.metadata.labels[ZONE] = n.metadata.labels["zone"]
        if i % 13 == 0:
            n.spec.taints = [O.Taint(key="dedicated", value="ml",
                                     effect="NoSchedule")]
    store = ClusterStore()
    eng = Scheduler(store, FULL_PROFILE.build(),
                    SchedulerConfig(platform="cpu"))
    try:
        eng.cache.upsert_nodes_bulk(nodes)
        for k in range(32):
            store.create(O.PersistentVolumeClaim(
                metadata=O.ObjectMeta(name=f"pin{k}", namespace="bench"),
                phase="Bound"))
            holder = O.Pod(metadata=O.ObjectMeta(name=f"holder{k}",
                                                 namespace="bench"),
                           spec=O.PodSpec(
                               requests={"cpu": 100.0},
                               volumes=[O.VolumeClaim(claim_name=f"pin{k}")],
                               node_name=nodes[1 + 37 * k].metadata.name))
            check(eng.cache.account_bind(holder), "holder not accounted")
        for i, p in enumerate(pods):
            kind = i % 8
            if kind == 0:
                p.spec.volumes = [O.VolumeClaim(claim_name=f"pin{i % 32}")]
            elif kind in (1, 2, 3):
                name = f"c{i}"
                pv = ""
                if kind == 2:
                    pv = f"pv{i}"
                    store.create(O.PersistentVolume(
                        metadata=O.ObjectMeta(
                            name=pv, labels={ZONE: f"z{i % 16}"}),
                        capacity={"ephemeral-storage": float(1 << 30)},
                        phase="Bound", claim_ref=f"bench/{name}"))
                store.create(O.PersistentVolumeClaim(
                    metadata=O.ObjectMeta(name=name, namespace="bench"),
                    volume_name=pv, phase="Bound"))
                p.spec.volumes = [O.VolumeClaim(
                    claim_name=name,
                    volume_type="aws-ebs" if kind == 3 else "")]
            elif kind == 4:
                p.spec.ports = [O.ContainerPort(host_port=8080 + i % 3)]
            elif kind == 5:
                p.spec.tolerations = [O.Toleration(
                    key="dedicated", operator="Equal", value="ml",
                    effect="NoSchedule")]
        qs = [QueuedPodInfo(pod=p) for p in pods]
        eb = eng._encode_batch(qs, pods, step_bucket(n_pods))[-1]
        nf, _names, _sv, _incs = eng.cache.snapshot_versioned(
            pad=step_bucket(N_NODES))
        af = eng.cache.snapshot_assigned()
        return eb, nf, af
    finally:
        eng.shutdown()


def full_step_phase(smi, key):
    """full_scheduler_profile()'s step at full width (50,000 nodes):
    every Decision field cuda = cpu on the default config's node sample
    (1,024 pods x K=4,096 of 53,248) and on one unsampled batch (256
    pods x 53,248), and no host sync in the sampled step."""
    plugin_set = FULL_PROFILE.build()
    for n_pods, sample in ((BATCH, SAMPLE_K), (256, None)):
        eb, nf, af = full_profile_batch(n_pods)
        rows = np.asarray(eb.pf.claim_rows)[:n_pods]
        check((rows >= 0).any() and (rows == -1).any()
              and np.asarray(eb.pf.claim_typed).any()
              and (np.asarray(eb.pf.zone_key)[:n_pods] > 0).any(),
              "full-profile batch: a claim kind is missing")
        step = build_step(plugin_set, shortlist=K, sample_nodes=sample)
        dev = [to_torch(x, "cuda") for x in (eb, nf, af)]
        d_gpu = step(*dev, key, has_gang=False, hard_spread=False)
        torch.cuda.synchronize()
        t = time.perf_counter()
        d_cpu = step(*(to_torch(x, "cpu") for x in (eb, nf, af)), key,
                     has_gang=False, hard_spread=False)
        cpu_s = time.perf_counter() - t
        for field in d_cpu._fields:
            check(torch.equal(bits(getattr(d_gpu, field)),
                              bits(getattr(d_cpu, field))),
                  f"full-profile step K={sample}: field {field} cuda != cpu")
        ms = cuda_ms(lambda: step(*dev, key, has_gang=False,
                                  hard_spread=False), reps=3)
        what = (f"sampled K={sample}" if sample else "unsampled")
        if sample:
            check_no_sync(lambda: step(*dev, key, has_gang=False,
                                       hard_spread=False),
                          "the full-profile sampled step")
            what += ", no host sync"
        print(f"full-profile step {what} {eb.pf.valid.shape[0]}x"
              f"{nf.valid.shape[0]} (15 filters, 7 scorers; pinned, "
              f"unused, zone-bound and aws-ebs claims, host ports, taints): "
              f"every Decision field bitwise equal cuda vs cpu, "
              f"{int(d_cpu.assigned[:n_pods].sum())} of {n_pods} assigned; "
              f"{ms:.3f} ms per step back to back on the card, cpu "
              f"{cpu_s:.1f} s ({smi})")
        del d_gpu, d_cpu, dev


def preempt_bound_s(eb, nf, af, R):
    """Least time for the candidate search on this input: the leaves it
    reads (the corpus, the node rows it filters and the pod rows) read
    once and its four outputs written once over the memory rate, against
    its operations (the masked corpus products and segment adds, R + 1
    per pod and corpus row, and the per-node compares, R + 3 per pod and
    node) over the float32 rate."""
    Pf, A, N = eb.pf.valid.shape[0], af.valid.shape[0], nf.valid.shape[0]
    moved = (sum(np.asarray(x).nbytes for x in af)
             + sum(np.asarray(getattr(nf, f)).nbytes
                   for f in ("valid", "free", "unschedulable",
                             "topo_domains"))
             + sum(np.asarray(x).nbytes for x in eb.pf)
             + Pf * (4 + 1 + 4 + 4 * eb.pf.spread_group.shape[1]))
    ops = Pf * A * (R + 2) + Pf * N * (R + 3)
    return max(moved / HBM_BYTES_PER_S, ops / F32_OPS_PER_S), (
        "bytes" if moved / HBM_BYTES_PER_S >= ops / F32_OPS_PER_S
        else "operations")


def preempt_bench_inputs():
    """bench.py's preemption candidate search input (bench.py:605-669):
    the 50,000 bench nodes, 100,000 priority-0 pods of 250 m bound
    round-robin through the cache's bulk bind, and 256 priority-100
    preemptors of 4,000 m. Returns (eb, nf, af, cfg), host numpy."""
    from minisched_tpu_torch.engine.clusterstate import _request_rows

    nodes, _ = bench_workload(N_NODES, 0)
    cache = NodeFeatureCache(capacity=N_NODES)
    cache.upsert_nodes_bulk(nodes)
    vics = [(O.Pod(metadata=O.ObjectMeta(name=f"vic-{i}", namespace="bench",
                                         labels={"app": "bench"}),
                   spec=O.PodSpec(requests={"cpu": 250.0}, priority=0)),
             nodes[i % N_NODES].metadata.name)
            for i in range(PREEMPT_CORPUS)]
    check(not cache.account_bind_bulk(vics, req_rows=_request_rows(vics)),
          "preemption corpus: a bind missed")
    hi = [O.Pod(metadata=O.ObjectMeta(name=f"hi-{i}", namespace="bench"),
                spec=O.PodSpec(requests={"cpu": 4000.0}, priority=100))
          for i in range(PREEMPT_PODS)]
    eb = encode_pods(hi, PREEMPT_PODS, cfg=cache.cfg,
                     registry=cache.registry)
    nf, _names, _sv, _incs = cache.snapshot_versioned(
        pad=step_bucket(N_NODES))
    af = cache.snapshot_assigned()
    return eb, nf, af, cache.cfg


def preempt_op_phase(smi):
    """bench.py's preemption candidate search on the card: 50,000 nodes,
    100,000 corpus pods, 256 preemptors, NodeUnschedulable +
    NodeResourcesFit + PodTopologySpread + InterPodAffinity. The four
    outputs cuda = cpu bitwise (the card's segment sums add by atomics:
    exact on integer-valued requests), its time in CUDA events and device
    time, its bound and the candidates found. Returns the op's numbers."""
    eb, nf, af, cfg = preempt_bench_inputs()
    op = build_preempt_op(PREEMPT_PROFILE.build(), cfg=cfg)
    dev = [to_torch(x, "cuda") for x in (eb, nf, af)]
    got = op(*dev)
    torch.cuda.synchronize()
    t = time.perf_counter()
    want = op(*(to_torch(x, "cpu") for x in (eb, nf, af)))
    cpu_s = time.perf_counter() - t
    for name, a, b in zip(("chosen", "ok", "victim_count", "spread_evict"),
                          got, want):
        check(torch.equal(bits(a), bits(b)),
              f"preemption op {name}: cuda != cpu")
    ms = cuda_ms(lambda: op(*dev), reps=5)
    dev_ms = device_ms(lambda: op(*dev), reps=5)
    bound_s, bound_by = preempt_bound_s(eb, nf, af, eb.pf.requests.shape[1])
    chosen, ok, cnt, _sev = fetch_preempt(got)
    found = int(ok.sum())
    check(found == PREEMPT_PODS and len(set(chosen.tolist())) == 1,
          f"preemption op: {found} candidates, rows {set(chosen.tolist())}")
    print(f"preemption op {PREEMPT_PODS} preemptors x {nf.valid.shape[0]} "
          f"nodes x {af.valid.shape[0]} corpus rows ({PREEMPT_CORPUS} "
          f"bound): chosen, ok, victim_count, spread_evict bitwise equal "
          f"cuda vs cpu; {found} candidates found, every victim count "
          f"{sorted(set(cnt.tolist()))} tied on row {int(chosen[0])} "
          f"(the first maximum); {ms:.3f} ms per call back to back, "
          f"{fmt_ms(dev_ms, 3)} of device time, bound "
          f"{bound_s * 1e3:.4f} ms ({bound_by}), cpu {cpu_s:.1f} s ({smi})")
    return {"ms": ms, "device_ms": dev_ms, "bound_s": bound_s,
            "bound_by": bound_by, "found": found}


def preempt_burst_phase(smi):
    """The preemption burst on the card: 1,200 nodes of 200 m exactly
    full of 2,400 priority-1 pods of 100 m, then 8 priority-100 pods of
    200 m, each needing two evictions, under SchedulerConfig() with the
    tests' fast backoff. Victim counts tie, so a batch's preemptors all
    pick one node; the first wins, the rest park until its victims'
    deletions revive them: about one win per cycle. Every preemptor must
    bind on its nominated node, no victim be evicted twice, no node be
    over its allocatable, a batch must have run with a nomination
    outstanding (residency_nomination_carries), and the first pass's op
    outputs must equal on the card and on the CPU for that snapshot."""
    from minisched_tpu_torch.engine.scheduler import Scheduler

    nodes = [O.Node(metadata=O.ObjectMeta(name=f"pe-{i:04d}"),
                    status=O.NodeStatus(allocatable={"cpu": 200.0,
                                                     "pods": 110.0}))
             for i in range(PREEMPT_NODES)]
    fillers = [O.Pod(metadata=O.ObjectMeta(name=f"fill-{i}",
                                           namespace="bench"),
                     spec=O.PodSpec(requests={"cpu": 100.0}, priority=1))
               for i in range(2 * PREEMPT_NODES)]
    vips = [O.Pod(metadata=O.ObjectMeta(name=f"vip-{i}", namespace="bench"),
                  spec=O.PodSpec(requests={"cpu": 200.0}, priority=100))
            for i in range(PREEMPTORS)]
    first_pass = []
    orig = Scheduler._preempt_inputs

    def tree_to(x, device):
        """A (nested) NamedTuple of tensors, copied to ``device``."""
        if isinstance(x, torch.Tensor):
            return x.to(device, copy=True)
        return type(x)(*[tree_to(v, device) for v in x])

    def recorded(self, eb, rows):
        out = orig(self, eb, rows)
        if not first_pass:
            first_pass.append([tree_to(x, "cpu") for x in out[:3]])
        return out

    cfg = SchedulerConfig(platform="", backoff_initial_s=0.05,
                          backoff_max_s=0.2)
    Scheduler._preempt_inputs = recorded
    cluster = Cluster()
    try:
        cluster.create_objects(nodes)
        cluster.start(C4_PROFILE, cfg)
        sched = cluster.service.scheduler
        check(wait_until(lambda: sched.cache.node_count() == PREEMPT_NODES,
                         timeout=60), "preemption burst: nodes not synced")
        cluster.create_objects(fillers)
        check(wait_until(lambda: sched.metrics()["pods_bound"]
                         == len(fillers), timeout=120),
              "preemption burst: the fillers did not all bind")
        # A spare node, too small for a preemptor, for a trickle of small
        # pods that arrive while the preemptors win one by one: their
        # batches run with nominations outstanding, which reserve the
        # freed capacity from them.
        cluster.create_objects([O.Node(
            metadata=O.ObjectMeta(name="pe-spare"),
            status=O.NodeStatus(allocatable={"cpu": 150.0,
                                             "pods": 110.0}))])
        check(wait_until(lambda: sched.cache.node_count()
                         == PREEMPT_NODES + 1, timeout=60),
              "preemption burst: the spare node not synced")
        t0 = time.perf_counter()
        cluster.create_objects(vips)
        trickle = []
        while len(trickle) < 100 and not all(
                cluster.get_pod(v.metadata.name, "bench").spec.node_name
                for v in vips):
            trickle.append(cluster.create_pod(
                f"small-{len(trickle)}", namespace="bench", cpu=1))
            time.sleep(0.01)
        check(wait_until(lambda: all(
            cluster.get_pod(v.metadata.name, "bench").spec.node_name
            for v in vips), timeout=180, interval=0.05),
            "preemption burst: a preemptor did not bind")
        burst_s = time.perf_counter() - t0
        check(wait_until(lambda: all(
            cluster.get_pod(p.metadata.name, "bench").spec.node_name
            == "pe-spare" for p in trickle), timeout=60),
            "preemption burst: a small pod not bound on the spare node")
        m = sched.metrics()
        for v in vips:
            p = cluster.get_pod(v.metadata.name, "bench")
            check(p.status.nominated_node_name == p.spec.node_name,
                  f"preemption burst: {p.key} bound on {p.spec.node_name}, "
                  f"nominated {p.status.nominated_node_name}")
        check(wait_until(lambda: sum(
            e.reason == "Preempted" for e in cluster.store.list("Event"))
            >= 2 * PREEMPTORS, timeout=10),
            "preemption burst: Preempted events missing")
        evicted = [e.involved_object for e in cluster.store.list("Event")
                   if e.reason == "Preempted"]
        check(len(evicted) == len(set(evicted)) == 2 * PREEMPTORS,
              f"preemption burst: {len(evicted)} evictions, "
              f"{len(set(evicted))} distinct")
        used: dict = {}
        for p in cluster.list_pods():
            if p.spec.node_name:
                used[p.spec.node_name] = (used.get(p.spec.node_name, 0.0)
                                          + p.spec.requests["cpu"])
        check(all(u <= (150.0 if n == "pe-spare" else 200.0)
                  for n, u in used.items()),
              "preemption burst: a node over its allocatable")
        check(m["residency_nomination_carries"] > 0,
              "preemption burst: no batch ran with a nomination outstanding")
    finally:
        Scheduler._preempt_inputs = orig
        cluster.shutdown()
    check(bool(first_pass), "preemption burst: no preemption pass ran")
    op = build_preempt_op(C4_PROFILE.build())
    got = op(*(tree_to(x, "cuda") for x in first_pass[0]))
    want = op(*first_pass[0])
    for name, a, b in zip(("chosen", "ok", "victim_count", "spread_evict"),
                          got, want):
        check(torch.equal(bits(a), bits(b)),
              f"preemption burst, first pass: {name} cuda != cpu")
    print(f"preemption burst {PREEMPT_NODES} full nodes, {PREEMPTORS} "
          f"preemptors needing 2 evictions each: all bound on their "
          f"nominated node in {burst_s:.3f} s, {len(evicted)} distinct "
          f"evictions, no node over its allocatable, {m['batches']} "
          f"batches, {m['residency_nomination_carries']} with a nomination "
          f"carried ({len(trickle)} small pods on the spare node meanwhile);"
          f" the first pass's op outputs equal cuda vs cpu ({smi})")
    return burst_s


def zone_counts(nodes, placed):
    """Bound pods per zone label value, from drive()'s placements."""
    zone_of = {n.metadata.name: n.metadata.labels["zone"] for n in nodes}
    counts: dict = {}
    for node_name in placed.values():
        counts[zone_of[node_name]] = counts.get(zone_of[node_name], 0) + 1
    return counts


def path_line(label, m, launches, c2b, per_pod, n_pods, smi) -> str:
    b = m["batches"]
    return (f"{label}: all {n_pods} bound, none over-committed, {b} "
            f"batches, launches {launches}, shortlist repairs "
            f"{m['shortlist_repairs']}, residency resyncs "
            f"{m['residency_resyncs']} hits {m['residency_hits']}, h2d "
            f"{m['h2d_bytes_total'] / b:.0f} B/batch, fetch "
            f"{m['fetch_bytes_total'] / b:.0f} B/batch; create-to-bound "
            f"{c2b:.3f} s for all, {n_pods / c2b:.1f} pods/s, per pod p50 "
            f"{np.percentile(per_pod, 50):.3f} s p99 "
            f"{np.percentile(per_pod, 99):.3f} s; prepare "
            f"{m['prepare_s_total']:.3f} s, step {m['step_s_total']:.3f} s,"
            f" resolve {m['resolve_s_total']:.3f} s, bind "
            f"{m['bind_s_total']:.3f} s ({smi})")


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

    # 2. build: one nvcc per kernel source, all started together
    t = time.perf_counter()
    with ThreadPoolExecutor(len(_cuda_build.KERNELS)) as pool:
        libs = dict(zip(_cuda_build.KERNELS,
                        pool.map(_cuda_build.build, _cuda_build.KERNELS)))
    print(f"build: {', '.join(libs)} in {time.perf_counter() - t:.2f} s "
          f"({smi})")
    for name, lib in libs.items():
        with open(lib + ".log") as f:
            print(f"ptxas {name}: " + " | ".join(
                ln.strip() for ln in f if "registers" in ln or "spill" in ln))

    # 3. the greedy kernel vs its plain version on the card
    rng = np.random.default_rng(0)
    seed = prng.bits(prng.fold_in(prng.PRNGKey(0), 1))
    err = {name: 0.0 for name in _cuda_build.KERNELS}
    for name, P, N, kw in (("ties", 16, 128, {}),
                           ("scarce", 24, 128, {"cpu_free": 300.0}),
                           ("off-tile", 13, 200, {}),
                           ("uneven 132-block", 256, 8449, {"R": 10})):
        args = random_case(rng, P, N, **kw)
        k = greedy_assign_cuda(*args, seed)
        p = greedy_assign_plain(*args, seed)
        torch.cuda.synchronize()
        err["greedy_assign"] = max(err["greedy_assign"], compare(k, p))
        print(f"greedy kernel vs plain {name} {P}x{N}x{args[1].shape[1]}: "
              f"bitwise equal, {int(p.assigned.sum())} assigned")

    plugin_set = BENCH_PROFILE.build()
    nodes, pods = bench_workload(N_NODES, N_PODS)
    eb, nf, af = full_width_batch(nodes, pods)
    eb_d, nf_d, af_d = (to_torch(x, "cuda") for x in (eb, nf, af))
    scores, _fc, _rc = evaluate(plugin_set, eb_d, nf_d, af_d)
    eval_ms = cuda_ms(lambda: evaluate(plugin_set, eb_d, nf_d, af_d), reps=5)
    args = (scores, eb_d.pf.requests, nf_d.free)
    P, N = scores.shape
    R = args[1].shape[1]
    k = greedy_assign_cuda(*args, seed)
    p = greedy_assign_plain(*args, seed)
    torch.cuda.synchronize()
    err["greedy_assign"] = max(err["greedy_assign"], compare(k, p))
    greedy_ms = cuda_ms(lambda: greedy_assign_cuda(*args, seed), reps=20)
    greedy_plain_ms = host_ms(lambda: greedy_assign_plain(*args, seed))
    moved = 4 * (P * N + P * R + N * R) + 4 * P + P + 4 * N * R
    compares = P * N * (R + 2)  # fits per axis, score and noise order
    greedy_bound_s = max(moved / HBM_BYTES_PER_S, compares / F32_OPS_PER_S)
    greedy_bound_by = ("bytes" if moved / HBM_BYTES_PER_S
                       >= compares / F32_OPS_PER_S else "operations")
    print(f"greedy kernel vs plain full width {P}x{N}x{R}: bitwise equal, "
          f"{int(p.assigned.sum())} assigned; kernel {greedy_ms:.3f} ms "
          f"({greedy_ms * 1e3 / P:.3f} us per pod; grid-barrier kernel "
          f"{GRID_BARRIER_KERNEL_MS} ms), plain {greedy_plain_ms:.1f} ms, "
          f"bound {greedy_bound_s * 1e3:.4f} ms ({greedy_bound_by}) ({smi})")
    full_greedy = k
    del p

    # 4. the selection and scan kernels vs their plain versions on the card
    cases = ([(f"random s{s} K={kk}", 96, 384, 3, s, kk, {})
              for s in (0, 1, 2) for kk in (1, 16, 128)]
             + [("plateau K=16", 128, 512, 3, 7, 16, {"plateau": True}),
                ("contention K=8", 128, 512, 3, 3, 8, {"contend": True})]
             + [(f"width K={kk}", 64, 384, 3, 9, kk, {})
                for kk in (1, 384, 4096)]
             + [("off-tile K=16", 13, 200, 3, 5, 16, {}),
                ("device layout K=16", 6000, 20000, 10, 4, 16, {})])
    for name, cp, cn, cr, cs, kk, kw in cases:
        case = shortlist_case(cp, cn, cr, cs, **kw)
        kk = min(kk, cn)
        err["shortlist_select"] = max(err["shortlist_select"],
                                      select_pair(case[0], seed, kk))
        got, plain, _sel, _ms = scan_pair(*case, seed, kk)
        err["shortlist_scan"] = max(
            err["shortlist_scan"],
            compare(got, plain, ("chosen", "assigned", "free_after",
                                 "repaired")))
        print(f"selection and scan kernels vs plain {name} {cp}x{cn}x{cr}: "
              f"bitwise equal, {int(plain.assigned.sum())} assigned, "
              f"{int(plain.repaired.sum())} repaired")
        del case, got, plain, _sel
    zrng = np.random.default_rng(4)
    signed = np.where(zrng.random((12, 300)) < 0.5, 0.0, -0.0)
    for row in signed:
        row[zrng.choice(300, 3, replace=False)] = 5.0
    wide = zrng.random((4, 60_000), dtype=np.float32)
    lrng = np.random.default_rng(5)
    list_rows = [(kind, *select_list_case(kind, lrng))
                 for kind in SELECT_CARD_LIST_KINDS]
    for name, rows, kks in (
            ("signed zeros", signed, (1, 7, 128, 300)),
            ("NEG only", np.full((8, 1000), NEG), (1, 16, 1000)),
            ("K = N", np.round(zrng.random((16, 777)) * 4) / 4, (777,)),
            ("wide, K up to N", wide, (4096, 30_000, 60_000)),
            *((f"list path {kind}", rows, (kk,))
              for kind, rows, kk in list_rows)):
        rows_d = torch.from_numpy(rows.astype(np.float32)).cuda()
        for kk in kks:
            err["shortlist_select"] = max(err["shortlist_select"],
                                          select_pair(rows_d, seed, kk))
        print(f"selection kernel vs plain {name} {tuple(rows.shape)} K in "
              f"{kks}: bitwise equal")
    for kk in (K, 1000):  # the list path, and the exact path's cached row
        err["shortlist_select"] = max(err["shortlist_select"],
                                      select_pair(scores, seed, kk))
    sel4 = shortlist_select_cuda(scores, seed, K)
    select_ms = cuda_ms(lambda: shortlist_select_cuda(scores, seed, K),
                        reps=20)
    select_plain_ms = cuda_ms(
        lambda: shortlist_select_plain(scores, seed, K), reps=5)
    topk_ms = cuda_ms(lambda: torch.topk(scores, K, dim=1), reps=10)
    select_bound_s_, select_bound_by = select_bound_s(P, N, K)
    print(f"selection kernel vs plain full width {P}x{N} K={K} and K=1000: "
          f"bitwise equal; K={K} kernel {select_ms:.4f} ms, plain "
          f"{select_plain_ms:.3f} ms, one torch.topk of the scores {topk_ms:.3f} ms, bound "
          f"{select_bound_s_ * 1e3:.4f} ms ({select_bound_by}) ({smi})")
    got, plain, sel, scan_plain_ms = scan_pair(*args, seed, K)
    err["shortlist_scan"] = max(err["shortlist_scan"], compare(
        got, plain, ("chosen", "assigned", "free_after", "repaired")))
    compare(got, full_greedy)  # the shortlist decides as the full kernel
    scan_repairs = int(plain.repaired.sum())
    scan_ms = cuda_ms(lambda: shortlist_scan_cuda(
        scores, sel4[0], sel4[1], sel4[2], args[1], args[2], seed,
        cand_scores=sel4[3]), reps=20)
    scan_bound_s_, scan_bound_by = scan_bound_s(P, N, K, R, scan_repairs)
    print(f"shortlist kernel vs plain full width {P}x{N}x{R} K={K}: bitwise "
          f"equal, equal to the full greedy kernel, "
          f"{int(plain.assigned.sum())} assigned, {scan_repairs} repaired; "
          f"kernel {scan_ms:.4f} ms ({scan_ms * 1e3 / P:.3f} us per pod), "
          f"plain {scan_plain_ms:.1f} ms, bound {scan_bound_s_ * 1e3:.4f} "
          f"ms ({scan_bound_by}; the real limit is the chain of {P} "
          f"dependent steps) ({smi})")
    del got, plain, sel, sel4, full_greedy
    cont = shortlist_case(BATCH, N, R, 3, contend=True)
    got, plain, sel, cont_plain_ms = scan_pair(*cont, seed, K)
    err["shortlist_scan"] = max(err["shortlist_scan"], compare(
        got, plain, ("chosen", "assigned", "free_after", "repaired")))
    cont_repairs = int(plain.repaired.sum())
    check(cont_repairs > 0, "the contention batch made no repairs")
    cont_ms = cuda_ms(lambda: shortlist_scan_cuda(
        cont[0], sel[0], sel[1], sel[2], cont[1], cont[2], seed), reps=5)
    # Per repair: the batch's time less its certified steps at the bench
    # batch's time per step, over the repairs.
    per_repair_us = (cont_ms - scan_ms / P * (BATCH - cont_repairs)) \
        * 1e3 / cont_repairs
    print(f"shortlist kernel vs plain contention {BATCH}x{N}x{R} K={K}: "
          f"bitwise equal, {int(plain.assigned.sum())} assigned, "
          f"{cont_repairs} repaired; kernel {cont_ms:.3f} ms, about "
          f"{per_repair_us:.2f} us per repair (the walker and 11 helper "
          f"warps scan the {N}-column row), plain {cont_plain_ms:.1f} ms "
          f"({smi})")
    print(f"step parts at full width: filters+scores {eval_ms:.3f} ms, "
          f"greedy kernel {greedy_ms:.3f} ms, or shortlist_select "
          f"{select_ms:.3f} ms + shortlist scan {scan_ms:.3f} ms ({smi})")
    del got, plain, sel, cont, scores, args

    # 5. one full-width step: shortlist vs full kernel, then cuda vs cpu
    key = prng.fold_in(prng.PRNGKey(0), 1)
    steps = {}
    for kk in (K, None):
        step = build_step(plugin_set, shortlist=kk)
        step(eb_d, nf_d, af_d, key)  # warm
        t = time.perf_counter()
        d_gpu = step(eb_d, nf_d, af_d, key)
        torch.cuda.synchronize()
        gpu_s = time.perf_counter() - t
        t = time.perf_counter()
        d_cpu = step(to_torch(eb, "cpu"), to_torch(nf, "cpu"),
                     to_torch(af, "cpu"), key)
        cpu_s = time.perf_counter() - t
        for field in d_cpu._fields:
            check(torch.equal(bits(getattr(d_gpu, field)),
                              bits(getattr(d_cpu, field))),
                  f"step shortlist={kk} field {field}: cuda != cpu")
        steps[kk] = (d_gpu, gpu_s, cpu_s)
        print(f"step full width {P}x{N} shortlist={kk}: every Decision "
              f"field bitwise equal cuda vs cpu; cuda {gpu_s * 1e3:.3f} ms, "
              f"cpu {cpu_s:.3f} s ({smi})")
    compare(steps[K][0], steps[None][0])
    print(f"step full width shortlist={K} vs None on cuda: chosen, assigned "
          f"and free_after bitwise equal; {steps[K][1] * 1e3:.3f} ms vs "
          f"{steps[None][1] * 1e3:.3f} ms per step ({smi})")
    del steps

    # 6. the sampled step at bench-50k: the default config's K of the pad
    skey_step, skey = prng.split(key)
    sseed = prng.bits(skey_step)
    nf_c = to_torch(nf, "cpu")
    idx = _select_node_sample(nf_d, skey, SAMPLE_K)
    check(torch.equal(idx.cpu(), _select_node_sample(nf_c, skey, SAMPLE_K)),
          "node sample rows: cuda != cpu")
    torch.cuda.set_sync_debug_mode("error")
    try:
        _select_node_sample(nf_d, skey, SAMPLE_K)
    except RuntimeError as e:
        check(False, f"picking the node sample waits on the card: {e}")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    sample_ms = cuda_ms(lambda: _select_node_sample(nf_d, skey, SAMPLE_K),
                        reps=10)
    sample_dev_ms = device_ms(
        lambda: _select_node_sample(nf_d, skey, SAMPLE_K), reps=10)
    sample_spin_ms = queued_ms(
        lambda: _select_node_sample(nf_d, skey, SAMPLE_K), reps=10)
    nf_s = _gather_nodes(nf_d, idx)
    s_scores, _fc, _rc = evaluate(plugin_set, eb_d, nf_s, af_d)
    s_args = (s_scores, eb_d.pf.requests, nf_s.free)
    SP, SN = s_scores.shape
    k = greedy_assign_cuda(*s_args, sseed)
    p = greedy_assign_plain(*s_args, sseed)
    torch.cuda.synchronize()
    err["greedy_assign"] = max(err["greedy_assign"], compare(k, p))
    s_greedy_ms = cuda_ms(lambda: greedy_assign_cuda(*s_args, sseed), reps=20)
    s_greedy_plain_ms = host_ms(lambda: greedy_assign_plain(*s_args, sseed))
    moved = 4 * (SP * SN + SP * R + SN * R) + 4 * SP + SP + 4 * SN * R
    compares = SP * SN * (R + 2)
    s_greedy_bound_s = max(moved / HBM_BYTES_PER_S, compares / F32_OPS_PER_S)
    s_greedy_bound_by = ("bytes" if moved / HBM_BYTES_PER_S
                         >= compares / F32_OPS_PER_S else "operations")
    s_greedy = k
    del p
    err["shortlist_select"] = max(err["shortlist_select"],
                                  select_pair(s_scores, sseed, K))
    s_sel = shortlist_select_cuda(s_scores, sseed, K)
    s_select_ms = cuda_ms(lambda: shortlist_select_cuda(s_scores, sseed, K),
                          reps=20)
    s_select_plain_ms = cuda_ms(
        lambda: shortlist_select_plain(s_scores, sseed, K), reps=5)
    s_topk_ms = cuda_ms(lambda: torch.topk(s_scores, K, dim=1), reps=10)
    s_select_bound_s, s_select_bound_by = select_bound_s(SP, SN, K)
    got, plain, _sel, s_scan_plain_ms = scan_pair(*s_args, sseed, K)
    err["shortlist_scan"] = max(err["shortlist_scan"], compare(
        got, plain, ("chosen", "assigned", "free_after", "repaired")))
    compare(got, s_greedy)  # the shortlist decides as the full kernel
    s_repairs = int(plain.repaired.sum())
    s_scan_ms = cuda_ms(lambda: shortlist_scan_cuda(
        s_scores, s_sel[0], s_sel[1], s_sel[2], s_args[1], s_args[2], sseed,
        cand_scores=s_sel[3]), reps=20)
    s_scan_bound_s, s_scan_bound_by = scan_bound_s(SP, SN, K, R, s_repairs)
    print(f"sampled kernels at {SP}x{SN}x{R} (the sample of {SAMPLE_K} "
          f"nodes, rows cuda = cpu, picked with no host sync, {sample_ms:.3f} "
          f"ms to pick back to back, "
          f"{fmt_ms(sample_dev_ms, 3)} of it device time, "
          f"{fmt_ms(sample_spin_ms, 3)} on the spin clock): greedy, "
          f"selection (K={K}) and scan kernels bitwise equal to their plain "
          f"versions, the scan equal to the greedy kernel, "
          f"{int(plain.assigned.sum())} assigned, {s_repairs} repaired; "
          f"greedy {s_greedy_ms:.4f} ms (plain {s_greedy_plain_ms:.1f} ms, "
          f"bound {s_greedy_bound_s * 1e3:.4f} ms {s_greedy_bound_by}); "
          f"selection {s_select_ms:.4f} ms (plain {s_select_plain_ms:.3f} "
          f"ms, one torch.topk {s_topk_ms:.3f} ms, bound "
          f"{s_select_bound_s * 1e3:.4f} ms {s_select_bound_by}); scan "
          f"{s_scan_ms:.4f} ms (plain {s_scan_plain_ms:.1f} ms, bound "
          f"{s_scan_bound_s * 1e3:.4f} ms {s_scan_bound_by}) ({smi})")
    del got, plain, _sel, s_sel, s_greedy, s_scores, s_args, nf_s
    step_ms = {}
    for kk in (K, None):
        step = build_step(plugin_set, shortlist=kk, sample_nodes=SAMPLE_K)
        d_gpu = step(eb_d, nf_d, af_d, key)
        d_cpu = step(to_torch(eb, "cpu"), nf_c, to_torch(af, "cpu"), key)
        for field in d_cpu._fields:
            check(torch.equal(bits(getattr(d_gpu, field)),
                              bits(getattr(d_cpu, field))),
                  f"sampled step shortlist={kk} field {field}: cuda != cpu")
        if kk == K:
            d_short = d_gpu
        else:
            compare(d_short, d_gpu)
        step_ms[kk] = cuda_ms(lambda: step(eb_d, nf_d, af_d, key), reps=5)
        if kk == K:
            step_dev_ms = device_ms(lambda: step(eb_d, nf_d, af_d, key),
                                    reps=5)
    full_step = build_step(plugin_set, shortlist=K)
    sampled_step = build_step(plugin_set, shortlist=K, sample_nodes=SAMPLE_K)
    for label, fn in (("sampled", sampled_step), ("unsampled", full_step)):
        check_no_sync(lambda: fn(eb_d, nf_d, af_d, key, has_gang=False,
                                 hard_spread=False),
                      f"the bench step, {label}")
    unsampled_ms = cuda_ms(lambda: full_step(eb_d, nf_d, af_d, key), reps=5)
    unsampled_dev_ms = device_ms(lambda: full_step(eb_d, nf_d, af_d, key),
                                 reps=5)
    s_eval_ms = cuda_ms(lambda: evaluate(plugin_set, eb_d, _gather_nodes(
        nf_d, idx), af_d), reps=5)
    print(f"sampled step K={SAMPLE_K}: every Decision field bitwise equal "
          f"cuda vs cpu with shortlist={K} and None, no host sync in the "
          f"sampled or the unsampled step (and chosen, assigned, "
          f"free_after equal between them); CUDA events: sampled "
          f"{step_ms[K]:.3f} ms (shortlist) / {step_ms[None]:.3f} ms (greedy "
          f"kernel), unsampled {unsampled_ms:.3f} ms (shortlist; 9577057: "
          f"{UNSAMPLED_STEP_MS} ms); device time sampled "
          f"{fmt_ms(step_dev_ms, 3)}, unsampled "
          f"{fmt_ms(unsampled_dev_ms, 3)}; "
          f"filters+scores {s_eval_ms:.3f} ms sampled vs {eval_ms:.3f} ms "
          f"full width ({smi})")
    del d_gpu, d_cpu, d_short, full_step, idx

    # 7. BalancedAllocation on the card: the score equals the CPU's
    # correctly rounded one, and the card's float32 sqrt is IEEE
    bal = next(p for p in plugin_set.score_plugins
               if p.name == "NodeResourcesBalancedAllocation")
    ctx = {"af": af_d, "gf": eb_d.gf, "naf": eb_d.naf}
    bal_gpu = bal.score(eb_d.pf, nf_d, ctx)
    ebc, afc = to_torch(eb, "cpu"), to_torch(af, "cpu")
    bal_cpu = bal.score(ebc.pf, nf_c, {"af": afc, "gf": ebc.gf,
                                       "naf": ebc.naf})
    check(torch.equal(bits(bal_gpu), bits(bal_cpu)),
          "BalancedAllocation score: cuda != cpu")
    x = np.random.default_rng(7).random(1 << 22, dtype=np.float32) * 4
    check(torch.equal(bits(torch.sqrt(torch.from_numpy(x).cuda())),
                      torch.from_numpy(np.sqrt(x)).view(torch.int32)),
          "torch.sqrt(float32) on the card is not correctly rounded")
    print(f"BalancedAllocation {tuple(bal_gpu.shape)}: score bitwise equal "
          f"cuda vs cpu; torch.sqrt(float32) on the card = numpy's "
          f"correctly rounded sqrt on {x.size} floats in [0, 4)")
    del eb_d, nf_d, af_d, nf_c, ebc, afc, bal_gpu, bal_cpu, x

    # 8. the port-insertion kernel vs the host replay and the plain version:
    # first at the engine's shapes (resolve passes only the batch's port
    # pods, padded with -1 rows to a power-of-two bucket, against the
    # whole used_ports), then on a port-heavy 1024-pod batch and with
    # 1024 pods on one row
    port_cases_ = port_cases(N, np.random.default_rng(6))
    for name, state, rows, ports in port_cases_:
        state_d = torch.from_numpy(state).cuda()
        rows_d, ports_d = (torch.from_numpy(a).cuda() for a in (rows, ports))
        got = insert_ports_cuda(state_d, rows_d, ports_d)
        mirror = state.copy()
        RES.replay_ports_host(mirror, rows, ports)
        check(torch.equal(got.cpu(), torch.from_numpy(mirror)),
              f"insert_ports kernel != host replay ({name})")
        plain_t = time.perf_counter()
        plain = RES.insert_ports_plain(state_d, rows_d, ports_d)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - plain_t) * 1e3
        check(torch.equal(got, plain),
              f"insert_ports kernel != plain version ({name})")
        err["insert_ports"] = max(err["insert_ports"], float(
            (got.cpu().double() - plain.cpu().double()).abs().max()))
        ms = cuda_ms(lambda: insert_ports_cuda(state_d, rows_d, ports_d),
                     reps=20)
        dev_ms = device_ms(lambda: insert_ports_cuda(state_d, rows_d,
                                                     ports_d), reps=20)
        spin_ms = queued_ms(lambda: insert_ports_cuda(state_d, rows_d,
                                                      ports_d), reps=20)
        # The state is read and written whole (the kernel's copy).
        moved = 2 * state.nbytes + rows.nbytes + ports.nbytes
        bound_s = moved / HBM_BYTES_PER_S
        if name == "engine shape":
            ports_ms, ports_dev_ms = ms, dev_ms
            ports_plain_ms, ports_bound_s = plain_ms, bound_s
        print(f"port-insertion kernel vs host replay and plain, {name}: "
              f"{int((rows >= 0).sum())} port pods in a bucket of "
              f"{len(rows)} x {ports.shape[1]} ports into {N}x{NODE_PORTS}: "
              f"bitwise equal, {int((mirror != state).sum())} slots "
              f"written; kernel {ms:.4f} ms per call back to back "
              f"(host-paced; {fmt_ms(dev_ms, 4)} of device time, the state "
              f"copy and the kernel; {fmt_ms(spin_ms, 4)} on the spin "
              f"clock), plain {plain_ms:.1f} ms, bound "
              f"{bound_s * 1e3:.4f} ms (bytes) ({smi})")
        del state_d, rows_d, ports_d, got, plain

    # 9. the caps scan kernel vs its plain version, and the step of the
    # eight label and topology plugins at full width, cuda = cpu
    t_phase = time.perf_counter()
    caps_t = caps_phase(smi)
    eight_plugin_phase(smi)
    print(f"phase 9 in {time.perf_counter() - t_phase:.1f} s")

    # 10. the volume and preemption slice at full width: the full
    # profile's step, cuda = cpu, and bench.py's preemption candidate
    # search, cuda = cpu
    t_phase = time.perf_counter()
    full_step_phase(smi, key)
    preempt_t = preempt_op_phase(smi)
    print(f"phase 10 in {time.perf_counter() - t_phase:.1f} s")

    # 11. the bench main path: SchedulerConfig(), the default cycle
    nodes, pods = bench_workload(N_NODES, N_PODS)
    picked = []
    m, main_launches, c2b, per_pod, _ = drive(
        SchedulerConfig(platform=""), nodes, pods, "main path",
        probe=lambda sched: picked.append(sched._sampled_step(
            step_bucket(N_NODES), BATCH, False)[1]))
    check(picked == [SAMPLE_K], f"the engine picks K={picked}")
    b = m["batches"]
    for name in ("shortlist_select", "shortlist_scan"):
        check(main_launches[name] >= b > 0,
              f"{name} launched {main_launches[name]} times in {b} batches")
    check(m["residency_resyncs"] == 1 and m["residency_hits"] == b - 1,
          f"residency resyncs {m['residency_resyncs']} hits "
          f"{m['residency_hits']} in {b} batches")
    print(path_line(f"main path (pipeline, device_resident, shortlist "
                    f"K={K}, node sample K={picked[0]} as _sampled_step "
                    f"picks it) {N_NODES} nodes x {N_PODS} pods",
                    m, main_launches, c2b, per_pod, N_PODS, smi)
          + f"; step {m['step_s_total'] / b * 1e3:.3f} ms per batch; "
            f"device free/used_ports = host mirror bitwise; 9577057 "
            f"(unsampled): bursts {UNSAMPLED_BURSTS_S} s, full-width step "
            f"{UNSAMPLED_STEP_MS} ms")

    # 12. this slice's main path: full_scheduler_profile() through
    # Cluster(...).start() with SchedulerConfig(), a fifth of the pods
    # holding a Bound claim on a zone-labelled PV
    t_phase = time.perf_counter()
    # Every claim is Bound before the burst, so the PV controller has
    # nothing to bind; it is off, as in bench.py's engine cells (it relists
    # every claim and PV on each claim-carrying pod event).
    first, pods = full_workload(N_NODES, N_PODS)
    m, full_launches, c2b, per_pod, _ = drive(
        SchedulerConfig(platform=""), first, pods, "full profile",
        FULL_PROFILE, with_pv_controller=False)
    b = m["batches"]
    for name in ("shortlist_select", "shortlist_scan"):
        check(full_launches[name] >= b > 0,
              f"full profile: {name} launched {full_launches[name]} times in "
              f"{b} batches")
    check(m["zone_bound_claims"] == N_PODS // 5,
          f"full profile: {m['zone_bound_claims']} zone-bound claims placed")
    print(path_line(f"full profile (default config, 15 filters, 7 scorers, "
                    f"DefaultPreemption; {N_PODS // 5} pods with a Bound "
                    f"claim on a zone-labelled PV) {N_NODES} nodes x "
                    f"{N_PODS} pods", m, full_launches, c2b, per_pod, N_PODS,
                    smi)
          + f"; {m['sampled_batches']} of {b} batches sampled; every pod "
            "in its PV's zone, no claim on two nodes, no node over its "
            "attach limit; device free/used_ports = host mirror bitwise")
    del first, pods
    print(f"phase 12 in {time.perf_counter() - t_phase:.1f} s")

    # 13. config 4 soft, the main path of the topology slice: the default
    # config, BASELINE config 4's profile (DefaultPreemption on),
    # make_c4_workload's burst
    t_phase = time.perf_counter()
    nodes, pods = c4_workload(N_NODES, N_PODS)
    picked = []
    m, c4_launches, c2b, per_pod, _ = drive(
        SchedulerConfig(platform=""), nodes, pods, "config 4 soft",
        C4_PROFILE, probe=lambda sched: picked.append(sched._sampled_step(
            step_bucket(N_NODES), BATCH, False)[1]))
    b = m["batches"]
    check(picked == [SAMPLE_K], f"config 4 soft: the engine picks K={picked}")
    for name in ("shortlist_select", "shortlist_scan"):
        check(c4_launches[name] >= b > 0,
              f"config 4 soft: {name} launched {c4_launches[name]} times in "
              f"{b} batches")
    check(m["sampled_batches"] == b and m["hard_spread_batches"] == 0,
          f"config 4 soft: {m['sampled_batches']} of {b} batches sampled")
    # No pod fails here, so the PostFilter never runs: the batches are
    # the 1,024-pod tranches, as without it.
    check(b == -(-N_PODS // SchedulerConfig().max_batch_size),
          f"config 4 soft: {b} batches with the PostFilter on")
    c4eb, c4nf, c4af = (to_torch(x, "cuda")
                        for x in full_width_batch(nodes, pods))
    c4_step = build_step(C4_PROFILE.build(), shortlist=K,
                         sample_nodes=SAMPLE_K)
    check_no_sync(lambda: c4_step(c4eb, c4nf, c4af, key, has_gang=False,
                                  hard_spread=False),
                  "the config 4 soft step")
    del c4eb, c4nf, c4af, c4_step
    print(path_line(f"config 4 soft (default config, node sample "
                    f"K={picked[0]}, ScheduleAnyway max_skew 8, preferred "
                    f"affinity on every other pod) {N_NODES} nodes x "
                    f"{N_PODS} pods", m, c4_launches, c2b, per_pod, N_PODS,
                    smi) + "; no host sync in its step")

    # 14. config 4 hard: DoNotSchedule max_skew 1, the skew worst case
    nodes, pods = c4_workload(N_NODES, N_PODS, max_skew=1, hard=True)
    m, hard_launches, c2b, per_pod, placed = drive(
        SchedulerConfig(platform=""), nodes, pods, "config 4 hard",
        C4_PROFILE)
    b = m["batches"]
    check(m["sampled_batches"] == 0 and m["hard_spread_batches"] == b,
          f"config 4 hard: {m['sampled_batches']} of {b} batches sampled")
    check(hard_launches["caps_scan"] >= b > 0,
          f"config 4 hard: caps scan launched {hard_launches['caps_scan']} "
          f"times in {b} batches")
    check(b == -(-N_PODS // SchedulerConfig().max_batch_size),
          f"config 4 hard: {b} batches with the PostFilter on")
    check(m["spread_revoked_enforced"] == 0,
          f"config 4 hard: {m['spread_revoked_enforced']} pods revoked on "
          "a scan-enforced group")
    zc = zone_counts(nodes, placed)
    check(max(zc.values()) - min(zc.values()) <= 1,
          f"config 4 hard: per-zone counts {sorted(zc.values())}")
    print(path_line(f"config 4 hard (default config, DoNotSchedule "
                    f"max_skew 1, every batch unsampled on the caps scan) "
                    f"{N_NODES} nodes x {N_PODS} pods", m, hard_launches,
                    c2b, per_pod, N_PODS, smi)
          + f"; {b} batches to drain, {m['spread_revoked']} revoked by the "
            f"host arbitration ({m['spread_revoked_enforced']} on "
            f"scan-enforced groups), {m['spread_repaired']} repaired; "
            f"app=bench per zone {min(zc.values())}..{max(zc.values())} "
            f"over {len(zc)} zones")

    # 15. cross-device placements: a smaller hard burst, cuda = cpu
    placements = {}
    for platform in ("", "cpu"):
        nodes, pods = c4_workload(1200, 512, max_skew=1, hard=True)
        *_, placements[platform] = drive(
            SchedulerConfig(platform=platform), nodes, pods,
            f"config 4 hard 1,200 x 512 on {platform or 'cuda'}",
            C4_PROFILE)
    check(placements[""] == placements["cpu"],
          "config 4 hard 1,200 x 512: placements cuda != cpu")
    print(f"config 4 hard 1,200 nodes x 512 pods: placements equal on the "
          f"card and on the CPU ({len(placements[''])} pods)")
    print(f"phases 13-15 in {time.perf_counter() - t_phase:.1f} s")

    # 16. a preemption burst on the card
    t_phase = time.perf_counter()
    preempt_burst_s = preempt_burst_phase(smi)
    print(f"phase 16 in {time.perf_counter() - t_phase:.1f} s")

    # 17. the port path: the default cycle books host ports on the device
    nodes, pods = port_heavy_workload()
    m, port_launches, c2b, per_pod, placed = drive(
        SchedulerConfig(platform=""), nodes, pods, "port path",
        PORTS_PROFILE)
    b = m["batches"]
    check(port_launches["insert_ports"] >= 1,
          f"port insertion launched {port_launches['insert_ports']} times "
          f"in {b} batches")
    check(m["residency_resyncs"] == 1 and m["residency_hits"] == b - 1,
          f"port path: residency resyncs {m['residency_resyncs']} hits "
          f"{m['residency_hits']} in {b} batches")
    nodes, pods = port_heavy_workload()
    *_, placed_sync = drive(
        SchedulerConfig(platform="", pipeline=False, device_resident=False,
                        shortlist=False), nodes, pods, "port path, sync",
        PORTS_PROFILE)
    check(placed == placed_sync,
          "port path: placements differ from the synchronous run")
    print(path_line(f"port path (default config, NodePorts profile) "
                    f"{len(nodes)} nodes x {len(pods)} pods with 2 host "
                    f"ports each", m, port_launches, c2b, per_pod,
                    len(pods), smi)
          + "; device used_ports = host mirror bitwise, placements = the "
            "synchronous upload-every-batch run")

    # 18. the earlier path: synchronous, upload every batch, full kernel
    nodes, pods = bench_workload(N_NODES, EARLIER_PODS)
    m, early_launches, c2b, per_pod, _ = drive(
        SchedulerConfig(platform="", pipeline=False, device_resident=False,
                        shortlist=False), nodes, pods, "earlier path")
    b = m["batches"]
    check(early_launches["greedy_assign"] >= b > 0,
          f"greedy kernel launched {early_launches['greedy_assign']} times "
          f"in {b} batches")
    check(early_launches["shortlist_scan"] == 0
          and early_launches["shortlist_select"] == 0,
          "the shortlist kernels ran with shortlist=False")
    print(path_line(f"earlier path (synchronous, full greedy kernel) "
                    f"{N_NODES} nodes x {EARLIER_PODS} pods", m,
                    early_launches, c2b, per_pod, EARLIER_PODS, smi))
    del nodes, pods

    # 19. faults on the card, on a cluster that samples
    for pipeline in (True, False):
        cfg = dict(platform="", pipeline=pipeline, max_batch_size=64,
                   batch_window_s=0.3, backoff_initial_s=0.05,
                   backoff_max_s=0.3, probation_batches=1)
        label = f"faults, pipeline={pipeline}"
        ref, ref_m = fault_burst("", SchedulerConfig(**cfg), label)
        check(ref_m["batch_faults"] == 0 and ref["only-fits-big"]
              == "big-node", f"{label}: the fault-free run")
        placed, fm = fault_burst(FAULT_SPEC, SchedulerConfig(**cfg), label)
        fires = {g: fm[f"fault_fires_{g}"]
                 for g in ("step", "fetch", "commit", "informer")}
        check(set(fires.values()) == {1}, f"{label}: fires {fires}")
        check(fm["degradation_state"] == "resident",
              f"{label}: ends at {fm['degradation_state']}")
        check(placed == ref, f"{label}: placements differ from the "
              "fault-free run")
        print(f"{label}: {FAULT_SPEC} each fired once, {fm['batch_faults']} "
              f"batch faults, {fm['batch_retries']} retries, "
              f"{fm['supervisor_escalations']} escalations, "
              f"{fm['supervisor_recoveries']} recoveries, ends at "
              f"resident; {len(placed)} placements = the fault-free run's")
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    placed, cm = fault_burst("", SchedulerConfig(
        platform="", max_batch_size=64, batch_window_s=0.3,
        shortlist_check_every=1, resident_check_every=1), "cross-checks")
    check(cm["shortlist_checks"] >= cm["batches"] - 1
          and cm["resident_checks"] >= 1 and LAUNCHES["greedy_assign"] > 0,
          f"cross-checks: {cm['shortlist_checks']} shortlist checks, "
          f"{cm['resident_checks']} carry checks, greedy kernel launched "
          f"{LAUNCHES['greedy_assign']} times")
    check(cm["shortlist_desyncs"] == 0 and cm["residency_desyncs"] == 0
          and cm["batch_faults"] == 0 and placed == ref,
          "cross-checks: a desync, a fault or other placements")
    print(f"cross-checks on the card: {cm['shortlist_checks']} shortlist "
          f"checks (the greedy kernel launched {LAUNCHES['greedy_assign']} "
          f"times), {cm['resident_checks']} carry checks, no desync, "
          f"placements = the fault-free run's")

    # 20. the README scenario on the card, default config
    run_scenario(default_scenario, config=SchedulerConfig(platform=""))
    print("README scenario: pod1 pending on NodeUnschedulable, then bound "
          "to node10")

    print(json.dumps({"kernels": [{
        "name": "greedy_assign",
        "route": "cuda",
        "source": "minisched_tpu_torch/csrc/greedy_assign.cu",
        "replaces": "minisched_tpu/ops/pallas_select.py:151",
        "launches": early_launches["greedy_assign"],
        "max_abs_err": err["greedy_assign"],
        "ms": s_greedy_ms,
        "plain_ms": s_greedy_plain_ms,
        "bound_ms": s_greedy_bound_s * 1e3,
        "bound_by": s_greedy_bound_by,
        "library_ms": None,
    }, {
        "name": "shortlist_select",
        "route": "cuda",
        "source": "minisched_tpu_torch/csrc/shortlist_select.cu",
        "replaces": "minisched_tpu/ops/select.py:144",
        "launches": full_launches["shortlist_select"],
        "launches_by_path": {"full profile": full_launches[
            "shortlist_select"], "bench": main_launches["shortlist_select"],
            "config 4 soft": c4_launches["shortlist_select"]},
        "max_abs_err": err["shortlist_select"],
        "ms": s_select_ms,
        "plain_ms": s_select_plain_ms,
        "bound_ms": s_select_bound_s * 1e3,
        "bound_by": s_select_bound_by,
        "library_ms": None,
    }, {
        "name": "shortlist_scan",
        "route": "cuda",
        "source": "minisched_tpu_torch/csrc/shortlist_scan.cu",
        "replaces": "minisched_tpu/ops/select.py:238",
        "launches": full_launches["shortlist_scan"],
        "launches_by_path": {"full profile": full_launches[
            "shortlist_scan"], "bench": main_launches["shortlist_scan"],
            "config 4 soft": c4_launches["shortlist_scan"]},
        "max_abs_err": err["shortlist_scan"],
        "ms": s_scan_ms,
        "plain_ms": s_scan_plain_ms,
        "bound_ms": s_scan_bound_s * 1e3,
        "bound_by": s_scan_bound_by,
        "library_ms": None,
    }, {
        "name": "insert_ports",
        "route": "cuda",
        "source": "minisched_tpu_torch/csrc/insert_ports.cu",
        "replaces": "minisched_tpu/ops/residency.py:195",
        "launches": port_launches["insert_ports"],
        "max_abs_err": err["insert_ports"],
        "ms": ports_ms,
        "device_ms": ports_dev_ms,
        "plain_ms": ports_plain_ms,
        "bound_ms": ports_bound_s * 1e3,
        "bound_by": "bytes",
        "library_ms": None,
    }, {
        "name": "caps_scan",
        "route": "cuda",
        "source": "minisched_tpu_torch/csrc/caps_scan.cu",
        "replaces": "minisched_tpu/ops/select.py:80",
        "launches": hard_launches["caps_scan"],
        "max_abs_err": caps_t["err"],
        "ms": caps_t["ms"],
        "plain_ms": caps_t["plain_ms"],
        "bound_ms": caps_t["bound_s"] * 1e3,
        "bound_by": caps_t["bound_by"],
        "library_ms": None,
    }], "stages": [{
        # Not a kernel: the preemption op is PyTorch ops (the JAX package
        # computes it outside any Pallas kernel), timed here at bench.py's
        # shape.
        "name": "preempt_op",
        "source": "minisched_tpu_torch/ops/preempt.py",
        "replaces": "minisched_tpu/ops/preempt.py:72",
        "ms": preempt_t["ms"],
        "device_ms": preempt_t["device_ms"],
        "bound_ms": preempt_t["bound_s"] * 1e3,
        "bound_by": preempt_t["bound_by"],
        "candidates": preempt_t["found"],
        "preemption_burst_s": preempt_burst_s,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

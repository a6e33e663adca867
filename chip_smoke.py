"""Drive the PyTorch/CUDA port on one GPU and check it end to end.

    python3 chip_smoke.py

Needs a CUDA card and the CUDA toolkit (nvcc); exits non-zero without
them, and on any mismatch. Phases, each printing its own lines:

  1. the card (nvidia-smi name and power limit) and the torch/CUDA build;
  2. build the seven kernels with nvcc, one process each, all at once,
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
  A. at that shape, the selection, scan and bid-auction kernels vs
     their plain versions at the widths the overload tuner sets (K in
     {16, 256, 512}: past the selection's fast path, the scan's
     candidate ring and the bid kernel's warp path), bitwise on every
     output, each time beside its bound;
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
  B. phase 11's workload again with the timeline, the SLO sentinel, the
     overload controller (default knobs), the journal and the trace
     recorder armed: placements equal to phase 11's bitwise, overload
     level 0, nothing shed, the four gap components summing to
     gap_s_total, every lifecycle histogram counting each bound pod
     once, a timeline snapshot, the flight recorder holding queue.pop,
     encode.pods, step.dispatch, fetch.decision and bind.bulk; the gap
     decomposition and the histograms' p50/p99 printed;
  C. trace_next_batch during that burst: one sampled batch under
     torch.profiler, its device operations by time (the kernels by
     name) and the device's busy share of the batch window;
 12. the volume slice's main path: the same with full_scheduler_profile()
     (CUT_PODS = 5,120 pods) and a fifth of the pods holding a Bound claim on a zone-labelled
     PV (every claim Bound up front, no PV controller): all bound, no node over its allocatable (attach slots
     included), no claim mounted on two nodes, each zone-bound pod in
     its PV's zone, the selection and scan kernels in every batch, the
     carried device state equal to its host mirror;
 13. config 4 soft: the same with BASELINE config 4's profile
     (NodeUnschedulable, NodeResourcesFit, PodTopologySpread,
     InterPodAffinity, DefaultPreemption) and make_c4_workload's pods
     (ScheduleAnyway max_skew 8, preferred affinity on every other pod):
     every batch sampled, the selection and scan kernels in each, no
     host sync in its step, the five 1,024-pod batches of CUT_PODS (no
     pod fails, so the PostFilter never runs);
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
  D. the overload ladder on phase 19's cluster, every object in the
     store before the engine starts and the controller pinned (hold
     1,000,000): rung 1 (batches of 16, K=512) and rung 3 (brownout,
     node sampling at 20%) place as on the CPU bitwise; rung 2 with the
     pods' priorities split at 500 binds every pod and sheds as many as
     the CPU run; then the ladder walked into brownout through real
     snapshot windows with incident bundles armed, and
     tools/postmortem.py accepting the brownout bundle;
 20. the auction kernels (csrc/auction.cu, csrc/bid_auction.cu) vs their
     plain versions, bitwise on every output and in the rounds run:
     tests/torch_parity.py's auction instances at
     each width (one of 16,385 pods, past the kernels' old cap), the fold
     and strength cases that one rounding and two decide differently,
     equal strengths, round budgets that run out, and 1,300,000 pods
     against 2 nodes (past the shared-memory wall of the earlier layout;
     the feasible rows the last 48); then the bench batch at full width
     (1,024 x 53,248 x 10, one band and three bands, dense and K=128) and
     at the sampled shape the bench burst runs (1,024 x 4,096), each
     with its time back to back, device time, plain time and bound (the
     bid shortlist's selection alone as well), and a full-width
     contention batch (the dense kernel timed) where the bid shortlist
     at K in {1, 128, N} equals the dense rounds;
 21. build_step(assignment="auction") cuda = cpu on every Decision
     field, sampled and unsampled, with and without the bid shortlist,
     and on 16,385 pods (an 18,432-row step past the old cap, the
     feasible pods the last 65); no host sync in the gang-free sampled
     step;
 22. the bench burst with SchedulerConfig(assignment="auction") (50,000
     nodes x 10,000 pods, sampled): all bound, none over-committed, the
     bid-shortlist kernel in every batch, the carried device state equal
     to its host mirror; create-to-bound;
 23. BASELINE config 5 under the auction: the same pods in gangs of 8 at
     quorum 8 (every batch unsampled, 1,024 x 53,248): all bound, every
     gang whole, no pod failed, the kernel in every batch;
 24. the auction on a 1,201-node cluster with both cross-checks (the
     dense kernel as the shortlist's reference), then under
     auction_mirror:corrupt@2: the phantom debit caught as a carry
     desync, the placements equal the fault-free run's;
 25. the reference's README scenario on the card (default config);
 E1. the explain step (SchedulerConfig.explain) cuda = cpu on every
     Decision field, the three per-plugin stacks and total_scores
     included: the bench profile at 1024 x 53,248 (in phase 5), the full
     profile at 256 x 53,248 (in phase 10), and config 4 hard at 1024 x
     53,248 (after phase 10) with no caps built or launched, the
     shortlist kernels launched and no host sync with hard_spread=None;
     each step's time beside the step without explain, its peak device
     memory;
 E2. (after phase 11, with the native clone's status) the explain burst:
     bench-50k with SchedulerConfig(explain=True), every batch unsampled
     (1024 x 53,248): the selection and scan kernels in every batch, all
     bound, none over-committed, every pod with its three annotations
     of at most 128 nodes, filter_verdict for 16 pods on 3 nodes
     outside the annotation and on the chosen node (every filter
     passed, as the annotation says where it lists it); create-to-bound,
     the gap decomposition beside phase 11's, the result store's
     counters, the worker's ingest seconds per batch, peak device memory;
 E3. explain mode cuda = cpu at the engine level (1,200 nodes x 512
     pods): config 4 hard (the caps off: the host arbitration and its
     repair) and the bench profile under the auction: placements, every
     pod's three annotation strings byte for byte, filter_verdict on
     three nodes outside each annotation; no zone over its skew;
 E4. the pod-chunked step at 8,192 x 53,248 (C = 2,048), bench profile
     and config 4 hard, against the unchunked step: every Decision field
     bitwise, peak memory both ways; the selection and scan kernels vs
     plain at that shape, with times and bounds;
 E5. phase D's pinned rung 3 with explain on, cuda against cpu:
     overload_explain_skipped equal (every batch), no pod annotated;
 E6. the demo scenario (scenario/demo.py) on the card: demo OK.
 F1. the device loop: the bench profile at 50,000 nodes x LOOP_PODS,
     every pod in the store first, unsampled (percentage 100), with
     device_loop=True (depth 8) against the same burst without:
     placements bitwise equal, steps_dispatched < batches,
     decision_fetches == steps_dispatched, no loop break, the selection
     and scan kernels once a slot, no host sync inside a tranche (torch's
     sync debug mode "error" around each tranche's slots), the carried
     free equal to its host mirror; both create-to-bound times and the
     stacked fetch bytes;
 F2. 1,200 nodes x 512 pods in batches of 64, unsampled, loop on,
     greedy and auction: placements and the loop counters on the card
     equal the CPU's; then fetch:corrupt@2 on the card: one break, every
     pod bound once on its fault-free node;
 G1. the maintained index on F1's workload (index_classes=128: the bench
     pods make 70 classes): all bound, index hits, placements equal to
     F1's index-off burst, the first indexed batch's gathered class-row
     view through the selection and scan kernels equal to their plain
     versions, the index state's bytes and the peak device memory; then
     at the default 64 classes (a batch at a time) every batch a counted
     fallback;
 G2. F2's cluster with index_check_every=1, its pods created a batch at
     a time once the previous are bound and the cache is quiet (no bind
     confirmation in flight when a batch prepares: an index race depends
     on the informer's timing): placements and the index counters on the
     card equal the CPU's, no desync; then index:corrupt@2: one desync,
     the index disabled, an index_revert bundle, the fault-free
     placements.
 H1. fused multi-tenant arbitration (service.TenantFusionCoordinator):
     TENANTS tenants, each the bench-50k cluster with its own
     TENANT_PODS pods, all in the stores first, unsampled, rounds
     single-stepped over quiet caches: fused (one lane a tenant) against
     sequential, placements equal per tenant, the fused rounds'
     dispatches and fetches against the sequential steps', one
     selection and one scan launch per fused group, no pod bound twice,
     no node over-committed; the first group's stacked (T, 1,024,
     53,248) inputs through the lane kernels equal their plain versions
     and T solo launches bitwise, the batched launches timed against
     the solo launches in turns with their bounds; the rounds' host
     time; peak device memory;
 H2. the same tenants with the index (128 classes): round 1 ejects every
     lane (cold) and rebuilds it solo, round 2 serves every lane in one
     fused indexed dispatch; placements equal H1's; the lane kernels on
     the gathered class rows against plain and solo;
 H3. 1,200 nodes, four tenants of 256, 256, 200 and 40 pods, rounds of
     64 slots (mixed-bucket rounds), unsampled: placements and the
     deterministic counters cuda = cpu, full and indexed
     (index_check_every=1); then tenant_index:corrupt@2: the gate fires
     once, one lane desyncs and runs its supervised retry, the others
     settle, every pod on its fault-free node.
 I1. the engine as a pure network client of the port's API server at
     bench-50k: WIRE_PODS bench pods and the 50,000 nodes in a served
     ClusterStore first (APIServer with a bearer token and
     max_inflight=256, as bench.py serves its wire cell), the
     SchedulerService on a RemoteStore with SchedulerConfig() and the
     bench profile: every pod bound once, none over-committed, one
     selection and one scan launch per batch, placements equal to the
     same stored workload in process (drive(..., pods_first=True)), the
     client's store_breaker_* keys in the engine's metrics with the
     breaker closed; the sync time, both create-to-bound times and the
     engine's prepare / step / resolve / bind split;
 I2. the remote scenario (scenario/remote.py): the server subprocess's
     co-located engine on the card, then --client-engine with the
     engine in this process on the card: pod1 pends on
     NodeUnschedulable, binds to node10, the watch replays from cursor
     0;
 I3. two profiles of one SchedulerConfiguration over 1,200 bench nodes
     and 512 pods (half naming each) with the service's checkpoint: the
     first profile's pods bound, shutdown (the final checkpoint),
     open_or_restore, the second profile's pods, restart; on the card
     and on the CPU: placements equal, no pod bound twice, none
     over-committed; a co-located API server's /metrics with both
     profiles' prefixed keys.
 J1. the in-process replicated fleet at bench-50k (SchedulerConfig(),
     default lease TTL): the first FLEET_PODS of bench_workload's pods
     whose key falls in shard 0 of 2, stored first, on a single engine
     and then on Cluster.start(fleet=2): placements bitwise equal, r1
     launches no kernel (its own kernel_launches_<name>), r0 one
     selection and one scan per batch, the replicas' launches summing to
     the process-wide counts, stale_owner_binds and bind_conflicts 0;
 J2. a crash failover at bench-50k (tools/bench_fleet.py's failover
     round on the headline cluster): fleet=2, the first half of
     FAILOVER_PODS bench pods created, r1 killed with crash=True once
     the fleet has bound FAILOVER_KILL_AT, the second half created:
     every pod bound exactly once (no pod seen on two nodes), none
     over-committed, a takeover journaled from r1, every lease held by
     r0 at the end; the takeover latency, create-to-bound, the
     fleet-merged p99, the lease counters and stale_owner_binds;
 J3. the lifecycle oracle on the card, every default invariant after
     every step: bench.py's clean churn_bench composition (16 base
     nodes, diurnal arrivals, the tenant mix, the autoscaler,
     reclamation waves and a rolling upgrade under one
     max_unavailable=2 budget, CHURN_S seconds), then
     tests/test_fleet.py's kill and restart soak on fleet=2 with a
     0.4 s lease TTL: zero violations, settled, every engine resident,
     a takeover.
 K1. the process fleet at bench-50k: the port's API server serves the
     50,000 bench nodes to a ProcFleetSupervisor of two replica
     processes (SchedulerConfig(), the bench profile, prewarm on, the
     default lease TTL; the kernels built once before the spawn); once
     both are ready the first half of FLEET_PROC_PODS bench pods is
     stored, p1 is SIGKILLed once FLEET_PROC_KILL_AT are bound, and the
     second half is stored (so the dead shard has pods left to adopt:
     4,096 pods stored at once were all bound before a 50 ms poll saw
     half of them): every pod bound exactly once, none
     over-committed, the takeover in the merged journal, p0 holding
     every lease at the end, p1 respawned at incarnation 1 and ready,
     each replica's own selection and scan launches in its sidecar
     metrics, both replicas holding the card (a /dev/nvidia<n> file
     open, nvidia-smi's compute processes up by two) and no launch in
     this process; each replica's sync and prewarm
     times, the takeover latency, time_to_first_slo_s (SIGKILL to the
     adopter's first bind of a pod of the dead shard), create-to-bound
     and p99;
 K2. the self-governing fleet on the card: an ElectFleet of three
     detached replicas over ELECT_NODES bench nodes and ELECT_PODS pods;
     the steward SIGKILLed: one new steward at a higher epoch, the dead
     replica respawned exactly once (incarnation 1), every pod bound
     once, every pid the fleet showed reaped at the end;
 K3. a replica with platform="cpu" spawned on the card's machine binds
     its pods, reports that it never initialized CUDA, holds no
     /dev/nvidia* file, and never shows among nvidia-smi's compute
     processes (neither its pid nor one more context: the platform
     guard).
     The replicas' standard error goes to smoke_out/phase_k_stderr.log
     (its last lines are printed if phase K fails).
 L1. the sharded step at full width: bench-50k's first 1,024-pod batch
     against the 53,248-row pad (the bench profile) on a (2,4) virtual
     mesh over cuda:0 and on a (1,1) mesh, greedy and auction: every
     Decision field equals the single-device step's (unsampled, no
     shortlist) bitwise; the greedy scan launches the greedy kernel once
     per chunk (8 chunks of 128 rows), each launch equal to
     greedy_assign_plain on the same chunk, the auction the dense
     auction kernel; the sharded and single-device steps' ms;
 L2. the engine on the (2,4) mesh at bench-50k, MESH_PODS pods stored
     before it starts: the placements equal the single-device engine's
     with percentage_of_nodes_to_score=100 and the same seed, every pod
     bound, none over-committed; its decision reads (count and bytes)
     equal the single-device engine's (one packed read a batch);
     create-to-bound and the greedy launches booked;
 L3. the multi-process dryrun (parallel/dcn_dryrun.py) with both gloo
     workers on cuda:0: DCN-OK from each, the decision equal to the
     single-device recompute, each worker holding the card (a
     /dev/nvidia<n> file open, nvidia-smi's compute processes up by
     two), the gloo operations staged through host buffers named, and no
     launch in this process.

Phase 6 also runs the bench step, sampled and unsampled, under torch's
sync debug mode "error" with the engine's host flags (no gang, no
DoNotSchedule slot): the step never waits on the card.

The line before the last is the kernel table as JSON (the shortlist
kernels' launches are the full-profile burst's, with each path's beside
them; the bid-shortlist kernel's the auction bench burst's, the dense
auction's the cross-check run's; the preemption op, PyTorch ops and no
kernel, under "stages"; the explain burst's numbers under "explain";
the native clone's status under "native_clone"; phase I's under
"wire", phase J's under "fleet", phase K's under "fleet"."proc", phase
L's under "mesh", and the mesh path's launches and errors of the greedy
and auction kernels under their own "mesh" keys); the last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from minisched_tpu_torch import faults, lifecycle, native, obs
from minisched_tpu_torch.apiserver import APIServer, RemoteStore
from minisched_tpu_torch.config import SchedulerConfig
from minisched_tpu_torch.encode import NodeFeatureCache, encode_pods, to_torch
from minisched_tpu_torch.encode.cache import step_bucket
from minisched_tpu_torch.fleet.election import ElectFleet, _pid_dead
from minisched_tpu_torch.fleet.procfleet import ProcFleetSupervisor
from minisched_tpu_torch.fleet.shardmap import shard_of
from minisched_tpu_torch.engine import overload
from minisched_tpu_torch.explain import FILTER_RESULT_KEY, ResultStore
from minisched_tpu_torch.engine import scheduler as engine_scheduler
from minisched_tpu_torch.obs import bundle, journal, slo, timeseries
from minisched_tpu_torch.ops import _cuda_build
from minisched_tpu_torch.ops import index as PIPE_INDEX
from minisched_tpu_torch.ops import pipeline as PIPE
from minisched_tpu_torch.ops import prng, spreadcap
from minisched_tpu_torch.ops import residency as RES
from minisched_tpu_torch.ops._cuda_build import LAUNCHES
from minisched_tpu_torch.ops.auction import auction_assign_plain
from minisched_tpu_torch.ops.auction_kernel import (auction_cuda,
                                                    bid_auction_cuda,
                                                    bid_auction_layout)
from minisched_tpu_torch.ops.bid_select import auction_assign_shortlist_plain
from minisched_tpu_torch.ops.caps_kernel import caps_scan_cuda
from minisched_tpu_torch.ops.greedy_kernel import greedy_assign_cuda
from minisched_tpu_torch.ops.pipeline import (_evaluate, _gather_nodes,
                                              _select_node_sample,
                                              build_step, cycle_state,
                                              evaluate)
from minisched_tpu_torch.ops.ports_kernel import insert_ports_cuda
from minisched_tpu_torch.ops.preempt import build_preempt_op, fetch_preempt
from minisched_tpu_torch.ops.select import (
    NEG, greedy_assign_plain, greedy_assign_shortlist_lanes_plain,
    greedy_assign_shortlist_plain, lane_seeds, shortlist_select,
    shortlist_select_lanes_plain, shortlist_select_plain)
from minisched_tpu_torch.ops.select_kernel import (
    shortlist_select_cuda, shortlist_select_lanes_cuda)
from minisched_tpu_torch.ops.shortlist_kernel import (
    shortlist_scan_cuda, shortlist_scan_lanes_cuda)
from minisched_tpu_torch.ops.spreadcap import build_domain_caps
from minisched_tpu_torch.parallel import build_sharded_step, make_mesh
from minisched_tpu_torch.parallel.dcn_dryrun import run_dcn_dryrun
from minisched_tpu_torch.parallel.sharded_assign import _chunk_size
from minisched_tpu_torch.scenario import demo, remote
from minisched_tpu_torch.scenario.runner import (Cluster, default_scenario,
                                                 run_scenario, wait_until)
from minisched_tpu_torch.service.config import SchedulerConfiguration
from minisched_tpu_torch.service.defaultconfig import (Profile,
                                                       full_scheduler_profile)
from minisched_tpu_torch.service.service import SchedulerService
from minisched_tpu_torch.state.persistence import open_or_restore
from minisched_tpu_torch.state.store import ClusterStore
from minisched_tpu_torch.state import objects as O

# The tests' numpy case builders (tests/torch_parity.py imports numpy only).
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "tests"))
from torch_parity import (AUCTION_CASES, AUCTION_SELECT_CASES,  # noqa: E402
                          CAPS_KINDS, OLD_AUCTION_CAP,
                          SELECT_CARD_LIST_KINDS, auction_adversarial,
                          auction_fold_case, auction_past_cap,
                          auction_past_cap_cluster, auction_select_case,
                          auction_strength_case, auction_tie_case,
                          caps_problem, full_cluster, sampled_cluster,
                          select_list_case)

N_NODES, N_PODS, BATCH, K = 50_000, 10_000, 1024, 128
# The depth of the full-profile and config-4-soft bursts (phases 12-13):
# cut from N_PODS to five batches to keep the script's time near its
# earlier length beside the explain phases (PERF.md §4).
CUT_PODS = 5 * BATCH
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


def full_width_batch(nodes, pods, bound=(), selector_spread=False,
                     n_pods=BATCH):
    """The first ``n_pods``-pod batch of a workload against every node,
    encoded by the port's own cache and encoder (host numpy). The pods
    are encoded first, as the engine does: their constraints register
    the topology keys the node snapshot's domains reflect."""
    cache = NodeFeatureCache()
    if selector_spread:
        cache.enable_owner_pairs()
    cache.upsert_nodes_bulk(nodes)
    for pod, node_name in bound:
        pod.spec.node_name = node_name
        cache.account_bind(pod)
    eb = encode_pods(pods[:n_pods], step_bucket(n_pods), cfg=cache.cfg,
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
          with_pv_controller=True, inspect=None, pods_first=False):
    """Boot a cluster with ``cfg``, load the nodes, zero the launch
    counts, create the pods and wait until every pod is bound and every
    batch folded into the metrics (``pods_first``: the pods are in the
    store before the engine starts, so its informers list them all
    before the first pop and the batches are the same on every run). With residency on, the carried device
    free/used_ports must then equal their host mirrors bitwise (the
    kernels' outputs at the path's own shapes against the host replay).
    ``probe(scheduler)`` runs once the nodes are synced;
    ``with_pv_controller=False`` boots without the PV controller, as
    bench.py runs its engine cells (bench.py:1457); ``inspect(cluster)``
    runs after the checks, before the cluster shuts down. Returns
    (metrics, launches, burst create-to-bound, per-pod create-to-bound,
    placements)."""
    cluster = Cluster()
    try:
        cluster.create_objects(nodes)
        if pods_first:
            cluster.create_objects(pods)
            for name in LAUNCHES:
                LAUNCHES[name] = 0
        cluster.start(profile, cfg, with_pv_controller=with_pv_controller)
        n_nodes = sum(isinstance(o, O.Node) for o in nodes)
        check(wait_until(lambda: cluster.service.scheduler.cache.node_count()
                         == n_nodes, timeout=120),
              f"{label}: informers did not sync the nodes")
        if probe is not None:
            probe(cluster.service.scheduler)
        if not pods_first:
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
        if inspect is not None:
            inspect(cluster)
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
    return {"ms": ms, "us_per_pod": ms * 1e3 / P, "plain_ms": plain_ms,
            "bound_s": bound_s, "bound_by": bound_by, "err": err}


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
        if sample is None:
            # E1. the full profile's explain step (256 x 53,248)
            explain_step_pair("full profile", plugin_set, (eb, nf, af), key,
                              smi, has_gang=False, hard_spread=False)


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


def auction_pair(scores, req, free, seed, label, prio=None, k=None,
                 max_rounds=None):
    """One auction kernel (the dense one for ``k`` None, else the bid
    shortlist at width k) against its plain version on the card, bitwise
    on every output and in the rounds run. Returns (kernel result, the
    plain version's stats: rounds, bids, full-row bids; plain ms, max abs
    error)."""
    r_k = torch.zeros((1,), dtype=torch.int32, device=scores.device)
    st_p = torch.zeros((3,), dtype=torch.int32, device=scores.device)
    if k is None:
        got = auction_cuda(scores, req, free, seed, max_rounds=max_rounds,
                           priority=prio, rounds=r_k)
        fn, kw = auction_assign_plain, {}
        fields = ("chosen", "assigned", "free_after")
    else:
        got = bid_auction_cuda(scores, req, free, seed,
                               max_rounds=max_rounds, priority=prio, k=k,
                               rounds=r_k)
        fn, kw = auction_assign_shortlist_plain, {"k": k}
        fields = ("chosen", "assigned", "free_after", "repaired")
    torch.cuda.synchronize()
    t = time.perf_counter()
    plain = fn(scores, req, free, seed, max_rounds=max_rounds,
               priority=prio, stats=st_p, **kw)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t) * 1e3
    what = f"{'auction' if k is None else 'bid_auction'} {label}"
    err = compare(got, plain, fields)
    check(int(r_k[0]) == int(st_p[0]),
          f"{what}: {int(r_k[0])} rounds vs plain {int(st_p[0])}")
    return got, st_p.tolist(), plain_ms, err


def auction_bound_s(P, N, R, K_, stats):
    """Least time for one auction call on this input: its inputs read
    once (scores, requests, priorities, free) and its outputs written
    once (free, chosen, assigned, and repaired for the bid shortlist)
    over the memory rate, against the operations this data needs over
    the float32 rate: one per score folded, and per bid one per value
    reduced (the full row for the dense rounds; the K candidates, and
    the full row of a repaired bid, for the bid shortlist). ``K_`` is 0
    for the dense rounds; ``stats`` the plain version's (rounds, bids,
    full-row bids)."""
    _rounds, bids, full = stats
    moved = (4 * P * N + 4 * P * R + 4 * P + 8 * N * R + 5 * P
             + (P if K_ else 0))
    ops = P * N + (N * bids if not K_ else K_ * bids + N * full)
    return max(moved / HBM_BYTES_PER_S, ops / F32_OPS_PER_S), (
        "bytes" if moved / HBM_BYTES_PER_S >= ops / F32_OPS_PER_S
        else "operations")


def auction_timed(args, seed, label, smi, prio=None, k=None):
    """auction_pair plus the kernel's time back to back (CUDA events), its
    device time (the profiler's, and CUDA events around calls queued
    behind a spin kernel), its bound and, for the bid shortlist, the
    selection alone (a launch with a round budget of 0). Returns the
    kernel table's numbers and prints one line."""
    scores, req, free = args
    P, N = scores.shape
    R = req.shape[1]
    got, stats, plain_ms, err = auction_pair(scores, req, free, seed, label,
                                             prio=prio, k=k)
    name = "auction" if k is None else "bid_auction"
    if k is None:
        def call(max_rounds=None):
            auction_cuda(scores, req, free, seed, priority=prio,
                         max_rounds=max_rounds)
    else:
        def call(max_rounds=None):
            bid_auction_cuda(scores, req, free, seed, priority=prio, k=k,
                             max_rounds=max_rounds)
    ms = cuda_ms(call, reps=10)
    dev_ms = device_ms(call, reps=5)
    spin_ms = queued_ms(call, reps=5)
    select_ms = cuda_ms(lambda: call(max_rounds=0), reps=10) if k else None
    bound_s, bound_by = auction_bound_s(P, N, R, k or 0, stats)
    rounds, bids, full = stats
    print(f"{name} kernel vs plain {label} {P}x{N}x{R}"
          f"{'' if k is None else f' K={k}'}: bitwise equal, "
          f"{int(got.assigned.sum())} assigned, {rounds} rounds, {bids} "
          f"bids, {full} over full rows; kernel {ms:.4f} ms back to back, "
          f"{fmt_ms(dev_ms, 4)} of device time, {fmt_ms(spin_ms, 4)} on "
          f"the spin clock"
          + ("" if k is None else
             f" (the selection alone {select_ms:.4f} ms)")
          + f", plain {plain_ms:.1f} ms, bound {bound_s * 1e3:.4f} ms "
          f"({bound_by}) ({smi})")
    return {"ms": ms, "device_ms": dev_ms, "spin_ms": spin_ms,
            "plain_ms": plain_ms,
            "bound_s": bound_s, "bound_by": bound_by, "err": err,
            "rounds": rounds, "bids": bids, "full_rows": full,
            "select_ms": select_ms, "got": got}


def auction_kernels_phase(smi, eb, nf, af, key):
    """Both auction kernels against their plain versions on the card,
    bitwise on every output and in the rounds run: the CPU tests' instances
    (tests/torch_parity.py AUCTION_CASES at each case's widths, the fold
    and strength cases that one rounding and two decide differently, two
    bidders of equal strength, round budgets that run out), then the
    bench batch at full width (1,024 x 53,248 x 10, one band and three
    bands, dense and K=128), the sampled shape the bench burst runs
    (1,024 x 4,096), and a full-width contention batch where the bid
    shortlist at K in {1, 128, N} equals the dense rounds and repairs.
    Returns the kernel table's numbers for both kernels."""
    err = {"auction": 0.0, "bid_auction": 0.0}

    def note(k, e):
        name = "auction" if k is None else "bid_auction"
        err[name] = max(err[name], e)

    def cuda(a):
        return torch.from_numpy(np.ascontiguousarray(a)).cuda()

    seed = prng.bits(prng.fold_in(key, 21))
    for name, (make, prio, widths) in AUCTION_CASES.items():
        args = [cuda(a) for a in make()]
        pr = None if prio is None else cuda(np.asarray(prio, np.int32))
        for k in (None,) + widths:
            got, stats, _ms, e = auction_pair(*args, seed, name, prio=pr, k=k)
            note(k, e)
        print(f"auction kernels vs plain {name} "
              f"{tuple(args[0].shape)}x{args[1].shape[1]} K in "
              f"(dense,) + {widths}: bitwise equal, {stats[0]} rounds, "
              f"{int(got.assigned.sum())} assigned")
    # The bid shortlist's selection on each of its paths (ties past the
    # list walked, plateaus, zeros at kth, K = N, uncached rows).
    for name in AUCTION_SELECT_CASES:
        *arrays, k = auction_select_case(name)
        args = [cuda(a) for a in arrays]
        got, stats, _ms, e = auction_pair(*args, seed, name, k=k)
        note(k, e)
        print(f"bid_auction kernel vs plain, selection case {name} "
              f"{tuple(args[0].shape)}x{args[1].shape[1]} K={k}: bitwise "
              f"equal, {stats[0]} rounds, {stats[2]} full-row bids, "
              f"{int(got.assigned.sum())} assigned")
    nseed = prng.bits(prng.PRNGKey(5))

    def noise(i, cols):
        from minisched_tpu_torch.ops.select import tie_noise_from_cols

        return tie_noise_from_cols(
            nseed, torch.as_tensor(np.asarray(i, np.int64)),
            torch.as_tensor(np.asarray(cols, np.int64))).numpy()

    fold = auction_fold_case(noise)[0]
    strength = auction_strength_case(noise)[0]
    P_s = strength.shape[0]
    special = {
        "fold rounded once": (fold, np.ones((1, 1), np.float32),
                              np.ones((2, 1), np.float32)),
        "strength rounded once": (strength, np.ones((P_s, 1), np.float32),
                                  np.array([[1.0], [0.0]], np.float32)),
        "equal strengths": auction_tie_case(noise),
    }
    for name, arrays in special.items():
        args = [cuda(a) for a in arrays]
        for k in (None, 1, 2):
            note(k, auction_pair(*args, nseed, name, k=k)[3])
    budget = [cuda(a) for a in auction_adversarial(1)]
    for k in (None, 2):
        for rounds in (1, 2, 4):
            got, _st, _ms, e = auction_pair(*budget, nseed, "budget",
                                            k=k, max_rounds=rounds)
            note(k, e)
            check(not bool(got.assigned.all()),
                  f"a round budget of {rounds} placed every pod")
    print("auction kernels vs plain: the fold and the strength rounded "
          "once, equal strengths to the higher row, round budgets of 1, 2 "
          "and 4 that leave feasible pods unassigned: bitwise equal")
    # Past the shared-memory wall of the kernels' earlier layout (every
    # block's pods in its shared memory: about 9,550 a block): 1,300,000
    # pods against 2 nodes, the feasible ones the last 48.
    P_w = 1_300_000
    *arrays, prio_w = auction_past_cap(P=P_w, N=2, n_feasible=48, seed=44)
    args = [cuda(a) for a in arrays]
    pr = cuda(prio_w)
    for k in (None, 1, 2):
        got, stats, _ms, e = auction_pair(*args, seed, "past the wall",
                                          prio=pr, k=k)
        note(k, e)
        placed = got.assigned.nonzero().flatten()
        check(placed.numel() > 0 and int(placed.min()) >= P_w - 48,
              f"past the wall: placed rows {placed.tolist()}")
    print(f"auction kernels vs plain past the shared-memory wall "
          f"{P_w}x2x2 (dense, K=1, K=2; feasible rows the last 48): "
          f"bitwise equal, {stats[0]} rounds, {placed.numel()} assigned, "
          f"the bid shortlist's pods in device memory: "
          f"{not bid_auction_layout(P_w, 2)['shared_pods']}")
    del args, pr, got

    plugin_set = BENCH_PROFILE.build()
    eb_d, nf_d, af_d = (to_torch(x, "cuda") for x in (eb, nf, af))
    scores = evaluate(plugin_set, eb_d, nf_d, af_d)[0]
    full = (scores, eb_d.pf.requests, nf_d.free)
    P = scores.shape[0]
    three = (torch.arange(P, device=scores.device) % 3).to(torch.int32)
    out = {}
    for label, prio in (("full width", None), ("full width, 3 bands", three)):
        for k in (None, K):
            out[(label, k)] = auction_timed(full, seed, label, smi,
                                            prio=prio, k=k)
    _skey_step, skey = prng.split(key)
    idx = _select_node_sample(nf_d, skey, SAMPLE_K)
    nf_s = _gather_nodes(nf_d, idx)
    s_scores = evaluate(plugin_set, eb_d, nf_s, af_d)[0]
    sampled = (s_scores, eb_d.pf.requests, nf_s.free)
    for k in (None, K):
        out[("sampled", k)] = auction_timed(sampled, seed, "sampled", smi,
                                            k=k)
    del s_scores, sampled, nf_s, idx
    cont = shortlist_case(BATCH, scores.shape[1], full[1].shape[1], 3,
                          contend=True)
    out[("contention", None)] = auction_timed(cont, seed, "contention", smi)
    dense = out[("contention", None)].pop("got")
    dstats = [out[("contention", None)][f]
              for f in ("rounds", "bids", "full_rows")]
    note(None, out[("contention", None)]["err"])
    for k in (1, K, scores.shape[1]):
        got, stats, _ms, e = auction_pair(*cont, seed, "contention", k=k)
        note(k, e)
        compare(got, dense)
        check(k != 1 or stats[2] > 0,
              "the contention batch made no repairs at K=1")
        print(f"bid_auction kernel = dense auction kernel, contention "
              f"{tuple(cont[0].shape)}x{cont[1].shape[1]} K={k}: chosen, "
              f"assigned, free_after bitwise equal, {stats[0]} rounds "
              f"(dense {dstats[0]}), {stats[2]} full-row bids, "
              f"{int(got.assigned.sum())} assigned ({smi})")
    del cont, dense, got, full, scores, eb_d, nf_d, af_d
    for v in out.values():
        v.pop("got", None)
    for name in err:
        out[name + "_err"] = err[name]
    return out


def auction_step_phase(smi, eb, nf, af, key):
    """build_step(assignment="auction") on the card against the CPU, every
    Decision field bitwise, on the bench batch sampled (1,024 x 4,096)
    and unsampled (1,024 x 53,248), with the bid shortlist and without;
    no host sync in the gang-free sampled step."""
    plugin_set = BENCH_PROFILE.build()
    eb_d, nf_d, af_d = (to_torch(x, "cuda") for x in (eb, nf, af))
    eb_c, nf_c, af_c = (to_torch(x, "cpu") for x in (eb, nf, af))
    for sample in (SAMPLE_K, None):
        for kk in (K, None):
            step = build_step(plugin_set, shortlist=kk, sample_nodes=sample,
                              assignment="auction")
            d_gpu = step(eb_d, nf_d, af_d, key)
            t = time.perf_counter()
            d_cpu = step(eb_c, nf_c, af_c, key)
            cpu_s = time.perf_counter() - t
            for field in d_cpu._fields:
                check(torch.equal(bits(getattr(d_gpu, field)),
                                  bits(getattr(d_cpu, field))),
                      f"auction step sample={sample} shortlist={kk} field "
                      f"{field}: cuda != cpu")
            ms = cuda_ms(lambda: step(eb_d, nf_d, af_d, key), reps=3)
            shape = f"sampled K={sample}" if sample else "unsampled"
            print(f"auction step {shape} shortlist={kk}: every Decision field bitwise equal cuda "
                  f"vs cpu, {int(d_cpu.assigned.sum())} assigned; cuda "
                  f"{ms:.3f} ms per step back to back, cpu {cpu_s:.2f} s "
                  f"({smi})")
    # 16,385 pods (an 18,432-row step) past the kernels' old cap of
    # 16,384, only the last 65 feasible, against 64 nodes.
    nodes_c, pods_c = auction_past_cap_cluster(O)
    cache = NodeFeatureCache()
    cache.upsert_nodes_bulk(nodes_c)
    nf_c, _names, _sv, _incs = cache.snapshot_versioned(pad=64)
    eb_cap = encode_pods(pods_c, step_bucket(len(pods_c)), cfg=cache.cfg,
                         registry=cache.registry)
    af_cap = cache.snapshot_assigned(pad=16)
    rows = eb_cap.pf.requests.shape[0]
    for kk in (16, None):
        step = build_step(plugin_set, shortlist=kk, assignment="auction")
        d_gpu = step(*(to_torch(x, "cuda") for x in (eb_cap, nf_c, af_cap)),
                     key)
        d_cpu = step(*(to_torch(x, "cpu") for x in (eb_cap, nf_c, af_cap)),
                     key)
        for field in d_cpu._fields:
            check(torch.equal(bits(getattr(d_gpu, field)),
                              bits(getattr(d_cpu, field))),
                  f"auction step past the old cap shortlist={kk} field "
                  f"{field}: cuda != cpu")
        placed = d_cpu.assigned.nonzero().flatten()
        check(placed.numel() > 0 and int(placed.min()) >= len(pods_c) - 65
              and bool(d_cpu.assigned[len(pods_c) - 1]),
              f"auction step past the old cap: placed {placed.tolist()}")
        print(f"auction step past the old cap ({len(pods_c)} pods > "
              f"{OLD_AUCTION_CAP}, a {rows}-row step x 64 nodes) "
              f"shortlist={kk}: every Decision field bitwise equal cuda vs "
              f"cpu, {placed.numel()} assigned, pod {len(pods_c) - 1} "
              f"among them")
    step = build_step(plugin_set, shortlist=K, sample_nodes=SAMPLE_K,
                      assignment="auction")
    check_no_sync(lambda: step(eb_d, nf_d, af_d, key, has_gang=False,
                               hard_spread=False),
                  "the auction step, sampled")
    print("auction step, sampled: no host sync (gang-free, no DoNotSchedule "
          "slot)")


def c5_pods(pods, gang: int = 8):
    """BASELINE config 5's pods (bench.py:378-395): gangs of 8 at quorum
    8."""
    for i, p in enumerate(pods):
        p.spec.pod_group = f"gang-{i // gang}"
        p.spec.pod_group_min = gang
    return pods


def auction_burst_phase(smi):
    """The bench burst and BASELINE config 5's gang burst through Cluster
    with SchedulerConfig(assignment="auction"). Returns (launches by
    path, create-to-bound by path)."""
    launches, c2bs = {}, {}
    nodes, pods = bench_workload(N_NODES, N_PODS)
    m, launches["bench"], c2bs["bench"], per_pod, _ = drive(
        SchedulerConfig(platform="", assignment="auction"), nodes, pods,
        "auction bench")
    b = m["batches"]
    check(launches["bench"]["bid_auction"] >= b > 0
          and m["sampled_batches"] == b,
          f"auction bench: bid_auction launched "
          f"{launches['bench']['bid_auction']} times in {b} batches, "
          f"{m['sampled_batches']} sampled")
    print(path_line(f"auction bench (assignment=auction, bid shortlist "
                    f"K={K}, node sample) {N_NODES} nodes x {N_PODS} pods",
                    m, launches["bench"], c2bs["bench"], per_pod, N_PODS,
                    smi)
          + f"; {m['sampled_batches']} of {b} batches sampled; device "
            "free/used_ports = host mirror bitwise")
    nodes, pods = bench_workload(N_NODES, N_PODS)
    m, launches["config 5"], c2bs["config 5"], per_pod, placed = drive(
        SchedulerConfig(platform="", assignment="auction"), nodes,
        c5_pods(pods), "config 5")
    b = m["batches"]
    check(launches["config 5"]["bid_auction"] >= b > 0
          and m["sampled_batches"] == 0 and m["pods_failed"] == 0,
          f"config 5: bid_auction launched "
          f"{launches['config 5']['bid_auction']} times in {b} batches, "
          f"{m['sampled_batches']} sampled, {m['pods_failed']} failed")
    members: dict = {}
    for name in placed:
        members[int(name.split("-")[1]) // 8] = (
            members.get(int(name.split("-")[1]) // 8, 0) + 1)
    check(len(members) == N_PODS // 8 and set(members.values()) == {8},
          "config 5: a gang was not placed whole")
    print(path_line(f"config 5 (assignment=auction, gangs of 8 at quorum 8,"
                    f" every batch unsampled: the bid shortlist at "
                    f"{BATCH}x{step_bucket(N_NODES)}) {N_NODES} nodes x "
                    f"{N_PODS} pods", m, launches["config 5"],
                    c2bs["config 5"], per_pod, N_PODS, smi)
          + f"; {len(members)} gangs whole, gang_rejected 0 (no pod "
            "failed)")
    return launches, c2bs


def auction_fault_phase():
    """The auction on the card under auction_mirror:corrupt@2 with the
    carry cross-check armed (resident_check_every=1) and the shortlist
    cross-check against the dense rounds (shortlist_check_every=1): the
    phantom debit is caught as a desync, re-uploaded, and the placements
    equal the fault-free run's. Returns the launches of the fault-free
    run (the dense kernel in each cross-check)."""
    cfg = dict(platform="", assignment="auction", pipeline=False,
               max_batch_size=64, batch_window_s=0.3,
               backoff_initial_s=0.05, backoff_max_s=0.3,
               probation_batches=1, resident_check_every=1,
               shortlist_check_every=1)
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    ref, ref_m = fault_burst("", SchedulerConfig(**cfg), "auction checks")
    launches = dict(LAUNCHES)
    check(ref_m["batch_faults"] == 0 and ref_m["shortlist_desyncs"] == 0
          and ref_m["residency_desyncs"] == 0
          and ref_m["shortlist_checks"] >= ref_m["batches"] - 1
          and launches["auction"] > 0 and launches["bid_auction"] > 0,
          f"auction checks: {ref_m['shortlist_checks']} shortlist checks, "
          f"launches {launches}")
    placed, m = fault_burst("auction_mirror:corrupt@2",
                            SchedulerConfig(**cfg), "auction_mirror")
    check(m["fault_fires_auction_mirror"] == 1
          and m["residency_desyncs"] >= 1
          and m["degradation_state"] == "resident" and placed == ref,
          f"auction_mirror: fires {m['fault_fires_auction_mirror']}, "
          f"desyncs {m['residency_desyncs']}, ends at "
          f"{m['degradation_state']}, placements equal {placed == ref}")
    print(f"auction faults on the card: fault-free with both cross-checks "
          f"({ref_m['shortlist_checks']} against the dense kernel, "
          f"launched {launches['auction']} times; bid_auction "
          f"{launches['bid_auction']}), then auction_mirror:corrupt@2 fired "
          f"once, {m['residency_desyncs']} carry desync caught and "
          f"re-uploaded, ends at resident; {len(placed)} placements = the "
          f"fault-free run's")
    return launches


def zone_counts(nodes, placed):
    """Bound pods per zone label value, from drive()'s placements."""
    zone_of = {n.metadata.name: n.metadata.labels["zone"] for n in nodes}
    counts: dict = {}
    for node_name in placed.values():
        counts[zone_of[node_name]] = counts.get(zone_of[node_name], 0) + 1
    return counts


# The shortlist widths the overload tuner retunes K to around the default
# 128 (engine/overload.py shortlist_target: within [min(16, K), 4 K]).
TUNER_WIDTHS = (16, 256, 512)
GAPS = ("gather", "encode", "fetch", "commit")
LIFECYCLE = ("pod_queue_wait_s", "pod_decide_s", "pod_bind_s",
             "pod_create_to_bound_s")
ENGINE_SPANS = ("queue.pop", "encode.pods", "step.dispatch",
                "fetch.decision", "bind.bulk")
# Pinned rungs: no window moves the level; a sentinel that never burns
# (a burning window would reset the tune depth to the level's); brownout
# sampling at 20% (at the default 50% the 1,201-node cluster's sample
# would reach half the node pad and the engine would score every node);
# a shed backoff past the time the admitted pods take to leave the queue,
# so that each shed pod is re-offered once, to an idle queue.
PIN_SLO = "create_bound_p99=1000,queue_wait_p95=1000"
PIN_OVERLOAD = ("hold=1000000,probation=1000000,min_batch=16,"
                "brownout_pct=20,shed_backoff=5,shed_backoff_max=5")


def disarm_obs() -> None:
    """Every telemetry, actuation and fault singleton of the port off
    (the controller first: its disarm releases the sentinel it armed)."""
    overload.configure("")
    slo.configure("")
    timeseries.configure(False)
    obs.configure(False)
    journal.configure("")
    bundle.configure("")
    faults.configure("")


def tuner_widths_phase(smi, scores, args, seed):
    """A. The selection, scan and bid-auction kernels against their plain
    versions at the widths the overload tuner sets (K in TUNER_WIDTHS)
    on the main path's sampled shape, bitwise: cand, kth, kth_noise (and
    the candidates' scores); chosen, assigned, free_after, repaired.
    Each kernel's time beside its bound. Returns ({kernel: {"K": numbers}},
    {kernel: max abs error})."""
    P, N = scores.shape
    req, free = args[1], args[2]
    R = req.shape[1]
    out = {"shortlist_select": {}, "shortlist_scan": {}, "bid_auction": {}}
    err = dict.fromkeys(out, 0.0)
    for kk in TUNER_WIDTHS:
        err["shortlist_select"] = max(err["shortlist_select"],
                                      select_pair(scores, seed, kk))
        sel = shortlist_select_cuda(scores, seed, kk)
        sel_ms = cuda_ms(lambda: shortlist_select_cuda(scores, seed, kk),
                         reps=20)
        sel_b, sel_by = select_bound_s(P, N, kk)
        got, plain, _sel, _ms = scan_pair(scores, req, free, seed, kk)
        err["shortlist_scan"] = max(err["shortlist_scan"], compare(
            got, plain, ("chosen", "assigned", "free_after", "repaired")))
        repairs = int(plain.repaired.sum())
        scan_ms = cuda_ms(lambda: shortlist_scan_cuda(
            scores, sel[0], sel[1], sel[2], req, free, seed,
            cand_scores=sel[3]), reps=20)
        scan_b, scan_by = scan_bound_s(P, N, kk, R, repairs)
        au = auction_timed((scores, req, free), seed, "tuner width", smi,
                           k=kk)
        err["bid_auction"] = max(err["bid_auction"], au["err"])
        w = str(kk)
        out["shortlist_select"][w] = {"ms": sel_ms, "bound_ms": sel_b * 1e3,
                                      "bound_by": sel_by}
        out["shortlist_scan"][w] = {"ms": scan_ms, "bound_ms": scan_b * 1e3,
                                    "bound_by": scan_by, "repaired": repairs}
        out["bid_auction"][w] = {"ms": au["ms"],
                                 "bound_ms": au["bound_s"] * 1e3,
                                 "bound_by": au["bound_by"],
                                 "rounds": au["rounds"]}
        print(f"tuner width K={kk} at {P}x{N}x{R}: selection, scan and bid "
              f"auction kernels bitwise equal to their plain versions; "
              f"selection {sel_ms:.4f} ms (bound {sel_b * 1e3:.4f} ms "
              f"{sel_by}), scan {scan_ms:.4f} ms, {repairs} repaired "
              f"(bound {scan_b * 1e3:.4f} ms {scan_by}), bid auction "
              f"{au['ms']:.4f} ms, {au['rounds']} rounds (bound "
              f"{au['bound_s'] * 1e3:.4f} ms {au['bound_by']}) ({smi})")
        del sel, got, plain, _sel, au
    return out, err


def device_breakdown(path: str):
    """C. One batch's torch.profiler trace (Chrome JSON) → (the device
    operations by total time, the device's busy share of the batch
    window, the window in ms). The window runs from the batch's
    ``prepare`` span to the end of its ``commit``; busy is the union of
    kernel, copy and set intervals inside it."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    cpu = {}
    for e in events:
        if e.get("ph") == "X" and e.get("name") in ("prepare", "commit"):
            cpu.setdefault(e["name"], []).append(e)
    check(dev, "the one-batch trace holds no device operation")
    check("prepare" in cpu and "commit" in cpu,
          "the one-batch trace lacks the prepare or commit span")
    t0 = min(e["ts"] for e in cpu["prepare"])
    t1 = max(e["ts"] + e["dur"] for e in cpu["commit"])
    by_name: dict = {}
    spans = []
    for e in dev:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
        a, b = max(e["ts"], t0), min(e["ts"] + e["dur"], t1)
        if b > a:
            spans.append((a, b))
    busy, end = 0.0, t0
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    return top, busy / (t1 - t0), (t1 - t0) / 1e3


def armed_main_path_phase(smi, main_placed, trace_dir):
    """B and C. Phase 11's workload once more with the timeline, SLO
    sentinel, overload controller (default knobs), journal and trace
    recorder armed, and ``trace_next_batch`` armed once two batches are
    in. Returns the gap decomposition and the lifecycle quantiles."""
    from minisched_tpu_torch.obs import hist_quantile

    timeseries.configure(True)
    slo.configure("1")
    overload.configure("1")
    journal.configure("1")
    obs.configure(True)

    def probe(sched):
        def arm_trace():
            wait_until(lambda: sched.metrics()["batches"] >= 2,
                       timeout=120, interval=0.005)
            sched.trace_next_batch(trace_dir)

        threading.Thread(target=arm_trace, daemon=True).start()

    try:
        nodes, pods = bench_workload(N_NODES, N_PODS)
        m, _launches, c2b, _per_pod, placed = drive(
            SchedulerConfig(platform=""), nodes, pods, "armed main path",
            probe=probe)
        spans = os.path.join(trace_dir, "spans.json")
        spans_doc = json.load(open(obs.TRACE.export_chrome(spans)))
    finally:
        disarm_obs()
    check(placed == main_placed,
          "armed main path: placements differ from the unarmed run's")
    check(m["overload_level"] == 0 and m["shed_total"] == 0,
          f"armed main path: overload level {m['overload_level']}, "
          f"{m['shed_total']} shed")
    gaps = {g: m[f"gap_{g}_s_total"] for g in GAPS}
    check(abs(sum(gaps.values()) - m["gap_s_total"])
          <= 1e-9 * m["batches"],
          f"armed main path: gap components {gaps} do not sum to "
          f"gap_s_total {m['gap_s_total']}")
    hists = m["histograms"]
    for h in LIFECYCLE:
        check(hists[h]["count"] == m["pods_bound"],
              f"armed main path: {h} counts {hists[h]['count']} of "
              f"{m['pods_bound']} bound pods")
    check(m["timeline_snapshots"] >= 1,
          "armed main path: the timeline took no snapshot")
    names = {e["name"] for e in spans_doc["traceEvents"]}
    missing = [s for s in ENGINE_SPANS if s not in names]
    check(not missing, f"armed main path: the flight recorder lacks "
          f"{missing}")
    q = {h: (hist_quantile(hists[h], 0.5), hist_quantile(hists[h], 0.99))
         for h in LIFECYCLE}
    b = m["batches"]
    print(f"armed main path (timeline, SLO sentinel, overload controller, "
          f"journal and trace recorder on) {N_NODES} nodes x {N_PODS} pods: "
          f"placements = the unarmed run's bitwise, overload level 0, none "
          f"shed, {m['timeline_snapshots']} timeline snapshots, "
          f"{m['journal_events']} journal events; {b} batches, "
          f"create-to-bound {c2b:.3f} s; gap {m['gap_s_total']:.4f} s = "
          + " + ".join(f"{g} {v:.4f}" for g, v in gaps.items())
          + f"; encode {m['encode_s_total']:.3f} s, dispatch "
          f"{m['step_dispatch_s_total']:.3f} s, step {m['step_s_total']:.3f}"
          f" s, commit {m['commit_s_total']:.3f} s, bind "
          f"{m['bind_s_total']:.3f} s, overlap encode "
          f"{m['encode_overlap_s']:.4f} commit {m['commit_overlap_s']:.4f} "
          f"s; lifecycle p50/p99: "
          + ", ".join(f"{h} {a:.4f}/{z:.4f} s" for h, (a, z) in q.items())
          + f"; the flight recorder holds {', '.join(ENGINE_SPANS)} ({smi})")
    path = os.path.join(trace_dir, "trace.json")
    error = os.path.join(trace_dir, "error.txt")
    check(wait_until(lambda: os.path.exists(path) or os.path.exists(error),
                     timeout=60), "trace_next_batch wrote nothing")
    if not os.path.exists(path):
        check(False, f"trace_next_batch: {open(error).read().strip()}")
    top, busy, window_ms = device_breakdown(path)
    kernels = [n for n, _ in top]
    check(any("shortlist_select_kernel" in n for n in kernels)
          and any("shortlist_scan_kernel" in n for n in kernels),
          f"the one-batch trace lacks the shortlist kernels: {kernels[:12]}")
    print(f"one sampled batch's device trace (torch.profiler): window "
          f"{window_ms:.3f} ms, device busy {busy * 100:.2f}% of it; device "
          f"operations by time: "
          + "; ".join(f"{n[:60]} {us / 1e3:.4f} ms" for n, us in top[:10])
          + f" ({smi})")
    return {"gaps": gaps, "quantiles": q, "busy": busy,
            "window_ms": window_ms, "top": top[:10]}


def pinned_burst(platform: str, level: int, label: str, *, tune_steps=2,
                 sl_exp=0, split_priority=False, explain=False):
    """D. Phase 19's 1,201-node sampled cluster, every object in the store
    before the engine starts, with the overload controller pinned at
    ``level`` (tune depth ``tune_steps``, shortlist exponent ``sl_exp``
    applied to the step as the tuner does) before its informers list
    the pods; ``split_priority`` puts every other pod at priority 1,000
    and the rest at 0 (below shed_priority 500); ``explain`` runs the
    engine in explain mode, and the metrics then also count the pods
    that carry an annotation (``annotated_pods``). Returns (placements,
    metrics, the node sample K the engine picks for a 16-pod batch)."""
    first, pods = sampled_cluster(O)
    if split_priority:
        for i, p in enumerate(pods):
            p.spec.priority = 1000 if i % 2 else 0
    slo.configure(PIN_SLO)
    # Rungs 2 and 3 shed below shed_priority: 500 only where the pods'
    # priorities are split (0 would shed none of them).
    overload.configure(PIN_OVERLOAD + (",shed_priority=500"
                                       if split_priority else ""))
    picked = []
    orig = engine_scheduler.Scheduler.start

    def pinned_start(sched):
        ov = sched._overload
        ov.level, ov.tune_steps, ov.sl_exp = level, tune_steps, sl_exp
        ov._since_change = ov._sl_since = 0
        want = ov.shortlist_target(sched._sl_base)
        if want != sched._shortlist_k:
            sched._set_shortlist_k(want)
        orig(sched)

    cluster = Cluster()
    try:
        cluster.create_objects(first)
        cluster.create_objects(pods)
        engine_scheduler.Scheduler.start = pinned_start
        try:
            cluster.start(BENCH_PROFILE, SchedulerConfig(
                platform=platform, max_batch_size=64, batch_window_s=0.3,
                explain=explain), with_pv_controller=False)
        finally:
            engine_scheduler.Scheduler.start = orig
        sched = cluster.service.scheduler
        check(wait_until(lambda: sched.metrics()["pods_bound"] >= len(pods)
                         and sched.metrics()["pods_assigned"] >= len(pods),
                         timeout=120, interval=0.02),
              f"{label}: {sched.metrics()['pods_bound']} of {len(pods)} "
              f"pods bound")
        picked.append(sched._sampled_step(
            sched._node_pad(sched.cache.node_count()), 16, False)[1])
        placed = {p.key: p.spec.node_name for p in cluster.list_pods()}
        check(all(placed.values()), f"{label}: a pod left unbound")
        m = sched.metrics()
        if explain:
            check(cluster.service.result_store.drain(timeout=60),
                  f"{label}: the result store did not drain")
            m["annotated_pods"] = sum(
                FILTER_RESULT_KEY in p.metadata.annotations
                for p in cluster.list_pods())
        return placed, m, picked[0]
    finally:
        cluster.shutdown()
        disarm_obs()


def brownout_bundle(bundle_dir: str):
    """D. The ladder walked into brownout on the card through real
    snapshot windows (an objective every window with a bind breaches,
    hold 1) on the 1,201-node cluster, with incident bundles armed: the
    brownout bundle, which tools/postmortem.py must accept."""
    first, _pods = sampled_cluster(O)
    journal.configure("1")
    obs.configure(True)
    timeseries.configure(True, every="1")
    slo.configure("create_bound_p99=0.000001,short=30,long=60")
    overload.configure("hold=1,probation=3")
    bundle.configure(bundle_dir)
    cluster = Cluster()
    try:
        cluster.create_objects(first)
        cluster.start(BENCH_PROFILE, SchedulerConfig(
            platform="", max_batch_size=16), with_pv_controller=False)
        sched = cluster.service.scheduler
        check(wait_until(lambda: sched.cache.node_count() == 1201,
                         timeout=60), "brownout: nodes not synced")
        made = 0
        deadline = time.monotonic() + 90
        while sched._overload.level < 3 and time.monotonic() < deadline:
            cluster.create_objects([O.Pod(
                metadata=O.ObjectMeta(name=f"wave{made + j}",
                                      namespace="bench"),
                spec=O.PodSpec(requests={"cpu": 10.0}))
                for j in range(8)])
            made += 8
            time.sleep(0.05)
        check(sched._overload.level == 3,
              f"brownout: the ladder reached level {sched._overload.level}")
        path = os.path.join(bundle_dir, "incident-brownout")
        check(wait_until(lambda: os.path.exists(
            os.path.join(path, "manifest.json")), timeout=30),
            "brownout: no incident bundle")
        m = sched.metrics()
    finally:
        cluster.shutdown()
        disarm_obs()
    tool = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "tools", "postmortem.py")
    r = subprocess.run([sys.executable, tool, path, "--quiet"],
                       capture_output=True, text=True, timeout=120)
    check(r.returncode == 0, f"postmortem rejects the brownout bundle "
          f"(rc {r.returncode}): {r.stdout[-400:]} {r.stderr[-400:]}")
    return path, m, made, r.stdout.strip().splitlines()[0]


def ladder_phase(smi, scratch):
    """D. The overload ladder on the card: rungs 1 and 3 pinned place as
    on the CPU; rung 2 loses no pod and sheds as many as the CPU run;
    the brownout bundle passes tools/postmortem.py."""
    for rung, level, sl_exp, want_k, want_sample in (
            ("rung 1 (tuned: batches of 16, K=512)", 1, 2, 512, 512),
            ("rung 3 (brownout: node sample at 20%)", 3, 0, K, 256)):
        got, m, k_gpu = pinned_burst("", level, rung, sl_exp=sl_exp)
        want, _cm, k_cpu = pinned_burst("cpu", level, rung, sl_exp=sl_exp)
        check(got == want, f"{rung}: placements on the card differ from "
              "the CPU's")
        check(m["overload_level"] == level and m["overload_max_batch"] == 16
              and m["overload_shortlist_k"] == want_k,
              f"{rung}: level {m['overload_level']}, batch "
              f"{m['overload_max_batch']}, K {m['overload_shortlist_k']}")
        check(k_gpu == k_cpu == want_sample
              and m["sampled_batches"] == m["batches"],
              f"{rung}: node sample {k_gpu}, {m['sampled_batches']} of "
              f"{m['batches']} batches sampled")
        check(m["kernel_launches_shortlist_select"] >= m["batches"]
              and m["kernel_launches_shortlist_scan"] >= m["batches"],
              f"{rung}: the shortlist kernels did not run in every batch")
        print(f"ladder {rung} pinned on 1,201 nodes: {len(got)} placements "
              f"on the card = the CPU's bitwise, {m['batches']} batches, "
              f"each on a node sample of {k_gpu}, shortlist K "
              f"{m['overload_shortlist_k']}, {m['shortlist_repairs']} "
              f"repairs ({smi})")
    label = "rung 2 (shedding below priority 500)"
    got, m, _k = pinned_burst("", 2, label, split_priority=True)
    _want, cm, _k = pinned_burst("cpu", 2, label, split_priority=True)
    n_low = (len(sampled_cluster(O)[1]) + 1) // 2  # the even indices
    check(m["pods_bound"] == len(got) - 1 and m["queue_shed"] == 0,
          f"{label}: {m['pods_bound']} bound, {m['queue_shed']} still shed")
    check(m["shed_total"] == cm["shed_total"] == n_low,
          f"{label}: shed {m['shed_total']} on the card, "
          f"{cm['shed_total']} on the CPU, {n_low} below the threshold")
    print(f"ladder {label} pinned on 1,201 nodes: every pod bound, "
          f"{m['shed_total']} shed and re-admitted (the CPU run: "
          f"{cm['shed_total']}) ({smi})")
    path, bm, made, verdict = brownout_bundle(os.path.join(scratch,
                                                           "bundles"))
    print(f"ladder walked to brownout on the card through real windows "
          f"({made} pods, {bm['overload_escalations']} escalations, "
          f"{bm['slo_alerts_total']} SLO alerts): bundle "
          f"{os.path.basename(path)} with "
          f"{sorted(os.listdir(path))}; tools/postmortem.py: {verdict}")


# ---- explain mode, the chunked step, the native clone (phases E1-E6) ------

# E2's depth: the bench burst's 10,000 pods, every batch unsampled.
EXPLAIN_PODS = N_PODS
# E4's batch: where the pod-chunked evaluation starts to matter (P x N x
# 4 bytes of scores past 1 GiB: C = 2,048 at 53,248 nodes).
CHUNK_PODS, CHUNK_C = 8192, 2048
# E3's engine-level cuda = cpu check: config 4 hard at 1,200 nodes (the
# repair runs up to 64 rounds a batch so that every batch places all of
# its pods in the cycle: a pod that fails comes back when its backoff
# expires, and the next batches then follow the wall clock).
PARITY_NODES, PARITY_PODS = 1200, 512
GB = float(1 << 30)


def explain_step_pair(label, plugin_set, batch, key, smi, **call_kw):
    """E1. ``plugin_set``'s explain step (shortlist K) on the card against
    the CPU on one batch, every Decision field bitwise (the three stacks
    and total_scores included); its time beside the step without explain
    (CUDA events) and its peak device memory. Returns the launches of
    its first call on the card."""
    dev = [to_torch(x, "cuda") for x in batch]
    step = build_step(plugin_set, shortlist=K, explain=True)
    base = build_step(plugin_set, shortlist=K)
    base(*dev, key, **call_kw)  # warm
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    before = dict(LAUNCHES)
    d_gpu = step(*dev, key, **call_kw)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    launched = {n: LAUNCHES[n] - before[n] for n in LAUNCHES}
    t = time.perf_counter()
    d_cpu = step(*(to_torch(x, "cpu") for x in batch), key, **call_kw)
    cpu_s = time.perf_counter() - t
    for field in d_cpu._fields:
        check(torch.equal(bits(getattr(d_gpu, field)),
                          bits(getattr(d_cpu, field))),
              f"{label} explain step: field {field} cuda != cpu")
    P, N = d_cpu.total_scores.shape
    F, S = len(plugin_set.filter_plugins), len(plugin_set.score_plugins)
    check(tuple(d_cpu.filter_masks.shape) == (F, P, N)
          and tuple(d_cpu.raw_scores.shape) == (S, P, N),
          f"{label} explain step: stacks of the wrong shape")
    stacks = sum(t.numel() * t.element_size() for t in (
        d_gpu.filter_masks, d_gpu.raw_scores, d_gpu.norm_scores,
        d_gpu.total_scores))
    del d_gpu, d_cpu
    ms = cuda_ms(lambda: step(*dev, key, **call_kw), reps=3)
    base_ms = cuda_ms(lambda: base(*dev, key, **call_kw), reps=3)
    print(f"explain step {label} {P}x{N} ({F} filters, {S} scorers): every "
          f"Decision field bitwise equal cuda vs cpu, the stacks and "
          f"total_scores {stacks / GB:.3f} GB; {ms:.3f} ms per step back to "
          f"back against {base_ms:.3f} ms without explain; peak device "
          f"memory {peak / GB:.3f} GB ({held / GB:.3f} GB held before); "
          f"launches {launched}; cpu {cpu_s:.1f} s ({smi})")
    return launched


def explain_c4_step_phase(smi, key):
    """E1. Config 4 hard's first 1,024-pod batch against 50,000 nodes in
    explain mode, cuda = cpu: the caps are never built (so the step
    makes no read of any_enforced: it runs under torch's sync debug mode
    "error" with hard_spread=None), the caps kernel is not launched and
    the selection and scan kernels are."""
    nodes, pods = c4_workload(N_NODES, BATCH, max_skew=1, hard=True)
    batch = full_width_batch(nodes, pods)
    plugin_set = C4_PROFILE.build()
    launched = explain_step_pair("config 4 hard", plugin_set, batch, key,
                                 smi, has_gang=False, hard_spread=None)
    dev = [to_torch(x, "cuda") for x in batch]
    step = build_step(plugin_set, shortlist=K, explain=True)
    built = []
    orig = spreadcap.build_domain_caps

    def counted(*a, **kw):
        built.append(1)
        return orig(*a, **kw)

    spreadcap.build_domain_caps = counted
    try:
        check_no_sync(lambda: step(*dev, key, has_gang=False,
                                   hard_spread=None),
                      "the config 4 hard explain step (hard_spread=None)")
    finally:
        spreadcap.build_domain_caps = orig
    check(not built, "config 4 hard explain step: the caps were built")
    check(launched["caps_scan"] == 0, "config 4 hard explain step: the caps "
          "kernel was launched")
    check(launched["shortlist_select"] >= 1
          and launched["shortlist_scan"] >= 1,
          "config 4 hard explain step: the shortlist kernels did not run")
    print(f"explain step config 4 hard: no caps built, caps kernel not "
          f"launched, no host sync with hard_spread=None ({smi})")


def explain_view(cluster, rng, n_pods, outside=3):
    """The explain surface of a finished burst: every pod's three
    annotation strings, and for ``n_pods`` pods picked by ``rng``
    (all when None), filter_verdict on ``outside`` nodes not in the
    pod's annotation (the first by name when ``rng`` is None, else
    drawn) and on its chosen node, beside the annotation's own verdict
    for the chosen node where it lists it."""
    from minisched_tpu_torch.explain import (FINAL_SCORE_RESULT_KEY,
                                             SCORE_RESULT_KEY)

    rs = cluster.service.result_store
    check(rs.drain(timeout=120), "the result store did not drain")
    keys = (FILTER_RESULT_KEY, SCORE_RESULT_KEY, FINAL_SCORE_RESULT_KEY)
    nodes = sorted(n.metadata.name for n in cluster.list_nodes())
    ann, verdicts, listed_sizes = {}, {}, []
    pods = sorted(cluster.list_pods(), key=lambda p: p.key)
    for pod in pods:
        a = pod.metadata.annotations
        ann[pod.key] = tuple(a.get(k) for k in keys)
        check(None not in ann[pod.key], f"{pod.key} lacks an annotation")
        listed_sizes.append(len(json.loads(a[FILTER_RESULT_KEY])))
    picked = (pods if n_pods is None else
              [pods[i] for i in rng.choice(len(pods), n_pods, replace=False)])
    for pod in picked:
        listed = json.loads(pod.metadata.annotations[FILTER_RESULT_KEY])
        others = [n for n in nodes if n not in listed]
        if rng is None:
            others = others[:outside]
        else:
            others = [others[i] for i in rng.choice(len(others), outside,
                                                    replace=False)]
        chosen = pod.spec.node_name
        v = {n: rs.filter_verdict(pod.key, n) for n in others + [chosen]}
        check(all(x is not None for x in v.values()),
              f"{pod.key}: filter_verdict has no answer")
        check(set(v[chosen].values()) == {"passed"},
              f"{pod.key}: its chosen node failed a filter: {v[chosen]}")
        if chosen in listed:
            check(listed[chosen] == v[chosen],
                  f"{pod.key}: annotation and filter_verdict disagree")
        verdicts[pod.key] = v
    return ann, verdicts, listed_sizes, rs.stats()


def explain_burst_phase(smi, main_m):
    """E2. bench-50k (50,000 nodes x EXPLAIN_PODS pods, bench profile)
    with SchedulerConfig(explain=True): pipelined, device-resident,
    shortlist K=128, every batch unsampled (1,024 x 53,248). Every
    batch launches the selection and scan kernels; all bound, none
    over-committed (drive); every pod carries the three annotations,
    each of at most 128 nodes; for 16 pods picked by seed,
    filter_verdict answers for 3 nodes outside the annotation and says
    every filter passed on the chosen node, as the annotation does where
    it lists that node. Prints create-to-bound, the gap decomposition
    beside phase 11's, the result store's counters, the worker's ingest
    seconds per batch and the peak device memory."""
    nodes, pods = bench_workload(N_NODES, EXPLAIN_PODS)
    ingest_s, flush_s = [], []
    orig, orig_flush = ResultStore._ingest, ResultStore.flush_pod

    def timed(self, *a):
        t = time.perf_counter()
        try:
            return orig(self, *a)
        finally:
            ingest_s.append(time.perf_counter() - t)

    def timed_flush(self, *a):
        t = time.perf_counter()
        try:
            return orig_flush(self, *a)
        finally:
            flush_s.append(time.perf_counter() - t)

    view = {}

    def inspect(cluster):
        view["peak"] = torch.cuda.max_memory_allocated()
        view["out"] = explain_view(cluster, np.random.default_rng(13), 16)

    ResultStore._ingest, ResultStore.flush_pod = timed, timed_flush
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    try:
        m, launches, c2b, per_pod, _ = drive(
            SchedulerConfig(platform="", explain=True), nodes, pods,
            "explain burst", inspect=inspect)
    finally:
        ResultStore._ingest, ResultStore.flush_pod = orig, orig_flush
        print(f"explain burst: the worker's ingest per batch (s) "
              f"{[round(x, 3) for x in ingest_s]}, flush "
              f"{sum(flush_s):.3f} s for {len(flush_s)} pods")
    b = m["batches"]
    check(m["sampled_batches"] == 0, f"explain burst: "
          f"{m['sampled_batches']} of {b} batches sampled")
    for name in ("shortlist_select", "shortlist_scan"):
        check(launches[name] >= b > 0,
              f"explain burst: {name} launched {launches[name]} times in "
              f"{b} batches")
    ann, _verdicts, sizes, stats = view["out"]
    check(len(ann) == EXPLAIN_PODS and max(sizes) <= K,
          f"explain burst: {len(ann)} annotated pods, up to {max(sizes)} "
          "nodes each")
    print(path_line(f"explain burst (SchedulerConfig(explain=True): every "
                    f"batch unsampled, {BATCH}x{step_bucket(N_NODES)}) "
                    f"{N_NODES} nodes x {EXPLAIN_PODS} pods", m, launches,
                    c2b, per_pod, EXPLAIN_PODS, smi))
    print(f"explain burst: every pod with 3 annotations of {min(sizes)}.."
          f"{max(sizes)} nodes; filter_verdict for 16 pods x 3 nodes outside "
          f"the annotation answered, the chosen node passed every filter; "
          f"gap {m['gap_s_total']:.4f} s = " + " + ".join(
              f"{g} {m[f'gap_{g}_s_total']:.4f}" for g in GAPS)
          + f" (phase 11: gap {main_m['gap_s_total']:.4f} s, fetch "
          f"{main_m['gap_fetch_s_total']:.4f}); result store {stats}; ingest "
          f"{len(ingest_s)} batches, {np.median(ingest_s):.3f} s median, "
          f"{max(ingest_s):.3f} s max, {sum(ingest_s):.3f} s in all per "
          f"batch on the worker; peak device memory {view['peak'] / GB:.3f} "
          f"GB ({smi})")
    return launches, c2b, ingest_s, view["peak"]


def explain_parity_phase(smi):
    """E3. Explain mode on the card against the CPU at the engine level:
    config 4 hard (DoNotSchedule max_skew 1; explain keeps the caps off,
    the host arbitration and its repair do the work) at PARITY_NODES x
    PARITY_PODS, then the bench profile under the auction. Placements,
    each pod's three annotation strings byte for byte, and
    filter_verdict on the first three nodes outside each pod's
    annotation are equal; in config 4 hard no zone is over its skew."""
    for label, (nodes, pods), profile, kw in (
            ("config 4 hard", c4_workload(PARITY_NODES, PARITY_PODS,
                                          max_skew=1, hard=True),
             C4_PROFILE, dict(spread_repair_iters=64)),
            ("auction", bench_workload(PARITY_NODES, PARITY_PODS),
             BENCH_PROFILE, dict(assignment="auction"))):
        out = {}
        for platform in ("", "cpu"):
            n, p = ((nodes, pods) if platform == "" else
                    (c4_workload(PARITY_NODES, PARITY_PODS, max_skew=1,
                                 hard=True) if profile is C4_PROFILE
                     else bench_workload(PARITY_NODES, PARITY_PODS)))
            view = {}
            m, _l, c2b, _pp, placed = drive(
                SchedulerConfig(platform=platform, explain=True, **kw), n, p,
                f"explain {label} on {platform or 'cuda'}", profile,
                with_pv_controller=False,
                inspect=lambda c: view.update(out=explain_view(c, None,
                                                                None)))
            out[platform] = (placed, *view["out"][:2], m, c2b)
        (g_placed, g_ann, g_ver, gm, g_c2b) = out[""]
        (c_placed, c_ann, c_ver, _cm, c_c2b) = out["cpu"]
        check(g_placed == c_placed, f"explain {label}: placements cuda != cpu")
        check(g_ann == c_ann, f"explain {label}: annotations cuda != cpu")
        check(g_ver == c_ver, f"explain {label}: filter_verdict cuda != cpu")
        extra = ""
        if profile is C4_PROFILE:
            zc = zone_counts(nodes, g_placed)
            check(max(zc.values()) - min(zc.values()) <= 1,
                  f"explain {label}: per-zone counts {sorted(zc.values())}")
            check(gm["hard_spread_batches"] == gm["batches"]
                  and gm["kernel_launches_caps_scan"] == 0,
                  f"explain {label}: the caps kernel ran")
            extra = (f", {gm['spread_revoked']} revoked by the host "
                     f"arbitration, {gm['spread_repaired']} repaired, "
                     f"app=bench per zone {min(zc.values())}.."
                     f"{max(zc.values())}, no caps launch")
        print(f"explain {label} {PARITY_NODES} nodes x {PARITY_PODS} pods: "
              f"placements, {len(g_ann)} pods' annotation strings and "
              f"{sum(len(v) for v in g_ver.values())} filter_verdict answers "
              f"equal on the card and on the CPU{extra}; create-to-bound "
              f"{g_c2b:.3f} s on the card, {c_c2b:.3f} s on the CPU ({smi})")


def chunked_step_phase(smi, key):
    """E4. The pod-chunked step at CHUNK_PODS x 53,248: the bench profile
    and config 4 hard (its caps kernel, feasible_static per chunk) at
    the default knobs, which chunk at C = 2,048, against the same step
    with _CHUNK_WHEN_BYTES past the size (no chunks): every Decision
    field bitwise, the peak device memory both ways. Then the selection
    and scan kernels against their plain versions at that shape, with
    their times and bounds."""
    C = PIPE._chunk_pods(CHUNK_PODS, step_bucket(N_NODES))
    check(C == CHUNK_C, f"the chunk rule picks C={C} at {CHUNK_PODS} pods")
    out = {}
    for label, (nodes, pods), profile, hard in (
            ("bench", bench_workload(N_NODES, CHUNK_PODS), BENCH_PROFILE,
             False),
            ("config 4 hard", c4_workload(N_NODES, CHUNK_PODS, max_skew=1,
                                          hard=True), C4_PROFILE, True)):
        batch = full_width_batch(nodes, pods, n_pods=CHUNK_PODS)
        dev = [to_torch(x, "cuda") for x in batch]
        step = build_step(profile.build(), shortlist=K)
        ds, peaks, ms = {}, {}, {}
        when = PIPE._CHUNK_WHEN_BYTES
        for chunked in (True, False):
            PIPE._CHUNK_WHEN_BYTES = when if chunked else 1 << 62
            try:
                torch.cuda.synchronize()
                held = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                ds[chunked] = step(*dev, key, has_gang=False,
                                   hard_spread=hard)
                torch.cuda.synchronize()
                peaks[chunked] = torch.cuda.max_memory_allocated() - held
                ms[chunked] = cuda_ms(lambda: step(
                    *dev, key, has_gang=False, hard_spread=hard), reps=2)
            finally:
                PIPE._CHUNK_WHEN_BYTES = when
        for field in ds[True]._fields:
            check(torch.equal(bits(getattr(ds[True], field)),
                              bits(getattr(ds[False], field))),
                  f"chunked step {label}: field {field} differs from the "
                  "unchunked step")
        d = ds[True]
        if hard:
            check(bool(d.scan_groups.any()),
                  f"chunked step {label}: no group enforced")
        print(f"chunked step {label} {CHUNK_PODS}x{step_bucket(N_NODES)} "
              f"(C={C}, {CHUNK_PODS // C} chunks): every Decision field "
              f"bitwise equal to the unchunked step, feasible_static "
              f"included, {int(d.assigned.sum())} assigned"
              + (f", {int(d.scan_groups.sum())} groups enforced by the caps "
                 f"kernel" if hard else "")
              + f"; peak device memory above the inputs {peaks[True] / GB:.3f}"
              f" GB chunked, {peaks[False] / GB:.3f} GB unchunked; "
              f"{ms[True]:.3f} ms vs {ms[False]:.3f} ms per step ({smi})")
        out[label] = (peaks, ms)
        del ds, d
        if not hard:
            eb_d, nf_d, af_d = dev
            scores, _fc, _rc = evaluate(profile.build(), eb_d, nf_d, af_d)
            P, N = scores.shape
            R = eb_d.pf.requests.shape[1]
            seed = prng.bits(prng.fold_in(prng.PRNGKey(0), 1))
            sel_err = select_pair(scores, seed, K)
            got, plain, sel, scan_plain_ms = scan_pair(
                scores, eb_d.pf.requests, nf_d.free, seed, K)
            scan_err = compare(got, plain, ("chosen", "assigned",
                                            "free_after", "repaired"))
            repairs = int(plain.repaired.sum())
            sel4 = shortlist_select_cuda(scores, seed, K)
            select_ms = cuda_ms(lambda: shortlist_select_cuda(scores, seed, K),
                                reps=10)
            select_plain_ms = cuda_ms(
                lambda: shortlist_select_plain(scores, seed, K), reps=2)
            scan_ms = cuda_ms(lambda: shortlist_scan_cuda(
                scores, sel4[0], sel4[1], sel4[2], eb_d.pf.requests,
                nf_d.free, seed, cand_scores=sel4[3]), reps=5)
            sb, sby = select_bound_s(P, N, K)
            cb, cby = scan_bound_s(P, N, K, R, repairs)
            out["kernels"] = dict(
                select_err=sel_err, scan_err=scan_err, select_ms=select_ms,
                select_plain_ms=select_plain_ms, select_bound_s=sb,
                select_bound_by=sby, scan_ms=scan_ms,
                scan_plain_ms=scan_plain_ms, scan_bound_s=cb,
                scan_bound_by=cby)
            print(f"selection and scan kernels vs plain at {P}x{N}x{R} K={K}: "
                  f"bitwise equal, {int(plain.assigned.sum())} assigned, "
                  f"{repairs} repaired; selection {select_ms:.4f} ms (plain "
                  f"{select_plain_ms:.3f} ms, bound {sb * 1e3:.4f} ms {sby}); "
                  f"scan {scan_ms:.4f} ms ({scan_ms * 1e3 / P:.3f} us per pod;"
                  f" plain {scan_plain_ms:.1f} ms, bound {cb * 1e3:.4f} ms "
                  f"{cby}) ({smi})")
            del scores, got, plain, sel, sel4
        del dev, batch
    return out


def explain_brownout_phase(smi):
    """E5. Phase D's pinned rung 3 (brownout) with explain on, on the card
    and on the CPU: the same placements, overload_explain_skipped equal
    (every batch), and no pod with an annotation."""
    label = "rung 3 (brownout) with explain"
    got, m, _k = pinned_burst("", 3, label, explain=True)
    want, cm, _k = pinned_burst("cpu", 3, label, explain=True)
    check(got == want, f"{label}: placements on the card differ from the "
          "CPU's")
    check(m["overload_explain_skipped"] == cm["overload_explain_skipped"]
          == m["batches"] > 0,
          f"{label}: explain skipped {m['overload_explain_skipped']} on the "
          f"card, {cm['overload_explain_skipped']} on the CPU, in "
          f"{m['batches']} batches")
    check(m["annotated_pods"] == cm["annotated_pods"] == 0,
          f"{label}: {m['annotated_pods']} annotated pods")
    print(f"ladder {label} pinned on 1,201 nodes: {len(got)} placements on "
          f"the card = the CPU's, explain ingestion skipped in all "
          f"{m['overload_explain_skipped']} batches on both, no pod "
          f"annotated, {m['sampled_batches']} batches sampled ({smi})")


def demo_phase() -> None:
    """E6. The port's demo scenario on the card (scenario/demo.py)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        demo.main(platform="")
    lines = buf.getvalue().strip().splitlines()
    for line in lines:
        print(f"demo: {line}")
    check(lines and lines[-1] == "demo OK", "the demo did not print demo OK")


# F-G. The device loop and the maintained index (their parity bursts:
# SMALL_NODES x SMALL_PODS in batches of SMALL_BATCH, every batch
# unsampled, as tests/test_torch_device_loop.py and test_torch_index.py
# run them at a smaller size).
LOOP_DEPTH = 8
# F1 and G1's depth: four batches (the first per batch, then a tranche of
# three; a cold index build, then three served batches), cut from
# CUT_PODS to keep the script near 400 s (PERF.md §4); the 64-class run
# needs two batches to show that every batch falls back.
LOOP_PODS, FALLBACK_PODS = 4 * BATCH, 2 * BATCH
SMALL_NODES, SMALL_PODS, SMALL_BATCH = 1_200, 512, 64
UNSAMPLED = {"percentage_of_nodes_to_score": 100}
# The bench pods are named pod-{i}-{i % 10} with 7 CPU sizes: a class is
# a pod's whole feature row, the name suffix included, so 70 classes,
# past the default registry of 64.
INDEX_CLASSES = 128
# The counters that do not depend on timing. index_races does (a cache
# mutation landing between a batch's drain and its dispatch), and a race
# moves the index counters with it: they are compared only between runs
# that saw none.
LOOP_COUNTERS = ("batches", "steps_dispatched", "decision_fetches",
                 "loop_tranches", "loop_iterations", "loop_breaks")
INDEX_COUNTERS = ("batches", "steps_dispatched", "decision_fetches",
                  "index_hits", "index_rebuilds", "index_appends",
                  "index_fallbacks", "index_repair_rows")


def watched_loop(record):
    """A stand-in for the engine's build_loop_step whose tranches run
    under torch's sync debug mode "error" (the host never waits on the
    card from the first slot's launches to the stacked buffer's return)
    and record (slots, stacked bytes); a sync raises, which the engine's
    containment turns into a counted loop break."""
    def build(*args, **kw):
        loop = PIPE.build_loop_step(*args, **kw)

        def run(slot_ebs, nf, af, seeds):
            torch.cuda.set_sync_debug_mode("error")
            try:
                packed, free = loop(slot_ebs, nf, af, seeds)
            except RuntimeError as e:
                record["sync"].append(str(e))
                raise
            finally:
                torch.cuda.set_sync_debug_mode("default")
            record["tranches"].append(
                (len(slot_ebs), packed.numel() * packed.element_size()))
            return packed, free
        return run
    return build


def cache_quiet(cache, span=0.15) -> None:
    """Wait until the cache's version holds still for ``span`` seconds:
    the informer has confirmed every bind."""
    last = cache.version
    while True:
        time.sleep(span)
        if cache.version == last:
            return
        last = cache.version


def stored_burst(cfg, nodes, pods, label, spec="", burst=None):
    """The nodes and the pods in the store before the engine starts (the
    batches are then the same on every run and device), ``spec`` armed on
    the fault gates; waits until every pod is bound. ``burst``: only the
    first ``burst`` pods are stored first, and each further ``burst``
    once the previous ones are bound and the cache is quiet, so that no
    bind confirmation lands while an index batch prepares (an index race
    depends on the informer's timing). Returns (placements, metrics)."""
    step = burst or len(pods)
    chunks = [pods[i:i + step] for i in range(0, len(pods), step)]
    cluster = Cluster()
    try:
        cluster.create_objects(nodes)
        cluster.create_objects(chunks[0])
        if spec:
            faults.configure(spec, 0)
        cluster.start(BENCH_PROFILE, cfg, with_pv_controller=False)
        sched = cluster.service.scheduler
        want = 0
        for i, chunk in enumerate(chunks):
            if i:
                cache_quiet(sched.cache)
                cluster.create_objects(chunk)
            want += len(chunk)
            check(wait_until(lambda: sched.metrics()["pods_bound"] >= want
                             and sched.metrics()["pods_assigned"] >= want,
                             timeout=120, interval=0.02),
                  f"{label}: {sched.metrics()['pods_bound']} of {want} "
                  f"pods bound")
        placed = {p.key: p.spec.node_name for p in cluster.list_pods()}
        check(sched.metrics()["pods_bound"] == len(pods),
              f"{label}: a pod bound twice or lost")
        return placed, sched.metrics()
    finally:
        faults.configure("")
        cluster.shutdown()


def same_counters(a, b, keys, label) -> None:
    for k in keys:
        check(a[k] == b[k], f"{label}: {k} {a[k]} on the card, {b[k]} on "
              f"the CPU")


def loop_phase(smi):
    """F1. The bench profile at 50,000 nodes x LOOP_PODS, unsampled, with
    the device loop (depth LOOP_DEPTH) against the same burst without it:
    placements bitwise equal, fewer dispatches than batches, one fetch a
    dispatch, no break, the selection and scan kernels once a slot, no
    host sync in a tranche, the carried free equal to its mirror (drive).
    F2. SMALL_NODES x SMALL_PODS in batches of SMALL_BATCH, greedy and
    auction: placements and LOOP_COUNTERS on the card = on the CPU; then
    fetch:corrupt@2 on the card: one break, every pod bound once, the
    fault-free placements. Returns (launches of the loop burst, its
    create-to-bound, the loop-off burst's placements and create-to-bound,
    the loop-off metrics)."""
    nodes, pods = bench_workload(N_NODES, LOOP_PODS)
    m0, l0, c2b0, pp0, placed0 = drive(
        SchedulerConfig(platform="", **UNSAMPLED), nodes, pods,
        "F1 loop off", with_pv_controller=False, pods_first=True)
    rec = {"sync": [], "tranches": []}
    nodes, pods = bench_workload(N_NODES, LOOP_PODS)
    engine_scheduler.build_loop_step = watched_loop(rec)
    try:
        m1, l1, c2b1, pp1, placed1 = drive(
            SchedulerConfig(platform="", device_loop=True,
                            loop_depth=LOOP_DEPTH, **UNSAMPLED),
            nodes, pods, "F1 loop on", with_pv_controller=False,
            pods_first=True)
    finally:
        engine_scheduler.build_loop_step = PIPE.build_loop_step
    b = m1["batches"]
    check(not rec["sync"], f"F1: a tranche waited on the card: "
          f"{rec['sync'][:1]}")
    check(m1["loop_tranches"] >= 1 and m1["steps_dispatched"] < b
          and m1["decision_fetches"] == m1["steps_dispatched"]
          and m1["loop_breaks"] == 0 and m1["batch_faults"] == 0,
          f"F1: tranches {m1['loop_tranches']}, dispatches "
          f"{m1['steps_dispatched']}, fetches {m1['decision_fetches']}, "
          f"breaks {m1['loop_breaks']} in {b} batches")
    check(len(rec["tranches"]) == m1["loop_tranches"],
          f"F1: {len(rec['tranches'])} tranches ran, engine counts "
          f"{m1['loop_tranches']}")
    for name in ("shortlist_select", "shortlist_scan"):
        check(l1[name] == b, f"F1: {name} launched {l1[name]} times in "
              f"{b} batches")
    check(placed1 == placed0, "F1: placements with the loop != without")
    print(f"F1 device loop {N_NODES} nodes x {LOOP_PODS} pods unsampled, "
          f"depth {LOOP_DEPTH}: placements bitwise equal to the loop-off "
          f"burst; {b} batches in {m1['steps_dispatched']} dispatches "
          f"({m1['loop_tranches']} tranches of {m1['loop_iterations']} "
          f"slots, tranche sizes and stacked fetch bytes "
          f"{rec['tranches']}), {m1['decision_fetches']} fetches, 0 "
          f"breaks, no host sync in a tranche, the selection and scan "
          f"kernels {l1['shortlist_select']} and {l1['shortlist_scan']} "
          f"times, device free = host mirror; create-to-bound "
          f"{c2b1:.3f} s (p50 {np.percentile(pp1, 50):.3f} p99 "
          f"{np.percentile(pp1, 99):.3f}) against {c2b0:.3f} s (p50 "
          f"{np.percentile(pp0, 50):.3f} p99 {np.percentile(pp0, 99):.3f}) "
          f"without; fetch {m1['fetch_bytes_total']:.0f} against "
          f"{m0['fetch_bytes_total']:.0f} B, step {m1['step_s_total']:.3f} "
          f"against {m0['step_s_total']:.3f} s, prepare "
          f"{m1['prepare_s_total']:.3f} against {m0['prepare_s_total']:.3f}"
          f" s ({smi})")

    for assignment in ("greedy", "auction"):
        out = {}
        for platform in ("", "cpu"):
            cfg = SchedulerConfig(platform=platform, device_loop=True,
                                  loop_depth=LOOP_DEPTH,
                                  max_batch_size=SMALL_BATCH,
                                  assignment=assignment, **UNSAMPLED)
            out[platform] = stored_burst(
                cfg, *bench_workload(SMALL_NODES, SMALL_PODS),
                f"F2 {assignment} on {platform or 'cuda'}")
        (g_placed, gm), (c_placed, cm) = out[""], out["cpu"]
        check(g_placed == c_placed,
              f"F2 {assignment}: placements cuda != cpu")
        same_counters(gm, cm, LOOP_COUNTERS, f"F2 {assignment}")
        check(gm["loop_tranches"] >= 1 and gm["loop_breaks"] == 0,
              f"F2 {assignment}: {gm['loop_tranches']} tranches, "
              f"{gm['loop_breaks']} breaks")
        line = (f"F2 device loop {assignment} {SMALL_NODES} nodes x "
                f"{SMALL_PODS} pods in batches of {SMALL_BATCH}: "
                f"placements and " + ", ".join(
                    f"{k} {gm[k]}" for k in LOOP_COUNTERS)
                + " equal on the card and on the CPU")
        if assignment == "greedy":
            f_placed, fm = stored_burst(
                SchedulerConfig(platform="", device_loop=True,
                                loop_depth=LOOP_DEPTH,
                                max_batch_size=SMALL_BATCH, **UNSAMPLED),
                *bench_workload(SMALL_NODES, SMALL_PODS),
                "F2 fetch:corrupt@2", spec="fetch:corrupt@2")
            check(fm["loop_breaks"] == 1 and fm["fault_fires_fetch"] == 1
                  and fm["batch_faults"] >= 1,
                  f"F2 fetch:corrupt@2: breaks {fm['loop_breaks']}, fires "
                  f"{fm['fault_fires_fetch']}, faults {fm['batch_faults']}")
            check(f_placed == g_placed,
                  "F2 fetch:corrupt@2: placements != the fault-free run's")
            line += (f"; under fetch:corrupt@2 on the card 1 break, "
                     f"{fm['batch_faults']} batch fault, every pod bound "
                     f"once on its fault-free node")
        print(line + f" ({smi})")
    return l1, c2b1, placed0, c2b0, m0


def index_phase(smi, off_placed, off_c2b, off_m):
    """G1. F1's workload with the maintained index (INDEX_CLASSES
    classes): all bound (drive), index hits, placements equal to F1's
    index-off burst, the first indexed batch's gathered class-row view
    through the selection and scan kernels equal to their plain
    versions, the index state's bytes and the peak device memory; then
    at the default 64 classes every batch a counted fallback. G2. F2's
    cluster with index_check_every=1: placements and INDEX_COUNTERS on
    the card = on the CPU, no desync; then index:corrupt@2: one desync,
    the index disabled, an index_revert bundle, the fault-free
    placements. Returns (launches, create-to-bound, the view's kernel
    times and errors)."""
    cap = {}

    def capturing(plugin_set, k_eff):
        build_, refresh_, append_, assign_ = PIPE_INDEX.build_index_ops(
            plugin_set, k_eff)

        def assign_c(state, cls, valid, requests, free0, key):
            if "args" not in cap:
                cap["args"] = (state.score, cls.clone(), valid.clone(),
                               requests.clone(), free0.clone(), key)
            return assign_(state, cls, valid, requests, free0, key)
        return build_, refresh_, append_, assign_c

    st = {}
    nodes, pods = bench_workload(N_NODES, LOOP_PODS)
    torch.cuda.reset_peak_memory_stats()
    engine_scheduler.build_index_ops = capturing
    try:
        m, launches, c2b, pp, placed = drive(
            SchedulerConfig(platform="", index=True,
                            index_classes=INDEX_CLASSES, **UNSAMPLED),
            nodes, pods, "G1 index", with_pv_controller=False,
            pods_first=True,
            inspect=lambda c: st.update(state=c.service.scheduler._index
                                        .state))
    finally:
        engine_scheduler.build_index_ops = PIPE_INDEX.build_index_ops
    peak = torch.cuda.max_memory_allocated()
    b = m["batches"]
    check(m["index_hits"] >= 1 and m["index_desyncs"] == 0,
          f"G1: {m['index_hits']} hits, {m['index_desyncs']} desyncs")
    check(placed == off_placed, "G1: placements with the index != without")
    state = st["state"]
    state_bytes = sum(t.numel() * t.element_size() for t in state)
    score, cls, valid, req, free0, key = cap["args"]
    view = torch.where(valid[:, None], score[cls.long()], NEG)
    view_shape = tuple(view.shape)
    seed = prng.bits(key)
    view_err = {"shortlist_select": select_pair(view, seed, K)}
    got, plain, sel, _ms = scan_pair(view, req, free0, seed, K)
    view_err["shortlist_scan"] = compare(
        got, plain, ("chosen", "assigned", "free_after", "repaired"))
    view_ms = {
        "shortlist_select": cuda_ms(
            lambda: shortlist_select_cuda(view, seed, K), reps=10),
        "shortlist_scan": cuda_ms(lambda: shortlist_scan_cuda(
            view, sel[0], sel[1], sel[2], req, free0, seed), reps=10)}
    del got, plain, sel, view, cap["args"], st["state"], state
    print(f"G1 maintained index {N_NODES} nodes x {LOOP_PODS} pods "
          f"unsampled, {INDEX_CLASSES} classes ({m['index_classes_registered']}"
          f" registered): placements bitwise equal to the index-off burst; "
          f"{b} batches, {m['index_hits']} served, {m['index_rebuilds']} "
          f"rebuilds, {m['index_appends']} appended class rows, "
          f"{m['index_repair_rows']} columns repaired in place, "
          f"{m['index_fallbacks']} fallbacks, {m['index_races']} races, "
          f"{m['index_uncertified']} in-scan repairs; scored rows "
          f"{m['scored_rows_total']} against {off_m['scored_rows_total']} "
          f"without (series {m['batch_series']['scored_rows']}); the first "
          f"indexed batch's gathered {view_shape} class-row view"
          f" through the selection and scan kernels bitwise equal to their "
          f"plain versions (selection {view_ms['shortlist_select']:.4f} ms, "
          f"scan {view_ms['shortlist_scan']:.4f} ms); kernels "
          f"{ {k: launches[k] for k in ('shortlist_select', 'shortlist_scan')} }; "
          f"index state {state_bytes / GB:.3f} GB, peak device memory "
          f"{peak / GB:.3f} GB; create-to-bound {c2b:.3f} s (p50 "
          f"{np.percentile(pp, 50):.3f} p99 {np.percentile(pp, 99):.3f}) "
          f"against {off_c2b:.3f} s without; step {m['step_s_total']:.3f} "
          f"against {off_m['step_s_total']:.3f} s ({smi})")
    del score, cls, valid, req, free0

    p64, m64 = stored_burst(
        SchedulerConfig(platform="", index=True, **UNSAMPLED),
        *bench_workload(N_NODES, FALLBACK_PODS), "G1 index, 64 classes",
        burst=BATCH)
    check(m64["index_fallbacks"] == m64["batches"]
          and m64["index_hits"] == 0 and m64["index_rebuilds"] == 0,
          f"G1 64 classes: {m64['index_fallbacks']} fallbacks, "
          f"{m64['index_hits']} hits in {m64['batches']} batches")
    check(all(p64[k] == off_placed[k] for k in p64),
          "G1 64 classes: placements != index-off")
    print(f"G1 at index_classes=64: every batch a counted fallback "
          f"({m64['index_fallbacks']} of {m64['batches']}, "
          f"{m64['index_classes_registered']} classes registered), "
          f"placements equal to the index-off burst ({smi})")

    cfg_kw = dict(index=True, index_classes=INDEX_CLASSES,
                  index_check_every=1, max_batch_size=SMALL_BATCH,
                  **UNSAMPLED)
    for attempt in range(5):
        out = {platform: stored_burst(
            SchedulerConfig(platform=platform, **cfg_kw),
            *bench_workload(SMALL_NODES, SMALL_PODS),
            f"G2 index on {platform or 'cuda'}", burst=SMALL_BATCH)
            for platform in ("", "cpu")}
        (g_placed, gm), (c_placed, cm) = out[""], out["cpu"]
        check(g_placed == c_placed, "G2: placements cuda != cpu")
        check(gm["index_desyncs"] == 0 and cm["index_desyncs"] == 0
              and gm["index_hits"] >= 1, f"G2: desyncs "
              f"{gm['index_desyncs']}/{cm['index_desyncs']}, hits "
              f"{gm['index_hits']}")
        if gm["index_races"] == 0 and cm["index_races"] == 0:
            break
        print(f"G2 attempt {attempt + 1}: index races "
              f"{gm['index_races']} on the card, {cm['index_races']} on the "
              f"CPU; counters compared only between race-free runs")
    check(gm["index_races"] == 0 and cm["index_races"] == 0,
          "G2: no race-free pair of runs in 5 attempts")
    same_counters(gm, cm, INDEX_COUNTERS, "G2")
    with tempfile.TemporaryDirectory() as bdir:
        bundle.configure(bdir)
        try:
            f_placed, fm = stored_burst(
                SchedulerConfig(platform="", **cfg_kw),
                *bench_workload(SMALL_NODES, SMALL_PODS),
                "G2 index:corrupt@2", spec="index:corrupt@2",
                burst=SMALL_BATCH)
            bundles = sorted(os.listdir(bdir))
        finally:
            bundle.configure("")
    check(fm["index_desyncs"] == 1 and fm["index_width"] == 0
          and fm["fault_fires_index"] == 1,
          f"G2 index:corrupt@2: desyncs {fm['index_desyncs']}, width "
          f"{fm['index_width']}, fires {fm['fault_fires_index']}")
    check(any(n.startswith("incident-index_revert") for n in bundles),
          f"G2 index:corrupt@2: no index_revert bundle in {bundles}")
    check(f_placed == g_placed,
          "G2 index:corrupt@2: placements != the fault-free run's")
    print(f"G2 maintained index {SMALL_NODES} nodes x {SMALL_PODS} pods in "
          f"batches of {SMALL_BATCH}, index_check_every=1: placements and "
          + ", ".join(f"{k} {gm[k]}" for k in INDEX_COUNTERS)
          + f" equal on the card and on the CPU, {gm['index_checks']} "
          f"checks, no desync; under index:corrupt@2 on the card 1 desync, "
          f"the index disabled, bundle {bundles}, every pod on its "
          f"fault-free node ({smi})")
    return launches, c2b, view_ms, view_err


# H. Fused multi-tenant arbitration. TENANTS tenants, each the bench-50k
# cluster (bench_workload seed 0: their static node images are equal, so
# their lanes fuse) with its own TENANT_PODS bench pods (seed 1 + t). The
# coordinator's max_batch_size is the round's slots across the tenants:
# TENANTS x BATCH, so each lane is one 1,024 x 53,248 batch.
TENANTS, TENANT_PODS = 8, 2 * BATCH
TENANT_SMALL = (256, 256, 200, 40)  # H3's ragged demands
# The coordinator's counters and the tenant engines' that follow the
# inputs alone on single-stepped rounds over quiet caches.
TENANT_COUNTERS = ("tenant_rounds", "tenant_dispatches", "tenant_fetches",
                   "tenant_groups", "tenant_lanes_fused", "tenant_races",
                   "tenant_solo_fallbacks", "tenant_index_dispatches",
                   "tenant_index_lanes", "tenant_groups_round_max",
                   "steps_dispatched_total", "decision_fetches_total")
TENANT_ENGINE_COUNTERS = ("batches", "pods_bound", "tenant_fused_lanes",
                          "steps_dispatched", "decision_fetches",
                          "index_hits", "index_fused_hits",
                          "index_lane_ejects", "index_rebuilds",
                          "index_fallbacks", "index_races",
                          "index_repair_rows", "index_appends",
                          "index_checks", "index_desyncs", "batch_faults")


def tenant_stores(nodes, tenant_pods):
    """One ClusterStore a tenant holding ``nodes`` and its own pods."""
    from minisched_tpu_torch.state.store import ClusterStore

    stores = []
    for pods in tenant_pods:
        store = ClusterStore()
        store.create_many(nodes)
        store.create_many(pods)
        stores.append(store)
    return stores


def reset_tenant_pods(stores, tenant_pods) -> None:
    """Each store's pods deleted and created again unbound, in their
    first order: the stores serve another run with their nodes kept (a
    store of 50,000 nodes takes seconds to build)."""
    for store, pods in zip(stores, tenant_pods):
        for q in pods:
            store.delete("Pod", q.key)
        store.create_many(pods)


def tenant_run(cfg, nodes, tenant_pods, fuse, label, spec="",
               capture=None, stores=None):
    """A TenantFusionCoordinator (``fuse`` lanes; 0: sequential) over one
    store a tenant (``stores``, else built here), each holding ``nodes``
    and its own pods before the informers start; rounds single-stepped
    with serve_round until every queue drains, and before each round
    every bind in the store and every cache quiet (no mutation lands
    between a lane's submit and the dispatch: the batches and the
    counters follow the inputs). The launch counts are zeroed just
    before the first round and read after the last; each fused group's
    own launches are read around its dispatch. ``capture`` records the
    first lane-form assignment's arguments, moved to the host after the
    round (outside its time) so that no later round's peak memory holds
    them. Checks every pod bound once, no node over its allocatable.
    Returns (placements per tenant, metrics, each round's host seconds,
    launches, each fused group's launches)."""
    from minisched_tpu_torch.ops import select as SEL
    from minisched_tpu_torch.service.service import (
        Tenant, TenantFusionCoordinator)

    names = [f"t{i}" for i in range(len(tenant_pods))]
    if stores is None:
        stores = tenant_stores(nodes, tenant_pods)
    tenants = [Tenant(name=nm, store=store, profile=BENCH_PROFILE)
               for nm, store in zip(names, stores)]
    lanes = SEL.greedy_assign_shortlist_lanes

    def capturing(scores, requests, free0, seeds, k=128):
        if "args" not in capture:
            capture["args"] = (scores, requests, free0, list(seeds), k)
        return lanes(scores, requests, free0, seeds, k=k)

    coord = TenantFusionCoordinator(tenants, cfg, fuse=fuse)
    engines = [coord.engine(nm) for nm in names]
    group_launches: list = []
    if coord.mux is not None:
        for attr in ("_dispatch_group", "_dispatch_index_group"):
            def counted(group, _fn=getattr(coord.mux, attr)):
                before = dict(LAUNCHES)
                _fn(group)
                group_launches.append(
                    {k: LAUNCHES[k] - before[k] for k in LAUNCHES})
            setattr(coord.mux, attr, counted)
    if capture is not None:
        SEL.greedy_assign_shortlist_lanes = capturing
        PIPE._TENANT_CACHE.clear()
        PIPE._TENANT_INDEX_CACHE.clear()
    try:
        if spec:
            faults.configure(spec, 0)
        for eng in engines:
            eng._shared.ensure_started()
        check(wait_until(lambda: all(
            eng.queue.pending_count() == len(pods)
            for eng, pods in zip(engines, tenant_pods)), timeout=120),
            f"{label}: the tenants' pods are not all queued")
        cache_quiet_all(engines)
        for name in LAUNCHES:
            LAUNCHES[name] = 0
        rounds = []
        while any(eng.queue.pending_count() for eng in engines):
            t = time.perf_counter()
            coord.serve_round()
            rounds.append(time.perf_counter() - t)
            if capture is not None and "args" in capture:
                capture["args"] = tuple(
                    a.cpu() if torch.is_tensor(a) else a
                    for a in capture["args"])
            check(wait_until(lambda: all(
                eng.metrics()["pods_bound"] >= eng.metrics()["pods_assigned"]
                for eng in engines), timeout=120, interval=0.02),
                f"{label}: a round's binds did not land")
            cache_quiet_all(engines)
            check(len(rounds) < 1000, f"{label}: the queues do not drain")
        launches = dict(LAUNCHES)
        m = coord.metrics()
        by_name = {n.metadata.name: n for n in nodes}
        placed = {}
        for nm, pods, t in zip(names, tenant_pods, tenants):
            check(m[f"{nm}_pods_bound"] == len(pods)
                  and m[f"{nm}_batch_faults"] == 0 or spec,
                  f"{label}: {nm} bound {m[f'{nm}_pods_bound']} of "
                  f"{len(pods)}")
            bound = [q for q in t.store.list("Pod") if q.spec.node_name]
            check(len(bound) == len(pods),
                  f"{label}: {nm} has {len(bound)} of {len(pods)} bound")
            used: dict = {}
            for q in bound:
                u = used.setdefault(q.spec.node_name, [0.0, 0.0, 0])
                u[0] += q.spec.requests["cpu"]
                u[1] += q.spec.requests.get("memory", 0.0)
                u[2] += 1
            # The nodes as created (every store holds the same ones;
            # listing a store would clone its 50,000 nodes a tenant).
            for name, u in used.items():
                node = by_name[name]
                a = node.status.allocatable
                check(u[0] <= a["cpu"] and u[1] <= a["memory"]
                      and u[2] <= a["pods"] and not node.spec.unschedulable,
                      f"{label}: {nm} node {name} over-committed")
            placed[nm] = {q.key: q.spec.node_name for q in bound}
        return placed, m, rounds, launches, group_launches
    finally:
        faults.configure("")
        SEL.greedy_assign_shortlist_lanes = lanes
        PIPE._TENANT_CACHE.clear()
        PIPE._TENANT_INDEX_CACHE.clear()
        coord.shutdown()


def cache_quiet_all(engines, span=0.15) -> None:
    """cache_quiet over every engine's cache at once."""
    last = [eng.cache.version for eng in engines]
    while True:
        time.sleep(span)
        now = [eng.cache.version for eng in engines]
        if now == last:
            return
        last = now


def lane_kernels_check(args, label, smi):
    """The lane kernels on one captured fused group (scores (T,P,N),
    requests, free0, the lanes' seeds, K): one selection and one scan
    launch equal the lane-looped plain versions bitwise and equal T solo
    launches; the batched launches timed against the T solo launches in
    turns (CUDA events), each beside its bound. Returns the numbers."""
    scores, req, free0, seeds, k = args
    scores, req, free0 = (a.cuda() for a in (scores, req, free0))
    T, P, N = scores.shape
    R = req.shape[2]
    seeds_dev = lane_seeds(seeds, scores.device)
    sel = shortlist_select_lanes_cuda(scores, seeds_dev, k)
    got = shortlist_scan_lanes_cuda(scores, sel[0], sel[1], sel[2], req,
                                    free0, seeds_dev, cand_scores=sel[3])
    torch.cuda.synchronize()
    t = time.perf_counter()
    want_sel = shortlist_select_lanes_plain(scores, seeds, k)
    torch.cuda.synchronize()
    select_plain_ms = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    plain = greedy_assign_shortlist_lanes_plain(scores, req, free0, seeds,
                                                *want_sel)
    torch.cuda.synchronize()
    scan_plain_ms = (time.perf_counter() - t) * 1e3
    err = {"shortlist_select": 0.0, "shortlist_scan": 0.0}
    want_cs = torch.gather(scores, 2, want_sel[0].long())
    for name, a, b in zip(("cand", "kth", "kth_noise", "cand_scores"), sel,
                          (*want_sel, want_cs)):
        check(torch.equal(bits(a), bits(b)),
              f"{label}: lane selection {name} != plain")
        err["shortlist_select"] = max(err["shortlist_select"], float(
            (a.double() - b.double()).abs().max()))
    fields = ("chosen", "assigned", "free_after", "repaired")
    err["shortlist_scan"] = compare(got, plain, fields)
    for t_ in range(T):
        s_sel = shortlist_select_cuda(scores[t_], seeds[t_], k)
        for name, a, b in zip(("cand", "kth", "kth_noise", "cand_scores"),
                              s_sel, sel):
            check(torch.equal(bits(a), bits(b[t_])),
                  f"{label}: lane {t_} selection {name} != its solo launch")
        s_scan = shortlist_scan_cuda(scores[t_], *s_sel[:3], req[t_],
                                     free0[t_], seeds[t_],
                                     cand_scores=s_sel[3])
        for f in fields:
            check(torch.equal(bits(getattr(s_scan, f)),
                              bits(getattr(got, f)[t_])),
                  f"{label}: lane {t_} scan {f} != its solo launch")
    repairs = [int(r) for r in plain.repaired.sum(dim=1)]
    del plain, want_sel, want_cs

    def lane_select():
        shortlist_select_lanes_cuda(scores, seeds_dev, k)

    def solo_select():
        for t_ in range(T):
            shortlist_select_cuda(scores[t_], seeds[t_], k)

    def lane_scan():
        shortlist_scan_lanes_cuda(scores, sel[0], sel[1], sel[2], req, free0,
                                  seeds_dev, cand_scores=sel[3])

    def solo_scan():
        for t_ in range(T):
            shortlist_scan_cuda(scores[t_], sel[0][t_], sel[1][t_],
                                sel[2][t_], req[t_], free0[t_], seeds[t_],
                                cand_scores=sel[3][t_])

    times = {"select_lanes": [], "select_solo": [], "scan_lanes": [],
             "scan_solo": []}
    for key, fn in (("select_lanes", lane_select),
                    ("select_solo", solo_select),
                    ("select_solo", solo_select),
                    ("select_lanes", lane_select),
                    ("scan_lanes", lane_scan), ("scan_solo", solo_scan),
                    ("scan_solo", solo_scan), ("scan_lanes", lane_scan)):
        times[key].append(cuda_ms(fn, reps=5))
    sb, sby = select_bound_s(T * P, N, k)
    cb = [scan_bound_s(P, N, k, R, r) for r in repairs]
    out = {"shape": [T, P, N], "k": k, "err": err, "repairs": repairs,
           "select_ms": times["select_lanes"],
           "select_solo_ms": times["select_solo"],
           "select_plain_ms": select_plain_ms,
           "select_bound_s": sb, "select_bound_by": sby,
           "scan_ms": times["scan_lanes"], "scan_solo_ms": times["scan_solo"],
           "scan_plain_ms": scan_plain_ms,
           "scan_bound_s": sum(b for b, _ in cb),
           "scan_bound_by": cb[0][1]}
    print(f"{label}: the lane kernels on the stacked {tuple(scores.shape)} "
          f"K={k} batch equal their plain versions and {T} solo launches "
          f"bitwise (repairs per lane {repairs}); selection one launch "
          f"{'/'.join(f'{x:.4f}' for x in out['select_ms'])} ms against "
          f"{T} solo {'/'.join(f'{x:.4f}' for x in out['select_solo_ms'])}"
          f" ms in turns, plain {select_plain_ms:.1f} ms, bound "
          f"{sb * 1e3:.4f} ms ({sby}); scan one launch "
          f"{'/'.join(f'{x:.4f}' for x in out['scan_ms'])} ms against "
          f"{T} solo {'/'.join(f'{x:.4f}' for x in out['scan_solo_ms'])} "
          f"ms, plain {scan_plain_ms:.1f} ms, bound "
          f"{out['scan_bound_s'] * 1e3:.4f} ms ({out['scan_bound_by']}; "
          f"the chains of {P} dependent steps are the real limit) ({smi})")
    return out


def tenant_phase(smi):
    """H1. TENANTS bench-50k tenants with their own TENANT_PODS pods,
    unsampled, fused (one lane each) against sequential: placements
    equal per tenant, the fused rounds' dispatches and fetches against
    the sequential steps', one selection and one scan launch per fused
    group, the first group's lane kernels against plain and solo
    (lane_kernels_check), the rounds' host time, peak device memory.
    The tenants' stores are built once for H1 and H2.
    H2. The same tenants with the index (INDEX_CLASSES classes): the
    first round ejects every lane (cold) and rebuilds solo, the second
    serves every lane in one fused indexed dispatch; placements equal
    H1's; the lane kernels on the gathered class rows against plain.
    H3. SMALL_NODES nodes, four tenants of TENANT_SMALL pods, rounds of
    SMALL_BATCH slots (mixed-bucket rounds), unsampled: cuda = cpu on
    placements and counters, full and indexed; then
    tenant_index:corrupt@2 with index_check_every=1: the gate fires
    once, one lane desyncs and retries, the others settle, the
    fault-free placements. Returns the numbers for the kernels line."""
    nodes, _ = bench_workload(N_NODES, 0)
    tenant_pods = [bench_workload(0, TENANT_PODS, seed=1 + t)[1]
                   for t in range(TENANTS)]
    cfg = dict(max_batch_size=TENANTS * BATCH, **UNSAMPLED)
    t_sub = time.perf_counter()
    # The tenants' stores are built once: H1 sequential and H2 run on
    # them again with their pods created anew.
    stores = tenant_stores(nodes, tenant_pods)
    times = {"stores": time.perf_counter() - t_sub}
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cap1: dict = {}
    t_sub = time.perf_counter()
    f_placed, fm, f_rounds, f_launches, f_groups = tenant_run(
        SchedulerConfig(platform="", **cfg), nodes, tenant_pods, TENANTS,
        "H1 fused", capture=cap1, stores=stores)
    peak = torch.cuda.max_memory_allocated()
    times["H1 fused"] = time.perf_counter() - t_sub
    t_sub = time.perf_counter()
    reset_tenant_pods(stores, tenant_pods)
    s_placed, sm, s_rounds, s_launches, _g = tenant_run(
        SchedulerConfig(platform="", **cfg), nodes, tenant_pods, 0,
        "H1 sequential", stores=stores)
    times["H1 sequential"] = time.perf_counter() - t_sub
    check(f_placed == s_placed, "H1: fused placements != sequential")
    n_rounds = len(f_rounds)
    check(fm["tenant_dispatches"] == fm["tenant_fetches"] == n_rounds
          and fm["tenant_lanes_fused"] == TENANTS * n_rounds
          and fm["tenant_races"] == 0,
          f"H1: {fm['tenant_dispatches']} fused dispatches, "
          f"{fm['tenant_fetches']} fetches, {fm['tenant_lanes_fused']} "
          f"lanes in {n_rounds} rounds, {fm['tenant_races']} races")
    check(sm["steps_dispatched_total"] == sm["decision_fetches_total"]
          == TENANTS * len(s_rounds),
          f"H1 sequential: {sm['steps_dispatched_total']} steps, "
          f"{sm['decision_fetches_total']} fetches")
    check(len(f_groups) == fm["tenant_groups"] == n_rounds,
          f"H1: {len(f_groups)} fused groups read, {fm['tenant_groups']} "
          f"counted, in {n_rounds} rounds")
    for name in ("shortlist_select", "shortlist_scan"):
        check(f_launches[name] == n_rounds
              and all(g[name] == 1 for g in f_groups),
              f"H1: {name} launched {f_launches[name]} times in "
              f"{n_rounds} fused groups, by group "
              f"{[g[name] for g in f_groups]}")
        check(sum(fm[f"t{i}_kernel_launches_{name}"] for i in range(TENANTS))
              == f_launches[name], f"H1: {name} launches booked on the "
              f"engines != launched")
    t_sub = time.perf_counter()
    lanes1 = lane_kernels_check(cap1.pop("args"), "H1 lane kernels", smi)
    times["H1 lane kernels"] = time.perf_counter() - t_sub
    print(f"H1 {TENANTS} tenants x {N_NODES} nodes x {TENANT_PODS} pods "
          f"unsampled: placements equal fused and sequential per tenant; "
          f"fused {n_rounds} rounds, {fm['tenant_dispatches']} dispatches, "
          f"{fm['tenant_fetches']} fetches ({fm['tenant_fetch_bytes']:.0f} "
          f"B) against {sm['steps_dispatched_total']:.0f} steps and "
          f"{sm['decision_fetches_total']:.0f} fetches; kernels "
          f"{ {k: f_launches[k] for k in ('shortlist_select', 'shortlist_scan')} } "
          f"fused against "
          f"{ {k: s_launches[k] for k in ('shortlist_select', 'shortlist_scan')} } "
          f"sequential; round host time fused "
          f"{'/'.join(f'{x:.3f}' for x in f_rounds)} s against sequential "
          f"{'/'.join(f'{x:.3f}' for x in s_rounds)} s ({TENANTS} steps a "
          f"round); peak device memory {peak / GB:.3f} GB "
          f"({held / GB:.3f} GB held before) ({smi})")

    cap2: dict = {}
    t_sub = time.perf_counter()
    reset_tenant_pods(stores, tenant_pods)
    held2 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    i_placed, im, i_rounds, i_launches, i_groups = tenant_run(
        SchedulerConfig(platform="", index=True, index_classes=INDEX_CLASSES,
                        **cfg), nodes, tenant_pods, TENANTS, "H2 indexed",
        capture=cap2, stores=stores)
    peak2 = torch.cuda.max_memory_allocated()
    times["H2 indexed"] = time.perf_counter() - t_sub
    del stores
    check(i_placed == f_placed, "H2: indexed placements != H1's")
    check(len(i_groups) == im["tenant_groups"] >= 1
          and all(g[name] == 1 for g in i_groups
                  for name in ("shortlist_select", "shortlist_scan")),
          f"H2: fused groups' launches {i_groups}, {im['tenant_groups']} "
          f"groups counted")
    ejects = sum(im.get(f"t{i}_index_lane_ejects", 0)
                 for i in range(TENANTS))
    fused_hits = sum(im.get(f"t{i}_index_fused_hits", 0)
                     for i in range(TENANTS))
    check(ejects == TENANTS and im["tenant_index_dispatches"] >= 1
          and im["tenant_index_lanes"] == TENANTS * (len(i_rounds) - 1)
          and fused_hits == im["tenant_index_lanes"],
          f"H2: {ejects} ejects, {im['tenant_index_dispatches']} indexed "
          f"dispatches, {im['tenant_index_lanes']} lanes, {fused_hits} fused "
          f"hits in {len(i_rounds)} rounds; " + ", ".join(
              f"{k} {v}" for k, v in im.items()
              if k.startswith("t0_index") or k.startswith("tenant")))
    t_sub = time.perf_counter()
    lanes2 = lane_kernels_check(cap2.pop("args"), "H2 lane kernels on the "
                                "gathered class rows", smi)
    times["H2 lane kernels"] = time.perf_counter() - t_sub
    print(f"H2 the same tenants with the index ({INDEX_CLASSES} classes): "
          f"placements equal H1's; round 1 ejected {ejects} lanes (cold) "
          f"and rebuilt them solo, then {im['tenant_index_dispatches']} "
          f"fused indexed dispatches served {im['tenant_index_lanes']} "
          f"lanes, {fused_hits} fused hits; kernels "
          f"{ {k: i_launches[k] for k in ('shortlist_select', 'shortlist_scan')} }; "
          f"round host time {'/'.join(f'{x:.3f}' for x in i_rounds)} s; "
          f"peak device memory {peak2 / GB:.3f} GB ({held2 / GB:.3f} GB "
          f"held before) ({smi})")
    t_sub = time.perf_counter()

    small_nodes, _ = bench_workload(SMALL_NODES, 0)
    small_pods = [bench_workload(0, n, seed=20 + t)[1]
                  for t, n in enumerate(TENANT_SMALL)]
    runs = {}
    for index in (False, True):
        kw = dict(max_batch_size=SMALL_BATCH, **UNSAMPLED)
        if index:
            kw.update(index=True, index_classes=INDEX_CLASSES,
                      index_check_every=1)
        for platform in ("", "cpu"):
            runs[(index, platform)] = tenant_run(
                SchedulerConfig(platform=platform, **kw), small_nodes,
                small_pods, TENANTS,
                f"H3 {'indexed' if index else 'full'} on "
                f"{platform or 'cuda'}")
    names = [f"t{i}" for i in range(len(TENANT_SMALL))]
    for index in (False, True):
        (gp, gm, *_), (cp, cm, *_) = runs[(index, "")], runs[(index, "cpu")]
        check(gp == cp, f"H3 index={index}: placements cuda != cpu")
        for k in TENANT_COUNTERS:
            check(gm[k] == cm[k], f"H3 index={index}: {k} {gm[k]} on the "
                  f"card, {cm[k]} on the CPU")
        for nm in names:
            same_counters({k: gm.get(f"{nm}_{k}", 0) for k in
                           TENANT_ENGINE_COUNTERS},
                          {k: cm.get(f"{nm}_{k}", 0) for k in
                           TENANT_ENGINE_COUNTERS},
                          TENANT_ENGINE_COUNTERS, f"H3 {nm} index={index}")
    gm = runs[(True, "")][1]
    check(runs[(True, "")][0] == runs[(False, "")][0],
          "H3: indexed placements != full")
    check(gm["tenant_groups_round_max"] >= 2
          and gm["tenant_index_dispatches"] >= 2,
          f"H3: {gm['tenant_groups_round_max']} groups in a round at most, "
          f"{gm['tenant_index_dispatches']} indexed dispatches")
    f3, fm3, *_ = tenant_run(
        SchedulerConfig(platform="", max_batch_size=SMALL_BATCH,
                        index=True, index_classes=INDEX_CLASSES,
                        index_check_every=1, probation_batches=1,
                        **UNSAMPLED),
        small_nodes, small_pods, TENANTS, "H3 tenant_index:corrupt@2",
        spec="tenant_index:corrupt@2")
    desyncs = {nm: fm3[f"{nm}_index_desyncs"] for nm in names}
    hit = max(desyncs, key=desyncs.get)
    check(fm3["t0_fault_fires_tenant_index"] == 1
          and sum(desyncs.values()) == 1 and fm3[f"{hit}_index_width"] == 0
          and fm3[f"{hit}_batch_faults"] >= 1
          and all(fm3[f"{nm}_index_width"] > 0
                  and fm3[f"{nm}_batch_faults"] == 0
                  for nm in names if nm != hit),
          f"H3 tenant_index:corrupt@2: fires "
          f"{fm3['t0_fault_fires_tenant_index']}, desyncs {desyncs}")
    check(f3 == runs[(True, "")][0],
          "H3 tenant_index:corrupt@2: placements != the fault-free run's")
    print(f"H3 {SMALL_NODES} nodes, tenants of {TENANT_SMALL} pods, rounds "
          f"of {SMALL_BATCH} slots, unsampled: placements and "
          + ", ".join(f"{k} {gm[k]:.0f}" for k in TENANT_COUNTERS)
          + f" equal on the card and on the CPU, full and indexed "
          f"(index_check_every=1, {sum(gm[f'{nm}_index_checks'] for nm in names)} "
          f"checks, no desync); under tenant_index:corrupt@2 the gate fired "
          f"once, {hit} desynced once and ran its supervised retry, the "
          f"other lanes settled undisturbed, every pod on its fault-free "
          f"node ({smi})")
    times["H3"] = time.perf_counter() - t_sub
    print("phase H by part: " + ", ".join(f"{k} {v:.1f} s"
                                          for k, v in times.items()))
    groups = f_groups + i_groups
    return {"launches_per_fused_group": {
                name: sum(g[name] for g in groups) / len(groups)
                for name in ("shortlist_select", "shortlist_scan")},
            "fused_groups": len(groups),
            "h1": {"rounds": n_rounds, "fused_round_s": f_rounds,
                   "sequential_round_s": s_rounds,
                   "dispatches": fm["tenant_dispatches"],
                   "fetches": fm["tenant_fetches"],
                   "sequential_steps": sm["steps_dispatched_total"],
                   "sequential_fetches": sm["decision_fetches_total"],
                   "peak_device_gb": peak / GB, "held_gb": held / GB,
                   "launches": f_launches,
                   "lanes": lanes1},
            "h2": {"rounds": len(i_rounds), "round_s": i_rounds,
                   "index_dispatches": im["tenant_index_dispatches"],
                   "index_lanes": im["tenant_index_lanes"],
                   "fused_hits": fused_hits, "ejects": ejects,
                   "peak_device_gb": peak2 / GB, "held_gb": held2 / GB,
                   "launches": i_launches,
                   "lanes": lanes2}}


# I. The process surface: the engine over the API server's wire, the
# remote scenario, two profiles with a checkpoint.
# I1's depth: the main path's 10,000 pods (PERF.md §4).
WIRE_PODS = N_PODS
WIRE_TOKEN = "chip-smoke"
PROFILES_NODES, PROFILES_PODS = 1_200, 512
TWO_PROFILES = ("prof-a", "prof-b")


def placement_check(label, nodes, pods, placed) -> None:
    """Every pod of ``pods`` bound in ``placed`` ({key: node}), no node
    over its allocatable cpu, memory or pod count, none cordoned."""
    by_name = {n.metadata.name: n for n in nodes}
    used: dict = {}
    for p in pods:
        node = placed.get(p.key, "")
        check(bool(node), f"{label}: {p.key} not bound")
        u = used.setdefault(node, [0.0, 0.0, 0])
        u[0] += p.spec.requests["cpu"]
        u[1] += p.spec.requests.get("memory", 0.0)
        u[2] += 1
    for name, u in used.items():
        n = by_name[name]
        alloc = n.status.allocatable
        check(not n.spec.unschedulable and u[0] <= alloc["cpu"]
              and u[1] <= alloc["memory"] and u[2] <= alloc["pods"],
              f"{label}: node {name} over-committed or cordoned: {u}")


def wire_phase(smi):
    """I1. bench-50k with WIRE_PODS pods stored first, the engine a pure
    network client of the API server, against the same stored workload
    in process. Returns the numbers for the kernels line."""
    times = {}
    t = time.perf_counter()
    nodes, pods = bench_workload(N_NODES, WIRE_PODS)
    m0, l0, c2b0, pp0, placed0 = drive(
        SchedulerConfig(), nodes, pods, "I1 in process", pods_first=True,
        with_pv_controller=False)
    times["in process"] = time.perf_counter() - t
    t = time.perf_counter()
    nodes, pods = bench_workload(N_NODES, WIRE_PODS)
    store = ClusterStore()
    store.create_many(nodes)
    store.create_many(pods)
    times["served store"] = time.perf_counter() - t
    t = time.perf_counter()
    api = APIServer(store, token=WIRE_TOKEN, max_inflight=256).start()
    svc = SchedulerService(RemoteStore(api.address, token=WIRE_TOKEN))
    try:
        for name in LAUNCHES:
            LAUNCHES[name] = 0
        t0 = time.perf_counter()
        sched = svc.start_scheduler(BENCH_PROFILE, SchedulerConfig())
        check(wait_until(lambda: sched.cache.node_count() == N_NODES,
                         timeout=180, interval=0.01),
              "I1: the informers did not sync the nodes over the wire")
        sync_s = time.perf_counter() - t0

        def settled() -> bool:
            # The binds can land before the last batch is folded into
            # the metrics (pods_assigned and batches fold together).
            m = sched.metrics()
            return m["batch_faults"] > 0 or (
                m["pods_bound"] >= len(pods)
                and m["pods_assigned"] >= len(pods) and m["kernel_launches"]
                == sum(LAUNCHES.values()))

        wait_until(settled, timeout=300, interval=0.05)
        launches = dict(LAUNCHES)
        m = sched.metrics()
    finally:
        svc.shutdown_scheduler()
        api.shutdown()
    times["wire"] = time.perf_counter() - t
    check(m["batch_faults"] == 0, "I1: a scheduling cycle failed")
    check(m["pods_bound"] == len(pods) and m["bind_conflicts"] == 0,
          f"I1: {m['pods_bound']} binds for {len(pods)} pods, "
          f"{m['bind_conflicts']} conflicts")
    placed_pods = store.list("Pod")
    placed = {p.key: p.spec.node_name for p in placed_pods}
    placement_check("I1", nodes, pods, placed)
    b = m["batches"]
    check(launches["shortlist_select"] == b == launches["shortlist_scan"],
          f"I1: {b} batches, launches {launches}")
    check(placed == placed0, "I1: placements over the wire != in process")
    check("store_breaker_state" in m and m["store_breaker_state"] == 0
          and m["store_breaker_opens_total"] == 0 and m["store_outages"] == 0,
          "I1: the client's breaker is not closed or not in the metrics")
    created = np.array([p.metadata.creation_timestamp for p in placed_pods])
    bound_at = np.array([p.status.scheduled_time for p in placed_pods])
    c2b = float(bound_at.max() - created.min())
    print(path_line(f"I1 in process, pods first ({N_NODES} x {WIRE_PODS})",
                    m0, {k: v for k, v in l0.items() if v}, c2b0,
                    pp0, len(pods), smi))
    print(path_line(f"I1 over the wire (RemoteStore -> APIServer, "
                    f"{N_NODES} x {WIRE_PODS})", m,
                    {k: v for k, v in launches.items() if v}, c2b,
                    bound_at - created, len(pods), smi))
    print(f"I1: sync over the wire {sync_s:.3f} s (start until "
          f"{N_NODES} nodes cached); create-to-bound {c2b:.3f} s over the "
          f"wire against {c2b0:.3f} s in process; placements bitwise "
          f"equal; every pod bound once; breaker closed "
          f"(store_breaker_state 0, {m['store_breaker_probes_total']} "
          f"probes) ({smi})")
    print("phase I1 by part: " + ", ".join(f"{k} {v:.1f} s"
                                           for k, v in times.items()))
    return {"launches": launches, "sync_s": sync_s, "burst_s": c2b,
            "in_process_burst_s": c2b0, "pods": WIRE_PODS,
            "batches": b, "split_s": {k: m[f"{k}_s_total"] for k in (
                "prepare", "step", "resolve", "bind")}}


def remote_scenario_phase():
    """I2. scenario/remote.py's README scenario over the wire: the server
    subprocess's co-located engine on the card, then --client-engine,
    the engine in this process on the card. Returns the client engine's
    launches."""
    import contextlib
    import io

    for flags, label in (([], "co-located engine"),
                         (["--client-engine"], "client engine")):
        for name in LAUNCHES:
            LAUNCHES[name] = 0
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            remote.main(flags)
        lines = buf.getvalue().strip().splitlines()
        for line in lines:
            print(f"I2 {label}: {line}")
        check(any(ln.startswith("pod1 pending as expected over the wire "
                                "(unschedulable_plugins=['NodeUnschedulable']")
                  for ln in lines)
              and "pod1 is bound to node10 over the wire" in lines
              and any(ln.startswith("watch replayed ") for ln in lines)
              and "remote scenario OK" in lines,
              f"I2 {label}: the scenario's lines are missing")
    check("client-engine scenario OK (engine attached over the wire)"
          in lines, "I2: the client engine did not finish")
    launches = dict(LAUNCHES)
    check(launches["shortlist_select"] >= 1
          and launches["shortlist_scan"] >= 1,
          f"I2 client engine: no kernel launched in this process "
          f"({launches})")
    return launches


def profiles_run(platform: str, scratch: str, scrape: bool = False):
    """I3 on one device: prof-a's pods bound, shutdown (the final
    checkpoint), restore, prof-b's pods stored, restart, all bound.
    Returns (placements, metrics of each start, the scrape's text)."""
    nodes, pods = bench_workload(PROFILES_NODES, PROFILES_PODS, seed=5)
    for i, p in enumerate(pods):
        p.spec.scheduler_name = TWO_PROFILES[i % 2]
    half = {n: [p for p in pods if p.spec.scheduler_name == n]
            for n in TWO_PROFILES}
    conf = SchedulerConfiguration(profiles=[
        Profile(name=n, plugins=list(BENCH_PROFILE.plugins),
                plugin_args=dict(BENCH_PROFILE.plugin_args))
        for n in TWO_PROFILES])
    cfg = SchedulerConfig(platform=platform)
    path = os.path.join(scratch, f"profiles-{platform or 'cuda'}.json")
    label = f"I3 on {platform or 'cuda'}"
    ms, text = [], ""
    for start, pending in enumerate((half["prof-a"], half["prof-b"])):
        c = Cluster(persist_path=path)
        try:
            if start == 0:
                c.create_objects(nodes)
            else:
                check(c.store.count("Node") == len(nodes)
                      and all(c.get_pod(p.metadata.name, "bench")
                              .spec.node_name for p in half["prof-a"]),
                      f"{label}: the restored store lost a node or a bind")
            c.create_objects(pending)
            c.start(conf, cfg, with_pv_controller=False)
            check(wait_until(lambda: all(
                c.store.get("Pod", p.key).spec.node_name for p in pending),
                timeout=120, interval=0.02), f"{label}: pods left unbound")
            check(wait_until(lambda: sum(
                c.service.metrics()[f"{n}_pods_bound"]
                for n in TWO_PROFILES) >= len(pending), timeout=30),
                f"{label}: binds not counted")
            if scrape:
                api = APIServer(c.store).start()
                try:
                    remote.wire_service(api, c.service)
                    with urllib.request.urlopen(f"{api.address}/metrics",
                                                timeout=30) as r:
                        text = r.read().decode()
                finally:
                    api.shutdown()
            ms.append(c.service.metrics())
        finally:
            c.shutdown()
    restored = open_or_restore(path)
    placed = {p.key: p.spec.node_name for p in restored.list("Pod")}
    placement_check(label, nodes, pods, placed)
    for start, name in enumerate(TWO_PROFILES):
        other = TWO_PROFILES[1 - start]
        check(ms[start][f"{name}_pods_bound"] == len(half[name])
              and ms[start][f"{other}_pods_bound"] == 0
              and ms[start][f"{name}_bind_conflicts"] == 0,
              f"{label}: start {start + 1} bound "
              f"{ms[start][f'{name}_pods_bound']} of {name}'s pods and "
              f"{ms[start][f'{other}_pods_bound']} of {other}'s")
    return placed, ms, text


def profiles_phase(smi):
    """I3. Two profiles of one SchedulerConfiguration, with the service's
    checkpoint across a restart, on the card and on the CPU."""
    with tempfile.TemporaryDirectory() as scratch:
        placed, ms, text = profiles_run("", scratch, scrape=True)
        placed_cpu, _ms_cpu, _ = profiles_run("cpu", scratch)
    check(placed == placed_cpu, "I3: placements cuda != cpu")
    for n in TWO_PROFILES:
        key = n.replace("-", "_")
        check(f"minisched_engine_{key}_pods_bound " in text
              and f"minisched_engine_{key}_pod_create_to_bound_s_bucket"
              in text, f"I3: /metrics lacks {n}'s prefixed keys")
    print(f"I3 two profiles ({', '.join(TWO_PROFILES)}) over "
          f"{PROFILES_NODES} nodes x {PROFILES_PODS} pods, a checkpoint "
          f"and a restart between them: placements equal on the card and "
          f"on the CPU, no pod bound twice, none over-committed; batches "
          + ", ".join(f"{n} {ms[i][f'{n}_batches']:.0f}"
                      for i, n in enumerate(TWO_PROFILES))
          + f"; /metrics carries both profiles' prefixed keys ({smi})")


# ---- the replicated fleet and the lifecycle oracle (phase J) ---------------

FLEET_PODS = 4_096          # J1: shard-0 pods, stored first
FAILOVER_PODS = N_PODS      # J2: over both shards
FAILOVER_KILL_AT = 2_000    # J2: r1 dies once this many are bound
CHURN_S = 6.0               # J3: bench.py's churn_bench duration
SOAK_TTL_S = "0.4"          # J3: tests/test_fleet.py's soak lease TTL
FLEET_KERNELS = ("shortlist_select", "shortlist_scan")


def replica_launches(m) -> dict:
    """One engine's own launches by kernel, from its metrics (the
    process-wide LAUNCHES is shared by every replica) or from a replica
    process's sidecar metrics."""
    return {k: int(m[f"kernel_launches_{k}"]) for k in _cuda_build.KERNELS
            if m[f"kernel_launches_{k}"]}


def store_owners(fleet, want, timeout: float = 10.0) -> list:
    """The shards' owners in store truth, read until they are ``want``
    or ``timeout`` passes. A lease reads expired ("") while its live
    holder's heartbeat waits out a pause of the whole interpreter (a
    full garbage collection at 50,000 nodes can last as long as the
    default TTL); the holder's next renewal restores it, a claim by a
    peer does not."""
    def read():
        return [fleet.owner_of(s) for s in range(fleet.n_shards)]

    wait_until(lambda: read() == want, timeout=timeout, interval=0.05)
    return read()


def fleet_placement_phase(smi):
    """J1. One replica owns every pod at full width: the fleet places
    the shard-0 pods as the single engine does, bitwise."""
    times = {}
    t = time.perf_counter()
    nodes, pods = bench_workload(N_NODES, N_PODS)
    shard0 = [p for p in pods if shard_of(p.key, 2) == 0][:FLEET_PODS]
    check(len(shard0) == FLEET_PODS, f"J1: {len(shard0)} shard-0 pods")
    _m, l0, c2b0, _pp, solo = drive(
        SchedulerConfig(), nodes, shard0, "J1 single engine",
        pods_first=True, with_pv_controller=False)
    times["single engine"] = time.perf_counter() - t
    t = time.perf_counter()
    nodes, pods = bench_workload(N_NODES, N_PODS)
    shard0 = [p for p in pods if shard_of(p.key, 2) == 0][:FLEET_PODS]
    c = Cluster()
    try:
        c.create_objects(nodes)
        c.create_objects(shard0)
        for name in LAUNCHES:
            LAUNCHES[name] = 0
        t0 = time.perf_counter()
        c.start(BENCH_PROFILE, SchedulerConfig(), with_pv_controller=False,
                fleet=2)
        start_s = time.perf_counter() - t0
        fleet = c.service.fleet
        engines = fleet.engines()
        check(sorted(engines) == ["r0", "r1"], f"J1: replicas {engines}")

        def settled() -> bool:
            ms = [e.metrics() for e in engines.values()]
            return any(m["batch_faults"] for m in ms) or (
                sum(m["pods_bound"] for m in ms) >= len(shard0)
                and sum(m["pods_assigned"] for m in ms) >= len(shard0)
                and sum(m["kernel_launches"] for m in ms)
                == sum(LAUNCHES.values()))

        check(wait_until(settled, timeout=300, interval=0.05),
              "J1: the fleet did not bind every pod")
        per = {rid: e.metrics() for rid, e in engines.items()}
        fm = c.service.metrics()
        launches = dict(LAUNCHES)
        placed_pods = c.list_pods()
        placed = {p.key: p.spec.node_name for p in placed_pods}
        converged = fleet.wait_converged(10.0)
        owners = store_owners(fleet, ["r0", "r1"])
    finally:
        c.shutdown()
    times["fleet"] = time.perf_counter() - t
    r0, r1 = per["r0"], per["r1"]
    check(all(m["batch_faults"] == 0 for m in per.values()),
          "J1: a scheduling cycle failed")
    placement_check("J1", nodes, shard0, placed)
    check(placed == solo, "J1: fleet placements != the single engine's")
    check(r1["kernel_launches"] == 0 and r1["batches"] == 0
          and r1["pods_seen"] == 0,
          f"J1: r1 saw {r1['pods_seen']} pods, launched "
          f"{replica_launches(r1)}")
    b = r0["batches"]
    check(all(r0[f"kernel_launches_{k}"] == b for k in FLEET_KERNELS),
          f"J1: r0 {b} batches, launches {replica_launches(r0)}")
    check(all(r0[f"kernel_launches_{k}"] + r1[f"kernel_launches_{k}"]
              == launches[k] for k in _cuda_build.KERNELS),
          f"J1: replicas' launches {replica_launches(r0)} + "
          f"{replica_launches(r1)} != process-wide {launches}")
    check(fm["stale_owner_binds"] == 0 and fm["bind_conflicts"] == 0,
          f"J1: stale_owner_binds {fm['stale_owner_binds']}, "
          f"bind_conflicts {fm['bind_conflicts']}")
    check(converged and owners == ["r0", "r1"],
          f"J1: lease owners {owners} at the end")
    created = np.array([p.metadata.creation_timestamp for p in placed_pods])
    bound_at = np.array([p.status.scheduled_time for p in placed_pods])
    c2b = float(bound_at.max() - created.min())
    lease = {k: int(v) for k, v in fm.items() if k.startswith("lease_")}
    print(f"J1 fleet=2 at {N_NODES} nodes x {FLEET_PODS} shard-0 pods "
          f"(stored first, SchedulerConfig(), lease TTL "
          f"{fleet.lease_ttl_s} s): placements bitwise equal to the single "
          f"engine's; r0 {b} batches, launches {replica_launches(r0)}; r1 "
          f"0 batches, no launch; stale_owner_binds 0, bind_conflicts 0; "
          f"start (two informer syncs) {start_s:.3f} s, create-to-bound "
          f"{c2b:.3f} s against {c2b0:.3f} s single; {lease} ({smi})")
    print("phase J1 by part: " + ", ".join(f"{k} {v:.1f} s"
                                            for k, v in times.items()))
    return {"launches": {"r0": replica_launches(r0),
                         "r1": replica_launches(r1)},
            "solo_launches": {k: v for k, v in l0.items() if v},
            "batches": b, "pods": FLEET_PODS, "burst_s": c2b,
            "single_burst_s": c2b0, "start_s": start_s, "lease": lease}


def failover_phase(smi):
    """J2. A crash failover at full width: r1 abandoned mid-burst, its
    shard taken over by r0 through the expired lease."""
    times = {}
    t = time.perf_counter()
    nodes, pods = bench_workload(N_NODES, FAILOVER_PODS, seed=7)
    half = FAILOVER_PODS // 2
    c = Cluster()
    journal.configure("1")
    try:
        c.create_objects(nodes)
        times["store"] = time.perf_counter() - t
        t = time.perf_counter()
        c.start(BENCH_PROFILE, SchedulerConfig(), with_pv_controller=False,
                fleet=2)
        fleet = c.service.fleet
        engines = fleet.engines()
        check(fleet.wait_converged(30.0), "J2: the fleet never converged")
        times["start"] = time.perf_counter() - t
        t = time.perf_counter()
        seen: dict = {}
        rebinds = []

        def bound_now() -> int:
            """The exactly-once oracle from store truth: once a pod
            incarnation is seen bound, its node never changes. A pass
            copies every pod, so it runs every half second: polled
            faster it would take the interpreter from the engines."""
            n = 0
            for p in c.list_pods():
                if not p.spec.node_name:
                    continue
                n += 1
                prev = seen.setdefault(p.metadata.uid, p.spec.node_name)
                if prev != p.spec.node_name:
                    rebinds.append(p.key)
            return n

        def engines_bound() -> int:
            return sum(e.metrics()["pods_bound"] for e in engines.values())

        c.create_objects(pods[:half])
        check(wait_until(lambda: engines_bound() >= FAILOVER_KILL_AT,
                         timeout=120, interval=0.01),
              f"J2: {FAILOVER_KILL_AT} pods never bound before the kill")
        bound_at_kill = bound_now()
        check(fleet.kill("r1", crash=True), "J2: r1 was not killed")
        c.create_objects(pods[half:])
        check(wait_until(lambda: bound_now() >= FAILOVER_PODS,
                         timeout=300, interval=0.5),
              f"J2: {bound_now()} of {FAILOVER_PODS} pods bound")
        times["burst"] = time.perf_counter() - t
        converged = fleet.wait_converged(30.0)
        owners = store_owners(fleet, ["r0", "r0"])
        fm = fleet.metrics()
        hist = fleet.histograms()["pod_create_to_bound_s"]
        r0 = engines["r0"].metrics()
        r1 = engines["r1"].metrics()
        evs = journal.JOURNAL.entries()
        placed_pods = c.list_pods()
    finally:
        c.shutdown()
        journal.configure("")
    check(not rebinds, f"J2: pods seen on two nodes: {rebinds[:5]}")
    placed = {p.key: p.spec.node_name for p in placed_pods}
    check(len(placed_pods) == FAILOVER_PODS,
          f"J2: {len(placed_pods)} pods in the store")
    placement_check("J2", nodes, pods, placed)
    check(r0["batch_faults"] == 0, "J2: a scheduling cycle of r0 failed")
    kills = [e for e in evs if e["kind"] == "fleet.kill"]
    takes = [e for e in evs if e["kind"] == "lease.takeover"]
    check(len(kills) == 1 and kills[0]["replica"] == "r1"
          and kills[0]["crash"] is True, f"J2: kill notes {kills}")
    check(any(e["frm"] == "r1" and e["replica"] == "r0" for e in takes),
          f"J2: no lease.takeover from r1 ({takes})")
    check(fm["fleet_takeovers"] >= 1 and fm["fleet_replicas_live"] == 1,
          f"J2: fleet_takeovers {fm['fleet_takeovers']}, live "
          f"{fm['fleet_replicas_live']}")
    check(converged and set(owners) == {"r0"},
          f"J2: lease owners {owners} at the end")
    take = next(e for e in takes if e["frm"] == "r1")
    latency = take["t"] - kills[0]["t"]
    created = np.array([p.metadata.creation_timestamp for p in placed_pods])
    bound_at = np.array([p.status.scheduled_time for p in placed_pods])
    c2b = float(bound_at.max() - created.min())
    p99 = obs.hist_quantile(hist, 0.99)
    p99_pods = float(np.percentile(bound_at - created, 99))
    lease = {k: int(v) for k, v in fm.items() if k.startswith("lease_")}
    b0 = r0["batches"]
    check(all(r0[f"kernel_launches_{k}"] == b0 for k in FLEET_KERNELS),
          f"J2: r0 {b0} batches, launches {replica_launches(r0)}")
    print(f"J2 crash failover at {N_NODES} nodes x {FAILOVER_PODS} pods "
          f"(fleet=2, SchedulerConfig(), lease TTL {fleet.lease_ttl_s} s): "
          f"r1 (shards {kills[0]['shards']}) killed with crash=True at "
          f"{bound_at_kill} bound; every pod bound exactly once, none "
          f"over-committed; takeover of shard {take['shard']} by r0 at "
          f"epoch {take['epoch']} ({take['pods']} pending pods drained), "
          f"latency {latency:.3f} s (fleet.kill to lease.takeover); "
          f"create-to-bound {c2b:.3f} s, p99 {p99:.3f} s from the "
          f"fleet-merged histogram (r0's, its bucket interpolated), "
          f"{p99_pods:.3f} s from the pods' stamps; "
          f"fleet_takeovers {fm['fleet_takeovers']}, stale_owner_binds "
          f"{fm['stale_owner_binds']} (r1's own "
          f"{r1['stale_owner_binds']}), bind_conflicts "
          f"{fm['bind_conflicts']}; {lease}; r0 {b0} batches, launches "
          f"{replica_launches(r0)}, r1 {r1['batches']} batches, launches "
          f"{replica_launches(r1)} ({smi})")
    print("phase J2 by part: " + ", ".join(f"{k} {v:.1f} s"
                                            for k, v in times.items()))
    return {"launches": {"r0": replica_launches(r0),
                         "r1": replica_launches(r1)},
            "pods": FAILOVER_PODS, "bound_at_kill": bound_at_kill,
            "takeover_latency_s": latency, "burst_s": c2b,
            "p99_create_to_bound_s": p99,
            "p99_create_to_bound_s_stamps": p99_pods, "lease": lease,
            "stale_owner_binds": int(fm["stale_owner_binds"]),
            "r1_stale_owner_binds": int(r1["stale_owner_binds"]),
            "bind_conflicts": int(fm["bind_conflicts"]),
            "takeover_pods": take["pods"]}


CHURN_PROFILE = Profile(name="churn", plugins=[
    "NodeUnschedulable", "NodeResourcesFit", "NodeResourcesLeastAllocated",
    "DefaultPreemption"])
SOAK_PROFILE = Profile(plugins=["NodeUnschedulable", "NodeResourcesFit",
                                "NodeResourcesLeastAllocated"])


def oracle_run(label, c, driver, until_s=None):
    """Run ``driver`` (every invariant after every step), then settle
    and the final pass; an InvariantViolation fails the phase."""
    try:
        driver.run(until_s=until_s)
        settled = driver.settle(timeout=60)
        driver.check_invariants()
    except lifecycle.InvariantViolation as e:
        check(False, f"{label}: {e}")
    check(settled, f"{label}: the cluster never settled")
    states = {rid: e.metrics()["degradation_state"]
              for rid, e in c.service.schedulers.items()}
    check(all(s == "resident" for s in states.values()),
          f"{label}: degradation states {states}")


def oracle_phase(smi):
    """J3. The lifecycle oracle on the card: the clean churn composition
    on one engine, then the kill and restart soak on a fleet."""
    out = {}
    t = time.perf_counter()
    c = Cluster()
    c.start(CHURN_PROFILE, SchedulerConfig(
        backoff_initial_s=0.05, backoff_max_s=0.2, max_batch_size=128,
        probation_batches=2), with_pv_controller=False)
    try:
        d = lifecycle.LifecycleDriver(c, seed=0, pace=1.0, settle_s=8.0)
        budget = d.budget("base", max_unavailable=2)
        for _ in range(16):
            d.view.create_pool_node("base", cpu=4000)
        d.add(lifecycle.PoissonArrivals(
            "arrivals", rate_pps=40, duration_s=CHURN_S, amplitude=0.6,
            period_s=CHURN_S / 2, cpu=100, prefix="ch"))
        d.add(lifecycle.TenantMix("tenants", rate_pps=20,
                                  duration_s=CHURN_S, cpu=150))
        d.add(lifecycle.AutoscalerLoop(
            "autoscaler", pool="as", interval_s=0.4, min_nodes=2,
            max_nodes=8, scale_up_pending=12, idle_rounds=2, cpu=4000,
            drain_grace_s=0.3))
        d.add(lifecycle.ReclamationWave(
            "reclaim", pool="base", interval_s=CHURN_S / 3, wave_frac=0.2,
            grace_s=0.4, waves=max(1, int(CHURN_S // 2)), budget=budget))
        d.add(lifecycle.RollingUpgrade(
            "upgrade", pool="base", budget=budget, grace_s=0.3,
            retry_s=0.25, start_after_s=0.5))
        d.install_default_invariants()
        oracle_run("J3 churn", c, d, until_s=CHURN_S)
        m = c.service.scheduler.metrics()
        check(m["pods_bound"] > 0 and budget.high_water <= 2,
              f"J3 churn: {m['pods_bound']} bound, budget high water "
              f"{budget.high_water}")
        p99 = obs.hist_quantile(m["histograms"]["pod_create_to_bound_s"],
                                0.99)
        churn = {"events": len(d.events), "steps": d.steps,
                 "invariant_checks": d.invariant_checks,
                 "pods_bound": int(m["pods_bound"]),
                 "batches": int(m["batches"]),
                 "budget_denials": budget.denials,
                 "p99_create_to_bound_s": p99,
                 "launches": replica_launches(m)}
    finally:
        c.shutdown()
    out["churn_s"] = time.perf_counter() - t
    print(f"J3 churn ({CHURN_S} s, 16 base nodes, seed 0): "
          f"{churn['events']} events, {churn['steps']} steps, "
          f"{churn['invariant_checks']} invariant passes, 0 violations, "
          f"settled, resident; {churn['pods_bound']} pods bound in "
          f"{churn['batches']} batches, budget denials "
          f"{churn['budget_denials']}, create-to-bound p99 {p99:.3f} s, "
          f"launches {churn['launches']} ({smi})")
    t = time.perf_counter()
    old_ttl = os.environ.get("MINISCHED_LEASE_TTL")
    os.environ["MINISCHED_LEASE_TTL"] = SOAK_TTL_S
    c = Cluster()
    try:
        for i in range(8):
            c.create_node(f"n{i}", cpu=32000)
        c.start(SOAK_PROFILE, SchedulerConfig(
            max_batch_size=16, batch_window_s=0.05, batch_idle_s=0.02,
            backoff_initial_s=0.05, backoff_max_s=0.2),
            with_pv_controller=False, fleet=2)
        fleet = c.service.fleet
        check(fleet.wait_converged(10.0), "J3 soak: never converged")
        d = lifecycle.LifecycleDriver(c, seed=7, pace=1.0, settle_s=10.0)
        d.add(lifecycle.PoissonArrivals("load", rate_pps=40,
                                        duration_s=2.5, cpu=200,
                                        prefix="fo"))
        d.add(lifecycle.RestartScheduler("chaos", replica="r1",
                                         after_s=0.8, downtime_s=1.0))
        d.install_default_invariants()
        oracle_run("J3 soak", c, d)
        fm = fleet.metrics()
        check(d.view.counters.get("scheduler_kills") == 1
              and d.view.counters.get("scheduler_restarts") == 1
              and fm["fleet_takeovers"] >= 1,
              f"J3 soak: counters {d.view.counters}, takeovers "
              f"{fm['fleet_takeovers']}")
        soak = {"events": len(d.events), "steps": d.steps,
                "invariant_checks": d.invariant_checks,
                "pods_bound": len([p for p in c.list_pods()
                                   if p.spec.node_name]),
                "takeovers": int(fm["fleet_takeovers"]),
                "launches": {rid: replica_launches(e.metrics())
                             for rid, e in fleet.engines().items()}}
    finally:
        c.shutdown()
        if old_ttl is None:
            os.environ.pop("MINISCHED_LEASE_TTL", None)
        else:
            os.environ["MINISCHED_LEASE_TTL"] = old_ttl
    out["soak_s"] = time.perf_counter() - t
    print(f"J3 kill and restart soak (fleet=2, lease TTL {SOAK_TTL_S} s, "
          f"seed 7): {soak['events']} events, {soak['invariant_checks']} "
          f"invariant passes, 0 violations, settled, resident; "
          f"{soak['pods_bound']} pods bound, takeovers {soak['takeovers']},"
          f" launches of the live replicas {soak['launches']} ({smi})")
    print(f"phase J3 by part: churn {out['churn_s']:.1f} s, soak "
          f"{out['soak_s']:.1f} s")
    return {"churn": churn, "soak": soak}


# ---- the process fleet and the steward election (phase K) -----------------

FLEET_PROC_PODS = 4_096     # K1: bench pods over both shards
FLEET_PROC_KILL_AT = 1_024  # K1: p1 dies once this many are bound
ELECT_NODES, ELECT_PODS = 1_200, 512  # K2
CPU_REPLICA_NODES, CPU_REPLICA_PODS = 64, 64  # K3
PHASE_K_STDERR = os.path.join("smoke_out", "phase_k_stderr.log")


class replica_stderr:
    """The standard error of every process started inside the block
    (the replicas inherit it) goes to ``PHASE_K_STDERR``: the replicas'
    warnings would otherwise crowd out the run's own output. If the
    block fails, the log's last lines are printed."""

    def __enter__(self):
        os.makedirs(os.path.dirname(PHASE_K_STDERR), exist_ok=True)
        sys.stderr.flush()
        self.saved = os.dup(2)
        self.log = open(PHASE_K_STDERR, "a")
        os.dup2(self.log.fileno(), 2)
        return self

    def __exit__(self, exc_type, *exc):
        sys.stderr.flush()
        os.dup2(self.saved, 2)
        os.close(self.saved)
        self.log.close()
        if exc_type is not None:
            with open(PHASE_K_STDERR) as f:
                tail = f.read().splitlines()[-40:]
            print("replicas' stderr, last lines:\n" + "\n".join(tail))
        return False


def sidecar_metrics(address: str) -> dict:
    """A replica's own metrics from its sidecar's ``/metrics``."""
    import re

    with urllib.request.urlopen(f"{address}/metrics", timeout=10) as r:
        text = r.read().decode()
    return {m.group(1): float(m.group(2)) for m in re.finditer(
        r"^minisched_engine_(\w+) (\S+)$", text, re.M)}


def compute_apps() -> list:
    """The card's compute processes as nvidia-smi lists them, one
    (pid, used memory) pair a context. In a container whose pid
    namespace the NVIDIA driver cannot map, the pids are not this
    namespace's (one such machine listed pid 1 for every context): the
    count of contexts is then what holds."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout
    return [tuple(x.strip() for x in ln.split(",", 1))
            for ln in out.splitlines() if ln.strip()]


def card_fds(pid: int) -> list:
    """The NVIDIA device files process ``pid`` holds open: a process
    with a CUDA context holds ``/dev/nvidia<n>``; one that never
    initialized CUDA holds none (not even ``/dev/nvidiactl``)."""
    out = []
    fd_dir = f"/proc/{pid}/fd"
    for fd in os.listdir(fd_dir):
        try:
            target = os.readlink(os.path.join(fd_dir, fd))
        except OSError:
            continue
        if target.startswith("/dev/nvidia"):
            out.append(target)
    return sorted(set(out))


def holds_card(pid: int) -> bool:
    import re

    return any(re.fullmatch(r"/dev/nvidia\d+", f) for f in card_fds(pid))


def reap(pids) -> list:
    """SIGKILL every pid of ``pids`` still alive; the ones left."""
    for pid in pids:
        if pid > 0 and not _pid_dead(pid):
            try:
                os.kill(pid, 9)
            except OSError:
                pass
    wait_until(lambda: all(_pid_dead(p) for p in pids if p > 0),
               timeout=10, interval=0.05)
    return [p for p in pids if p > 0 and not _pid_dead(p)]


def proc_fleet_phase(smi):
    """K1. Two replica processes at bench-50k, one SIGKILLed mid-burst."""
    times = {}
    t = time.perf_counter()
    nodes, pods = bench_workload(N_NODES, FLEET_PROC_PODS, seed=11)
    store = ClusterStore()
    store.create_many(nodes)
    api = APIServer(store, max_inflight=256).start()
    times["store"] = time.perf_counter() - t
    journal.configure("1")
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    sup = ProcFleetSupervisor(
        store, api.address, replicas=2,
        config_overrides=dataclasses.asdict(SchedulerConfig()),
        profile=BENCH_PROFILE, prewarm=True)
    pids: set = set()
    apps0 = len(compute_apps())
    try:
        t = time.perf_counter()
        sup.start()
        pids.update(p.popen.pid for p in sup._procs.values())
        check(sup.wait_ready(180), "K1: the replicas never came ready")
        check(sup.wait_converged(60), "K1: the shards were never claimed")
        times["start"] = time.perf_counter() - t
        apps = compute_apps()
        fds = {pid: card_fds(pid) for pid in pids}
        check(all(holds_card(pid) for pid in pids)
              and len(apps) >= apps0 + 2,
              f"K1: replicas' device files {fds}, the card's compute "
              f"processes {apps} (before the spawn: {apps0})")
        boot = {rid: sidecar_metrics(sup._procs[rid].address)
                for rid in ("p0", "p1")}
        t = time.perf_counter()
        seen: dict = {}
        rebinds = []
        shard1 = {p.key for p in pods if shard_of(p.key, 2) == 1}

        def bound_now() -> int:
            n = 0
            for p in store.list("Pod"):
                if not p.spec.node_name:
                    continue
                n += 1
                if seen.setdefault(p.metadata.uid,
                                   p.spec.node_name) != p.spec.node_name:
                    rebinds.append(p.key)
            return n

        def kill_due() -> bool:
            # Both replicas have bound a batch (each binds its shard).
            bound = {p.key in shard1 for p in store.list("Pod")
                     if p.spec.node_name}
            return bound == {False, True} \
                and bound_now() >= FLEET_PROC_KILL_AT

        half = FLEET_PROC_PODS // 2
        store.create_many(pods[:half])
        check(wait_until(kill_due, timeout=120, interval=0.05),
              f"K1: {bound_now()} pods bound before the kill")
        before_kill = {rid: sidecar_metrics(sup._procs[rid].address)
                       for rid in ("p0", "p1")}
        kill_unix = time.time()
        bound_at_kill = bound_now()
        check(sup.kill("p1"), "K1: p1 was not killed")
        store.create_many(pods[half:])
        check(wait_until(lambda: bound_now() >= FLEET_PROC_PODS,
                         timeout=180, interval=0.5),
              f"K1: {bound_now()} of {FLEET_PROC_PODS} pods bound")
        times["burst"] = time.perf_counter() - t
        t = time.perf_counter()

        def takeovers():
            return [e for e in sup.journal()["entries"]
                    if e["kind"] == "lease.takeover"
                    and e.get("frm") == "p1"]

        check(wait_until(lambda: bool(takeovers()), timeout=30,
                         interval=0.2), "K1: no lease.takeover from p1")
        check(wait_until(lambda: sup.census().get("p1") is not None
                         and sup.census()["p1"].incarnation == 1,
                         timeout=120, interval=0.2),
              "K1: p1 never came back ready at incarnation 1")
        pids.update(p.popen.pid for p in sup._procs.values())
        check(wait_until(lambda: sup.lease_holders() == {0: "p0",
                                                         1: "p0"},
                         timeout=10, interval=0.05),
              f"K1: lease holders {sup.lease_holders()} at the end")
        times["respawn"] = time.perf_counter() - t
        after = {rid: sidecar_metrics(sup._procs[rid].address)
                 for rid in ("p0", "p1")}
        doc = sup.journal()
        fm = sup.metrics()
        placed_pods = store.list("Pod")
    finally:
        sup.shutdown()
        api.shutdown()
        journal.configure("")
        left = reap(pids)
    check(not left, f"K1: replica pids {left} outlived the phase")
    check(not rebinds, f"K1: pods seen on two nodes: {rebinds[:5]}")
    check(len(placed_pods) == FLEET_PROC_PODS,
          f"K1: {len(placed_pods)} pods in the store")
    placement_check("K1", nodes, pods,
                    {p.key: p.spec.node_name for p in placed_pods})
    take = [e for e in doc["entries"]
            if e["kind"] == "lease.takeover" and e.get("frm") == "p1"]
    check(take[0]["source"] == "p0", f"K1: takeover notes {take}")
    deaths = [e for e in doc["entries"] if e["kind"] == "proc.death"]
    check(len(deaths) == 1 and deaths[0]["exit_code"] == -9
          and fm["proc_exit_-9"] == 1 and fm["proc_respawns"] == 1,
          f"K1: deaths {deaths}, census {fm}")
    check(sum(LAUNCHES.values()) == 0,
          f"K1: this process launched {dict(LAUNCHES)}")
    for rid, m in before_kill.items():
        b = int(m["batches"])
        check(b > 0 and all(int(m[f"kernel_launches_{k}"]) == b
                            for k in FLEET_KERNELS)
              and m["proc_cuda_initialized"] == 1.0
              and m["batch_faults"] == 0,
              f"K1: {rid} {b} batches, launches {replica_launches(m)}, "
              f"faults {m['batch_faults']}")
    p0 = after["p0"]
    check(all(p0[f"kernel_launches_{k}"] == p0["batches"]
              for k in FLEET_KERNELS) and p0["batch_faults"] == 0,
          f"K1: p0 after the burst {replica_launches(p0)}")
    created = np.array([p.metadata.creation_timestamp
                        for p in placed_pods])
    bound_at = np.array([p.status.scheduled_time for p in placed_pods])
    adopted = [p.status.scheduled_time for p in placed_pods
               if p.key in shard1 and p.status.scheduled_time > kill_unix]
    first_slo = (min(adopted) - kill_unix) if adopted else None
    latency = take[0]["unix"] - kill_unix
    c2b = float(bound_at.max() - created.min())
    p99 = float(np.percentile(bound_at - created, 99))
    lease = {k: int(v) for k, v in after["p0"].items()
             if k.startswith("lease_")}
    out = {"pods": FLEET_PROC_PODS, "bound_at_kill": bound_at_kill,
           "sync_s": {rid: m["proc_sync_s"] for rid, m in boot.items()},
           "prewarm_s": {rid: m["proc_warm_s"] for rid, m in boot.items()},
           "respawn_sync_s": after["p1"]["proc_sync_s"],
           "respawn_prewarm_s": after["p1"]["proc_warm_s"],
           "takeover_latency_s": latency,
           "time_to_first_slo_s": first_slo, "burst_s": c2b,
           "p99_create_to_bound_s": p99, "lease_p0": lease,
           "lease_losses_p0": lease.get("lease_losses", 0),
           "launches": {"p0": replica_launches(p0),
                        "p1": replica_launches(before_kill["p1"])},
           "adopted_pods": take[0]["pods"]}
    check(first_slo is not None and take[0]["pods"] > 0,
          f"K1: nothing of the dead shard adopted ({take[0]['pods']} "
          f"drained, first bind {first_slo})")
    print(f"K1 process fleet at {N_NODES} nodes x {FLEET_PROC_PODS} pods "
          f"(2 replica processes, SchedulerConfig(), lease TTL "
          f"{sup.lease_ttl_s} s, prewarm on): p1 SIGKILLed at "
          f"{bound_at_kill} bound, then the second {half} stored; every pod bound exactly once, none "
          f"over-committed; takeover of shard {take[0]['shard']} by p0 at "
          f"epoch {take[0]['epoch']} ({take[0]['pods']} pods drained) "
          f"{latency:.3f} s after the kill, first bind of the dead "
          f"shard {first_slo:.3f} s after it; p1 respawned at incarnation 1; sync "
          f"{out['sync_s']} s, prewarm {out['prewarm_s']} s (respawn: sync "
          f"{out['respawn_sync_s']:.3f} s, prewarm "
          f"{out['respawn_prewarm_s']:.3f} s); create-to-bound {c2b:.3f} s,"
          f" p99 {p99:.3f} s (pods' stamps); launches in p0 "
          f"{out['launches']['p0']}, in p1 before the kill "
          f"{out['launches']['p1']}, in this process none; p0 {lease} "
          f"({smi})")
    print("phase K1 by part: " + ", ".join(f"{k} {v:.1f} s"
                                            for k, v in times.items()))
    return out


def elect_phase(smi):
    """K2. Three detached replicas elect a steward; the steward dies."""
    nodes, pods = bench_workload(ELECT_NODES, ELECT_PODS, seed=12)
    store = ClusterStore()
    store.create_many(nodes)
    api = APIServer(store).start()
    rs = RemoteStore(api.address)
    fleet = ElectFleet(rs, api.address, replicas=3,
                       spec={"config": dataclasses.asdict(
                           SchedulerConfig()),
                             "profile": dataclasses.asdict(BENCH_PROFILE)})
    pids: set = set()

    def look() -> bool:
        pids.update(p for p in fleet.pids().values() if p > 0)
        return True

    t0 = time.perf_counter()
    try:
        launched = fleet.launch()
        pids.update(launched)
        check(fleet.wait_ready(120), "K2: the fleet never came ready")
        steward = fleet.wait_steward(30)
        check(bool(steward) and fleet.wait_converged(60),
              f"K2: steward {steward!r}, leases {fleet.lease_holders()}")
        ready_s = time.perf_counter() - t0
        epoch0 = fleet.steward_epoch()
        look()
        store.create_many(pods)
        check(wait_until(lambda: sum(1 for p in store.list("Pod")
                                     if p.spec.node_name) >= 64,
                         timeout=60, interval=0.05),
              "K2: no pod bound before the kill")
        t_kill = time.perf_counter()
        check(fleet.kill(steward), f"K2: steward {steward} not killed")
        successor = fleet.wait_steward(30, exclude=steward)
        succession_s = time.perf_counter() - t_kill
        check(bool(successor) and fleet.steward_epoch() > epoch0,
              f"K2: successor {successor!r} at epoch "
              f"{fleet.steward_epoch()} (was {epoch0})")
        check(wait_until(lambda: look() and (lambda r: r is not None
                         and r.state == "alive" and r.deaths == 1
                         and r.respawns == 1 and r.incarnation == 1)(
                         fleet.incarnations().get(steward)),
                         timeout=120, interval=0.2),
              f"K2: census {fleet.incarnations().get(steward)}")
        respawn_s = time.perf_counter() - t_kill
        others = [r for rid, r in fleet.incarnations().items()
                  if rid != steward]
        check(all(r.deaths == 0 and r.respawns == 0 for r in others),
              f"K2: other records {others}")
        check(wait_until(lambda: all(p.spec.node_name
                                     for p in store.list("Pod")),
                         timeout=120, interval=0.2),
              "K2: not every pod bound")
        check(fleet.wait_converged(60), "K2: the fleet never reconverged")
        look()
        placed_pods = store.list("Pod")
        elect_epoch = fleet.steward_epoch()
    finally:
        try:
            look()
        except Exception:
            pass
        fleet.shutdown()
        api.shutdown()
        left = reap(pids)
    check(not left, f"K2: pids {left} outlived the phase")
    check(len(pids) == 4, f"K2: {len(pids)} pids (3 launched, 1 respawn)")
    check(len(placed_pods) == ELECT_PODS
          and len({p.key for p in placed_pods}) == ELECT_PODS,
          f"K2: {len(placed_pods)} pods")
    placement_check("K2", nodes, pods,
                    {p.key: p.spec.node_name for p in placed_pods})
    print(f"K2 election fleet of 3 detached replicas at {ELECT_NODES} "
          f"nodes x {ELECT_PODS} pods (SchedulerConfig(), lease TTL "
          f"{fleet.ttl_s} s): ready and converged in {ready_s:.3f} s; "
          f"steward {steward} SIGKILLed, {successor} steward at epoch "
          f"{elect_epoch} (was {epoch0}) {succession_s:.3f} s later; "
          f"{steward} respawned once (incarnation 1, alive) "
          f"{respawn_s:.3f} s after the kill; every pod bound once, none "
          f"over-committed; all {len(pids)} pids reaped ({smi})")
    return {"ready_s": ready_s, "succession_s": succession_s,
            "respawn_s": respawn_s, "epochs": [epoch0, elect_epoch],
            "pids": len(pids)}


def cpu_replica_phase(smi):
    """K3. A replica on platform="cpu" beside the card never touches it."""
    nodes, pods = bench_workload(CPU_REPLICA_NODES, CPU_REPLICA_PODS,
                                 seed=13)
    store = ClusterStore()
    store.create_many(nodes)
    api = APIServer(store).start()
    sup = ProcFleetSupervisor(
        store, api.address, replicas=1,
        config_overrides=dataclasses.asdict(SchedulerConfig(
            platform="cpu")), profile=BENCH_PROFILE, prewarm=True)
    pids: set = set()
    sightings = []
    apps0 = compute_apps()

    def sight(pid) -> None:
        apps = compute_apps()
        sightings.append({"pid listed": str(pid) in {a[0] for a in apps},
                          "contexts": len(apps),
                          "device files": card_fds(pid)})

    try:
        sup.start()
        pid = sup._procs["p0"].popen.pid
        pids.add(pid)
        check(sup.wait_ready(120) and sup.wait_converged(30),
              "K3: the CPU replica never came ready")
        sight(pid)
        store.create_many(pods)
        check(wait_until(lambda: all(p.spec.node_name
                                     for p in store.list("Pod")),
                         timeout=60, interval=0.05),
              "K3: the CPU replica did not bind its pods")
        sight(pid)
        m = sidecar_metrics(sup._procs["p0"].address)
        sight(pid)
        placed_pods = store.list("Pod")
    finally:
        sup.shutdown()
        api.shutdown()
        left = reap(pids)
    check(not left, f"K3: pid {left} outlived the phase")
    check(all(not x["pid listed"] and x["contexts"] == len(apps0)
              and not x["device files"] for x in sightings),
          f"K3: the CPU replica on the card: {sightings} (contexts before "
          f"its spawn: {apps0})")
    check(m["proc_cuda_initialized"] == 0.0 and not replica_launches(m)
          and m["pods_bound"] == CPU_REPLICA_PODS,
          f"K3: cuda_initialized {m['proc_cuda_initialized']}, launches "
          f"{replica_launches(m)}, bound {m['pods_bound']}")
    placement_check("K3", nodes, pods,
                    {p.key: p.spec.node_name for p in placed_pods})
    print(f"K3 a platform=\"cpu\" replica on the card's machine: "
          f"{CPU_REPLICA_PODS} pods bound over {CPU_REPLICA_NODES} nodes, "
          f"{int(m['batches'])} batches, no kernel launch, CUDA never "
          f"initialized; at {len(sightings)} readings its pid absent from "
          f"nvidia-smi's compute processes, their count {len(apps0)} as "
          f"before its spawn, and no /dev/nvidia* file open in it ({smi})")
    return {"pods": CPU_REPLICA_PODS, "cuda_initialized": False}


MESH_DEVICE = "cuda:0"
MESH_SHAPES = ((2, 4), (1, 1))  # L1: a virtual (2,4) mesh and (1,1)
MESH_PODS = EARLIER_PODS        # L2: the earlier path's cut (PERF.md §4)


def mesh_step_phase(smi, eb_d, nf_d, af_d, key):
    """L1. The sharded step at full width against the single-device
    step, each chunk launch of the greedy scan against its plain
    version."""
    ps = BENCH_PROFILE.build()
    dev = torch.device(MESH_DEVICE)
    P = eb_d.pf.valid.shape[0]
    out = {"launches": {}, "ms": {}, "single_ms": {},
           "err": {"greedy_assign": 0.0, "auction": 0.0}}
    for assignment in ("greedy", "auction"):
        kernel = "greedy_assign" if assignment == "greedy" else "auction"
        single = build_step(ps, assignment=assignment)

        def run_single():
            return single(eb_d, nf_d, af_d, key, has_gang=False,
                          hard_spread=False)

        want = run_single()
        out["single_ms"][assignment] = cuda_ms(run_single, reps=3)
        for shape in MESH_SHAPES:
            label = f"L1 {shape[0]}x{shape[1]} {assignment}"
            mesh = make_mesh([dev] * (shape[0] * shape[1]),
                             pod_axis_size=shape[0])
            check(mesh.devices.shape == shape, f"{label}: mesh shape")
            chunks = []
            step = build_sharded_step(
                ps, mesh, eb_d, nf_d, af_d, assignment=assignment,
                observe=lambda *a: chunks.append(a))
            before = dict(LAUNCHES)
            got = step(eb_d, nf_d, af_d, key, has_gang=False)
            torch.cuda.synchronize()
            launched = {k: LAUNCHES[k] - before[k] for k in LAUNCHES
                        if LAUNCHES[k] != before[k]}
            for f in want._fields:
                check(torch.equal(bits(getattr(want, f)),
                                  bits(getattr(got, f))),
                      f"{label}: {f} differs from the single-device step")
            if assignment == "greedy":
                n_chunks = P // _chunk_size(P // shape[0])
                check(launched == {kernel: n_chunks} == {
                    kernel: len(chunks)},
                      f"{label}: launches {launched}, {len(chunks)} chunks"
                      f" (want one greedy launch per chunk, {n_chunks})")
                if shape == MESH_SHAPES[0]:
                    for c, blk, req, free, seed_c, r in chunks:
                        p = greedy_assign_plain(blk.cpu(), req.cpu(),
                                                free.cpu(), seed_c)
                        out["err"][kernel] = max(out["err"][kernel],
                                                 compare(r, p))
            else:
                check(set(launched) == {kernel} and launched[kernel] >= 1,
                      f"{label}: launches {launched} (want the dense "
                      "auction only)")
                out["err"][kernel] = max(out["err"][kernel], compare(
                    got, want, ("chosen", "assigned", "free_after")))
            del chunks
            timed = build_sharded_step(ps, mesh, eb_d, nf_d, af_d,
                                       assignment=assignment)
            ms = cuda_ms(lambda: timed(eb_d, nf_d, af_d, key,
                                       has_gang=False), reps=3)
            out["launches"][label] = launched[kernel]
            out["ms"][label] = ms
            print(f"{label}: every Decision field = single-device, "
                  f"{int(got.assigned.sum())} assigned, {kernel} launches "
                  f"{launched[kernel]}"
                  + (" (each chunk = greedy_assign_plain bitwise)"
                     if assignment == "greedy" and shape == MESH_SHAPES[0]
                     else "")
                  + f"; sharded step {ms:.3f} ms, single-device "
                  f"{out['single_ms'][assignment]:.3f} ms ({smi})")
    return out


def mesh_engine_phase(smi):
    """L2. The engine on the (2,4) mesh at bench-50k against the
    single-device engine, unsampled, same seed, pods stored first."""
    mesh = make_mesh([torch.device(MESH_DEVICE)] * 8)
    runs = {}
    for label, cfg in (("L2 mesh (2,4)", SchedulerConfig(mesh=mesh)),
                       ("L2 single-device", SchedulerConfig(
                           percentage_of_nodes_to_score=100))):
        nodes, pods = bench_workload(N_NODES, MESH_PODS)
        runs[label] = drive(cfg, nodes, pods, label, pods_first=True,
                            with_pv_controller=False)
        m, launches, c2b, per_pod, _placed = runs[label]
        print(path_line(label, m, launches, c2b, per_pod, MESH_PODS, smi))
    (m, launches, c2b, _pp, placed), (m1, _l1, c2b1, _pp1, placed1) = (
        runs["L2 mesh (2,4)"], runs["L2 single-device"])
    check(placed == placed1, "L2: the mesh engine's placements differ "
          "from the single-device engine's on "
          f"{sum(placed[k] != placed1.get(k) for k in placed)} pods")
    check(m["shortlist_width"] == 0 and m["sampled_batches"] == 0,
          "L2: the mesh engine ran the shortlist or sampled")
    # The mesh's Decision is whole on one device: one packed read a
    # batch, the single-device engine's.
    check((m["decision_fetches"], m["fetch_bytes_total"])
          == (m1["decision_fetches"], m1["fetch_bytes_total"]),
          f"L2: the mesh engine read {m['fetch_bytes_total']} B in "
          f"{m['decision_fetches']} fetches, the single-device engine "
          f"{m1['fetch_bytes_total']} B in {m1['decision_fetches']}")
    n_chunks = BATCH // _chunk_size(BATCH // 2)
    check(launches.get("greedy_assign", 0) >= m["batches"] * n_chunks
          and set(launches) >= {"greedy_assign"},
          f"L2: greedy launches {launches} for {m['batches']} batches")
    print(f"L2: placements = single-device on all {MESH_PODS} pods; "
          f"greedy launches booked {launches.get('greedy_assign', 0)} "
          f"({m['batches']} batches); decision reads "
          f"{m['decision_fetches']}, {m['fetch_bytes_total']} B, as "
          f"single-device; create-to-bound {c2b:.3f} s, "
          f"single-device {c2b1:.3f} s ({smi})")
    return {"launches": launches, "burst_s": c2b, "single_burst_s": c2b1,
            "batches": m["batches"]}


def _child_pids(marker: str) -> list:
    """This process's children whose command line holds ``marker``."""
    me, out = os.getpid(), []
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
            with open(f"/proc/{d}/cmdline", "rb") as f:
                cmd = f.read()
        except (OSError, ValueError, IndexError):
            continue
        if ppid == me and marker.encode() in cmd:
            out.append(int(d))
    return out


def mesh_dcn_phase(smi):
    """L3. The two-process dryrun on the card, its workers watched while
    they run."""
    before = dict(LAUNCHES)
    apps0 = len(compute_apps())
    result = {}

    def run():
        try:
            result["out"] = run_dcn_dryrun(nprocs=2, timeout_s=240.0)
        except BaseException as e:  # re-raised below, on this thread
            result["error"] = e

    t = time.perf_counter()
    th = threading.Thread(target=run, name="dcn-dryrun")
    th.start()
    seen, held, contexts = set(), set(), 0
    while th.is_alive():
        pids = _child_pids("dcn_dryrun")
        seen.update(pids)
        for pid in pids:
            try:
                if holds_card(pid):
                    held.add(pid)
            except OSError:
                pass
        if len(held) >= 2:
            contexts = max(contexts, len(compute_apps()) - apps0)
        th.join(0.05)
    wall = time.perf_counter() - t
    if "error" in result:
        raise result["error"]
    lines = [ln for ln in result["out"].splitlines()
             if ln.startswith("DCN-OK")]
    check(sorted(ln.split(":")[0] for ln in lines) == ["DCN-OK 0",
                                                       "DCN-OK 1"],
          f"L3: DCN-OK lines {lines}")
    check(all("DCN == single-device" in ln and "16/16 scheduled" in ln
              for ln in lines), f"L3: {lines}")
    check(len(seen) == 2, f"L3: {len(seen)} worker processes seen")
    check(len(held) == 2, f"L3: {len(held)} worker(s) seen holding the card")
    check(contexts >= 2, f"L3: nvidia-smi's compute processes rose by "
          f"{contexts}, not two")
    check(dict(LAUNCHES) == before, "L3: this process booked a launch")
    staged = sorted({ln.split("staged through host: ")[1].split(";")[0]
                     for ln in lines})
    for ln in lines:
        print(f"L3 {ln}")
    print(f"L3: two gloo workers on {MESH_DEVICE} in {wall:.1f} s, both "
          f"holding the card (+{contexts} contexts), gloo ops staged "
          f"through host: {staged}; no launch here ({smi})")
    return {"s": wall, "staged": staged, "contexts": contexts}


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
    t_script = time.perf_counter()
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
    # E1. the explain step at full width, cuda = cpu
    explain_step_pair("bench", plugin_set, (eb, nf, af), key, smi,
                      has_gang=False, hard_spread=False)

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
    del got, plain, _sel, s_sel, s_greedy
    # A. the widths the overload tuner sets, at this shape
    t_phase = time.perf_counter()
    tuner, tuner_err = tuner_widths_phase(smi, s_scores, s_args, sseed)
    for name, e in tuner_err.items():
        err[name] = max(err[name], e)
    print(f"phase A in {time.perf_counter() - t_phase:.1f} s")
    del s_scores, s_args, nf_s
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
    # E1. config 4 hard's explain step: the shortlist kernels, no caps
    t_phase = time.perf_counter()
    explain_c4_step_phase(smi, key)
    print(f"phase E1 (config 4 hard) in {time.perf_counter() - t_phase:.1f} s")

    # 11. the bench main path: SchedulerConfig(), the default cycle
    nodes, pods = bench_workload(N_NODES, N_PODS)
    picked = []
    m, main_launches, c2b, per_pod, main_placed = drive(
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
    main_m = m
    clone = native.status()
    check(clone["native"], f"the native clone is not loaded: {clone}")
    print(f"native clone: loaded from {os.path.relpath(clone['path'])}, "
          + (f"built at first use in {clone['build_s']:.2f} s"
             if clone["built"] else "found built")
          + f"; phase 11's bind {m['bind_s_total']:.3f} s, create-to-bound "
          f"{c2b:.3f} s ({smi})")

    # E2. the explain burst at bench-50k
    t_phase = time.perf_counter()
    explain_launches, explain_c2b, explain_ingest, explain_peak = \
        explain_burst_phase(smi, main_m)
    print(f"phase E2 in {time.perf_counter() - t_phase:.1f} s")

    # B-C. the main path armed: timeline, SLO sentinel, overload
    # controller, journal and trace recorder; one batch's device trace
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as trace_dir:
        armed_main_path_phase(smi, main_placed, trace_dir)
    del main_placed
    print(f"phases B-C in {time.perf_counter() - t_phase:.1f} s")

    # 12. the volume slice's main path: full_scheduler_profile() through
    # Cluster(...).start() with SchedulerConfig(), a fifth of the pods
    # holding a Bound claim on a zone-labelled PV
    t_phase = time.perf_counter()
    # Every claim is Bound before the burst, so the PV controller has
    # nothing to bind; it is off, as in bench.py's engine cells (it relists
    # every claim and PV on each claim-carrying pod event).
    first, pods = full_workload(N_NODES, CUT_PODS)
    m, full_launches, c2b, per_pod, _ = drive(
        SchedulerConfig(platform=""), first, pods, "full profile",
        FULL_PROFILE, with_pv_controller=False)
    b = m["batches"]
    for name in ("shortlist_select", "shortlist_scan"):
        check(full_launches[name] >= b > 0,
              f"full profile: {name} launched {full_launches[name]} times in "
              f"{b} batches")
    check(m["zone_bound_claims"] == CUT_PODS // 5,
          f"full profile: {m['zone_bound_claims']} zone-bound claims placed")
    print(path_line(f"full profile (default config, 15 filters, 7 scorers, "
                    f"DefaultPreemption; {CUT_PODS // 5} pods with a Bound "
                    f"claim on a zone-labelled PV) {N_NODES} nodes x "
                    f"{CUT_PODS} pods", m, full_launches, c2b, per_pod,
                    CUT_PODS, smi)
          + f"; {m['sampled_batches']} of {b} batches sampled; every pod "
            "in its PV's zone, no claim on two nodes, no node over its "
            "attach limit; device free/used_ports = host mirror bitwise")
    del first, pods
    print(f"phase 12 in {time.perf_counter() - t_phase:.1f} s")

    # 13. config 4 soft, the main path of the topology slice: the default
    # config, BASELINE config 4's profile (DefaultPreemption on),
    # make_c4_workload's burst
    t_phase = time.perf_counter()
    nodes, pods = c4_workload(N_NODES, CUT_PODS)
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
    check(b == -(-CUT_PODS // SchedulerConfig().max_batch_size),
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
                    f"{CUT_PODS} pods", m, c4_launches, c2b, per_pod, CUT_PODS,
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

    # D. the overload ladder on the card, on the same cluster
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as scratch:
        ladder_phase(smi, scratch)
    print(f"phase D in {time.perf_counter() - t_phase:.1f} s")

    # 20. the auction kernels vs their plain versions on the card
    t_phase = time.perf_counter()
    au = auction_kernels_phase(smi, eb, nf, af, key)
    print(f"phase 20 in {time.perf_counter() - t_phase:.1f} s")

    # 21. the auction step, cuda = cpu, and no host sync when sampled
    t_phase = time.perf_counter()
    auction_step_phase(smi, eb, nf, af, key)
    print(f"phase 21 in {time.perf_counter() - t_phase:.1f} s")

    # 22-23. the auction's bursts: the bench burst and config 5's gangs
    t_phase = time.perf_counter()
    au_launches, au_c2b = auction_burst_phase(smi)
    print(f"phases 22-23 in {time.perf_counter() - t_phase:.1f} s")

    # 24. the auction under auction_mirror:corrupt and both cross-checks
    t_phase = time.perf_counter()
    au_check_launches = auction_fault_phase()
    print(f"phase 24 in {time.perf_counter() - t_phase:.1f} s")

    # 25. the README scenario on the card, default config
    run_scenario(default_scenario, config=SchedulerConfig(platform=""))
    print("README scenario: pod1 pending on NodeUnschedulable, then bound "
          "to node10")

    # E3. explain mode, cuda = cpu at the engine level
    t_phase = time.perf_counter()
    explain_parity_phase(smi)
    print(f"phase E3 in {time.perf_counter() - t_phase:.1f} s")
    # E4. the pod-chunked step at 8,192 x 53,248
    t_phase = time.perf_counter()
    chunk = chunked_step_phase(smi, key)
    print(f"phase E4 in {time.perf_counter() - t_phase:.1f} s")
    # E5. the brownout's explain pause
    t_phase = time.perf_counter()
    explain_brownout_phase(smi)
    print(f"phase E5 in {time.perf_counter() - t_phase:.1f} s")
    # E6. the demo scenario on the card
    t_phase = time.perf_counter()
    demo_phase()
    print(f"phase E6 in {time.perf_counter() - t_phase:.1f} s")
    # F. the device loop on the card
    t_phase = time.perf_counter()
    loop_launches, loop_c2b, off_placed, off_c2b, off_m = loop_phase(smi)
    print(f"phase F in {time.perf_counter() - t_phase:.1f} s")
    # G. the maintained index on the card
    t_phase = time.perf_counter()
    index_launches, index_c2b, view_ms, view_err = index_phase(
        smi, off_placed, off_c2b, off_m)
    del off_placed
    print(f"phase G in {time.perf_counter() - t_phase:.1f} s")
    # H. fused multi-tenant arbitration on the card
    t_phase = time.perf_counter()
    ten = tenant_phase(smi)
    print(f"phase H in {time.perf_counter() - t_phase:.1f} s")
    # I. the process surface: the engine over the wire, the remote
    # scenario, two profiles with a checkpoint
    t_phase = time.perf_counter()
    t_sub = {}
    wire = wire_phase(smi)
    t_sub["I1"] = time.perf_counter() - t_phase
    t = time.perf_counter()
    wire["client_engine_launches"] = remote_scenario_phase()
    t_sub["I2"] = time.perf_counter() - t
    t = time.perf_counter()
    profiles_phase(smi)
    t_sub["I3"] = time.perf_counter() - t
    print("phase I by part: " + ", ".join(f"{k} {v:.1f} s"
                                          for k, v in t_sub.items()))
    print(f"phase I in {time.perf_counter() - t_phase:.1f} s")
    # J. the in-process replicated fleet and the lifecycle oracle
    t_phase = time.perf_counter()
    t_sub = {}
    fleet = {"J1": fleet_placement_phase(smi)}
    t_sub["J1"] = time.perf_counter() - t_phase
    t = time.perf_counter()
    fleet["J2"] = failover_phase(smi)
    t_sub["J2"] = time.perf_counter() - t
    t = time.perf_counter()
    fleet["J3"] = oracle_phase(smi)
    t_sub["J3"] = time.perf_counter() - t
    print("phase J by part: " + ", ".join(f"{k} {v:.1f} s"
                                          for k, v in t_sub.items()))
    fleet["phase_s"] = time.perf_counter() - t_phase
    print(f"phase J in {fleet['phase_s']:.1f} s")
    fleet["script_s"] = time.perf_counter() - t_script
    print(f"script until phase J's end: {fleet['script_s']:.1f} s ({smi})")
    # K. the process fleet and the steward election: replica processes
    # on the card, and a CPU replica beside it
    t_phase = time.perf_counter()
    t_sub = {}
    proc = {}
    with replica_stderr():
        proc["K1"] = proc_fleet_phase(smi)
        t_sub["K1"] = time.perf_counter() - t_phase
        t = time.perf_counter()
        proc["K2"] = elect_phase(smi)
        t_sub["K2"] = time.perf_counter() - t
        t = time.perf_counter()
        proc["K3"] = cpu_replica_phase(smi)
        t_sub["K3"] = time.perf_counter() - t
    print("phase K by part: " + ", ".join(f"{k} {v:.1f} s"
                                          for k, v in t_sub.items()))
    proc["phase_s"] = time.perf_counter() - t_phase
    print(f"phase K in {proc['phase_s']:.1f} s")
    fleet["proc"] = proc
    fleet["script_s_k"] = time.perf_counter() - t_script
    print(f"script until phase K's end: {fleet['script_s_k']:.1f} s "
          f"({smi})")
    # L. the mesh: the sharded step, the engine on a virtual mesh, the
    # multi-process dryrun, on the card
    t_phase = time.perf_counter()
    t_sub = {}
    mesh = {"L1": mesh_step_phase(
        smi, *(to_torch(x, MESH_DEVICE) for x in (eb, nf, af)), key)}
    t_sub["L1"] = time.perf_counter() - t_phase
    t = time.perf_counter()
    mesh["L2"] = mesh_engine_phase(smi)
    t_sub["L2"] = time.perf_counter() - t
    t = time.perf_counter()
    mesh["L3"] = mesh_dcn_phase(smi)
    t_sub["L3"] = time.perf_counter() - t
    print("phase L by part: " + ", ".join(f"{k} {v:.1f} s"
                                          for k, v in t_sub.items()))
    mesh["phase_s"] = time.perf_counter() - t_phase
    mesh["script_s"] = time.perf_counter() - t_script
    print(f"phase L in {mesh['phase_s']:.1f} s; script until phase L's "
          f"end: {mesh['script_s']:.1f} s ({smi})")
    mesh_launches = {
        name: {**{k: v for k, v in mesh["L1"]["launches"].items()
                  if k.endswith(assignment)},
               "L2 engine (2,4), greedy": (
                   mesh["L2"]["launches"].get(name, 0))}
        for name, assignment in (("greedy_assign", "greedy"),
                                 ("auction", "auction"))}
    for h in ("h1", "h2"):
        for name in ("shortlist_select", "shortlist_scan"):
            err[name] = max(err[name], ten[h]["lanes"]["err"][name])
    lanes = ten["h1"]["lanes"]
    ck = chunk["kernels"]
    err["shortlist_select"] = max(err["shortlist_select"], ck["select_err"],
                                  view_err["shortlist_select"])
    err["shortlist_scan"] = max(err["shortlist_scan"], ck["scan_err"],
                                view_err["shortlist_scan"])

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
        "mesh": {"launches": mesh_launches["greedy_assign"],
                 "max_abs_err": mesh["L1"]["err"]["greedy_assign"]},
        "library_ms": None,
    }, {
        "name": "shortlist_select",
        "route": "cuda",
        "source": "minisched_tpu_torch/csrc/shortlist_select.cu",
        "replaces": "minisched_tpu/ops/select.py:144",
        "launches": full_launches["shortlist_select"],
        "launches_by_path": {"full profile": full_launches[
            "shortlist_select"], "bench": main_launches["shortlist_select"],
            "config 4 soft": c4_launches["shortlist_select"],
            "explain bench": explain_launches["shortlist_select"],
            "loop bench unsampled": loop_launches["shortlist_select"],
            "index bench unsampled": index_launches["shortlist_select"],
            "tenants fused (H1)": ten["h1"]["launches"]["shortlist_select"],
            "tenants fused indexed (H2)": ten["h2"]["launches"]["shortlist_select"],
            "wire bench (I1)": wire["launches"]["shortlist_select"],
            "fleet shard 0, r0 (J1)": fleet["J1"]["launches"]["r0"].get(
                "shortlist_select", 0),
            "fleet shard 0, r1 (J1)": fleet["J1"]["launches"]["r1"].get(
                "shortlist_select", 0),
            "fleet failover, r0 (J2)": fleet["J2"]["launches"]["r0"].get(
                "shortlist_select", 0),
            "fleet failover, r1 (J2)": fleet["J2"]["launches"]["r1"].get(
                "shortlist_select", 0),
            "lifecycle churn (J3)": fleet["J3"]["churn"]["launches"].get(
                "shortlist_select", 0),
            "process fleet, p0 process (K1)": proc["K1"]["launches"][
                "p0"].get("shortlist_select", 0),
            "process fleet, p1 process before its kill (K1)": proc["K1"][
                "launches"]["p1"].get("shortlist_select", 0)},
        "max_abs_err": err["shortlist_select"],
        "ms": s_select_ms,
        "plain_ms": s_select_plain_ms,
        "bound_ms": s_select_bound_s * 1e3,
        "bound_by": s_select_bound_by,
        "tuner_widths": tuner["shortlist_select"],
        "ms_full_width": select_ms,
        "plain_ms_full_width": select_plain_ms,
        "bound_ms_full_width": select_bound_s_ * 1e3,
        "ms_8192": ck["select_ms"],
        "plain_ms_8192": ck["select_plain_ms"],
        "bound_ms_8192": ck["select_bound_s"] * 1e3,
        "ms_index_view": view_ms["shortlist_select"],
        # The tenant-lane form: one launch for the first fused group of
        # H1 (T x 1,024 x 53,248), timed in turns against T solo
        # launches of the same lanes; launches_per_fused_group is the
        # mean of each fused group's own launches over H1 and H2.
        "lanes_shape": lanes["shape"],
        "ms_lanes": lanes["select_ms"],
        "ms_solo_lanes": lanes["select_solo_ms"],
        "plain_ms_lanes": lanes["select_plain_ms"],
        "bound_ms_lanes": lanes["select_bound_s"] * 1e3,
        "bound_by_lanes": lanes["select_bound_by"],
        "launches_per_fused_group": ten["launches_per_fused_group"][
            "shortlist_select"],
        "fused_groups": ten["fused_groups"],
        "library_ms": None,
    }, {
        "name": "shortlist_scan",
        "route": "cuda",
        "source": "minisched_tpu_torch/csrc/shortlist_scan.cu",
        "replaces": "minisched_tpu/ops/select.py:238",
        "launches": full_launches["shortlist_scan"],
        "launches_by_path": {"full profile": full_launches[
            "shortlist_scan"], "bench": main_launches["shortlist_scan"],
            "config 4 soft": c4_launches["shortlist_scan"],
            "explain bench": explain_launches["shortlist_scan"],
            "loop bench unsampled": loop_launches["shortlist_scan"],
            "index bench unsampled": index_launches["shortlist_scan"],
            "tenants fused (H1)": ten["h1"]["launches"]["shortlist_scan"],
            "tenants fused indexed (H2)": ten["h2"]["launches"]["shortlist_scan"],
            "wire bench (I1)": wire["launches"]["shortlist_scan"],
            "fleet shard 0, r0 (J1)": fleet["J1"]["launches"]["r0"].get(
                "shortlist_scan", 0),
            "fleet shard 0, r1 (J1)": fleet["J1"]["launches"]["r1"].get(
                "shortlist_scan", 0),
            "fleet failover, r0 (J2)": fleet["J2"]["launches"]["r0"].get(
                "shortlist_scan", 0),
            "fleet failover, r1 (J2)": fleet["J2"]["launches"]["r1"].get(
                "shortlist_scan", 0),
            "lifecycle churn (J3)": fleet["J3"]["churn"]["launches"].get(
                "shortlist_scan", 0),
            "process fleet, p0 process (K1)": proc["K1"]["launches"][
                "p0"].get("shortlist_scan", 0),
            "process fleet, p1 process before its kill (K1)": proc["K1"][
                "launches"]["p1"].get("shortlist_scan", 0)},
        "max_abs_err": err["shortlist_scan"],
        "ms": s_scan_ms,
        "plain_ms": s_scan_plain_ms,
        "bound_ms": s_scan_bound_s * 1e3,
        "bound_by": s_scan_bound_by,
        "tuner_widths": tuner["shortlist_scan"],
        "ms_full_width": scan_ms,
        "plain_ms_full_width": scan_plain_ms,
        "bound_ms_full_width": scan_bound_s_ * 1e3,
        "ms_8192": ck["scan_ms"],
        "plain_ms_8192": ck["scan_plain_ms"],
        "bound_ms_8192": ck["scan_bound_s"] * 1e3,
        "ms_index_view": view_ms["shortlist_scan"],
        # The tenant-lane form: one launch for the first fused group of
        # H1 (T x 1,024 x 53,248), timed in turns against T solo
        # launches of the same lanes; launches_per_fused_group is the
        # mean of each fused group's own launches over H1 and H2.
        "lanes_shape": lanes["shape"],
        "ms_lanes": lanes["scan_ms"],
        "ms_solo_lanes": lanes["scan_solo_ms"],
        "plain_ms_lanes": lanes["scan_plain_ms"],
        "bound_ms_lanes": lanes["scan_bound_s"] * 1e3,
        "bound_by_lanes": lanes["scan_bound_by"],
        "launches_per_fused_group": ten["launches_per_fused_group"][
            "shortlist_scan"],
        "fused_groups": ten["fused_groups"],
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
        "redesigned": True,
        "max_abs_err": caps_t["err"],
        "ms": caps_t["ms"],
        "us_per_pod": caps_t["us_per_pod"],
        "plain_ms": caps_t["plain_ms"],
        "bound_ms": caps_t["bound_s"] * 1e3,
        "bound_by": caps_t["bound_by"],
        "library_ms": None,
    }, {
        "name": "auction",
        "route": "cuda",
        "source": "minisched_tpu_torch/csrc/auction.cu",
        "replaces": "minisched_tpu/ops/auction.py:104",
        # The dense rounds run in the shortlist cross-check (and with
        # shortlist=False): launches of phase 24's fault-free run.
        "launches": au_check_launches["auction"],
        "redesigned": True,
        "max_abs_err": au["auction_err"],
        "ms": au[("sampled", None)]["ms"],
        "device_ms": au[("sampled", None)]["device_ms"],
        "spin_ms": au[("sampled", None)]["spin_ms"],
        "plain_ms": au[("sampled", None)]["plain_ms"],
        "bound_ms": au[("sampled", None)]["bound_s"] * 1e3,
        "bound_by": au[("sampled", None)]["bound_by"],
        "rounds": au[("sampled", None)]["rounds"],
        "ms_full_width": au[("full width", None)]["ms"],
        "bound_ms_full_width": au[("full width", None)]["bound_s"] * 1e3,
        "ms_full_width_3_bands": au[("full width, 3 bands", None)]["ms"],
        "ms_contention": au[("contention", None)]["ms"],
        "rounds_contention": au[("contention", None)]["rounds"],
        "mesh": {"launches": mesh_launches["auction"],
                 "max_abs_err": mesh["L1"]["err"]["auction"]},
        "library_ms": None,
    }, {
        "name": "bid_auction",
        "route": "cuda",
        "source": "minisched_tpu_torch/csrc/bid_auction.cu",
        "replaces": "minisched_tpu/ops/bid_select.py:76",
        "launches": au_launches["bench"]["bid_auction"],
        "launches_by_path": {
            "auction bench": au_launches["bench"]["bid_auction"],
            "config 5": au_launches["config 5"]["bid_auction"],
            "cross-checks": au_check_launches["bid_auction"]},
        "redesigned": True,
        "max_abs_err": au["bid_auction_err"],
        "ms": au[("sampled", K)]["ms"],
        "device_ms": au[("sampled", K)]["device_ms"],
        "spin_ms": au[("sampled", K)]["spin_ms"],
        "select_ms": au[("sampled", K)]["select_ms"],
        "plain_ms": au[("sampled", K)]["plain_ms"],
        "bound_ms": au[("sampled", K)]["bound_s"] * 1e3,
        "bound_by": au[("sampled", K)]["bound_by"],
        "tuner_widths": tuner["bid_auction"],
        "rounds": au[("sampled", K)]["rounds"],
        "ms_full_width": au[("full width", K)]["ms"],
        "select_ms_full_width": au[("full width", K)]["select_ms"],
        "bound_ms_full_width": au[("full width", K)]["bound_s"] * 1e3,
        "bursts_s": au_c2b,
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
    }], "explain": {
        "burst_s": explain_c2b, "pods": EXPLAIN_PODS,
        "ingest_s_per_batch": explain_ingest,
        "peak_device_gb": explain_peak / GB,
        "chunked_peak_gb": {label: {"chunked": v[0][True] / GB,
                                    "unchunked": v[0][False] / GB}
                            for label, v in chunk.items()
                            if label != "kernels"},
    }, "device_loop": {"burst_s": loop_c2b, "off_burst_s": off_c2b,
                       "pods": LOOP_PODS},
        "index": {"burst_s": index_c2b, "off_burst_s": off_c2b,
                  "pods": LOOP_PODS, "classes": INDEX_CLASSES},
        "tenants": {
            "tenants": TENANTS, "pods_per_tenant": TENANT_PODS,
            **{k: v for k, v in ten["h1"].items()
               if k not in ("lanes", "launches")},
            "indexed": {k: v for k, v in ten["h2"].items()
                        if k not in ("lanes", "launches")},
            "index_lanes_ms": {"select": ten["h2"]["lanes"]["select_ms"],
                               "scan": ten["h2"]["lanes"]["scan_ms"]}},
        "native_clone": native.status(),
        "wire": {k: v for k, v in wire.items() if k != "launches"},
        "fleet": fleet,
        "mesh": {"L1": {k: v for k, v in mesh["L1"].items()
                        if k != "err"},
                 "L2": mesh["L2"], "L3": mesh["L3"],
                 "phase_s": mesh["phase_s"],
                 "script_s": mesh["script_s"]}}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

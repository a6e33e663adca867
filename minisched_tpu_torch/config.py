"""Engine configuration.

Two tiers, as the reference has them (its config/config.go reads every
process setting from the environment, with typed errors):

  1. ``SchedulerConfig``: the engine knobs this package implements, with
     the JAX package's names and defaults (a knob joins together with
     its code), and ``config_from_env``, which reads them from the same
     ``MINISCHED_*`` variables.
  2. Scheduler profiles live in service/defaultconfig.py and
     service/config.py.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import torch


class EmptyEnvError(ValueError):
    """A ``MINISCHED_*`` variable that is set but empty (reference
    config.ErrEmptyEnv, config/config.go:18)."""


@dataclass
class SchedulerConfig:
    """Engine tuning knobs."""

    max_batch_size: int = 1024       # pods per scheduling step
    # Batch formation window (s): after the first pod arrives, keep
    # gathering until max_batch_size or this much time passes. 0 = pop
    # immediately.
    batch_window_s: float = 0.0
    # Stop gathering once no pod has arrived for this long (only with
    # batch_window_s > 0). 0 = pure-window behavior.
    batch_idle_s: float = 0.0
    pod_bucket_min: int = 16         # bucket ladder minimum (pad P)
    node_bucket_min: int = 16        # bucket ladder minimum (pad N)
    backoff_initial_s: float = 1.0   # reference queue.go:218-221
    backoff_max_s: float = 10.0
    # Explain mode: the step also returns every filter's mask and every
    # scorer's raw and normalized matrix, and the service's result store
    # publishes them as pod annotations (explain/resultstore.py). It
    # turns node sampling and the in-scan domain caps off: the recorded
    # columns must be the full node table, and the recorded spread
    # verdict upstream's static one.
    explain: bool = False
    # Host-selection strategy: "greedy" (priority-faithful sequential
    # semantics; the shortlist scan or the full greedy kernel) or
    # "auction" (parallel bidding rounds in descending priority bands,
    # aggregate-score-seeking: ops/auction.py lists how it departs from
    # the greedy contract; BASELINE config 5's opt-in). Both ride the
    # same residency carry (the host mirror's debit replay is an
    # order-free per-node aggregate) and shortlist knobs.
    assignment: str = "greedy"
    seed: int = 0                    # PRNG seed for tie-breaking parity
    bind_workers: int = 16           # async binding-cycle pool size
    # Pipelined engine cycle (engine/scheduler.py _run_pipelined): while
    # batch k's step runs on the device, the host flushes batch k-1's
    # commit work (store status writes, queue requeues, events) on a
    # commit worker and gathers batch k+1 from the queue on a gather
    # worker; batch k+1 is encoded only after batch k's arbitration and
    # assume accounting, so decisions equal the synchronous loop's.
    # False restores the strictly synchronous cycle.
    pipeline: bool = True
    # Device-resident dynamic cluster state + slim decision readback
    # (engine/scheduler.py _DeviceResidency, ops/residency.py): the
    # dynamic node-feature leaves (free/used_ports) stay loop-carried on
    # the device — the step's free_after is the next batch's input — and
    # the host uploads only sparse correction rows where its cache
    # diverged from the device's view (revocations, failed binds,
    # informer churn); the per-batch decision fetch packs bool planes as
    # bits and narrows counts to i16. Decisions are bit-identical either
    # way. False restores the upload-every-batch path and the all-i32
    # fetch.
    device_resident: bool = True
    # Shortlist-compressed arbitration (ops/select.py
    # greedy_assign_shortlist, wired through ops/pipeline.build_step):
    # the greedy scan's per-pod argmax runs over per-pod top-K candidate
    # shortlists computed in one parallel pass, with an exactness
    # certificate per step and a counted full-row repair where it fails
    # — decisions are bit-identical to the full scan. False restores the
    # full-width greedy kernel.
    shortlist: bool = True
    # Shortlist width K: per-step sequential argmax width, clamped to the
    # node pad. Widen it if shortlist_repairs climbs (contention
    # exhausting K candidates forces full-row rescans).
    shortlist_k: int = 128
    # Node-axis sampling for the scoring step, the upstream
    # percentageOfNodesToScore analog. 0 = auto (upstream's
    # 50 - nodes/125, floored at 5); 100 = always evaluate every node.
    # A sampled batch that finds a pod 0-feasible re-checks it against
    # the full axis in the same cycle, so terminal verdicts never come
    # from a sample.
    percentage_of_nodes_to_score: int = 0
    # Never sample below this many candidate nodes (upstream
    # minFeasibleNodesToFind), and only sample at all when the cluster
    # is at least twice this size.
    min_sample_nodes: int = 256
    # In-cycle repair of topology-revoked pods (engine/scheduler.py
    # _repair_spread): after the host arbitration revokes placements that
    # would breach hard skew or required anti-affinity within the batch,
    # re-run the step on them up to this many times against the refreshed
    # counts (the survivors assumed), instead of a queue round trip and
    # backoff per tranche. 0 disables.
    spread_repair_iters: int = 8
    # Engine supervisor (engine/scheduler.py _Supervisor): per-batch
    # device-step watchdog deadline in seconds. A batch whose
    # dispatch-to-fetch window exceeds it counts a watchdog trip and
    # degrades the engine one ladder rung (the step completed; nothing
    # is retried). 0 disables the deadline; fault, NaN and desync
    # detection and the degradation ladder stay active regardless.
    watchdog_s: float = 0.0
    # Probation length for the degradation ladder: after this many
    # consecutive clean batches at a degraded level, the supervisor
    # climbs one rung back toward the full fast path
    # (resident -> upload-every-batch -> synchronous -> quarantine).
    probation_batches: int = 8
    # Shortlist certification cross-check: every N batches re-run the
    # same inputs through the full-width greedy assignment and compare
    # decisions. A divergence counts a shortlist_desync, permanently
    # reverts the engine to the full kernel, and aborts the batch into
    # the supervised retry. 0 disables (the certificate already proves
    # equality per step; the check covers defects outside the proof,
    # such as a scribbled readback, which the shortlist_repair:corrupt
    # fault gate models).
    shortlist_check_every: int = 0
    # Residency carry cross-check: every N device-resident batches,
    # fetch the carried free array and compare it to the host mirror
    # before the step consumes it. A mismatch counts a desync, forces a
    # full re-upload and degrades the engine one rung. 0 disables.
    resident_check_every: int = 0
    # Device loop (engine/scheduler.py tranche machinery +
    # ops/pipeline.build_loop_step): when the queue holds several ready
    # batches of loop-safe pods (no gangs, pod (anti-)affinity, spread
    # constraints, volumes or host ports: the workloads whose decisions
    # are independent of the host state the ring cannot carry), the
    # engine stages up to ``loop_depth`` encoded batches at one pod pad
    # and runs them as one tranche: each slot's step takes the previous
    # slot's ``free_after`` on the device, every slot's packed decision
    # lands in one stacked device buffer, and the host reads the whole
    # tranche back in one transfer. Between slots the engine checks
    # host truth against the carried chain (cache.drain_dyn_rows) and
    # breaks back to per-batch dispatch on any divergence, replaying
    # the unconsumed slots with their original PRNG draws: decisions
    # are bit-identical loop on or off. Only unsampled batches ride the
    # ring (a sampled step draws another key path). False keeps
    # per-batch dispatch exactly.
    device_loop: bool = False
    # Work-ring depth: the most batches one tranche runs. The overload
    # tuner halves the effective depth per tune step.
    loop_depth: int = 8
    # Maintained arbitration index (ops/index.py +
    # engine/scheduler._ArbIndex): per-pod-class score rows stay on the
    # device across batches in a (C,N) matrix that the cache's sparse
    # deltas repair in place, so a steady-state batch skips the (P,N)
    # filter+score pass and runs only a gather of its pods' class rows
    # and the certified shortlist scan over them. A batch with an
    # unassigned live row discards the speculative result and
    # re-dispatches the full step with the same PRNG draw, so decisions
    # are bit-identical index on or off. Engages only for eligible
    # profiles (column-local plugins, row-local normalizes:
    # ops/index.index_eligible), the greedy assignment, and unsampled
    # batches of loop-safe pods. False keeps the per-batch dataflow.
    index: bool = False
    # Indexed-scan width K: the shortlist width over the gathered class
    # rows (exact at any width; in-scan repairs absorb a narrow one).
    # The overload tuner's K-dial retunes it live, with no rebuild.
    index_k: int = 128
    # Most registered pod classes (the class axis of the (C,N) matrix,
    # padded to a power-of-two bucket). A class is a pod's whole
    # feature row, its name suffix included; a batch whose pods exceed
    # the registry takes the full step (a counted fallback).
    index_classes: int = 64
    # Index cross-check: every N index-served batches, re-run the
    # batch's inputs through the full step and compare decisions. A
    # divergence counts an index_desync, disables the index for good
    # and aborts the batch into the supervised retry. 0 disables.
    index_check_every: int = 0
    # Device of the scheduling step: "" = the first CUDA device (raises
    # when there is none), "cpu", "cuda" or "cuda:<n>".
    platform: str = ""

    def device(self) -> torch.device:
        """The step's device. ``platform=""`` means ``cuda:0`` and never
        falls back to the CPU."""
        dev = torch.device(self.platform or "cuda:0")
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"SchedulerConfig.platform={self.platform!r} needs a CUDA "
                "device and none is available; pass platform='cpu' to run "
                "on the CPU")
        return dev


def config_from_env() -> SchedulerConfig:
    """``SchedulerConfig`` from the ``MINISCHED_*`` variables (the
    reference reads all its config from the environment,
    config/config.go:22-44). An unset variable takes the field's
    default; a set but empty one raises ``EmptyEnvError``.
    ``MINISCHED_PLATFORM`` names the device: unset or "" means
    ``cuda:0``, which raises at start without a card. The knobs of
    modules this package does not have yet (``MINISCHED_MESH_DEVICES``
    other than 0, a ``MINISCHED_COMPILE_CACHE`` directory) raise a
    ``ValueError`` rather than run without them."""

    def _req(name: str, default: str) -> str:
        v = os.environ.get(name, default)
        if v == "":
            raise EmptyEnvError(f"env {name} is empty")
        return v

    if int(os.environ.get("MINISCHED_MESH_DEVICES", "0")):
        raise ValueError(
            "MINISCHED_MESH_DEVICES: this package has no multi-device "
            "step yet; unset it or set it to 0")
    if os.environ.get("MINISCHED_COMPILE_CACHE", ""):
        raise ValueError(
            "MINISCHED_COMPILE_CACHE: this package has no persistent "
            "step cache yet; unset it")
    return SchedulerConfig(
        max_batch_size=int(_req("MINISCHED_MAX_BATCH", "1024")),
        batch_window_s=float(_req("MINISCHED_BATCH_WINDOW", "0.0")),
        batch_idle_s=float(_req("MINISCHED_BATCH_IDLE", "0.0")),
        explain=_req("MINISCHED_EXPLAIN", "0") == "1",
        assignment=_req("MINISCHED_ASSIGNMENT", "greedy"),
        seed=int(_req("MINISCHED_SEED", "0")),
        backoff_initial_s=float(_req("MINISCHED_BACKOFF_INITIAL", "1.0")),
        backoff_max_s=float(_req("MINISCHED_BACKOFF_MAX", "10.0")),
        platform=os.environ.get("MINISCHED_PLATFORM", ""),
        percentage_of_nodes_to_score=int(
            _req("MINISCHED_PCT_NODES_TO_SCORE", "0")),
        pipeline=_req("MINISCHED_PIPELINE", "1") != "0",
        device_resident=_req("MINISCHED_DEVICE_RESIDENT", "1") != "0",
        shortlist=_req("MINISCHED_SHORTLIST", "1") != "0",
        shortlist_k=int(_req("MINISCHED_SHORTLIST_K", "128")),
        shortlist_check_every=int(
            _req("MINISCHED_SHORTLIST_CHECK_EVERY", "0")),
        device_loop=_req("MINISCHED_DEVICE_LOOP", "0") == "1",
        loop_depth=int(_req("MINISCHED_LOOP_DEPTH", "8")),
        index=_req("MINISCHED_INDEX", "0") == "1",
        index_k=int(_req("MINISCHED_INDEX_K", "128")),
        index_classes=int(_req("MINISCHED_INDEX_CLASSES", "64")),
        index_check_every=int(_req("MINISCHED_INDEX_CHECK_EVERY", "0")),
        watchdog_s=float(_req("MINISCHED_WATCHDOG", "0.0")),
        probation_batches=int(_req("MINISCHED_PROBATION_BATCHES", "8")),
        resident_check_every=int(
            _req("MINISCHED_RESIDENT_CHECK_EVERY", "0")),
    )

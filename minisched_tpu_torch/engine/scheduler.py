"""Core scheduling engine: batched cycles over the step.

Rebuild of reference minisched/minisched.go + initialize.go. One cycle
(reference scheduleOne, minisched.go:32-112) becomes one *batch* cycle,
three phases:

  prepare  pop batch → priority sort → encode pods (each pod's volume
           state resolved once) → snapshot node features (cache) →
           tensors on the device (with device residency: sparse
           corrections to the carried free/used_ports; capacity
           nominated to preemptors outside the batch reserved)
           → step (on K sampled nodes at >= 2 × min_sample_nodes): filters
           ∧ → scores → normalize → weigh → sum → capacity-aware
           assignment (greedy: the shortlist scan or the full greedy
           kernel on a card; ``assignment="auction"``: the bid-shortlist
           or the dense auction kernel) → pack the decision on the device
  resolve  read the packed decision back (one fetch) → replay the
           device's debits and port insertions into the residency mirror
           → the full-axis residual pass for pods the sample found no
           node for → the explain recorder (explain mode: the step's
           per-plugin stacks to the result store) → the RWO arbitration
           (arbitrate_rwo) and the topology arbitration (hard skew and
           required anti-affinity within the batch, arbitrate_spread)
           → per pod: assume + permit
           plugins (host) or a failure verdict → the in-cycle repair of
           revoked pods (_repair_spread) → the preemption pass for
           terminally unschedulable pods (DefaultPreemption,
           _try_preempt) → async bulk bind
  commit   flush the batch's failure verdicts in bulk, fold the metrics

With ``config.pipeline`` (the default) the loop is the bounded two-deep
pipeline of ``_run_pipelined``; otherwise the three phases run back to
back on the scheduling thread.

Observability and overload control (each hook one attribute test while
unarmed): the phase and gap clocks, the lifecycle histograms and the
per-pod provenance in ``metrics()`` / ``provenance()``; the snapshot
ring, the SLO sentinel (whose alerts warn the supervisor) and the
overload ladder (engine/overload.py: smaller batches and a retuned
shortlist K, admission shedding, brownout's node sampling) at snapshot
cadence; incident bundles (obs/bundle.py); ``dump_trace`` and
``trace_next_batch``.

A supervisor (``_Supervisor``) contains batch faults: a raised phase, a
readback that fails its sanity check, a resident carry that left its
host mirror, a shortlist decision the full-width scan disagrees with.
The batch's assumes are rolled back and it is replayed with the PRNG
rewound (so it decides as the fault-free run would), one rung further
down the degradation ladder resident → upload → sync → quarantine;
clean batches climb back up after ``probation_batches``.

The scheduler "assumes" a pod onto its node at selection time (cache
accounting) and unassumes on any later failure — upstream
kube-scheduler's assume/forget model.

Failure path mirrors ErrorFunc (minisched.go:283-298): record the
rejecting plugins on the pod status, emit a FailedScheduling event, park
the pod in unschedulableQ keyed by those plugins for event-driven revival.
"""
from __future__ import annotations

import contextlib
import logging
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Set

import numpy as np
import torch

from ..config import SchedulerConfig
from ..encode import NodeFeatureCache, encode_pods, to_torch
from ..encode.cache import SymBatch, bucket_for, static_token, step_bucket
from ..encode.features import GangFeatures
from ..errors import ConflictError, NotFoundError
from ..faults import FAULTS, FaultWorkerDeath
from ..fleet.shardmap import shard_of
from ..obs import GC_WATCH, Histogram, instant, span
from ..obs import bundle as bundle_mod
from ..obs import slo as slo_mod
from ..obs.journal import JOURNAL, ProvenanceStore
from ..obs.journal import note as jnote
from ..obs.timeseries import TIMELINE, TimelineTracker
from ..ops import prng
from ..ops.hostread import thread_reads
from ..ops._cuda_build import (KERNELS, enable_compile_cache,
                               thread_launches)
from ..ops.index import (build_index_ops, corrupt_slab, index_eligible,
                         unpack_index_decision)
from ..ops.pipeline import Decision, build_loop_step, build_step
from ..ops.residency import (I16_SAT, apply_rows, apply_rows_bytes,
                             insert_ports, insert_ports_bytes,
                             pack_decision_i32, pack_decision_slim,
                             replay_ports_host, unpack_decision_i32,
                             unpack_decision_slim)
from ..plugins.base import PluginSet
from ..state.events import ActionType, ClusterEvent, EventBroadcaster, GVK
from ..state.objects import (CLAIM_UNUSED, CLOUD_VOLUME_AXES, Pod,
                             claim_keys, gang_key)
from . import overload as overload_mod
from .clusterstate import SharedClusterState
from .queue import (BATCH_CAPACITY, COSCHEDULING, QueuedPodInfo,
                    SchedulingQueue)
from .waitingpod import WaitingPod

log = logging.getLogger(__name__)

# Shared by the arbitration and repair-leftover failure paths — the two
# must never diverge on reason text or plugin attribution.
_SPREAD_REVOKE_MSG = (
    "placement would breach a topology constraint (max_skew / required "
    "anti-affinity) within this batch; retrying against committed counts")


class EngineDesync(RuntimeError):
    """A supervisor detector's verdict: the engine's view of device state
    failed a sanity or cross check (decision readback out of range,
    non-finite capacity after a device-debit replay, resident carry
    diverged from the host mirror, shortlist decisions diverged from the
    full-width scan). Contained like any batch fault: rollback, degrade,
    retry."""


#: The supervisor's degradation ladder, fastest first. Level indexes it.
DEGRADATION_LADDER = ("resident", "upload", "sync", "quarantine")

#: SLO early-warning pre-arming (obs/slo.py → _Supervisor.early_warning):
#: a burning SLO arms the per-batch watchdog at this fallback deadline
#: for this many batches even when ``watchdog_s`` is unset, so the
#: sentinel's trend verdict buys the ladder a tripwire before a wedged
#: step forces the exception path.
SLO_PREARM_BATCHES = 64
SLO_PREARM_WATCHDOG_S = 30.0


class _Supervisor:
    """Fault detection and containment state for one engine.

    A batch that faults is retried down a counted degradation ladder:

        0 resident    the full fast path (device residency + pipeline)
        1 upload      residency dropped; every batch uploads the dynamic
                      leaves (the device_resident=False shape)
        2 sync        additionally no pipelining: one batch at a time,
                      prepare → resolve → commit inline
        3 quarantine  the poisoned batch is requeued at the backoff
                      ceiling instead of retried; later traffic keeps
                      running at the sync rung

    ``level`` is written only on the scheduling thread, the one thread
    that also reads it for gating, so it needs no lock; counters live in
    the engine's metrics under its lock. After ``probation_batches``
    consecutive clean batches at a degraded level the supervisor climbs
    one rung back toward the full fast path."""

    __slots__ = ("_sched", "level", "_clean", "prearm")

    def __init__(self, sched: "Scheduler"):
        self._sched = sched
        self.level = 0
        self._clean = 0
        # Batches left on the SLO early-warning posture: while > 0 the
        # watchdog runs at SLO_PREARM_WATCHDOG_S even with the knob
        # unset. Scheduling-thread only, like ``level``.
        self.prearm = 0

    def allows_residency(self) -> bool:
        return self.level == 0

    def sync_only(self) -> bool:
        return self.level >= 2

    def escalate(self, reason: str) -> None:
        self._clean = 0
        if self.level >= len(DEGRADATION_LADDER) - 1:
            return
        self.level += 1
        s = self._sched
        s._sup_count("supervisor_escalations")
        instant("supervisor.escalate", to=DEGRADATION_LADDER[self.level],
                level=self.level, reason=reason)
        if JOURNAL.enabled:
            jnote("supervisor.escalate", profile=s.profile,
                  replica=s.replica, frm=DEGRADATION_LADDER[self.level - 1],
                  to=DEGRADATION_LADDER[self.level], level=self.level,
                  reason=reason, batch=s._batch_seq, step=s._step_counter)
        log.warning("supervisor: degraded to %r (%s)",
                    DEGRADATION_LADDER[self.level], reason)

    def early_warning(self, reason: str) -> None:
        """SLO sentinel input (obs/slo.py): a burning objective is a
        leading indicator of the faults the ladder contains. Two counted,
        reversible reactions: the probation counter resets (a degraded
        engine cannot climb back while its SLO burns), and the per-batch
        watchdog is pre-armed for the next SLO_PREARM_BATCHES batches
        even when ``watchdog_s`` is unset. No rung changes here: the
        sentinel warns, the detectors decide."""
        s = self._sched
        self._clean = 0
        self.prearm = SLO_PREARM_BATCHES
        s._sup_count("supervisor_early_warnings")
        instant("supervisor.early_warning", reason=reason, level=self.level)
        if JOURNAL.enabled:
            jnote("supervisor.early_warning", profile=s.profile,
                  replica=s.replica, reason=reason, level=self.level,
                  batch=s._batch_seq)
        log.warning("supervisor: SLO early warning (%s); probation "
                    "extended, watchdog pre-armed for %d batches",
                    reason, SLO_PREARM_BATCHES)

    def note_clean(self) -> None:
        """One batch resolved with no fault: probation bookkeeping. While
        any SLO burns the engine cannot climb (clean batches during a burn
        do not count toward probation) and the watchdog pre-arm stays
        topped up, also at level 0: a continuous burn fires one
        rising-edge alert only."""
        s = self._sched
        burning = s._slo_burning_any()
        if burning:
            self.prearm = SLO_PREARM_BATCHES
        if self.level == 0:
            return
        if burning:
            self._clean = 0
            return
        self._clean += 1
        if self._clean >= max(1, s.config.probation_batches):
            self._clean = 0
            self.level -= 1
            s._sup_count("supervisor_recoveries")
            instant("supervisor.recover",
                    to=DEGRADATION_LADDER[self.level], level=self.level)
            if JOURNAL.enabled:
                jnote("supervisor.recover", profile=s.profile,
                      replica=s.replica,
                      frm=DEGRADATION_LADDER[self.level + 1],
                      to=DEGRADATION_LADDER[self.level], level=self.level,
                      batch=s._batch_seq)
            log.info("supervisor: probation passed; re-escalated to %r",
                     DEGRADATION_LADDER[self.level])


class _Batch:
    """One batch moving through prepare → resolve → commit."""

    __slots__ = ("batch", "eb", "eb_dev", "nf", "af", "key", "sample_k",
                 "names", "row_incs", "decision", "packed_dev",
                 "spread_dev", "fail_closed", "vol_memo", "nom_reserved",
                 "res_carried", "failures", "n_assigned", "launches",
                 "sl_repairs", "assumed", "detached", "seq", "t0",
                 "t_enc0", "t_encode", "t_dispatch", "t_fetch_start",
                 "t_fetched", "t_resolved", "commit_t0", "commit_t1",
                 "gap", "h2d0", "fetch0", "h2d1", "fetch1", "scored_rows",
                 "shapes", "step_share", "loop_slot", "index_mode",
                 "index_packed_dev", "index_free_after", "tenant_ticket",
                 "c0", "c_encode", "c_fetched", "c_resolved", "syncs",
                 "sync_s", "step_events", "device_span_s")

    def __init__(self):
        # Inter-batch gap components (gather/encode/commit) booked since
        # the previous prepare and adopted by this batch (_book_gap).
        self.gap: Dict[str, float] = {}
        self.commit_t0 = self.commit_t1 = 0.0
        self.seq = 0
        # The scheduling thread's CPU clock (time.thread_time) at t0,
        # t_encode, t_fetched and t_resolved: the prepare and resolve
        # windows' own CPU beside their wall time.
        self.c0 = self.c_encode = self.c_fetched = self.c_resolved = 0.0
        # Blocking reads the step made inside its ops (ops/hostread: the
        # gang admission's, the caps' any_enforced) and their seconds.
        self.syncs = 0
        self.sync_s = 0.0
        # The (start, end) CUDA timing events around the solo step's
        # dispatch and pack, read after the decision fetch into
        # device_span_s (seconds); None off the card and on every other
        # path.
        self.step_events = None
        self.device_span_s = 0.0
        # Transfer ledger at prepare and after resolve: the per-batch
        # series' byte deltas.
        self.h2d0 = self.fetch0 = self.h2d1 = self.fetch1 = 0.0
        # Plugin evaluations the main step paid, pod rows × node rows.
        self.scored_rows = 0
        self.shapes = (0, 0, 0)  # padded (P, N, A)
        self.failures: List[tuple] = []  # (qpi, plugins, message, retryable)
        self.n_assigned = 0
        self.decision: Optional[Decision] = None
        self.packed_dev = None
        # The spread-arbitration inputs packed on the device, staged only
        # for batches the host must arbitrate (a DoNotSchedule slot or a
        # required anti-affinity term); None otherwise.
        self.spread_dev = None
        # Pods whose hard constraint the encoding could not represent:
        # key → (plugin, reason); they fail closed at resolve.
        self.fail_closed: Dict[str, tuple] = {}
        # Pod key → _volume_state tuple, resolved once at encode; the RWO
        # arbitration and the spread repair read the encode-time claim
        # rows from it.
        self.vol_memo: Dict[str, tuple] = {}
        # The nomination reserve subtracted from a carried ``free`` input
        # (device (N,R)), added back before free_after is adopted.
        self.nom_reserved = None
        # This batch's free/used_ports input is the device-resident chain:
        # its free_after is carried and its debits replayed into the host
        # mirror at resolve time.
        self.res_carried = False
        self.launches: Dict[str, int] = {}  # kernel launches by name
        self.sl_repairs = 0
        # Rollback ledger: pods this batch assumed that no async owner
        # took over yet (key → qpi), and the pods an owner (the binder's
        # bulk commit, a permit wait) now holds.
        self.assumed: Dict[str, QueuedPodInfo] = {}
        self.detached: Set[str] = set()
        # Device-loop slot: this batch's share of its tranche's window
        # (the tranche's dispatch-to-fetch time over its slots) and its
        # ring slot; the share stands in for the dispatch-to-fetch stamps
        # in the watchdog and step_s_total, so a tranche is not booked
        # (or judged) once per slot. None on the per-batch path.
        self.step_share: Optional[float] = None
        self.loop_slot: Optional[int] = None
        # Maintained index: "off" | "hit" | "fused-hit" | "fallback"
        # (provenance), the speculative scan's [chosen | assigned |
        # repaired] buffer that resolve settles, and its carried
        # free_after (adopted by residency when the index serves the
        # batch; a fused lane's free after its fused step too).
        self.index_mode = "off"
        self.index_packed_dev = None
        self.index_free_after = None
        # Fused multi-tenant lane ticket (encode/cache.TenantCacheMux):
        # set between the prepare's submit and the mux's fused dispatch,
        # which fills packed_dev (a host tuple; or index_packed_dev, a
        # host row) and index_free_after and clears it. Resolve refuses a
        # batch whose ticket is still armed.
        self.tenant_ticket = None


def _count_launches(b: _Batch, fn, *args, **kwargs):
    """Run ``fn`` and book the kernel launches and the blocking reads of
    the card it made into ``b``: the calling thread's deltas, which are
    this call's alone even while another engine of the process runs."""
    counts = thread_launches()
    before = dict(counts)
    reads = thread_reads()
    n0, s0 = reads
    out = fn(*args, **kwargs)
    for name, n in counts.items():
        if n != before[name]:
            b.launches[name] = b.launches.get(name, 0) + n - before[name]
    b.syncs += reads[0] - n0
    b.sync_s += reads[1] - s0
    return out


def _pack_spread(d: Decision) -> torch.Tensor:
    """The spread-arbitration inputs as one (2P+2, G) float32 buffer, one
    fetch: pre-counts, chosen-domain ids, the per-group pre-batch min and
    the in-scan enforcement flags. Domain ids and counts are < 2**24,
    exact in float32."""
    return torch.cat([d.spread_pre, d.spread_dom.to(torch.float32),
                      d.spread_min[None, :],
                      d.scan_groups.to(torch.float32)[None, :]], dim=0)


def _device_copy(a: np.ndarray, device) -> torch.Tensor:
    """A device tensor that never shares memory with ``a`` (on the CPU
    ``from_numpy(a).to("cpu")`` would alias the host mirror)."""
    return torch.tensor(a, device=device)


class _DeviceResidency:
    """Loop-carried device residency of the dynamic node-feature leaves
    (``free`` / ``used_ports``): the step's ``free_after`` stays on the
    device as the next batch's input, and the host uploads only sparse
    host-truth corrections (ops/residency.apply_rows) for the rows where
    its cache diverged from the device's optimistic view — revoked
    placements, failed binds, informer churn and node lifecycle all
    surface through the cache's DynDeltaListener. ``used_ports`` carries
    its own optimistic update: the batch's host-port insertions run on
    the resident copy (ops/residency.insert_ports, the CUDA kernel on a
    card) and are replayed into the host mirror in the same integer op
    order (note_ports), so a port-heavy steady state stays upload-free.

    Invariants (held end to end by tests/test_torch_residency.py and
    tests/test_torch_engine.py against the JAX engine):

      I1. the host mirrors equal the device arrays: the mirror replay is
          an order-free per-node debit aggregate (the batch's requests
          summed per debited node with ``np.add.at``, then one subtract
          per node). Every request and capacity component is an
          integer-valued f32 inside the 2**24 exact-integer window, so
          the aggregate equals the scan's sequential pod-order debits
          bitwise.
      I2. after ``attach`` the device arrays equal the cache's truth on
          every row, so the step consumes exactly what the
          upload-every-batch path would feed it.
      I3. the correction candidate set is complete: a row diverges only
          through a host mutation (the cache marks it into the listener)
          or a device debit (``note_debits`` records it with its
          pre-replay truth). The epoch counter carried on both sides
          turns any protocol break into a full re-upload (counted in
          ``residency_resyncs``), never a silent desync.
    """

    __slots__ = ("listener", "epoch", "free_dev", "ports_dev",
                 "mirror_free", "mirror_ports", "pending_rows",
                 "pending_pre", "pending_prows", "pending_ppre")

    def __init__(self, listener):
        self.listener = listener
        self.epoch = -1          # engine-side epoch; -1 = no device state
        self.free_dev = None     # device (N,R) f32 — next step input
        self.ports_dev = None    # device (N,PORT) i32
        self.mirror_free = None  # host twins of the device arrays
        self.mirror_ports = None
        self.pending_rows = None  # rows the last step debited (unique)
        self.pending_pre = None   # their pre-replay mirror rows
        self.pending_prows = None  # rows the last port insertion touched
        self.pending_ppre = None   # and their pre-insert mirror rows

    def attach(self, eng, nf, delta):
        """Bring the device-resident dynamic leaves up to host truth for
        this batch and splice them into ``nf``. ``delta`` None = full
        rebase (the snapshot returned real leaves and rebased the
        listener); else apply the sparse correction. Raises on epoch
        desync — the caller drops residency and re-snapshots."""
        dev = eng.device
        if delta is None:
            free_np, ports_np = nf.free, nf.used_ports
            self.free_dev = _device_copy(free_np, dev)
            self.ports_dev = _device_copy(ports_np, dev)
            # The snapshot copies are private — they become the mirrors.
            self.mirror_free, self.mirror_ports = free_np, ports_np
            self.epoch = self.listener.epoch
            self.pending_rows = self.pending_pre = None
            self.pending_prows = self.pending_ppre = None
            eng._res_count(resync=True,
                           h2d=free_np.nbytes + ports_np.nbytes)
            return nf._replace(free=self.free_dev,
                               used_ports=self.ports_dev)
        if delta.epoch != self.epoch + 1 or self.free_dev is None:
            raise RuntimeError(
                f"residency epoch desync: device at {self.epoch}, delta "
                f"at {delta.epoch}")
        self.epoch = delta.epoch
        h2d = 0
        self.free_dev, self.mirror_free, n = self._correct(
            self.free_dev, self.mirror_free, delta.rows, delta.free,
            self.pending_rows, self.pending_pre, donate=False)
        h2d += n
        self.ports_dev, self.mirror_ports, n = self._correct(
            self.ports_dev, self.mirror_ports, delta.rows,
            delta.used_ports, self.pending_prows, self.pending_ppre,
            donate=True)
        h2d += n
        self.pending_rows = self.pending_pre = None
        self.pending_prows = self.pending_ppre = None
        eng._res_count(resync=False, h2d=h2d)
        return nf._replace(free=self.free_dev, used_ports=self.ports_dev)

    @staticmethod
    def _correct(state, mirror, rows, vals, pending_rows, pending_pre, *,
                 donate):
        """Upload the rows whose truth differs from the mirror. Rows the
        device changed that the host never touched take their
        pre-replay mirror value as truth (a host-mutated row lands in
        the delta and wins here by exclusion). ``free`` is never
        donated: the carried array is the last Decision's free_after,
        which its batch object still holds."""
        rows = rows.astype(np.int64)
        if pending_rows is not None:
            extra = ~np.isin(pending_rows, rows)
            if extra.any():
                rows = np.concatenate([rows, pending_rows[extra]])
                vals = np.concatenate([vals, pending_pre[extra]])
        if not rows.size:
            return state, mirror, 0
        diff = np.any(vals != mirror[rows], axis=1)
        if not diff.any():
            return state, mirror, 0
        up_r = rows[diff].astype(np.int32)
        up_v = np.ascontiguousarray(vals[diff])
        state = apply_rows(state, up_r, up_v, donate=donate)
        mirror[up_r] = up_v
        return state, mirror, apply_rows_bytes(up_r.shape[0], up_v)

    def note_debits(self, chosen, assigned, requests, free_after_dev,
                    add_back=None):
        """Record the step's device-side debits: fold them into the host
        mirror as the per-node commutative aggregate (exact — I1) and
        adopt ``free_after`` as the carried device array. ``add_back``
        (device (N,R)) reverses a nomination reserve that was subtracted
        from the step's ``free`` input only, so the adopted array returns
        to the un-nominated truth the mirror tracks: exact under the
        integer grammar, (carried - reserved) - debits + reserved =
        carried - debits."""
        rows = chosen[assigned].astype(np.int64)
        if rows.size:
            reqs = requests[assigned]
            uniq = np.unique(rows)
            self.pending_pre = self.mirror_free[uniq].copy()
            self.pending_rows = uniq
            agg = np.zeros((uniq.shape[0], reqs.shape[1]),
                           dtype=self.mirror_free.dtype)
            np.add.at(agg, np.searchsorted(uniq, rows), reqs)
            self.mirror_free[uniq] -= agg
            if FAULTS.hit("auction_mirror") == "corrupt":
                # A mis-targeted aggregate: a phantom debit on a row the
                # batch never debited, which no later delta corrects; only
                # the resident_check_every carry check can see it.
                self.mirror_free[-1, 0] -= 1.0
            if not np.isfinite(self.mirror_free[uniq]).all():
                # A non-finite request or feature reached the carried
                # chain: abort before the poisoned mirror is trusted (the
                # retry drops residency, which resets the mirrors).
                raise EngineDesync(
                    "non-finite free capacity after device-debit replay")
        else:
            self.pending_rows = self.pending_pre = None
        if add_back is not None:
            free_after_dev = free_after_dev + add_back
        self.free_dev = free_after_dev

    def note_ports(self, rows: np.ndarray, ports: np.ndarray) -> int:
        """Run the batch's host-port insertions on the resident
        used_ports (the device op) and replay them into the mirror (the
        host op), tracking touched rows like the free carry's pending
        set. ``rows`` is (P,) chosen with -1 for pods that insert
        nothing. Returns the host→device bytes the insertion uploaded."""
        uniq = np.unique(rows[rows >= 0])
        self.pending_prows = uniq
        self.pending_ppre = self.mirror_ports[uniq].copy()
        replay_ports_host(self.mirror_ports, rows, ports)
        self.ports_dev = insert_ports(self.ports_dev, rows, ports)
        return insert_ports_bytes(rows.shape[0], ports.shape[1])

    def drop(self, reason: str) -> None:
        """Abandon the device state; the next residency batch does a
        full re-upload (the listener rebases itself at collection)."""
        if self.epoch >= 0:
            log.info("device residency dropped (%s); next batch "
                     "re-uploads the dynamic leaves", reason)
        self.epoch = -1
        self.free_dev = self.ports_dev = None
        self.mirror_free = self.mirror_ports = None
        self.pending_rows = self.pending_pre = None
        self.pending_prows = self.pending_ppre = None
        self.listener.invalidate()


class _ArbIndex:
    """The engine's side of the maintained arbitration index
    (ops/index.py): the pod-class registry, the pending repair rows, the
    device IndexState and its rebuild bookkeeping.

    Invariants (held against the JAX engine by
    tests/test_torch_index.py):

      I1. every served class row equals the masked total the full step
          computes for that class, as of the snapshot of the last build
          or refresh; rows whose truth moved since are in ``pending``
          (the cache marks every free/used_ports mutation and every
          narrowing static change into the IndexDeltaListener, and the
          drain runs before the snapshot a refresh evaluates against);
      I2. a column not in ``pending`` kept its build/refresh value; a
          widening static change (a fresh node, an uncordon, a topology
          refresh) bumps the listener's ``inval`` epoch and forces a
          rebuild before the index serves again;
      I3. decisions equal the index-off engine's bitwise: a served batch
          runs the certified shortlist scan over gathered class rows,
          and a batch with an unassigned live row discards the result
          and re-runs the full step with the batch's PRNG draw.
    """

    __slots__ = ("listener", "k_base", "k_target", "n_built", "c_max",
                 "registry", "rows", "reg_version", "state", "pending",
                 "fresh_rows", "pending_inval", "inval_seen",
                 "needs_rebuild", "rebuild_streak", "drain_version",
                 "_stack_memo")

    def __init__(self, listener, k: int, c_max: int):
        self.listener = listener
        self.k_base = k          # the configured width (index_k)
        self.k_target = k        # the tuner's width (the K-dial)
        self.n_built = -1        # node pad the live state was built at
        self.c_max = c_max
        self.registry: Dict[bytes, int] = {}   # class key → class row
        self.rows: List[dict] = []             # each class's pf row
        self.reg_version = 0
        self.state = None                      # ops.index.IndexState
        self.pending: Set[int] = set()         # node rows to rescore
        self.fresh_rows: List[int] = []        # class rows to append
        self.pending_inval = 0   # listener.inval at the last drain
        self.inval_seen = -1     # listener.inval the live state covers
        self.needs_rebuild = True
        self.rebuild_streak = 0  # consecutive fallback batches
        self.drain_version = -1  # cache.version at the last drain
        self._stack_memo = None  # (reg_version, class PodFeatures)

    @property
    def k_eff(self) -> int:
        """The indexed-scan width: the tuner's target (exact at any
        width, so a dial move costs no rebuild)."""
        return max(1, self.k_target)

    def drain(self, cache) -> None:
        """Collect the listener's repair rows and inval epoch. Runs
        before the snapshot the next refresh evaluates against; the
        cache version recorded here gates serving (_index_dispatch)."""
        rows, inval, version = cache.drain_index_rows(self.listener)
        self.pending.update(int(r) for r in rows)
        self.pending_inval = inval
        self.drain_version = version

    def classify(self, pf, length: int):
        """Map the batch's pods to class rows, registering unseen
        classes. The class key is the pod's whole feature-row byte image
        (every PodFeatures leaf, the name suffix included). Returns the
        (L,) int32 class rows, or None when the registry is full (the
        batch takes the full step)."""
        mats = [np.ascontiguousarray(
            getattr(pf, f)[:length]).reshape(length, -1).view(np.uint8)
            for f in pf._fields]
        blob = np.concatenate(mats, axis=1)
        cls = np.empty(length, dtype=np.int32)
        for i in range(length):
            key = blob[i].tobytes()
            row = self.registry.get(key)
            if row is None:
                if len(self.rows) >= self.c_max:
                    return None
                row = len(self.rows)
                self.registry[key] = row
                self.rows.append({f: np.copy(getattr(pf, f)[i])
                                  for f in pf._fields})
                self.reg_version += 1
                # Appended incrementally unless the registry crossed the
                # class-pad bucket (_index_dispatch decides).
                self.fresh_rows.append(row)
            cls[i] = row
        return cls

    def class_pf(self, template, device):
        """The class PodFeatures (C_pad rows, a power-of-two bucket) on
        ``device``, memoized per registry version. Padding rows are all
        zero: invalid, NEG everywhere, never chosen."""
        if self._stack_memo and self._stack_memo[0] == self.reg_version:
            return self._stack_memo[1]
        c_pad = bucket_for(max(len(self.rows), 1), 16)
        leaves = {}
        for f in template._fields:
            proto = self.rows[0][f]
            arr = np.zeros((c_pad,) + proto.shape, dtype=proto.dtype)
            for c, row in enumerate(self.rows):
                arr[c] = row[f]
            leaves[f] = arr
        self._stack_memo = (self.reg_version,
                            to_torch(type(template)(**leaves), device))
        return self._stack_memo[1]

    def invalidate(self, reason: str) -> None:
        """Drop the device state; the next index batch rebuilds (counted).
        Used when the inputs a refresh consumed are no longer trusted: a
        carry desync means the ``free`` the last refresh scored against
        may have been wrong."""
        log.info("arbitration index invalidated (%s); next index batch "
                 "rebuilds", reason)
        jnote("index.invalidate", reason=reason)
        self.state = None
        self.needs_rebuild = True


def arbitrate_rwo(batch: List[QueuedPodInfo], assigned, chosen,
                  vol_memo: Dict[str, tuple]):
    """In-batch RWO arbitration → (revoked pod indices, parked gang keys).

    The VolumeRestrictions filter pins pods to a claim's existing mount
    node, but an UNUSED claim shared by several pods in one batch could be
    jointly assigned to different nodes. Walk assignments in priority
    order; the first surviving pod pins each unused claim, later pods
    choosing a different node are revoked and retried (next cycle sees the
    pinned claim — sequential RWO semantics without splitting gangs out of
    the batch).

    "Unused" is judged from the ENCODE-time claim rows the filter itself
    evaluated (``vol_memo``: pod key → ``_volume_state`` tuple), not a
    second live cache read: an informer event mounting a claim between
    encode and commit would make a live read skip arbitration and let two
    batch pods bind the same RWO claim to different nodes.

    A pin is only binding while its owner survives arbitration: a pinner
    revoked later (gang atomicity over another claim) must not keep
    revoking claim-mates against a placement that never commits. Two
    stages:

    1. an optimistic fixed-point loop where only surviving pods pin
       (revoked pods are re-checked against live pins each pass, so a pod
       stays revoked only while a live pin justifies it) — this rescues
       spuriously-revoked pods;
    2. a monotone safety closure (pins from survivors, conflicts only ADD
       revocations, repeated until stable) — at a converged stage-1
       fixpoint it is a no-op, and in the pathological non-converged case
       it restores the invariant that no two committed pods bind one
       claim to two nodes.
    """
    parked_gangs: Set[str] = set()  # intra-gang conflicts: unsatisfiable

    def unused_claims(pod: Pod):
        st = vol_memo.get(pod.key)
        if st is None:
            # No encode-time record (a pod without volumes has no claims
            # either) — nothing to arbitrate.
            return []
        return [ck for ck, r in zip(claim_keys(pod), st[1])
                if r == CLAIM_UNUSED]

    def scan(dead: Set[int], monotone: bool) -> Set[int]:
        """One arbitration pass. Pods in ``dead`` never pin; they are
        still checked against live pins unless ``monotone`` (where dead is
        sticky and needs no re-justification). Returns the revocation set
        implied by live pins."""
        claim_pin: Dict[str, tuple] = {}  # ck → (row, pinner's gang)
        conflicted: Set[int] = set()
        for i, qpi in enumerate(batch):
            if not assigned[i] or (monotone and i in dead):
                continue
            row = int(chosen[i])
            gk = gang_key(qpi.pod)
            alive = i not in dead and not (gk and gk in parked_gangs)
            for ck in unused_claims(qpi.pod):
                pin = claim_pin.get(ck)
                if pin is None:
                    if alive:
                        claim_pin[ck] = (row, gk)
                elif pin[0] != row:
                    conflicted.add(i)
                    if gk and gk == pin[1]:
                        # The conflict is INSIDE one gang: its members
                        # demand the claim on different nodes; retrying
                        # reproduces it forever — park the gang
                        # (terminal, sticky).
                        parked_gangs.add(gk)
                    break
        # Gang atomicity: revoking one member revokes its whole gang.
        gangs = {gang_key(batch[i].pod) for i in conflicted
                 if batch[i].pod.spec.pod_group} | parked_gangs
        out = set(conflicted)
        if gangs:
            for i, qpi in enumerate(batch):
                if assigned[i] and gang_key(qpi.pod) in gangs:
                    out.add(i)
        return out

    revoked: Set[int] = set()
    for _ in range(8):  # stage 1: rescue loop
        new_revoked = scan(revoked, monotone=False)
        if new_revoked == revoked:
            break
        revoked = new_revoked
    while True:  # stage 2: safety closure (monotone, terminates)
        grown = revoked | scan(revoked, monotone=True)
        if grown == revoked:
            break
        revoked = grown
    return revoked, parked_gangs


def _holds_unused_claim(vol_memo: Dict[str, tuple], pod) -> bool:
    """Does the pod hold a claim nobody mounted at encode time? The spread
    repair leaves such pods out: a repair could move them off the node
    their claim was arbitrated against."""
    st = vol_memo.get(pod.key)
    return st is not None and CLAIM_UNUSED in st[1]


def batch_group_match(batch: List[QueuedPodInfo], gf) -> np.ndarray:
    """(P_live, G) bool: batch pod i's namespace+labels match selector
    group g — the HOST twin of ops.topology.group_assigned_match (same
    hash functions, same all-zero-selector = match-all and ns_hash 0 =
    any-namespace semantics), evaluated over the batch pods themselves
    (their labels are host objects; the device only encodes groups).
    Label-pair rows are memoized per distinct signature — a deployment's
    replicas share one."""
    from ..encode import features as F

    P, G = len(batch), gf.valid.shape[0]
    sel = np.asarray(gf.sel_pairs, dtype=np.int64)   # (G,QT)
    gvalid = np.asarray(gf.valid)
    gns = np.asarray(gf.ns_hash, dtype=np.int64)
    ns_memo: Dict[str, int] = {}
    # per distinct label signature: the (G,) selector-match row
    sig_memo: Dict[tuple, np.ndarray] = {}
    match = np.zeros((P, G), dtype=bool)
    for i, qpi in enumerate(batch):
        pod = qpi.pod
        sig = tuple(pod.metadata.labels.items())
        sel_ok = sig_memo.get(sig)
        if sel_ok is None:
            s = {F.pair_hash(k, v) for k, v in sig}
            sel_ok = np.array([
                all((int(p) in s) for p in sel[g] if p != 0)
                for g in range(G)])
            sig_memo[sig] = sel_ok
        nsv = ns_memo.get(pod.metadata.namespace)
        if nsv is None:
            nsv = ns_memo[pod.metadata.namespace] = (
                F._h(pod.metadata.namespace) if pod.metadata.namespace else 0)
        match[i] = gvalid & ((gns == 0) | (gns == nsv)) & sel_ok
    return match


class _SpreadGroupState:
    """Running per-domain count table for ONE selector group — the exact
    sequential-semantics core of arbitrate_spread. Maintains the count
    of every topology domain plus the global min via a count-histogram,
    so each admission is O(1) and the min is always exact (never the
    conservative pre-batch min, which on a skew-constrained burst admits
    only ~(domains x max_skew) pods per cycle)."""

    __slots__ = ("counts", "hist", "min")

    def __init__(self, counts_row: np.ndarray, exist_row: np.ndarray):
        self.counts = counts_row.astype(np.int64)  # (D,) private copy
        vals, freq = np.unique(self.counts[exist_row], return_counts=True)
        self.hist = dict(zip(vals.tolist(), freq.tolist()))
        self.min = int(vals[0]) if vals.size else 0

    def admit(self, d: int) -> None:
        c = int(self.counts[d])
        self.counts[d] = c + 1
        n = self.hist.get(c, 0) - 1
        if n:
            self.hist[c] = n
        else:
            self.hist.pop(c, None)
        self.hist[c + 1] = self.hist.get(c + 1, 0) + 1
        if c == self.min and n <= 0:
            # every domain that sat at the min has moved up; the next
            # occupied histogram bucket is the new exact min
            while self.hist.get(self.min, 0) == 0:
                self.min += 1


def arbitrate_spread(batch: List[QueuedPodInfo], assigned, pf, gf,
                     spread_pre, spread_dom, spread_min,
                     dead: Set[int], anti_enabled: bool = True,
                     exact_tables=None,
                     scan_enforced=None) -> Set[int]:
    """Intra-batch topology arbitration → additional revoked indices.

    Every batch pod was filtered/scored against PRE-batch topology counts,
    so a burst can jointly commit constraints none violates alone (the
    sequential reference sees each prior placement):

      * hard (DoNotSchedule) spread: a burst can stack one domain past
        max_skew;
      * required anti-affinity: two mutually-exclusive batch pods can
        both land in one domain — direct (the later pod's own anti term
        matches an earlier placement) and symmetric (an earlier pod's
        anti term matches the later pod).

    Walk assignments in priority order carrying in-batch per-(group,
    domain) state — membership updates fed by EVERY matching assigned
    pod, constraint or not, and anti-term deltas by each survivor's own
    anti terms. Skew is judged with EXACT sequential semantics when
    ``exact_tables`` supplies the step's full per-domain count tables
    (``() -> (cdom (G,D) f32, dexist (G,D) bool)``, fetched lazily —
    only batches with hard constraints pay the transfer): a running
    count table + histogram-tracked min per group reproduces what a
    sequential scheduler placing the same pods in the same order would
    admit, so a skew-constrained burst drains in one cycle instead of
    max_skew-per-domain per cycle. Without the tables it falls back to
    judging against the conservative pre-batch min (in-batch additions
    only raise the true min, so the fallback never under-revokes — it
    over-revokes and converges over more cycles). Violators are revoked
    and retried next cycle, where the committed counts are visible —
    required AFFINITY needs no arbitration: in-batch blindness can only
    under-admit, and the parked pod is revived by the peer's bind event.
    Gang atomicity: one revoked member revokes its whole gang.

    Inputs: pf/gf (host-side encoded batch), spread_pre/dom (P,G) and
    spread_min (G,) from the step (state at each pod's chosen node),
    ``dead`` = indices already revoked upstream (they never commit, so
    they contribute no deltas).

    ``scan_enforced`` ((G,) bool, Decision.scan_groups): groups whose
    hard skew the in-scan domain caps (ops/spreadcap.py) already judged
    against running counts AT CHOICE TIME, in this same batch order —
    the host replay is skipped for them, and a batch whose hard groups
    are all scan-enforced never calls ``exact_tables`` at all (the
    (G,D) transfer exists solely to rebuild the running state the scan
    already had)."""
    from ..encode import features as F

    if spread_pre.shape[0] == 0:
        return set()
    P = len(batch)
    hard = ((pf.spread_group >= 0)
            & (pf.spread_mode == F.SPREAD_DO_NOT_SCHEDULE))[:P]
    anti = pf.anti_req_group[:P]                     # (P,T), -1 unused
    # Anti terms are always encoded, but only the InterPodAffinity filter
    # ENFORCES them — arbitrating them in a profile that ignores them
    # would revoke pods the next cycle happily co-locates anyway.
    has_anti = anti_enabled and bool((anti >= 0).any())
    if not hard.any() and not has_anti:
        return set()
    match = batch_group_match(batch, gf)

    hard_gids = {int(g) for g in np.unique(pf.spread_group[:P][hard])
                 if g >= 0}
    # (G,D) tables are fetched at most once across every walk iteration.
    tables = {"fetched": False, "cdom": None, "dexist": None}

    def fetch_tables():
        if not tables["fetched"]:
            tables["fetched"] = True
            if exact_tables is not None:
                fetched = exact_tables()
                if fetched is not None and fetched[0].shape[0]:
                    tables["cdom"], tables["dexist"] = fetched
        return tables["cdom"], tables["dexist"]

    def _walk(dead_all: Set[int]) -> Set[int]:
        """One exact sequential replay with ``dead_all`` contributing
        nothing. Mutable enforcement view: a group's scan verdict is
        trusted only while every admission the scan COUNTED for it
        survives. A host-side revocation (RWO/gang ``dead_all``, or an
        anti revocation made in this very walk) removes a contribution
        the scan's running counts relied on — lowering a domain min that
        later admissions were judged against — so those groups fall back
        to the exact replay, reconstructed mid-walk from the survivor
        deltas."""
        enf = (np.array(scan_enforced, dtype=bool, copy=True)
               if scan_enforced is not None
               else np.zeros(gf.valid.shape[0], dtype=bool))
        delta: Dict[tuple, int] = {}      # (g,d) → matching pods placed
        anti_delta: Dict[tuple, int] = {}  # (g,d) → anti terms placed in d
        gstates: Dict[int, _SpreadGroupState] = {}

        def build_state(g: int) -> None:
            """Exact running state for group g AT THE CURRENT WALK
            POSITION: pre-batch tables plus every surviving admission so
            far (delta already tracks them for all matching groups,
            enforced or not)."""
            cdom, dexist = fetch_tables()
            if cdom is None:
                return  # fallback mode: pre-batch-min check (over-revokes)
            st = _SpreadGroupState(cdom[g], dexist[g])
            for (g2, d), cnt in delta.items():
                if g2 == g:
                    for _ in range(cnt):
                        st.admit(d)
            gstates[g] = st

        def un_enforce(rows) -> None:
            """Stop trusting the scan for every hard group the given
            revoked pods match; rebuild their exact state from deltas."""
            for i in rows:
                for g in np.nonzero(match[i])[0]:
                    gi = int(g)
                    if enf[gi] and gi in hard_gids:
                        enf[gi] = False
                        build_state(gi)

        # Pre-walk: revocations known before this walk were counted by
        # the scan from their row onward — replay their groups from row
        # 0 (the sequential scheduler would have rejected them at their
        # turn).
        dead_assigned = [i for i in dead_all if i < P and assigned[i]]
        if dead_assigned:
            un_enforce(dead_assigned)
        for g in sorted(hard_gids):
            if not enf[g] and g not in gstates:
                build_state(g)

        revoked: Set[int] = set()
        for i in range(P):
            if not assigned[i] or i in dead_all:
                continue
            viol = False
            for c in np.nonzero(hard[i])[0]:
                g = int(pf.spread_group[i, c])
                if enf[g]:
                    # the scan judged this admission against running
                    # counts at choice time, and every admission it
                    # counted so far survives — replaying is redundant
                    continue
                d = int(spread_dom[i, g])
                st = gstates.get(g)
                if st is not None:
                    if d >= 0 and (int(st.counts[d]) + 1 - st.min
                                   > int(pf.spread_max_skew[i, c])):
                        viol = True
                        break
                else:
                    after = (float(spread_pre[i, g])
                             + delta.get((g, d), 0) + 1)
                    if after - float(spread_min[g]) > float(
                            pf.spread_max_skew[i, c]):
                        viol = True
                        break
            if not viol and has_anti:
                for t in np.nonzero(anti[i] >= 0)[0]:
                    g = int(anti[i, t])
                    d = int(spread_dom[i, g])
                    # direct: an earlier matching placement in my domain
                    if d >= 0 and delta.get((g, d), 0) > 0:
                        viol = True
                        break
                if not viol:
                    # symmetric: an earlier pod's anti term targets ME
                    for g in np.nonzero(match[i])[0]:
                        d = int(spread_dom[i, int(g)])
                        if d >= 0 and anti_delta.get((int(g), d), 0) > 0:
                            viol = True
                            break
            if viol:
                revoked.add(i)
                # this pod's admission WAS in the scan's running counts —
                # groups it matches can no longer trust the scan verdict
                # for the remaining rows
                un_enforce((i,))
                continue
            for g in np.nonzero(match[i])[0]:
                gi = int(g)
                d = int(spread_dom[i, gi])
                if d >= 0:  # node lacks the key → no domain membership
                    # delta tracks IN-BATCH placements for the anti path
                    # in both modes; the exact group states additionally
                    # carry the running counts + min for the skew check.
                    delta[(gi, d)] = delta.get((gi, d), 0) + 1
                    st = gstates.get(gi)
                    if st is not None:
                        st.admit(d)
            if has_anti:
                for t in np.nonzero(anti[i] >= 0)[0]:
                    g = int(anti[i, t])
                    d = int(spread_dom[i, g])
                    if d >= 0:
                        anti_delta[(g, d)] = anti_delta.get((g, d), 0) + 1
        return revoked

    # Fixpoint over gang atomicity: a revoked member revokes its whole
    # gang, and each revoked gang member's admission was counted by BOTH
    # the scan and this walk's running state — later pods may hold
    # placements only legal because of it. Re-walk with the gang's
    # members dead until no new revocation appears (bounded by the
    # number of gangs; a batch with no gang revocations exits after one
    # pass, identical to the single-walk behavior).
    extra: Set[int] = set()
    while True:
        revoked = _walk(dead | extra) | extra
        gangs = {gang_key(batch[i].pod) for i in revoked
                 if batch[i].pod.spec.pod_group}
        cascade = {i for i, qpi in enumerate(batch)
                   if (assigned[i] and i not in dead and i not in revoked
                       and gang_key(qpi.pod) in gangs)}
        if not cascade:
            return revoked
        extra = revoked | cascade


class Scheduler:
    def __init__(self, store, plugin_set: PluginSet,
                 config: Optional[SchedulerConfig] = None,
                 recorder=None, scheduler_names: Optional[Set[str]] = None,
                 shared: Optional[SharedClusterState] = None,
                 profile: Optional[str] = None,
                 replica: Optional[str] = None):
        self.store = store
        self.plugin_set = plugin_set
        self.config = config or SchedulerConfig()
        # Explainability hook (explain/resultstore.ResultStore): every
        # batch's step output goes to record_batch when set.
        self.recorder = recorder
        # Multi-profile routing: when set, only pods whose
        # spec.scheduler_name is in this set are queued here (reference
        # KubeSchedulerProfile.SchedulerName selection); None accepts
        # every pod (a single-profile service).
        self.scheduler_names = scheduler_names
        # Serving-profile label: journal events, timeline rows and
        # provenance records carry it, and it names the overload
        # controller (per-profile shed budgets resolve against it). A
        # directly built engine derives it from its routing set.
        self.profile = profile or (sorted(scheduler_names)[0]
                                   if scheduler_names else "default")
        # Replica id tagged beside the profile ("" = a solo engine).
        self.replica = replica or ""
        # Fleet shard ownership (fleet/supervisor.py): (n_shards, owned
        # frozenset, epoch), read as ONE tuple on the wants_pod hot path
        # and only ever replaced whole, so an informer thread never sees
        # a half-updated pair. n_shards == 0 (the solo default) owns
        # every pod.
        self._shard_view = (0, frozenset(), 0)
        # Fleet bind fence: callable(pod_key) -> bool installed by the
        # supervisor. False at commit time means this replica lost the
        # pod's shard: the bind is withheld and the pod handed back (the
        # new owner's takeover re-gathers it from the store). None: no
        # fence (a solo engine).
        self._bind_guard = None
        if self.config.assignment not in ("greedy", "auction"):
            raise ValueError(f"unknown assignment strategy "
                             f"{self.config.assignment!r}; expected "
                             "'greedy' or 'auction'")
        # Resolved (and checked) at construction: a missing card fails
        # start_scheduler, not every later cycle.
        self.device = self.config.device()
        # The mesh (SchedulerConfig.mesh): the step runs over the ("pod",
        # "node") device grid through parallel/sharded.py. Checked here,
        # so a bad mesh fails start_scheduler rather than every cycle.
        # The engine's tensors live whole on the mesh's first device;
        # the sharded step cuts them (a virtual mesh's blocks are views).
        self._mesh = self.config.mesh
        if self._mesh is not None:
            from ..parallel.mesh import NODE_AXIS, POD_AXIS, Mesh

            if (not isinstance(self._mesh, Mesh)
                    or set(self._mesh.axis_names) != {POD_AXIS, NODE_AXIS}):
                raise ValueError(
                    "SchedulerConfig.mesh must be a parallel.mesh.Mesh "
                    "with ('pod', 'node') axes (parallel.mesh.make_mesh); "
                    f"got {self._mesh!r}")
            if self._mesh.group is not None:
                raise ValueError(
                    "SchedulerConfig.mesh must be a single-process mesh: a "
                    "hybrid mesh's decision is whole in every process, but "
                    "the store and its informers are one process's")
            if self._mesh.device.type != self.device.type:
                raise ValueError(
                    f"SchedulerConfig.mesh is on {self._mesh.device.type} "
                    f"but platform={self.config.platform!r} names "
                    f"{self.device.type}")
            self.device = self._mesh.device
        self._shared = shared or SharedClusterState(store)
        self._owns_shared = shared is None
        self.cache = self._shared.cache
        self._shared.register(self)
        self.broadcaster = EventBroadcaster(store)

        event_map = plugin_set.cluster_event_map()
        # In-batch capacity losses and bind conflicts are revivable by any
        # node add/update or assigned-pod delete (capacity freed).
        for ev in (ClusterEvent(GVK.NODE, ActionType.ADD | ActionType.UPDATE),
                   ClusterEvent(GVK.POD, ActionType.DELETE)):
            event_map.setdefault(ev, set()).add(BATCH_CAPACITY)
        # Gang-rejected pods revive when a new member arrives (pod add),
        # capacity frees (pod delete), or nodes appear/change.
        for ev in (ClusterEvent(GVK.POD, ActionType.ADD | ActionType.DELETE),
                   ClusterEvent(GVK.NODE, ActionType.ADD | ActionType.UPDATE)):
            event_map.setdefault(ev, set()).add(COSCHEDULING)
        self.queue = SchedulingQueue(
            event_map,
            backoff_initial=self.config.backoff_initial_s,
            backoff_max=self.config.backoff_max_s)

        # Shortlist-compressed arbitration: None = the full greedy kernel
        # (or, under the auction, the dense bidding rounds). Off on a
        # mesh: the sharded assignment keeps full (P,N) rows, so the
        # decisions are the knob's either way.
        self._shortlist_k = (self.config.shortlist_k
                             if self.config.shortlist and self._mesh is None
                             else None)
        if self._mesh is not None:
            # The sharded step (parallel/sharded.py): no input templates
            # needed, so it is built here; "greedy" is the chunked-gather
            # scan, "auction" the gathered dense auction. Node sampling
            # is off on a mesh (_sampled_step), so every batch takes it.
            from ..parallel.sharded import build_sharded_step

            self._step = build_sharded_step(
                plugin_set, self._mesh, explain=self.config.explain,
                assignment=self.config.assignment)
        else:
            self._step = build_step(plugin_set, shortlist=self._shortlist_k,
                                    assignment=self.config.assignment,
                                    explain=self.config.explain)
        self._key = prng.PRNGKey(self.config.seed)
        self._step_counter = 0
        # Supervisor replay anchor: the step counter the batch in prepare
        # started from (see _prepare_batch).
        self._prep_step0 = 0
        self._batch_seq = 0
        # CUDA timing events around the solo step (_step_events): on a
        # card, single-device only; pairs come back to this pool once
        # read, so it holds at most the pipeline's depth.
        self._time_steps = self.device.type == "cuda" and self._mesh is None
        self._step_event_pool: List[tuple] = []
        # Engine supervisor: the degradation ladder and its detectors.
        # Level state is scheduling-thread-only; counters ride _metrics.
        self._sup = _Supervisor(self)
        # The batch in resolve on the scheduling thread, whose assumes
        # an abort rolls back (thread-gated like _fail_sink).
        self._track: Optional[_Batch] = None
        # Pods an async owner (the binder's bulk commit, a permit wait)
        # holds right now: a supervised retry strips them before every
        # attempt, since re-scheduling one would double-assume it and
        # race the owner's bind. Owners release them on binder threads.
        self._detached_live: Set[str] = set()
        self._detached_lock = threading.Lock()
        # Cross-check cadence counters (scheduling thread only).
        self._res_check_tick = 0
        self._sl_check_tick = 0
        self.waiting_pods: Dict[str, WaitingPod] = {}
        self._waiting_lock = threading.Lock()
        self._binder = ThreadPoolExecutor(
            max_workers=self.config.bind_workers, thread_name_prefix="binder")
        # Workers of the pipelined cycle (_run_pipelined): batch k-1's
        # failure flush runs on the commit worker (ONE worker: commits
        # apply in batch order) and batch k+1's queue pop on the gather
        # worker, while the scheduling thread resolves batch k.
        self._committer = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="commit")
        self._gatherer = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="gather")
        # Deferred-failure sink: while the scheduling thread resolves a
        # batch, _handle_failure APPENDS verdicts here and _commit_batch
        # flushes them in bulk. Thread-gated: binder/permit threads always
        # take the immediate path.
        self._fail_sink: Optional[List[tuple]] = None
        self._fail_sink_tid = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.filter_names = [p.name for p in plugin_set.filter_plugins]
        names = {p.name for p in plugin_set.plugins}
        # Intra-batch topology arbitration (hard spread + required
        # anti-affinity, arbitrate_spread) applies when either topology
        # plugin is in the profile.
        self._spread_enabled = bool(
            names & {"PodTopologySpread", "InterPodAffinity"})
        # Symmetric existing-pod anti-affinity is enforced by the
        # InterPodAffinity filter via encode.anti_forbid slots.
        self._anti_enabled = "InterPodAffinity" in names
        # Upstream's symmetric InterPodAffinity score: the encoder stamps
        # each pod's rows of the bound pods' terms it matches
        # (cache.SymBatch) when the profile scores InterPodAffinity.
        self._sym_enabled = any(p.name == "InterPodAffinity"
                                for p in plugin_set.score_plugins)
        # SelectorSpread consumes owner-derived selector groups; the
        # shared assigned corpus must then carry owner pairs too, enabled
        # here, before the informers sync.
        self._selspread_enabled = "SelectorSpread" in names
        if self._selspread_enabled:
            self.cache.enable_owner_pairs()
        # Which encode-side fail-closed verdicts apply: only constraints
        # this profile's plugin set enforces may park a pod.
        self._fail_closed_plugins = {
            "InterPodAffinity": self._anti_enabled,
            "PodTopologySpread": "PodTopologySpread" in names}
        # In-batch RWO arbitration applies when the plugin enforcing claim
        # exclusivity is in the profile.
        self._rwo_enabled = "VolumeRestrictions" in names
        # PostFilter preemption (upstream DefaultPreemption): enabled by
        # the marker plugin; terminally unschedulable pods get a batched
        # victim-candidate search before parking.
        self._preempt_enabled = bool(plugin_set.postfilter_plugins)
        # Outstanding nominations: pod key → (node name, request vector,
        # expiry). Freed capacity stays reserved for its preemptor until
        # it binds, vanishes, or the TTL lapses. Own lock: the binder
        # thread clears entries while the scheduling thread debits them.
        self._nominations: Dict[str, tuple] = {}
        # Preemption wins per pending pod without a bind (cleared on bind
        # or delete; see _PREEMPT_MAX_ROUNDS).
        self._preempt_rounds: Dict[str, int] = {}
        self._nom_lock = threading.Lock()
        # WFFC candidate-zone memo: pvc key → (zones, computed_at).
        self._wffc_memo: Dict[str, tuple] = {}
        # Device copies of the static node-feature leaves, keyed on
        # (cache static version, pad), with their content token when a
        # tenant mux is armed: ((version, pad), leaves, token or None).
        # Scheduling thread only.
        self._nf_static_device = None
        # Fused multi-tenant arbitration (MINISCHED_TENANTS_FUSE;
        # encode/cache.TenantCacheMux): installed by the service's
        # fusion coordinator on each tenant engine it serves. When armed,
        # a fusable batch's prepare SUBMITS its staged step inputs to the
        # mux instead of dispatching, and the coordinator's one fused
        # dispatch per group fills the batch's decision before resolve.
        # None: a solo engine (every other path, unchanged).
        self._tenant_mux = None
        # The kernel build directory (MINISCHED_COMPILE_CACHE): set
        # before the first launch builds a kernel, so restarts and the
        # replicas of a process fleet load one set of libraries.
        # Process-wide; a directory that cannot be made leaves it off.
        self._compile_cache_on = enable_compile_cache(
            self.config.compile_cache)
        # Slim decision readback rides the residency knob, as in the JAX
        # package: device_resident=False restores the all-i32 fetch.
        self._slim = bool(self.config.device_resident)
        # The first slim fetch is checked against direct reads of the
        # decision's leaves (byte order and bit packing); a mismatch
        # reverts to the i32 layout. The device loop opens after it.
        self._slim_verified = False
        self._residency: Optional[_DeviceResidency] = None
        if self.config.device_resident:
            self._residency = _DeviceResidency(
                self.cache.register_dyn_listener())
        # Device loop (_maybe_run_tranche): not under explain mode (the
        # step's stacks would stack D deep). The loop's own dyn listener
        # feeds the between-slot validator (cache.drain_dyn_rows); it is
        # never handed to snapshot_resident, so the residency epoch
        # protocol is untouched. _loop_cooldown is the loop→pipelined
        # rung: a tranche fault closes the ring for probation_batches
        # resolved batches.
        self._loop_enabled = (self.config.device_loop
                              and self._mesh is None
                              and not self.config.explain)
        self._loop_listener = (self.cache.register_dyn_listener()
                               if self._loop_enabled else None)
        self._loop_cooldown = 0
        # Crash-stop flag (abandon()), honoured between ring slots.
        self._abandoned = False
        # Maintained arbitration index (ops/index.py, _ArbIndex): the
        # greedy assignment, not explain mode, an index-eligible profile.
        self._index: Optional[_ArbIndex] = None
        if (self.config.index and self.config.assignment == "greedy"
                and self._mesh is None and not self.config.explain):
            if index_eligible(plugin_set):
                self._index = _ArbIndex(
                    self.cache.register_index_listener(),
                    self.config.index_k, self.config.index_classes)
            else:
                log.info("index=True but profile %s is not index-eligible "
                         "(topology or affinity state, a plugin that is "
                         "not column-local, or an undeclared normalize "
                         "override); keeping the per-batch dataflow",
                         [p.name for p in plugin_set.plugins])
        # The index ladder's full-rescore rung: a fallback storm parks
        # the index for probation_batches resolved batches.
        self._index_cooldown = 0
        self._idx_check_tick = 0
        # Batch-scoped provenance path (journal armed only): set by
        # _resolve_batch_impl, read by the placement stamp sites on the
        # same thread. None = journal unarmed.
        self._prov_batch: Optional[dict] = None
        # Armed trace request (trace_next_batch); the lock covers the
        # arm/consume pair.
        self._trace_lock = threading.Lock()
        self._trace_dir: Optional[str] = None
        self._metrics_lock = threading.Lock()
        # Commits can complete out of batch order (an inline fold while
        # the previous batch's worker flush runs): last_* only accept the
        # highest sequence seen. The prepare window lets a commit book
        # the encode-vs-flush overlap. Both under _metrics_lock.
        self._last_committed_seq = -1
        self._prep_window: tuple = (0.0, 0.0)
        # Inter-batch gap components booked since the last prepare
        # (scheduling thread only; see _book_gap).
        self._gap_pending: Dict[str, float] = {}
        # Per-pod lifecycle histograms, fed from the QueuedPodInfo stamps
        # (added_at, gathered_at, decided_at) where pods_bound increments,
        # so create_to_bound's count equals the bound pods. Always on.
        self._hists: Dict[str, Histogram] = {
            "pod_queue_wait_s": Histogram(),
            "pod_decide_s": Histogram(),
            "pod_bind_s": Histogram(),
            "pod_create_to_bound_s": Histogram(),
        }
        self._metrics: Dict[str, float] = {
            "batches": 0, "pods_seen": 0, "pods_assigned": 0,
            "pods_failed": 0, "pods_bound": 0, "bind_conflicts": 0,
            # Fleet bind fence: commits withheld because this replica
            # lost the pod's shard lease between decision and commit.
            "stale_owner_binds": 0,
            # Supervisor: detected batch faults and the inline degraded
            # retries they triggered, watchdog deadline trips, ladder
            # transitions, batches requeued at the quarantine rung,
            # commit worker deaths, and the cross-checks' runs and trips.
            "batch_faults": 0, "batch_retries": 0, "watchdog_trips": 0,
            "supervisor_escalations": 0, "supervisor_recoveries": 0,
            "quarantined_batches": 0, "worker_deaths": 0,
            "resident_checks": 0, "residency_desyncs": 0,
            "shortlist_checks": 0, "shortlist_desyncs": 0,
            # Phase clocks (host seconds). The step window runs from the
            # dispatch to the decision read back and replayed, less the
            # next batch's gather in pipelined mode; it includes the
            # device time.
            "prepare_s_total": 0.0, "step_s_total": 0.0,
            "resolve_s_total": 0.0, "bind_s_total": 0.0,
            # The scheduling thread's CPU seconds (time.thread_time) over
            # the windows of prepare_s_total and resolve_s_total (the
            # flush's part: the CPU of the thread that ran it). Wall
            # minus CPU is time the phase did not run: waiting for the
            # interpreter lock, on a collection, or blocked.
            "prepare_cpu_s_total": 0.0, "resolve_cpu_s_total": 0.0,
            # Upstream's symmetric InterPodAffinity term: the encoder's
            # host seconds matching pods to the bound pods' terms and
            # building the batch's table (metrics() adds the cache's
            # seconds keeping the term index), and the slots stamped.
            "sym_affinity_s_total": 0.0, "sym_affinity_slots_total": 0,
            # Blocking reads of the card on a batch's path (every
            # fetch.* span, the step's reads inside its ops) and their
            # wall seconds, wherever they fall (most in step_s_total;
            # fetch.carry in prepare_s_total).
            "host_syncs_total": 0, "fetch_wait_s_total": 0.0,
            # The solo step's device span (CUDA events from before its
            # first launch to after the pack, read after the decision
            # fetch): 0 off the card, on a mesh, and for batches served
            # another way (fused tenant lanes, index serves, loop slots).
            "step_device_span_s_total": 0.0,
            # The JAX engine's clocks: encode (after the gang pull and
            # sort, to the dispatch), the step's dispatch alone, commit
            # (the resolve tail after the fetch plus the flush).
            "encode_s_total": 0.0, "step_dispatch_s_total": 0.0,
            "commit_s_total": 0.0,
            # Inter-batch glue: every gap_s_total booking is tagged with
            # one component, so the four partition it exactly: gather =
            # blocking queue-pop waits; encode = batch formation (gang
            # pull + priority sort) before the encode window; fetch =
            # the dispatch→fetch turnaround (the next batch's gather
            # runs there in pipelined mode); commit = the scheduling
            # thread's wait on the previous batch's commit flush.
            "gap_s_total": 0.0, "gap_gather_s_total": 0.0,
            "gap_encode_s_total": 0.0, "gap_fetch_s_total": 0.0,
            "gap_commit_s_total": 0.0,
            # Pipelined overlap: commit-flush time hidden behind the next
            # batch's stages, and the prepare time that ran while the
            # previous commit flushed. Both 0 in the synchronous loop.
            "encode_overlap_s": 0.0, "commit_overlap_s": 0.0,
            "last_encode_s": 0.0, "last_step_s": 0.0, "last_commit_s": 0.0,
            # Main-step dispatches, blocking decision readbacks (main,
            # residual, repair), and plugin evaluations in pod-row ×
            # node-row units (the full step's P_pad·N, a sampled K).
            "steps_dispatched": 0, "decision_fetches": 0,
            "scored_rows_total": 0, "last_scored_rows": 0,
            # Device loop: tranches (one dispatch and one fetch each),
            # the slots they consumed, and the breaks back to per-batch
            # dispatch (a divergence or a machinery fault mid-tranche).
            "loop_tranches": 0, "loop_iterations": 0, "loop_breaks": 0,
            # Maintained index: batches served from it (no full
            # filter+score pass ran), batches it attempted that re-ran
            # the full step (an unassigned live row, a full registry),
            # node columns rescored in place, full rebuilds, fresh class
            # rows appended, per-pod certificate failures the scan
            # repaired in place (counted, never a fallback), serves
            # declined because a cache mutation landed between the
            # drain and the dispatch, the cross-check's runs and trips,
            # and fallback-storm parks.
            "index_hits": 0, "index_fallbacks": 0,
            "index_repair_rows": 0, "index_rebuilds": 0,
            "index_appends": 0, "index_uncertified": 0,
            "index_races": 0, "index_checks": 0, "index_desyncs": 0,
            "index_cooldowns": 0,
            # Fused multi-tenant arbitration (MINISCHED_TENANTS_FUSE):
            # batches this engine served as one lane of a fused tenant
            # dispatch (the mux books the one dispatch and fetch of a
            # group on its own counters), submitted batches dispatched
            # solo after a cache mutation raced the collect window, and
            # those races.
            "tenant_fused_lanes": 0, "tenant_solo_fallbacks": 0,
            "tenant_races": 0,
            # SLO sentinel alerts (total; per-objective keys appear on
            # first fire) and the supervisor's early-warning reactions.
            "slo_alerts_total": 0, "supervisor_early_warnings": 0,
            # Transfer ledger: host→device bytes (static-leaf uploads,
            # full dynamic-leaf uploads, residency corrections, port
            # insertions; the pod encode is not counted) and
            # device→host bytes of the decision fetches; the residency
            # protocol's hits (delta-corrected batches) and resyncs
            # (full re-uploads).
            "h2d_bytes_total": 0.0, "fetch_bytes_total": 0.0,
            "residency_hits": 0, "residency_resyncs": 0,
            # Shortlist repair events (full-row rescans) and their
            # per-batch complement.
            "shortlist_repairs": 0, "shortlist_certified": 0,
            "last_shortlist_repairs": 0,
            # Kernel launches made by this engine's batches (0 on the
            # CPU): the sum, and one count per kernel.
            "kernel_launches": 0,
            **{f"kernel_launches_{k}": 0 for k in KERNELS},
            # Topology arbitration: batches with a DoNotSchedule slot
            # (each reads the caps' any_enforced once, the step's one
            # wait on the card there), batches run on a node sample,
            # pods the host arbitration revoked
            # (and of them, those with a hard slot on a group the caps
            # scan enforced), pods the in-cycle repair placed.
            "hard_spread_batches": 0, "sampled_batches": 0,
            "spread_revoked": 0,
            "spread_revoked_enforced": 0, "spread_repaired": 0,
            # Batches whose carried free input had a nomination reserve
            # subtracted (and added back before free_after was adopted).
            "residency_nomination_carries": 0,
            # Post-outage reconciles of the queue against store truth
            # (reconcile_store, run on a RemoteStore's reattach).
            "store_reconciles": 0,
            "last_batch_size": 0,
        }
        # Rolling ring of metrics() snapshots (obs/timeseries.py). Always
        # constructed; ticked only while TIMELINE.enabled (one attribute
        # test per resolved batch when disarmed).
        self._timeline = TimelineTracker(self.metrics, name=self.profile)
        # Per-pod decision provenance, written only while the journal is
        # armed.
        self._provenance = ProvenanceStore()
        # SLO sentinel, built from the epoch-current process config at
        # the first armed snapshot.
        self._slo_sentinel: Optional[slo_mod.SLOSentinel] = None
        self._slo_epoch = -1
        # Overload controller (engine/overload.py): admission control,
        # batch/window/shortlist tuning and the brownout rung. Every hook
        # gates on the process-wide enabled flag or the controller's
        # level, so disarmed decisions are unchanged.
        self._overload = overload_mod.OverloadController(name=self.profile)
        # Base shortlist width the tuner retunes around; a permanent
        # certification revert (_shortlist_k = None) wins over any target.
        self._sl_base = self._shortlist_k
        self.queue.set_admission(
            self._overload.admits,
            backoff_fn=lambda: (overload_mod.OVERLOAD.shed_backoff,
                                overload_mod.OVERLOAD.shed_backoff_max))

    # ---- lifecycle -----------------------------------------------------

    def wants_pod(self, pod) -> bool:
        """Does this scheduler handle the pod? Profile routing by
        ``spec.scheduler_name`` (an engine without a routing set takes
        every pod), then, in a fleet, the shard filter: the pod's hash
        shard (fleet/shardmap.py) must be one this replica owns. The
        shard view is one tuple load: no lock, no store round trip."""
        if not (self.scheduler_names is None
                or pod.spec.scheduler_name in self.scheduler_names):
            return False
        n_shards, owned, _epoch = self._shard_view
        if n_shards:
            return shard_of(pod.key, n_shards) in owned
        return True

    # ---- fleet shard ownership (fleet/supervisor.py) -------------------

    @property
    def shard_view(self):
        """(n_shards, owned frozenset, epoch): the fleet ownership view;
        (0, frozenset(), 0) when sharding is off."""
        return self._shard_view

    def set_shards(self, owned, n_shards: int, *, epoch: int = 0) -> None:
        """Replace this replica's owned shards in one store of the tuple.
        The supervisor calls it BEFORE start() for the first deal (the
        informer's first sync consults wants_pod as it delivers); later
        calls come through adopt_shards / release_shards."""
        self._shard_view = (int(n_shards), frozenset(owned), int(epoch))

    def set_bind_guard(self, fn) -> None:
        """Install the fleet bind fence: ``fn(pod_key) -> bool`` (False:
        this replica lost the pod's shard; withhold the commit)."""
        self._bind_guard = fn

    def adopt_shards(self, shards, *, epoch: int = 0,
                     reason: str = "") -> int:
        """The takeover: extend the owned shards and drain the dead
        owner's pending work. Every unbound store pod that now routes
        here is gathered into the active queue (its keyed dedupe skips
        pods already queued or in flight), including the pods of ring
        slots an abandoned owner staged and never committed. Returns the
        number of pods adopted."""
        n_shards, owned, _ = self._shard_view
        self.set_shards(owned | set(shards), n_shards, epoch=epoch)
        adopted = [p for p in self.store.list("Pod")
                   if not p.spec.node_name and self.wants_pod(p)]
        if adopted:
            self.queue.add_many(adopted)
        jnote("fleet.adopt", profile=self.profile, replica=self.replica,
              shards=",".join(str(s) for s in sorted(shards)),
              epoch=epoch, pods=len(adopted), reason=reason)
        return len(adopted)

    def release_shards(self, shards, *, epoch: int = 0,
                       reason: str = "") -> int:
        """Shard handoff on lease loss: shrink the owned shards and drop
        every QUEUED pod this replica no longer owns (pods in flight
        resolve through the bind fence and the store's CAS). Returns the
        number of pods released."""
        n_shards, owned, _ = self._shard_view
        self.set_shards(owned - set(shards), n_shards, epoch=epoch)
        released = self.queue.release_unwanted(self.wants_pod)
        jnote("fleet.release", profile=self.profile, replica=self.replica,
              shards=",".join(str(s) for s in sorted(shards)),
              epoch=epoch, pods=len(released), reason=reason)
        return len(released)

    def reconcile_store(self, *, reason: str = "") -> Dict[str, int]:
        """Reconcile the queue against store truth after a store outage:
        drop every QUEUED pod the store already shows bound (a bind that
        committed before the outage is not tried again), then re-gather
        every unbound pod this engine routes (the queue's keyed dedupe
        skips pods already queued or in flight). Both halves come from
        the store, never from the engine's memory of before the outage.
        Returns the counts dropped and requeued."""
        pods = self.store.list("Pod")
        bound = {p.key for p in pods if p.spec.node_name}
        dropped = self.queue.release_unwanted(
            lambda p: p.key not in bound and self.wants_pod(p))
        requeue = [p for p in pods
                   if not p.spec.node_name and self.wants_pod(p)]
        if requeue:
            self.queue.add_many(requeue)
        with self._metrics_lock:
            self._metrics["store_reconciles"] += 1
        jnote("engine.reconcile", profile=self.profile,
              replica=self.replica, dropped=len(dropped),
              requeued=len(requeue), reason=reason)
        return {"dropped": len(dropped), "requeued": len(requeue)}

    def start(self) -> None:
        """Start the informers + this engine's scheduling loop
        (reference scheduler.go:72-75)."""
        GC_WATCH.install()
        self._shared.ensure_started()
        jnote("engine.start", profile=self.profile, replica=self.replica,
              mode="pipelined" if self.config.pipeline else "sync",
              resident=bool(self._residency is not None),
              shortlist_k=int(self._shortlist_k or 0),
              loop=bool(self._loop_enabled),
              index=bool(self._index is not None))
        self._thread = threading.Thread(target=self.run, daemon=True,
                                        name="scheduling-loop")
        self._thread.start()

    def abandon(self) -> None:
        """Crash-stop, the model of a killed process: stop the loop and
        skip every graceful drain (no commit wait, no recorder drain, no
        event flush). Ring slots staged past the point where the flag is
        seen are dropped without being resolved or committed; their pods
        stay pending in the store."""
        self._abandoned = True
        self._stop.set()
        self.queue.close()
        jnote("engine.abandon", profile=self.profile, replica=self.replica)
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        self._binder.shutdown(wait=False)
        self._committer.shutdown(wait=False)
        self._gatherer.shutdown(wait=False)
        if self._owns_shared:
            self._shared.shutdown()
        if self.recorder is not None:
            self.recorder.close()
        self.broadcaster.close()

    def shutdown(self) -> None:
        self._stop.set()
        self.queue.close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        self._committer.shutdown(wait=True)
        self._gatherer.shutdown(wait=False)
        if self._owns_shared:
            self._shared.shutdown()
        self._binder.shutdown(wait=False)
        if self.recorder is not None:
            # Past one flush's full retry backoff (~6 s at the defaults),
            # so a flush mid-retry is not abandoned silently.
            if not self.recorder.drain(timeout=8.0):
                log.warning("unflushed scheduling results at shutdown: %s",
                            self.recorder.pending_keys()[:10])
            self.recorder.close()
        self.broadcaster.flush(timeout=2.0)
        self.broadcaster.close()

    def _pop(self) -> List[QueuedPodInfo]:
        max_n, window, idle = self._pop_params()
        return self.queue.pop_batch(max_n, timeout=0.2,
                                    gather_window=window, gather_idle=idle)

    def _pop_params(self):
        """(max_n, gather_window, gather_idle) for the next queue pop:
        the config's, unless the overload tuner is engaged (batch stepped
        down toward ``min_batch``, formation window stepped up). At tune
        depth 0 the config passes through untouched."""
        cfg = self.config
        ov = self._overload
        if ov.tune_steps == 0:
            return cfg.max_batch_size, cfg.batch_window_s, cfg.batch_idle_s
        return (ov.effective_max_batch(cfg.max_batch_size),
                ov.effective_window(cfg.batch_window_s),
                ov.effective_idle(cfg.batch_idle_s))

    def _book_gap(self, component: str, dt: float) -> None:
        """Book inter-batch glue into gap_s_total, tagged with its
        component (gather/encode/commit; the fetch slot is booked at
        commit). Scheduling thread only: the next prepare adopts the
        pending dict, so the per-batch series attribute each wait to the
        batch it preceded."""
        if dt <= 0.0:
            return
        with self._metrics_lock:
            self._metrics["gap_s_total"] += dt
            self._metrics[f"gap_{component}_s_total"] += dt
        self._gap_pending[component] = (
            self._gap_pending.get(component, 0.0) + dt)

    def run(self) -> None:
        """The scheduling loop (reference minisched.go:28-30
        wait.UntilWithContext(ctx, scheduleOne, 0)); each iteration
        schedules a whole batch. With ``config.pipeline`` the loop is the
        bounded two-deep pipeline of _run_pipelined."""
        if self.config.pipeline:
            self._run_pipelined()
            return
        last_done = None
        while not self._stop.is_set():
            batch = self._pop()
            if not batch:
                # Idle (no pending pods) is not inter-batch overhead.
                last_done = None
                continue
            # Batch-to-batch dead time, spent inside the pop: gather glue.
            if last_done is not None:
                self._book_gap("gather", time.perf_counter() - last_done)
            if not self._maybe_run_tranche(batch):
                self._schedule_guarded(batch)
            last_done = time.perf_counter()

    def _schedule_guarded(self, batch: List[QueuedPodInfo]) -> None:
        """One synchronous cycle; a fault engages the supervisor."""
        try:
            self.schedule_batch(batch)
        except Exception:
            log.exception("schedule_batch failed; engaging supervisor")
            self._supervised_retry(batch)

    def _supervised_retry(self, batch: List[QueuedPodInfo],
                          b: Optional[_Batch] = None) -> None:
        """Contain a batch fault. The aborted attempt's assumes were
        rolled back (_resolve_batch) and pods it handed to async owners
        are excluded, so nothing can double-bind. The rest retries inline
        down the degradation ladder, each rung dropping one fast path; a
        batch that still fails at the bottom rung is quarantined:
        requeued at the backoff ceiling, so a poison batch can neither
        wedge the loop nor lose its pods."""
        self._sup_count("batch_faults")
        # Every replay rewinds the step counter to the aborted attempt's
        # anchor, so it draws the randomness the fault-free run would
        # have drawn: recovered decisions are bit-identical.
        anchor = self._prep_step0
        retry = list(batch)
        if b is not None and b.detached:
            retry = [q for q in retry if q.pod.key not in b.detached]
        while True:
            with self._detached_lock:
                live = self._detached_live
                retry = [q for q in retry if q.pod.key not in live]
            if not retry:
                return
            self._sup.escalate("batch fault")
            if self._sup.level >= len(DEGRADATION_LADDER) - 1:
                self._sup_count("quarantined_batches")
                self._step_counter = anchor  # no decision consumed it
                for qpi in retry:
                    self.queue.quarantine(qpi)
                jnote("supervisor.quarantine", profile=self.profile,
                      replica=self.replica, pods=len(retry),
                      batch=self._batch_seq, step=anchor)
                bundle_mod.capture(
                    "quarantine", scheduler=self,
                    reason=f"degradation ladder exhausted; "
                           f"{len(retry)} pod(s) quarantined")
                log.error("supervisor: exhausted the degradation ladder; "
                          "quarantined %d pods (requeued at the backoff "
                          "ceiling)", len(retry))
                return
            self._sup_count("batch_retries")
            self._step_counter = anchor  # replay, don't advance
            try:
                self.schedule_batch(list(retry))
                jnote("supervisor.retry", profile=self.profile,
                      replica=self.replica, outcome="ok",
                      rung=DEGRADATION_LADDER[self._sup.level],
                      pods=len(retry), batch=self._batch_seq, step=anchor)
                return
            except Exception:
                jnote("supervisor.retry", profile=self.profile,
                      replica=self.replica, outcome="failed",
                      rung=DEGRADATION_LADDER[self._sup.level],
                      pods=len(retry), batch=self._batch_seq, step=anchor)
                log.exception("degraded retry failed at rung %r; "
                              "escalating further",
                              DEGRADATION_LADDER[self._sup.level])

    def _run_pipelined(self) -> None:
        """Bounded two-deep pipelined scheduling loop.

        While batch k's step runs on the device, the host (a) flushes
        batch k-1's commit work on the commit worker and (b) gathers
        batch k+1 from the queue on the gather worker. Batch k+1 is
        ENCODED only after batch k's arbitration + assume accounting
        (_resolve_batch): encode sees cache state that already includes
        k's assumed placements, so decisions are bit-identical to the
        synchronous loop. In-flight work is bounded: one dispatched
        step + one commit flush.

        Where the host waits: PyTorch launches the step's kernels
        asynchronously, but gang_admission reads ``failing.any()`` on
        the host after the first assignment attempt, so the dispatch
        returns only once that attempt has run on the device. The
        overlap is then the commit and gather workers' host work against
        the next prepare, the pack and the fetch.

            sched:  ...| resolve k | commit k-1 wait | enc+step k+1 |
            commit:    [... flush k-1 (worker) ...]   [... flush k ...
            gather:    [pop k+1]                      [pop k+2 ...
        """
        inflight = None            # prepared + dispatched, not resolved
        pending = None             # (future, batch) commit in flight
        gather_fut = None          # in-flight pop on the gather worker
        last_done = None           # the gap clock (see _book_gap)
        try:
            while not self._stop.is_set():
                if inflight is None:
                    if gather_fut is not None:
                        # The last_done booking below covers this wait.
                        with span("gather.wait"):
                            batch = gather_fut.result()
                        gather_fut = None
                    else:
                        batch = self._pop()
                    if not batch:
                        last_done = None
                        pending = self._await_commit(pending)
                        continue
                    if last_done is not None:
                        self._book_gap("gather",
                                       time.perf_counter() - last_done)
                    inflight, pending = self._prepare_guarded(batch,
                                                              pending)
                    if inflight is None:
                        # Ran synchronously (or failed): the next gap
                        # starts after it.
                        last_done = time.perf_counter()
                    continue
                if gather_fut is None and not self._stop.is_set():
                    try:
                        gather_fut = self._gatherer.submit(self._pop)
                    except RuntimeError:  # executor torn down (shutdown)
                        gather_fut = None
                pending = self._finish(inflight, pending)
                last_done = time.perf_counter()
                nxt = []
                if gather_fut is not None and not self._stop.is_set():
                    nxt = self._take_gather(gather_fut) or []
                    gather_fut = None
                inflight = None
                if nxt:
                    inflight, pending = self._prepare_guarded(nxt, pending)
                    if inflight is None:
                        last_done = time.perf_counter()
        finally:
            # Drain: a dispatched batch is completed, then the last
            # commit is awaited. A gather that raced the stop and popped
            # pods must not lose them.
            if inflight is not None:
                pending = self._finish(inflight, pending)
            if gather_fut is not None:
                for qpi in gather_fut.result():
                    self.queue.requeue_backoff(qpi)
            self._await_commit(pending)

    def _take_gather(self, gather_fut):
        """Consume an overlapped pop, booking the blocking part of a
        productive wait as gather gap (the synchronous loop's pop waits
        land there too). An empty result is idle and books nothing."""
        t0 = time.perf_counter()
        with span("gather.wait"):
            batch = gather_fut.result()
        waited = time.perf_counter() - t0
        if batch:
            self._book_gap("gather", waited)
        return batch

    def _prepare_guarded(self, batch, pending):
        """Prepare (encode + dispatch) a popped batch → (batch in flight
        or None, pending). An armed trace request (the whole cycle must
        sit in one profiler scope) and the supervisor's sync rung drain
        the pipeline and run the batch's whole cycle here; a failed
        prepare engages the supervisor."""
        with self._trace_lock:
            trace_armed = self._trace_dir is not None
        if trace_armed or self._sup.sync_only():
            pending = self._await_commit(pending)
            self._schedule_guarded(batch)
            return None, pending
        if self._loop_gates_open() and self._loop_safe(batch):
            # A device-loop tranche commits inline on this thread, so the
            # previous batch's flush lands first (commit order). A
            # decline (no second ready batch) falls through to the
            # normal prepare, the pipeline merely drained one slot early.
            pending = self._await_commit(pending)
            if self._maybe_run_tranche(batch, checked=True):
                return None, pending
        try:
            return self._prepare_batch(batch), pending
        except Exception:
            log.exception("batch prepare failed; engaging supervisor")
            self._supervised_retry(batch)
            return None, pending

    def _finish(self, b: _Batch, pending):
        """Resolve ``b``, then commit it: on the commit worker when it
        has failure verdicts to flush (after the previous commit lands),
        inline when the commit is only a metrics fold. A failed resolve
        engages the supervisor and skips the commit."""
        try:
            self._resolve_batch(b)
        except Exception:
            log.exception("batch resolve failed; engaging supervisor")
            self._supervised_retry(b.batch, b)
            return pending
        if not b.failures:
            self._commit_guarded(b)
            return pending
        pending = self._await_commit(pending)
        try:
            return self._committer.submit(self._commit_guarded, b), b
        except RuntimeError:  # executor torn down (shutdown race)
            self._commit_guarded(b)
            return None

    def _commit_guarded(self, b: _Batch) -> None:
        try:
            self._commit_batch(b)
        except FaultWorkerDeath:
            raise  # worker death: _await_commit restarts the worker
        except Exception:
            log.exception("batch commit failed")

    def _await_commit(self, pending):
        """Bound the pipeline at ONE commit in flight; a commit worker
        that died mid-flush is replaced."""
        if pending is None:
            return None
        fut, b = pending
        t0 = time.perf_counter()
        try:
            with span("commit.wait"):
                fut.result()
        except FaultWorkerDeath:
            self._restart_commit_worker(b)
            return None
        waited = time.perf_counter() - t0
        # The exposed flush wait is the commit slot of the gap; the part
        # of the flush the scheduling thread did not wait for overlapped.
        self._book_gap("commit", waited)
        flush = max(0.0, b.commit_t1 - b.commit_t0)
        with self._metrics_lock:
            self._metrics["commit_overlap_s"] += max(0.0, flush - waited)
        return None

    def _restart_commit_worker(self, b: _Batch) -> None:
        """The commit worker died mid-flush: replace the executor,
        requeue the dead flush's tranche with backoff (its status writes
        never applied, and nothing else would revive the popped pods),
        and degrade."""
        log.error("commit worker died mid-flush; restarting the worker "
                  "and requeueing its %d-pod tranche", len(b.failures))
        self._sup_count("worker_deaths")
        self._sup.escalate("commit worker death")
        self._committer.shutdown(wait=False)
        self._committer = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="commit")
        for qpi, _plugins, _msg, _retry in b.failures:
            self.queue.requeue_backoff(qpi)

    # ---- device loop (config.device_loop) ------------------------------

    def _effective_loop_depth(self) -> int:
        """Ring depth for the next tranche: the configured depth, halved
        per overload tune step (floor 1: the loop disengaged)."""
        return self._overload.effective_loop_depth(self.config.loop_depth)

    def _loop_gates_open(self) -> bool:
        """The tranche's gates that hold whatever the batch's pods: the
        fast rung only, no nomination reserve, no permit profile, no
        explain recorder, no armed shortlist cross-check (its full-width
        replay needs per-batch inputs), no armed trace, no instance-
        patched schedule_batch, the first slim fetch verified (that
        check runs per batch), and no loop cooldown."""
        if not self._loop_enabled or self._loop_cooldown > 0:
            return False
        if (self.recorder is not None or self.plugin_set.permit_plugins
                or self._nominations or self._sup.level != 0
                or self.config.shortlist_check_every):
            return False
        with self._trace_lock:
            if self._trace_dir is not None:
                return False
        if "schedule_batch" in self.__dict__:
            return False
        if self._slim and not self._slim_verified:
            return False
        return self._effective_loop_depth() >= 2

    def _loop_safe(self, batch: List[QueuedPodInfo]) -> bool:
        """May this batch ride the ring? Its pods pass the shared safety
        walk (_ring_safe_pods), and the per-batch path would not sample
        nodes for it: the ring runs the full node axis, and a sampled
        step draws another key path."""
        if not self._ring_safe_pods(batch):
            return False
        n_pad = self._node_pad(self.cache.rows_high_water())
        return self._sampled_step(n_pad, len(batch), False)[1] is None

    def _ring_safe_pods(self, batch: List[QueuedPodInfo]) -> bool:
        """The per-pod safety walk shared by the device loop and the
        maintained index: every pod's decision is independent of host
        state neither can carry. No gangs (quorum spans batches), no pod
        (anti-)affinity and no spread constraints (they read the
        assigned corpus), no volumes (the RWO arbitration and the claim
        table live on the host), no host ports (the cache's bulk assume
        debits port pods out of pod order, which would break the
        bitwise mirror check), and no owner references when
        SelectorSpread runs (owner groups read the corpus too)."""
        for q in batch:
            pod = q.pod
            sp = pod.spec
            if (sp.pod_group or sp.topology_spread_constraints
                    or sp.volumes or sp.ports):
                return False
            a = sp.affinity
            if a is not None and (a.pod_affinity is not None
                                  or a.pod_anti_affinity is not None):
                return False
            if self._selspread_enabled and pod.metadata.owner_references:
                return False
        return True

    def _tenant_fusable(self, batch: List[QueuedPodInfo], hard_spread: bool,
                        fail_closed) -> bool:
        """May this batch ride a fused tenant dispatch? The index's and
        the loop's posture: greedy, the fast rung only, no nominations
        (their reserve changes the step's free input outside the fused
        staging), no explain recorder, no armed shortlist cross-check
        (its attribution is per batch; the index cross-check is allowed
        while the index is live: it certifies a fused indexed serve as a
        solo one), no fail-closed verdict, no hard-spread arbitration,
        and the shared per-pod walk (_ring_safe_pods), which also keeps
        the spread fetch away. Other batches dispatch solo inside
        prepare."""
        if (self.config.assignment != "greedy" or self._mesh is not None
                or self.config.explain or self.recorder is not None):
            return False
        if (self._sup.level != 0 or self._nominations or fail_closed
                or hard_spread or self.config.shortlist_check_every
                or (self.config.index_check_every
                    and self._index is None)):
            return False
        return self._ring_safe_pods(batch)

    def _maybe_run_tranche(self, batch: List[QueuedPodInfo], *,
                           checked: bool = False) -> bool:
        """Run ``batch`` and up to depth-1 further ready batches as one
        tranche. True when the pods were consumed (run as a tranche, or
        per batch after a break); False: the caller schedules ``batch``.
        The ring pops with timeout 0, so only pods already queued join
        and a shallow stream runs per batch with no added latency.
        ``checked``: the caller ran the per-pod walk; the gates are
        checked again all the same (the commit drain before this call
        can escalate the supervisor)."""
        if not (self._loop_gates_open()
                and (checked or self._loop_safe(batch))):
            return False
        depth = self._effective_loop_depth()
        max_n, _window, _idle = self._pop_params()
        slots: List[List[QueuedPodInfo]] = [batch]
        held: Optional[List[QueuedPodInfo]] = None
        while len(slots) < depth:
            nxt = self.queue.pop_batch(max_n, timeout=0.0)
            if not nxt:
                break
            if not self._loop_safe(nxt):
                held = nxt
                break
            slots.append(nxt)
        if len(slots) < 2:
            if held is None:
                return False
            # A second batch was popped but cannot ride the ring: both
            # run per batch, in pop order.
            self._schedule_guarded(batch)
            self._schedule_guarded(held)
            return True
        self._run_tranche(slots)
        if held is not None:
            self._schedule_guarded(held)
        return True

    def _loop_break(self, reason: str, *, slot: int) -> None:
        """Back to per-batch dispatch: counted, traced, journaled, and
        the carried residency dropped (the tranche's final free holds
        every staged slot's debits, the invalidated ones included)."""
        self._sup_count("loop_breaks")
        instant("loop.break", reason=reason, slot=slot)
        jnote("loop.break", profile=self.profile, replica=self.replica,
              reason=reason, slot=slot, batch=self._batch_seq)
        res = self._residency
        if res is not None:
            res.drop(f"device-loop break: {reason}")

    def _loop_probation(self) -> None:
        """Engage the loop→pipelined rung after a fault's containment
        (set here, not in the break: every resolved batch, the replay
        tail's included, pays one cooldown tick)."""
        self._loop_cooldown = max(1, self.config.probation_batches)

    def _replay_tail(self, slot_batches, start: int,
                     anchor: Optional[int]) -> None:
        """Replay the unconsumed slots per batch with their original PRNG
        draws. With ``anchor`` the step counter rewinds to the first
        unconsumed slot's draw; the slot-fault path passes None, since
        the supervised retry already left the counter where a run
        without the loop would have it."""
        if anchor is not None:
            self._step_counter = anchor + start
        for bt in slot_batches[start:]:
            self._schedule_guarded(bt)

    def _run_tranche(self, slot_batches: List[List[QueuedPodInfo]]) -> None:
        """One tranche end to end. A machinery fault (staging, dispatch,
        the stacked fetch, the validator) never loses a pod: every slot
        that did not consume its decision replays per batch."""
        progress = {"done": 0}
        anchor = self._step_counter
        try:
            self._run_tranche_impl(slot_batches, progress, anchor)
        except Exception:
            log.exception("device-loop tranche failed; replaying the "
                          "remaining slots per batch")
            self._loop_break("tranche machinery fault",
                             slot=progress["done"])
            self._replay_tail(slot_batches, progress["done"], anchor)
            self._loop_probation()

    def _run_tranche_impl(self, slot_batches, progress, anchor) -> None:
        cfg = self.config
        n_slots = len(slot_batches)
        res = self._residency
        dev = self.device
        # Baseline-drain the loop listener BEFORE the snapshot: a mark
        # landing between the drain and the snapshot is inside the
        # snapshot's truth, so seeing it again at slot 0 costs at worst a
        # conservative break, where a drain after the snapshot could
        # discard a real divergence.
        self.cache.drain_dyn_rows(self._loop_listener)

        # One snapshot and carry attach for the whole tranche; an attach
        # or cross-check failure goes to the containment (the replay
        # re-snapshots per batch).
        cached = self._nf_static_device
        known = cached[0] if cached else None
        res_live = (res is not None and not self._nominations
                    and self._sup.allows_residency())
        if res_live:
            nf, names, static_v, row_incs, delta = (
                self.cache.snapshot_resident(pad=self._node_pad,
                                             known_static=known,
                                             dyn=res.listener))
        else:
            nf, names, static_v, row_incs = self.cache.snapshot_versioned(
                pad=self._node_pad, known_static=known)
            delta = None
        nf = self._with_device_static(nf, static_v, row_incs.shape[0])
        carried = False
        if res_live:
            act = FAULTS.hit("residency")
            with span("h2d.dyn"):
                nf = res.attach(self, nf, delta)
            carried = True
            if act == "corrupt" and res.mirror_free is not None:
                res.mirror_free[0, :] += 1.0
            if cfg.resident_check_every:
                self._check_resident_carry(res, nf)
        # The tranche's host twins of the carried chain: each slot's
        # debits fold into ``mirror`` and the validator compares the
        # rows the cache marked against it; ``pmirror`` is compared only
        # (no ring slot inserts a port).
        if carried:
            mirror = res.mirror_free.copy()
            pmirror = res.mirror_ports
        else:
            mirror = np.array(nf.free, copy=True)
            pmirror = np.array(nf.used_ports, copy=True)
            # One full dynamic upload per tranche.
            self._count_h2d(nf.free.nbytes + pmirror.nbytes)
            nf = nf._replace(free=to_torch(nf.free, dev),
                             used_ports=to_torch(nf.used_ports, dev))
        af = to_torch(self.cache.snapshot_assigned(pad=self._af_pad), dev)

        # Stage the ring: every slot encoded at one pod pad, on the card
        # before the first slot runs.
        P_ring = step_bucket(max(len(bt) for bt in slot_batches),
                             cfg.pod_bucket_min)
        slots: List[_Batch] = []
        counters: List[int] = []
        for bt in slot_batches:
            # The step gate, once per slot as on the per-batch path: an
            # err here aborts into the containment.
            FAULTS.hit("step")
            slots.append(self._stage_slot(bt, P_ring, nf, names, af,
                                          row_incs))
            counters.append(self._step_counter)

        # One dispatch of every slot, one stacked fetch.
        loop_fn = build_loop_step(self.plugin_set,
                                  assignment=cfg.assignment,
                                  shortlist=self._shortlist_k,
                                  slim=self._slim)
        before = dict(thread_launches())
        t_disp0 = time.perf_counter()
        with span("loop.dispatch", slots=n_slots):
            packed_dev, free_final = loop_fn(
                [b.eb_dev for b in slots], nf, af, [b.key for b in slots])
        self._fold_launches(before)
        self._sup_count("steps_dispatched")
        self._sup_count("loop_tranches")
        self._sup_count("loop_iterations", n_slots)
        with self._host_sync("fetch.loop", slots[0].seq, slots=n_slots):
            stack = np.array(packed_dev.cpu().numpy())
        t_fetched = time.perf_counter()
        self._count_fetch(stack.nbytes)
        self._sup_count("decision_fetches")
        if FAULTS.hit("fetch") == "corrupt":
            # Every slot's chosen plane scribbled: the resolve sanity
            # detector catches slot 0 and the containment replays the
            # rest without losing a pod.
            if self._slim:
                stack[:, :4 * P_ring] = 0x7F
            else:
                stack[:, 0, :] = 0x7F7F7F7F
        share = max(0.0, t_fetched - t_disp0) / n_slots

        # Per slot: resolve, commit, then check host truth against the
        # carried chain before the next slot's decisions are consumed.
        n_filters = len(self.filter_names)
        for j, b in enumerate(slots):
            if self._abandoned:
                # Crash-stop: slots [j:] are staged but never resolved
                # or committed; their pods stay pending in the store. No
                # replay and no carry adoption: a dead process does
                # neither.
                self._sup_count("loop_abandoned_slots", n_slots - j)
                jnote("loop.abandon", profile=self.profile,
                      replica=self.replica, slot=j, slots_staged=n_slots,
                      pods_staged=sum(len(bt)
                                      for bt in slot_batches[j:]))
                return
            buf = stack[j]
            tup = (unpack_decision_slim(buf, P_ring, n_filters)
                   if self._slim else unpack_decision_i32(buf))
            b.packed_dev = tup
            b.step_share = share
            b.loop_slot = j
            b.t_dispatch = t_disp0
            self._prep_step0 = counters[j] - 1
            try:
                self._resolve_batch(b)
            except Exception:
                log.exception("device-loop slot resolve failed; "
                              "engaging supervisor")
                self._supervised_retry(b.batch, b)
                progress["done"] = j + 1
                self._loop_break("slot fault", slot=j)
                # anchor None: the supervised retry left the counter
                # where a run without the loop would have it.
                self._replay_tail(slot_batches, j + 1, None)
                self._loop_probation()
                return
            # Consumed once resolve returns (assumes made, binds
            # submitted): no containment may schedule it again.
            progress["done"] = j + 1
            try:
                self._commit_batch(b)
            except FaultWorkerDeath:
                log.error("commit flush died in a device-loop slot; "
                          "requeueing its %d-pod tranche", len(b.failures))
                self._sup_count("worker_deaths")
                self._sup.escalate("commit flush death")
                for qpi, _plugins, _msg, _retry in b.failures:
                    self.queue.requeue_backoff(qpi)

            # Did host truth move off the carried chain? Fold this slot's
            # debits into the mirror as the order-free per-node aggregate
            # (bitwise the scan's sequential carry under the
            # exact-integer resource grammar, _DeviceResidency I1), then
            # compare every row the cache marked since the last slot. A
            # mismatch (an assume miss, a failed bind, informer churn, a
            # revocation) means slot j+1 was computed against inputs the
            # per-batch path would not have fed it: break and replay.
            ch, asg = tup[0], tup[1]
            rows_deb = ch[asg].astype(np.int64)
            if rows_deb.size:
                uniq_deb = np.unique(rows_deb)
                agg = np.zeros((uniq_deb.shape[0], mirror.shape[1]),
                               dtype=mirror.dtype)
                np.add.at(agg, np.searchsorted(uniq_deb, rows_deb),
                          b.eb.pf.requests[asg])
                mirror[uniq_deb] -= agg
            diverged = bool(
                rows_deb.size
                and not np.isfinite(mirror[np.unique(rows_deb)]).all())
            rows, fvals, pvals = self.cache.drain_dyn_rows(
                self._loop_listener)
            if not diverged and rows.size:
                # A row outside the tranche's pad (a node add that grew
                # the cache mid-tranche) diverges by definition: the
                # per-batch path would re-snapshot at the bigger pad.
                if int(rows[-1]) >= mirror.shape[0]:
                    diverged = True
                else:
                    diverged = (not np.array_equal(fvals, mirror[rows])
                                or not np.array_equal(pvals,
                                                      pmirror[rows]))
            if not diverged and self._nominations:
                # A nomination reserves capacity the carried chain cannot
                # represent.
                diverged = True
            if diverged:
                if j < n_slots - 1:
                    self._loop_break("carry divergence", slot=j)
                    self._replay_tail(slot_batches, j + 1, anchor)
                else:
                    # Every decision consumed; only the carry adoption
                    # is off: drop it (the next batch re-uploads).
                    self._loop_break("tail divergence", slot=j)
                return

        # Clean completion: adopt the tranche's carry.
        if carried:
            res.free_dev = free_final
            res.mirror_free = mirror
            res.pending_rows = res.pending_pre = None
            res.pending_prows = res.pending_ppre = None

    def _stage_slot(self, batch: List[QueuedPodInfo], P_ring: int,
                    nf, names, af, row_incs) -> _Batch:
        """Encode one ring slot at the tranche's pod pad and put it on the
        device: the prepare phase without the snapshot and the dispatch.
        A ragged slot pads with invalid rows, which every assignment
        masks, so its real rows decide as at their own bucket."""
        b = _Batch()
        b.t0 = time.perf_counter()
        b.c0 = time.thread_time()
        self._prep_step0 = self._step_counter
        self._step_counter += 1
        with self._metrics_lock:
            b.h2d0 = self._metrics["h2d_bytes_total"]
            b.fetch0 = self._metrics["fetch_bytes_total"]
        batch = sorted(batch, key=lambda q: -q.pod.spec.priority)
        pods = [q.pod for q in batch]
        b.t_enc0 = time.perf_counter()
        self._book_gap("encode", b.t_enc0 - b.t0)
        b.gap, self._gap_pending = self._gap_pending, {}
        b.vol_memo, fail_closed, eb = self._encode_batch(batch, pods, P_ring,
                                                         loop_slot=True)
        if fail_closed:
            # Loop-safe pods cannot trip a slot limit themselves, but an
            # anti-affinity overflow from running pods still can: the
            # containment replays per batch, where fail-closed applies.
            raise EngineDesync("loop slot hit a fail-closed encode verdict")
        b.batch, b.eb, b.names, b.row_incs = batch, eb, names, row_incs
        b.eb_dev = to_torch(eb, self.device)
        b.nf, b.af = nf, af
        b.key = prng.fold_in(self._key, self._step_counter)
        b.sample_k = None
        # Every slot pays the full (P_ring, N) filter+score pass.
        b.scored_rows = int(P_ring) * int(nf.valid.shape[0])
        b.shapes = (int(P_ring), int(nf.valid.shape[0]),
                    int(af.valid.shape[0]))
        b.t_encode = b.t_dispatch = time.perf_counter()
        b.c_encode = time.thread_time()
        self._batch_seq += 1
        b.seq = self._batch_seq
        with self._metrics_lock:
            self._prep_window = (b.t_enc0, b.t_dispatch)
        return b

    def _fold_launches(self, before: Dict[str, int]) -> None:
        """Book the kernel launches this thread made since ``before`` (a
        ``thread_launches()`` copy) straight into the metrics: a
        tranche's launches belong to no single slot."""
        with self._metrics_lock:
            m = self._metrics
            for name, n in thread_launches().items():
                d = n - before[name]
                if d:
                    m["kernel_launches"] += d
                    m[f"kernel_launches_{name}"] += d

    # ---- one batched scheduling cycle ----------------------------------

    def trace_next_batch(self, trace_dir: str) -> None:
        """Capture a ``torch.profiler`` trace (host and, on a card, CUDA
        activity) of the next scheduling batch into ``trace_dir`` as a
        Chrome trace (``trace.json``). The batch runs its whole cycle
        synchronously inside the profiler scope."""
        with self._trace_lock:
            self._trace_dir = trace_dir
        os.makedirs(trace_dir, exist_ok=True)

    def dump_trace(self, path: str) -> str:
        """Export the process-wide flight recorder (obs.TRACE: spans at
        every engine seam, fault and ladder instants) as Chrome
        trace-event JSON. Arm it with MINISCHED_TRACE=1 (or
        obs.configure) first; an unarmed dump writes a valid, empty
        trace. Returns ``path``."""
        from ..obs import TRACE

        return TRACE.export_chrome(path)

    def schedule_batch(self, batch: List[QueuedPodInfo]) -> Decision:
        with self._trace_lock:
            trace_dir, self._trace_dir = self._trace_dir, None
        if trace_dir:
            return self._schedule_traced(batch, trace_dir)
        return self._schedule_batch_impl(batch)

    def _schedule_traced(self, batch: List[QueuedPodInfo],
                         trace_dir: str) -> Decision:
        """One cycle under ``torch.profiler``: CPU activity always, CUDA
        activity when the engine runs on a card. On a card a capture with
        no device event is an error, not an empty trace: it writes
        ``error.txt`` instead of ``trace.json`` (raising here would send
        an already committed batch into the supervised retry)."""
        from torch.profiler import ProfilerActivity, profile

        on_card = self.device.type == "cuda"
        acts = [ProfilerActivity.CPU]
        if on_card:
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            out = self._schedule_batch_impl(batch)
            if on_card:
                torch.cuda.synchronize(self.device)
        cuda = torch.autograd.DeviceType.CUDA
        if on_card and not any(e.device_type == cuda for e in prof.events()):
            msg = "the capture holds no CUDA activity"
            log.error("trace_next_batch: %s", msg)
            with open(os.path.join(trace_dir, "error.txt"), "w") as f:
                f.write(msg + "\n")
            return out
        # Written aside, then renamed: a reader polling for trace.json
        # never sees a partial file.
        path = os.path.join(trace_dir, "trace.json")
        prof.export_chrome_trace(path + ".tmp")
        os.replace(path + ".tmp", path)
        return out

    def _schedule_batch_impl(self, batch: List[QueuedPodInfo]) -> Decision:
        """One synchronous cycle: prepare → resolve → commit."""
        b = self._prepare_batch(batch)
        self._resolve_batch(b)
        try:
            self._commit_batch(b)
        except FaultWorkerDeath:
            # No worker to restart in the synchronous cycle: requeue the
            # tranche (retrying the whole batch would re-schedule pods
            # the binder already owns) and degrade.
            log.error("commit flush died in the synchronous cycle; "
                      "requeueing its %d-pod tranche", len(b.failures))
            self._sup_count("worker_deaths")
            self._sup.escalate("commit flush death")
            for qpi, _plugins, _msg, _retry in b.failures:
                self.queue.requeue_backoff(qpi)
        return b.decision

    def _node_pad(self, hw: int) -> int:
        """Node-axis pad: the eighth-step bucket of the cache's row
        high-water (50k nodes pad to 53248). Resolved under the snapshot
        lock (passed as a callable)."""
        return step_bucket(max(hw, 1), self.config.node_bucket_min)

    def _af_pad(self, hw: int) -> int:
        return bucket_for(max(hw, 1), 16)

    def _count_h2d(self, nbytes: int) -> None:
        with self._metrics_lock:
            self._metrics["h2d_bytes_total"] += nbytes

    def _count_fetch(self, nbytes: int) -> None:
        with self._metrics_lock:
            self._metrics["fetch_bytes_total"] += nbytes

    @contextlib.contextmanager
    def _host_sync(self, name: str, seq: int, blocking: bool = True,
                   **args):
        """The one seam of a blocking read of the card on a batch's path:
        the read's ``fetch.*`` span with the batch's ``seq``, one count in
        ``host_syncs_total`` and its wall seconds in
        ``fetch_wait_s_total``. ``blocking=False`` keeps the span and
        counts nothing (the rows are already on the host)."""
        t0 = time.perf_counter()
        try:
            with span(name, seq=seq, **args):
                yield
        finally:
            if blocking:
                dt = time.perf_counter() - t0
                with self._metrics_lock:
                    self._metrics["host_syncs_total"] += 1
                    self._metrics["fetch_wait_s_total"] += dt

    def _step_events(self) -> Optional[tuple]:
        """A (start, end) pair of CUDA timing events, the start recorded
        on the engine's stream before the solo step's first launch; None
        off the card and on a mesh."""
        if not self._time_steps:
            return None
        pool = self._step_event_pool
        ev = pool.pop() if pool else (torch.cuda.Event(enable_timing=True),
                                      torch.cuda.Event(enable_timing=True))
        ev[0].record(torch.cuda.current_stream(self.device))
        return ev

    def _read_step_events(self, b: _Batch) -> None:
        """The solo step's device span into ``b.device_span_s`` (the
        commit folds it into ``step_device_span_s_total`` beside
        ``step_s_total``), read after the decision fetch, which already
        waited on the stream past the end event: no further sync. It
        includes any time the card waited for the host's launches inside
        the step. The pair goes back to the pool (at most two: the
        pipeline's depth)."""
        ev, b.step_events = b.step_events, None
        if ev is None or not ev[1].query():
            return
        b.device_span_s = 1e-3 * ev[0].elapsed_time(ev[1])
        if len(self._step_event_pool) < 2:
            self._step_event_pool.append(ev)

    def _sup_count(self, key: str, n: int = 1) -> None:
        with self._metrics_lock:
            self._metrics[key] = self._metrics.get(key, 0) + n

    def _res_count(self, *, resync: bool, h2d: int) -> None:
        with self._metrics_lock:
            self._metrics["h2d_bytes_total"] += h2d
            if resync:
                self._metrics["residency_resyncs"] += 1
            else:
                self._metrics["residency_hits"] += 1

    def _with_device_static(self, nf, static_version: int, pad: int):
        """Swap the static node-feature leaves for device copies cached
        per (static version, pad); on a hit the snapshot elided their
        host copies."""
        key = (static_version, pad)
        cached = self._nf_static_device
        dynamic = NodeFeatureCache.DYNAMIC_NF_FIELDS
        if cached is None or cached[0] != key:
            host = {f: getattr(nf, f) for f in nf._fields
                    if f not in dynamic}
            leaves = {f: to_torch(a, self.device) for f, a in host.items()}
            # A tenant engine hashes the host arrays it uploads (the
            # mux's grouping token): never the device tensors, whose read
            # would make every round wait for the card.
            token = (static_token(host) if self._tenant_mux is not None
                     else None)
            self._nf_static_device = cached = (key, leaves, token)
            self._count_h2d(sum(a.nbytes for a in host.values()))
        return nf._replace(**cached[1])

    def _snapshot(self):
        """Node features for this batch: (nf with device leaves, names,
        row incarnations, carried). With residency (and the supervisor
        at its top rung) the dynamic leaves are the carried device arrays
        brought up to the cache's truth by a sparse correction; an
        attach error drops residency and falls back to a full snapshot,
        and a carry that fails its cross-check also degrades the engine.
        Otherwise they are uploaded whole."""
        cached = self._nf_static_device
        known = cached[0] if cached else None
        res = self._residency
        if res is not None and not self._sup.allows_residency():
            # Degraded: drop the carry; probation re-establishes it
            # through a counted full re-upload.
            res.drop("supervisor degradation")
        elif res is not None:
            nf, names, static_v, row_incs, delta = (
                self.cache.snapshot_resident(pad=self._node_pad,
                                             known_static=known,
                                             dyn=res.listener))
            nf = self._with_device_static(nf, static_v, row_incs.shape[0])
            try:
                # Fault gate: residency delta/carry. err → the resync
                # fallback below; corrupt → diverge the host mirror from
                # the device so the carry cross-check has a defect to
                # catch.
                act = FAULTS.hit("residency")
                with span("h2d.dyn"):
                    nf = res.attach(self, nf, delta)
                if act == "corrupt" and res.mirror_free is not None:
                    res.mirror_free[0, :] += 1.0
                if self.config.resident_check_every:
                    self._check_resident_carry(res, nf)
                return nf, names, row_incs, True
            except EngineDesync as e:
                log.warning("resident carry cross-check failed (%s); "
                            "forcing a full re-upload", e)
                self._sup_count("residency_desyncs")
                instant("residency.desync", reason=str(e))
                jnote("residency.desync", profile=self.profile,
                      replica=self.replica, reason=str(e),
                      batch=self._batch_seq)
                self._sup.escalate("resident carry desync")
                res.drop("carry cross-check mismatch")
                if self._index is not None:
                    # The index's last refresh scored against the carried
                    # free now distrusted: rebuild before it serves again.
                    self._index.invalidate("resident carry desync")
            except Exception:
                log.exception("device residency attach failed; resyncing "
                              "through a full snapshot")
                res.drop("attach error")
                if self._index is not None:
                    self._index.invalidate("residency attach error")
            cached = self._nf_static_device
            known = cached[0] if cached else None
        nf, names, static_v, row_incs = self.cache.snapshot_versioned(
            pad=self._node_pad, known_static=known)
        nf = self._with_device_static(nf, static_v, row_incs.shape[0])
        self._count_h2d(nf.free.nbytes + nf.used_ports.nbytes)
        nf = nf._replace(free=to_torch(nf.free, self.device),
                         used_ports=to_torch(nf.used_ports, self.device))
        return nf, names, row_incs, False

    def _check_resident_carry(self, res: _DeviceResidency, nf) -> None:
        """Every ``resident_check_every`` carried batches, fetch the
        carried device free and compare it to the host mirror before the
        step consumes it. Raises EngineDesync on any divergence (NaN
        included, which np.array_equal rejects)."""
        self._res_check_tick += 1
        if self._res_check_tick % self.config.resident_check_every:
            return
        # Before the batch's seq is assigned: the id it will get.
        with self._host_sync("fetch.carry", self._batch_seq + 1):
            dev = nf.free.cpu().numpy()
        self._count_fetch(dev.nbytes)
        self._sup_count("resident_checks")
        if res.mirror_free is not None and not np.array_equal(
                dev, res.mirror_free):
            bad = int(np.sum(np.any(dev != res.mirror_free, axis=1)))
            raise EngineDesync(
                f"device-carried free diverged from the host mirror on "
                f"{bad} row(s) at epoch {res.epoch}")

    def _sampled_step(self, n_pad: int, batch_len: int, full_axis: bool):
        """(step, K) for this batch, or (None, None) when node sampling
        does not apply: gang batches (quorum must be judged against one
        node set) and hard-spread batches (the in-scan domain caps run
        only unsampled) pass ``full_axis``; the percentage is 100; the cluster
        has fewer than 2 × min_sample_nodes real nodes; or K would reach
        half the node pad (the gather and residual then cost more than
        they save). Explain mode never samples: the recorded columns
        must line up with the full name table. K = the power-of-two
        bucket of max(min_sample_nodes, n × pct / 100, 2 × batch), pct 0
        meaning upstream's max(5, 50 - n / 125)."""
        cfg = self.config
        if cfg.explain or full_axis or self._mesh is not None:
            return None, None
        # Brownout (overload level 3) pulls the dial down to
        # ``brownout_pct``; otherwise the configured percentage.
        pct = self._overload.effective_pct_nodes(
            cfg.percentage_of_nodes_to_score)
        if pct >= 100:
            return None, None
        n_real = self.cache.node_count()
        if n_real < 2 * cfg.min_sample_nodes:
            return None, None
        if pct <= 0:
            pct = max(5, 50 - n_real // 125)
        want = max(cfg.min_sample_nodes, (n_real * pct) // 100,
                   2 * batch_len)
        k = bucket_for(want, cfg.node_bucket_min)
        if k >= n_pad // 2:
            return None, None
        return build_step(self.plugin_set, shortlist=self._shortlist_k,
                          sample_nodes=k,
                          assignment=cfg.assignment), k

    def _prepare_batch(self, batch: List[QueuedPodInfo]) -> _Batch:
        with span("prepare", pods=len(batch)) as sp:
            b = self._prepare_batch_impl(batch)
            sp.set(seq=b.seq)
            return b

    def _prepare_batch_impl(self, batch: List[QueuedPodInfo]) -> _Batch:
        b = _Batch()
        b.t0 = time.perf_counter()
        b.c0 = time.thread_time()
        cfg = self.config
        # Supervisor replay anchor: prepares run one after another on the
        # scheduling thread, so at any batch fault this is the step
        # counter the aborted attempt started from.
        self._prep_step0 = self._step_counter
        with self._metrics_lock:
            b.h2d0 = self._metrics["h2d_bytes_total"]
            b.fetch0 = self._metrics["fetch_bytes_total"]
        # Pull queued gang-mates so no batch boundary splits a gang (the
        # step would reject the partial group for missing quorum).
        for group in {gang_key(q.pod) for q in batch
                      if q.pod.spec.pod_group}:
            batch.extend(self.queue.pop_group(group))
        if len(batch) > cfg.max_batch_size:
            log.warning("batch grew to %d pods (> max_batch_size %d) "
                        "pulling gang mates", len(batch), cfg.max_batch_size)
        batch = sorted(batch, key=lambda q: -q.pod.spec.priority)
        pods = [q.pod for q in batch]
        b.t_enc0 = time.perf_counter()
        # Batch formation (gang pull + sort) is the encode slot of the
        # gap; then adopt every gap component booked since the previous
        # prepare, so the per-batch series attribute each wait to the
        # batch it preceded.
        self._book_gap("encode", b.t_enc0 - b.t0)
        b.gap, self._gap_pending = self._gap_pending, {}
        with self._metrics_lock:
            # Prepare started; the end is published at dispatch (None =
            # still preparing: a flush's overlap booking clips at its end).
            self._prep_window = (b.t_enc0, None)
        # Encode pods FIRST: constraints may register new topology keys,
        # which the node snapshot's domain tables must reflect.
        p_req = step_bucket(len(pods), cfg.pod_bucket_min)
        if self._tenant_mux is not None:
            # Ragged tenant batches pad to the fusion round's common pod
            # pad (the fused lanes share one P) with invalid rows, which
            # change no real row's decision.
            p_req = max(p_req, self._tenant_mux.round_pods)
        b.vol_memo, b.fail_closed, eb = self._encode_batch(batch, pods,
                                                           p_req)
        if self._index is not None:
            # Drain the index listener BEFORE the snapshot a refresh
            # evaluates against: a mutation landing after the drain is
            # caught by the version gate in _index_dispatch (a counted
            # race and the full step, never a stale serve).
            self._index.drain(self.cache)
        nf, names, row_incs, b.res_carried = self._snapshot()
        if self._nominations:
            # Nominated-capacity protection (upstream nominatedNodeName):
            # reservations of pods NOT in this batch are debited from the
            # step's free input, so the batch cannot steal them; a nominee
            # in the batch sees its own reservation as available. On a
            # carried input the reserve is subtracted from a fresh array
            # only, and resolve adds it back before adopting free_after
            # (note_debits add_back): the carried chain never holds it.
            reserved = self._nomination_debits({q.pod.key for q in batch},
                                               names, nf)
            if reserved is not None:
                reserved_dev = _device_copy(reserved, self.device)
                self._count_h2d(reserved.nbytes)
                if b.res_carried:
                    b.nom_reserved = reserved_dev
                    self._sup_count("residency_nomination_carries")
                nf = nf._replace(free=nf.free - reserved_dev)
        af = to_torch(self.cache.snapshot_assigned(pad=self._af_pad),
                      self.device)
        eb_dev = to_torch(eb, self.device)
        self._step_counter += 1
        key = prng.fold_in(self._key, self._step_counter)
        # Hard (DoNotSchedule) spread rows, known on the host from the
        # encode: they keep the full node axis (the in-scan domain caps
        # run only unsampled) and gate the spread-arbitration fetch.
        L = len(batch)
        dns = self._hard_spread(eb, L)
        hard_spread = self._spread_enabled and dns
        # Node-axis sampling: a batch against a large cluster runs on K
        # candidate nodes; pods the sample finds no node for are
        # re-checked against the full axis at resolve (_run_residual).
        has_gang = any(q.pod.spec.pod_group for q in batch)
        step_fn, b.sample_k = self._sampled_step(
            nf.free.shape[0], len(batch), has_gang or hard_spread)
        step_fn = step_fn or self._step
        b.t_encode = time.perf_counter()
        b.c_encode = time.thread_time()
        # Fault gate: step dispatch (err → supervised retry down the
        # ladder; stall → lands in the watchdog's step window).
        FAULTS.hit("step")
        # Fused multi-tenant arbitration: with the coordinator's mux
        # armed, a fusable batch SUBMITS its staged inputs instead of
        # dispatching; the mux's one fused dispatch per group fills its
        # decision before the coordinator resolves it. Checked before
        # the index seam: the fused full step decides as the indexed
        # serve does (I3), and the index listener drained above keeps
        # its protocol for batches that fall back.
        fuse_lane = (self._tenant_mux is not None and b.sample_k is None
                     and self._tenant_fusable(batch, hard_spread,
                                              b.fail_closed))
        idx_payload = None
        if fuse_lane and self._index is not None:
            # The fused indexed lane: stage this engine's own repaired
            # (C,N) slab for the mux's indexed dispatch. A repair that
            # needs a rebuild ejects the lane for this round (counted):
            # it rebuilds through the solo indexed dispatch below.
            idx_payload = self._tenant_index_stage(b, batch, eb, nf, af)
            if idx_payload == "eject":
                fuse_lane = False
                idx_payload = None
        # Maintained index: serve the batch from the device-resident
        # class rows, repaired from this prepare's drained deltas, in
        # place of the full (P,N) pass. Speculative: resolve settles it
        # and re-runs the full step with the same key on an unassigned
        # live row.
        d = None
        if fuse_lane:
            b.tenant_ticket = self._tenant_mux.submit(
                self, b, eb_dev, nf, af, key, index=idx_payload)
        elif not (self._index is not None and b.sample_k is None
                  and self._index_dispatch(b, batch, eb, eb_dev, nf, af,
                                           key)):
            # The batch's id as this prepare will assign it below.
            with span("step.dispatch", seq=self._batch_seq + 1):
                ev = self._step_events()
                # The host flags spare the step its reads of the card: a
                # gang-free batch skips the gang admission's, a batch
                # with no DoNotSchedule slot the caps' any_enforced.
                d = _count_launches(b, step_fn, eb_dev, nf, af, key,
                                    has_gang=has_gang, hard_spread=dns)
                b.packed_dev = self._pack(d)
                if ev is not None:
                    ev[1].record(torch.cuda.current_stream(self.device))
                    b.step_events = ev
                # The spread/anti arbitration inputs are staged only when
                # the batch carries something the host must arbitrate: a
                # hard spread slot or a required anti-affinity term. A
                # soft-only topology batch pays neither the pack nor the
                # fetch.
                needs_arb = hard_spread or bool(
                    self._spread_enabled and self._anti_enabled
                    and (eb.pf.anti_req_group[:L] >= 0).any())
                b.spread_dev = _pack_spread(d) if needs_arb else None
            self._sup_count("steps_dispatched")
            b.scored_rows += int(eb.pf.valid.shape[0]) * int(
                b.sample_k if b.sample_k is not None else nf.valid.shape[0])
        b.shapes = (int(eb.pf.valid.shape[0]), int(nf.valid.shape[0]),
                    int(af.valid.shape[0]))
        if hard_spread:
            self._sup_count("hard_spread_batches")
        if b.sample_k is not None:
            self._sup_count("sampled_batches")
        b.decision = d
        b.batch, b.eb, b.names, b.row_incs = batch, eb, names, row_incs
        b.eb_dev, b.nf, b.af, b.key = eb_dev, nf, af, key
        self._batch_seq += 1
        b.seq = self._batch_seq
        b.t_dispatch = time.perf_counter()
        with self._metrics_lock:
            self._prep_window = (b.t_enc0, b.t_dispatch)
        return b

    def _encode_batch(self, batch: List[QueuedPodInfo], pods, p_pad: int, *,
                      loop_slot: bool = False):
        """Encode the (priority-sorted) batch → (vol_memo, fail_closed, eb).
        One store pass per pod resolves every volume-derived input
        (readiness, claim mount rows, cloud typing, the zone requirement)
        for every profile, as the JAX engine does; both encode callbacks
        share it through ``vol_memo`` (pod key → _volume_state tuple).
        ``fail_closed`` maps pod key → (plugin, reason) for pods whose
        required (anti-)affinity term or DoNotSchedule spread constraint
        cannot fit the encoding slots, or whose forbidden domains exceed
        the anti_forbid slots: they are rejected after the step rather
        than scheduled against a silently weakened constraint. Only
        constraints this profile enforces fail closed. Shared by the
        per-batch prepare and the device loop's slot staging
        (``loop_slot`` tags the span)."""
        vol_memo: Dict[str, tuple] = {}

        def vol_state(pod) -> tuple:
            st = vol_memo.get(pod.key)
            if st is None:
                st = vol_memo[pod.key] = self._volume_state(pod)
            return st

        fail_closed: Dict[str, tuple] = {}
        anti_fn = None
        if self._anti_enabled:
            max_forbid = self.cache.cfg.max_anti_forbid

            def anti_fn(pod) -> List[tuple]:
                pairs = self.cache.anti_forbidden_for(pod)
                if any(entry[0] < 0 for entry in pairs):
                    # (-1, -1): a running pod's matching anti term has an
                    # unregistrable topology key.
                    fail_closed.setdefault(pod.key, (
                        "InterPodAffinity",
                        "a running pod's matching anti-affinity term "
                        "has an unrepresentable topology key (registry "
                        "full); failing closed"))
                elif len(pairs) > max_forbid:
                    fail_closed.setdefault(pod.key, (
                        "InterPodAffinity",
                        f"pod is repelled by more than {max_forbid} "
                        "distinct anti-affinity domains; failing closed "
                        "rather than evaluating a truncated constraint"))
                return pairs

        encode_hard: Dict[int, list] = {}
        sym = (SymBatch(self.cache, seq=self._batch_seq + 1)
               if self._sym_enabled else None)
        with span("encode.pods", pods=len(pods),
                  **({"loop_slot": 1} if loop_slot else {})):
            eb = encode_pods(pods, p_pad, cfg=self.cache.cfg,
                             registry=self.cache.registry,
                             overflow=self.cache.overflow,
                             volumes_ready_fn=lambda p: vol_state(p)[0],
                             gang_bound_fn=self.cache.gang_bound_count,
                             volume_info_fn=lambda p: vol_state(p)[1:],
                             anti_forbidden_fn=anti_fn,
                             hard_failed=encode_hard,
                             selector_spread=self._selspread_enabled,
                             sym_table=sym)
        if sym is not None:
            slots = int((eb.pf.sym_slot >= 0).sum())
            with self._metrics_lock:
                self._metrics["sym_affinity_s_total"] += sym.seconds
                self._metrics["sym_affinity_slots_total"] += slots
        for idx, infos in encode_hard.items():
            for info in infos:
                if self._fail_closed_plugins.get(info[0], True):
                    fail_closed.setdefault(batch[idx].pod.key, info)
                    break
        return vol_memo, fail_closed, eb

    ZONE_KEY = "topology.kubernetes.io/zone"
    IMPOSSIBLE_DOMAIN = -2  # matches no node (multi-zone PVs, registry full)

    def _volume_state(self, pod: Pod):
        """One store pass resolving every volume-derived encode input:
        (ready, claim_rows, claim_typed, zone_key_idx, zone_dom).

        ready      — every referenced PVC Bound (VolumeBinding). A pending
                     WaitForFirstConsumer claim does not block: the PV
                     controller binds it after the pod schedules.
        claim_rows — each claim's current mount row (VolumeRestrictions).
        zone       — the required zone domain from the bound PVs' zone
                     labels (VolumeZone); a pending WFFC claim whose
                     candidate PVs all lie in ONE zone makes that zone the
                     requirement, candidates in several zones add none
                     (fail open). PVs in several distinct zones, or a zone
                     key the registry cannot take, give IMPOSSIBLE_DOMAIN
                     under the hostname slot: no node matches, and the
                     pod parks under VolumeZone (fail closed)."""
        ready = True
        claim_rows = []
        claim_typed = []
        typed_by_key: Dict[str, bool] = {}
        for v in pod.spec.volumes:
            k = f"{pod.metadata.namespace}/{v.claim_name}"
            typed_by_key[k] = (typed_by_key.get(k, False)
                               or v.volume_type in CLOUD_VOLUME_AXES)
        zones_seen: Set[str] = set()
        impossible = False
        for ck in claim_keys(pod):
            claim_rows.append(self.cache.claim_node_row(ck))
            claim_typed.append(typed_by_key.get(ck, False))
            try:
                pvc = self.store.get("PersistentVolumeClaim", ck)
            except NotFoundError:
                ready = False
                continue
            if pvc.phase != "Bound":
                if pvc.binding_mode == "WaitForFirstConsumer":
                    # No candidate PV: dynamic provisioning is assumed to
                    # create one in the pod's zone after placement.
                    zones = self._wffc_candidate_zones(pvc)
                    if len(zones) == 1:
                        zones_seen |= zones
                        if len(zones_seen) > 1:
                            impossible = True
                else:
                    ready = False
            if not pvc.volume_name:
                continue
            try:
                pv = self.store.get("PersistentVolume", pvc.volume_name)
            except NotFoundError:
                continue
            zone = pv.metadata.labels.get(self.ZONE_KEY)
            if zone:
                zones_seen.add(zone)
                if len(zones_seen) > 1:
                    impossible = True
        return (ready, claim_rows, claim_typed,
                *self._zone_requirement(zones_seen, impossible))

    def _zone_requirement(self, zones_seen, impossible):
        """(zone_key_idx, zone_dom) for the encoder from the set of zones
        the pod's volumes demand."""
        from ..encode.features import pair_hash

        if not zones_seen:
            return -1, -1
        idx = self.cache.registry.index_of(self.ZONE_KEY, self.cache.overflow)
        if impossible or idx < 0:
            return 0, self.IMPOSSIBLE_DOMAIN
        (zone,) = zones_seen
        return idx, (pair_hash(self.ZONE_KEY, zone)
                     % self.cache.cfg.domain_buckets)

    def _wffc_candidate_zones(self, pvc) -> Set[str]:
        """Distinct zones of Available PVs that could satisfy a pending
        WaitForFirstConsumer claim (class and capacity match), memoized
        per claim for 0.5 s so a batch of pods sharing pending claims does
        not rescan the PV list once per pod."""
        now = time.monotonic()
        hit = self._wffc_memo.get(pvc.key)
        if hit is not None and now - hit[1] < 0.5:
            return hit[0]
        want = pvc.request.get("ephemeral-storage", 0)
        zones: Set[str] = set()
        for pv in self.store.list("PersistentVolume"):
            if (pv.phase == "Available"
                    and pv.storage_class == pvc.storage_class
                    and pv.capacity.get("ephemeral-storage", 0) >= want):
                zone = pv.metadata.labels.get(self.ZONE_KEY)
                if zone:
                    zones.add(zone)
        self._wffc_memo[pvc.key] = (zones, now)
        return zones

    def _hard_spread(self, eb, n: int) -> bool:
        """Does a live row of the host-encoded batch carry a DoNotSchedule
        slot? Without one no slot can be enforced in the scan (the step's
        caps follow the profile's topology plugins, whichever they are;
        the sampling gate and the arbitration also need PodTopologySpread
        or InterPodAffinity in the profile)."""
        from ..encode import features as F

        return bool(((eb.pf.spread_group[:n] >= 0)
                     & (eb.pf.spread_mode[:n] == F.SPREAD_DO_NOT_SCHEDULE)
                     ).any())

    def _pack(self, d: Decision):
        """One device buffer for the whole decision: the slim layout with
        residency, else the all-i32 stack. A mesh step's Decision is
        whole on the mesh's first device, so it packs the same way."""
        pack = pack_decision_slim if self._slim else pack_decision_i32
        return pack(d.chosen, d.assigned, d.gang_rejected,
                    d.feasible_counts, d.feasible_static, d.reject_counts,
                    d.shortlist_repaired)

    def _fetch_decision(self, packed_dev, p: int, f: int, decision=None, *,
                        seq: int):
        """Block on the ONE packed decision fetch and unpack it into
        writable host arrays: (chosen, assigned, gang_rejected, feasible,
        feasible_static, rejects (F,P), repaired). A tuple is a device-
        loop slot's (or an index-served batch's) planes, already read
        back and counted: it passes through. The first slim fetch is
        checked against direct reads of ``decision``'s leaves when it is
        given; a mismatch reverts to the i32 layout for good and fetches
        this batch again through it. ``seq``: the batch's id."""
        if type(packed_dev) is tuple:
            return packed_dev
        # Fault gate: decision fetch. ``corrupt`` scribbles the chosen
        # plane with absurd node rows, which the resolve sanity detector
        # must catch.
        act = FAULTS.hit("fetch")
        self._sup_count("decision_fetches")
        with self._host_sync("fetch.decision", seq):
            buf = np.array(packed_dev.cpu().numpy())
        self._count_fetch(buf.nbytes)
        if not self._slim:
            out = unpack_decision_i32(buf)
        else:
            out = unpack_decision_slim(buf, p, f)
            if not self._slim_verified and decision is not None:
                self._slim_verified = True
                with self._host_sync("fetch.verify", seq):
                    ok = (np.array_equal(out[0],
                                         decision.chosen.cpu().numpy())
                          and np.array_equal(
                              out[1], decision.assigned.cpu().numpy())
                          and np.array_equal(out[3], np.minimum(
                              decision.feasible_counts.cpu().numpy(),
                              I16_SAT)))
                if not ok:
                    log.error("slim decision readback failed its "
                              "first-batch check; reverting to the i32 "
                              "packed fetch")
                    self._slim = False
                    return self._fetch_decision(
                        pack_decision_i32(
                            decision.chosen, decision.assigned,
                            decision.gang_rejected,
                            decision.feasible_counts,
                            decision.feasible_static,
                            decision.reject_counts,
                            decision.shortlist_repaired), p, f, seq=seq)
        if act == "corrupt":
            # After the first-batch check: the scribble must reach the
            # resolve sanity detector, not pass for an odd byte order.
            out[0][:] = 0x7F7F7F7F
        return out

    def _resolve_batch(self, b: _Batch) -> None:
        self._fail_sink = b.failures
        self._fail_sink_tid = threading.get_ident()
        self._track = b
        try:
            with span("resolve", pods=len(b.batch), seq=b.seq):
                self._resolve_batch_impl(b)
        except BaseException:
            # Crash-consistent abort: reverse every assume this batch
            # made that no async owner took over, so a supervised retry
            # never double-debits capacity.
            self._rollback_assumed(b)
            raise
        finally:
            self._fail_sink = None
            self._track = None
            self._prov_batch = None
            b.t_resolved = time.perf_counter()
            b.c_resolved = time.thread_time()
        with self._metrics_lock:
            b.h2d1 = self._metrics["h2d_bytes_total"]
            b.fetch1 = self._metrics["fetch_bytes_total"]
        self._watchdog_check(b)
        self._sup.note_clean()
        if self._loop_cooldown > 0:
            # The loop→pipelined rung's probation: one clean resolved
            # batch pays one tick.
            self._loop_cooldown -= 1
        if self._index_cooldown > 0:
            # The index's full-rescore rung pays down the same way.
            self._index_cooldown -= 1
        if TIMELINE.enabled:
            self._timeline_tick()

    def _rollback_assumed(self, b: _Batch) -> None:
        if not b.assumed:
            return
        n = 0
        for key in list(b.assumed):
            b.assumed.pop(key, None)
            try:
                self.cache.account_unbind(key)
                n += 1
            except Exception:  # rollback must reverse the rest regardless
                log.exception("rollback unassume failed for %s", key)
        log.warning("rolled back %d assumed placement(s) from an aborted "
                    "batch", n)

    def _watchdog_check(self, b: _Batch) -> None:
        """Per-batch device-step watchdog: a step window (dispatch to
        fetch, less the pipelined gather) past ``watchdog_s`` counts a
        trip and degrades one rung. The batch itself completed; nothing
        is retried: the next batches stop leaning on a path that just
        blew its budget."""
        wd = self.config.watchdog_s
        if self._sup.prearm > 0:
            # SLO early-warning posture: the fallback deadline (or the
            # configured one if tighter) for the pre-armed batches.
            self._sup.prearm -= 1
            wd = min(wd, SLO_PREARM_WATCHDOG_S) if wd else \
                SLO_PREARM_WATCHDOG_S
        if not wd:
            return
        if b.step_share is not None:
            # A device-loop slot is judged by its share of the tranche's
            # window, so the deadline scales with the loop depth.
            window = b.step_share
        else:
            gather_gap = max(0.0, b.t_fetch_start - b.t_dispatch)
            window = (b.t_fetched - b.t_encode) - gather_gap
        if window > wd:
            self._sup_count("watchdog_trips")
            instant("watchdog.trip", window_s=round(window, 6),
                    deadline_s=wd)
            jnote("watchdog.trip", profile=self.profile,
                  replica=self.replica, window_s=round(window, 6),
                  deadline_s=wd, batch=b.seq)
            self._sup.escalate(f"watchdog: device step took {window:.3f}s "
                               f"(deadline {wd}s)")

    def _note_assumed(self, qpi: QueuedPodInfo) -> None:
        t = self._track
        if t is not None and threading.get_ident() == self._fail_sink_tid:
            t.assumed[qpi.pod.key] = qpi

    def _note_detached(self, key: str) -> None:
        """An async owner (the binder's bulk commit, a permit wait) now
        owns the pod's placement: it leaves the rollback ledger and is
        excluded from any supervised retry."""
        t = self._track
        if t is not None and threading.get_ident() == self._fail_sink_tid:
            t.assumed.pop(key, None)
            t.detached.add(key)
            with self._detached_lock:
                self._detached_live.add(key)

    def _check_shortlist(self, b: _Batch, chosen, assigned) -> None:
        """Every ``shortlist_check_every`` batches, re-run this batch's
        exact inputs through the full-width assignment (the greedy kernel,
        or under the auction the dense rounds) and compare decisions: the
        certificate made executable. A divergence counts a
        shortlist_desync, permanently reverts the engine to the full
        width, and aborts the batch into the supervised retry, which
        replays it bit-identically on the reverted path."""
        if not self.config.shortlist_check_every or self._mesh is not None:
            return
        self._sl_check_tick += 1
        if self._sl_check_tick % self.config.shortlist_check_every:
            return
        self._sup_count("shortlist_checks")
        check_step = build_step(self.plugin_set, shortlist=None,
                                sample_nodes=b.sample_k,
                                assignment=self.config.assignment,
                                explain=self.config.explain)
        d = _count_launches(b, check_step, b.eb_dev, b.nf, b.af, b.key)
        with self._host_sync("fetch.check", b.seq):
            ref_chosen = d.chosen.cpu().numpy()
            ref_assigned = d.assigned.cpu().numpy()
        self._count_fetch(ref_chosen.nbytes + ref_assigned.nbytes)
        L = len(b.batch)
        if (np.array_equal(chosen[:L], ref_chosen[:L])
                and np.array_equal(assigned[:L], ref_assigned[:L])):
            return
        bad = int(np.sum((chosen[:L] != ref_chosen[:L])
                         | (assigned[:L] != ref_assigned[:L])))
        self._sup_count("shortlist_desyncs")
        instant("shortlist.desync", pods=bad)
        jnote("shortlist.desync", profile=self.profile, replica=self.replica,
              pods=bad, batch=b.seq)
        self._disable_shortlist(
            f"decisions diverged from the full scan on {bad} pod(s)")
        raise EngineDesync(
            "shortlist certification cross-check failed: decisions "
            f"diverged from the full-width scan on {bad} pod(s)")

    def _disable_shortlist(self, reason: str) -> None:
        """Permanently revert to the full-width assignment; sampled steps
        read ``_shortlist_k`` per batch."""
        log.error("disabling shortlist-compressed arbitration (%s); "
                  "reverting to the full-width scan", reason)
        jnote("shortlist.disable", profile=self.profile, replica=self.replica,
              reason=reason, batch=self._batch_seq)
        bundle_mod.capture("shortlist_revert", scheduler=self, reason=reason)
        self._set_shortlist_k(None)

    # ---- maintained arbitration index (config.index) ---------------------

    def _index_dispatch(self, b: _Batch, batch, eb, eb_dev, nf, af,
                        key) -> bool:
        """Try to serve this batch from the maintained index in place of
        the full (P,N) filter+score pass: bring the (C,N) class rows to
        this snapshot (rescore the drained columns in place, append fresh
        classes; rebuild on a widening invalidation, a class-pad crossing
        or a node-pad change), then dispatch the certified shortlist scan
        over the gathered class rows. True with ``b.index_packed_dev``
        staged for resolve to settle; False: the caller dispatches the
        full step.

        The gates are the device loop's posture: the fast rung only, no
        nominations (their debits change the step's ``free`` outside the
        delta protocol), no explain recorder, no armed shortlist
        cross-check, no fail-closed verdict, the shared per-pod walk.
        Serving also needs no cache mutation between this batch's drain
        and here (cache.version unchanged): a mutation in that window is
        marked for the next refresh but already inside this snapshot, so
        its row would be stale; that is a counted race, not a desync."""
        idx = self._index
        if (idx is None or self._index_cooldown > 0
                or self._sup.level != 0 or self._nominations
                or self.recorder is not None or b.fail_closed
                or self.config.shortlist_check_every
                or not self._ring_safe_pods(batch)):
            return False
        if (self.cache.version != idx.drain_version
                or idx.listener.inval != idx.pending_inval):
            self._sup_count("index_races")
            return False
        cls = idx.classify(eb.pf, len(batch))
        if cls is None:
            # The class registry is full: a counted fallback.
            self._sup_count("index_fallbacks")
            return False
        # Fault gate: the index's dispatch seam. ``corrupt`` scribbles one
        # entry per class after the repair below, a defect the scan's
        # certificate cannot see; only index_check_every catches it.
        act = FAULTS.hit("index")
        n_pad = int(nf.valid.shape[0])
        k_eff = idx.k_eff
        rebuild = (idx.state is None or idx.needs_rebuild
                   or idx.pending_inval != idx.inval_seen
                   or idx.n_built != n_pad)
        build_fn, refresh_fn, append_fn, assign_fn = build_index_ops(
            self.plugin_set, k_eff)
        class_pf = idx.class_pf(eb.pf, self.device)
        c_pad = int(class_pf.valid.shape[0])
        if (not rebuild and idx.fresh_rows
                and c_pad != int(idx.state.score.shape[0])):
            # Fresh classes crossed the class-pad bucket: the matrix must
            # grow, the one fresh-class case that still rebuilds.
            rebuild = True
        if rebuild:
            # Cause, in order: a moved inval epoch; never built; dropped
            # by invalidate(); node-pad growth; else the class-pad
            # crossing above.
            cause = ("widening-invalidation"
                     if idx.pending_inval != idx.inval_seen
                     else "cold" if idx.n_built == -1
                     else "invalidated" if idx.state is None
                     else "node-pad" if idx.n_built != n_pad
                     else "class-pad")
            with span("index.build", classes=len(idx.rows), n=n_pad):
                idx.state = build_fn(class_pf, nf, af)
            idx.n_built = n_pad
            idx.inval_seen = idx.pending_inval
            idx.pending.clear()
            idx.fresh_rows.clear()
            idx.needs_rebuild = False
            self._sup_count("index_rebuilds")
            jnote("index.rebuild", profile=self.profile,
                  replica=self.replica, cause=cause, classes=len(idx.rows),
                  n=n_pad, batch=self._batch_seq)
            b.scored_rows += c_pad * n_pad
        else:
            self._index_repair_slab(idx, b, class_pf, nf, af, refresh_fn,
                                    append_fn, c_pad, n_pad)
        if act == "corrupt" and idx.state is not None:
            idx.state = idx.state._replace(
                score=corrupt_slab(idx.state.score, n_pad))
        cls_pad = np.zeros((int(eb.pf.valid.shape[0]),), dtype=np.int32)
        cls_pad[:len(batch)] = cls
        with span("index.assign", pods=len(batch), k=k_eff):
            packed, free_after = _count_launches(
                b, assign_fn, idx.state, to_torch(cls_pad, self.device),
                eb_dev.pf.valid, eb_dev.pf.requests, nf.free, key)
        self._sup_count("steps_dispatched")
        b.index_packed_dev = packed
        b.index_free_after = free_after
        return True

    def _index_repair_slab(self, idx: _ArbIndex, b: _Batch, class_pf, nf,
                           af, refresh_fn, append_fn, c_pad: int,
                           n_pad: int, *, fused: bool = False) -> None:
        """Bring a live (C,N) slab to this snapshot without a rebuild:
        rescore exactly the drained node columns in place, then write in
        any fresh class rows still inside the class-pad bucket. Shared by
        the solo indexed dispatch and the fused lane's staging, which
        journals ``index.slab_repair`` (the repair lands in the owning
        tenant's slab)."""
        if idx.pending:
            rows = np.fromiter(idx.pending, dtype=np.int64,
                               count=len(idx.pending))
            rows.sort()
            rows = rows[rows < n_pad]  # pad growth forces a rebuild
            idx.pending.clear()
            if rows.size:
                rb = bucket_for(int(rows.size), 16)
                rows_pad = np.full((rb,), n_pad, dtype=np.int32)
                rows_pad[:rows.size] = rows
                with span("index.refresh", rows=int(rows.size)):
                    idx.state = refresh_fn(idx.state, class_pf, nf, af,
                                           rows_pad)
                self._sup_count("index_repair_rows", int(rows.size))
                jnote("index.slab_repair" if fused else "index.repair",
                      profile=self.profile, replica=self.replica,
                      rows=int(rows.size), batch=self._batch_seq)
                b.scored_rows += c_pad * rb
        if idx.fresh_rows:
            # The per-class add: only the fresh rows over the full node
            # axis, against this snapshot, as a rebuild would compute
            # them (the refresh above already brought every existing
            # row's changed columns up to date).
            n_fresh = len(idx.fresh_rows)
            rb = bucket_for(n_fresh, 16)
            rows_pad = np.full((rb,), c_pad, dtype=np.int32)
            rows_pad[:n_fresh] = np.asarray(idx.fresh_rows, dtype=np.int32)
            idx.fresh_rows.clear()
            with span("index.append", rows=n_fresh):
                idx.state = append_fn(idx.state, class_pf, nf, af,
                                      rows_pad)
            self._sup_count("index_appends", n_fresh)
            jnote("index.append", profile=self.profile,
                  replica=self.replica, rows=n_fresh, batch=self._batch_seq)
            b.scored_rows += rb * n_pad

    def _tenant_index_stage(self, b: _Batch, batch, eb, nf, af):
        """Stage this fused lane's indexed serve: bring the engine's own
        (C,N) slab to this snapshot (column repairs and in-bucket fresh
        classes, in place of the owning slab) and hand the mux the slab
        and this batch's class rows, so the lane rides one fused indexed
        dispatch (ops/pipeline.build_tenant_index_step) instead of the
        fused full pass. Three outcomes: ``(score_slab, cls on the
        device, k_eff)`` (serve fused-indexed); None (ride fused-full:
        no live or a cooling index, a counted race, a full class
        registry; never a stale serve); or ``"eject"``: a repair no slab
        patch can express (a widening invalidation, a cold or
        invalidated state, node-pad growth, a class-pad crossing) takes
        the lane out of the fused group this round, counted and
        journaled, and it rebuilds through its own solo indexed
        dispatch."""
        idx = self._index
        if idx is None or self._index_cooldown > 0:
            return None
        if (self.cache.version != idx.drain_version
                or idx.listener.inval != idx.pending_inval):
            self._sup_count("index_races")
            return None
        cls = idx.classify(eb.pf, len(batch))
        if cls is None:
            # A full class registry: a counted fallback, never an error.
            self._sup_count("index_fallbacks")
            return None
        n_pad = int(nf.valid.shape[0])
        rebuild = (idx.state is None or idx.needs_rebuild
                   or idx.pending_inval != idx.inval_seen
                   or idx.n_built != n_pad)
        _build_fn, refresh_fn, append_fn, _assign_fn = build_index_ops(
            self.plugin_set, idx.k_eff)
        class_pf = idx.class_pf(eb.pf, self.device)
        c_pad = int(class_pf.valid.shape[0])
        if (not rebuild and idx.fresh_rows
                and c_pad != int(idx.state.score.shape[0])):
            rebuild = True
        if rebuild:
            # The solo dispatch's cause precedence; the rebuild happens
            # there (this lane leaves the fused group).
            cause = ("widening-invalidation"
                     if idx.pending_inval != idx.inval_seen
                     else "cold" if idx.n_built == -1
                     else "invalidated" if idx.state is None
                     else "node-pad" if idx.n_built != n_pad
                     else "class-pad")
            self._sup_count("index_lane_ejects")
            jnote("index.lane_eject", profile=self.profile,
                  replica=self.replica, cause=cause, batch=self._batch_seq)
            return "eject"
        self._index_repair_slab(idx, b, class_pf, nf, af, refresh_fn,
                                append_fn, c_pad, n_pad, fused=True)
        cls_pad = np.zeros((int(eb.pf.valid.shape[0]),), dtype=np.int32)
        cls_pad[:len(batch)] = cls
        return (idx.state.score, to_torch(cls_pad, self.device), idx.k_eff)

    def _settle_index(self, b: _Batch) -> None:
        """Settle an index-dispatched batch (resolve, before anything
        consumes a decision): read the [chosen | assigned | repaired]
        buffer back in one transfer. Every live row assigned: serve the
        batch from the indexed scan (an index hit; its in-scan repairs
        are exact and counted in index_uncertified). An unassigned live
        row (the failure path needs the per-plugin reject attribution
        the index does not compute): discard the result and run the full
        step with the batch's PRNG draw, so decisions equal the index-off
        engine's in every case (I3)."""
        idx = self._index
        p_pad = int(b.eb.pf.valid.shape[0])
        # A fused indexed lane arrives with its row of the mux's one
        # stacked fetch already on the host (counted once at the mux).
        fused = isinstance(b.index_packed_dev, np.ndarray)
        with self._host_sync("fetch.index", b.seq, blocking=not fused):
            buf = np.array(b.index_packed_dev if fused
                           else b.index_packed_dev.cpu().numpy())
        b.index_packed_dev = None
        if not fused:
            self._count_fetch(buf.nbytes)
            self._sup_count("decision_fetches")
        chosen, assigned, repaired = unpack_index_decision(buf, p_pad)
        L = len(b.batch)
        if bool(assigned[:L].all()):
            n_f = len(self.filter_names)
            # The gang, feasibility and reject planes are read only for
            # unassigned rows (none here; index-safe batches have no
            # gangs); the scan's repairs ride in the shortlist slot.
            b.packed_dev = (
                chosen.astype(np.int32), assigned,
                np.zeros((p_pad,), dtype=bool),
                np.ones((p_pad,), dtype=np.int32),
                np.ones((p_pad,), dtype=np.int32),
                np.zeros((n_f, p_pad), dtype=np.int32),
                repaired)
            b.index_mode = "fused-hit" if fused else "hit"
            if idx is not None:
                idx.rebuild_streak = 0
            self._sup_count("index_hits")
            if fused:
                self._sup_count("index_fused_hits")
                jnote("index.fused_serve", profile=self.profile,
                      replica=self.replica, pods=L, batch=b.seq)
            self._sup_count("index_uncertified", int(repaired[:L].sum()))
            self._check_index(b, chosen, assigned)
            return
        # Fallback: the full step for the whole batch, the ladder's
        # engine-level repair rung.
        self._sup_count("index_fallbacks")
        b.index_mode = "fallback"
        jnote("index.fallback", profile=self.profile, replica=self.replica,
              batch=b.seq)
        b.index_free_after = None
        if idx is not None:
            idx.rebuild_streak += 1
            if idx.rebuild_streak >= max(2, self.config.probation_batches):
                # A fallback storm: park the index for a probation of
                # resolved batches (the full-rescore rung).
                idx.rebuild_streak = 0
                self._index_cooldown = max(1, self.config.probation_batches)
                self._sup_count("index_cooldowns")
                instant("index.cooldown", batches=self._index_cooldown)
                jnote("index.cooldown", profile=self.profile,
                      replica=self.replica, batches=self._index_cooldown,
                      batch=b.seq)
        with span("step.dispatch"):
            d = _count_launches(b, self._step, b.eb_dev, b.nf, b.af, b.key,
                                has_gang=False, hard_spread=False)
        self._sup_count("steps_dispatched")
        b.decision = d
        b.packed_dev = self._pack(d)
        b.scored_rows += p_pad * int(b.nf.valid.shape[0])

    def _check_index(self, b: _Batch, chosen, assigned) -> None:
        """Every ``index_check_every`` served batches, re-run this batch's
        inputs through the full step and compare decisions: the cover
        for defects outside the certificate's proof (a scribbled index
        entry, the ``index:corrupt`` gate; a broken gather). A
        divergence counts an index_desync, disables the index for good
        and aborts the batch into the supervised retry, which replays it
        on the index-off path."""
        if not self.config.index_check_every:
            return
        self._idx_check_tick += 1
        if self._idx_check_tick % self.config.index_check_every:
            return
        self._sup_count("index_checks")
        check_step = build_step(self.plugin_set, shortlist=self._shortlist_k,
                                assignment=self.config.assignment,
                                explain=self.config.explain)
        d = _count_launches(b, check_step, b.eb_dev, b.nf, b.af, b.key,
                            has_gang=False, hard_spread=False)
        with self._host_sync("fetch.check", b.seq):
            ref_c = d.chosen.cpu().numpy()
            ref_a = d.assigned.cpu().numpy()
        self._count_fetch(ref_c.nbytes + ref_a.nbytes)
        L = len(b.batch)
        if (np.array_equal(chosen[:L], ref_c[:L])
                and np.array_equal(assigned[:L], ref_a[:L])):
            return
        bad = int(np.sum((chosen[:L] != ref_c[:L])
                         | (assigned[:L] != ref_a[:L])))
        self._sup_count("index_desyncs")
        instant("index.desync", pods=bad)
        jnote("index.desync", profile=self.profile, replica=self.replica,
              pods=bad, batch=b.seq)
        self._disable_index(
            f"decisions diverged from the full step on {bad} pod(s)")
        raise EngineDesync(
            "maintained-index certification cross-check failed: "
            f"decisions diverged from the full step on {bad} pod(s)")

    def _disable_index(self, reason: str) -> None:
        """Revert to the per-batch dataflow for good; the listener keeps
        collecting marks that nothing reads again."""
        log.error("disabling the maintained arbitration index (%s); "
                  "reverting to the per-batch full step", reason)
        jnote("index.disable", profile=self.profile, replica=self.replica,
              reason=reason, batch=self._batch_seq)
        bundle_mod.capture("index_revert", scheduler=self, reason=reason)
        self._index = None

    def _slice_eb(self, eb, rows, bucket: Optional[int] = None):
        """(eb_sub, P2): the pod rows ``rows`` of a host EncodedBatch,
        padded to a fresh bucket (or the caller's ``bucket``), with the
        batch's group tables shared (group ids stay aligned) and gangs
        stripped (the residual pass and the spread repair never see a
        gang pod)."""
        n = len(rows)
        P2 = bucket or bucket_for(n, self.config.pod_bucket_min)

        def take(a):
            out = np.zeros((P2,) + a.shape[1:], dtype=a.dtype)
            out[:n] = a[rows]
            return out

        pf2 = type(eb.pf)(*[take(getattr(eb.pf, f)) for f in eb.pf._fields])
        gang2 = GangFeatures(group=np.full(P2, -1, dtype=np.int32),
                             min_count=np.asarray(eb.gang.min_count))
        return eb._replace(pf=pf2, gang=gang2), P2

    def _run_residual(self, b: _Batch, rows, chosen, assigned,
                      gang_rejected, feasible, rejects, feasible_static,
                      sp) -> None:
        """Full-axis re-evaluation of the pods the sampled step found no
        node for, merged in place. The sub-batch sees the cluster's free
        capacity after the sampled assignments (free_after is full-size
        under sampling), read back to the host as the JAX engine does and
        counted in fetch_bytes_total; its tie-breaks draw
        ``fold_in(key, 0x5e5)``. Only the per-pod spread rows merge into
        ``sp``: a residual exists only for soft-spread batches (hard ones
        never sample), where the min and scan rows are advisory."""
        n_res = len(rows)
        eb2, P2 = self._slice_eb(b.eb, rows)
        with self._host_sync("fetch.free", b.seq):
            free2 = b.decision.free_after.cpu().numpy()
        self._count_fetch(free2.nbytes)
        nf2 = b.nf._replace(free=to_torch(free2, self.device))
        d2 = _count_launches(b, self._step, to_torch(eb2, self.device), nf2,
                             b.af, prng.fold_in(b.key, 0x5E5),
                             has_gang=False, hard_spread=False)
        ch2, as2, gr2, fc2, fs2, rj2, rep2 = self._fetch_decision(
            self._pack(d2), P2, rejects.shape[0], d2, seq=b.seq)
        b.sl_repairs += int(rep2[:n_res].sum())
        chosen[rows] = ch2[:n_res]
        assigned[rows] = as2[:n_res]
        gang_rejected[rows] = gr2[:n_res]
        feasible[rows] = fc2[:n_res]
        feasible_static[rows] = fs2[:n_res]
        rejects[:, rows] = rj2[:, :n_res]
        if sp is not None:
            sp2 = self._fetch_spread(_pack_spread(d2), b.seq)
            sp_p = b.decision.spread_pre.shape[0]
            if d2.spread_pre.shape[0]:
                sp[rows] = sp2[:P2][:n_res]
                sp[sp_p + rows] = sp2[P2:2 * P2][:n_res]

    def _fetch_spread(self, payload, seq: int) -> Optional[np.ndarray]:
        """Read back a staged (2P+2, G) spread table (None stays None);
        the ``fetch.spread`` span covers the wait."""
        if payload is None:
            return None
        with self._host_sync("fetch.spread", seq):
            sp = np.array(payload.cpu().numpy())
        self._count_fetch(sp.nbytes)
        return sp

    def _arbitrate_packed(self, batch, assigned, eb, decision, sp,
                          dead: Set[int], seq: int) -> Set[int]:
        """arbitrate_spread over the packed (2P+2, G) spread fetch: the
        one place that decodes _pack_spread's row layout (pre | dom | min
        | scan_groups). The (G,D) exact tables stay on the card until a
        batch with hard rows the caps scan did not enforce asks for
        them."""
        sp_p = decision.spread_pre.shape[0]

        def exact_tables():
            with self._host_sync("fetch.tables", seq):
                cd = decision.spread_cdom.cpu().numpy()
                de = decision.spread_dexist.cpu().numpy()
            self._count_fetch(cd.nbytes + de.nbytes)
            return cd, de

        return arbitrate_spread(
            batch, assigned, eb.pf, eb.gf,
            sp[:sp_p], sp[sp_p:2 * sp_p].astype(np.int32), sp[2 * sp_p],
            dead=dead, anti_enabled=self._anti_enabled,
            exact_tables=exact_tables,
            scan_enforced=sp[2 * sp_p + 1].astype(bool))

    def _count_revoked(self, batch, eb, sp, rows) -> None:
        """Book spread revocations, and those of them with a hard slot on
        a group the caps scan enforced (which its running counts should
        have made legal: a nonzero count there is a fault to chase)."""
        if not rows:
            return
        from ..encode import features as F

        sp_p = (sp.shape[0] - 2) // 2
        enforced = sp[2 * sp_p + 1].astype(bool)
        pf = eb.pf
        n_enf = 0
        for i in rows:
            hard = ((pf.spread_group[i] >= 0)
                    & (pf.spread_mode[i] == F.SPREAD_DO_NOT_SCHEDULE))
            if any(enforced[int(g)] for g in pf.spread_group[i][hard]):
                n_enf += 1
        self._sup_count("spread_revoked", len(rows))
        self._sup_count("spread_revoked_enforced", n_enf)

    def _replay_on_residency(self, b: _Batch, chosen, assigned) -> None:
        """Replay the step's device debits into the host mirror and adopt
        free_after as the carried next-batch input, then model the
        batch's host-port insertions on the resident used_ports (only the
        port-carrying pods, padded to a power-of-two bucket; -1 rows are
        skipped)."""
        res = self._residency
        # An index-served batch has no Decision: its carried array is the
        # indexed scan's free_after, bitwise the full step's.
        res.note_debits(chosen, assigned, b.eb.pf.requests,
                        b.decision.free_after if b.decision is not None
                        else b.index_free_after, add_back=b.nom_reserved)
        ports = np.asarray(b.eb.pf.ports)
        live = assigned & (ports != 0).any(axis=1)
        if live.any():
            idx = np.nonzero(live)[0]
            k = bucket_for(idx.size, 16)
            rows_pad = np.full((k,), -1, dtype=np.int32)
            rows_pad[:idx.size] = chosen[idx]
            ports_pad = np.zeros((k, ports.shape[1]), dtype=ports.dtype)
            ports_pad[:idx.size] = ports[idx]
            self._count_h2d(_count_launches(b, res.note_ports, rows_pad,
                                            ports_pad))

    def _resolve_batch_impl(self, b: _Batch) -> None:
        batch, names, eb = b.batch, b.names, b.eb
        L = len(batch)
        # The read back blocks on the device. In pipelined mode the next
        # batch's gather sits between dispatch and here; the fetch-start
        # stamp keeps it out of the step window.
        b.t_fetch_start = time.perf_counter()
        if b.tenant_ticket is not None:
            # A fused tenant lane must be dispatched by the mux before the
            # coordinator resolves it: an armed ticket here is a
            # sequencing defect of the coordinator.
            raise EngineDesync(
                "fused tenant lane reached resolve with its ticket still "
                "armed (mux.dispatch did not run)")
        if b.index_packed_dev is not None:
            # Settle the speculative indexed scan: serve it (an index
            # hit: no full pass ran) or discard it and run the full step
            # with the batch's PRNG draw.
            self._settle_index(b)
        (chosen, assigned, gang_rejected, feasible, feasible_static,
         rejects, sl_repaired) = self._fetch_decision(
            b.packed_dev, eb.pf.valid.shape[0], len(self.filter_names),
            b.decision, seq=b.seq)
        if b.step_events is not None:
            self._read_step_events(b)
        # Supervisor sanity detector, before the residency replay trusts
        # ``chosen``: a corrupted readback must abort the batch, not
        # poison the carried mirror.
        if assigned[:L].any():
            ch = chosen[:L][assigned[:L]]
            if int(ch.min()) < 0 or int(ch.max()) >= len(names):
                raise EngineDesync(
                    "decision readback failed its sanity check: chosen "
                    f"node row outside [0, {len(names)})")
        if self._shortlist_k is not None:
            # Fault gate: shortlist decision accounting. ``corrupt``
            # re-points one assigned pod at a different valid row, a
            # mispick the range check cannot see; only the full-width
            # cross-check below catches it.
            if (FAULTS.hit("shortlist_repair") == "corrupt"
                    and assigned[:L].any()):
                j = int(np.argmax(assigned[:L]))
                chosen[j] = (int(chosen[j]) + 1) % len(names)
            self._check_shortlist(b, chosen, assigned)
            b.sl_repairs += int(sl_repaired[:L].sum())
        sp = self._fetch_spread(b.spread_dev, b.seq)
        # Provenance path (journal armed only), before any placement
        # stamp.
        self._prov_batch = self._prov_path(b) if JOURNAL.enabled else None
        if b.res_carried:
            # The main step's debits, before the residual merge mutates
            # chosen/assigned: residual placements reach the device as
            # next-batch corrections, like any host mutation.
            self._replay_on_residency(b, chosen, assigned)
        if b.sample_k is not None:
            # Residual pass: a pod with no feasible node in the sample may
            # still fit elsewhere; terminal verdicts never come from a
            # sample.
            res_rows = np.nonzero((feasible[:L] == 0) & ~assigned[:L])[0]
            if res_rows.size:
                self._run_residual(b, res_rows, chosen, assigned,
                                   gang_rejected, feasible, rejects,
                                   feasible_static, sp)
        b.t_fetched = time.perf_counter()
        b.c_fetched = time.thread_time()
        # Lifecycle stamp: the device's verdict exists from here on
        # (decided_at feeds the pod_decide / pod_bind histograms).
        now_mono = time.monotonic()
        for qpi in batch:
            qpi.decided_at = now_mono

        if self.recorder is not None and not self._overload.explain_skip():
            # The step's device output (its explain stacks), not the slim
            # fetch. Brownout (overload level 3) pauses explain
            # ingestion, counted in overload_explain_skipped.
            self.recorder.record_batch([q.pod for q in batch], names,
                                       b.decision, self.plugin_set)

        revoked, parked_gangs = (
            arbitrate_rwo(batch, assigned, chosen, b.vol_memo)
            if self._rwo_enabled else (set(), set()))
        for i in revoked:
            if gang_key(batch[i].pod) in parked_gangs:
                self._handle_failure(
                    batch[i], {COSCHEDULING},
                    "gang members demand the same RWO claim on different "
                    "nodes", retryable=False)
            else:
                self._handle_failure(
                    batch[i], {BATCH_CAPACITY},
                    "RWO claim pinned by an earlier pod in this batch",
                    retryable=True)

        if b.fail_closed:
            # Before the spread arbitration: fail-closed pods (and their
            # gangs) must be in its dead set, or a later placement could
            # stay committed over max_skew on their counted admission.
            dead_gangs = {gang_key(q.pod) for q in batch
                          if q.pod.key in b.fail_closed
                          and q.pod.spec.pod_group}
            for i, qpi in enumerate(batch):
                if i in revoked:
                    continue
                info = b.fail_closed.get(qpi.pod.key)
                gk = gang_key(qpi.pod)
                if info is None and gk not in dead_gangs:
                    continue
                if info is not None:
                    plugins, reason = {info[0]}, info[1]
                else:
                    plugins = set()
                    reason = (f"gang {qpi.pod.spec.pod_group} member "
                              "failed closed on an unrepresentable hard "
                              "constraint")
                if gk in dead_gangs:
                    plugins.add(COSCHEDULING)
                self._handle_failure(qpi, plugins, reason, retryable=False)
                revoked.add(i)

        repair_rows: List[int] = []
        if self._spread_enabled and sp is not None:
            s_revoked = self._arbitrate_packed(batch, assigned, eb,
                                               b.decision, sp, dead=revoked,
                                               seq=b.seq)
            self._count_revoked(batch, eb, sp, s_revoked)
            for i in sorted(s_revoked):
                qpi = batch[i]
                # In-cycle repair candidates: re-placed against refreshed
                # counts after the survivors are assumed (_repair_spread),
                # instead of a queue round trip and backoff per tranche.
                # Excluded: gang members (repairing one member alone
                # breaks gang atomicity) and pods holding unused RWO
                # claims (a repair could move them off the node their
                # claim was arbitrated against).
                if (self.config.spread_repair_iters
                        and not qpi.pod.spec.pod_group
                        and not _holds_unused_claim(b.vol_memo, qpi.pod)):
                    repair_rows.append(i)
                else:
                    self._handle_failure(qpi, {BATCH_CAPACITY},
                                         _SPREAD_REVOKE_MSG, retryable=True)
            revoked |= s_revoked

        to_bind: List[tuple] = []  # permit-free (qpi, node_name) pairs
        # With no permit plugins in the profile the per-pod binding cycle
        # reduces to assume + enqueue: one cache-lock acquisition for the
        # whole batch, reusing the encoder's request rows.
        bulk_assume = not self.plugin_set.permit_plugins
        assume_items: List[tuple] = []
        assume_rows: List[int] = []
        assume_incs: List[int] = []
        # Rows whose counted admission vanished after the fact (assume
        # misses, synchronous permit rejections): their gang-mates must
        # not bind at sub-quorum, and the spread arbitration runs again
        # without them.
        lost_rows: List[int] = []
        preempt_rows: List[int] = []          # deferred terminal verdicts
        preempt_plugins: Dict[int, Set[str]] = {}
        n_ghost = 0
        chosen_l = chosen[:L].tolist()
        assigned_l = assigned[:L].tolist()
        gang_rejected_l = gang_rejected[:L].tolist()
        feasible_l = feasible[:L].tolist()
        static_l = feasible_static[:L].tolist()
        for i, qpi in enumerate(batch):
            if i in revoked:
                continue
            if parked_gangs and gang_key(qpi.pod) in parked_gangs:
                # Unassigned members of a parked gang park with it in this
                # cycle (its assigned members are already revoked).
                self._handle_failure(
                    qpi, {COSCHEDULING},
                    "gang members demand the same RWO claim on different "
                    "nodes", retryable=False)
                continue
            if assigned_l[i]:
                node_name = names[chosen_l[i]]
                inc = int(b.row_incs[chosen_l[i]])
                if self._prov_batch is not None:
                    self._prov_stamp(qpi, node_name,
                                     repaired=bool(sl_repaired[i]))
                if bulk_assume:
                    assume_items.append((qpi.pod, node_name))
                    assume_rows.append(i)
                    assume_incs.append(inc)
                    to_bind.append((qpi, node_name))
                else:
                    pair, ghost, rej = self._start_binding_cycle(
                        qpi, node_name, expected_inc=inc)
                    if ghost:
                        n_ghost += 1
                    if ghost or rej:
                        lost_rows.append(i)
                    if pair is not None:
                        to_bind.append(pair)
            elif gang_rejected_l[i]:
                # The pod's gang missed quorum — park the member under
                # Coscheduling (plus any real filter rejections).
                plugins = {COSCHEDULING}
                if feasible_l[i] == 0:
                    plugins |= {self.filter_names[f]
                                for f in range(rejects.shape[0])
                                if rejects[f, i] > 0}
                self._handle_failure(
                    qpi, plugins,
                    f"gang {qpi.pod.spec.pod_group} missed quorum "
                    f"{qpi.pod.spec.pod_group_min}", retryable=False)
            elif feasible_l[i] > 0 and static_l[i] > 0:
                # Nodes were feasible but earlier pods in the batch took
                # the capacity — retryable, not unschedulable.
                self._handle_failure(
                    qpi, {BATCH_CAPACITY},
                    "ran out of capacity within scheduling batch",
                    retryable=True)
            else:
                plugins = {self.filter_names[f]
                           for f in range(rejects.shape[0])
                           if rejects[f, i] > 0} or {BATCH_CAPACITY}
                if feasible_l[i] > 0:
                    # The caps scan deferred the static skew check, so
                    # the filter passed nodes the scan then refused under
                    # the same pre-batch counts (feasible_static == 0):
                    # the pod is statically over-skew everywhere, a
                    # terminal PodTopologySpread verdict (which preemption
                    # may cure by evicting matching pods).
                    plugins = {"PodTopologySpread"}
                if self._preempt_enabled and not qpi.pod.spec.pod_group:
                    # PostFilter (DefaultPreemption): the terminal verdict
                    # waits for the victim-candidate search below. Gang
                    # members never preempt.
                    preempt_rows.append(i)
                    preempt_plugins[i] = plugins
                    continue
                self._handle_failure(
                    qpi, plugins,
                    f"0/{self.cache.node_count()} nodes are available: "
                    f"rejected by {sorted(plugins)}", retryable=False)

        if assume_items:
            missed = self.cache.account_bind_bulk(
                assume_items, req_rows=eb.pf.requests[assume_rows],
                expected_inc=assume_incs)
            if missed:
                # The chosen node's cache row vanished between the
                # snapshot and this assume (node deleted mid-cycle):
                # requeue instead of binding to a ghost node.
                n_ghost += len(missed)
                dead = set()
                for m in missed:
                    pod, node_name = assume_items[m]
                    dead.add(pod.key)
                    self._handle_failure(
                        batch[assume_rows[m]], {BATCH_CAPACITY},
                        f"chosen node {node_name} was deleted during the "
                        "scheduling cycle", retryable=True)
                lost_rows.extend(assume_rows[m] for m in missed)
                to_bind = [(q, n) for q, n in to_bind
                           if q.pod.key not in dead]
            missed_set = set(missed) if missed else ()
            for j in range(len(assume_items)):
                if j not in missed_set:
                    self._note_assumed(batch[assume_rows[j]])

        if lost_rows:
            # Post-assume staleness: the scan (and the host replay)
            # counted the lost rows' admissions, so a later placement may
            # be legal only because of a contribution that just vanished:
            # gang-mates must not bind at sub-quorum, and the spread
            # arbitration runs again with the lost rows dead. to_bind is
            # not submitted yet, so dropped pairs never bind.
            g_set = set(lost_rows)
            bind_keys = {q.pod.key for q, _ in to_bind}
            drop: Set[str] = set()
            lost_gangs = {gang_key(batch[i].pod) for i in g_set
                          if batch[i].pod.spec.pod_group}
            for j, qpi in enumerate(batch):
                if (j in g_set or j in revoked or not assigned_l[j]
                        or gang_key(qpi.pod) not in lost_gangs):
                    continue
                if self._revoke_post_assume(
                        qpi, {COSCHEDULING, BATCH_CAPACITY},
                        f"gang {qpi.pod.spec.pod_group} member lost its "
                        "placement during the scheduling cycle",
                        in_bind=qpi.pod.key in bind_keys):
                    drop.add(qpi.pod.key)
                    revoked.add(j)
            if sp is not None:
                re_rev = self._arbitrate_packed(batch, assigned, eb,
                                                b.decision, sp,
                                                dead=revoked | g_set,
                                                seq=b.seq)
                self._count_revoked(batch, eb, sp, re_rev)
                for i in sorted(re_rev):
                    qpi = batch[i]
                    if (self.config.spread_repair_iters
                            and not qpi.pod.spec.pod_group
                            and qpi.pod.key in bind_keys
                            and not _holds_unused_claim(b.vol_memo,
                                                        qpi.pod)):
                        # the same in-cycle repair the first-pass
                        # revocations get
                        self._unassume(qpi)
                        drop.add(qpi.pod.key)
                        repair_rows.append(i)
                        revoked.add(i)
                    elif self._revoke_post_assume(
                            qpi, {BATCH_CAPACITY}, _SPREAD_REVOKE_MSG,
                            in_bind=qpi.pod.key in bind_keys):
                        drop.add(qpi.pod.key)
                        revoked.add(i)
            if drop:
                to_bind = [(q, n) for q, n in to_bind
                           if q.pod.key not in drop]

        n_repaired = 0
        if repair_rows:
            # In-cycle repair: with the survivors assumed, the refreshed
            # snapshot carries the committed counts — re-run the step on
            # the revoked rows so the next tranche places now.
            more_bind, leftover, n_repaired = self._repair_spread(
                b, repair_rows)
            to_bind.extend(more_bind)
            self._sup_count("spread_repaired", n_repaired)
            for i in leftover:
                self._handle_failure(batch[i], {BATCH_CAPACITY},
                                     _SPREAD_REVOKE_MSG, retryable=True)

        if preempt_rows:
            # After the assume and the repair, against a FRESH snapshot:
            # victim sets must cover the preemptor's need against capacity
            # as it stands once this batch's survivors and repair
            # placements are debited (free_after would still debit pods
            # the arbitration revoked and miss the repair's placements).
            won = self._try_preempt(batch, preempt_rows, eb, b.seq)
            for i in preempt_rows:
                if i not in won:
                    self._handle_failure(
                        batch[i], preempt_plugins[i],
                        f"0/{self.cache.node_count()} nodes are available: "
                        f"rejected by {sorted(preempt_plugins[i])}; "
                        "preemption found no candidates",
                        retryable=False)

        if to_bind:
            # One bulk commit for all permit-free pods: a single store
            # transaction (bind_pods), still async like the reference's
            # per-pod binding goroutine (minisched.go:96-112).
            for q, _n in to_bind:
                self._note_detached(q.pod.key)
            self._binder.submit(self._bind_many, to_bind, b.seq)
        b.n_assigned = (int(assigned[:L].sum())
                        - sum(1 for i in revoked if assigned[i])
                        - n_ghost + n_repaired)

    def _repair_spread(self, b: _Batch, rows: List[int]):
        """In-cycle repair of topology-revoked pods → (bind pairs,
        leftover rows, admitted count — permit-parked pods included).

        Each iteration re-snapshots node and assigned state (the
        survivors and earlier repair tranches are assumed, so the step's
        filter and the exact arbitration see the committed counts),
        re-runs the unsampled step on the remaining rows (padded to the
        main batch's bucket), arbitrates the sub-batch and assumes the
        admitted pods. Rows the step finds infeasible stay in the loop
        while the iteration made progress — a zone at its skew cap
        re-opens as other domains catch up — and the loop stops on no
        progress or after ``spread_repair_iters`` iterations; leftovers
        take the normal requeue path."""
        batch, eb = b.batch, b.eb
        rows = list(rows)
        out_bind: List[tuple] = []
        n_admitted = 0
        bulk = not self.plugin_set.permit_plugins
        for _ in range(self.config.spread_repair_iters):
            if not rows:
                break
            cached = self._nf_static_device
            nf, names, static_v, row_incs = self.cache.snapshot_versioned(
                pad=self._node_pad,
                known_static=cached[0] if cached else None)
            af = self.cache.snapshot_assigned(pad=self._af_pad)
            nf = self._with_device_static(nf, static_v, row_incs.shape[0])
            if self._nominations:
                reserved = self._nomination_debits(
                    {batch[i].pod.key for i in rows}, names, nf)
                if reserved is not None:
                    nf = nf._replace(free=nf.free - reserved)
            self._count_h2d(nf.free.nbytes + nf.used_ports.nbytes)
            nf = nf._replace(free=to_torch(nf.free, self.device),
                             used_ports=to_torch(nf.used_ports, self.device))
            eb2, _P2 = self._slice_eb(eb, np.asarray(rows, dtype=np.int64),
                                      bucket=eb.pf.valid.shape[0])
            self._step_counter += 1
            d2 = _count_launches(
                b, self._step, to_torch(eb2, self.device), nf,
                to_torch(af, self.device),
                prng.fold_in(self._key, self._step_counter), False,
                self._hard_spread(eb2, len(rows)))
            (chosen2, assigned2, _gr2, _fc2, _fs2, _rj2, rep2) = (
                self._fetch_decision(self._pack(d2), eb2.pf.valid.shape[0],
                                     d2.reject_counts.shape[0], d2,
                                     seq=b.seq))
            b.sl_repairs += int(rep2[:len(rows)].sum())
            n_r = len(rows)
            sub = [batch[i] for i in rows]
            sp2 = self._fetch_spread(_pack_spread(d2), b.seq)
            rev2 = self._arbitrate_packed(sub, assigned2, eb2, d2, sp2,
                                          dead=set(), seq=b.seq)
            items, req_rows, next_rows = [], [], []
            iter_incs: List[int] = []
            iter_rows: List[int] = []
            iter_bind: List[tuple] = []
            ghost_js: List[int] = []   # sub-rows lost to assume misses
            for j in range(n_r):
                i = rows[j]
                if assigned2[j] and j not in rev2:
                    # Counted admitted regardless of the permit outcome,
                    # as the main cycle counts permit-parked pods.
                    n_admitted += 1
                    node_name = names[int(chosen2[j])]
                    if self._prov_batch is not None:
                        self._prov_stamp(batch[i], node_name,
                                         repaired=bool(rep2[j]),
                                         spread_repaired=True)
                    if bulk:
                        items.append((batch[i].pod, node_name))
                        req_rows.append(j)
                        iter_incs.append(int(row_incs[int(chosen2[j])]))
                        iter_rows.append(i)
                        iter_bind.append((batch[i], node_name))
                    else:
                        pair, ghost, rej = self._start_binding_cycle(
                            batch[i], node_name,
                            expected_inc=int(row_incs[int(chosen2[j])]))
                        if ghost:
                            n_admitted -= 1
                            next_rows.append(i)
                            ghost_js.append(j)
                        elif rej:
                            ghost_js.append(j)
                        elif pair is not None:
                            out_bind.append(pair)
                else:
                    # still contended or currently infeasible — both can
                    # succeed next iteration once this iteration's
                    # admissions raise the domain min
                    next_rows.append(i)
            if items:
                missed = self.cache.account_bind_bulk(
                    items, req_rows=eb2.pf.requests[req_rows],
                    expected_inc=iter_incs)
                if missed:
                    # Chosen node deleted mid-cycle: not accounted, must
                    # not bind — back into the loop.
                    n_admitted -= len(missed)
                    dead = set(missed)
                    next_rows.extend(iter_rows[m] for m in missed)
                    ghost_js.extend(req_rows[m] for m in missed)
                    iter_bind = [p for m, p in enumerate(iter_bind)
                                 if m not in dead]
                missed_set = set(missed) if missed else ()
                for m in range(len(items)):
                    if m not in missed_set:
                        self._note_assumed(batch[iter_rows[m]])
            if ghost_js:
                # This iteration's walk counted the ghosts' admissions:
                # re-arbitrate with them dead; newly violating survivors
                # are unassumed and re-loop.
                re3 = self._arbitrate_packed(
                    sub, assigned2, eb2, d2, sp2,
                    dead=rev2 | set(ghost_js),
                    seq=b.seq) - rev2 - set(ghost_js)
                if re3:
                    pair_keys = ({p[0].pod.key for p in iter_bind}
                                 | {p[0].pod.key for p in out_bind})
                    kill: Set[str] = set()
                    for j in sorted(re3):
                        qpi = batch[rows[j]]
                        k = qpi.pod.key
                        if k in pair_keys:
                            self._unassume(qpi)
                            kill.add(k)
                            next_rows.append(rows[j])
                            n_admitted -= 1
                        elif self._revoke_post_assume(
                                qpi, {BATCH_CAPACITY},
                                _SPREAD_REVOKE_MSG, in_bind=False):
                            n_admitted -= 1
                    if kill:
                        iter_bind = [p for p in iter_bind
                                     if p[0].pod.key not in kill]
                        out_bind = [p for p in out_bind
                                    if p[0].pod.key not in kill]
            out_bind.extend(iter_bind)
            rows = next_rows
            if len(next_rows) == n_r:  # no progress; stop burning steps
                break
        return out_bind, rows, n_admitted

    # ---- preemption (upstream DefaultPreemption PostFilter) -------------

    _NOMINATION_TTL_S = 60.0
    _PREEMPT_MAX_ROUNDS = 3

    def _preempt_inputs(self, eb, rows):
        """The failed pods' sub-batch and a fresh full-axis snapshot of
        nodes and assigned pods, as tensors on the engine's device: (eb2,
        nf, af, names)."""
        cached = self._nf_static_device
        nf, names, static_v, row_incs = self.cache.snapshot_versioned(
            pad=self._node_pad, known_static=cached[0] if cached else None)
        nf = self._with_device_static(nf, static_v, row_incs.shape[0])
        self._count_h2d(nf.free.nbytes + nf.used_ports.nbytes)
        nf = nf._replace(free=to_torch(nf.free, self.device),
                         used_ports=to_torch(nf.used_ports, self.device))
        af = to_torch(self.cache.snapshot_assigned(pad=self._af_pad),
                      self.device)
        eb2, _p2 = self._slice_eb(eb, rows)
        return to_torch(eb2, self.device), nf, af, names

    def _try_preempt(self, batch, rows, eb, seq: int) -> Set[int]:
        """Batched candidate search (ops/preempt.py) on a fresh snapshot,
        then the host-side minimal victim commit, for terminally
        unschedulable pods. Returns the rows queued behind a preemption
        (victims evicted, nominated_node_name recorded, the preemptor
        requeued retryably) or otherwise settled."""
        from ..encode import features as F
        from ..ops.preempt import build_preempt_op, fetch_preempt
        from ..state.objects import pod_requests

        op = build_preempt_op(self.plugin_set, cfg=self.cache.cfg)
        eb2, nf, af, names = self._preempt_inputs(eb, rows)
        with span("preempt.op", pods=len(rows)):
            # The op queues its work; the pass reads the card once.
            outs = op(eb2, nf, af)
            with self._host_sync("fetch.preempt", seq):
                chosen, ok, _cnt, spread_evict = fetch_preempt(outs)

        won: Set[int] = set()
        taken: Set[str] = set()  # victims already evicted this cycle
        # One live PDB accounting pass shared by every preemptor of the
        # cycle (earlier evictions debit the budgets later ones see).
        pdb_state = self._pdb_state()
        for j, i in enumerate(rows):
            if not ok[j]:
                continue
            qpi = batch[i]
            node_name = names[int(chosen[j])]
            if node_name is None:
                continue
            # Re-check the preemptor BEFORE any eviction: a pod deleted
            # (or bound elsewhere) since the snapshot must not cost real
            # workloads their capacity.
            try:
                fresh = self.store.get("Pod", qpi.pod.key)
            except NotFoundError:
                self.queue.forget(qpi.pod.key)
                self.drop_nomination(qpi.pod.key)
                won.add(i)  # nothing further to do for this row
                continue
            if fresh.spec.node_name:
                self.drop_nomination(qpi.pod.key)
                won.add(i)  # already bound elsewhere — no verdict needed
                continue
            # Rounds cap: a cure the host could not honor would otherwise
            # evict and retry forever; after _PREEMPT_MAX_ROUNDS wins
            # without a bind, the terminal verdict stands.
            if (self._preempt_rounds.get(qpi.pod.key, 0)
                    >= self._PREEMPT_MAX_ROUNDS):
                log.warning("preemption: %s exceeded %d rounds without "
                            "binding; giving up", qpi.pod.key,
                            self._PREEMPT_MAX_ROUNDS)
                self.drop_nomination(qpi.pod.key)
                continue
            victims = self._select_victims(qpi.pod, node_name, taken,
                                           pdb_state,
                                           spread_evict=spread_evict[j])
            if victims is None:
                continue  # candidates raced away — terminal verdict stands
            if not victims:
                # The node fits outright now (state moved since the
                # step): no eviction, just retry promptly.
                self._handle_failure(
                    qpi, {BATCH_CAPACITY},
                    f"capacity freed on {node_name} since the scheduling "
                    "attempt; retrying", retryable=True)
                won.add(i)
                continue
            for vk in victims:
                try:
                    self.store.delete("Pod", vk)
                except NotFoundError:
                    pass
                else:
                    # Account the eviction NOW (idempotent with the
                    # informer's later delete-event unbind): a second
                    # preemptor of this cycle must see the freed capacity.
                    self.cache.account_unbind(vk)
                taken.add(vk)
                self.broadcaster.record(
                    involved=f"Pod:{vk}", reason="Preempted",
                    message=f"Preempted by {qpi.pod.key} on {node_name}",
                    type_="Warning",
                    namespace=vk.split("/", 1)[0])
            try:
                fresh.status.nominated_node_name = node_name
                self.store.update(fresh)
                qpi.pod = fresh
            except (NotFoundError, ConflictError):
                pass
            # Reserve the freed capacity for the preemptor until it binds
            # or the TTL lapses (upstream nominated-pod handling).
            with self._nom_lock:
                self._nominations[qpi.pod.key] = (
                    node_name, F.resources_vector(pod_requests(qpi.pod)),
                    time.monotonic() + self._NOMINATION_TTL_S)
            self._handle_failure(
                qpi, {"DefaultPreemption"},
                f"preempted {len(victims)} lower-priority pod(s) on "
                f"{node_name}; waiting for the freed capacity",
                retryable=True)
            log.info("preemption: %s evicted %d pod(s) on %s",
                     qpi.pod.key, len(victims), node_name)
            self._preempt_rounds[qpi.pod.key] = (
                self._preempt_rounds.get(qpi.pod.key, 0) + 1)
            won.add(i)
        return won

    def drop_nomination(self, pod_key: str) -> None:
        """Release a preemptor's capacity reservation (pod bound, deleted
        or otherwise gone): the informer's pod-delete path and the failure
        funnel call this so a vanished preemptor cannot pin the freed
        capacity for the rest of the TTL."""
        if self._nominations:
            with self._nom_lock:
                self._nominations.pop(pod_key, None)
        self._preempt_rounds.pop(pod_key, None)

    def _nomination_debits(self, batch_keys: Set[str], names, nf):
        """(N,R) float32 capacity reserved by OUT-OF-BATCH nominees
        (expired and orphaned nominations pruned), or None when there is
        nothing to debit."""
        now = time.monotonic()
        debits = None
        with self._nom_lock:
            drop = []
            row_of = None
            for key, (node, req, exp) in self._nominations.items():
                if exp < now:
                    drop.append(key)
                    continue
                if key in batch_keys:
                    continue  # the nominee itself sees its reservation
                if row_of is None:
                    row_of = {n: j for j, n in enumerate(names)
                              if n is not None}
                j = row_of.get(node)
                if j is None:  # nominated node is gone
                    drop.append(key)
                    continue
                if debits is None:
                    # A host allocation: nf.free may be a device tensor.
                    debits = np.zeros(
                        (int(nf.free.shape[0]), int(nf.free.shape[1])),
                        dtype=np.float32)
                debits[j] += req
            for k in drop:
                del self._nominations[k]
        return debits

    def _pdb_state(self) -> Optional[List[list]]:
        """Live PodDisruptionBudget accounting for one preemption pass:
        ``[namespace, selector, allowed_disruptions]`` rows, where
        allowed = currently bound matching pods − min_available (upstream
        disruptionsAllowed from live state). None when no PDB exists."""
        pdbs = self.store.list("PodDisruptionBudget")
        if not pdbs:
            return None
        counts = [0] * len(pdbs)

        def visit(p):
            if not p.spec.node_name:
                return
            for i, bud in enumerate(pdbs):
                if (p.metadata.namespace == bud.metadata.namespace
                        and (bud.spec.selector is None
                             or bud.spec.selector.matches(
                                 p.metadata.labels))):
                    counts[i] += 1

        # A read-only visitor: list() would deep-copy every pod. A
        # RemoteStore has no visitor; its list() objects are already
        # private decoded copies.
        for_each = getattr(self.store, "for_each", None)
        if for_each is not None:
            for_each("Pod", visit)
        else:
            for p in self.store.list("Pod"):
                visit(p)
        return [[bud.metadata.namespace, bud.spec.selector,
                 c - int(bud.spec.min_available)]
                for bud, c in zip(pdbs, counts)]

    def _select_victims(self, pod, node_name: str, taken: Set[str],
                        pdb_state: Optional[List[list]] = None,
                        spread_evict=None) -> Optional[List[str]]:
        """Victim set on ``node_name``: the MANDATORY topology victims
        (the pods matching the preemptor's own required anti-affinity,
        the symmetric repelling-term owners, and ``spread_evict[c]``
        matching pods per over-skew spread slot), then the lowest-priority
        first capacity top-up until the node's free vector covers the
        preemptor's request on every axis. None when the candidates no
        longer suffice (state raced since the device search) or a
        mandatory victim is unavailable.

        PodDisruptionBudgets: a victim whose eviction would drop a
        matching budget below min_available is skipped in the first pass
        and taken only when no non-violating set suffices, violating
        victims last (upstream's minimize-violations order; a protected
        MANDATORY victim fails the first pass outright). On success the
        shared ``pdb_state`` rows are debited, so later preemptors of the
        same cycle see the budget the earlier evictions consumed."""
        from ..encode import features as F
        from ..state.objects import pod_requests

        free0 = self.cache.free_of(node_name)
        if free0 is None:
            return None
        # Capacity reserved by OTHER pods' nominations on this node is not
        # available to this preemptor.
        with self._nom_lock:
            now = time.monotonic()
            for k, (n2, req2, exp) in self._nominations.items():
                if n2 == node_name and k != pod.key and exp >= now:
                    free0 = free0 - req2
        need = F.resources_vector(pod_requests(pod))
        cands = [(k, r) for k, r, _p in self.cache.victims_below(
            node_name, pod.spec.priority) if k not in taken]

        anti = (pod.spec.affinity.pod_anti_affinity.required
                if (pod.spec.affinity
                    and pod.spec.affinity.pod_anti_affinity) else [])
        spread_slots = []  # (constraint, count) with count > 0
        if spread_evict is not None:
            cons = pod.spec.topology_spread_constraints
            for c, e in enumerate(np.asarray(spread_evict).tolist()):
                if e > 0 and c < len(cons):
                    spread_slots.append((cons[c], int(np.ceil(e))))

        req_of = dict(cands)

        # Candidate identity (namespace, labels), fetched once. The anti
        # cure needs it for EVERY bound pod on the node, not only the
        # evictable pool: an unevictable repeller must fail the cure
        # closed, never be skipped.
        meta: Dict[str, tuple] = {}
        meta_keys: List[str] = [k for k, _ in cands]
        if anti:
            seen = set(meta_keys)
            meta_keys += [k for k in self.cache.bound_keys_on(node_name)
                          if k not in seen and k not in taken]
        if pdb_state or anti or spread_slots:
            for key in meta_keys:
                try:
                    vp = self.store.get("Pod", key)
                except NotFoundError:
                    continue
                meta[key] = (vp.metadata.namespace, vp.metadata.labels)

        # Mandatory topology victims: unavailable ones mean the state
        # raced, a repeller is unevictable, or the device's hashed match
        # was broader than the host's exact one → None, no speculative
        # eviction.
        mandatory: List[str] = []
        mset: Set[str] = set()

        def _mand(key: str) -> bool:
            if key in mset:
                return True
            if key in req_of:
                mset.add(key)
                mandatory.append(key)
                return True
            return False  # not an eligible victim (anymore)

        pod_ns = pod.metadata.namespace
        for term in anti:
            term_ns = set(term.namespaces) if term.namespaces else {pod_ns}
            for key in meta_keys:
                m = meta.get(key)
                if m is None or m[0] not in term_ns:
                    continue
                if (term.label_selector is None
                        or term.label_selector.matches(m[1])):
                    if not _mand(key):
                        return None
        for owner in self.cache.repelling_owners_on(node_name, pod):
            if owner not in taken and not _mand(owner):
                return None
        for tsc, count in spread_slots:
            got = sum(1 for key in mset
                      if (m := meta.get(key)) is not None
                      and m[0] == pod_ns
                      and (tsc.label_selector is None
                           or tsc.label_selector.matches(m[1])))
            for key, _req in cands:  # lowest priority first
                if got >= count:
                    break
                if key in mset:
                    continue
                m = meta.get(key)
                if (m is not None and m[0] == pod_ns
                        and (tsc.label_selector is None
                             or tsc.label_selector.matches(m[1]))):
                    if _mand(key):
                        got += 1
            if got < count:
                return None  # not enough matching victims anymore

        def attempt(allow_violations: bool):
            acc = free0
            victims: List[str] = []
            budgets = [list(bud) for bud in (pdb_state or [])]
            deferred: List[tuple] = []
            # Mandatory victims first: they are the cure, not a capacity
            # choice, so the fits-already exit below never skips them.
            for key in mandatory:
                if budgets:
                    m = meta.get(key)
                    hit = ([bud for bud in budgets
                            if bud[0] == m[0]
                            and (bud[1] is None or bud[1].matches(m[1]))]
                           if m is not None else [])
                    if (any(bud[2] <= 0 for bud in hit)
                            and not allow_violations):
                        return None
                    for bud in hit:
                        bud[2] -= 1
                acc = acc + req_of[key]
                victims.append(key)
            for key, req in cands:
                if key in mset:
                    continue
                if np.all(acc >= need):
                    break
                if budgets:
                    m = meta.get(key)
                    if m is None:
                        continue
                    hit = [bud for bud in budgets
                           if bud[0] == m[0]
                           and (bud[1] is None or bud[1].matches(m[1]))]
                    if any(bud[2] <= 0 for bud in hit):
                        if allow_violations:
                            # violating victims rank LAST
                            deferred.append((key, req, hit))
                        continue
                    for bud in hit:
                        bud[2] -= 1
                acc = acc + req
                victims.append(key)
            for key, req, hit in deferred:
                if np.all(acc >= need):
                    break
                for bud in hit:
                    bud[2] -= 1
                acc = acc + req
                victims.append(key)
            return (victims, budgets) if np.all(acc >= need) else None

        got = attempt(False)
        if got is None and pdb_state:
            got = attempt(True)
        if got is None:
            return None
        victims, budgets = got
        if pdb_state is not None:
            for row, new in zip(pdb_state, budgets):
                row[2] = new[2]
        return victims

    def _commit_batch(self, b: _Batch) -> None:
        with span("commit", seq=b.seq, failures=len(b.failures)):
            self._commit_batch_impl(b)

    def _commit_batch_impl(self, b: _Batch) -> None:
        """Flush the deferred failure verdicts (one store transaction, one
        queue lock hold, one event payload) and fold the metrics. Runs on
        the commit worker in pipelined mode when the batch has failures."""
        t_commit = b.commit_t0 = time.perf_counter()
        c_commit = time.thread_time()
        if b.failures:
            try:
                with span("commit.flush", pods=len(b.failures), seq=b.seq):
                    self._flush_failures(b.failures)
            except FaultWorkerDeath:
                # A simulated worker death escapes every guard, so the
                # supervisor's restart path handles it.
                raise
            except Exception:
                # The pods are popped; nothing else would requeue them.
                log.exception("bulk failure flush failed; requeueing the "
                              "tranche with backoff")
                for qpi, _plugins, _msg, _retry in b.failures:
                    self.queue.requeue_backoff(qpi)
        t_end = b.commit_t1 = time.perf_counter()
        c_end = time.thread_time()
        # The step window: dispatch to fetch, less the next batch's
        # gather that ran between them in pipelined mode; that
        # turnaround is the fetch slot of the gap, booked here where the
        # window is known (commits may run on the worker, so it cannot
        # go through _book_gap).
        gather_gap = max(0.0, b.t_fetch_start - b.t_dispatch)
        step_s = b.t_fetched - b.t_encode - gather_gap
        if b.step_share is not None:
            # A device-loop slot books its share of the tranche's window:
            # its own stamps span the whole tranche.
            gather_gap, step_s = 0.0, b.step_share
        # The resolve tail after the fetch plus this flush.
        commit_s = (b.t_resolved - b.t_fetched) + (t_end - t_commit)
        gap = b.gap
        with self._metrics_lock:
            m = self._metrics
            m["batches"] += 1
            m["pods_seen"] += len(b.batch)
            m["pods_assigned"] += b.n_assigned
            m["pods_failed"] += len(b.batch) - b.n_assigned
            m["prepare_s_total"] += b.t_encode - b.t0
            m["prepare_cpu_s_total"] += b.c_encode - b.c0
            m["encode_s_total"] += b.t_encode - b.t_enc0
            m["step_s_total"] += step_s
            m["step_dispatch_s_total"] += b.t_dispatch - b.t_encode
            m["resolve_s_total"] += commit_s
            m["resolve_cpu_s_total"] += ((b.c_resolved - b.c_fetched)
                                         + (c_end - c_commit))
            m["host_syncs_total"] += b.syncs
            m["fetch_wait_s_total"] += b.sync_s
            m["step_device_span_s_total"] += b.device_span_s
            m["commit_s_total"] += commit_s
            m["gap_s_total"] += gather_gap
            m["gap_fetch_s_total"] += gather_gap
            m["shortlist_repairs"] += b.sl_repairs
            m["shortlist_certified"] += max(0, len(b.batch) - b.sl_repairs)
            m["scored_rows_total"] += b.scored_rows
            for name, n in b.launches.items():
                m["kernel_launches"] += n
                m[f"kernel_launches_{name}"] += n
            # Per-batch series (bounded): step window, bytes moved,
            # repairs, scored rows and the gap components this batch
            # adopted, plus its own dispatch→fetch window.
            ser = m.setdefault("batch_series", {
                "device_s": [], "h2d_bytes": [], "fetch_bytes": [],
                "shortlist_repairs": [], "scored_rows": [],
                "gap_gather_s": [], "gap_encode_s": [],
                "gap_fetch_s": [], "gap_commit_s": []})
            if len(ser["device_s"]) < 64:
                ser["device_s"].append(round(step_s, 6))
                ser["h2d_bytes"].append(int(b.h2d1 - b.h2d0))
                ser["fetch_bytes"].append(int(b.fetch1 - b.fetch0))
                ser["shortlist_repairs"].append(int(b.sl_repairs))
                ser["scored_rows"].append(int(b.scored_rows))
                ser["gap_gather_s"].append(round(gap.get("gather", 0.0), 6))
                ser["gap_encode_s"].append(round(gap.get("encode", 0.0), 6))
                ser["gap_fetch_s"].append(
                    round(gap.get("fetch", 0.0) + gather_gap, 6))
                ser["gap_commit_s"].append(round(gap.get("commit", 0.0), 6))
            if b.failures:
                # Prepare-vs-flush overlap, booked here where the flush
                # window is known; a still-preparing window (end None) is
                # clipped at this flush's end.
                w0, w1 = self._prep_window
                if w1 is None:
                    w1 = t_end
                m["encode_overlap_s"] += max(
                    0.0, min(t_end, w1) - max(t_commit, w0))
            if b.seq > self._last_committed_seq:
                # Only the newest batch writes the last_* diagnostics.
                self._last_committed_seq = b.seq
                m["last_batch_size"] = len(b.batch)
                sizes = m.setdefault("batch_sizes", [])
                if len(sizes) < 16:
                    sizes.append(len(b.batch))
                m["last_encode_s"] = b.t_encode - b.t_enc0
                m["last_step_s"] = step_s
                m["last_commit_s"] = commit_s
                m["last_shapes"] = b.shapes
                m["last_shortlist_repairs"] = b.sl_repairs
                m["last_scored_rows"] = int(b.scored_rows)

    def _flush_failures(self, items: List[tuple]) -> None:
        """Apply a cycle's deferred failure verdicts in bulk: one store
        transaction for the status writes where the store has the bulk
        verb, else (a RemoteStore) a get and an update per pod. Pods
        deleted mid-flight are forgotten."""
        FAULTS.hit("commit")  # fault gate: commit-worker failure flush
        self.broadcaster.failed_scheduling_many(
            [(qpi.pod.key, qpi.pod.metadata.namespace, msg)
             for qpi, _plugins, msg, _retry in items])
        fail_bulk = getattr(self.store, "fail_pods", None)
        missing: Set[str] = set()
        if fail_bulk is not None:
            missing = set(fail_bulk(
                [(qpi.pod.key, plugins, msg)
                 for qpi, plugins, msg, _retry in items]))
        else:
            for qpi, plugins, msg, _retry in items:
                try:
                    fresh = self.store.get("Pod", qpi.pod.key)
                    if not fresh.spec.node_name:
                        fresh.status.unschedulable_plugins = sorted(plugins)
                        fresh.status.message = msg
                        self.store.update(fresh)
                        qpi.pod = fresh
                except NotFoundError:
                    missing.add(qpi.pod.key)
        retryable: List[QueuedPodInfo] = []
        unsched: List[tuple] = []
        for qpi, plugins, _msg, retry in items:
            if qpi.pod.key in missing:
                self.queue.forget(qpi.pod.key)
                self.drop_nomination(qpi.pod.key)
            elif retry:
                retryable.append(qpi)
            else:
                unsched.append((qpi, plugins))
        if retryable or unsched:
            self.queue.requeue_failures(retryable, unsched)

    def metrics(self) -> Dict[str, float]:
        """Cumulative and last-batch scheduling metrics plus current queue
        depths, the lifecycle histograms and the overload, timeline, SLO,
        journal and provenance surfaces."""
        with self._metrics_lock:
            out = dict(self._metrics)
            # dict() is shallow: the live lists must not escape the lock.
            if "batch_sizes" in out:
                out["batch_sizes"] = list(out["batch_sizes"])
            if "batch_series" in out:
                out["batch_series"] = {k: list(v) for k, v
                                       in out["batch_series"].items()}
        out.update({f"queue_{k}": v for k, v in self.queue.stats().items()})
        out["waiting_pods"] = len(self.waiting_pods)
        # Histogram snapshots (bounds/counts/sum/count); quantiles come
        # from obs.hist_quantile.
        out["histograms"] = {name: h.snapshot()
                             for name, h in self._hists.items()}
        out["shortlist_width"] = int(self._shortlist_k or 0)
        # The cache's share of the symmetric term's host seconds (bind
        # and unbind) and its live term groups (a gauge).
        sym_s, sym_terms = self.cache.sym_stats()
        out["sym_affinity_s_total"] += sym_s
        out["sym_affinity_terms"] = sym_terms
        # The ring depth the next tranche would use (0: the loop is off).
        out["loop_depth_effective"] = (self._effective_loop_depth()
                                       if self._loop_enabled else 0)
        # The index's scan width (0: off, ineligible, not built yet, or
        # disabled by a desync), its registered classes and the batches
        # left on its cooldown.
        idx = self._index
        out["index_width"] = (int(idx.k_eff) if idx is not None
                              and idx.state is not None else 0)
        out["index_classes_registered"] = (len(idx.rows) if idx is not None
                                           else 0)
        out["index_cooldown_left"] = int(self._index_cooldown)
        out["compile_cache_on"] = int(self._compile_cache_on)
        out["degradation_level"] = self._sup.level
        out["degradation_state"] = DEGRADATION_LADDER[self._sup.level]
        # Overload controller: its rung, counters and the live effective
        # knobs (all zeros and bases while MINISCHED_OVERLOAD is unset),
        # with ``shed_total`` beside the queue's shed stats.
        out.update(self._overload.metrics())
        out["shed_total"] = out.get("queue_shed_total", 0)
        out["overload_max_batch"] = self._overload.effective_max_batch(
            self.config.max_batch_size)
        out["overload_window_s"] = self._overload.effective_window(
            self.config.batch_window_s)
        out["overload_shortlist_k"] = int(self._shortlist_k or 0)
        # A RemoteStore's circuit breaker (utils/breaker.py: state,
        # opens, fast-fails, probes) and its outage ride-through counters
        # (outages, reattaches, last outage length), when the engine
        # runs as a network client of the API server.
        for stats in ("breaker_stats", "reattach_stats"):
            fn = getattr(self.store, stats, None)
            if callable(fn):
                for k, v in fn().items():
                    out[f"store_{k}"] = v
        # Result-store retention (explain/resultstore.py), with a
        # recorder only.
        if self.recorder is not None:
            for k, v in self.recorder.stats().items():
                out[f"resultstore_{k}"] = v
        out["timeline_snapshots"] = self._timeline.snapshots()
        out["timeline_dropped"] = self._timeline.dropped()
        # Burning gauges only from the current sentinel, re-derived at
        # the current clock (an idle engine resolves no batches, so the
        # batch-driven evaluate() alone would latch a stale 1).
        sent = self._slo_sentinel
        if (sent is not None and slo_mod.SLO.enabled
                and self._slo_epoch == slo_mod.SLO.epoch):
            live = sent.burning_now(self._timeline.entries(),
                                    self._timeline.now_t())
            for name, burning in live.items():
                out[f"slo_burning_{name}"] = int(burning)
        # The process-wide journal's ledger and this engine's provenance
        # store (all zeros with MINISCHED_JOURNAL unset).
        out["journal_events"] = JOURNAL.next_seq()
        out["journal_dropped"] = JOURNAL.dropped()
        out["journal_dropped_by_fault"] = JOURNAL.dropped_by_fault
        pstats = self._provenance.stats()
        out["provenance_records"] = pstats["records"]
        out["provenance_evictions"] = pstats["evictions"]
        # Per-gate fault fire counts (a process-wide registry; all zeros
        # with MINISCHED_FAULTS unset, proving a run was fault-free).
        for gate, n in FAULTS.counts().items():
            out[f"fault_fires_{gate}"] = n
        # The interpreter's collections and pause seconds (obs.GC_WATCH):
        # process-wide, the same numbers in every engine of the process.
        out.update(GC_WATCH.counters())
        # The objects the store kept off and on the collector's lists
        # (state/store.snapshot_counts), where the store counts them.
        counts = getattr(self.store, "snapshot_counts", None)
        if callable(counts):
            out.update(counts())
        return out

    # ---- timeline, SLO sentinel, overload ladder ------------------------

    def _timeline_tick(self) -> None:
        """The telemetry cadence point (scheduling thread, one per
        resolved batch, gated on TIMELINE.enabled by the caller). When
        the cadence elapses the tracker appends a row and the SLO
        sentinel evaluates its burn windows; a rising-edge alert is
        counted, traced, journaled, listed on the timeline and fed to
        the supervisor as an early warning."""
        entry = self._timeline.tick()
        if entry is None:
            return
        cfg = slo_mod.SLO
        if not cfg.enabled:
            self._overload_disarm_check()
            return
        if self._slo_sentinel is None or self._slo_epoch != cfg.epoch:
            self._slo_sentinel = slo_mod.SLOSentinel.from_config(cfg)
            self._slo_epoch = cfg.epoch
        for alert in self._slo_sentinel.evaluate(self._timeline.entries()):
            self._sup_count("slo_alerts_total")
            self._sup_count(f"slo_alerts_{alert['slo']}")
            flat = {k: v for k, v in alert.items()
                    if isinstance(v, (int, float, str))}
            instant("slo.burn", **flat)
            jnote("slo.burn", profile=self.profile, replica=self.replica,
                  batch=self._batch_seq, **flat)
            self._timeline.note_alert(alert)
            self._sup.early_warning(f"slo:{alert['slo']}")
        for name in self._slo_sentinel.last_cleared:
            instant("slo.clear", slo=name)
            jnote("slo.clear", profile=self.profile, replica=self.replica,
                  slo=name, batch=self._batch_seq)
        if overload_mod.OVERLOAD.enabled:
            self._drive_overload(entry)
        else:
            self._overload_disarm_check()

    def _set_shortlist_k(self, k: Optional[int]) -> None:
        """Rebuild the main step at shortlist width ``k`` (any K is
        exact: repairs absorb a narrow one; None = the full-width
        assignment); sampled steps read ``_shortlist_k`` per batch."""
        if self._mesh is not None:
            return  # no shortlist on a mesh: the sharded step stays
        self._shortlist_k = k
        self._step = build_step(self.plugin_set, shortlist=k,
                                assignment=self.config.assignment,
                                explain=self.config.explain)

    def _overload_disarm_check(self) -> None:
        """A runtime disarm (overload.configure("")) must not leave the
        controller's latched actuation applied: reset its level machine,
        the timeline stretch and a retuned shortlist width, and release
        any shed pods."""
        if not self._overload.note_window(set()):
            return
        self._timeline.stretch = 1
        want = self._sl_base
        if (self._shortlist_k is not None and want is not None
                and self._shortlist_k != want):
            self._set_shortlist_k(want)
        idx = self._index
        if idx is not None and idx.k_target != idx.k_base:
            # The configured indexed-scan width back (exact at any width,
            # no rebuild).
            idx.k_target = idx.k_base
        n = self.queue.release_shed()
        log.info("overload controller disarmed at runtime; actuation "
                 "neutralized (%d shed pod(s) released)", n)

    def _drive_overload(self, entry: dict) -> None:
        """Feed the controller one snapshot window (scheduling thread, at
        sentinel cadence) and apply what changed. It sees only the
        sentinel's symptom verdicts: the degraded-posture objective is
        excluded, or load shedding would hold itself engaged while the
        fault ladder is off the fast path."""
        sent = self._slo_sentinel
        burning = {sp.name for sp in sent.specs
                   if sp.kind != "degraded" and sent.burning.get(sp.name)}
        ov = self._overload
        prev_shedding = ov.shedding
        prev_brownout = ov.brownout_active
        if not ov.note_window(burning, entry.get("d_shortlist_repairs", 0.0)):
            return
        if ov.brownout_active and not prev_brownout:
            bundle_mod.capture(
                "brownout", scheduler=self,
                reason=f"overload ladder entered brownout "
                       f"(burning: {', '.join(sorted(burning))})")
        # Shortlist retune within the certified machinery; a permanent
        # certification revert (_shortlist_k None) wins.
        want = ov.shortlist_target(self._sl_base)
        if (self._shortlist_k is not None and want is not None
                and want != self._shortlist_k):
            log.warning("overload tuner: shortlist K %d -> %d",
                        self._shortlist_k, want)
            self._set_shortlist_k(want)
        # The K-dial on the indexed-scan width: live and free both ways
        # (the index keeps whole class rows, so any width is exact).
        idx = self._index
        if idx is not None:
            want_k = ov.shortlist_target(idx.k_base)
            if want_k is not None and want_k != idx.k_target:
                log.warning("overload tuner: index scan K %d -> %d",
                            idx.k_target, want_k)
                idx.k_target = want_k
        # Brownout's quality shed: a coarser timeline cadence.
        self._timeline.stretch = ov.timeline_stretch
        # Recovery below the shedding rung re-admits every parked pod now.
        if prev_shedding and not ov.shedding:
            n = self.queue.release_shed()
            if n:
                log.info("overload recovered below shedding; re-admitted "
                         "%d shed pod(s)", n)

    def _slo_burning_any(self) -> bool:
        """Is any symptom objective of the current sentinel burning? (The
        supervisor's probation gate.) The degraded-posture objective is
        excluded: it burns because the engine is degraded, and gating the
        climb on it would hold the ladder down forever."""
        sent = self._slo_sentinel
        if (sent is None or not slo_mod.SLO.enabled
                or self._slo_epoch != slo_mod.SLO.epoch):
            return False
        return any(sent.burning.get(sp.name) for sp in sent.specs
                   if sp.kind != "degraded")

    def timeline(self, since: int = 0) -> Dict:
        """The snapshot ring and the SLO alert log as one JSON-able
        document (rows with ``seq > since``); empty but valid while
        MINISCHED_TIMELINE is unset."""
        return self._timeline.to_doc(since)

    def burn_signal(self) -> tuple:
        """(overload level, "obj1,obj2"): the controller's rung and the
        last window's burning symptom objectives. Any-thread safe."""
        return (int(self._overload.level),
                ",".join(sorted(self._overload.last_burning)))

    def overload_reject_reason(self) -> Optional[str]:
        """An ingress front end's verdict for a pod create: a reason while
        the controller is at or past its reject rung (counted in
        admission_rejects_total), else None. Any-thread safe."""
        return self._overload.http_reject_reason()

    # ---- per-pod decision provenance (obs/journal.ProvenanceStore) -------

    def _prov_path(self, b: _Batch) -> dict:
        """The batch-scoped half of a provenance record: the path that
        served this batch (engine mode, ring slot, rung, residency, index
        posture, shortlist width), shared by every pod it settles."""
        return {
            "profile": self.profile,
            "replica": self.replica,
            "batch": b.seq,
            "step": self._prep_step0 + 1,
            "mode": ("loop" if b.step_share is not None
                     else "pipelined" if self.config.pipeline else "sync"),
            "loop_slot": b.loop_slot,
            "rung": DEGRADATION_LADDER[self._sup.level],
            "resident": bool(b.res_carried),
            "index": b.index_mode,
            "shortlist_k": int(self._shortlist_k or 0),
            "overload_level": self._overload.level,
            "decided_unix": round(time.time(), 3),
        }

    def _prov_stamp(self, qpi: QueuedPodInfo, node_name: str, *,
                    repaired: bool = False,
                    spread_repaired: bool = False) -> None:
        """Stamp a pod's provenance onto its QueuedPodInfo at placement
        (scheduling thread, inside resolve); the bound or failed
        settlement publishes it with the outcome."""
        path = self._prov_batch
        if path is None:
            return
        qpi.prov = {**path, "pod": qpi.pod.key, "node": node_name,
                    "attempts": qpi.attempts,
                    "shed_count": qpi.shed_count,
                    "shortlist_repaired": bool(repaired),
                    "spread_repaired": bool(spread_repaired)}

    def _prov_settle_failure(self, qpi: QueuedPodInfo, plugins,
                             message: str, retryable: bool) -> None:
        """Publish a failed or requeued pod's provenance record (journal
        armed only). A pod with no placement stamp still gets the batch
        path when the verdict lands on the scheduling thread."""
        base = qpi.prov
        qpi.prov = None  # consumed, as at the bound settlement
        if base is None:
            path = (self._prov_batch
                    if threading.get_ident() == self._fail_sink_tid
                    else None)
            base = {**path, "pod": qpi.pod.key} if path else {
                "profile": self.profile, "replica": self.replica,
                "pod": qpi.pod.key}
        self._provenance.record(qpi.pod.key, {
            **base, "outcome": "requeued" if retryable else "failed",
            "plugins": sorted(plugins), "message": message[:200],
            "attempts": qpi.attempts,
            "settled_unix": round(time.time(), 3)})

    def provenance(self, pod_key: str) -> Optional[dict]:
        """One pod's provenance record, or None (an empty store while
        MINISCHED_JOURNAL was never armed)."""
        return self._provenance.get(pod_key)

    # ---- binding cycle -------------------------------------------------

    def _start_binding_cycle(self, qpi: QueuedPodInfo, node_name: str,
                             expected_inc: Optional[int] = None):
        """Assume + permit. Returns (pair, ghost, rejected): ``pair`` is
        (qpi, node_name) when the pod is permit-free and can join the bulk
        commit, None when it was parked for a permit wait or failed
        permit; ``ghost`` when its chosen node's row vanished mid-cycle;
        ``rejected`` when a permit plugin rejected synchronously."""
        pod = qpi.pod
        # Assume the pod onto the node immediately so the next batch's
        # snapshot sees the capacity taken (upstream assume/forget model).
        if not self.cache.account_bind(pod, node_name=node_name,
                                       expected_inc=expected_inc):
            self._handle_failure(
                qpi, {BATCH_CAPACITY},
                f"chosen node {node_name} was deleted during the "
                "scheduling cycle", retryable=True)
            return None, True, False
        self._note_assumed(qpi)

        waits = []
        for plugin in self.plugin_set.permit_plugins:
            try:
                status, delay, timeout = plugin.permit(pod, node_name)
            except Exception:
                log.exception("permit plugin %s failed", plugin.name)
                status, delay, timeout = "reject", 0.0, 0.0
            if status == "reject":
                self._unassume(qpi)
                self._handle_failure(
                    qpi, {plugin.name},
                    f"pod rejected by permit plugin {plugin.name}",
                    retryable=False)
                return None, False, True
            if status == "wait":
                waits.append((plugin.name, delay, timeout))

        if waits:
            # Park the pod (reference RunPermitPlugins Wait status →
            # WaitingPod + timers, minisched.go:228-234), then bind async.
            wp = WaitingPod(pod, node_name, waits)
            with self._waiting_lock:
                self.waiting_pods[pod.key] = wp
            max_timeout = max(t for _, _, t in waits)
            self._note_detached(pod.key)  # the wait owns the placement now
            self._binder.submit(self._wait_and_bind, qpi, wp, max_timeout)
            return None, False, False
        return (qpi, node_name), False, False

    def _wait_and_bind(self, qpi: QueuedPodInfo, wp: WaitingPod,
                       max_timeout: float) -> None:
        try:
            self._wait_and_bind_impl(qpi, wp, max_timeout)
        finally:
            # The wait no longer owns the placement (bound, requeued or
            # parked): release the supervised-retry exclusion.
            with self._detached_lock:
                self._detached_live.discard(qpi.pod.key)

    def _wait_and_bind_impl(self, qpi: QueuedPodInfo, wp: WaitingPod,
                            max_timeout: float) -> None:
        sig = wp.get_signal(timeout=max_timeout + 1.0)
        with self._waiting_lock:
            self.waiting_pods.pop(qpi.pod.key, None)
        revoked = getattr(wp, "engine_revoked", None)
        if sig is None or not sig.allowed or revoked is not None:
            self._unassume(qpi)
            if revoked is not None:
                # Engine-side revocation (_revoke_post_assume), not a
                # permit verdict: retryable with the engine's attribution.
                self._handle_failure(qpi, revoked[0], revoked[1],
                                     retryable=True)
                return
            reason = sig.reason if sig else "permit wait timed out"
            self._handle_failure(
                qpi, {name for name, _, _ in wp.waits},
                f"WaitOnPermit failed: {reason}", retryable=False)
            return
        self._bind(qpi, wp.node_name)

    def _dispose_stale_owner(self, items: List[tuple]) -> None:
        """The fleet bind fence tripped: this replica lost the pod's
        shard lease between decision and commit. Withhold the bind:
        unassume (the capacity must not leak) and forget, WITHOUT a
        requeue, since the pod belongs to the shard's new owner, whose
        takeover re-gathers it from the store. A true epoch race (both
        replicas believe they hold) is safe without the fence too: the
        store's bind CAS lets exactly one commit win."""
        for qpi, _node in items:
            self._unassume(qpi)
            self.queue.forget(qpi.pod.key)
        with self._metrics_lock:
            self._metrics["stale_owner_binds"] += len(items)
        jnote("fleet.stale_bind", profile=self.profile,
              replica=self.replica, pods=len(items))

    def _fence_binds(self, items: List[tuple]) -> List[tuple]:
        """Partition a bind tranche through the fleet bind guard (a no-op
        without one): stale-owner placements are disposed of, the rest go
        on to the store commit."""
        guard = self._bind_guard
        if guard is None:
            return items
        live, stale = [], []
        for it in items:
            try:
                ok = guard(it[0].pod.key)
            except Exception:
                ok = True  # a broken fence must not drop commits
            (live if ok else stale).append(it)
        if stale:
            self._dispose_stale_owner(stale)
        return live

    def _bind(self, qpi: QueuedPodInfo, node_name: str) -> None:
        if not self._fence_binds([(qpi, node_name)]):
            return
        t0 = time.perf_counter()
        pod = qpi.pod
        try:
            with span("bind.pod"):
                bound = self.store.bind_pod(pod.key, node_name)
        except (ConflictError, NotFoundError) as e:
            self._bind_failed(qpi, node_name, e)
            return
        self.queue.forget(pod.key)
        with self._metrics_lock:
            self._metrics["pods_bound"] += 1
            self._metrics["bind_s_total"] += time.perf_counter() - t0
        self._observe_bound((qpi,))
        self.broadcaster.scheduled(bound, node_name)
        log.info("bound %s to %s", pod.key, node_name)

    def _observe_bound(self, qpis) -> None:
        """Feed the lifecycle histograms for pods that just bound. Called
        at every site that counts ``pods_bound`` (and only there), so
        ``pod_create_to_bound_s``'s count equals the bound pods. Stage
        windows come from the QueuedPodInfo stamps (added_at →
        gathered_at → decided_at → now); create→bound pairs the store's
        wall-clock creation stamp with wall-clock now. With the journal
        armed, it also settles the pods' provenance records."""
        now_m = time.monotonic()
        now_w = time.time()
        qw, dec, bnd, c2b = [], [], [], []
        for qpi in qpis:
            if qpi.gathered_at:
                qw.append(max(0.0, qpi.gathered_at - qpi.added_at))
                if qpi.decided_at:
                    dec.append(max(0.0, qpi.decided_at - qpi.gathered_at))
            if qpi.decided_at:
                bnd.append(max(0.0, now_m - qpi.decided_at))
            created = qpi.pod.metadata.creation_timestamp or now_w
            c2b.append(max(0.0, now_w - created))
        h = self._hists
        if qw:
            h["pod_queue_wait_s"].observe_many(qw)
        if dec:
            h["pod_decide_s"].observe_many(dec)
        if bnd:
            h["pod_bind_s"].observe_many(bnd)
        h["pod_create_to_bound_s"].observe_many(c2b)
        if JOURNAL.enabled:
            for qpi in qpis:
                rec = qpi.prov
                if rec is not None:
                    # Consumed: a later attempt must never publish this
                    # attempt's node and batch under its own verdict.
                    qpi.prov = None
                    self._provenance.record(qpi.pod.key, {
                        **rec, "outcome": "bound",
                        "bound_unix": round(now_w, 3)})

    def _bind_many(self, items: List[tuple], seq: int) -> None:
        """Bulk binding commit with failure containment: an unhandled
        exception on the binder pool would lose the whole tranche, so any
        failure reconciles per pod against store truth instead. ``seq``:
        the id of the batch whose resolve submitted the tranche."""
        live = items
        try:
            live = self._fence_binds(items)
            if live:
                FAULTS.hit("bind")  # fault gate: bulk binding task
                with span("bind.bulk", pods=len(live), seq=seq):
                    self._bind_many_impl(live)
        except Exception:
            log.exception("bulk bind task failed; reconciling %d "
                          "placement(s) against store truth", len(live))
            self._reconcile_bind_failure(live)
        finally:
            # The bulk commit concluded for every pod (bound, requeued or
            # forgotten): release the supervised-retry exclusions.
            with self._detached_lock:
                self._detached_live.difference_update(
                    q.pod.key for q, _n in items)

    def _bind_many_impl(self, items: List[tuple]) -> None:
        """One store.bind_pods transaction for the whole tranche, then
        per-pod bookkeeping; pods the store skipped (deleted mid-flight,
        bound elsewhere, node gone) take the per-pod failure path."""
        t0 = time.perf_counter()
        keyed = [(qpi.pod.key, qpi, node_name) for qpi, node_name in items]
        bound_keys = set(self.store.bind_pods(
            [(k, n) for k, _, n in keyed]))
        self._observe_bound([qpi for k, qpi, _n in keyed if k in bound_keys])
        self.queue.forget_many(bound_keys)
        if self._nominations:  # a bound nominee releases its reservation
            with self._nom_lock:
                for k in bound_keys:
                    self._nominations.pop(k, None)
                    self._preempt_rounds.pop(k, None)
        with self._metrics_lock:
            self._metrics["pods_bound"] += len(bound_keys)
            self._metrics["bind_s_total"] += time.perf_counter() - t0
        ok = keyed
        if len(bound_keys) != len(keyed):
            ok = []
            for k, qpi, node_name in keyed:
                if k in bound_keys:
                    ok.append((k, qpi, node_name))
                else:
                    self._bind_failed(qpi, node_name,
                                      "skipped by bulk commit")
        self.broadcaster.scheduled_many(
            [(k, qpi.pod.metadata.namespace, n) for k, qpi, n in ok])

    def _reconcile_bind_failure(self, items: List[tuple]) -> None:
        """Per-pod recovery for an aborted bulk bind: a pod the store DID
        bind keeps its assume; an unbound pod is unassumed and requeued;
        a deleted pod releases everything."""
        for qpi, node_name in items:
            key = qpi.pod.key
            try:
                fresh = self.store.get("Pod", key)
            except NotFoundError:
                self._unassume(qpi)
                self.queue.forget(key)
                continue
            if fresh.spec.node_name:
                self.queue.forget(key)
                with self._metrics_lock:
                    self._metrics["pods_bound"] += 1
                self._observe_bound((qpi,))
            else:
                self._bind_failed(qpi, node_name, "bulk bind task aborted")

    def _bind_failed(self, qpi: QueuedPodInfo, node_name: str,
                     reason) -> None:
        """Unassume, then drop (pod deleted) or requeue with backoff."""
        self._unassume(qpi)
        with self._metrics_lock:
            self._metrics["bind_conflicts"] += 1
        try:
            self.store.get("Pod", qpi.pod.key)
        except NotFoundError:
            self.queue.forget(qpi.pod.key)
            return
        log.warning("bind of %s to %s failed: %s", qpi.pod.key, node_name,
                    reason)
        self.queue.requeue_backoff(qpi)

    def _revoke_post_assume(self, qpi: QueuedPodInfo, plugins: Set[str],
                            msg: str, *, in_bind: bool) -> bool:
        """Reverse an assume made this cycle. ``in_bind``: the pod sits in
        the unsubmitted bulk list, so unassume + requeue is race-free.
        Otherwise an in-flight permit wait is rejected (its continuation
        unassumes and requeues); a wait that already resolved may have
        bound, and the revocation is declined."""
        if in_bind:
            self._unassume(qpi)
            self._handle_failure(qpi, plugins, msg, retryable=True)
            return True
        with self._waiting_lock:
            wp = self.waiting_pods.get(qpi.pod.key)
            if wp is None:
                return False
            wp.engine_revoked = (set(plugins), msg)
        wp.reject("engine", msg)
        return True

    def _unassume(self, qpi: QueuedPodInfo) -> None:
        self.cache.account_unbind(qpi.pod.key)

    # ---- failure path (reference ErrorFunc minisched.go:283-298) --------

    def _handle_failure(self, qpi: QueuedPodInfo, plugins: Set[str],
                        message: str, *, retryable: bool) -> None:
        if JOURNAL.enabled:
            self._prov_settle_failure(qpi, plugins, message, retryable)
        sink = self._fail_sink
        if sink is not None and threading.get_ident() == self._fail_sink_tid:
            sink.append((qpi, set(plugins), message, retryable))
            return
        pod = qpi.pod
        self.broadcaster.failed_scheduling(pod, message)
        try:
            fresh = self.store.get("Pod", pod.key)
            if not fresh.spec.node_name:
                fresh.status.unschedulable_plugins = sorted(plugins)
                fresh.status.message = message
                self.store.update(fresh)
                qpi.pod = fresh
        except NotFoundError:
            self.queue.forget(pod.key)
            self.drop_nomination(pod.key)
            return
        if retryable:
            self.queue.requeue_backoff(qpi)
        else:
            self.queue.add_unschedulable(qpi, plugins)

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
           ∧ → scores → normalize → weigh → sum → greedy capacity-aware
           assignment (the shortlist scan or the full greedy kernel on a
           card) → pack the decision on the device
  resolve  read the packed decision back (one fetch) → replay the
           device's debits and port insertions into the residency mirror
           → the full-axis residual pass for pods the sample found no
           node for → the RWO arbitration (arbitrate_rwo) and the
           topology arbitration (hard skew and required anti-affinity
           within the batch, arbitrate_spread) → per pod: assume + permit
           plugins (host) or a failure verdict → the in-cycle repair of
           revoked pods (_repair_spread) → the preemption pass for
           terminally unschedulable pods (DefaultPreemption,
           _try_preempt) → async bulk bind
  commit   flush the batch's failure verdicts in bulk, fold the metrics

With ``config.pipeline`` (the default) the loop is the bounded two-deep
pipeline of ``_run_pipelined``; otherwise the three phases run back to
back on the scheduling thread.

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

import logging
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Set

import numpy as np
import torch

from ..config import SchedulerConfig
from ..encode import NodeFeatureCache, encode_pods, to_torch
from ..encode.cache import bucket_for, step_bucket
from ..encode.features import GangFeatures
from ..errors import ConflictError, NotFoundError
from ..faults import FAULTS, FaultWorkerDeath
from ..obs import instant, span
from ..obs.journal import note as jnote
from ..ops import prng
from ..ops._cuda_build import KERNELS, LAUNCHES
from ..ops.pipeline import Decision, build_step
from ..ops.residency import (apply_rows, apply_rows_bytes, insert_ports,
                             insert_ports_bytes, pack_decision_i32,
                             pack_decision_slim, replay_ports_host,
                             unpack_decision_i32, unpack_decision_slim)
from ..plugins.base import PluginSet
from ..state.events import ActionType, ClusterEvent, EventBroadcaster, GVK
from ..state.objects import (CLAIM_UNUSED, CLOUD_VOLUME_AXES, Pod,
                             claim_keys, gang_key)
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

    __slots__ = ("_sched", "level", "_clean")

    def __init__(self, sched: "Scheduler"):
        self._sched = sched
        self.level = 0
        self._clean = 0

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
        jnote("supervisor.escalate", frm=DEGRADATION_LADDER[self.level - 1],
              to=DEGRADATION_LADDER[self.level], level=self.level,
              reason=reason, batch=s._batch_seq, step=s._step_counter)
        log.warning("supervisor: degraded to %r (%s)",
                    DEGRADATION_LADDER[self.level], reason)

    def note_clean(self) -> None:
        """One batch resolved with no fault: probation bookkeeping."""
        if self.level == 0:
            return
        self._clean += 1
        if self._clean >= max(1, self._sched.config.probation_batches):
            self._clean = 0
            self.level -= 1
            self._sched._sup_count("supervisor_recoveries")
            instant("supervisor.recover",
                    to=DEGRADATION_LADDER[self.level], level=self.level)
            jnote("supervisor.recover", frm=DEGRADATION_LADDER[self.level + 1],
                  to=DEGRADATION_LADDER[self.level], level=self.level,
                  batch=self._sched._batch_seq)
            log.info("supervisor: probation passed; re-escalated to %r",
                     DEGRADATION_LADDER[self.level])


class _Batch:
    """One batch moving through prepare → resolve → commit."""

    __slots__ = ("batch", "eb", "eb_dev", "nf", "af", "key", "sample_k",
                 "names", "row_incs", "decision", "packed_dev",
                 "spread_dev", "fail_closed", "vol_memo", "nom_reserved",
                 "res_carried", "failures", "n_assigned", "launches",
                 "sl_repairs", "assumed", "detached", "seq", "t0",
                 "t_encode", "t_dispatch", "t_fetch_start", "t_fetched",
                 "t_resolved")

    def __init__(self):
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


def _count_launches(b: _Batch, fn, *args, **kwargs):
    """Run ``fn`` and book the kernel launches it made into ``b``. Only
    the scheduling thread launches kernels, so the deltas are this
    batch's."""
    before = dict(LAUNCHES)
    out = fn(*args, **kwargs)
    for name, n in LAUNCHES.items():
        if n != before[name]:
            b.launches[name] = b.launches.get(name, 0) + n - before[name]
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
                 shared: Optional[SharedClusterState] = None):
        self.store = store
        self.plugin_set = plugin_set
        self.config = config or SchedulerConfig()
        if self.config.assignment != "greedy":
            raise ValueError(f"unknown assignment strategy "
                             f"{self.config.assignment!r}; this package "
                             "implements 'greedy'")
        # Resolved (and checked) at construction: a missing card fails
        # start_scheduler, not every later cycle.
        self.device = self.config.device()
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

        # Shortlist-compressed arbitration: None = the full greedy kernel.
        self._shortlist_k = (self.config.shortlist_k
                             if self.config.shortlist else None)
        self._step = build_step(plugin_set, shortlist=self._shortlist_k)
        self._key = prng.PRNGKey(self.config.seed)
        self._step_counter = 0
        # Supervisor replay anchor: the step counter the batch in prepare
        # started from (see _prepare_batch).
        self._prep_step0 = 0
        self._batch_seq = 0
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
        # (cache static version, pad). Scheduling thread only.
        self._nf_static_device = None
        # Slim decision readback rides the residency knob, as in the JAX
        # package: device_resident=False restores the all-i32 fetch.
        self._slim = bool(self.config.device_resident)
        self._residency: Optional[_DeviceResidency] = None
        if self.config.device_resident:
            self._residency = _DeviceResidency(
                self.cache.register_dyn_listener())
        self._metrics_lock = threading.Lock()
        self._metrics: Dict[str, float] = {
            "batches": 0, "pods_seen": 0, "pods_assigned": 0,
            "pods_failed": 0, "pods_bound": 0, "bind_conflicts": 0,
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
            "last_batch_size": 0,
        }

    # ---- lifecycle -----------------------------------------------------

    def wants_pod(self, pod) -> bool:
        """Does this scheduler handle the pod? One engine per service
        handles every pod (the JAX package's single-profile mode)."""
        return True

    def start(self) -> None:
        """Start the informers + this engine's scheduling loop
        (reference scheduler.go:72-75)."""
        self._shared.ensure_started()
        self._thread = threading.Thread(target=self.run, daemon=True,
                                        name="scheduling-loop")
        self._thread.start()

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
        self.broadcaster.flush(timeout=2.0)
        self.broadcaster.close()

    def _pop(self) -> List[QueuedPodInfo]:
        cfg = self.config
        return self.queue.pop_batch(
            cfg.max_batch_size, timeout=0.2,
            gather_window=cfg.batch_window_s, gather_idle=cfg.batch_idle_s)

    def run(self) -> None:
        """The scheduling loop (reference minisched.go:28-30
        wait.UntilWithContext(ctx, scheduleOne, 0)); each iteration
        schedules a whole batch. With ``config.pipeline`` the loop is the
        bounded two-deep pipeline of _run_pipelined."""
        if self.config.pipeline:
            self._run_pipelined()
            return
        while not self._stop.is_set():
            batch = self._pop()
            if batch:
                self._schedule_guarded(batch)

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
                jnote("supervisor.quarantine", pods=len(retry),
                      batch=self._batch_seq, step=anchor)
                log.error("supervisor: exhausted the degradation ladder; "
                          "quarantined %d pods (requeued at the backoff "
                          "ceiling)", len(retry))
                return
            self._sup_count("batch_retries")
            self._step_counter = anchor  # replay, don't advance
            try:
                self.schedule_batch(list(retry))
                jnote("supervisor.retry", outcome="ok",
                      rung=DEGRADATION_LADDER[self._sup.level],
                      pods=len(retry), batch=self._batch_seq, step=anchor)
                return
            except Exception:
                jnote("supervisor.retry", outcome="failed",
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
        try:
            while not self._stop.is_set():
                if inflight is None:
                    if gather_fut is not None:
                        with span("gather.wait"):
                            batch = gather_fut.result()
                        gather_fut = None
                    else:
                        batch = self._pop()
                    if not batch:
                        pending = self._await_commit(pending)
                        continue
                    inflight, pending = self._prepare_guarded(batch,
                                                              pending)
                    continue
                if gather_fut is None and not self._stop.is_set():
                    try:
                        gather_fut = self._gatherer.submit(self._pop)
                    except RuntimeError:  # executor torn down (shutdown)
                        gather_fut = None
                pending = self._finish(inflight, pending)
                nxt = []
                if gather_fut is not None and not self._stop.is_set():
                    with span("gather.wait"):
                        nxt = gather_fut.result() or []
                    gather_fut = None
                inflight = None
                if nxt:
                    inflight, pending = self._prepare_guarded(nxt, pending)
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

    def _prepare_guarded(self, batch, pending):
        """Prepare (encode + dispatch) a popped batch → (batch in flight
        or None, pending). At the supervisor's sync rung the pipeline is
        drained and the batch runs its whole cycle here; a failed prepare
        engages the supervisor."""
        if self._sup.sync_only():
            pending = self._await_commit(pending)
            self._schedule_guarded(batch)
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
        if pending is not None:
            fut, b = pending
            try:
                with span("commit.wait"):
                    fut.result()
            except FaultWorkerDeath:
                self._restart_commit_worker(b)
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

    # ---- one batched scheduling cycle ----------------------------------

    def schedule_batch(self, batch: List[QueuedPodInfo]) -> Decision:
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
            self._nf_static_device = cached = (key, leaves)
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
                jnote("residency.desync", reason=str(e),
                      batch=self._batch_seq)
                self._sup.escalate("resident carry desync")
                res.drop("carry cross-check mismatch")
            except Exception:
                log.exception("device residency attach failed; resyncing "
                              "through a full snapshot")
                res.drop("attach error")
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
        they save). K = the power-of-two bucket of
        max(min_sample_nodes, n × pct / 100, 2 × batch), pct 0 meaning
        upstream's max(5, 50 - n / 125)."""
        cfg = self.config
        if full_axis:
            return None, None
        # This package has no overload controller, so the dial is the
        # configured percentage; the JAX engine's controller passes it
        # through unchanged while it is off (engine/overload.py:536-537).
        pct = cfg.percentage_of_nodes_to_score
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
                          sample_nodes=k), k

    def _prepare_batch(self, batch: List[QueuedPodInfo]) -> _Batch:
        with span("prepare", pods=len(batch)):
            return self._prepare_batch_impl(batch)

    def _prepare_batch_impl(self, batch: List[QueuedPodInfo]) -> _Batch:
        b = _Batch()
        b.t0 = time.perf_counter()
        cfg = self.config
        # Supervisor replay anchor: prepares run one after another on the
        # scheduling thread, so at any batch fault this is the step
        # counter the aborted attempt started from.
        self._prep_step0 = self._step_counter
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
        # Encode pods FIRST: constraints may register new topology keys,
        # which the node snapshot's domain tables must reflect.
        b.vol_memo, b.fail_closed, eb = self._encode_batch(
            batch, pods, step_bucket(len(pods), cfg.pod_bucket_min))
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
        # Fault gate: step dispatch (err → supervised retry down the
        # ladder; stall → lands in the watchdog's step window).
        FAULTS.hit("step")
        with span("step.dispatch"):
            # The host flags spare the step its reads of the card: a
            # gang-free batch skips the gang admission's, a batch with no
            # DoNotSchedule slot the caps' any_enforced.
            d = _count_launches(b, step_fn, eb_dev, nf, af, key,
                                has_gang=has_gang, hard_spread=dns)
            b.packed_dev = self._pack(d)
            # The spread/anti arbitration inputs are staged only when the
            # batch carries something the host must arbitrate: a hard
            # spread slot or a required anti-affinity term. A soft-only
            # topology batch pays neither the pack nor the fetch.
            needs_arb = hard_spread or bool(
                self._spread_enabled and self._anti_enabled
                and (eb.pf.anti_req_group[:L] >= 0).any())
            b.spread_dev = _pack_spread(d) if needs_arb else None
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
        return b

    def _encode_batch(self, batch: List[QueuedPodInfo], pods, p_pad: int):
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
        constraints this profile enforces fail closed."""
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
        eb = encode_pods(pods, p_pad, cfg=self.cache.cfg,
                         registry=self.cache.registry,
                         overflow=self.cache.overflow,
                         volumes_ready_fn=lambda p: vol_state(p)[0],
                         gang_bound_fn=self.cache.gang_bound_count,
                         volume_info_fn=lambda p: vol_state(p)[1:],
                         anti_forbidden_fn=anti_fn,
                         hard_failed=encode_hard,
                         selector_spread=self._selspread_enabled)
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
        residency, else the all-i32 stack."""
        pack = pack_decision_slim if self._slim else pack_decision_i32
        return pack(d.chosen, d.assigned, d.gang_rejected,
                    d.feasible_counts, d.feasible_static, d.reject_counts,
                    d.shortlist_repaired)

    def _fetch_decision(self, packed_dev, p: int, f: int):
        """Block on the ONE packed decision fetch and unpack it into
        writable host arrays: (chosen, assigned, gang_rejected, feasible,
        feasible_static, rejects (F,P), repaired)."""
        # Fault gate: decision fetch. ``corrupt`` scribbles the chosen
        # plane with absurd node rows, which the resolve sanity detector
        # must catch.
        act = FAULTS.hit("fetch")
        with span("fetch.decision"):
            buf = np.array(packed_dev.cpu().numpy())
        self._count_fetch(buf.nbytes)
        out = (unpack_decision_slim(buf, p, f) if self._slim
               else unpack_decision_i32(buf))
        if act == "corrupt":
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
            b.t_resolved = time.perf_counter()
        self._watchdog_check(b)
        self._sup.note_clean()

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
        if not wd:
            return
        gather_gap = max(0.0, b.t_fetch_start - b.t_dispatch)
        window = (b.t_fetched - b.t_encode) - gather_gap
        if window > wd:
            self._sup_count("watchdog_trips")
            instant("watchdog.trip", window_s=round(window, 6),
                    deadline_s=wd)
            jnote("watchdog.trip", window_s=round(window, 6),
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
        exact inputs through the full-width greedy assignment and compare
        decisions: the certificate made executable. A divergence counts a
        shortlist_desync, permanently reverts the engine to the full
        kernel, and aborts the batch into the supervised retry, which
        replays it bit-identically on the reverted path."""
        if not self.config.shortlist_check_every:
            return
        self._sl_check_tick += 1
        if self._sl_check_tick % self.config.shortlist_check_every:
            return
        self._sup_count("shortlist_checks")
        check_step = build_step(self.plugin_set, shortlist=None,
                                sample_nodes=b.sample_k)
        d = _count_launches(b, check_step, b.eb_dev, b.nf, b.af, b.key)
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
        jnote("shortlist.desync", pods=bad, batch=b.seq)
        self._disable_shortlist(
            f"decisions diverged from the full scan on {bad} pod(s)")
        raise EngineDesync(
            "shortlist certification cross-check failed: decisions "
            f"diverged from the full-width scan on {bad} pod(s)")

    def _disable_shortlist(self, reason: str) -> None:
        """Permanently revert to the full-width greedy assignment; sampled
        steps read ``_shortlist_k`` per batch."""
        log.error("disabling shortlist-compressed arbitration (%s); "
                  "reverting to the full-width scan", reason)
        jnote("shortlist.disable", reason=reason, batch=self._batch_seq)
        self._shortlist_k = None
        self._step = build_step(self.plugin_set, shortlist=None)

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
        free2 = b.decision.free_after.cpu().numpy()
        self._count_fetch(free2.nbytes)
        nf2 = b.nf._replace(free=to_torch(free2, self.device))
        d2 = _count_launches(b, self._step, to_torch(eb2, self.device), nf2,
                             b.af, prng.fold_in(b.key, 0x5E5),
                             has_gang=False, hard_spread=False)
        ch2, as2, gr2, fc2, fs2, rj2, rep2 = self._fetch_decision(
            self._pack(d2), P2, rejects.shape[0])
        b.sl_repairs += int(rep2[:n_res].sum())
        chosen[rows] = ch2[:n_res]
        assigned[rows] = as2[:n_res]
        gang_rejected[rows] = gr2[:n_res]
        feasible[rows] = fc2[:n_res]
        feasible_static[rows] = fs2[:n_res]
        rejects[:, rows] = rj2[:, :n_res]
        if sp is not None:
            sp2 = self._fetch_spread(_pack_spread(d2))
            sp_p = b.decision.spread_pre.shape[0]
            if d2.spread_pre.shape[0]:
                sp[rows] = sp2[:P2][:n_res]
                sp[sp_p + rows] = sp2[P2:2 * P2][:n_res]

    def _fetch_spread(self, payload) -> Optional[np.ndarray]:
        """Read back a staged (2P+2, G) spread table (None stays None);
        the ``fetch.spread`` span covers the wait."""
        if payload is None:
            return None
        with span("fetch.spread"):
            sp = np.array(payload.cpu().numpy())
        self._count_fetch(sp.nbytes)
        return sp

    def _arbitrate_packed(self, batch, assigned, eb, decision, sp,
                          dead: Set[int]) -> Set[int]:
        """arbitrate_spread over the packed (2P+2, G) spread fetch: the
        one place that decodes _pack_spread's row layout (pre | dom | min
        | scan_groups). The (G,D) exact tables stay on the card until a
        batch with hard rows the caps scan did not enforce asks for
        them."""
        sp_p = decision.spread_pre.shape[0]

        def exact_tables():
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
        res.note_debits(chosen, assigned, b.eb.pf.requests,
                        b.decision.free_after, add_back=b.nom_reserved)
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
        (chosen, assigned, gang_rejected, feasible, feasible_static,
         rejects, sl_repaired) = self._fetch_decision(
            b.packed_dev, eb.pf.valid.shape[0], len(self.filter_names))
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
        sp = self._fetch_spread(b.spread_dev)
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
                                               b.decision, sp, dead=revoked)
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
                                                dead=revoked | g_set)
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
            won = self._try_preempt(batch, preempt_rows, eb)
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
            self._binder.submit(self._bind_many, to_bind)
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
                                     d2.reject_counts.shape[0]))
            b.sl_repairs += int(rep2[:len(rows)].sum())
            n_r = len(rows)
            sub = [batch[i] for i in rows]
            sp2 = self._fetch_spread(_pack_spread(d2))
            rev2 = self._arbitrate_packed(sub, assigned2, eb2, d2, sp2,
                                          dead=set())
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
                    dead=rev2 | set(ghost_js)) - rev2 - set(ghost_js)
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

    def _try_preempt(self, batch, rows, eb) -> Set[int]:
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
            chosen, ok, _cnt, spread_evict = fetch_preempt(op(eb2, nf, af))

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

        # A read-only visitor: list() would deep-copy every pod.
        self.store.for_each("Pod", visit)
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
        t_commit = time.perf_counter()
        if b.failures:
            try:
                with span("commit.flush", pods=len(b.failures)):
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
        t_end = time.perf_counter()
        # The step window: dispatch to fetch, less the next batch's
        # gather that ran between them in pipelined mode.
        gather_gap = max(0.0, b.t_fetch_start - b.t_dispatch)
        with self._metrics_lock:
            m = self._metrics
            m["batches"] += 1
            m["pods_seen"] += len(b.batch)
            m["pods_assigned"] += b.n_assigned
            m["pods_failed"] += len(b.batch) - b.n_assigned
            m["prepare_s_total"] += b.t_encode - b.t0
            m["step_s_total"] += b.t_fetched - b.t_encode - gather_gap
            m["resolve_s_total"] += ((b.t_resolved - b.t_fetched)
                                     + (t_end - t_commit))
            m["shortlist_repairs"] += b.sl_repairs
            m["shortlist_certified"] += max(0, len(b.batch) - b.sl_repairs)
            m["last_shortlist_repairs"] = b.sl_repairs
            for name, n in b.launches.items():
                m["kernel_launches"] += n
                m[f"kernel_launches_{name}"] += n
            m["last_batch_size"] = len(b.batch)

    def _flush_failures(self, items: List[tuple]) -> None:
        """Apply a cycle's deferred failure verdicts in bulk. Pods deleted
        mid-flight are forgotten."""
        FAULTS.hit("commit")  # fault gate: commit-worker failure flush
        self.broadcaster.failed_scheduling_many(
            [(qpi.pod.key, qpi.pod.metadata.namespace, msg)
             for qpi, _plugins, msg, _retry in items])
        missing = set(self.store.fail_pods(
            [(qpi.pod.key, plugins, msg)
             for qpi, plugins, msg, _retry in items]))
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
        """Cumulative scheduling metrics plus current queue depths."""
        with self._metrics_lock:
            out = dict(self._metrics)
        out.update({f"queue_{k}": v for k, v in self.queue.stats().items()})
        out["waiting_pods"] = len(self.waiting_pods)
        out["shortlist_width"] = int(self._shortlist_k or 0)
        out["degradation_state"] = DEGRADATION_LADDER[self._sup.level]
        # Per-gate fault fire counts (a process-wide registry; all zeros
        # with MINISCHED_FAULTS unset, proving a run was fault-free).
        for gate, n in FAULTS.counts().items():
            out[f"fault_fires_{gate}"] = n
        return out

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

    def _bind(self, qpi: QueuedPodInfo, node_name: str) -> None:
        t0 = time.perf_counter()
        pod = qpi.pod
        try:
            bound = self.store.bind_pod(pod.key, node_name)
        except (ConflictError, NotFoundError) as e:
            self._bind_failed(qpi, node_name, e)
            return
        self.queue.forget(pod.key)
        with self._metrics_lock:
            self._metrics["pods_bound"] += 1
            self._metrics["bind_s_total"] += time.perf_counter() - t0
        self.broadcaster.scheduled(bound, node_name)
        log.info("bound %s to %s", pod.key, node_name)

    def _bind_many(self, items: List[tuple]) -> None:
        """Bulk binding commit with failure containment: an unhandled
        exception on the binder pool would lose the whole tranche, so any
        failure reconciles per pod against store truth instead."""
        try:
            FAULTS.hit("bind")  # fault gate: bulk binding task
            with span("bind.bulk", pods=len(items)):
                self._bind_many_impl(items)
        except Exception:
            log.exception("bulk bind task failed; reconciling %d "
                          "placement(s) against store truth", len(items))
            self._reconcile_bind_failure(items)
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

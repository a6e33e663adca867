"""Out-of-process scheduler fleet: process-supervised replicas over
RemoteStore, elastic load-skew shard handoff, warm sub-second takeover.

The in-process fleet (fleet/supervisor.py) proves the lease protocol;
this module promotes it to REAL process isolation — the Borg shape: a
supervisor spawns ``MINISCHED_FLEET_PROC=N`` replica *processes*, each
running a full engine over an HTTP ``RemoteStore`` against one
apiserver, with the per-shard lease CAS heartbeat riding the same wire
as every bind. A SIGKILL'd replica leaves exactly the debris a dead
process leaves — unexpired Lease objects, unbound pods, a half-staged
device-loop ring — and a peer claims it all through the existing epoch
fence within about one lease TTL.

Three subsystems live here:

**Process lifecycle (spawn → mourn → respawn).** ``ProcFleetSupervisor``
spawns each replica via the stdin-tether pattern (scenario/remote.py):
the child prints ``READY <rid> <sidecar-address>`` once serving and
exits when its stdin closes, so a dead supervisor reaps its fleet by
construction. A monitor thread polls child exit codes into an exit-code
census (``proc.death`` journaled with the code/signal), then respawns
under a per-replica doubling backoff capped at ``backoff_cap_s`` — the
crashloop guard; a replica that stayed up ``stable_s`` earns its backoff
reset. The ``proc`` fault gate (faults.py) sits on the lifecycle seams:
``err`` fails a SPAWN (counted, backoff-respawned), ``die`` SIGKILLs the
consulting replica process from the inside (outside a replica it raises
like any worker death), ``corrupt`` scribbles the ReplicaStatus
heartbeat's resource_version before the CAS so the store must reject it.

**Elastic shard handoff.** Each replica heartbeats a ``ReplicaStatus``
object (queue depth, overload rung, binds) next to its lease renewals.
The supervisor's ``ShardRebalancer`` folds those into per-replica load
and — only after the SAME donor has been the hottest replica for
``hold`` consecutive windows with skew ≥ ``skew`` (structural
hysteresis: an oscillating donor can never accumulate a streak) —
nominates ONE counted ``ShardMove`` directive, then cools down for
``cooldown`` windows. The donor answers by draining the shard
(``release_shards``) and VOLUNTARILY clearing its lease holder
(``LeaseManager.release`` — no TTL wait); the recipient claims with the
usual epoch bump and adopts. A directive older than ``stale_s`` is
reaped so a dead party never orphans a shard: a released lease is
claimable by ANYONE once the directive is gone. Spec grammar rides
``MINISCHED_REBALANCE`` (``"1"`` = defaults;
``"skew=4,hold=3,cooldown=6,burn_weight=8,max_moves=8,stale_s=10"``).

**Warm takeover.** Before flipping ready (and therefore before claiming
any lease — a cold replica never owns work), a replica pre-warms: a
throwaway engine over a private in-process store pushes two small waves
through the full dispatch, so the process's CUDA context, each kernel's
``ctypes`` load and the caching allocator are warm before its first
real batch. The kernels themselves are built once, before any replica
is spawned, by the supervisor (``ops/_cuda_build.build_all``) into the
build directory every replica loads from (the package's ``_build/``, or
``SchedulerConfig.compile_cache``). The replica's sidecar apiserver
keeps its admission gate closed until warm. ``time_to_first_slo_s`` —
SIGKILL to the adopter's first post-takeover bind — is what this buys.

**Devices.** A replica runs on the device its spec's
``SchedulerConfig.platform`` names, and nothing else sets it: the
child's environment carries no platform variable, and a parent's
``MINISCHED_PLATFORM`` is dropped. A CPU replica hides the CUDA devices
from its process before anything can initialize CUDA
(``utils/platform_guard.py``). There is no fallback: a CUDA replica
whose kernel build or launch fails exits non-zero (``KERNEL_FAILURE_EXIT``)
and the supervisor mourns it like any death; nothing retries it on the
CPU. Kernel launch counts are per process: a replica's own launches are
read from its sidecar metrics (``kernel_launches_<name>``).

Replica entrypoint: ``python -m minisched_tpu_torch.fleet.procfleet
--replica`` with the ``MINISCHED_PROC_*`` environment below; everything
else in this module runs in the supervisor process.
"""
from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import logging

from ..errors import (AlreadyExistsError, ConflictError, NotFoundError)
from ..faults import FAULTS, FaultInjected, FaultWorkerDeath
from ..obs.journal import JOURNAL, note as jnote
from ..state import objects as obj
from ..utils.platform_guard import (cuda_initialized, enforce_cpu_only,
                                    guard_env, wants_cpu)
from .lease import LeaseManager
from .shardmap import (FLEET_ELECT_ENV, FLEET_PROC_ENV, LEASE_TTL_ENV,
                       REBALANCE_ENV, SHARDS_ENV, fleet_elect_from_env,
                       incarnation_name, lease_name, lease_ttl_from_env,
                       move_name, shard_of, shards_from_env, status_name)

log = logging.getLogger(__name__)

#: The module every replica process runs (``python -m <it> --replica``).
REPLICA_MODULE = "minisched_tpu_torch.fleet.procfleet"
#: A replica's exit code when a kernel build or launch failed in it.
KERNEL_FAILURE_EXIT = 3

#: Replica-process environment (set by the supervisor's spawn; the
#: presence of _REPLICA_ENV is how code tells it runs INSIDE a replica).
_REPLICA_ENV = "MINISCHED_PROC_REPLICA"
_APISERVER_ENV = "MINISCHED_PROC_APISERVER"
_TOKEN_ENV = "MINISCHED_PROC_TOKEN"
_CONFIG_ENV = "MINISCHED_PROC_CONFIG"
_INCARNATION_ENV = "MINISCHED_PROC_INCARNATION"
_PREWARM_ENV = "MINISCHED_PROC_PREWARM"
_TICK_ENV = "MINISCHED_PROC_TICK_S"
_FLEET_N_ENV = "MINISCHED_PROC_FLEET_N"
#: Detached replica (fleet/election.py launcher): no supervisor stdin
#: tether — the process answers only to SIGTERM and the store.
_DETACHED_ENV = "MINISCHED_PROC_DETACHED"

#: A published overload level above this is implausible (the real
#: ladder is 4 rungs deep): the rebalancer discards it as an
#: ``election:corrupt`` scribble instead of minting load from it.
MAX_PLAUSIBLE_BURN = 8


def proc_gate() -> Optional[str]:
    """Consult the ``proc`` fault gate at a lifecycle seam. ``die``
    inside a replica process is a REAL SIGKILL of the consulting process
    (the supervisor mourns a -9 exit like any crash); outside a replica
    it propagates as the usual FaultWorkerDeath so the in-process test
    suite can fire the whole catalog without killing pytest. ``err``
    propagates as FaultInjected — the caller's seam decides what failed
    (a spawn, a heartbeat). ``corrupt`` returns for the caller to
    scribble its payload."""
    try:
        return FAULTS.hit("proc")
    except FaultWorkerDeath:
        if os.environ.get(_REPLICA_ENV):
            jnote("proc.suicide", replica=os.environ[_REPLICA_ENV])
            os.kill(os.getpid(), signal.SIGKILL)
        raise


# ---------------------------------------------------------------------------
# ReplicaStatus heartbeat
# ---------------------------------------------------------------------------


def push_heartbeat(store, rid: str, fields: Dict[str, object], *,
                   counters: Optional[Dict[str, int]] = None) -> bool:
    """Create-or-CAS-update the replica's ReplicaStatus object with
    ``fields``. The ``proc`` gate sits on the write: ``err`` drops this
    heartbeat (counted — miss enough and the supervisor's census reads
    the replica stale), ``corrupt`` REWINDS the resource_version so the
    store CAS must reject the write — the supervisor's census can never
    be poisoned by a corrupted heartbeat, only starved, which the
    staleness window already covers. Returns True iff a clean heartbeat
    committed."""

    def bump(key: str) -> None:
        if counters is not None:
            counters[key] = counters.get(key, 0) + 1

    try:
        act = proc_gate()
    except FaultWorkerDeath:
        raise
    except FaultInjected:
        bump("heartbeats_dropped")
        jnote("proc.heartbeat_dropped", replica=rid)
        return False
    name = status_name(rid)
    try:
        st = store.get("ReplicaStatus", name)
    except NotFoundError:
        st = obj.ReplicaStatus(metadata=obj.ObjectMeta(name=name))
        for k, v in fields.items():
            setattr(st, k, v)
        try:
            store.create(st)
            bump("heartbeats")
            return True
        except AlreadyExistsError:
            try:
                st = store.get("ReplicaStatus", name)
            except NotFoundError:
                return False
    for k, v in fields.items():
        setattr(st, k, v)
    if act == "corrupt":
        # Zombie heartbeat: a REWOUND fencing token. The CAS below
        # rejects it by construction (the lease:corrupt proof, applied
        # to the census object).
        st.metadata.resource_version -= 1
    try:
        store.update(st, check_version=True)
    except (ConflictError, NotFoundError):
        if act == "corrupt":
            bump("stale_heartbeats_rejected")
            jnote("proc.heartbeat_rejected", replica=rid)
        return False
    bump("heartbeats")
    return act != "corrupt"


# ---------------------------------------------------------------------------
# Elastic shard handoff: rebalancer (supervisor side) + directive
# protocol (replica side)
# ---------------------------------------------------------------------------


@dataclass
class RebalanceSpec:
    """Knobs of the elastic-handoff controller (MINISCHED_REBALANCE)."""

    skew: float = 4.0        # min load(donor) - load(recipient) to act
    hold: int = 3            # consecutive windows the SAME donor must
    #                          stay hottest with skew sustained
    cooldown: int = 6        # quiet windows after a nomination
    burn_weight: float = 8.0  # overload-rung weight in the load signal
    max_moves: int = 8       # lifetime nomination cap (0 = unlimited)
    stale_s: float = 10.0    # directive TTL before anyone may reap it


_REBALANCE_KNOBS = {
    "skew": float, "hold": int, "cooldown": int,
    "burn_weight": float, "max_moves": int, "stale_s": float,
}


def parse_rebalance_spec(spec: Optional[str]) -> Optional[RebalanceSpec]:
    """``""``/``"0"``/None = off (None); ``"1"`` = defaults; otherwise
    comma-separated ``name=value`` overrides over the RebalanceSpec
    knobs (the overload.parse_spec_overrides grammar). Raises ValueError
    on unknown knobs or unparsable values — a misspelled production knob
    must fail loudly, not silently run defaults."""
    spec = (spec or "").strip()
    if spec in ("", "0"):
        return None
    out = RebalanceSpec()
    if spec == "1":
        return out
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(
                f"MINISCHED_REBALANCE segment {part!r} is not name=value")
        name, _, raw = part.partition("=")
        name = name.strip()
        conv = _REBALANCE_KNOBS.get(name)
        if conv is None:
            raise ValueError(
                f"unknown MINISCHED_REBALANCE knob {name!r} "
                f"(have: {sorted(_REBALANCE_KNOBS)})")
        try:
            setattr(out, name, conv(raw.strip()))
        except ValueError:
            raise ValueError(
                f"bad MINISCHED_REBALANCE value {raw!r} for {name!r}")
    return out


def rebalance_from_env() -> Optional[RebalanceSpec]:
    return parse_rebalance_spec(os.environ.get(REBALANCE_ENV, ""))


class ShardRebalancer:
    """Load-skew shard-move nominator — the supervisor-side half of the
    elastic handoff. Pure windowed logic plus ShardMove directives in
    the store; the replica-side half is :func:`handle_move_directives`.

    Hysteresis contract (pinned by tests/test_fleet_proc.py): a move is
    nominated only after the SAME replica has been the hottest donor for
    ``hold`` CONSECUTIVE observe() windows, each with sustained skew ≥
    ``spec.skew``; any window where the donor identity changes or the
    skew collapses resets the streak to zero, and every nomination opens
    a ``cooldown``-window quiet period. Oscillating skew (A hot, B hot,
    A hot, ...) therefore produces ZERO moves structurally — not by
    tuning, by the streak reset."""

    def __init__(self, store, spec: RebalanceSpec, *,
                 clock: Callable[[], float] = time.time):
        self.store = store
        self.spec = spec
        self._clock = clock
        self._streak = 0
        self._last_donor = ""
        self._cooldown_left = 0
        #: Fencing token stamped onto every nominated directive: the
        #: steward's lease epoch under the self-governing fleet (0 =
        #: the unfenced supervised path). Replicas reject directives
        #: below the current steward epoch — a dead steward's leftover
        #: nominations cannot move shards.
        self.steward_epoch = 0
        self.counters: Dict[str, int] = {
            "windows": 0, "moves_nominated": 0, "moves_reaped": 0,
            "streak_resets": 0, "burn_nominations": 0,
            "burn_scribbles_ignored": 0,
        }

    def load_of(self, st) -> float:
        """The burn signal: queue pressure plus the overload rung,
        weighted — a replica at a deep ladder rung reads hot even while
        its queue drains (shedding hides depth)."""
        return (float(st.queue_depth)
                + self.spec.burn_weight * float(st.overload_level))

    def observe(self, statuses: Dict[str, object],
                holders: Dict[int, str]) -> Optional[str]:
        """One rebalance window over the fresh ReplicaStatus heartbeats
        (``statuses``: rid → ReplicaStatus) and the current lease
        holders (shard → rid). Returns the nominated move's name when
        this window nominated, else None."""
        self.counters["windows"] += 1
        self.reap_stale()
        if self._cooldown_left > 0:
            self._cooldown_left -= 1
            return None
        if len(statuses) < 2:
            self._reset_streak()
            return None
        # Plausibility clamp: an ``election:corrupt`` scribble publishes
        # an absurd burn level; discarding it (counted) means a scribble
        # can only HIDE load, never mint a move — and the hysteresis
        # below already covers a signal that flickers.
        levels: Dict[str, int] = {}
        burning: Dict[str, str] = {}
        for rid, st in statuses.items():
            lvl = int(getattr(st, "overload_level", 0))
            names = str(getattr(st, "burning", "") or "")
            if lvl < 0 or lvl > MAX_PLAUSIBLE_BURN:
                self.counters["burn_scribbles_ignored"] += 1
                jnote("proc.rebalance_scribble", replica=rid, level=lvl)
                lvl, names = 0, ""
            levels[rid] = lvl
            burning[rid] = names
        loads = {rid: (float(st.queue_depth)
                       + self.spec.burn_weight * levels[rid])
                 for rid, st in statuses.items()}
        donor = max(sorted(loads), key=lambda r: loads[r])
        recipient = min(sorted(loads), key=lambda r: loads[r])
        skew_ok = (donor != recipient
                   and loads[donor] - loads[recipient] >= self.spec.skew)
        # Burn trigger (self-governing fleet): one replica burning SLOs
        # while every peer sits idle is actionable even before the queue
        # skew crosses the threshold — the same streak/cooldown
        # hysteresis applies, so oscillating burn still moves nothing.
        burn_ok = (donor != recipient
                   and (levels[donor] > 0 or bool(burning[donor]))
                   and all(levels[r] == 0 and not burning[r]
                           for r in loads if r != donor))
        if not (skew_ok or burn_ok):
            self._reset_streak()
            return None
        if donor != self._last_donor:
            # Hysteresis: a NEW hottest replica starts a fresh streak —
            # the oscillation killer.
            if self._last_donor:
                self.counters["streak_resets"] += 1
            self._last_donor = donor
            self._streak = 1
            return None
        self._streak += 1
        if self._streak < self.spec.hold:
            return None
        if (self.spec.max_moves
                and self.counters["moves_nominated"] >= self.spec.max_moves):
            return None
        donor_shards = sorted(s for s, r in holders.items() if r == donor)
        move = None
        for shard in donor_shards:
            name = move_name(shard)
            try:
                self.store.get("ShardMove", name)
                continue  # a directive is already in flight for it
            except NotFoundError:
                pass
            move = obj.ShardMove(
                metadata=obj.ObjectMeta(name=name), shard=shard,
                donor=donor, recipient=recipient, state="nominated",
                nominated_at=self._clock(), ttl_s=self.spec.stale_s,
                steward_epoch=self.steward_epoch)
            try:
                self.store.create(move)
            except AlreadyExistsError:
                move = None
                continue
            break
        if move is None:
            return None
        self.counters["moves_nominated"] += 1
        self._streak = 0
        self._last_donor = ""
        self._cooldown_left = self.spec.cooldown
        # Burn takes the label when both hold: a burning donor with idle
        # peers is the SPECIFIC condition (the weighted load usually
        # crosses the skew bar too, but the burn signal is why).
        trigger = "burn" if burn_ok else "skew"
        if trigger == "burn":
            self.counters["burn_nominations"] += 1
            jnote("rebalance.burn_nominate", shard=move.shard,
                  donor=donor, recipient=recipient,
                  level=levels[donor], burning=burning[donor][:80],
                  epoch=self.steward_epoch)
        jnote("proc.rebalance_nominate", shard=move.shard, donor=donor,
              recipient=recipient, trigger=trigger,
              skew=round(loads[donor] - loads[recipient], 3))
        log.info("rebalance: nominated shard %d %s -> %s (%s, skew %.1f)",
                 move.shard, donor, recipient, trigger,
                 loads[donor] - loads[recipient])
        return move.key

    def _reset_streak(self) -> None:
        if self._streak:
            self.counters["streak_resets"] += 1
        self._streak = 0
        self._last_donor = ""

    def reap_stale(self) -> int:
        """Delete directives older than their TTL — a dead donor or
        recipient must never orphan a shard behind a stuck directive
        (once reaped, a released lease is claimable by any replica's
        normal expired-lease scan)."""
        now = self._clock()
        reaped = 0
        for mv in list(self.store.list("ShardMove")):
            if now - mv.nominated_at > mv.ttl_s:
                try:
                    self.store.delete("ShardMove", mv.key)
                except NotFoundError:
                    continue
                reaped += 1
                self.counters["moves_reaped"] += 1
                jnote("proc.rebalance_reap", shard=mv.shard,
                      state=mv.state, donor=mv.donor,
                      recipient=mv.recipient)
        return reaped


def handle_move_directives(store, rid: str, mgr: LeaseManager, engine,
                           *, clock: Callable[[], float] = time.time,
                           steward_epoch_floor: int = 0) -> List[str]:
    """Replica-side half of the elastic handoff — one pass over the
    ShardMove directives that name this replica. Factored out of the
    replica tick so tests can drive the protocol synchronously against
    an in-process store.

    Donor (state=nominated): stop serving first (``release_shards``
    drops the queued pods; the bind fence covers in-flight work), then
    VOLUNTARILY clear the lease holder (``LeaseManager.release`` — the
    store object immediately reads claimable, no TTL wait), then CAS the
    directive to ``released``. Recipient (state=released): claim with
    the usual epoch bump, adopt the shard's pending pods, delete the
    directive. Every transition is journaled; returns the actions taken
    (``"donated:N"`` / ``"adopted:N"``)."""
    actions: List[str] = []
    for mv in list(store.list("ShardMove")):
        if clock() - mv.nominated_at > mv.ttl_s:
            continue  # stale: the supervisor's reap owns it
        if 0 < mv.steward_epoch < steward_epoch_floor:
            # Epoch fence (self-governing fleet): a directive stamped by
            # a steward whose lease epoch has since moved on is a dead
            # steward's leftover — it must never move a shard. The
            # current steward's reap deletes it; until then every
            # replica refuses it. (epoch 0 = the unfenced supervised
            # path — the parent never dies without taking the fleet.)
            jnote("proc.rebalance_fenced", replica=rid, shard=mv.shard,
                  directive_epoch=mv.steward_epoch,
                  floor=steward_epoch_floor)
            continue
        if mv.state == "nominated" and mv.donor == rid \
                and mgr.holds(mv.shard):
            epoch = mgr.epoch_of(mv.shard)
            engine.release_shards(
                {mv.shard}, epoch=epoch,
                reason=f"rebalance to {mv.recipient}")
            if not mgr.release(mv.shard):
                continue  # superseded mid-move; directive goes stale
            mv.state = "released"
            try:
                store.update(mv, check_version=True)
            except (ConflictError, NotFoundError):
                pass  # reaped/raced: the lease is released either way
            jnote("proc.rebalance_release", replica=rid, shard=mv.shard,
                  recipient=mv.recipient, epoch=epoch)
            actions.append(f"donated:{mv.shard}")
        elif mv.state == "released" and mv.recipient == rid:
            if not mgr.try_acquire(mv.shard):
                continue  # lost the claim race; leave the directive
            epoch = mgr.epoch_of(mv.shard)
            pods = engine.adopt_shards(
                {mv.shard}, epoch=epoch,
                reason=f"rebalance from {mv.donor}")
            try:
                store.delete("ShardMove", mv.key)
            except NotFoundError:
                pass
            jnote("proc.rebalance_adopt", replica=rid, shard=mv.shard,
                  frm=mv.donor, epoch=epoch, pods=pods)
            actions.append(f"adopted:{mv.shard}")
    return actions


def _reserved_shards(store, rid: str,
                     clock: Callable[[], float] = time.time) -> set:
    """Shards a live directive earmarks for SOMEONE ELSE: the donor (or
    a bystander) must not re-claim a just-released shard out from under
    the nominated recipient. Stale directives reserve nothing — the
    reap unblocks everyone."""
    out = set()
    for mv in list(store.list("ShardMove")):
        if clock() - mv.nominated_at > mv.ttl_s:
            continue
        if mv.recipient != rid:
            out.add(mv.shard)
    return out


# ---------------------------------------------------------------------------
# Replica process entrypoint
# ---------------------------------------------------------------------------


def replica_tick(store, rid: str, mgr: LeaseManager, engine,
                 n_shards: int, *,
                 clock: Callable[[], float] = time.monotonic,
                 prefer: Optional[set] = None,
                 steward_epoch_floor: int = 0) -> None:
    """One pass of the replica-side lease protocol (the in-process
    supervisor's tick, re-homed into the replica because there is no
    shared-memory supervisor to run it): renew, sync lost shards,
    answer move directives, scan-and-claim expired leases. ``prefer``
    limits the claim scan to a shard subset (the boot-time round-robin
    deal: each replica first claims only shard ≡ its index mod N, so a
    fresh fleet partitions instead of thundering at shard 0; the caller
    widens to all shards after a couple of TTLs)."""
    mgr.renew_all()
    held = frozenset(mgr.held())
    _n, owned, _e = engine.shard_view
    lost = owned - held
    if lost:
        engine.release_shards(
            lost, epoch=max(mgr.held().values(), default=0),
            reason="lease lost")
    handle_move_directives(store, rid, mgr, engine,
                           steward_epoch_floor=steward_epoch_floor)
    reserved = _reserved_shards(store, rid)
    now = clock()
    for shard in range(n_shards):
        if mgr.holds(shard) or shard in reserved:
            continue
        if prefer is not None and shard not in prefer:
            continue
        try:
            lease = store.get("Lease", lease_name(shard))
        except NotFoundError:
            lease = None
        if lease is not None and not lease.expired(now):
            continue
        prev = lease.holder if lease is not None else ""
        if not mgr.try_acquire(shard):
            continue  # a peer's CAS won this epoch
        epoch = mgr.epoch_of(shard)
        pods = engine.adopt_shards(
            {shard}, epoch=epoch,
            reason=f"takeover from {prev or 'unheld'}")
        if prev and prev != rid:
            jnote("lease.takeover", replica=rid, frm=prev, shard=shard,
                  epoch=epoch, pods=pods)
            log.warning("proc fleet: %s took over shard %d from dead %s "
                        "at epoch %d (%d pods drained)", rid, shard,
                        prev, epoch, pods)


def _prewarm(config, profile, rid: str, *, strict: bool = False) -> float:
    """Pre-warm: push two small waves through a throwaway engine over a
    PRIVATE in-process store, on this replica's device, BEFORE it flips
    ready, so the CUDA context, each kernel's ``ctypes`` load and the
    caching allocator are warm for the first adopted batches. Returns
    the warmup wall seconds (-1.0 on failure: the replica then serves
    cold). ``strict`` (a CUDA replica): a failure raises instead, and so
    does a wave left unbound or a failed cycle: a kernel that does not
    build or launch is a death, never served around."""
    t0 = time.perf_counter()
    try:
        from ..engine.scheduler import Scheduler
        from ..state.store import ClusterStore

        store = ClusterStore()
        for i in range(2):
            store.create(obj.Node(
                metadata=obj.ObjectMeta(name=f"warm-n{i}"),
                status=obj.NodeStatus(allocatable={
                    "cpu": 64000, "memory": 1 << 36, "pods": 110})))
        eng = Scheduler(store, profile.build(), config,
                        profile="default", replica=f"{rid}-warm")
        eng.start()
        try:
            # Two waves ride the ladder's small buckets (and, with the
            # device loop armed, its depth-2 ring) — the shapes a
            # takeover's first adopted batches actually dispatch.
            n = 0
            for wave in (2, 6):
                for _ in range(wave):
                    store.create(obj.Pod(
                        metadata=obj.ObjectMeta(name=f"warm-p{n}",
                                                namespace="default"),
                        spec=obj.PodSpec(requests={"cpu": 100})))
                    n += 1
                deadline = time.monotonic() + 60.0
                while time.monotonic() < deadline:
                    if all(p.spec.node_name
                           for p in store.list("Pod")):
                        break
                    time.sleep(0.01)
            faults = eng.metrics()["batch_faults"]
        finally:
            eng.shutdown()
        bound = sum(1 for p in store.list("Pod") if p.spec.node_name)
        if strict and (faults or bound < n):
            raise RuntimeError(
                f"prewarm of {rid}: {bound} of {n} pods bound, "
                f"{faults} failed cycles")
        dt = time.perf_counter() - t0
        jnote("proc.prewarm", replica=rid, s=round(dt, 3))
        return dt
    except Exception:
        if strict:
            raise
        log.exception("prewarm failed; replica %s serves cold", rid)
        return -1.0


def _build_kernels(rid: str) -> None:
    """A CUDA replica builds its kernels before ready: a cache hit once
    the supervisor (or the launcher) built them into the shared build
    directory. A failed build exits the replica."""
    from ..ops import _cuda_build

    try:
        _cuda_build.build_all()
    except Exception:
        _cuda_build.FAILURES["build"] += 1
        log.exception("replica %s: kernel build failed", rid)
    _exit_on_kernel_failure(rid)


def _exit_on_kernel_failure(rid: str,
                            failures: Optional[Dict[str, int]] = None
                            ) -> None:
    """A CUDA replica's kernel gate: any build or launch failure of this
    process exits it with ``KERNEL_FAILURE_EXIT``, at once and without a
    graceful drain (a failed launch can leave the CUDA context
    unusable): the supervisor or steward mourns the death and its peers
    take its shards over through the leases, as after a SIGKILL."""
    from ..ops import _cuda_build

    failures = failures or {k: v for k, v in _cuda_build.FAILURES.items()
                            if v}
    if failures:
        jnote("proc.kernel_failure", replica=rid, **failures)
        log.error("replica %s: kernel failures %s; exiting %d", rid,
                  failures, KERNEL_FAILURE_EXIT)
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(KERNEL_FAILURE_EXIT)


def replica_main() -> int:
    """The replica process: RemoteStore engine + lease tick +
    ReplicaStatus heartbeat + a sidecar apiserver serving THIS process's
    journal/provenance/metrics. Prints ``READY <rid> <sidecar-address>``
    once serving; exits when stdin closes (the supervisor tether) or on
    SIGTERM."""
    rid = os.environ[_REPLICA_ENV]
    main_addr = os.environ[_APISERVER_ENV]
    token = os.environ.get(_TOKEN_ENV) or None
    incarnation = int(os.environ.get(_INCARNATION_ENV, "0") or 0)
    tick_s = float(os.environ.get(_TICK_ENV, "") or
                   max(0.05, lease_ttl_from_env() / 4.0))
    spec = json.loads(os.environ.get(_CONFIG_ENV, "") or "{}")

    from ..config import SchedulerConfig

    config = SchedulerConfig(**spec.get("config", {}))
    # The spec's platform is the only device setting: a CPU replica
    # hides the CUDA devices before anything below can touch them.
    enforce_cpu_only(config.platform)
    cuda = not wants_cpu(config.platform)

    from ..apiserver.client import RemoteStore
    from ..apiserver.server import APIServer
    from ..engine.scheduler import Scheduler
    from ..service.defaultconfig import (Profile,
                                         default_scheduler_profile)
    from ..state.store import ClusterStore

    if spec.get("profile"):
        profile = Profile(**spec["profile"])
    elif spec.get("plugins"):
        profile = Profile(plugins=list(spec["plugins"]))
    else:
        profile = default_scheduler_profile()
    store = RemoteStore(main_addr, token=token)
    n_shards = shards_from_env(1)
    detached = (os.environ.get(_DETACHED_ENV, "") or "0") not in ("", "0")
    elect = fleet_elect_from_env() > 0
    # Burn publication rides the lease heartbeat; the provider lands in
    # this cell once the engine exists (the manager must predate it —
    # the bind guard closes over the manager).
    burn_cell: Dict[str, Optional[Callable[[], tuple]]] = {"fn": None}
    mgr = LeaseManager(
        store, rid,
        burn_provider=((lambda: burn_cell["fn"]()
                        if burn_cell["fn"] else (0, ""))
                       if elect else None))
    hb_counters: Dict[str, int] = {}

    ready = {"flag": False}

    # Warm BEFORE ready: a cold replica never claims a lease, so a
    # takeover always lands on a warm device when prewarm is on. A CUDA
    # replica's kernels must build and launch, or it exits.
    if cuda:
        _build_kernels(rid)
    warm_s = -1.0
    if (os.environ.get(_PREWARM_ENV, "") or "0") not in ("", "0"):
        try:
            warm_s = _prewarm(config, profile, rid, strict=cuda)
        except Exception:
            log.exception("replica %s: prewarm failed on %s", rid,
                          config.platform or "cuda:0")
            _exit_on_kernel_failure(rid, {"prewarm": 1})

    engine = Scheduler(store, profile.build(), config,
                       profile="default", replica=rid)
    engine.set_shards(frozenset(), n_shards)
    engine.set_bind_guard(
        lambda key, _m=mgr, _n=n_shards: _m.holds(shard_of(key, _n)))
    t_sync = time.perf_counter()
    engine.start()
    sync_s = time.perf_counter() - t_sync

    # Self-governing fleet (MINISCHED_FLEET_ELECT): this replica runs
    # the election, and WHEN it holds the steward lease it also runs the
    # parent's extracted duties — census, respawn, rebalance.
    election = duties = None
    if elect:
        from .election import (StewardDuties, StewardElection,
                               burn_fields, ensure_roster)

        burn_cell["fn"] = engine.burn_signal
        election = StewardElection(store, rid, ttl_s=mgr.ttl_s)
        reb_spec = rebalance_from_env()
        reb = (ShardRebalancer(store, reb_spec)
               if reb_spec is not None else None)
        duties = StewardDuties(store, rid, election, tick_s=tick_s,
                               ttl_s=mgr.ttl_s, rebalancer=reb)
        try:
            # Idempotent: ensure our own census record exists, then CAS
            # our liveness onto it (never the incarnation — only a
            # steward's mourn bumps that).
            ensure_roster(store, [rid])
            rec = store.get("Incarnation", incarnation_name(rid))
            rec.state = "alive"
            rec.pid = os.getpid()
            if incarnation >= rec.incarnation:
                rec.incarnation = incarnation
            rec.updated_at = time.time()
            store.update(rec, check_version=True)
        except Exception:
            log.exception("replica %s: census boot write failed; "
                          "the steward's scan will repair it", rid)

    # Apiserver-outage ride-through: when the RemoteStore declares the
    # wire back after an outage, the next tick re-earns EVERYTHING
    # through fresh epochs — drop local lease claims, release the
    # engine's shards, reconcile staged binds against store truth.
    reattach_box = {"pending": False, "outage_s": 0.0}
    if callable(getattr(store, "on_reattach", None)):
        def _mark_reattached(outage_s: float) -> None:
            reattach_box["outage_s"] = float(outage_s)
            reattach_box["pending"] = True

        store.on_reattach(_mark_reattached)

    # Sidecar apiserver: serves THIS process's journal / provenance /
    # metrics to the supervisor's aggregation poll. Its admission gate
    # (the overload 429 path) stays closed until the replica is ready.
    side = APIServer(ClusterStore())
    side.journal_providers.append(lambda since: JOURNAL.to_doc(since))
    side.provenance_providers.append(engine.provenance)

    def _metrics() -> Dict[str, float]:
        out = {k: v for k, v in engine.metrics().items()
               if isinstance(v, (int, float))
               and not isinstance(v, bool)}
        for k, v in mgr.counters.items():
            out[f"lease_{k}"] = v
        for k, v in hb_counters.items():
            out[f"proc_{k}"] = v
        out["proc_incarnation"] = incarnation
        out["proc_warm"] = 1.0 if warm_s >= 0 else 0.0
        out["proc_warm_s"] = warm_s
        out["proc_sync_s"] = sync_s
        out["proc_cuda_initialized"] = 1.0 if cuda_initialized() else 0.0
        if duties is not None:
            out.update(duties.metrics())
        return out

    side.metrics_providers.append(_metrics)
    side.admission_providers.append(
        lambda: None if ready["flag"] else "SchedulerWarming")
    side.start()

    stop = threading.Event()

    def _tether() -> None:
        # The supervisor holds our stdin; EOF = the supervisor is gone
        # (or told us to exit) — either way, leave.
        try:
            while sys.stdin.readline():
                pass
        except Exception:
            pass
        stop.set()

    if not detached:
        threading.Thread(target=_tether, daemon=True,
                         name="supervisor-tether").start()
    try:
        signal.signal(signal.SIGTERM, lambda *_: stop.set())
    except ValueError:
        pass  # non-main thread (embedded use)

    ready["flag"] = True
    jnote("proc.ready", replica=rid, incarnation=incarnation,
          warm=warm_s >= 0, warm_s=round(max(warm_s, 0.0), 3),
          sync_s=round(sync_s, 3))
    print(f"READY {rid} {side.address}", flush=True)

    # Boot-time round-robin deal: for the first ~2 TTLs a replica only
    # claims shards congruent to its index mod the fleet size, so a
    # cold fleet partitions the shard space instead of one fast starter
    # sweeping everything; afterwards any expired lease is fair game
    # (the takeover path).
    fleet_n = int(os.environ.get(_FLEET_N_ENV, "0") or 0)
    my_idx = int(rid[1:]) if rid[1:].isdigit() else 0
    prefer_until = time.monotonic() + 2.0 * mgr.ttl_s
    prefer = (set(range(my_idx % fleet_n, n_shards, fleet_n))
              if fleet_n >= 2 else None)

    while not stop.wait(tick_s):
        if cuda:
            _exit_on_kernel_failure(rid)
        try:
            if reattach_box["pending"]:
                # Ride-through recovery: everything this replica held
                # before the outage is re-earned through a FRESH epoch.
                # Release engine-side first (epochs still known), then
                # forget the local claims; the claim scan below
                # re-acquires expired leases with epoch+1, and the
                # reconcile squares staged binds against store truth —
                # nothing lost, nothing doubly bound.
                reattach_box["pending"] = False
                held_now = frozenset(mgr.held())
                if held_now:
                    engine.release_shards(
                        held_now,
                        epoch=max(mgr.held().values(), default=0),
                        reason="store reattach")
                mgr.drop_all()
                if election is not None:
                    election.drop()
                engine.reconcile_store(
                    reason="reattach after %.2fs outage"
                           % reattach_box["outage_s"])
                hb_counters["reattach_recoveries"] = \
                    hb_counters.get("reattach_recoveries", 0) + 1
            floor = 0
            if election is not None:
                election.tick()
                duties.tick(n_shards)
                floor = election.observed_epoch()
            use_prefer = (prefer if prefer is not None
                          and time.monotonic() < prefer_until else None)
            replica_tick(store, rid, mgr, engine, n_shards,
                         prefer=use_prefer, steward_epoch_floor=floor)
            m = engine.metrics()
            hb = {"pid": os.getpid(), "incarnation": incarnation,
                  "ready": True, "warm": warm_s >= 0,
                  "queue_depth": int(engine.queue.pending_count()),
                  "overload_level": int(m.get("overload_level", 0)),
                  "pods_bound": int(m.get("pods_bound", 0)),
                  "renewed_at": time.time(),
                  "address": side.address}
            if elect:
                # The published burn signal (election:corrupt scribbles
                # it HERE — the rebalancer's clamp is the detection).
                from .election import burn_fields

                hb.update(burn_fields(engine, counters=hb_counters))
            push_heartbeat(store, rid, hb, counters=hb_counters)
        except Exception:
            # A replica process is the unit of failure: a tick fault is
            # logged and retried, never fatal — only SIGKILL (or the
            # proc:die gate, which IS a SIGKILL in here) takes us down.
            log.exception("replica %s tick failed; continuing", rid)

    # Graceful exit (NOT the crash model — that is SIGKILL, which never
    # reaches here): drain the engine, tell the census we left.
    if election is not None and election.is_steward:
        try:
            election.resign()  # a peer claims without a TTL wait
        except Exception:
            pass
    engine.shutdown()
    try:
        push_heartbeat(store, rid,
                       {"ready": False, "renewed_at": time.time()},
                       counters=hb_counters)
    except Exception:
        pass
    side.shutdown()
    return 0


# ---------------------------------------------------------------------------
# Supervisor process
# ---------------------------------------------------------------------------


def child_device_env(env: Dict[str, str], platform: str) -> Dict[str, str]:
    """A replica's environment, made to run the port's module on the
    device ``platform`` names and on nothing else: ``PYTHONPATH`` leads
    with the root that holds this package (the spawner may run from any
    directory), a parent's ``MINISCHED_PLATFORM`` is dropped (the spec's
    config is the only device setting), no platform variable is set for
    a CUDA spec, and a CPU spec's child sees no CUDA device at all
    (``utils/platform_guard.guard_env``)."""
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    parts = [pkg_root] + [x for x in env.get("PYTHONPATH", "").split(
        os.pathsep) if x]
    env["PYTHONPATH"] = os.pathsep.join(dict.fromkeys(parts))
    env.pop("MINISCHED_PLATFORM", None)
    return guard_env(env, platform)


def prebuild_kernels(config: Dict[str, object]) -> Optional[Dict[str, str]]:
    """Build every kernel once, before replicas on a CUDA device start,
    into the build directory they load from (``compile_cache`` or the
    package's ``_build/``): N replicas started together would each run
    ``nvcc`` on first use, and a replica that builds cannot renew. A CPU
    config builds nothing (None). Not a fallback: a failed build raises
    in the caller."""
    if wants_cpu(str(config.get("platform", ""))):
        return None
    from ..ops import _cuda_build

    cache = str(config.get("compile_cache", "") or "")
    return _cuda_build.build_all(os.path.abspath(cache) if cache else "")


@dataclass
class _Proc:
    rid: str
    popen: Optional[subprocess.Popen] = None
    address: str = ""                  # sidecar apiserver (from READY)
    client: Optional[object] = None    # RemoteStore on the sidecar
    alive: bool = False
    ready: threading.Event = field(default_factory=threading.Event)
    incarnation: int = 0
    spawned_at: float = 0.0
    backoff_s: float = 0.0
    next_spawn_at: float = 0.0
    journal_cursor: int = 0
    reader: Optional[threading.Thread] = None


class ProcFleetSupervisor:
    """Spawn/mourn/respawn lifecycle over N replica processes, plus the
    cross-process observability the in-process fleet got for free:
    journal aggregation (each replica's ``GET /journal?since=`` merged,
    re-sequenced, and source-tagged so postmortem's monotone-seq
    contract holds across processes) and provenance fan-out. Duck-types
    the FleetSupervisor surface the service and the lifecycle
    kill/restart generators drive (``kill``/``restart``/``metrics``/
    ``histograms``/``shutdown``/``scheduler``/``engines``)."""

    def __init__(self, store, apiserver_address: str, *,
                 replicas: int = 2, n_shards: Optional[int] = None,
                 lease_ttl_s: Optional[float] = None,
                 token: Optional[str] = None,
                 config_overrides: Optional[dict] = None,
                 plugins: Optional[List[str]] = None,
                 profile: Optional[object] = None,
                 rebalance: Optional[RebalanceSpec] = None,
                 tick_s: Optional[float] = None,
                 prewarm: bool = True, respawn: bool = True,
                 backoff0_s: float = 0.25, backoff_cap_s: float = 5.0,
                 stable_s: float = 10.0,
                 spawn_timeout_s: float = 120.0,
                 extra_env: Optional[Dict[str, str]] = None):
        if replicas < 1:
            raise ValueError(
                f"proc fleet needs >= 1 replica, got {replicas}")
        self.store = store
        self.apiserver_address = apiserver_address.rstrip("/")
        self.n_replicas = int(replicas)
        self.n_shards = int(n_shards) if n_shards else self.n_replicas
        self.lease_ttl_s = (float(lease_ttl_s)
                            if lease_ttl_s is not None
                            else lease_ttl_from_env())
        self.tick_s = (float(tick_s) if tick_s is not None
                       else max(0.05, self.lease_ttl_s / 2.0))
        self.token = token
        self.prewarm = prewarm
        self.respawn = respawn
        self.backoff0_s = float(backoff0_s)
        self.backoff_cap_s = float(backoff_cap_s)
        self.stable_s = float(stable_s)
        self.spawn_timeout_s = float(spawn_timeout_s)
        self.extra_env = dict(extra_env or {})
        self._spec = {"config": dict(config_overrides or {})}
        if profile is not None:
            import dataclasses as _dc

            self._spec["profile"] = _dc.asdict(profile)
        elif plugins:
            self._spec["plugins"] = list(plugins)
        self.rebalancer = (ShardRebalancer(store, rebalance)
                          if rebalance is not None else None)
        self._lock = threading.RLock()
        self._procs: Dict[str, _Proc] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        #: Lifecycle census: spawns/deaths/respawns/spawn_failures plus
        #: the per-exit-code death tally (``exit_codes["-9"]`` counts
        #: SIGKILLs — the census the bench's exactly-once claim reads).
        self.counters: Dict[str, int] = {
            "spawns": 0, "deaths": 0, "respawns": 0,
            "spawn_failures": 0, "kills": 0,
        }
        self.exit_codes: Dict[str, int] = {}
        # Aggregated cross-process journal: merged entries with fresh
        # monotone seqs, each tagged source=<rid>; the supervisor's own
        # process journal merges in as source="supervisor".
        self._journal_lock = threading.Lock()
        self._poll_lock = threading.Lock()
        self._journal: List[dict] = []
        self._own_cursor = 0

    # ---- lifecycle ------------------------------------------------------

    @property
    def platform(self) -> str:
        """The replicas' device (``SchedulerConfig.platform`` of the
        spec; "" = ``cuda:0``)."""
        return str(self._spec["config"].get("platform", ""))

    def start(self) -> None:
        """Spawn every replica. On a CUDA spec the kernels are built
        first, once, into the build directory the replicas load from
        (a failed build raises here and nothing is spawned)."""
        with self._lock:
            if self._procs:
                raise RuntimeError("proc fleet already started")
        prebuild_kernels(self._spec["config"])
        with self._lock:
            for i in range(self.n_replicas):
                rid = f"p{i}"
                self._procs[rid] = _Proc(rid=rid)
        jnote("proc.fleet_start", replicas=self.n_replicas,
              shards=self.n_shards, ttl_s=self.lease_ttl_s)
        for rid in list(self._procs):
            self._spawn(rid)
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="proc-fleet-monitor")
        self._thread.start()

    def _child_env(self, p: _Proc) -> Dict[str, str]:
        env = dict(os.environ)
        env.update(self.extra_env)
        env[_REPLICA_ENV] = p.rid
        env[_APISERVER_ENV] = self.apiserver_address
        env[_INCARNATION_ENV] = str(p.incarnation)
        env[_CONFIG_ENV] = json.dumps(self._spec)
        env[_PREWARM_ENV] = "1" if self.prewarm else "0"
        env[SHARDS_ENV] = str(self.n_shards)
        env[LEASE_TTL_ENV] = str(self.lease_ttl_s)
        env[_FLEET_N_ENV] = str(self.n_replicas)
        env.setdefault("MINISCHED_JOURNAL", "1")
        child_device_env(env, self.platform)
        if self.token:
            env[_TOKEN_ENV] = self.token
        # The child must never recurse into fleet wiring of its own —
        # and a PARENTED replica never runs the election (the modes are
        # mutually exclusive: a supervisor IS the steward).
        env.pop(FLEET_PROC_ENV, None)
        env.pop("MINISCHED_FLEET", None)
        env.pop(REBALANCE_ENV, None)
        env.pop(FLEET_ELECT_ENV, None)
        env.pop(_DETACHED_ENV, None)
        return env

    def _spawn(self, rid: str) -> bool:
        with self._lock:
            p = self._procs[rid]
            if p.alive:
                return False
        try:
            proc_gate()
        except FaultInjected:
            # ``err`` (and a worker-death fired OUTSIDE a replica): the
            # spawn failed — count it, journal it, lean on the capped
            # backoff respawn. This is the fork-bomb / crashloop guard.
            self.counters["spawn_failures"] += 1
            p.backoff_s = min(max(p.backoff_s * 2, self.backoff0_s),
                              self.backoff_cap_s)
            p.next_spawn_at = time.monotonic() + p.backoff_s
            jnote("proc.spawn_failed", replica=rid,
                  backoff_s=round(p.backoff_s, 3))
            log.warning("proc fleet: spawn of %s failed (fault); "
                        "respawn in %.2fs", rid, p.backoff_s)
            return False
        try:
            popen = subprocess.Popen(
                [sys.executable, "-m", REPLICA_MODULE, "--replica"],
                stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                text=True, env=self._child_env(p))
        except OSError as e:
            self.counters["spawn_failures"] += 1
            p.backoff_s = min(max(p.backoff_s * 2, self.backoff0_s),
                              self.backoff_cap_s)
            p.next_spawn_at = time.monotonic() + p.backoff_s
            jnote("proc.spawn_failed", replica=rid, reason=str(e))
            return False
        p.popen = popen
        p.address = ""
        p.client = None
        p.ready = threading.Event()
        p.journal_cursor = 0
        p.spawned_at = time.monotonic()
        p.alive = True
        p.reader = threading.Thread(target=self._read_stdout,
                                    args=(p, popen), daemon=True,
                                    name=f"proc-{rid}-stdout")
        p.reader.start()
        self.counters["spawns"] += 1
        jnote("proc.spawn", replica=rid, pid=popen.pid,
              incarnation=p.incarnation)
        log.info("proc fleet: spawned %s (pid %d, incarnation %d)",
                 rid, popen.pid, p.incarnation)
        return True

    def _read_stdout(self, p: _Proc, popen: subprocess.Popen) -> None:
        try:
            for line in popen.stdout:
                if line.startswith("READY "):
                    parts = line.split()
                    if len(parts) >= 3:
                        from ..apiserver.client import RemoteStore

                        p.address = parts[2]
                        p.client = RemoteStore(p.address,
                                               retry_deadline_s=0.5)
                    p.ready.set()
        except Exception:
            pass

    def _run(self) -> None:
        while not self._stop.wait(self.tick_s):
            try:
                self.tick()
            except Exception:
                log.exception("proc fleet monitor tick failed; "
                              "continuing")

    def tick(self) -> None:
        """One monitor pass (callable directly by tests): mourn dead
        children, respawn due ones, poll replica journals, run a
        rebalance window."""
        now = time.monotonic()
        with self._lock:
            procs = list(self._procs.values())
        for p in procs:
            if p.alive and p.popen is not None:
                rc = p.popen.poll()
                if rc is not None:
                    self._mourn(p, rc)
        if self.respawn and not self._stop.is_set():
            for p in procs:
                if (not p.alive and p.popen is not None
                        and now >= p.next_spawn_at):
                    p.incarnation += 1
                    if self._spawn(p.rid):
                        self.counters["respawns"] += 1
                        jnote("proc.respawn", replica=p.rid,
                              incarnation=p.incarnation)
        self._poll_journals()
        if self.rebalancer is not None:
            self.rebalancer.observe(self.census(), self.lease_holders())

    def _mourn(self, p: _Proc, rc: int) -> None:
        p.alive = False
        uptime = time.monotonic() - p.spawned_at
        if uptime >= self.stable_s:
            p.backoff_s = 0.0  # earned its reset: not a crashloop
        p.backoff_s = min(max(p.backoff_s * 2, self.backoff0_s),
                          self.backoff_cap_s)
        p.next_spawn_at = time.monotonic() + p.backoff_s
        self.counters["deaths"] += 1
        key = str(rc)
        self.exit_codes[key] = self.exit_codes.get(key, 0) + 1
        jnote("proc.death", replica=p.rid, exit_code=rc,
              sig=(-rc if rc < 0 else 0),
              uptime_s=round(uptime, 3),
              backoff_s=round(p.backoff_s, 3))
        log.warning("proc fleet: replica %s died (exit %d, up %.1fs); "
                    "respawn in %.2fs", p.rid, rc, uptime, p.backoff_s)

    # ---- failure injection / recovery -----------------------------------

    def kill(self, rid: str, **_kw) -> bool:
        """SIGKILL one replica process — the REAL crash model (no flush,
        no lease release, staged work dies in-memory). The monitor
        mourns the -9 and, with respawn on, brings a fresh incarnation
        back under the capped backoff; the dead replica's shards are
        claimed by peers through the epoch fence within ~one TTL."""
        with self._lock:
            p = self._procs.get(rid)
            if p is None or not p.alive or p.popen is None:
                return False
        jnote("proc.kill", replica=rid, pid=p.popen.pid)
        try:
            p.popen.kill()
        except OSError:
            return False
        self.counters["kills"] += 1
        return True

    def restart(self, rid: str) -> bool:
        """Respawn a dead replica NOW (skipping the remaining backoff).
        Returns True iff a fresh incarnation spawned."""
        with self._lock:
            p = self._procs.get(rid)
            if p is None or p.alive:
                return False
        p.incarnation += 1
        p.next_spawn_at = 0.0
        if self._spawn(rid):
            self.counters["respawns"] += 1
            jnote("proc.respawn", replica=rid,
                  incarnation=p.incarnation)
            return True
        return False

    def shutdown(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        with self._lock:
            procs = list(self._procs.values())
        for p in procs:
            if p.popen is None:
                continue
            try:
                if p.popen.stdin:
                    p.popen.stdin.close()  # tether EOF: graceful exit
            except OSError:
                pass
        deadline = time.monotonic() + 5.0
        for p in procs:
            if p.popen is None:
                continue
            try:
                p.popen.wait(timeout=max(0.1,
                                         deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.popen.kill()
                try:
                    p.popen.wait(timeout=5)
                except subprocess.TimeoutExpired:
                    pass
            p.alive = False
        jnote("proc.fleet_shutdown", replicas=len(procs))

    # ---- cross-process observability ------------------------------------

    def _poll_journals(self) -> None:
        """Merge each live replica's journal tail (its sidecar's ``GET
        /journal?since=<cursor>``) plus this process's own journal into
        ONE re-sequenced stream: entries sort by wall clock within the
        poll batch, get fresh monotone seqs (postmortem's
        validate_journal contract — per-process seqs would collide), and
        carry ``source``/``orig_seq`` for attribution. Serialized —
        the monitor tick and an on-demand ``journal()`` call must not
        interleave their cursor advances."""
        with self._poll_lock:
            self._poll_journals_locked()

    def _poll_journals_locked(self) -> None:
        batch: List[dict] = []
        own = JOURNAL.to_doc(self._own_cursor)
        self._own_cursor = own.get("next_seq", self._own_cursor)
        for ev in own.get("entries", []):
            ev = dict(ev)
            ev["orig_seq"] = ev.get("seq")
            ev["source"] = "supervisor"
            batch.append(ev)
        with self._lock:
            procs = [p for p in self._procs.values()
                     if p.alive and p.client is not None]
        for p in procs:
            try:
                doc = p.client.journal(since=p.journal_cursor)
            except Exception:
                continue  # replica mid-death or sidecar busy: next poll
            p.journal_cursor = doc.get("next_seq", p.journal_cursor)
            for ev in doc.get("entries", []):
                ev = dict(ev)
                ev["orig_seq"] = ev.get("seq")
                ev["source"] = p.rid
                batch.append(ev)
        if not batch:
            return
        batch.sort(key=lambda e: e.get("unix", 0.0))
        with self._journal_lock:
            seq = len(self._journal)
            for ev in batch:
                seq += 1
                ev["seq"] = seq
                self._journal.append(ev)

    def journal(self, since: int = 0) -> dict:
        """The merged cross-process journal document (same shape as
        ``Journal.to_doc`` — the service's journal provider swaps this
        in under proc-fleet mode, so ``GET /journal`` narrates the WHOLE
        fleet)."""
        self._poll_journals()
        with self._journal_lock:
            entries = [dict(e) for e in self._journal
                       if e["seq"] > since]
            return {"enabled": True, "cap": 0,
                    "next_seq": len(self._journal), "dropped": 0,
                    "dropped_by_fault": 0, "sink_errors": 0,
                    "sources": sorted({e.get("source", "?")
                                       for e in self._journal}),
                    "entries": entries}

    def provenance(self, pod_key: str):
        """Fan the lookup out across live replicas' sidecars; shards are
        disjoint so at most one answers. The record is attributed with
        the serving replica."""
        with self._lock:
            procs = [p for p in self._procs.values()
                     if p.alive and p.client is not None]
        for p in procs:
            try:
                rec = p.client.provenance(pod_key)
            except Exception:
                continue
            if rec is not None:
                out = dict(rec)
                out["served_by"] = p.rid
                return out
        return None

    # ---- census / views -------------------------------------------------

    def census(self) -> Dict[str, object]:
        """Fresh ReplicaStatus heartbeats (rid → ReplicaStatus), stale
        ones (older than 3 monitor ticks + one TTL) excluded — a dead
        replica's last heartbeat must age out of the rebalancer's load
        signal."""
        horizon = time.time() - (3 * self.tick_s + self.lease_ttl_s)
        out: Dict[str, object] = {}
        try:
            statuses = self.store.list("ReplicaStatus")
        except Exception:
            return out
        for st in statuses:
            if st.ready and st.renewed_at >= horizon:
                out[st.key.replace("replica-", "", 1)] = st
        return out

    def lease_holders(self) -> Dict[int, str]:
        """Store-truth shard → holder map (expired leases read
        unheld)."""
        out: Dict[int, str] = {}
        now = time.monotonic()
        for shard in range(self.n_shards):
            try:
                lease = self.store.get("Lease", lease_name(shard))
            except Exception:
                continue
            if lease.holder and not lease.expired(now):
                out[shard] = lease.holder
        return out

    def owner_of(self, shard: int) -> str:
        return self.lease_holders().get(shard, "")

    @property
    def scheduler(self):
        """No in-process engine exists — the service's single-engine
        mirrors read None and fall back to fleet-level surfaces."""
        return None

    def engines(self) -> Dict[str, object]:
        return {}

    def replica_ids(self) -> List[str]:
        with self._lock:
            return sorted(self._procs)

    def live_replicas(self) -> List[str]:
        with self._lock:
            return sorted(r for r, p in self._procs.items() if p.alive)

    def wait_ready(self, timeout: float = 120.0) -> bool:
        """Every live replica past its READY handshake."""
        deadline = time.monotonic() + timeout
        with self._lock:
            procs = list(self._procs.values())
        for p in procs:
            left = deadline - time.monotonic()
            if left <= 0 or not p.ready.wait(timeout=left):
                return False
        return True

    def wait_converged(self, timeout: float = 30.0) -> bool:
        """Every shard's lease held (unexpired) by a LIVE replica
        process — the quiescence contract tests wait on after a kill."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            live = set(self.live_replicas())
            holders = self.lease_holders()
            if (len(holders) == self.n_shards
                    and set(holders.values()) <= live):
                return True
            time.sleep(0.05)
        return False

    def metrics(self) -> Dict[str, float]:
        """Fleet-level gauges: the lifecycle census, the census view's
        load signals, and the rebalancer counters. Per-engine counters
        live behind each replica's sidecar /metrics."""
        out: Dict[str, float] = {
            f"proc_{k}": float(v) for k, v in self.counters.items()}
        for code, n in self.exit_codes.items():
            out[f"proc_exit_{code}"] = float(n)
        census = self.census()
        out["fleet_replicas_live"] = float(len(self.live_replicas()))
        out["fleet_replicas"] = float(self.n_replicas)
        out["fleet_shards"] = float(self.n_shards)
        out["fleet_heartbeats_fresh"] = float(len(census))
        for rid, st in census.items():
            out[f"proc_{rid}_queue_depth"] = float(st.queue_depth)
            out[f"proc_{rid}_pods_bound"] = float(st.pods_bound)
            out[f"proc_{rid}_overload_level"] = float(st.overload_level)
            out[f"proc_{rid}_incarnation"] = float(st.incarnation)
        if self.rebalancer is not None:
            for k, v in self.rebalancer.counters.items():
                out[f"rebalance_{k}"] = float(v)
        return out

    def histograms(self) -> Dict[str, dict]:
        return {}


# ---------------------------------------------------------------------------
# Entrypoint
# ---------------------------------------------------------------------------


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="minisched out-of-process fleet replica")
    ap.add_argument("--replica", action="store_true",
                    help="run as a fleet replica (the supervisor's "
                         "spawn target; requires MINISCHED_PROC_* env)")
    args = ap.parse_args(argv)
    if not args.replica:
        ap.error("this module runs only as a replica (--replica); "
                 "the supervisor side is ProcFleetSupervisor")
    return replica_main()


if __name__ == "__main__":
    sys.exit(main())

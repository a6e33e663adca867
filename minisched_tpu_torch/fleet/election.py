"""Self-governing fleet: supervisor-less steward election
(``MINISCHED_FLEET_ELECT=1``).

:class:`~.procfleet.ProcFleetSupervisor` runs the fleet as replica
processes but leaves the PARENT as a single point of failure: it
alone mourns exits, respawns the dead, and nominates rebalance moves —
kill it and the fleet decays silently. The shared-state design the
repo already follows (Omega: the store's CAS is the only arbiter)
implies the fix, and Borg states it outright: control-plane masters are
ELECTED, not parented.

Three pieces, all store-arbitrated:

* :class:`StewardElection` — replicas CAS-compete for ONE epoch-fenced
  *steward* lease (the exact ``lease.py`` record/heartbeat protocol the
  shard leases use, pointed at the ``steward`` Lease object). Whoever
  holds it runs the duties; a SIGKILL'd steward is mourned like any
  replica — its lease expires, a peer claims within one TTL
  (``steward.claim``/``steward.handoff``, plus an auto-captured
  ``steward_takeover`` incident bundle), and the old steward's stale
  directives are rejected by the epoch fence (ShardMove carries
  ``steward_epoch``; the Incarnation CAS arbitrates census writes).
* :class:`StewardDuties` — the extracted parent role ANY replica can
  hold: exit-code census through store-visible
  :class:`~..state.objects.Incarnation` records (mourn = a CAS that
  bumps ``incarnation`` — exactly one steward wins each death, the
  exactly-once respawn guarantee; a record stuck ``respawning`` past
  the grace window is an orphaned incarnation the successor re-adopts),
  respawn of dead peers with capped doubling backoff (spawned
  ``start_new_session`` so they outlive their spawner), and ShardMove
  nomination through the shared :class:`~.procfleet.ShardRebalancer`
  with the burn-signal trigger.
* :func:`launch_fleet` / ``python -m minisched_tpu_torch.fleet.election
  --launch`` — detached bootstrap: build the kernels once when the spec
  names a CUDA device, create the Incarnation roster, spawn N replicas
  with no stdin tether, print their pids, EXIT. From then on
  the fleet governs itself; :class:`ElectFleet` is the store-truth
  observer (and janitor) the tests and bench read it through — it holds
  no authority.

The ``election`` fault gate (faults.py) sits on two seams: the CAS
election call in :meth:`StewardElection.tick` (``err`` drops the
claim/renew attempt — counted; miss enough and stewardship moves;
``die`` kills the would-be steward at claim time, a REAL SIGKILL inside
a replica process) and the burn-signal publication in
:func:`burn_fields` (``corrupt`` scribbles the published overload level
— the rebalancer's plausibility clamp plus the no-flap hysteresis
detect and discard it, never a double steward, never a move minted from
a scribble).

Detached replicas outlive their spawner (``start_new_session``, no
tether): whoever launches them reaps them, ``ElectFleet.shutdown`` (or
SIGTERM to every pid of ``ElectFleet.pids()``) in a ``finally``. A
replica left alive on a card keeps its CUDA context there.
"""
from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import threading
import time
from typing import Callable, Dict, List, Optional

import logging

from ..errors import AlreadyExistsError, ConflictError, NotFoundError
from ..faults import FAULTS, FaultInjected, FaultWorkerDeath
from ..obs import bundle as bundle_mod
from ..obs.journal import note as jnote
from ..state import objects as obj
from .lease import LeaseManager
from .procfleet import (MAX_PLAUSIBLE_BURN, REPLICA_MODULE, _APISERVER_ENV,
                        _CONFIG_ENV, _DETACHED_ENV, _FLEET_N_ENV,
                        _INCARNATION_ENV, _PREWARM_ENV, _REPLICA_ENV,
                        _TICK_ENV, _TOKEN_ENV, child_device_env,
                        prebuild_kernels)
from .shardmap import (FLEET_ELECT_ENV, LEASE_TTL_ENV, SHARDS_ENV,
                       incarnation_name, lease_name, lease_ttl_from_env,
                       shards_from_env, status_name, steward_name)

log = logging.getLogger(__name__)

#: Sentinel "shard" id the steward lease is filed under (outside any
#: real shard range; the record's NAME — ``steward`` — is the identity,
#: this id only keys the LeaseManager's held-map).
STEWARD_SHARD = -1


def election_gate() -> Optional[str]:
    """Consult the ``election`` fault gate at an election seam.
    ``die`` inside a replica process is a REAL SIGKILL of the would-be
    steward (a peer then claims through the TTL — never a double
    steward); outside a replica it propagates as FaultWorkerDeath so
    the in-process suite can fire the catalog without killing pytest.
    ``err`` propagates as FaultInjected — the caller drops its CAS
    election call. ``corrupt`` returns for the burn-publish seam to
    scribble its payload."""
    try:
        return FAULTS.hit("election")
    except FaultWorkerDeath:
        if os.environ.get(_REPLICA_ENV):
            jnote("steward.suicide", replica=os.environ[_REPLICA_ENV])
            os.kill(os.getpid(), signal.SIGKILL)
        raise


def burn_fields(engine, *, counters: Optional[Dict[str, int]] = None
                ) -> Dict[str, object]:
    """The burn signal a replica publishes on its heartbeats:
    ``{"overload_level", "burning"}`` from the engine's overload ladder
    and last burning SLO window. The ``election:corrupt`` gate scribbles
    it here (absurd level + a marker name) — downstream the rebalancer's
    plausibility clamp discards the scribble, which is the detection the
    gate exists to prove."""
    try:
        level, names = engine.burn_signal()
    except Exception:
        level, names = 0, ""
    act = None
    try:
        act = election_gate()
    except FaultInjected:
        pass  # err at this seam: the signal publishes unscribbled
    if act == "corrupt":
        level, names = 0x7FFF, "scribbled"
        if counters is not None:
            counters["burn_scribbles"] = counters.get(
                "burn_scribbles", 0) + 1
        jnote("steward.burn_scribbled",
              replica=os.environ.get(_REPLICA_ENV, ""))
    return {"overload_level": int(level), "burning": str(names)}


# ---------------------------------------------------------------------------
# Steward election
# ---------------------------------------------------------------------------


class StewardElection:
    """One replica's side of the steward election: CAS-compete for the
    ``steward`` Lease through the ordinary :class:`LeaseManager`
    protocol (claim = epoch+1 CAS on an expired lease, heartbeat =
    same-epoch CAS renewal, loss = supersession observed). Journaled as
    ``steward.claim/renew/lose/handoff``; a takeover from a dead
    steward auto-captures a ``steward_takeover`` incident bundle."""

    def __init__(self, store, rid: str, *,
                 ttl_s: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.store = store
        self.rid = rid
        self._clock = clock
        self._mgr = LeaseManager(store, rid, ttl_s=ttl_s, clock=clock,
                                 lease_name_fn=lambda _s: steward_name())
        self.counters: Dict[str, int] = {
            "elections_dropped": 0, "claims": 0, "renewals": 0,
            "losses": 0, "takeovers": 0,
        }

    @property
    def ttl_s(self) -> float:
        return self._mgr.ttl_s

    @property
    def is_steward(self) -> bool:
        return self._mgr.holds(STEWARD_SHARD)

    @property
    def epoch(self) -> int:
        return self._mgr.epoch_of(STEWARD_SHARD)

    def observed_epoch(self) -> int:
        """Store-truth steward epoch — the fence floor every replica
        applies to incoming directives (0 when no steward lease
        exists or the store is unreachable)."""
        try:
            return self.store.get("Lease", steward_name()).epoch
        except Exception:
            return 0

    def holder(self) -> str:
        """Store-truth live steward ("" when unheld/expired/unknown)."""
        try:
            lease = self.store.get("Lease", steward_name())
        except Exception:
            return ""
        return "" if lease.expired(self._clock()) else lease.holder

    def tick(self) -> bool:
        """One election pass: renew if steward, else challenge an
        expired/unheld lease. Returns is_steward after the pass. The
        ``election`` gate sits on the CAS call: ``err`` drops this
        tick's attempt (counted), ``die`` kills the would-be steward
        at claim time."""
        try:
            election_gate()
        except FaultInjected:
            self.counters["elections_dropped"] += 1
            jnote("steward.election_dropped", replica=self.rid)
            return self.is_steward
        if self.is_steward:
            epoch = self.epoch
            if self._mgr.renew(STEWARD_SHARD):
                self.counters["renewals"] += 1
                jnote("steward.renew", replica=self.rid, epoch=epoch)
            elif not self.is_steward:
                # The renewal observed supersession (or the record is
                # gone): stewardship has moved on.
                self.counters["losses"] += 1
                jnote("steward.lose", replica=self.rid, epoch=epoch)
            return self.is_steward
        prev = ""
        try:
            lease = self.store.get("Lease", steward_name())
            if not lease.expired(self._clock()):
                return False  # a live steward reigns
            prev = lease.holder
        except NotFoundError:
            pass  # first election ever: create-claim below
        except Exception:
            return False  # store unreachable: ride-through owns this
        if not self._mgr.try_acquire(STEWARD_SHARD):
            return False  # a peer's CAS won this epoch
        self.counters["claims"] += 1
        jnote("steward.claim", replica=self.rid, epoch=self.epoch,
              frm=prev)
        if prev and prev != self.rid:
            self.counters["takeovers"] += 1
            jnote("steward.handoff", replica=self.rid, frm=prev,
                  epoch=self.epoch)
            bundle_mod.capture(
                "steward_takeover",
                reason=f"{self.rid} claimed stewardship from dead "
                       f"{prev} at epoch {self.epoch}")
            log.warning("election: %s took stewardship from dead %s "
                        "at epoch %d", self.rid, prev, self.epoch)
        return True

    def resign(self) -> bool:
        """Graceful handoff (replica shutdown): clear the holder by CAS
        so a peer claims without waiting out the TTL."""
        epoch = self.epoch
        if not self._mgr.release(STEWARD_SHARD):
            return False
        jnote("steward.lose", replica=self.rid, epoch=epoch,
              reason="resigned")
        return True

    def drop(self) -> None:
        """Forget the local claim WITHOUT touching the store — the
        post-outage posture: re-earn stewardship through a fresh
        epoch instead of renewing a pre-outage one."""
        self._mgr.drop_all()


# ---------------------------------------------------------------------------
# Steward duties: census, respawn, rebalance
# ---------------------------------------------------------------------------


class StewardDuties:
    """The parent role, extracted: whoever holds the steward lease runs
    this. All census state lives in store-visible Incarnation records —
    every transition is a CAS, so a steward handoff adopts the ledger
    exactly-once by construction (the successor can neither re-mourn a
    death the predecessor already recorded nor double-spawn an
    incarnation the predecessor already claimed).

    Record state machine (one record per replica, created by the
    launcher):

        alive --mourn CAS (deaths+1, incarnation+1)--> respawning
        respawning --spawn-claim CAS (respawns+1)--> spawned
        spawned --replica boot CAS--> alive

    A record stuck ``respawning``/``spawned`` past ``grace_s`` with no
    fresh heartbeat is an ORPHANED incarnation (its steward died between
    CAS and spawn, or the spawn produced nothing) — the current steward
    re-adopts it through the same spawn-claim CAS, which is what makes
    a steward's death survivable mid-respawn. The steward's OWN child
    for the record is left to boot until ``boot_s`` = 6 × ``grace_s``
    (a replica on a card can outlast the grace: its CUDA start, sync
    and prewarm); past it the child is a hung boot, SIGKILLed and
    reaped before the record is re-adopted, so one process runs per
    replica."""

    def __init__(self, store, rid: str, election: StewardElection, *,
                 tick_s: float, ttl_s: float,
                 backoff0_s: float = 0.25, backoff_cap_s: float = 5.0,
                 stable_s: float = 10.0, grace_s: Optional[float] = None,
                 rebalancer=None,
                 clock: Callable[[], float] = time.time,
                 spawn_fn: Optional[Callable[[str, int], int]] = None):
        self.store = store
        self.rid = rid
        self.election = election
        self.tick_s = float(tick_s)
        self.ttl_s = float(ttl_s)
        self.backoff0_s = float(backoff0_s)
        self.backoff_cap_s = float(backoff_cap_s)
        self.stable_s = float(stable_s)
        #: Stale-heartbeat death horizon (the supervisor's census
        #: window) and the orphaned-incarnation adoption grace.
        self.horizon_s = 3 * self.tick_s + self.ttl_s
        self.grace_s = (float(grace_s) if grace_s is not None
                        else max(4 * self.ttl_s, 6 * self.tick_s, 10.0))
        #: The boot deadline of this steward's own spawn.
        self.boot_s = 6 * self.grace_s
        self.rebalancer = rebalancer
        self._clock = clock
        self._spawn_fn = spawn_fn or self._spawn_process
        self._children: Dict[int, subprocess.Popen] = {}  # pid -> popen
        self._was_steward = False
        self.counters: Dict[str, int] = {
            "mourns": 0, "respawns": 0, "spawn_failures": 0,
            "adoptions": 0, "census_conflicts": 0,
            "orphans_adopted": 0, "fenced_skips": 0,
        }

    # ---- store-truth views ----------------------------------------------

    def census(self) -> Dict[str, object]:
        """Fresh ReplicaStatus heartbeats (rid → ReplicaStatus) — the
        rebalancer's load view (same staleness window the supervised
        census uses)."""
        horizon = self._clock() - self.horizon_s
        out: Dict[str, object] = {}
        try:
            statuses = self.store.list("ReplicaStatus")
        except Exception:
            return out
        for st in statuses:
            if st.ready and st.renewed_at >= horizon:
                out[st.key.replace("replica-", "", 1)] = st
        return out

    def lease_holders(self, n_shards: int) -> Dict[int, str]:
        out: Dict[int, str] = {}
        now = time.monotonic()
        for shard in range(n_shards):
            try:
                lease = self.store.get("Lease", lease_name(shard))
            except Exception:
                continue
            if lease.holder and not lease.expired(now):
                out[shard] = lease.holder
        return out

    # ---- the duties pass -------------------------------------------------

    def tick(self, n_shards: int) -> None:
        """One duties pass — a no-op unless this replica currently
        holds the steward lease. First pass after a claim ADOPTS the
        census ledger (journaled; the records themselves are the
        handoff — nothing is copied, the CAS history is the truth)."""
        if not self.election.is_steward:
            self._was_steward = False
            return
        if not self._was_steward:
            self._was_steward = True
            try:
                recs = self.store.list("Incarnation")
            except Exception:
                recs = []
            self.counters["adoptions"] += 1
            jnote("steward.adopt", replica=self.rid,
                  epoch=self.election.epoch, records=len(recs))
        if self.rebalancer is not None:
            self.rebalancer.steward_epoch = self.election.epoch
        self._reap_children()
        now = self._clock()
        statuses = self.census()
        try:
            recs = sorted(self.store.list("Incarnation"),
                          key=lambda r: r.key)
        except Exception:
            recs = []
        for rec in recs:
            if rec.replica == self.rid:
                continue  # a steward never mourns itself
            try:
                self._tend(rec, statuses.get(rec.replica), now)
            except Exception:
                log.exception("steward %s: tending %s failed; "
                              "continuing", self.rid, rec.replica)
        if self.rebalancer is not None:
            self.rebalancer.observe(statuses,
                                    self.lease_holders(n_shards))

    def _tend(self, rec, st, now: float) -> None:
        """Advance one replica's incarnation record. Every transition is
        a CAS — a conflict means another steward (or the replica's own
        boot) moved it first, which is counted and yielded to."""
        fresh = (st is not None and st.renewed_at >= now - self.horizon_s
                 and int(st.incarnation) >= int(rec.incarnation))
        if rec.state in ("respawning", "spawned"):
            if fresh:
                # The respawn landed and heartbeats: close the loop.
                self._cas(rec, state="alive", updated_at=now)
                return
            if (rec.state == "respawning" and rec.steward == self.rid
                    and rec.steward_epoch == self.election.epoch):
                # Our own mourn: spawn once the backoff window lapses.
                if now - rec.updated_at >= rec.backoff_s:
                    self._spawn(rec, now)
                return
            if now - rec.updated_at <= self.grace_s:
                return  # in flight (booting / pre-spawn); give it time
            child = self._children.get(rec.pid)
            if child is not None and child.poll() is None:
                if now - rec.updated_at <= self.boot_s:
                    # Our own spawn, still booting past the grace: a
                    # second spawn would run two processes for one
                    # replica.
                    return
                # Past the boot deadline with no heartbeat: a hung boot.
                # Kill and reap it, then re-adopt below.
                child.kill()
                try:
                    child.wait(timeout=10.0)
                except subprocess.TimeoutExpired:
                    log.error("steward %s: hung boot of %s (pid %d) "
                              "outlived its SIGKILL", self.rid,
                              rec.replica, rec.pid)
                log.warning("steward %s: killed the hung boot of %s "
                            "(pid %d)", self.rid, rec.replica, rec.pid)
                jnote("steward.boot_kill", replica=self.rid,
                      target=rec.replica, pid=rec.pid,
                      boot_s=round(now - rec.updated_at, 3))
            # Orphaned incarnation: whoever claimed this respawn died
            # (or the spawn silently failed) — re-adopt WITHOUT bumping
            # the incarnation: the death was already censused once.
            if rec.steward_epoch > self.election.epoch:
                self.counters["fenced_skips"] += 1
                jnote("steward.fenced", replica=self.rid,
                      target=rec.replica, rec_epoch=rec.steward_epoch,
                      epoch=self.election.epoch)
                return  # our own view is the stale one
            self.counters["orphans_adopted"] += 1
            jnote("steward.orphan_adopt", replica=self.rid,
                  target=rec.replica, incarnation=rec.incarnation,
                  frm=rec.steward)
            self._spawn(rec, now)
            return
        # state == "alive"
        if fresh:
            return
        booting = now - rec.updated_at <= self.grace_s
        if booting and (rec.pid <= 0 or not _pid_dead(rec.pid)):
            # Within the boot grace a record is mourned only when a
            # RECORDED pid is verifiably gone — a roster entry that has
            # not booted yet (pid 0) is not yet a death.
            return
        if rec.pid and not _pid_dead(rec.pid) and st is None:
            return  # process alive, no heartbeat yet (cold store?)
        # Dead: mourn through the CAS. Exactly one steward wins the
        # incarnation bump — the exactly-once census write.
        uptime = max(0.0, now - rec.updated_at)
        backoff = (0.0 if uptime >= self.stable_s else rec.backoff_s)
        backoff = min(max(backoff * 2, self.backoff0_s),
                      self.backoff_cap_s)
        code = self._exit_code_of(rec.pid)
        codes = dict(rec.exit_codes)
        codes[code] = codes.get(code, 0) + 1
        if not self._cas(rec, state="respawning",
                         incarnation=rec.incarnation + 1,
                         deaths=rec.deaths + 1, exit_codes=codes,
                         backoff_s=backoff, updated_at=now,
                         steward=self.rid,
                         steward_epoch=self.election.epoch):
            return  # a peer steward mourned first: exactly-once held
        self.counters["mourns"] += 1
        jnote("steward.mourn", replica=self.rid, target=rec.replica,
              incarnation=rec.incarnation, exit_code=code,
              uptime_s=round(uptime, 3), backoff_s=round(backoff, 3))
        log.warning("steward %s: mourned %s (exit %s, up %.1fs); "
                    "respawn in %.2fs", self.rid, rec.replica, code,
                    uptime, backoff)
        if backoff <= 0.0:
            self._spawn(rec, now)

    def _spawn(self, rec, now: float) -> None:
        """Spawn-claim the respawn: CAS the record to ``spawned`` FIRST
        (the arbiter — exactly one steward per incarnation gets to
        fork), then fork the replacement ``start_new_session`` so it
        outlives this steward. A failed fork CASes back to
        ``respawning`` with the backoff bumped."""
        if rec.state == "respawning" and now - rec.updated_at \
                < rec.backoff_s and rec.steward == self.rid:
            return  # our own backoff window is still running
        if not self._cas(rec, state="spawned",
                         respawns=rec.respawns + 1, updated_at=now,
                         steward=self.rid,
                         steward_epoch=self.election.epoch):
            return  # a peer claimed this spawn
        try:
            pid = self._spawn_fn(rec.replica, rec.incarnation)
        except Exception as e:
            self.counters["spawn_failures"] += 1
            backoff = min(max(rec.backoff_s * 2, self.backoff0_s),
                          self.backoff_cap_s)
            self._cas(rec, state="respawning", backoff_s=backoff,
                      updated_at=self._clock())
            jnote("steward.spawn_failed", replica=self.rid,
                  target=rec.replica, reason=str(e)[:120])
            return
        self.counters["respawns"] += 1
        self._cas(rec, pid=pid, updated_at=self._clock())
        jnote("steward.respawn", replica=self.rid, target=rec.replica,
              incarnation=rec.incarnation, pid=pid)
        log.info("steward %s: respawned %s (incarnation %d, pid %d)",
                 self.rid, rec.replica, rec.incarnation, pid)

    def _spawn_process(self, target_rid: str, incarnation: int) -> int:
        """Fork a replacement replica with this process's own election
        env, re-keyed to the target rid/incarnation. ``start_new_
        session``: the child must survive THIS steward's death — it
        answers to the store, not to its spawner. The steward's own
        environment already carries the fleet's device setting (and a
        CPU fleet's hidden devices)."""
        env = dict(os.environ)
        env[_REPLICA_ENV] = target_rid
        env[_INCARNATION_ENV] = str(incarnation)
        env[_DETACHED_ENV] = "1"
        env.setdefault(FLEET_ELECT_ENV, "1")
        popen = subprocess.Popen(
            [sys.executable, "-m", REPLICA_MODULE, "--replica"],
            stdin=subprocess.DEVNULL, stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL, start_new_session=True, env=env)
        self._children[popen.pid] = popen
        return popen.pid

    def _reap_children(self) -> None:
        """Poll our own forks so exited children do not zombie (their
        exit codes feed the census when we later mourn them)."""
        for pid, popen in list(self._children.items()):
            if popen.poll() is not None:
                self._children[pid] = popen  # code cached by poll()

    def _exit_code_of(self, pid: int) -> str:
        """The dead replica's exit code when it was OUR child (reaped),
        else ``"?"`` — a detached peer's code is unknowable without a
        parent, which is exactly why the census records the DEATH
        (heartbeat + pid truth) rather than trusting wait-status
        plumbing that no longer exists."""
        popen = self._children.get(pid)
        if popen is not None:
            rc = popen.poll()
            if rc is not None:
                return str(rc)
        return "?"

    def _cas(self, rec, **fields) -> bool:
        for k, v in fields.items():
            setattr(rec, k, v)
        try:
            out = self.store.update(rec, check_version=True)
            # A remote store returns the stored revision and leaves
            # ``rec`` as sent: carry its version, so that a second CAS on
            # ``rec`` (the spawn's pid after its claim) does not conflict
            # with our own first.
            rec.metadata.resource_version = out.metadata.resource_version
            return True
        except (ConflictError, NotFoundError):
            self.counters["census_conflicts"] += 1
            return False

    def metrics(self) -> Dict[str, float]:
        out = {f"steward_{k}": float(v)
               for k, v in self.counters.items()}
        for k, v in self.election.counters.items():
            out[f"steward_{k}"] = float(v)
        out["steward_is_steward"] = 1.0 if self.election.is_steward \
            else 0.0
        out["steward_epoch"] = float(self.election.epoch)
        if self.rebalancer is not None:
            for k, v in self.rebalancer.counters.items():
                out[f"rebalance_{k}"] = float(v)
        return out


def _pid_dead(pid: int) -> bool:
    """Is the pid gone from this host? (0/negative = never recorded —
    treated as dead so a roster entry that never booted gets spawned.)
    A ZOMBIE counts as dead: a killed replica whose (unrelated) spawner
    has not reaped it still answers signal 0, but it runs nothing — and
    a steward that is not its parent can never reap it."""
    if pid <= 0:
        return True
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return True
    except OSError:
        return False  # EPERM etc.: something lives there
    try:
        with open(f"/proc/{pid}/stat", "rb") as f:
            state = f.read().rsplit(b") ", 1)[1].split(b" ", 1)[0]
        return state == b"Z"
    except Exception:
        return False  # no /proc: trust the signal probe


# ---------------------------------------------------------------------------
# Detached bootstrap + observer
# ---------------------------------------------------------------------------


def ensure_roster(store, replicas: List[str], *,
                  clock: Callable[[], float] = time.time) -> None:
    """Create the Incarnation roster (idempotent): one record per
    replica, ``alive`` at incarnation 0 — the census ledger every
    steward reads and CAS-advances."""
    now = clock()
    for rid in replicas:
        rec = obj.Incarnation(
            metadata=obj.ObjectMeta(name=incarnation_name(rid)),
            replica=rid, incarnation=0, state="alive", updated_at=now)
        try:
            store.create(rec)
        except AlreadyExistsError:
            pass


def spawn_replica(rid: str, incarnation: int, apiserver: str, *,
                  n_shards: int, fleet_n: int, ttl_s: float,
                  spec: Optional[dict] = None, token: Optional[str] = None,
                  tick_s: Optional[float] = None, prewarm: bool = False,
                  extra_env: Optional[Dict[str, str]] = None
                  ) -> subprocess.Popen:
    """Spawn ONE detached election replica: no stdin tether, its own
    session — it answers to the store and SIGTERM only. Shared by the
    launcher and the tests."""
    env = dict(os.environ)
    env.update(extra_env or {})
    env[_REPLICA_ENV] = rid
    env[_APISERVER_ENV] = apiserver
    env[_INCARNATION_ENV] = str(incarnation)
    env[_CONFIG_ENV] = json.dumps(spec or {})
    env[_PREWARM_ENV] = "1" if prewarm else "0"
    env[SHARDS_ENV] = str(n_shards)
    env[LEASE_TTL_ENV] = str(ttl_s)
    env[_FLEET_N_ENV] = str(fleet_n)
    env[FLEET_ELECT_ENV] = "1"
    env[_DETACHED_ENV] = "1"
    if tick_s is not None:
        env[_TICK_ENV] = str(tick_s)
    if token:
        env[_TOKEN_ENV] = token
    env.setdefault("MINISCHED_JOURNAL", "1")
    child_device_env(env, str((spec or {}).get("config", {}).get(
        "platform", "")))
    env.pop("MINISCHED_FLEET", None)
    env.pop("MINISCHED_FLEET_PROC", None)
    return subprocess.Popen(
        [sys.executable, "-m", REPLICA_MODULE, "--replica"],
        stdin=subprocess.DEVNULL, stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL, start_new_session=True, env=env)


def launch_fleet(store, apiserver: str, n: int, **kw) -> List[int]:
    """Bootstrap a self-governing fleet: roster + N detached replicas.
    Returns the pids. The CALLER may exit immediately — nothing tethers
    the replicas to it (the acceptance shape: the parent absent). On a
    CUDA spec the kernels are built first, once (a failed build raises
    and nothing is spawned)."""
    prebuild_kernels((kw.get("spec") or {}).get("config", {}))
    rids = [f"p{i}" for i in range(n)]
    ensure_roster(store, rids)
    pids = []
    for rid in rids:
        popen = spawn_replica(rid, 0, apiserver, fleet_n=n, **kw)
        pids.append(popen.pid)
    jnote("steward.fleet_launch", replicas=n, pids=len(pids))
    return pids


class ElectFleet:
    """Store-truth observer (and test janitor) over a detached election
    fleet. Holds NO authority — every view re-derives from the store,
    and killing this object's process leaves the fleet running. The
    janitor half (``kill``/``shutdown``) drives pids read from
    ReplicaStatus/Incarnation records, which is all any outside agent
    has."""

    def __init__(self, store, apiserver: str, *, replicas: int,
                 n_shards: Optional[int] = None,
                 ttl_s: Optional[float] = None,
                 tick_s: Optional[float] = None,
                 spec: Optional[dict] = None,
                 token: Optional[str] = None,
                 prewarm: bool = False,
                 extra_env: Optional[Dict[str, str]] = None):
        self.store = store
        self.apiserver = apiserver
        self.n_replicas = int(replicas)
        self.n_shards = int(n_shards) if n_shards else self.n_replicas
        self.ttl_s = (float(ttl_s) if ttl_s is not None
                      else lease_ttl_from_env())
        self.tick_s = (float(tick_s) if tick_s is not None
                       else max(0.05, self.ttl_s / 4.0))
        self.spec = dict(spec or {})
        self.token = token
        self.prewarm = prewarm
        self.extra_env = dict(extra_env or {})
        self._spawned: List[subprocess.Popen] = []

    def launch(self) -> List[int]:
        """Spawn the fleet (kernels built first on a CUDA spec); the
        caller reaps it with :meth:`shutdown` in a ``finally``."""
        prebuild_kernels(self.spec.get("config", {}))
        rids = [f"p{i}" for i in range(self.n_replicas)]
        ensure_roster(self.store, rids)
        for rid in rids:
            self._spawned.append(spawn_replica(
                rid, 0, self.apiserver, n_shards=self.n_shards,
                fleet_n=self.n_replicas, ttl_s=self.ttl_s,
                spec=self.spec, token=self.token, tick_s=self.tick_s,
                prewarm=self.prewarm, extra_env=self.extra_env))
        return [p.pid for p in self._spawned]

    # ---- store-truth views ----------------------------------------------

    def census(self) -> Dict[str, object]:
        horizon = time.time() - (3 * self.tick_s + self.ttl_s)
        out: Dict[str, object] = {}
        try:
            statuses = self.store.list("ReplicaStatus")
        except Exception:
            return out
        for st in statuses:
            if st.ready and st.renewed_at >= horizon:
                out[st.key.replace("replica-", "", 1)] = st
        return out

    def incarnations(self) -> Dict[str, object]:
        try:
            return {r.replica: r
                    for r in self.store.list("Incarnation")}
        except Exception:
            return {}

    def steward(self) -> str:
        try:
            lease = self.store.get("Lease", steward_name())
        except Exception:
            return ""
        return "" if lease.expired(time.monotonic()) else lease.holder

    def steward_epoch(self) -> int:
        try:
            return self.store.get("Lease", steward_name()).epoch
        except Exception:
            return 0

    def lease_holders(self) -> Dict[int, str]:
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

    def pids(self) -> Dict[str, int]:
        """rid → live-ish pid, from the freshest store record."""
        out: Dict[str, int] = {}
        for rid, st in self.census().items():
            out[rid] = int(st.pid)
        for rid, rec in self.incarnations().items():
            out.setdefault(rid, int(rec.pid))
        return out

    # ---- waiting ---------------------------------------------------------

    def wait_ready(self, timeout: float = 120.0) -> bool:
        """Every replica heartbeating ready=True in the store."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if len(self.census()) >= self.n_replicas:
                return True
            time.sleep(0.05)
        return False

    def wait_steward(self, timeout: float = 30.0,
                     exclude: str = "") -> str:
        """Wait for a live steward (optionally one that is NOT
        ``exclude`` — the takeover wait). Returns the rid or ""."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            s = self.steward()
            if s and s != exclude:
                return s
            time.sleep(0.02)
        return ""

    def wait_converged(self, timeout: float = 60.0) -> bool:
        """Every shard lease held unexpired by a fresh-heartbeat
        replica."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            live = set(self.census())
            holders = self.lease_holders()
            if (len(holders) == self.n_shards
                    and set(holders.values()) <= live):
                return True
            time.sleep(0.05)
        return False

    # ---- janitor ---------------------------------------------------------

    def kill(self, rid: str) -> bool:
        """SIGKILL one replica by store-truth pid (the crash model)."""
        pid = self.pids().get(rid, 0)
        if pid <= 0:
            return False
        try:
            os.kill(pid, signal.SIGKILL)
        except OSError:
            return False
        jnote("steward.kill", replica=rid, pid=pid)
        return True

    def kill_steward(self) -> str:
        """SIGKILL the current steward. Returns its rid ("" if none)."""
        s = self.steward()
        if s and self.kill(s):
            return s
        return ""

    def shutdown(self, timeout: float = 10.0) -> None:
        """Terminate every replica the store knows about (SIGTERM, then
        SIGKILL stragglers) and reap our own direct forks."""
        pids = set(self.pids().values())
        pids.update(p.pid for p in self._spawned
                    if p.poll() is None)
        for pid in pids:
            if pid <= 0:
                continue
            try:
                os.kill(pid, signal.SIGTERM)
            except OSError:
                pass
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if all(_pid_dead(pid) for pid in pids if pid > 0):
                break
            time.sleep(0.05)
        for pid in pids:
            if pid > 0 and not _pid_dead(pid):
                try:
                    os.kill(pid, signal.SIGKILL)
                except OSError:
                    pass
        for p in self._spawned:
            try:
                p.wait(timeout=5)
            except Exception:
                pass


# ---------------------------------------------------------------------------
# Entrypoint: the exiting launcher (the parent that is ABSENT)
# ---------------------------------------------------------------------------


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="detached self-governing fleet launcher: create "
                    "the Incarnation roster, spawn N election replicas "
                    "with no tether, print their pids, exit")
    ap.add_argument("--launch", action="store_true")
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--apiserver", default=os.environ.get(
        _APISERVER_ENV, ""))
    ap.add_argument("--shards", type=int, default=0)
    ap.add_argument("--ttl", type=float, default=lease_ttl_from_env())
    args = ap.parse_args(argv)
    if not args.launch:
        ap.error("this module launches detached fleets (--launch); "
                 "the replica side is fleet.procfleet --replica")
    if not args.apiserver:
        ap.error(f"--apiserver (or {_APISERVER_ENV}) is required")
    from ..apiserver.client import RemoteStore

    store = RemoteStore(args.apiserver,
                        token=os.environ.get(_TOKEN_ENV) or None)
    n_shards = args.shards or shards_from_env(args.replicas)
    spec = json.loads(os.environ.get(_CONFIG_ENV, "") or "{}")
    pids = launch_fleet(store, args.apiserver, args.replicas,
                        n_shards=n_shards, ttl_s=args.ttl, spec=spec,
                        token=os.environ.get(_TOKEN_ENV) or None,
                        prewarm=(os.environ.get(_PREWARM_ENV, "0")
                                 not in ("", "0")))
    print(" ".join(str(p) for p in pids), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

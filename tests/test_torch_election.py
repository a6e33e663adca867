"""The port's self-governing fleet (fleet/election.py) against the JAX
package's.

Mirrors tests/test_election.py on the port. The UNIT layer feeds one
store sequence and one clock to both packages and asserts the JAX test's
claims on each, then equal results: the steward CAS race (any arrival
order, exactly one crown), TTL-expiry succession with an epoch bump, the
graceful resign, the exactly-once census ledger (mourn and spawn-claim
CASes; a successor neither re-mourns a recorded death nor double-spawns
a claimed incarnation; orphaned incarnations adopted WITHOUT a bump),
the burn-signal rebalance trigger (sustained burn migrates one shard,
oscillating burn none, scribbled signals clamped), the steward-epoch
directive fence, the RemoteStore outage/reattach arc, and the journal
of a succession as tools/postmortem.py narrates it: equal epochs,
spawns, census records, directives, journal events and counters.

The INTEGRATION layer spawns REAL detached replica processes of the
port on the CPU (``platform="cpu"``): the JAX suite's three ``slow``
tests, mirrored with the same mark, and one unmarked steward kill (3
replicas, one respawn) under its own deadline. Every test that spawns
reaps every pid it saw in a ``finally``.
"""
import os
import time
from types import SimpleNamespace

import pytest

from minisched_tpu.apiserver import client as jclient
from minisched_tpu.apiserver import server as jserver
from minisched_tpu.fleet import election as jelection
from minisched_tpu.fleet import lease as jlease
from minisched_tpu.fleet import procfleet as jprocfleet
from minisched_tpu.obs import journal as jjournal
from minisched_tpu.state import objects as JO
from minisched_tpu.state.store import ClusterStore as JStore
from minisched_tpu_torch.apiserver import client as tclient
from minisched_tpu_torch.apiserver import server as tserver
from minisched_tpu_torch.apiserver.client import RemoteStore
from minisched_tpu_torch.apiserver.server import APIServer
from minisched_tpu_torch.fleet import election as telection
from minisched_tpu_torch.fleet import lease as tlease
from minisched_tpu_torch.fleet import procfleet as tprocfleet
from minisched_tpu_torch.fleet.election import ElectFleet, _pid_dead
from minisched_tpu_torch.fleet.shardmap import lease_name, steward_name
from minisched_tpu_torch.obs import journal as tjournal
from minisched_tpu_torch.state import objects as obj
from minisched_tpu_torch.state.store import ClusterStore
from torch_obs_parity import disarm_all

JAX = SimpleNamespace(name="jax", el=jelection, pf=jprocfleet, lease=jlease,
                      O=JO, Store=JStore, journal=jjournal,
                      APIServer=jserver.APIServer,
                      RemoteStore=jclient.RemoteStore)
PORT = SimpleNamespace(name="port", el=telection, pf=tprocfleet,
                       lease=tlease, O=obj, Store=ClusterStore,
                       journal=tjournal, APIServer=tserver.APIServer,
                       RemoteStore=tclient.RemoteStore)

#: The journal fields that record when and where, not what.
_CLOCK_FIELDS = ("seq", "t", "unix", "thread")


@pytest.fixture(autouse=True)
def _disarmed():
    disarm_all()
    yield
    disarm_all()


def _both(scenario):
    """Run ``scenario(pkg)`` on both packages; their results must be
    equal. Returns the port's."""
    got = {pkg.name: scenario(pkg) for pkg in (JAX, PORT)}
    assert got["port"] == got["jax"]
    return got["port"]


def _events(pkg):
    return [{k: v for k, v in e.items() if k not in _CLOCK_FIELDS}
            for e in pkg.journal.JOURNAL.to_doc()["entries"]]


def _status(O, rid, queue_depth=0, overload_level=0, burning="",
            ready=True, renewed_at=None):
    return O.ReplicaStatus(
        metadata=O.ObjectMeta(name=f"replica-{rid}"),
        queue_depth=queue_depth, overload_level=overload_level,
        burning=burning, ready=ready,
        renewed_at=time.time() if renewed_at is None else renewed_at)


def _pod(name, cpu=100, priority=0):
    return obj.Pod(metadata=obj.ObjectMeta(name=name, namespace="default"),
                   spec=obj.PodSpec(requests={"cpu": cpu},
                                    priority=priority))


def _record(rec):
    return (rec.replica, rec.state, rec.incarnation, rec.deaths,
            rec.respawns, dict(rec.exit_codes), rec.backoff_s, rec.pid,
            rec.steward, rec.steward_epoch, rec.updated_at)


def _lease(store):
    lease = store.get("Lease", steward_name())
    return (lease.holder, lease.epoch, lease.shard)


class _Clock:
    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t


# ---- steward election (unit) ---------------------------------------------


def test_steward_cas_race_exactly_one_winner():
    """However the candidates arrive, the store CAS crowns exactly one
    steward per epoch; the rest observe a live lease and stand down."""
    def run(pkg):
        store = pkg.Store()
        clock = _Clock()
        cands = [pkg.el.StewardElection(store, f"p{i}", ttl_s=5.0,
                                        clock=clock) for i in range(5)]
        out = []
        for order in ([0, 1, 2, 3, 4], [4, 3, 2, 1, 0], [2, 0, 4, 1, 3]):
            results = {i: cands[i].tick() for i in order}
            stewards = [i for i, won in results.items() if won]
            assert stewards == [order[0]]  # first CAS wins
            lease = store.get("Lease", steward_name())
            assert lease.holder == f"p{order[0]}" and lease.shard < 0
            out.append((results, _lease(store)))
            cands[order[0]].resign()
            for c in cands:
                c.drop()
        return out, [c.counters for c in cands]

    _both(run)


def test_steward_expiry_succession_bumps_epoch():
    """A dead steward's lease lapses after one TTL; the claiming peer
    bumps the epoch and journals the handoff."""
    def run(pkg):
        pkg.journal.configure("1")
        try:
            store = pkg.Store()
            clock = _Clock()
            a = pkg.el.StewardElection(store, "pa", ttl_s=1.0, clock=clock)
            b = pkg.el.StewardElection(store, "pb", ttl_s=1.0, clock=clock)
            assert a.tick() and a.epoch == 1
            assert not b.tick()  # live steward reigns
            clock.t += 0.5
            assert a.tick() and a.epoch == 1  # renewal, same epoch
            clock.t += 1.1  # pa dies (stops renewing); lease lapses
            assert b.tick() and b.is_steward and b.epoch == 2
            assert b.counters["takeovers"] == 1
            assert not a.tick() and not a.is_steward
            assert a.counters["losses"] == 1
            events = _events(pkg)
            hand = next(e for e in events
                        if e["kind"] == "steward.handoff")
            assert (hand["replica"], hand["frm"], hand["epoch"]) \
                == ("pb", "pa", 2)
            return events, a.counters, b.counters, _lease(store)
        finally:
            pkg.journal.configure("")

    _both(run)


def test_steward_resign_hands_over_without_ttl_wait():
    def run(pkg):
        store = pkg.Store()
        clock = _Clock()
        a = pkg.el.StewardElection(store, "pa", ttl_s=30.0, clock=clock)
        b = pkg.el.StewardElection(store, "pb", ttl_s=30.0, clock=clock)
        assert a.tick()
        assert a.resign() and not a.is_steward
        assert b.tick() and b.epoch == 2  # no clock advance needed
        return _lease(store), a.counters, b.counters

    _both(run)


# ---- steward duties: exactly-once census ---------------------------------


def _duties(pkg, store, rid, clock, spawns, *, ttl=1.0, tick=0.25, **kw):
    elect = pkg.el.StewardElection(store, rid, ttl_s=ttl, clock=clock)

    def spawn_fn(target, incarnation):
        spawns.append((rid, target, incarnation))
        return 4000 + len(spawns)

    return elect, pkg.el.StewardDuties(store, rid, elect, tick_s=tick,
                                       ttl_s=ttl, spawn_fn=spawn_fn,
                                       clock=clock, **kw)


def _heartbeat(pkg, store, rid, clock, incarnation=0):
    """Create-or-refresh a ReplicaStatus at the fake clock's now."""
    name = f"replica-{rid}"
    try:
        st = store.get("ReplicaStatus", name)
    except Exception:
        store.create(_status(pkg.O, rid, renewed_at=clock.t))
        st = store.get("ReplicaStatus", name)
    st.renewed_at = clock.t
    st.incarnation = incarnation
    store.update(st)


def test_duties_mourn_and_respawn_exactly_once():
    """A dead replica is mourned once (deaths+1, incarnation+1) and
    respawned once after the backoff window, each transition a CAS."""
    def run(pkg):
        store = pkg.Store()
        clock = _Clock()
        spawns = []
        pkg.el.ensure_roster(store, ["p0", "p1"], clock=clock)
        elect, duties = _duties(pkg, store, "p0", clock, spawns,
                                stable_s=5.0, grace_s=5.0)
        assert elect.tick()
        _heartbeat(pkg, store, "p0", clock)
        _heartbeat(pkg, store, "p1", clock)
        duties.tick(2)
        assert not spawns  # everyone fresh
        clock.t += 10.0  # p1 stops heartbeating (uptime >= stable_s)
        _heartbeat(pkg, store, "p0", clock)
        duties.tick(2)
        rec = store.get("Incarnation", "incarnation-p1")
        assert (rec.state, rec.deaths, rec.incarnation) \
            == ("respawning", 1, 1)
        assert not spawns  # spawn waits out the backoff window
        trail = [_record(rec)]
        clock.t += rec.backoff_s
        _heartbeat(pkg, store, "p0", clock)
        elect.tick()
        duties.tick(2)
        assert spawns == [("p0", "p1", 1)]
        rec = store.get("Incarnation", "incarnation-p1")
        assert rec.respawns == 1 and rec.state == "spawned"
        trail.append(_record(rec))
        for _ in range(5):  # within the grace: never a double spawn
            clock.t += 0.5
            _heartbeat(pkg, store, "p0", clock)
            elect.tick()
            duties.tick(2)
        assert spawns == [("p0", "p1", 1)]
        _heartbeat(pkg, store, "p1", clock, incarnation=1)
        duties.tick(2)
        rec = store.get("Incarnation", "incarnation-p1")
        assert rec.state == "alive"
        trail.append(_record(rec))
        return spawns, trail, duties.metrics()

    _both(run)


def test_own_booting_spawn_is_not_adopted_as_an_orphan():
    """A steward's own spawn still running past the grace (a replica on
    a card may boot longer: its CUDA start, sync and prewarm) is in
    flight, not an orphan: no second spawn while the child lives, one
    re-adoption once it is gone. The JAX package's steward re-spawns at
    the grace whatever its child does (two processes for one replica),
    so this case is the port's alone."""
    _own_booting_spawn(remote=False)


def test_own_booting_spawn_over_the_wire_is_not_adopted():
    """The same over a RemoteStore, as a replica process runs the
    duties: the spawn's two CASes on one record (the claim, then the
    child's pid) must both land, or the steward cannot tell its own
    booting child and spawns again."""
    _own_booting_spawn(remote=True)


def _own_booting_spawn(remote):
    import subprocess
    import sys

    srv = APIServer(ClusterStore()).start() if remote else None
    store = RemoteStore(srv.address) if remote else ClusterStore()
    clock = _Clock()
    spawns = []
    telection.ensure_roster(store, ["p0", "p1"], clock=clock)
    elect, duties = _duties(PORT, store, "p0", clock, spawns,
                            stable_s=5.0, grace_s=5.0)
    child = subprocess.Popen([sys.executable, "-c",
                              "import time; time.sleep(60)"])
    try:
        def spawn_fn(target, incarnation):
            spawns.append((target, incarnation))
            if len(spawns) == 1:
                duties._children[child.pid] = child
                return child.pid
            return 4000 + len(spawns)

        duties._spawn_fn = spawn_fn
        assert elect.tick()
        _heartbeat(PORT, store, "p0", clock)
        _heartbeat(PORT, store, "p1", clock)
        clock.t += 10.0  # p1 stops heartbeating
        _heartbeat(PORT, store, "p0", clock)
        duties.tick(2)
        clock.t += store.get("Incarnation", "incarnation-p1").backoff_s
        _heartbeat(PORT, store, "p0", clock)
        elect.tick()
        duties.tick(2)
        assert spawns == [("p1", 1)]
        assert store.get("Incarnation", "incarnation-p1").pid == child.pid
        for _ in range(4):  # well past the grace, the child booting
            clock.t += 5.0
            _heartbeat(PORT, store, "p0", clock)
            elect.tick()
            duties.tick(2)
        assert spawns == [("p1", 1)]
        assert duties.counters["orphans_adopted"] == 0
        child.kill()
        child.wait(timeout=10)
        clock.t += 0.5
        _heartbeat(PORT, store, "p0", clock)
        elect.tick()
        duties.tick(2)
        assert spawns == [("p1", 1), ("p1", 1)]  # re-adopted, no bump
        rec = store.get("Incarnation", "incarnation-p1")
        assert (rec.deaths, rec.incarnation, rec.respawns) == (1, 1, 2)
        assert duties.counters["orphans_adopted"] == 1
    finally:
        child.kill()
        child.wait(timeout=10)
        if srv is not None:
            srv.shutdown()


def test_own_hung_boot_is_killed_then_adopted_once():
    """A steward's own spawn that neither heartbeats nor exits (a boot
    hung in its CUDA start, its sync or its prewarm) is left alone until
    the boot deadline, then SIGKILLed, reaped and re-adopted once: the
    replica comes back, with one process for it."""
    import subprocess
    import sys

    store = ClusterStore()
    clock = _Clock()
    spawns = []
    telection.ensure_roster(store, ["p0", "p1"], clock=clock)
    elect, duties = _duties(PORT, store, "p0", clock, spawns,
                            stable_s=5.0, grace_s=5.0)
    assert duties.boot_s == 30.0
    child = subprocess.Popen([sys.executable, "-c",
                              "import time; time.sleep(600)"])
    try:
        def spawn_fn(target, incarnation):
            spawns.append((target, incarnation))
            if len(spawns) == 1:
                duties._children[child.pid] = child
                return child.pid
            return 4000 + len(spawns)

        duties._spawn_fn = spawn_fn
        assert elect.tick()
        _heartbeat(PORT, store, "p0", clock)
        _heartbeat(PORT, store, "p1", clock)
        clock.t += 10.0  # p1 stops heartbeating
        _heartbeat(PORT, store, "p0", clock)
        duties.tick(2)
        clock.t += store.get("Incarnation", "incarnation-p1").backoff_s
        _heartbeat(PORT, store, "p0", clock)
        elect.tick()
        duties.tick(2)
        assert spawns == [("p1", 1)]
        for _ in range(6):  # past the grace, within the boot deadline
            clock.t += 4.5
            _heartbeat(PORT, store, "p0", clock)
            elect.tick()
            duties.tick(2)
        assert spawns == [("p1", 1)] and child.poll() is None
        clock.t += 4.5  # 31.5 s after the spawn: a hung boot
        _heartbeat(PORT, store, "p0", clock)
        elect.tick()
        duties.tick(2)
        assert child.poll() is not None  # killed and reaped
        assert spawns == [("p1", 1), ("p1", 1)]  # re-adopted, no bump
        rec = store.get("Incarnation", "incarnation-p1")
        assert (rec.deaths, rec.incarnation, rec.respawns) == (1, 1, 2)
        assert rec.pid == 4002
        assert duties.counters["orphans_adopted"] == 1
        for _ in range(4):  # the new spawn booting: no third spawn
            clock.t += 1.0
            _heartbeat(PORT, store, "p0", clock)
            elect.tick()
            duties.tick(2)
        assert len(spawns) == 2
    finally:
        child.kill()
        child.wait(timeout=10)


def test_steward_handoff_adopts_ledger_exactly_once():
    """Steward A mourns p2 then dies before spawning; successor B adopts
    the ledger: the death is NOT re-censused and the orphaned
    incarnation is respawned WITHOUT a bump."""
    def run(pkg):
        store = pkg.Store()
        clock = _Clock()
        spawns = []
        pkg.el.ensure_roster(store, ["pa", "pb", "p2"], clock=clock)
        ea, da = _duties(pkg, store, "pa", clock, spawns,
                         stable_s=1000.0, grace_s=3.0)
        eb, db = _duties(pkg, store, "pb", clock, spawns, grace_s=3.0)
        assert ea.tick()
        store.create(_status(pkg.O, "p2", renewed_at=clock.t - 50.0))
        clock.t += 3.1  # p2's silence outlives the boot grace
        _heartbeat(pkg, store, "pa", clock)
        _heartbeat(pkg, store, "pb", clock)
        da.tick(3)
        rec = store.get("Incarnation", "incarnation-p2")
        assert rec.state == "respawning" and rec.deaths == 1
        assert rec.backoff_s > 0 and not spawns
        trail = [_record(rec)]
        clock.t += 1.1  # pa dies; pb succeeds past the TTL
        _heartbeat(pkg, store, "pb", clock)
        assert eb.tick() and eb.epoch == 2
        db.tick(3)  # in-flight grace: B waits, no re-mourn
        rec = store.get("Incarnation", "incarnation-p2")
        assert rec.deaths == 1 and rec.incarnation == 1 and not spawns
        clock.t += 3.1  # past grace: the incarnation is orphaned
        _heartbeat(pkg, store, "pb", clock)
        eb.tick()
        db.tick(3)
        assert spawns == [("pb", "p2", 1)]
        rec = store.get("Incarnation", "incarnation-p2")
        assert (rec.deaths, rec.incarnation, rec.respawns) == (1, 1, 1)
        assert db.counters["orphans_adopted"] == 1
        trail.append(_record(rec))
        return spawns, trail, da.metrics(), db.metrics()

    _both(run)


def test_two_stewards_cannot_double_census():
    """Even with a zombie ex-steward still ticking, the incarnation CAS
    lets exactly one mourn land."""
    def run(pkg):
        store = pkg.Store()
        clock = _Clock()
        spawns = []
        pkg.el.ensure_roster(store, ["pa", "pb", "p2"], clock=clock)
        ea, da = _duties(pkg, store, "pa", clock, spawns,
                         stable_s=5.0, grace_s=3.0)
        eb, db = _duties(pkg, store, "pb", clock, spawns,
                         stable_s=5.0, grace_s=3.0)
        assert ea.tick()
        store.create(_status(pkg.O, "p2", renewed_at=clock.t - 50.0))
        clock.t += 3.2
        _heartbeat(pkg, store, "pa", clock)
        _heartbeat(pkg, store, "pb", clock)
        assert eb.tick()
        da._was_steward = True
        db.tick(3)
        da.tick(3)  # the zombie's mourn CAS must lose
        rec = store.get("Incarnation", "incarnation-p2")
        assert rec.deaths == 1 and rec.incarnation == 1
        assert da.counters["mourns"] + db.counters["mourns"] == 1
        return spawns, _record(rec), da.counters, db.counters

    _both(run)


# ---- burn-signal rebalance (unit) ----------------------------------------


def _burn_statuses(O, donor_level):
    return {
        "p0": _status(O, "p0", overload_level=donor_level,
                      burning="slo-p99" if donor_level else ""),
        "p1": _status(O, "p1"),
        "p2": _status(O, "p2"),
    }


def test_sustained_burn_migrates_exactly_one_shard():
    """One replica burning while peers idle nominates ONE ShardMove
    after the hold streak, stamped with the steward epoch; the cooldown
    then holds further moves."""
    def run(pkg):
        store = pkg.Store()
        spec = pkg.pf.RebalanceSpec(skew=1e9, hold=3, cooldown=6,
                                    max_moves=8)
        reb = pkg.pf.ShardRebalancer(store, spec, clock=_Clock())
        reb.steward_epoch = 7
        holders = {0: "p0", 1: "p0", 2: "p1", 3: "p2"}
        moves = []
        for _ in range(8):
            name = reb.observe(_burn_statuses(pkg.O, 2), holders)
            if name:
                mv = store.get("ShardMove", name)
                moves.append((mv.key, mv.shard, mv.donor, mv.recipient,
                              mv.state, mv.nominated_at, mv.steward_epoch))
        assert len(moves) == 1  # skew bar unreachable: pure burn
        assert moves[0][2] == "p0" and moves[0][6] == 7
        assert reb.counters["burn_nominations"] == 1
        assert reb.counters["moves_nominated"] == 1
        return moves, reb.counters

    _both(run)


def test_oscillating_burn_migrates_zero_shards():
    """Burn that hops between replicas each window never survives the
    hold streak: zero moves, structurally."""
    def run(pkg):
        store = pkg.Store()
        spec = pkg.pf.RebalanceSpec(skew=1e9, hold=3, cooldown=6,
                                    max_moves=8)
        reb = pkg.pf.ShardRebalancer(store, spec)
        holders = {0: "p0", 1: "p0", 2: "p1", 3: "p2"}
        for i in range(12):
            burner = f"p{i % 2}"
            sts = {r: _status(pkg.O, r,
                              overload_level=(2 if r == burner else 0),
                              burning=("slo" if r == burner else ""))
                   for r in ("p0", "p1", "p2")}
            assert reb.observe(sts, holders) is None
        assert reb.counters["moves_nominated"] == 0
        assert reb.counters["streak_resets"] >= 4
        return reb.counters

    _both(run)


def test_scribbled_burn_signal_is_clamped_and_ignored():
    """An implausible burn level (the election:corrupt scribble) is
    zeroed and counted: it can never push a move through."""
    def run(pkg):
        store = pkg.Store()
        spec = pkg.pf.RebalanceSpec(skew=1e9, hold=2, cooldown=4,
                                    max_moves=8)
        reb = pkg.pf.ShardRebalancer(store, spec)
        holders = {0: "p0", 1: "p1", 2: "p2"}
        for _ in range(6):
            sts = _burn_statuses(pkg.O, 0)
            sts["p0"].overload_level = 0x7FFF  # scribbled
            assert reb.observe(sts, holders) is None
        assert reb.counters["burn_scribbles_ignored"] == 6
        assert reb.counters["moves_nominated"] == 0
        return reb.counters

    _both(run)


def test_directive_fence_rejects_stale_steward_epoch():
    """A directive stamped by a deposed steward (epoch below the
    store-truth floor) is skipped; at-floor and unfenced directives
    pass."""
    def run(pkg):
        pkg.journal.configure("1")
        try:
            store = pkg.Store()
            now = time.time()
            for shard, epoch in ((0, 3), (1, 5), (2, 0)):
                store.create(pkg.O.ShardMove(
                    metadata=pkg.O.ObjectMeta(name=f"move-{shard}"),
                    shard=shard, donor="px", recipient="me",
                    state="released", nominated_at=now,
                    steward_epoch=epoch))

            class _Eng:
                calls = []

                @property
                def shard_view(self):
                    return (8, frozenset(), 0)

                def release_shards(self, shards, *, epoch=0, reason=""):
                    self.calls.append(("release", sorted(shards)))

                def adopt_shards(self, shards, *, epoch=0, reason=""):
                    self.calls.append(("adopt", sorted(shards)))
                    return 0

            mgr = pkg.lease.LeaseManager(store, "me", ttl_s=5.0)
            eng = _Eng()
            actions = pkg.pf.handle_move_directives(
                store, "me", mgr, eng, steward_epoch_floor=5)
            assert sorted(actions) == ["adopted:1", "adopted:2"]
            assert store.get("ShardMove", "move-0")  # fenced: untouched
            assert not mgr.holds(0) and mgr.holds(1) and mgr.holds(2)
            fenced = [e for e in _events(pkg)
                      if e["kind"] == "proc.rebalance_fenced"]
            assert len(fenced) == 1 and fenced[0]["shard"] == 0
            return actions, eng.calls, fenced, mgr.held()
        finally:
            pkg.journal.configure("")

    _both(run)


# ---- apiserver-outage ride-through (unit: the client arc) ----------------


def test_remote_store_outage_reattach_arc():
    """Three consecutive wire failures declare the outage (journaled
    once); the first success closes the arc, fires on_reattach, and the
    stats expose the round trip, alike in both packages."""
    def run(pkg):
        pkg.journal.configure("1")
        srv = pkg.APIServer(pkg.Store())
        srv.start()
        port = srv.port
        try:
            rs = pkg.RemoteStore(srv.address, retry_deadline_s=0.0,
                                 breaker_threshold=0)
            fired = []
            rs.on_reattach(lambda outage_s: fired.append(outage_s))
            rs.list("Pod")  # healthy baseline
            srv.shutdown()
            for _ in range(4):
                with pytest.raises(Exception):
                    rs.list("Pod")
            down = rs.reattach_stats()
            assert down["down"] and down["outages"] == 1
            srv = pkg.APIServer(pkg.Store(), port=port).start()
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline:
                try:
                    rs.list("Pod")
                    break
                except Exception:
                    time.sleep(0.05)
            up = rs.reattach_stats()
            assert not up["down"] and up["reattaches"] == 1
            assert len(fired) == 1 and fired[0] >= 0
            kinds = [e["kind"] for e in _events(pkg)]
            assert kinds.count("store.outage") == 1
            assert kinds.count("store.reattach") == 1
            return (len(fired), sorted(down), bool(down["down"]),
                    down["outages"], bool(up["down"]), up["reattaches"],
                    [k for k in kinds if k.startswith("store.")])
        finally:
            srv.shutdown()
            pkg.journal.configure("")

    _both(run)


# ---- postmortem: the succession narrative --------------------------------


def test_postmortem_narrates_steward_succession():
    """A succession driven in process (pa crowned, pa silent, pb claims
    past the TTL, mourns and respawns p0 through the census) journals
    the same events in both packages, and the port's events, behind the
    two that only a real replica process writes (the ``election:die``
    fire and the steward's suicide), read as ONE closed causal chain
    with crown-passing attribution."""
    from tools.postmortem import causal_chains, narrative

    def run(pkg):
        pkg.journal.configure("1")
        try:
            store = pkg.Store()
            clock = _Clock()
            spawns = []
            pkg.el.ensure_roster(store, ["p0", "p1"], clock=clock)
            e0, _d0 = _duties(pkg, store, "p0", clock, spawns,
                              stable_s=1.0, grace_s=3.0)
            e1, d1 = _duties(pkg, store, "p1", clock, spawns,
                             stable_s=1.0, grace_s=3.0)
            assert e0.tick()
            _heartbeat(pkg, store, "p0", clock)
            _heartbeat(pkg, store, "p1", clock)
            clock.t += 4.0  # p0 (the steward) dies; p1 lives on
            _heartbeat(pkg, store, "p1", clock)
            pkg.journal.configure("1")  # the succession alone
            assert e1.tick() and e1.epoch == 2
            d1.tick(2)
            clock.t += 1.0
            _heartbeat(pkg, store, "p1", clock)
            e1.tick()
            d1.tick(2)
            assert spawns == [("p1", "p0", 1)]
            return [e for e in _events(pkg)
                    if e["kind"].startswith("steward.")
                    and e["kind"] not in ("steward.renew", "steward.adopt")]
        finally:
            pkg.journal.configure("")

    succession = _both(run)
    assert [e["kind"] for e in succession] == [
        "steward.claim", "steward.handoff", "steward.mourn",
        "steward.respawn"]
    events = [{"kind": "fault.election", "action": "die"},
              {"kind": "steward.suicide", "replica": "p0"}] + succession
    events = [dict(e, seq=i + 1) for i, e in enumerate(events)]
    chains = causal_chains(events)
    assert len(chains) == 1 and len(chains[0]) == 6
    assert chains[0][-1]["kind"] == "steward.respawn"  # chain closed
    lines = narrative(events)
    assert len(lines) == 1
    assert "unresolved" not in lines[0]
    assert "p1<-p0@e2" in lines[0]
    assert "p1 tends p0 inc=1" in lines[0]


# ---- real detached processes ---------------------------------------------


def _wait(pred, timeout, step=0.1):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(step)
    return pred()


def _seed_nodes(store, n=4):
    for i in range(n):
        store.create(obj.Node(
            metadata=obj.ObjectMeta(name=f"n{i}"),
            status=obj.NodeStatus(allocatable={
                "cpu": 64000, "memory": 1 << 36, "pods": 500})))


ELECT_TTL = 0.6
ELECT_TICK = 0.15
#: The replicas' engine on the CPU (the spec's config names the device).
ELECT_CONFIG = dict(platform="cpu", max_batch_size=16, batch_window_s=0.05,
                    batch_idle_s=0.02, backoff_initial_s=0.05,
                    backoff_max_s=0.2)


class _Janitor:
    """Every pid a detached fleet has shown, reaped in a ``finally``."""

    def __init__(self, fleet):
        self.fleet = fleet
        self.pids = set()

    def look(self):
        self.pids.update(p for p in self.fleet.pids().values() if p > 0)
        self.pids.update(p.pid for p in self.fleet._spawned)
        return True

    def reap(self):
        try:
            self.look()
        except Exception:
            pass
        self.fleet.shutdown()
        for pid in self.pids:
            if not _pid_dead(pid):
                os.kill(pid, 9)
        _wait(lambda: all(_pid_dead(p) for p in self.pids), 5, 0.05)
        return [p for p in self.pids if not _pid_dead(p)]


@pytest.mark.slow
def test_elect_sigkill_steward_takeover_and_respawn_exactly_once():
    """Parent ABSENT: detached replicas, no supervisor. SIGKILL the
    steward mid-burst: a peer holds the steward lease within ~one TTL at
    a bumped epoch, the dead replica is respawned exactly once, and
    every pod lands exactly once."""
    store = ClusterStore()
    _seed_nodes(store)
    srv = APIServer(store).start()
    rs = RemoteStore(srv.address)
    fleet = ElectFleet(rs, srv.address, replicas=3, n_shards=3,
                       ttl_s=ELECT_TTL, tick_s=ELECT_TICK,
                       spec={"config": ELECT_CONFIG},
                       extra_env={"MINISCHED_REBALANCE": "1"})
    jan = _Janitor(fleet)
    try:
        fleet.launch()
        assert fleet.wait_ready(120), "fleet never came ready"
        steward = fleet.wait_steward(30)
        assert steward, "no steward elected"
        assert fleet.wait_converged(60), "shards never claimed"
        epoch0 = fleet.steward_epoch()
        for i in range(40):
            rs.create(_pod(f"e{i}", cpu=100 + i))
        time.sleep(0.3)
        jan.look()
        assert fleet.kill(steward)
        t_kill = time.monotonic()
        successor = fleet.wait_steward(30, exclude=steward)
        lat = time.monotonic() - t_kill
        assert successor and successor != steward
        assert lat < 2 * ELECT_TTL + 3.0, f"succession took {lat:.2f}s"
        assert fleet.steward_epoch() > epoch0
        assert _wait(lambda: jan.look() and (lambda r: r is not None
                     and r.state == "alive" and r.deaths == 1
                     and r.respawns == 1 and r.incarnation == 1)(
                     fleet.incarnations().get(steward)), 90), \
            f"census: {fleet.incarnations().get(steward)}"
        assert _wait(lambda: all(p.spec.node_name
                                 for p in rs.list("Pod")), 120)
        pods = rs.list("Pod")
        assert len(pods) == len({p.metadata.name for p in pods}) == 40
        assert fleet.wait_converged(60)
        assert set(fleet.lease_holders().values()) <= set(fleet.census())
    finally:
        left = jan.reap()
        srv.shutdown()
    assert not left


def _probe(rs):
    try:
        rs.list("Node")
        return True
    except Exception:
        return False


@pytest.mark.slow
def test_elect_apiserver_restart_ride_through():
    """Kill the control plane mid-burst and revive it on the same port:
    every replica declares the outage, reattaches, and re-earns its
    shards through a FRESH epoch; the full burst lands exactly once."""
    store = ClusterStore()
    _seed_nodes(store)
    srv = APIServer(store).start()
    port = srv.port
    rs = RemoteStore(srv.address)
    fleet = ElectFleet(rs, srv.address, replicas=2, n_shards=2,
                       ttl_s=ELECT_TTL, tick_s=ELECT_TICK,
                       spec={"config": ELECT_CONFIG})
    jan = _Janitor(fleet)
    try:
        fleet.launch()
        assert fleet.wait_ready(120)
        assert fleet.wait_steward(30)
        assert fleet.wait_converged(60)
        jan.look()
        epochs0 = {s: store.get("Lease", lease_name(s)).epoch
                   for s in range(2)}
        for i in range(20):
            rs.create(_pod(f"r{i}", cpu=100))
        time.sleep(0.4)
        srv.shutdown()
        time.sleep(2.5)  # outage >> TTL: every lease lapses
        srv = APIServer(store, port=port).start()
        assert _wait(lambda: _probe(rs), 15)
        for i in range(20, 40):
            rs.create(_pod(f"r{i}", cpu=100))
        assert _wait(lambda: all(
            store.get("Lease", lease_name(s)).epoch > epochs0[s]
            for s in range(2)), 30)
        assert fleet.wait_converged(90)
        assert _wait(lambda: len(rs.list("Pod")) == 40 and all(
            p.spec.node_name for p in rs.list("Pod")), 120)
        pods = rs.list("Pod")
        assert len({p.metadata.name for p in pods}) == 40
        assert set(fleet.lease_holders().values()) <= set(fleet.census())
        assert all(r.state == "alive" and r.deaths == 0
                   for r in fleet.incarnations().values()), \
            fleet.incarnations()
    finally:
        left = jan.reap()
        srv.shutdown()
    assert not left


@pytest.mark.slow
def test_elect_fleet_composes_with_device_loop():
    """Election fleet x depth-8 device loop: SIGKILL the steward while
    ring tranches are staged; the burst still drains exactly-once."""
    store = ClusterStore()
    _seed_nodes(store, 3)
    srv = APIServer(store).start()
    rs = RemoteStore(srv.address)
    spec = dict(platform="cpu", device_loop=True, loop_depth=8,
                max_batch_size=8, batch_window_s=0.1, batch_idle_s=0.05,
                backoff_initial_s=0.05, backoff_max_s=0.2)
    fleet = ElectFleet(rs, srv.address, replicas=2, n_shards=2,
                       ttl_s=ELECT_TTL, tick_s=ELECT_TICK,
                       spec={"config": spec})
    jan = _Janitor(fleet)
    try:
        fleet.launch()
        assert fleet.wait_ready(120)
        steward = fleet.wait_steward(30)
        assert steward and fleet.wait_converged(60)
        for i in range(32):
            rs.create(_pod(f"dl{i}", cpu=100 + 7 * i, priority=100 - i))
        time.sleep(0.25)
        jan.look()
        assert fleet.kill(steward)
        assert fleet.wait_steward(30, exclude=steward)
        assert _wait(lambda: jan.look() and len(rs.list("Pod")) == 32
                     and all(p.spec.node_name for p in rs.list("Pod")),
                     150)
        pods = rs.list("Pod")
        assert len({p.metadata.name for p in pods}) == 32
    finally:
        left = jan.reap()
        srv.shutdown()
    assert not left


#: The unmarked process test's deadline (well inside it on the CPU).
PROCESS_DEADLINE_S = 45.0


def test_cpu_elect_fleet_steward_kill_respawns_once():
    """Three detached replicas of the port on the CPU elect a steward;
    SIGKILL it: one new steward at a higher epoch, the dead replica
    respawned exactly once by a peer (incarnation 1), every pod bound
    once, and every pid the fleet ever showed dead at the end."""
    t0 = time.monotonic()
    store = ClusterStore()
    _seed_nodes(store)
    srv = APIServer(store).start()
    rs = RemoteStore(srv.address)
    fleet = ElectFleet(rs, srv.address, replicas=3, n_shards=3,
                       ttl_s=ELECT_TTL, tick_s=ELECT_TICK,
                       spec={"config": ELECT_CONFIG})
    jan = _Janitor(fleet)
    try:
        assert len(fleet.launch()) == 3
        assert fleet.wait_ready(30), "fleet never came ready"
        steward = fleet.wait_steward(10)
        assert steward and fleet.wait_converged(10)
        epoch0 = fleet.steward_epoch()
        for i in range(40):
            rs.create(_pod(f"s{i}", cpu=100 + i))
        jan.look()
        assert fleet.kill(steward)
        successor = fleet.wait_steward(10, exclude=steward)
        assert successor and successor != steward
        assert fleet.steward_epoch() > epoch0
        assert _wait(lambda: jan.look() and (lambda r: r is not None
                     and r.state == "alive" and r.deaths == 1
                     and r.respawns == 1 and r.incarnation == 1)(
                     fleet.incarnations().get(steward)), 20), \
            f"census: {fleet.incarnations().get(steward)}"
        others = [r for rid, r in fleet.incarnations().items()
                  if rid != steward]
        assert all(r.deaths == 0 and r.respawns == 0 for r in others)
        assert _wait(lambda: all(p.spec.node_name
                                 for p in rs.list("Pod")), 20)
        pods = rs.list("Pod")
        assert len(pods) == len({p.metadata.name for p in pods}) == 40
        assert time.monotonic() - t0 < PROCESS_DEADLINE_S
    finally:
        left = jan.reap()
        srv.shutdown()
    assert not left and len(jan.pids) == 4  # three launched, one respawn

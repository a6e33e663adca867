"""The port's process fleet (fleet/procfleet.py) against the JAX package's.

Mirrors tests/test_fleet_proc.py on the port. The UNIT layer feeds one
store sequence and one clock to both packages and asserts the JAX test's
claims on each, then equal results: the MINISCHED_REBALANCE grammar, the
heartbeat CAS, the rebalancer's hysteresis (a move needs the SAME donor
hottest for ``hold`` consecutive windows; oscillating skew produces
zero moves), the stale-directive reap, the ShardMove directive protocol
(donor release, recipient epoch-bump claim, reservations) and the
boot-time round-robin deal: equal directives, epochs, actions, engine
calls and counters. The fleet x device-loop composition runs the
in-process fleet of the port (unmarked, as in the JAX suite).

The INTEGRATION layer spawns REAL replica processes of the port on the
CPU (``platform="cpu"``): the JAX suite's four ``slow`` tests, mirrored
with the same mark, and one unmarked failover (2 replicas, 64 nodes,
200 pods, a SIGKILL) under its own deadline, which also checks that a
CPU replica never initializes CUDA. Then the port's own rules: the
replica's environment (no platform variable for a CUDA spec, the
devices hidden for a CPU one), no fallback (a CUDA replica without its
kernels exits 3 and is never run on the CPU), the platform guard, and
every public name of the JAX modules. Every test that spawns kills
what it spawned in a ``finally``.
"""
import os
import re
import threading
import time
import urllib.request
from types import SimpleNamespace

import pytest

from minisched_tpu.fleet import lease as jlease
from minisched_tpu.fleet import procfleet as jprocfleet
from minisched_tpu.fleet import shardmap as jshardmap
from minisched_tpu.state import objects as JO
from minisched_tpu.state.store import ClusterStore as JStore
from minisched_tpu_torch.config import SchedulerConfig
from minisched_tpu_torch.fleet import lease as tlease
from minisched_tpu_torch.fleet import procfleet as tprocfleet
from minisched_tpu_torch.fleet import shardmap as tshardmap
from minisched_tpu_torch.fleet.election import _pid_dead
from minisched_tpu_torch.fleet.procfleet import (ProcFleetSupervisor,
                                                 RebalanceSpec,
                                                 parse_rebalance_spec)
from minisched_tpu_torch.fleet.shardmap import (lease_name, move_name,
                                                shard_of)
from minisched_tpu_torch.obs import journal as journal_mod
from minisched_tpu_torch.scenario.runner import Cluster
from minisched_tpu_torch.service.defaultconfig import Profile
from minisched_tpu_torch.state import objects as obj
from minisched_tpu_torch.state.store import ClusterStore
from torch_obs_parity import disarm_all

JAX = SimpleNamespace(name="jax", pf=jprocfleet, lease=jlease,
                      shardmap=jshardmap, O=JO, Store=JStore)
PORT = SimpleNamespace(name="port", pf=tprocfleet, lease=tlease,
                       shardmap=tshardmap, O=obj, Store=ClusterStore)

PROFILE = Profile(plugins=["NodeUnschedulable", "NodeResourcesFit",
                           "NodeResourcesLeastAllocated"])

#: The JAX suite's engine shape for replica processes, on the CPU.
PROC_CONFIG = dict(platform="cpu", max_batch_size=16, batch_window_s=0.05,
                   batch_idle_s=0.02, backoff_initial_s=0.05,
                   backoff_max_s=0.2)


@pytest.fixture(autouse=True)
def _disarmed(request):
    """Both packages' singletons disarmed around each test, except
    around the module fleet's tests: its journal stays armed."""
    if "proc_fleet" in request.fixturenames:
        yield
        return
    disarm_all()
    yield
    disarm_all()


def _both(scenario):
    """Run ``scenario(pkg)`` on both packages; their results must be
    equal. Returns the port's."""
    got = {pkg.name: scenario(pkg) for pkg in (JAX, PORT)}
    assert got["port"] == got["jax"]
    return got["port"]


def _pod(name, cpu=100, priority=0, O=obj):
    return O.Pod(metadata=O.ObjectMeta(name=name, namespace="default"),
                 spec=O.PodSpec(requests={"cpu": cpu}, priority=priority))


def _status(O, rid, queue_depth=0, overload_level=0, ready=True,
            renewed_at=None):
    return O.ReplicaStatus(
        metadata=O.ObjectMeta(name=f"replica-{rid}"),
        queue_depth=queue_depth, overload_level=overload_level,
        ready=ready,
        renewed_at=time.time() if renewed_at is None else renewed_at)


def _moves(store):
    return sorted((m.key, m.shard, m.donor, m.recipient, m.state,
                   m.nominated_at, m.ttl_s, m.steward_epoch)
                  for m in store.list("ShardMove"))


class _FakeEngine:
    """Records the adopt/release protocol the real engine implements."""

    def __init__(self, n_shards=2, owned=()):
        self.n_shards = n_shards
        self.owned = set(owned)
        self.calls = []

    @property
    def shard_view(self):
        return (self.n_shards, frozenset(self.owned), 0)

    def release_shards(self, shards, *, epoch=0, reason=""):
        self.owned -= set(shards)
        self.calls.append(("release", sorted(shards), epoch, reason))

    def adopt_shards(self, shards, *, epoch=0, reason=""):
        self.owned |= set(shards)
        self.calls.append(("adopt", sorted(shards), epoch, reason))
        return 0


# ---- MINISCHED_REBALANCE grammar ----------------------------------------


def test_parse_rebalance_spec_grammar():
    def run(pkg):
        parse = pkg.pf.parse_rebalance_spec
        assert parse(None) is None and parse("") is None
        assert parse("0") is None
        assert parse("1") == pkg.pf.RebalanceSpec()
        spec = parse("skew=2.5,hold=5,cooldown=1,"
                     "burn_weight=4,max_moves=0,stale_s=3")
        assert (spec.skew, spec.hold, spec.cooldown) == (2.5, 5, 1)
        assert (spec.burn_weight, spec.max_moves, spec.stale_s) \
            == (4.0, 0, 3.0)
        return vars(spec)

    _both(run)
    assert tprocfleet.MAX_PLAUSIBLE_BURN == jprocfleet.MAX_PLAUSIBLE_BURN
    for name in ("_REPLICA_ENV", "_APISERVER_ENV", "_TOKEN_ENV",
                 "_CONFIG_ENV", "_INCARNATION_ENV", "_PREWARM_ENV",
                 "_TICK_ENV", "_FLEET_N_ENV", "_DETACHED_ENV"):
        assert getattr(tprocfleet, name) == getattr(jprocfleet, name)


@pytest.mark.parametrize("bad", [
    "frobnicate=1",      # unknown knob
    "skew",              # not name=value
    "hold=three",        # unparsable value
])
def test_parse_rebalance_spec_rejects_junk(bad):
    with pytest.raises(ValueError) as mine:
        parse_rebalance_spec(bad)
    with pytest.raises(ValueError) as theirs:
        jprocfleet.parse_rebalance_spec(bad)
    assert str(mine.value) == str(theirs.value)


# ---- heartbeat CAS -------------------------------------------------------


def test_push_heartbeat_creates_then_cas_updates():
    def run(pkg):
        store = pkg.Store()
        counters = {}
        assert pkg.pf.push_heartbeat(
            store, "p7", {"pid": 123, "ready": True, "renewed_at": 1.0},
            counters=counters)
        st = store.get("ReplicaStatus", "replica-p7")
        assert st.pid == 123 and st.ready
        assert pkg.pf.push_heartbeat(
            store, "p7", {"queue_depth": 5, "renewed_at": 2.0},
            counters=counters)
        st = store.get("ReplicaStatus", "replica-p7")
        # CAS update merged the new fields over the surviving old ones.
        assert st.queue_depth == 5 and st.pid == 123
        assert st.renewed_at == 2.0
        assert counters["heartbeats"] == 2
        return (counters, st.metadata.resource_version, st.pid,
                st.queue_depth, st.ready, st.renewed_at)

    _both(run)


# ---- rebalancer hysteresis -----------------------------------------------


def test_rebalancer_nominates_only_after_sustained_skew():
    """hold=3: the same donor must stay hottest with skew >= threshold
    for three CONSECUTIVE windows before a directive appears."""
    def run(pkg):
        store = pkg.Store()
        clk = [100.0]
        reb = pkg.pf.ShardRebalancer(
            store, pkg.pf.RebalanceSpec(skew=4.0, hold=3, cooldown=2),
            clock=lambda: clk[0])
        hot = {"p0": _status(pkg.O, "p0", queue_depth=20),
               "p1": _status(pkg.O, "p1", queue_depth=0)}
        holders = {0: "p0", 1: "p1"}
        out = [reb.observe(hot, holders), reb.observe(hot, holders)]
        assert out == [None, None] and _moves(store) == []
        moved = reb.observe(hot, holders)      # streak 3 -> nominate
        assert moved is not None
        mv = store.get("ShardMove", move_name(0))
        assert (mv.donor, mv.recipient, mv.state) \
            == ("p0", "p1", "nominated")
        assert reb.counters["moves_nominated"] == 1
        # Cooldown: the next `cooldown` windows are quiet under skew.
        out += [moved, reb.observe(hot, holders), reb.observe(hot, holders)]
        assert out[-2:] == [None, None]
        assert reb.counters["moves_nominated"] == 1
        return out, _moves(store), reb.counters

    _both(run)


def test_rebalancer_skew_collapse_resets_streak():
    def run(pkg):
        store = pkg.Store()
        reb = pkg.pf.ShardRebalancer(
            store, pkg.pf.RebalanceSpec(skew=4.0, hold=3, cooldown=2))
        hot = {"p0": _status(pkg.O, "p0", queue_depth=20),
               "p1": _status(pkg.O, "p1")}
        calm = {"p0": _status(pkg.O, "p0", queue_depth=1),
                "p1": _status(pkg.O, "p1")}
        holders = {0: "p0", 1: "p1"}
        out = [reb.observe(s, holders)
               for s in (hot, hot, calm, hot, hot)]  # collapse at 3
        assert out == [None] * 5
        assert reb.counters["moves_nominated"] == 0
        assert reb.counters["streak_resets"] >= 1
        return reb.counters

    _both(run)


def test_rebalancer_oscillating_skew_never_flaps():
    """A-hot, B-hot, A-hot ... for many windows nominates NOTHING: the
    donor-identity streak reset makes flapping structurally
    impossible."""
    def run(pkg):
        store = pkg.Store()
        reb = pkg.pf.ShardRebalancer(
            store, pkg.pf.RebalanceSpec(skew=4.0, hold=3, cooldown=2))
        a_hot = {"p0": _status(pkg.O, "p0", queue_depth=30),
                 "p1": _status(pkg.O, "p1")}
        b_hot = {"p0": _status(pkg.O, "p0"),
                 "p1": _status(pkg.O, "p1", queue_depth=30)}
        holders = {0: "p0", 1: "p1"}
        for i in range(24):
            reb.observe(a_hot if i % 2 == 0 else b_hot, holders)
        assert reb.counters["moves_nominated"] == 0
        assert _moves(store) == []
        assert reb.counters["streak_resets"] >= 10
        return reb.counters

    _both(run)


def test_rebalancer_burn_signal_weights_overload_rung():
    def run(pkg):
        reb = pkg.pf.ShardRebalancer(pkg.Store(),
                                     pkg.pf.RebalanceSpec(burn_weight=8.0))
        st = _status(pkg.O, "p0", queue_depth=3, overload_level=2)
        assert reb.load_of(st) == 3 + 8.0 * 2
        return reb.load_of(st)

    _both(run)


def test_rebalancer_reaps_stale_directives():
    def run(pkg):
        store = pkg.Store()
        clk = [100.0]
        reb = pkg.pf.ShardRebalancer(store,
                                     pkg.pf.RebalanceSpec(stale_s=5.0),
                                     clock=lambda: clk[0])
        store.create(pkg.O.ShardMove(
            metadata=pkg.O.ObjectMeta(name=move_name(0)), shard=0,
            donor="p0", recipient="p1", state="released",
            nominated_at=100.0, ttl_s=5.0))
        assert reb.reap_stale() == 0
        clk[0] = 106.0
        assert reb.reap_stale() == 1
        assert _moves(store) == []
        assert reb.counters["moves_reaped"] == 1
        return reb.counters

    _both(run)


# ---- directive protocol --------------------------------------------------


def test_move_directive_protocol_donor_release_recipient_adopt():
    """The full handoff, driven synchronously: donor releases the lease
    VOLUNTARILY (holder cleared, epoch untouched, immediately
    claimable), recipient claims with the usual epoch bump and deletes
    the directive. While the directive is live, the released shard is
    reserved against everyone but the recipient."""
    def run(pkg):
        store = pkg.Store()
        clk = [0.0]
        mgrs = [pkg.lease.LeaseManager(store, f"p{i}", ttl_s=10.0,
                                       clock=lambda: clk[0])
                for i in range(3)]
        mgr_a, mgr_b, mgr_c = mgrs
        assert mgr_a.try_acquire(0) and mgr_a.try_acquire(1)
        eng_a = _FakeEngine(owned={0, 1})
        eng_b, eng_c = _FakeEngine(), _FakeEngine()
        epoch0 = mgr_a.epoch_of(0)
        store.create(pkg.O.ShardMove(
            metadata=pkg.O.ObjectMeta(name=move_name(0)), shard=0,
            donor="p0", recipient="p1", state="nominated",
            nominated_at=time.time(), ttl_s=60.0))
        steps = []
        # Donor pass: stop serving, clear the holder, flip to released.
        steps.append(pkg.pf.handle_move_directives(store, "p0", mgr_a,
                                                   eng_a))
        assert steps[-1] == ["donated:0"]
        lease = store.get("Lease", lease_name(0))
        assert lease.holder == "" and lease.epoch == epoch0
        assert not mgr_a.holds(0) and mgr_a.holds(1)
        assert eng_a.calls[0][:2] == ("release", [0])
        assert "p1" in eng_a.calls[0][3]
        assert store.get("ShardMove", move_name(0)).state == "released"
        steps.append((lease.holder, lease.epoch,
                      lease.metadata.resource_version))
        # Bystander pass: the released shard is reserved for the
        # recipient; p2's claim scan must skip it (and p0's shard 1).
        assert pkg.pf._reserved_shards(store, "p2") == {0}
        pkg.pf.replica_tick(store, "p2", mgr_c, eng_c, 2,
                            clock=lambda: clk[0])
        assert mgr_c.held() == {}
        # Recipient pass: epoch-bump claim, adopt, delete the directive.
        steps.append(pkg.pf.handle_move_directives(store, "p1", mgr_b,
                                                   eng_b))
        assert steps[-1] == ["adopted:0"]
        lease = store.get("Lease", lease_name(0))
        assert lease.holder == "p1" and lease.epoch == epoch0 + 1
        assert eng_b.calls[0][0] == "adopt" and "p0" in eng_b.calls[0][3]
        assert _moves(store) == []
        return (steps, eng_a.calls, eng_b.calls, eng_c.calls,
                [(m.held(), m.counters) for m in mgrs])

    _both(run)


def test_stale_directive_is_ignored_by_both_sides():
    def run(pkg):
        store = pkg.Store()
        clk = [0.0]
        mgr_a = pkg.lease.LeaseManager(store, "p0", ttl_s=10.0,
                                       clock=lambda: clk[0])
        assert mgr_a.try_acquire(0)
        eng_a = _FakeEngine(owned={0})
        store.create(pkg.O.ShardMove(
            metadata=pkg.O.ObjectMeta(name=move_name(0)), shard=0,
            donor="p0", recipient="p1", state="nominated",
            nominated_at=time.time() - 120.0, ttl_s=5.0))
        assert pkg.pf.handle_move_directives(store, "p0", mgr_a,
                                             eng_a) == []
        assert mgr_a.holds(0) and eng_a.calls == []
        # ...and it reserves nothing: the reap path owns its deletion.
        assert pkg.pf._reserved_shards(store, "p2") == set()
        return mgr_a.held(), mgr_a.counters

    _both(run)


def test_replica_tick_prefer_limits_boot_claims():
    """The boot-time round-robin deal: with ``prefer`` set, a replica
    claims only its preferred shards even when others are free."""
    def run(pkg):
        store = pkg.Store()
        clk = [0.0]
        mgr = pkg.lease.LeaseManager(store, "p1", ttl_s=10.0,
                                     clock=lambda: clk[0])
        eng = _FakeEngine(n_shards=4)
        pkg.pf.replica_tick(store, "p1", mgr, eng, 4,
                            clock=lambda: clk[0], prefer={1, 3})
        first = sorted(mgr.held())
        assert first == [1, 3]
        pkg.pf.replica_tick(store, "p1", mgr, eng, 4,
                            clock=lambda: clk[0])
        assert sorted(mgr.held()) == [0, 1, 2, 3]  # widened
        return first, mgr.held(), eng.calls, mgr.counters

    _both(run)


# ---- fleet x device-loop composition (in-process, tier-1) ----------------


def test_fleet_crash_with_staged_ring_tranche_drains_bit_identical(
        monkeypatch):
    """Crash (abandon) the replica that owns every pod while a depth-8
    ring tranche is staged: staged-unresolved slots never commit, the
    adopter re-derives the dead replica's backlog from store truth, and
    the final placements are BIT-IDENTICAL to a fault-free fleet run of
    the port: zero pods lost, zero doubly bound.

    The premises are stated, not left to timing. Tie-breaks follow each
    engine's own step counter, so the adopter redoes the baseline's
    decisions only when the owner committed nothing and every run forms
    the same batches. So the owner's first pop waits until the whole
    burst is queued (the adopter receives the backlog in one bulk add:
    both cut it into the same batches); the crash run holds the owner
    right after its first tranche's dispatch until the kill lands
    (residency off, so the ring opens on the first batch: with it on,
    the first batch runs alone to verify the slim fetch and commits
    before any tranche). The baseline's lease TTL is one a collector
    pause cannot expire: the baseline must have no takeover at all."""
    names = [f"d{i}" for i in range(800)
             if shard_of(f"default/d{i}", 2) == 0][:40]
    assert len(names) == 40
    cfg = dict(platform="cpu", device_loop=True, loop_depth=8,
               device_resident=False, max_batch_size=8,
               batch_window_s=0.3, batch_idle_s=0.1,
               backoff_initial_s=0.05, backoff_max_s=0.2)
    profile = Profile(name="loop",
                      plugins=["NodeUnschedulable", "NodeResourcesFit"],
                      plugin_args={"NodeResourcesFit":
                                   {"score_strategy": None}})

    def hold_owner(eng, staged):
        """The owner's first pop waits for the whole burst; with
        ``staged`` its first ring dispatch signals it and waits to be
        abandoned. Returns an event set once the owner's loop is inside
        the held pop: the pods are created only then, so no pop begun
        before the patch can cut the burst."""
        pop, fold = eng._pop, eng._fold_launches
        first = [True]
        armed = threading.Event()

        def held_pop():
            if first[0]:
                first[0] = False
                armed.set()
                assert _wait(lambda: eng.queue.stats()["active"]
                             >= len(names), 30, step=0.01)
            return pop()

        def held_fold(before):
            fold(before)
            if staged is not None and not staged.is_set():
                staged.set()
                assert _wait(lambda: eng._abandoned, 30, step=0.005)

        eng._pop = held_pop
        eng._fold_launches = held_fold
        return armed

    def run(crash):
        monkeypatch.setenv("MINISCHED_LEASE_TTL", "0.4" if crash else "60")
        c = Cluster()
        try:
            for i, cpu in enumerate((64000, 48000, 32000)):
                c.create_node(f"n{i}", cpu=cpu)
            c.start(profile=profile, config=SchedulerConfig(**cfg),
                    with_pv_controller=False, fleet=2)
            fleet = c.service.fleet
            assert fleet.wait_converged(10.0)
            victim = fleet.owner_of(0)
            owner = fleet.engines()[victim]
            staged = threading.Event() if crash else None
            assert hold_owner(owner, staged).wait(10), \
                "the owner's loop never reached the held pop"
            c.create_objects([_pod(n, cpu=100 + 13 * i, priority=1000 - i)
                              for i, n in enumerate(names)])
            if crash:
                assert staged.wait(30), "the owner staged no tranche"
                assert not [p for p in c.list_pods() if p.spec.node_name], \
                    "the owner committed before the crash"
                assert fleet.kill(victim, crash=True)
                assert owner.metrics()["loop_abandoned_slots"] >= 1
            deadline = time.monotonic() + 120
            placed = {}
            while time.monotonic() < deadline:
                placed = {p.metadata.name: p.spec.node_name
                          for p in c.list_pods() if p.spec.node_name}
                if len(placed) == len(names):
                    break
                time.sleep(0.05)
            assert len(placed) == len(names), \
                f"only {len(placed)}/{len(names)} bound"
            # exactly-once: one store object per pod, each bound once
            assert sorted(p.metadata.name for p in c.list_pods()) \
                == sorted(names)
            m = fleet.metrics()
            if crash:
                assert m["fleet_takeovers"] >= 1
            else:
                assert m["fleet_takeovers"] == 0
                assert m["lease_losses"] == 0
            return placed
        finally:
            c.shutdown()

    baseline = run(crash=False)
    crashed = run(crash=True)
    assert crashed == baseline


# ---- real replica processes ----------------------------------------------


def _wait(pred, timeout, step=0.1):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(step)
    return pred()


def _nodes(store, cpus):
    for i, cpu in enumerate(cpus):
        store.create(obj.Node(
            metadata=obj.ObjectMeta(name=f"n{i}"),
            status=obj.NodeStatus(allocatable={"cpu": cpu,
                                               "memory": 64 << 30,
                                               "pods": 500})))


def sidecar_metrics(address):
    """A replica's own engine metrics from its sidecar's ``/metrics``
    (the engine's keys under ``minisched_engine_``)."""
    text = urllib.request.urlopen(f"{address}/metrics",
                                  timeout=5).read().decode()
    return {m.group(1): float(m.group(2)) for m in re.finditer(
        r"^minisched_engine_(\w+) (\S+)$", text, re.M)}


def _reap(sup):
    """Shut the supervisor down and SIGKILL any replica it left."""
    pids = [p.popen.pid for p in sup._procs.values() if p.popen]
    sup.shutdown()
    for pid in pids:
        if not _pid_dead(pid):
            os.kill(pid, 9)
    assert all(_pid_dead(pid) for pid in pids)


@pytest.fixture(scope="module")
def proc_fleet():
    from minisched_tpu_torch.apiserver.server import APIServer

    journal_mod.configure("1")
    store = ClusterStore()
    _nodes(store, (64000, 64000, 48000, 48000))
    api = APIServer(store).start()
    sup = ProcFleetSupervisor(
        store, api.address, replicas=2, lease_ttl_s=1.0,
        prewarm=False, respawn=True, backoff0_s=0.1, backoff_cap_s=1.0,
        stable_s=5.0, config_overrides=dict(PROC_CONFIG), profile=PROFILE)
    sup.start()
    try:
        assert sup.wait_ready(timeout=180), "replicas never came ready"
        assert sup.wait_converged(timeout=60), "shards never claimed"
        yield store, sup
    finally:
        _reap(sup)
        api.shutdown()
        journal_mod.configure("")


@pytest.mark.slow
def test_proc_fleet_partitions_and_binds(proc_fleet):
    """Boot census + clean partition: both processes heartbeat ready,
    the round-robin deal gives each replica its own shard, and a pod
    burst binds exactly once across the partition."""
    store, sup = proc_fleet
    census = sup.census()
    assert sorted(census) == ["p0", "p1"]
    assert all(st.pid > 0 and st.ready for st in census.values())
    holders = sup.lease_holders()
    assert len(holders) == 2 and set(holders.values()) == {"p0", "p1"}
    for i in range(24):
        store.create(_pod(f"a{i}"))
    assert _wait(lambda: sum(1 for p in store.list("Pod")
                             if p.spec.node_name) == 24, 60)
    pods = list(store.list("Pod"))
    assert sorted(p.metadata.name for p in pods) \
        == sorted(f"a{i}" for i in range(24))
    m = sup.metrics()
    assert m["proc_spawns"] >= 2 and m["fleet_replicas_live"] == 2


@pytest.mark.slow
def test_proc_sigkill_failover_exactly_once_and_journaled(proc_fleet):
    """SIGKILL one replica mid-burst: every pod still lands exactly
    once, the survivor claims the dead shard through the epoch fence,
    the takeover is journaled in the MERGED cross-process stream
    (monotone seqs), and the exit-code census reads exactly one -9."""
    from tools.postmortem import validate_journal

    store, sup = proc_fleet
    before = {p.metadata.name for p in store.list("Pod")}
    for i in range(40):
        store.create(_pod(f"k{i}", cpu=100 + i))
    time.sleep(0.1)
    kill_unix = time.time()
    assert sup.kill("p1")
    assert _wait(lambda: sum(1 for p in store.list("Pod")
                             if p.spec.node_name) == len(before) + 40, 90)
    pods = list(store.list("Pod"))
    assert len(pods) == len({p.metadata.name for p in pods}) \
        == len(before) + 40
    assert _wait(lambda: sup.exit_codes.get("-9", 0) >= 1, 30)
    assert sup.counters["kills"] == 1

    def takeovers():
        return [e for e in sup.journal()["entries"]
                if e["kind"] == "lease.takeover" and e.get("frm") == "p1"]

    # The port binds the burst before the dead lease expires (one TTL),
    # so the takeover is waited for rather than read at once.
    assert _wait(lambda: bool(takeovers()), 10), \
        "survivor never journaled the takeover"
    doc = sup.journal()
    assert set(doc["sources"]) >= {"p0", "supervisor"}
    validate_journal(doc["entries"])
    takes = takeovers()
    assert takes[0]["source"] == "p0"
    deaths = [e for e in doc["entries"] if e["kind"] == "proc.death"]
    assert deaths and deaths[0]["source"] == "supervisor"
    assert deaths[0]["exit_code"] == -9
    assert takes[0]["unix"] - kill_unix < 1.0 * 2 + 3.0
    assert _wait(lambda: set(sup.lease_holders().values()) == {"p0"}, 30)
    assert _wait(lambda: "p1" in sup.census()
                 and sup.census()["p1"].incarnation >= 1, 120)
    assert sup.counters["respawns"] >= 1


@pytest.mark.slow
def test_proc_elastic_handoff_executes_across_processes(proc_fleet):
    """A nominated directive executes across two LIVE processes: the
    donor voluntarily releases, the recipient claims with an epoch bump
    and deletes the directive, both sides journaled."""
    store, sup = proc_fleet
    assert sup.wait_converged(60)
    holders = sup.lease_holders()
    donor = holders[0]
    recipient = ({"p0", "p1"} - {donor}).pop()
    epoch0 = store.get("Lease", lease_name(0)).epoch
    store.create(obj.ShardMove(metadata=obj.ObjectMeta(name=move_name(0)),
                               shard=0, donor=donor, recipient=recipient,
                               state="nominated",
                               nominated_at=time.time(), ttl_s=60.0))
    assert _wait(lambda: sup.lease_holders().get(0) == recipient, 30), \
        "handoff never completed"
    assert store.get("Lease", lease_name(0)).epoch == epoch0 + 1
    assert _wait(lambda: not list(store.list("ShardMove")), 15)
    doc = sup.journal()
    rel = [e for e in doc["entries"]
           if e["kind"] == "proc.rebalance_release"]
    ado = [e for e in doc["entries"]
           if e["kind"] == "proc.rebalance_adopt"]
    assert rel and rel[0]["source"] == donor
    assert ado and ado[0]["source"] == recipient


@pytest.mark.slow
def test_proc_provenance_fans_out_with_attribution(proc_fleet):
    store, sup = proc_fleet
    store.create(_pod("prov-probe"))
    assert _wait(lambda: store.get("Pod", "default/prov-probe")
                 .spec.node_name, 60)
    rec = sup.provenance("default/prov-probe")
    assert rec is not None and rec.get("replica")
    assert rec["served_by"] in ("p0", "p1")
    assert rec["served_by"] == rec["replica"]


#: The unmarked process tests' deadline (each well inside it on the CPU).
PROCESS_DEADLINE_S = 45.0


def test_cpu_proc_fleet_sigkill_failover_binds_every_pod_once():
    """Two replica processes of the port on the CPU, 64 nodes and 200
    pods, one SIGKILL mid-burst: every pod is bound exactly once, the
    survivor takes the dead shard over, the dead replica is respawned at
    incarnation 1, and each CPU replica reports after binding that it
    never initialized CUDA. Every pid it spawned is dead at the end."""
    from minisched_tpu_torch.apiserver.server import APIServer

    t0 = time.monotonic()
    journal_mod.configure("1")
    store = ClusterStore()
    _nodes(store, [64000] * 64)
    api = APIServer(store).start()
    sup = ProcFleetSupervisor(
        store, api.address, replicas=2, lease_ttl_s=1.0, prewarm=True,
        backoff0_s=0.1, backoff_cap_s=1.0, stable_s=5.0,
        config_overrides=dict(PROC_CONFIG), profile=PROFILE)
    seen_pids = set()
    try:
        sup.start()
        assert sup.wait_ready(timeout=30), "replicas never came ready"
        assert sup.wait_converged(timeout=10)
        seen_pids.update(p.popen.pid for p in sup._procs.values())
        for i in range(200):
            store.create(_pod(f"f{i}", cpu=100 + i % 7))
        assert _wait(lambda: sum(1 for p in store.list("Pod")
                                 if p.spec.node_name) >= 20, 20, 0.02)
        assert sup.kill("p1")
        assert _wait(lambda: all(p.spec.node_name
                                 for p in store.list("Pod")), 20)
        pods = store.list("Pod")
        assert len(pods) == len({p.key for p in pods}) == 200
        used = {}
        for p in pods:
            used[p.spec.node_name] = (used.get(p.spec.node_name, 0)
                                      + p.spec.requests["cpu"])
        assert max(used.values()) <= 64000  # none over-committed
        assert _wait(lambda: sup.exit_codes.get("-9") == 1, 5)
        assert _wait(lambda: sup.census().get("p1") is not None
                     and sup.census()["p1"].incarnation == 1, 20)
        seen_pids.update(p.popen.pid for p in sup._procs.values())
        doc = sup.journal()
        takes = [e for e in doc["entries"]
                 if e["kind"] == "lease.takeover" and e["frm"] == "p1"]
        assert takes and takes[0]["source"] == "p0"
        for rid in ("p0", "p1"):
            m = sidecar_metrics(sup._procs[rid].address)
            assert m["proc_cuda_initialized"] == 0.0
            assert m["proc_warm"] == 1.0
        assert sidecar_metrics(sup._procs["p0"].address)["pods_bound"] > 0
        assert time.monotonic() - t0 < PROCESS_DEADLINE_S
    finally:
        _reap(sup)
        api.shutdown()
        journal_mod.configure("")
    assert seen_pids and all(_pid_dead(pid) for pid in seen_pids)


def test_child_env_sets_no_platform_for_cuda_and_hides_devices_for_cpu(
        monkeypatch):
    """The replica's environment: the port's module on PYTHONPATH, a
    parent's MINISCHED_PLATFORM dropped, no device variable at all for a
    CUDA spec and the devices hidden for a CPU one; the module spawned
    is the port's."""
    monkeypatch.setenv("MINISCHED_PLATFORM", "cpu")
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    root = os.path.dirname(os.path.dirname(os.path.abspath(
        tprocfleet.__file__)))
    root = os.path.dirname(root)
    for platform, hidden in (("", False), ("cuda:0", False),
                             ("cpu", True)):
        sup = ProcFleetSupervisor(
            ClusterStore(), "http://127.0.0.1:1", replicas=2,
            config_overrides={"platform": platform})
        env = sup._child_env(tprocfleet._Proc(rid="p0"))
        assert "MINISCHED_PLATFORM" not in env
        assert "JAX_PLATFORMS" not in env
        assert ("CUDA_VISIBLE_DEVICES" in env) == hidden
        if hidden:
            assert env["CUDA_VISIBLE_DEVICES"] == ""
        assert env["PYTHONPATH"].split(os.pathsep)[0] == root
        assert sup.platform == platform
    assert tprocfleet.REPLICA_MODULE == "minisched_tpu_torch.fleet.procfleet"
    # A CPU spec builds nothing before spawning.
    assert tprocfleet.prebuild_kernels({"platform": "cpu"}) is None


def test_a_cuda_replica_never_falls_back_to_the_cpu(monkeypatch, tmp_path):
    """No fallback. Without a toolkit a supervisor on a CUDA spec raises
    at ``start`` (the kernels are built before any spawn) and spawns
    nothing; a CUDA replica spawned anyway exits with
    ``KERNEL_FAILURE_EXIT`` on its failed build instead of running on
    the CPU; and a kernel failure inside a replica exits it, journaled."""
    from minisched_tpu_torch.apiserver.server import APIServer
    from minisched_tpu_torch.fleet.election import spawn_replica
    from minisched_tpu_torch.ops import _cuda_build

    monkeypatch.setenv("PATH", str(tmp_path))  # no nvcc on it
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    sup = ProcFleetSupervisor(ClusterStore(), "http://127.0.0.1:1",
                              replicas=2, config_overrides={})
    with pytest.raises(RuntimeError, match="nvcc"):
        sup.start()
    assert sup._procs == {} and sup.counters["spawns"] == 0
    monkeypatch.undo()
    store = ClusterStore()
    api = APIServer(store).start()
    # A build directory of its own: no built library to find.
    popen = spawn_replica(
        "p0", 0, api.address, n_shards=1, fleet_n=1, ttl_s=1.0,
        spec={"config": {"compile_cache": str(tmp_path / "kernels")}},
        extra_env={"PATH": str(tmp_path), "CUDA_HOME": str(tmp_path)})
    try:
        assert popen.wait(timeout=PROCESS_DEADLINE_S) \
            == tprocfleet.KERNEL_FAILURE_EXIT
        assert list(store.list("Lease")) == []  # never served
    finally:
        if popen.poll() is None:
            popen.kill()
        api.shutdown()
    # In a replica: any build or launch failure exits it, journaled.
    journal_mod.configure("1")
    exits = []
    monkeypatch.setattr(tprocfleet.os, "_exit",
                        lambda code: exits.append(code))
    monkeypatch.setitem(_cuda_build.FAILURES, "launch", 1)
    tprocfleet._exit_on_kernel_failure("p9")
    assert exits == [tprocfleet.KERNEL_FAILURE_EXIT]
    note = journal_mod.JOURNAL.entries()[-1]
    assert note["kind"] == "proc.kernel_failure" and note["launch"] == 1


def test_platform_guard_hides_devices_only_for_the_cpu(monkeypatch):
    """``utils/platform_guard``: a CPU platform hides every CUDA device
    (hard-set, in a child's environment or this process's); any other
    platform changes nothing, so a CUDA request is never made a CPU
    run."""
    from minisched_tpu_torch.utils import platform_guard as pg

    assert [pg.wants_cpu(p) for p in ("cpu", "CPU", "cpu:0", "", "cuda",
                                      "cuda:1")] \
        == [True, True, True, False, False, False]
    for platform in ("", "cuda", "cuda:0"):
        env = {"CUDA_VISIBLE_DEVICES": "0"}
        assert pg.guard_env(dict(env), platform) == env
        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0")
        assert pg.enforce_cpu_only(platform) is False
        assert os.environ["CUDA_VISIBLE_DEVICES"] == "0"
    assert pg.guard_env({"CUDA_VISIBLE_DEVICES": "0"}, "cpu") \
        == {"CUDA_VISIBLE_DEVICES": ""}
    assert pg.enforce_cpu_only("cpu") is True  # no CUDA initialized here
    assert os.environ["CUDA_VISIBLE_DEVICES"] == ""
    assert pg.cuda_initialized() is False


@pytest.mark.parametrize("name", ["procfleet", "election"])
def test_every_public_name_of_the_jax_module(name):
    """The port's module has every public name of its JAX counterpart
    (and the replica environment's names, letter for letter)."""
    import importlib

    jmod = importlib.import_module(f"minisched_tpu.fleet.{name}")
    tmod = importlib.import_module(f"minisched_tpu_torch.fleet.{name}")
    public = {n for n in vars(jmod) if not n.startswith("_")}
    envs = {n for n in vars(jmod) if n.startswith("_") and n.endswith("_ENV")}
    assert public <= set(vars(tmod))
    for n in envs:
        assert getattr(tmod, n) == getattr(jmod, n)

"""The port's in-process replicated fleet against the JAX package's.

Mirrors every test of tests/test_fleet.py on the port (engines on
``SchedulerConfig(platform="cpu")``): the shard map, the lease protocol
under racing claimants, a clean two-replica partition, a kill mid-burst
ending oracle-green, a restart that steals nothing, the lifecycle soak
over a kill and restart, and a fleet replica deciding what a single
engine decides. Then cross-package parity: ``shard_of`` on 10,000 keys,
one scripted lease sequence on an injected clock (held sets, epochs,
counters and store truth at every step), the shard-0 fleet's placements
(port fleet = JAX fleet = port single engine, bitwise, on stored pods)
and a refusing bind guard (the same stale-owner disposals, unassumes and
forgets in both engines).
"""
import threading
import time
import zlib

import pytest

from minisched_tpu import faults as jfaults
from minisched_tpu.fleet import lease as jlease
from minisched_tpu.fleet import shardmap as jshardmap
from minisched_tpu_torch import faults
from minisched_tpu_torch.config import SchedulerConfig
from minisched_tpu_torch.fleet import shardmap as tshardmap
from minisched_tpu_torch.fleet.lease import LeaseManager
from minisched_tpu_torch.fleet.shardmap import lease_name, shard_of
from minisched_tpu_torch.obs import journal as journal_mod
from minisched_tpu_torch.scenario.runner import Cluster, wait_until
from minisched_tpu_torch.service.defaultconfig import Profile
from minisched_tpu_torch.state import objects as obj
from minisched_tpu_torch.state.store import ClusterStore
from torch_obs_parity import JAX, PORT, disarm_all, placements
from torch_parity import BENCH_PROFILE, bench_cluster

FLEET_CONFIG = dict(platform="cpu", max_batch_size=16, batch_window_s=0.05,
                    batch_idle_s=0.02, backoff_initial_s=0.05,
                    backoff_max_s=0.2)

PROFILE = Profile(plugins=["NodeUnschedulable", "NodeResourcesFit",
                           "NodeResourcesLeastAllocated"])


@pytest.fixture(autouse=True)
def _disarmed():
    disarm_all()
    yield
    disarm_all()


def _pod(name, cpu=100):
    return obj.Pod(metadata=obj.ObjectMeta(name=name, namespace="default"),
                   spec=obj.PodSpec(requests={"cpu": cpu}))


def _wait_bound(cluster, n, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        placed = {p.metadata.name: p.spec.node_name
                  for p in cluster.list_pods() if p.spec.node_name}
        if len(placed) >= n:
            return placed
        time.sleep(0.02)
    raise AssertionError(
        f"only {len(placed)}/{n} pods bound within {timeout}s")


# ---- shard map -----------------------------------------------------------


def test_shard_map_is_deterministic_and_total():
    keys = [f"default/p{i}" for i in range(512)]
    for n in (1, 2, 4, 7):
        first = [shard_of(k, n) for k in keys]
        assert first == [shard_of(k, n) for k in keys]
        assert all(0 <= s < n for s in first)
        if n > 1:
            assert len(set(first)) == n
    crc = zlib.crc32(b"default/p0")
    assert shard_of("default/p0", 2) == crc % 2
    assert shard_of("default/p0", 4) == crc % 4


@pytest.mark.parametrize("n_shards", [1, 2, 3, 4, 7, 16])
def test_shard_of_matches_jax_package(n_shards):
    """The ownership function every party computes independently: the
    port's and the JAX package's agree on 10,000 keys."""
    keys = [f"ns{i % 7}/pod-{i}-{i * 2654435761 % 1000}"
            for i in range(10_000)]
    got = [tshardmap.shard_of(k, n_shards) for k in keys]
    assert got == [jshardmap.shard_of(k, n_shards) for k in keys]
    assert len(set(got)) == n_shards


def test_lease_names_are_per_shard():
    assert lease_name(0) == "shard-0"
    assert lease_name(7) == "shard-7"
    for fn in ("lease_name", "move_name"):
        for s in (0, 3, 15):
            assert getattr(tshardmap, fn)(s) == getattr(jshardmap, fn)(s)
    assert tshardmap.status_name("r2") == jshardmap.status_name("r2")
    assert tshardmap.steward_name() == jshardmap.steward_name()
    assert (tshardmap.incarnation_name("r2")
            == jshardmap.incarnation_name("r2"))


def test_env_knobs_match_jax_package(monkeypatch):
    """The fleet knobs read the same environment alike: defaults, floors
    and garbage."""
    cases = [("", ""), ("3", "0.4"), ("junk", "junk"), ("0", "0.001")]
    for n, ttl in cases:
        for env in (tshardmap.FLEET_ENV, tshardmap.SHARDS_ENV,
                    tshardmap.FLEET_PROC_ENV, tshardmap.FLEET_ELECT_ENV):
            monkeypatch.setenv(env, n)
        monkeypatch.setenv(tshardmap.LEASE_TTL_ENV, ttl)
        for fn, args in (("fleet_from_env", ()), ("shards_from_env", (2,)),
                         ("lease_ttl_from_env", ()),
                         ("fleet_proc_from_env", ()),
                         ("fleet_elect_from_env", ())):
            assert (getattr(tshardmap, fn)(*args)
                    == getattr(jshardmap, fn)(*args)), (fn, n, ttl)


# ---- lease protocol ------------------------------------------------------


def test_lease_epoch_monotone_under_concurrent_claimants():
    """Threads race try_acquire over repeated expiry rounds: each round
    exactly one claimant wins through the store's CAS and the epoch
    advances by exactly one."""
    store = ClusterStore()
    clk = [0.0]
    mgrs = [LeaseManager(store, f"r{i}", ttl_s=0.5, clock=lambda: clk[0])
            for i in range(4)]
    rounds = 6
    for rnd in range(rounds):
        clk[0] = rnd * 1.0
        wins = []
        barrier = threading.Barrier(len(mgrs))

        def claim(m):
            barrier.wait()
            if m.try_acquire(0):
                wins.append(m.replica)

        ts = [threading.Thread(target=claim, args=(m,)) for m in mgrs]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        lease = store.get("Lease", lease_name(0))
        assert lease.holder in [m.replica for m in mgrs]
        assert lease.epoch == rnd + 1, wins
        winner = next(m for m in mgrs if m.replica == lease.holder)
        assert winner.epoch_of(0) == lease.epoch
    acquires = sum(m.counters["acquires"] for m in mgrs)
    assert acquires == rounds


def test_lease_claim_lost_to_interleaved_peer_counts_conflict():
    store = ClusterStore()
    clk = [10.0]
    loser = LeaseManager(store, "rL", ttl_s=1.0, clock=lambda: clk[0])
    winner = LeaseManager(store, "rW", ttl_s=1.0, clock=lambda: clk[0])
    seed = LeaseManager(store, "r0", ttl_s=1.0, clock=lambda: 0.0)
    assert seed.try_acquire(0)
    stale = store.get("Lease", lease_name(0))
    assert winner.try_acquire(0)
    real_get = store.get
    store.get = lambda kind, name: stale
    try:
        assert loser.try_acquire(0) is False
    finally:
        store.get = real_get
    assert loser.counters["claim_conflicts"] == 1
    assert not loser.holds(0)
    truth = store.get("Lease", lease_name(0))
    assert (truth.holder, truth.epoch) == ("rW", 2)


def test_lease_renewal_keeps_epoch_fixed():
    store = ClusterStore()
    clk = [0.0]
    m = LeaseManager(store, "rA", ttl_s=5.0, clock=lambda: clk[0])
    assert m.try_acquire(3)
    for i in range(1, 4):
        clk[0] = float(i)
        assert m.renew(3)
        lease = store.get("Lease", lease_name(3))
        assert (lease.epoch, lease.renewed_at) == (1, float(i))
    assert m.counters["renewals"] == 3


def _lease_script(Store, Manager, registry):
    """One scripted sequence of two replicas' lease managers over three
    shards on an injected clock: first claims, a claim refused while the
    lease is live, renewals, an expiry and a takeover, the loser's
    renewal discovering it, a dropped and a stale heartbeat (the lease
    gate), a voluntary release and its claim, a crash's drop_all.
    Returns the trace of (held sets, counters, store truth) after each
    step."""
    store = Store()
    clk = [0.0]
    a = Manager(store, "rA", ttl_s=1.0, clock=lambda: clk[0])
    b = Manager(store, "rB", ttl_s=1.0, clock=lambda: clk[0])
    trace = []

    def step(label, result):
        truth = sorted((ls.key, ls.holder, ls.epoch, ls.renewed_at,
                        ls.ttl_s, ls.shard) for ls in store.list("Lease"))
        trace.append((label, result, sorted(a.held().items()),
                      sorted(b.held().items()), dict(a.counters),
                      dict(b.counters), truth))

    step("a0", a.try_acquire(0))
    step("a1", a.try_acquire(1))
    step("b1 live", b.try_acquire(1))
    step("b2", b.try_acquire(2))
    step("a0 again", a.try_acquire(0))
    clk[0] = 0.5
    step("a renew", a.renew_all())
    step("b renew 2", b.renew(2))
    clk[0] = 1.2
    step("b0 live", b.try_acquire(0))
    step("a renew 1", a.renew(1))
    clk[0] = 1.6
    step("b0 expired", b.try_acquire(0))
    step("a renew 0 lost", a.renew(0))
    step("b renew 0", b.renew(0))
    registry.configure("lease:err@1")
    step("a renew 1 dropped", a.renew(1))
    registry.configure("lease:corrupt@1")
    step("a renew 1 stale", a.renew(1))
    registry.configure("")
    step("a renew 1 clean", a.renew(1))
    step("a release 1", a.release(1))
    step("a release 1 again", a.release(1))
    step("b1 unheld", b.try_acquire(1))
    step("b epochs", (b.epoch_of(0), b.epoch_of(1), b.epoch_of(2)))
    b.drop_all()
    step("b drop_all", b.held())
    clk[0] = 5.0
    step("a0 after crash", a.try_acquire(0))
    step("a1 after crash", a.try_acquire(1))
    step("a epochs", (a.epoch_of(0), a.epoch_of(1), a.epoch_of(2)))
    return trace


def test_scripted_lease_sequence_matches_jax_package():
    from minisched_tpu.state.store import ClusterStore as JStore

    want = _lease_script(JStore, jlease.LeaseManager, jfaults)
    got = _lease_script(ClusterStore, LeaseManager, faults)
    for w, g in zip(want, got):
        assert g == w, g[0]
    assert len(got) == len(want) == 23
    assert got[-1][4] == {
        "renewals": 4, "heartbeats_dropped": 1,
        "stale_heartbeats_rejected": 1, "claim_conflicts": 0,
        "acquires": 4, "losses": 1, "releases": 1}
    assert got[-1][6] == [("shard-0", "rA", 3, 5.0, 1.0, 0),
                          ("shard-1", "rA", 3, 5.0, 1.0, 1),
                          ("shard-2", "rB", 1, 0.5, 1.0, 2)]


# ---- 2-replica clean run -------------------------------------------------


def test_two_replicas_partition_work_with_zero_cross_shard_binds():
    """Clean partition: every pod bound by the replica whose lease covers
    its shard (provenance's replica tag against the store-truth owner),
    no stale-owner disposals, no bind conflicts."""
    journal_mod.configure("1")
    c = Cluster()
    try:
        for i in range(8):
            c.create_node(f"n{i}", cpu=32000)
        c.start(profile=PROFILE, config=SchedulerConfig(**FLEET_CONFIG),
                with_pv_controller=False, fleet=2)
        fleet = c.service.fleet
        assert fleet is not None and fleet.n_shards == 2
        assert fleet.wait_converged(10.0)
        c.create_objects([_pod(f"p{i}") for i in range(80)])
        _wait_bound(c, 80)
        m = c.service.metrics()
        assert m["stale_owner_binds"] == 0
        assert m["bind_conflicts"] == 0
        by_shard = {0: 0, 1: 0}
        for p in c.list_pods():
            sh = shard_of(p.key, 2)
            rec = c.service.provenance(p.key)
            assert rec is not None and rec.get("replica"), p.key
            assert rec["replica"] == fleet.owner_of(sh), \
                f"{p.key} (shard {sh}) bound by {rec['replica']}"
            by_shard[sh] += 1
        assert by_shard[0] and by_shard[1]
    finally:
        c.shutdown()
        journal_mod.configure("")


# ---- kill / takeover -----------------------------------------------------


@pytest.mark.parametrize("crash", [False, True])
def test_kill_mid_batch_takeover_is_oracle_green(monkeypatch, crash):
    """Kill one replica mid-burst (the gentle stop, and the crash that
    abandons the engine after dropping its leases): every pod lands
    exactly once, the dead replica's shard is claimed within about one
    lease TTL, and the takeover is journaled."""
    monkeypatch.setenv("MINISCHED_LEASE_TTL", "0.4")
    journal_mod.configure("1")
    c = Cluster()
    try:
        for i in range(8):
            c.create_node(f"n{i}", cpu=32000)
        c.start(profile=PROFILE, config=SchedulerConfig(**FLEET_CONFIG),
                with_pv_controller=False, fleet=2)
        fleet = c.service.fleet
        assert fleet.wait_converged(10.0)
        c.create_objects([_pod(f"k{i}") for i in range(120)])
        time.sleep(0.05)
        assert fleet.kill("r1", crash=crash)
        placed = _wait_bound(c, 120)
        assert len(placed) == len(set(placed)) == 120
        assert fleet.wait_converged(10.0)
        assert fleet.owner_of(0) == fleet.owner_of(1) == "r0"
        m = fleet.metrics()
        assert m["fleet_takeovers"] >= 1
        assert m["fleet_replicas_live"] == 1
        evs = journal_mod.JOURNAL.entries()
        kills = [e for e in evs if e["kind"] == "fleet.kill"]
        takes = [e for e in evs if e["kind"] == "lease.takeover"]
        assert kills and takes
        assert kills[0]["crash"] is crash
        t_kill, tk = kills[0]["t"], takes[0]
        assert tk["frm"] == "r1" and tk["replica"] == "r0"
        assert tk["epoch"] >= 2
        assert tk["t"] - t_kill < 0.4 * 2 + 1.0
        if crash:
            assert any(e["kind"] == "engine.abandon"
                       and e["replica"] == "r1" for e in evs)
    finally:
        c.shutdown()
        journal_mod.configure("")


def test_restart_rejoins_without_stealing(monkeypatch):
    """A restarted replica comes back owning NOTHING and claws back no
    shard whose lease its peer keeps renewing."""
    ttl = 0.4
    monkeypatch.setenv("MINISCHED_LEASE_TTL", str(ttl))
    c = Cluster()
    try:
        for i in range(4):
            c.create_node(f"n{i}", cpu=32000)
        c.start(profile=PROFILE, config=SchedulerConfig(**FLEET_CONFIG),
                with_pv_controller=False, fleet=2)
        fleet = c.service.fleet
        assert fleet.wait_converged(10.0)
        assert fleet.kill("r1")
        assert wait_until(
            lambda: fleet.owner_of(0) == fleet.owner_of(1) == "r0",
            timeout=10, interval=0.05)
        assert fleet.restart("r1")
        time.sleep(ttl * 3)
        assert fleet.owner_of(0) == fleet.owner_of(1) == "r0"
        assert len(fleet.engines()) == 2
        assert fleet.replica_ids() == ["r0", "r1"]
        assert c.service.schedulers["r1"].shard_view == (
            2, frozenset(), 0)
    finally:
        c.shutdown()


def test_lifecycle_kill_restart_soak_holds_invariants(monkeypatch):
    """The lifecycle oracle over a fleet failover: Poisson arrivals with
    a replica killed mid-stream and restarted later, every default
    invariant checked after every step."""
    from minisched_tpu_torch.lifecycle import (LifecycleDriver,
                                               PoissonArrivals,
                                               RestartScheduler)

    monkeypatch.setenv("MINISCHED_LEASE_TTL", "0.4")
    c = Cluster()
    try:
        for i in range(8):
            c.create_node(f"n{i}", cpu=32000)
        c.start(profile=PROFILE, config=SchedulerConfig(**FLEET_CONFIG),
                with_pv_controller=False, fleet=2)
        assert c.service.fleet.wait_converged(10.0)
        d = LifecycleDriver(c, seed=7, pace=1.0, settle_s=10.0)
        d.add(PoissonArrivals("load", rate_pps=40, duration_s=2.5,
                              cpu=200, prefix="fo"))
        d.add(RestartScheduler("chaos", replica="r1", after_s=0.8,
                               downtime_s=1.0))
        d.install_default_invariants()
        d.run()
        assert d.view.counters.get("scheduler_kills") == 1
        assert d.view.counters.get("scheduler_restarts") == 1
        assert d.settle(timeout=30)
        d.check_invariants()
        assert c.service.fleet.metrics()["fleet_takeovers"] >= 1
    finally:
        c.shutdown()


def test_fleet_generators_are_noops_without_a_fleet():
    """KillScheduler and RestartScheduler degrade to no-ops on a single
    engine, so a mix that holds them stays usable outside fleet mode."""
    from minisched_tpu_torch.lifecycle import (KillScheduler,
                                               LifecycleDriver,
                                               RestartScheduler)

    c = Cluster()
    try:
        c.start(profile=PROFILE, config=SchedulerConfig(**FLEET_CONFIG),
                with_pv_controller=False)
        assert c.service.fleet is None
        d = LifecycleDriver(c, seed=1)
        d.add(KillScheduler(after_s=0.0, crash=True))
        d.add(RestartScheduler(after_s=0.0, downtime_s=0.0))
        d.run()
        assert not d.view.counters
        assert c.service.scheduler is not None
    finally:
        c.shutdown()


# ---- decision determinism ------------------------------------------------


def test_fleet_replica_decisions_match_single_engine_run():
    """Sharding changes WHO schedules, never WHAT is decided: a replica's
    placements over its shard are the single engine's on the same
    pods."""
    names = [f"d{i}" for i in range(200)
             if shard_of(f"default/d{i}", 2) == 0][:24]
    assert len(names) == 24
    cfg = dict(platform="cpu", max_batch_size=64, batch_window_s=0.3,
               batch_idle_s=0.1, backoff_initial_s=0.05, backoff_max_s=0.2)

    def run(fleet):
        c = Cluster()
        try:
            for i, cpu in enumerate((64000, 48000, 32000)):
                c.create_node(f"n{i}", cpu=cpu)
            c.start(profile=PROFILE, config=SchedulerConfig(**cfg),
                    with_pv_controller=False, fleet=fleet)
            c.create_objects([_pod(n, cpu=100 + 13 * i)
                              for i, n in enumerate(names)])
            return _wait_bound(c, len(names))
        finally:
            c.shutdown()

    solo = run(None)
    fleet = run(2)
    assert fleet == solo


def _shard0_run(pkg, fleet):
    """bench_cluster's pods of shard 0 (of 2) stored before the engines
    start, one batch: the replica owning shard 0 gathers all of them at
    its informer's first sync. Returns (placements, metrics, per-replica
    metrics)."""
    nodes, pods = bench_cluster(pkg.O, 120, 300, seed=2)
    pods = [p for p in pods if shard_of(p.key, 2) == 0][:96]
    c = pkg.Cluster()
    c.create_objects(nodes)
    c.create_objects(pods)
    c.start(pkg.Profile(**BENCH_PROFILE),
            pkg.config(max_batch_size=128, seed=3),
            with_pv_controller=False, fleet=fleet)
    try:
        assert wait_until(
            lambda: all(p.spec.node_name for p in c.list_pods()),
            timeout=90)
        assert wait_until(
            lambda: c.service.metrics()["pods_assigned"] >= len(pods),
            timeout=30)
        per = {rid: e.metrics() for rid, e in c.service.schedulers.items()}
        return placements(c), c.service.metrics(), per
    finally:
        c.shutdown()


def test_shard0_fleet_placements_match_jax_fleet_and_single_engine():
    """One replica owns every pod: the port's fleet places them bitwise
    as the JAX package's fleet and as the port's single engine; r1 sees
    no pod and books no batch; nothing is fenced or conflicted."""
    solo, _sm, _ = _shard0_run(PORT, None)
    got, m, per = _shard0_run(PORT, 2)
    want, jm, _ = _shard0_run(JAX, 2)
    assert got == want == solo
    assert len(got) == 96
    assert per["r1"]["batches"] == per["r1"]["pods_seen"] == 0
    assert per["r0"]["pods_bound"] == 96
    assert m["stale_owner_binds"] == jm["stale_owner_binds"] == 0
    assert m["bind_conflicts"] == jm["bind_conflicts"] == 0
    assert m["fleet_shards"] == jm["fleet_shards"] == 2
    assert m["fleet_replicas_live"] == jm["fleet_replicas_live"] == 2


def _guarded_run(pkg, refuse):
    """One engine over bench_cluster's stored pods with a bind guard that
    refuses ``refuse``: returns the stale-owner count, the store's
    placements, the cache's assigned count and free rows, and whether
    each refused pod left the queue's known set."""
    nodes, pods = bench_cluster(pkg.O, 120, 64, seed=4)
    c = pkg.Cluster()
    c.create_objects(nodes)
    c.create_objects(pods)
    orig_start = pkg.scheduler.Scheduler.start

    def guarded_start(self):
        self.set_bind_guard(lambda key: key not in refuse)
        orig_start(self)

    pkg.scheduler.Scheduler.start = guarded_start
    try:
        c.start(pkg.Profile(**BENCH_PROFILE),
                pkg.config(max_batch_size=64, seed=5),
                with_pv_controller=False)
    finally:
        pkg.scheduler.Scheduler.start = orig_start
    try:
        sched = c.service.scheduler

        def done():
            m = sched.metrics()
            return m["pods_bound"] + m["stale_owner_binds"] >= len(pods)

        assert wait_until(done, timeout=90)
        time.sleep(0.2)
        m = sched.metrics()
        free = {n.metadata.name: sched.cache.free_of(n.metadata.name)
                .tolist() for n in nodes}
        return (m["stale_owner_binds"], m["pods_bound"], placements(c),
                sched.cache.assigned_count(), free,
                [k in sched.queue._known for k in sorted(refuse)])
    finally:
        c.shutdown()


def test_refusing_bind_guard_matches_jax_engine():
    """A bind fence that refuses a fifth of the batch: both engines
    dispose of the same pods (stale_owner_binds), bind the same others
    to the same nodes, unassume the refused pods' capacity and forget
    them from the queue."""
    _nodes, pods = bench_cluster(PORT.O, 120, 64, seed=4)
    refuse = {p.key for i, p in enumerate(pods) if i % 5 == 1}
    got = _guarded_run(PORT, refuse)
    want = _guarded_run(JAX, refuse)
    assert got == want
    stale, bound, placed, assigned, _free, known = got
    assert stale == len(refuse) and bound == len(pods) - len(refuse)
    assert {k for k, n in placed.items() if not n} == refuse
    assert assigned == bound
    assert not any(known)


def test_fleet_seams_cost_nothing_without_a_fleet():
    """A solo engine's shard view is the off tuple, it takes every pod
    its profile routes, and its metrics carry stale_owner_binds at 0."""
    from minisched_tpu_torch.engine.scheduler import Scheduler

    eng = Scheduler(ClusterStore(), PROFILE.build(),
                    SchedulerConfig(platform="cpu"))
    try:
        assert eng.shard_view == (0, frozenset(), 0)
        assert eng._bind_guard is None
        assert eng.wants_pod(_pod("any"))
        assert eng.metrics()["stale_owner_binds"] == 0
        eng.set_shards({1}, 2, epoch=3)
        assert eng.shard_view == (2, frozenset({1}), 3)
        keys = [f"default/s{i}" for i in range(64)]
        assert [eng.wants_pod(_pod(k.split("/")[1])) for k in keys] == [
            shard_of(k, 2) == 1 for k in keys]
    finally:
        eng.shutdown()


def test_service_routes_through_the_fleet(monkeypatch):
    """MINISCHED_FLEET starts a fleet: the service's scheduler,
    schedulers, metrics, histograms and provenance answer through it;
    several profiles are refused; a restart keeps the fleet."""
    from minisched_tpu_torch.service.service import SchedulerService

    monkeypatch.setenv("MINISCHED_FLEET", "2")
    svc = SchedulerService(ClusterStore())
    with pytest.raises(ValueError, match="single-profile"):
        svc.start_scheduler([Profile(name="a", plugins=PROFILE.plugins),
                             Profile(name="b", plugins=PROFILE.plugins)],
                            SchedulerConfig(**FLEET_CONFIG))
    assert svc.fleet is None and svc.scheduler is None
    svc.start_scheduler(PROFILE, SchedulerConfig(**FLEET_CONFIG))
    try:
        fleet = svc.fleet
        assert fleet is not None and fleet.n_replicas == 2
        assert sorted(svc.schedulers) == ["r0", "r1"]
        assert svc.scheduler is svc.schedulers["r0"]
        assert svc.scheduler.replica == "r0"
        m = svc.metrics()
        for key in ("fleet_replicas_live", "fleet_takeovers",
                    "fleet_shards", "lease_renewals", "lease_acquires",
                    "stale_owner_binds", "pods_bound"):
            assert key in m, key
        assert set(svc.metrics_histograms()) == set(
            svc.scheduler.metrics()["histograms"])
        assert svc.provenance("default/none") is None
        svc.restart_scheduler()
        assert svc.fleet is not None and svc.fleet is not fleet
        assert sorted(svc.schedulers) == ["r0", "r1"]
    finally:
        svc.shutdown_scheduler()
    assert svc.fleet is None and svc.scheduler is None

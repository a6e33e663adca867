"""The port's lifecycle scenario engine against the JAX package's.

Mirrors every test of tests/test_lifecycle.py on the port (live runs on
``SchedulerConfig(platform="cpu")``): seed determinism in pure mode, the
generators' invariants on clean live runs, the facade verbs through the
informer-observed path, the faulted churn, the adversarial budget
overlap, the oracle's own detectors and the steward and API server
drills. Then cross-package parity: for one seed the composed pure-mode
mix gives the same event lines, stream digest and state digest in both
packages (so the port's store snapshot and object defaults are the JAX
ones), and every invariant returns the same violations on the same
hand-made view.
"""
import os
import time
from types import SimpleNamespace

import pytest

from minisched_tpu import faults as jfaults
from minisched_tpu import lifecycle as jlc
from minisched_tpu.scenario import Cluster as JCluster
from minisched_tpu.state import objects as JO
from minisched_tpu_torch import faults
from minisched_tpu_torch import lifecycle as tlc
from minisched_tpu_torch.config import SchedulerConfig
from minisched_tpu_torch.lifecycle import (AutoscalerLoop, InvariantViolation,
                                           LifecycleDriver, PoissonArrivals,
                                           ReclamationWave, RollingUpgrade,
                                           StewardUniqueness, TenantMix,
                                           seed_from_env)
from minisched_tpu_torch.lifecycle import invariants as tinv
from minisched_tpu_torch.scenario.runner import Cluster
from minisched_tpu_torch.service.defaultconfig import Profile
from minisched_tpu_torch.state import objects as TO
from torch_obs_parity import disarm_all

SEED = seed_from_env()


@pytest.fixture(autouse=True)
def _disarmed():
    disarm_all()
    yield
    disarm_all()


def pure_cluster() -> Cluster:
    """A Cluster with NO engine attached: the store is mutated only by
    the driver, so generator output is a pure function of the seed."""
    return Cluster()


def make_composed_driver(cluster, seed, *, pace=0.0, settle_s=0.0,
                         duration=3.0, lc=tlc):
    """tests/test_lifecycle.py's standard composition (arrivals and
    tenants over an autoscaling pool with reclamation and a rolling
    upgrade sharing one budget) from either package's ``lifecycle``."""
    d = lc.LifecycleDriver(cluster, seed=seed, pace=pace, settle_s=settle_s)
    budget = d.budget("base", max_unavailable=2)
    for _ in range(8):
        d.view.create_pool_node("base", cpu=2000)
    d.add(lc.PoissonArrivals("arrivals", rate_pps=30, duration_s=duration,
                             amplitude=0.6, period_s=duration / 2,
                             prefix="lc"))
    d.add(lc.TenantMix("tenants", rate_pps=10, duration_s=duration,
                       prefix="tm"))
    d.add(lc.AutoscalerLoop("autoscaler", pool="as", interval_s=0.25,
                            min_nodes=2, max_nodes=6, scale_up_pending=10,
                            idle_rounds=2, cpu=2000, drain_grace_s=0.2))
    d.add(lc.ReclamationWave("reclaim", pool="base", interval_s=1.0,
                             wave_frac=0.25, grace_s=0.2, waves=2,
                             budget=budget))
    d.add(lc.RollingUpgrade("upgrade", pool="base", budget=budget,
                            grace_s=0.2, retry_s=0.1, start_after_s=0.3))
    d.install_default_invariants()
    return d, budget


# ---- seed determinism (pure mode) ----------------------------------------


def _pure_run(seed, cluster_cls=Cluster, lc=tlc):
    d, _b = make_composed_driver(cluster_cls(), seed, lc=lc)
    d.run(until_s=6.0)
    return d


def test_same_seed_byte_identical_stream_and_state():
    a = _pure_run(SEED)
    b = _pure_run(SEED)
    assert a.event_lines(), "composition generated no events"
    assert a.event_lines() == b.event_lines()
    assert a.stream_digest() == b.stream_digest()
    assert a.state_digest() == b.state_digest()
    counters = a.view.counters
    assert counters.get("pods_created", 0) > 20
    assert counters.get("nodes_reclaimed", 0) >= 1
    assert counters.get("nodes_upgraded", 0) >= 1


def test_different_seed_diverges():
    a = _pure_run(SEED)
    b = _pure_run(SEED + 1)
    assert a.stream_digest() != b.stream_digest()


def test_generator_stream_independence():
    """Adding a generator must not shift another's draws: the
    arrivals-only prefix of a composed run matches a solo arrivals run
    event for event."""
    def arrivals_events(compose):
        d = LifecycleDriver(pure_cluster(), seed=SEED)
        d.add(PoissonArrivals("arrivals", rate_pps=30, duration_s=2.0,
                              prefix="ind"))
        if compose:
            d.add(TenantMix("tenants", rate_pps=15, duration_s=2.0,
                            prefix="ind-tm"))
        d.run()
        return [e.line() for e in d.events if e.gen == "arrivals"]

    assert arrivals_events(False) == arrivals_events(True)


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_pure_mode_matches_jax_package(seed):
    """One seed, both packages: byte-identical event lines, the same
    stream digest and the same canonical state digest (the port's store
    snapshot and object defaults are the JAX package's)."""
    want = _pure_run(seed, JCluster, jlc)
    got = _pure_run(seed, Cluster, tlc)
    assert got.event_lines() == want.event_lines()
    assert got.stream_digest() == want.stream_digest()
    assert got.state_digest() == want.state_digest()
    assert got.view.counters == want.view.counters
    assert got.steps == want.steps
    assert got.invariant_checks == want.invariant_checks


def test_fault_gate_stream_matches_jax_package():
    """The lifecycle gate fires at the same steps in both packages, so
    a faulted pure run shifts both streams alike (``err`` retries, a
    ``corrupt`` burns one draw)."""
    spec = "lifecycle:err@3,lifecycle:corrupt@5,lifecycle:err@9"

    def run(cluster_cls, lc, registry):
        d = lc.LifecycleDriver(cluster_cls(), seed=SEED)
        d.add(lc.PoissonArrivals("arrivals", rate_pps=50, duration_s=1.0,
                                 prefix="fg"))
        d.add(lc.TenantMix("tenants", rate_pps=20, duration_s=1.0,
                           prefix="fgt"))
        registry.configure(spec)
        try:
            d.run()
        finally:
            registry.configure("")
        return d

    want = run(JCluster, jlc, jfaults)
    got = run(Cluster, tlc, faults)
    assert got.faulted_steps == want.faulted_steps == 2
    assert got.event_lines() == want.event_lines()
    assert got.state_digest() == want.state_digest()


# ---- invariants on clean live runs ---------------------------------------


def live_cluster(**cfg_kw) -> Cluster:
    c = Cluster()
    cfg = SchedulerConfig(platform="cpu", backoff_initial_s=0.05,
                          backoff_max_s=0.2, max_batch_size=64, **cfg_kw)
    c.start(profile=Profile(plugins=["NodeUnschedulable",
                                     "NodeResourcesFit",
                                     "NodeResourcesLeastAllocated",
                                     "DefaultPreemption"]),
            config=cfg, with_pv_controller=False)
    return c


def test_clean_composed_live_run_holds_invariants():
    """The full composition against the port's engine: every invariant
    holds after every event, the cluster settles, nothing degrades."""
    c = live_cluster()
    try:
        d, budget = make_composed_driver(c, SEED, pace=1.0, settle_s=8.0,
                                         duration=2.5)
        d.run(until_s=2.5)
        assert d.settle(timeout=30), "cluster never settled after churn"
        d.check_invariants()
        m = c.service.scheduler.metrics()
        assert m["pods_bound"] > 0
        assert m["degradation_state"] == "resident"
        assert sum(v for k, v in m.items()
                   if k.startswith("fault_fires_")) == 0
        assert budget.high_water <= 2
    finally:
        c.shutdown()


class _BatchJob:
    """A fixed burst of finite-lifetime pods (a job): created, held, then
    deleted, so the autoscaler sees pressure and then real idleness."""

    name = "batchjob"

    def __init__(self, n=12, cpu=600, hold_s=2.0, prefix="asq"):
        self.n, self.cpu, self.hold, self.prefix = n, cpu, hold_s, prefix

    def run(self, env):
        for i in range(self.n):
            env.view.create_pod(f"{self.prefix}-{i}", cpu=self.cpu)
            yield 0.01
        yield self.hold
        for p in sorted(env.view.store.list("Pod"), key=lambda p: p.key):
            if p.metadata.name.startswith(self.prefix):
                env.view.delete_pod(p.key)
        yield 0.01


def test_autoscaler_grows_under_pressure_and_drains_idle():
    c = live_cluster()
    try:
        d = LifecycleDriver(c, seed=SEED, pace=1.0, settle_s=8.0)
        d.add(_BatchJob(n=12, cpu=600, hold_s=2.0))
        d.add(AutoscalerLoop("autoscaler", pool="as", interval_s=0.15,
                             min_nodes=1, max_nodes=8, scale_up_pending=2,
                             idle_rounds=2, cpu=2000, drain_grace_s=0.15,
                             rounds=45))
        d.install_default_invariants()
        d.run()
        assert d.view.counters.get("autoscaler_scale_ups", 0) >= 1, \
            "pressure never triggered a scale-up"
        assert d.view.counters.get("autoscaler_scale_downs", 0) >= 1, \
            "idleness never triggered a drain"
        assert d.settle(timeout=30)
        d.check_invariants()
    finally:
        c.shutdown()


def test_reclamation_wave_evicts_and_replaces():
    c = live_cluster()
    try:
        d = LifecycleDriver(c, seed=SEED, pace=1.0, settle_s=8.0)
        for _ in range(6):
            d.view.create_pool_node("spot", cpu=2000)
        d.add(PoissonArrivals("load", rate_pps=60, duration_s=0.8,
                              cpu=300, prefix="rw"))
        d.add(ReclamationWave("reclaim", pool="spot", interval_s=1.0,
                              wave_frac=0.4, grace_s=0.3, waves=2))
        d.install_default_invariants()
        d.run()
        assert d.view.counters.get("nodes_reclaimed", 0) >= 2
        assert d.settle(timeout=30)
        d.check_invariants()
        assert len(d.view.pool_nodes("spot")) == 6
    finally:
        c.shutdown()


# ---- facade verbs through the informer-observed path ---------------------


def test_cordon_blocks_then_uncordon_revives():
    c = live_cluster()
    try:
        c.create_node("only", cpu=1000)
        c.create_pod("cp-wait", cpu=100)
        c.wait_for_pod_bound("cp-wait", timeout=30)
        c.cordon("only")
        c.create_pod("cp-blocked", cpu=100)
        pod = c.wait_for_pod_pending("cp-blocked", timeout=15)
        assert "NodeUnschedulable" in pod.status.unschedulable_plugins
        c.uncordon("only")
        c.wait_for_pod_bound("cp-blocked", timeout=15)
    finally:
        c.shutdown()


def test_drain_evicts_bound_pods():
    c = live_cluster()
    try:
        c.create_node("dr-n", cpu=1000)
        for i in range(3):
            c.create_pod(f"dr-p{i}", cpu=100)
            c.wait_for_pod_bound(f"dr-p{i}", timeout=30)
        evicted = c.drain("dr-n")
        assert sorted(p.metadata.name for p in evicted) == [
            "dr-p0", "dr-p1", "dr-p2"]
        assert c.get_node("dr-n").spec.unschedulable
        assert not c.list_pods()
    finally:
        c.shutdown()


def test_update_node_allocatable_growth_revives_capacity_parked_pod():
    c = live_cluster()
    try:
        c.create_node("small", cpu=100)
        c.create_pod("big", cpu=500)
        c.wait_for_pod_pending("big", timeout=15)
        c.update_node("small", allocatable={"cpu": 1000.0})
        c.wait_for_pod_bound("big", timeout=15)
    finally:
        c.shutdown()


def test_narrowing_update_does_not_thrash_unschedulable_queue():
    c = live_cluster()
    try:
        c.create_node("full", cpu=100)
        c.create_node("other", cpu=100)
        c.create_pod("stuck", cpu=5000)
        c.wait_for_pod_pending("stuck", timeout=15)
        q = c.service.scheduler.queue
        deadline = time.monotonic() + 10
        while q.stats()["unschedulable"] != 1 \
                and time.monotonic() < deadline:
            time.sleep(0.02)
        assert q.stats()["unschedulable"] == 1
        moves_before = q.stats()["moves"]
        c.cordon("other")
        time.sleep(0.3)
        st = q.stats()
        assert st["unschedulable"] == 1, "narrowing update revived a pod"
        assert st["moves"] == moves_before, \
            "narrowing update reached the requeue fan-out"
        c.update_node("other", allocatable={"cpu": 50000.0},
                      unschedulable=False)
        c.wait_for_pod_bound("stuck", timeout=15)
    finally:
        c.shutdown()


# ---- faulted churn: compose both registries ------------------------------


AMBIENT = ("step:err@2,step:err@0.05,fetch:corrupt@0.03,"
           "residency:corrupt@0.03,commit:err@0.05,bind:err@0.03,"
           "lifecycle:err@0.05")


def test_faulted_churn_recovers_with_zero_violations():
    """The port's fault registry composed with the lifecycle gate: the
    deterministic step:err@2 guarantees an escalation; every invariant
    holds, the churn settles once faults stop, and a probation pump
    climbs the engine back to the full fast path."""
    c = live_cluster(resident_check_every=1, probation_batches=2)
    sched = c.service.scheduler
    try:
        d, _budget = make_composed_driver(c, SEED, pace=1.0, settle_s=8.0,
                                          duration=2.0)
        faults.FAULTS.reset_counts()
        faults.configure(AMBIENT,
                         int(os.environ.get("MINISCHED_FAULT_SEED", "0")))
        d.run(until_s=2.0)
        fired = sum(faults.FAULTS.counts().values())
        faults.configure("")
        assert fired >= 1, "ambient schedule never fired"
        assert d.settle(timeout=45), "faulted churn never settled"
        d.check_invariants()
        m = sched.metrics()
        assert m["supervisor_escalations"] >= 1, \
            "the ladder was never exercised"
        deadline = time.monotonic() + 30
        i = 0
        while (sched.metrics()["degradation_state"] != "resident"
               and time.monotonic() < deadline):
            for j in range(6):
                d.view.create_pod(f"pump-{i}-{j}", cpu=10)
            i += 1
            d.settle(timeout=10)
        assert sched.metrics()["degradation_state"] == "resident", \
            "engine never recovered to the full fast path"
        d.check_invariants()
    finally:
        faults.configure("")
        c.shutdown()


def test_lifecycle_fault_gate_skips_and_retries_steps():
    d = LifecycleDriver(pure_cluster(), seed=SEED)
    d.add(PoissonArrivals("arrivals", rate_pps=50, duration_s=1.0,
                          prefix="fg"))
    faults.configure("lifecycle:err@3,lifecycle:err@7")
    try:
        d.run()
    finally:
        faults.configure("")
    assert d.faulted_steps == 2
    assert d.view.counters.get("pods_created", 0) > 10


# ---- adversarial PDB overlap ---------------------------------------------


def test_pdb_never_violated_under_adversarial_upgrade_reclaim_overlap():
    d = LifecycleDriver(pure_cluster(), seed=SEED)
    budget = d.budget("base", max_unavailable=2)
    for _ in range(10):
        d.view.create_pool_node("base", cpu=2000)
    d.add(ReclamationWave("reclaim", pool="base", interval_s=0.2,
                          wave_frac=0.5, grace_s=0.3, waves=6,
                          budget=budget))
    d.add(RollingUpgrade("upgrade", pool="base", budget=budget,
                         grace_s=0.3, retry_s=0.05))
    d.install_default_invariants()
    d.run(until_s=30.0)
    assert budget.denials > 0, \
        "no contention: the adversarial overlap never happened"
    assert budget.high_water <= 2
    assert d.view.counters.get("nodes_reclaimed", 0) >= 1
    assert d.view.counters.get("nodes_upgraded", 0) >= 1
    d.check_invariants()


def test_budget_invariant_detects_violation():
    d = LifecycleDriver(pure_cluster(), seed=SEED)
    d.budget("base", max_unavailable=1)
    for _ in range(3):
        d.view.create_pool_node("base", cpu=1000)
    d.install_default_invariants()
    for n in d.view.pool_nodes("base")[:2]:
        d.view.cordon(n)
    with pytest.raises(InvariantViolation, match="disruption_budget"):
        d.check_invariants()


def test_no_pod_lost_invariant_detects_silent_loss():
    c = pure_cluster()
    d = LifecycleDriver(c, seed=SEED)
    d.install_default_invariants()
    d.view.create_pod("will-vanish")
    d.check_invariants()
    c.store.delete("Pod", "default/will-vanish")
    with pytest.raises(InvariantViolation, match="no_pod_lost"):
        d.check_invariants()


def test_violation_is_journaled_before_it_raises():
    """check_invariants notes ``invariant.violation`` in the port's
    journal (and tags the timeline) before the raise unwinds the run."""
    from minisched_tpu_torch.obs import journal

    journal.configure("1")
    c = pure_cluster()
    d = LifecycleDriver(c, seed=SEED)
    d.install_default_invariants()
    d.view.create_pod("gone")
    c.store.delete("Pod", "default/gone")
    with pytest.raises(InvariantViolation):
        d.check_invariants()
    notes = [e for e in journal.JOURNAL.entries()
             if e["kind"] == "invariant.violation"]
    assert len(notes) == 1 and notes[0]["invariant"] == "no_pod_lost"
    assert notes[0]["seed"] == SEED and notes[0]["count"] == 1


# ---- self-governing fleet drills -----------------------------------------


def test_steward_uniqueness_invariant_detects_bumpless_swap():
    c = pure_cluster()
    d = LifecycleDriver(c, seed=SEED)
    inv = StewardUniqueness()
    assert inv(d.view) == []
    c.store.create(TO.Lease(
        metadata=TO.ObjectMeta(name="steward"), holder="pa",
        epoch=3, ttl_s=30.0, renewed_at=time.monotonic(), shard=-1))
    assert inv(d.view) == []
    lease = c.store.get("Lease", "steward")
    lease.holder = "pb"
    c.store.update(lease)
    viols = inv(d.view)
    assert viols and "without an epoch bump" in viols[0]


def test_steward_uniqueness_invariant_detects_epoch_regression():
    c = pure_cluster()
    d = LifecycleDriver(c, seed=SEED)
    inv = StewardUniqueness()
    c.store.create(TO.Lease(
        metadata=TO.ObjectMeta(name="steward"), holder="pa",
        epoch=5, ttl_s=30.0, renewed_at=time.monotonic(), shard=-1))
    assert inv(d.view) == []
    lease = c.store.get("Lease", "steward")
    lease.epoch = 2
    c.store.update(lease)
    viols = inv(d.view)
    assert viols and "regressed" in viols[0]


def test_steward_uniqueness_invariant_detects_duplicate_crowns():
    c = pure_cluster()
    d = LifecycleDriver(c, seed=SEED)
    d.install_default_invariants()
    c.store.create(TO.Lease(
        metadata=TO.ObjectMeta(name="steward"), holder="pa",
        epoch=3, ttl_s=30.0, renewed_at=time.monotonic(), shard=-1))
    d.check_invariants()
    c.store.create(TO.Lease(
        metadata=TO.ObjectMeta(name="steward-shadow"), holder="pb",
        epoch=1, ttl_s=30.0, renewed_at=time.monotonic(), shard=-1))
    with pytest.raises(InvariantViolation, match="steward_uniqueness"):
        d.check_invariants()


def test_kill_steward_generator_kills_store_truth_steward():
    """KillSteward resolves the victim from the store alone (steward
    Lease, then the ReplicaStatus pid) and SIGKILLs it. A sleeping
    subprocess stands in for the steward replica."""
    import signal
    import subprocess
    import sys

    from minisched_tpu_torch.lifecycle import KillSteward

    proc = subprocess.Popen([sys.executable, "-c",
                             "import time; time.sleep(300)"])
    try:
        c = pure_cluster()
        d = LifecycleDriver(c, seed=SEED)
        c.store.create(TO.Lease(
            metadata=TO.ObjectMeta(name="steward"), holder="px",
            epoch=1, ttl_s=30.0, renewed_at=time.monotonic(), shard=-1))
        c.store.create(TO.ReplicaStatus(
            metadata=TO.ObjectMeta(name="replica-px"), pid=proc.pid,
            ready=True, renewed_at=time.time()))
        d.add(KillSteward(after_s=0.0))
        d.run(until_s=0.5)
        assert proc.wait(timeout=10) == -signal.SIGKILL
        assert d.view.counters.get("steward_kills") == 1
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait()


def test_kill_steward_generator_noop_without_election():
    from minisched_tpu_torch.lifecycle import KillSteward

    d = LifecycleDriver(pure_cluster(), seed=SEED)
    d.add(KillSteward(after_s=0.0))
    d.run(until_s=0.3)
    assert "steward_kills" not in d.view.counters


def test_restart_apiserver_generator_revives_same_port():
    """RestartApiserver kills the port's API server and revives it on
    the SAME port over the SAME store: a client that rides the outage
    out sees the same state on the other side."""
    from minisched_tpu_torch.apiserver import APIServer, RemoteStore
    from minisched_tpu_torch.lifecycle import RestartApiserver
    from minisched_tpu_torch.state.store import ClusterStore

    backing = ClusterStore()
    backing.create(TO.Node(metadata=TO.ObjectMeta(name="nx")))
    srv = APIServer(backing).start()
    port = srv.port
    revived = []
    try:
        d = LifecycleDriver(pure_cluster(), seed=SEED)
        d.add(RestartApiserver(server=srv, after_s=0.0, outage_s=0.2,
                               on_restart=revived.append))
        d.run(until_s=2.0)
        assert d.view.counters.get("apiserver_outages") == 1
        assert d.view.counters.get("apiserver_revivals") == 1
        assert len(revived) == 1 and revived[0].port == port
        assert type(revived[0]) is APIServer
        rs = RemoteStore(revived[0].address, retry_deadline_s=0.5)
        assert rs.get("Node", "nx").metadata.name == "nx"
    finally:
        for s in revived:
            s.shutdown()
        if not revived:
            srv.shutdown()


# ---- the oracle, check by check, against the JAX package -----------------


class _View:
    """A hand-made invariant view: a store that lists fixed objects and
    reports a fixed resource version, and the ledgers no_pod_lost
    reads."""

    def __init__(self, objects, rv, expected=(), deleted=(),
                 preempted_events=()):
        self.store = SimpleNamespace(
            list=lambda kind: list(objects.get(kind, ())),
            resource_version=lambda: rv)
        self.expected_pods = set(expected)
        self.deleted_pods = set(deleted)
        self.preempted_pods = set()
        self._events = set(preempted_events)

    def preempted_event_keys(self):
        return set(self._events)

    def note_preempted(self, key):
        if key in self.expected_pods:
            self.expected_pods.discard(key)
            self.preempted_pods.add(key)


def _views(O):
    """Two hand-made states in a row (stateful checks compare the second
    against the first): pods bound to a missing node and past a node's
    allocatable, a lost and a resurrected pod, a pod rebound, versions
    regressed, a shard lease's holder swapped without an epoch bump and
    another's epoch regressed, two steward crowns."""
    def node(name, cpu, pool="", cordoned=False, rv=1):
        return O.Node(
            metadata=O.ObjectMeta(name=name, resource_version=rv,
                                  labels={"minisched.io/pool": pool}
                                  if pool else {}),
            spec=O.NodeSpec(unschedulable=cordoned),
            status=O.NodeStatus(allocatable={"cpu": float(cpu),
                                             "pods": 110.0}))

    def pod(name, node_name="", cpu=100, uid="", rv=1):
        return O.Pod(metadata=O.ObjectMeta(name=name, namespace="default",
                                           uid=uid or f"u-{name}",
                                           resource_version=rv),
                     spec=O.PodSpec(node_name=node_name,
                                    requests={"cpu": float(cpu)}))

    def lease(name, holder, epoch, shard):
        return O.Lease(metadata=O.ObjectMeta(name=name), holder=holder,
                       epoch=epoch, ttl_s=2.0, renewed_at=0.0, shard=shard)

    first = _View({
        "Node": [node("a", 1000, "p", True), node("b", 500, "p", True),
                 node("c", 500, "p")],
        "Pod": [pod("x", "a", uid="ux", rv=4), pod("y", "b", 300),
                pod("z", "b", 300), pod("w")],
        "Lease": [lease("shard-0", "r0", 1, 0), lease("shard-1", "r1", 3, 1),
                  lease("steward", "s0", 2, -1)],
    }, rv=40, expected={"default/x", "default/y", "default/z", "default/w",
                        "default/gone", "default/evicted"},
        deleted={"default/old"}, preempted_events={"default/evicted"})
    second = _View({
        "Node": [node("a", 1000, "p", True, rv=1)],
        "Pod": [pod("x", "c", uid="ux", rv=2), pod("old"),
                pod("q", "nowhere")],
        "Lease": [lease("shard-0", "r1", 1, 0), lease("shard-1", "r1", 2, 1),
                  lease("steward", "s1", 2, -1),
                  lease("steward-2", "s2", 1, -1)],
    }, rv=30, expected={"default/x"}, deleted={"default/old"})
    return first, second


def _checks(inv, budget):
    return [("no_pod_lost", inv.no_pod_lost),
            ("bound_on_live_nodes", inv.bound_on_live_nodes),
            ("monotone_versions", inv.MonotoneVersions()),
            ("no_overcommit", inv.no_overcommit),
            ("stable_bindings", inv.StableBindings()),
            ("lease_integrity", inv.LeaseIntegrity()),
            ("steward_uniqueness", inv.StewardUniqueness()),
            ("disruption_budget", inv.budget_respected(budget))]


@pytest.mark.parametrize("check", [name for name, _ in _checks(
    tinv, tlc.DisruptionBudget("p", 1))])
def test_invariant_violations_match_jax_package(check):
    """Each check of the default oracle returns the same violation list
    as the JAX package's on the same two hand-made states, and leaves
    the view's ledgers alike."""
    from minisched_tpu.lifecycle import invariants as jinv

    out = {}
    for name, inv, lc, O in (("jax", jinv, jlc, JO), ("port", tinv, tlc, TO)):
        budget = lc.DisruptionBudget("p", 1)
        budget.high_water = 2
        fn = dict(_checks(inv, budget))[check]
        views = _views(O)
        out[name] = ([fn(v) for v in views],
                     [(sorted(v.expected_pods), sorted(v.preempted_pods))
                      for v in views])
    assert out["port"] == out["jax"]
    assert any(out["port"][0]), f"{check}: no violation in either state"

"""The port's fault gates and supervisor against the JAX package.

The cases of tests/test_faults.py that the port's gates reach: the spec
grammar and the registry's triggers, the supervisor ladder unit, then
one engine burst per containment path (inline ladder retry, the fetch
sanity detector, the residency carry desync detector, the shortlist
cross-check, the bind reconcile, the commit worker's death and restart,
the quarantine rung), then the lifecycle driver's gate and the fleet
lease manager's. Each burst runs the JAX test's recipe on the port:
recovered placements equal the port's fault-free run, which equals the
JAX engine's, and the fire counts and the ladder's end state are the
JAX engine's. Two specs requeue pods and so re-form later batches: the
quarantine rung, whose placements equal the JAX engine's under the same
spec, and a bind fault, whose requeued pods rejoin the queue at a time
that decides their batch in both packages (two JAX runs can differ), so
it is held to the JAX test's bar: no pod lost or bound twice.

The port's registry is a process-wide singleton apart from JAX's; every
test starts and ends with both disarmed.
"""
import time

import pytest

from minisched_tpu import faults as jfaults
from minisched_tpu.config import SchedulerConfig as JConfig
from minisched_tpu.scenario import Cluster as JCluster
from minisched_tpu.service.defaultconfig import Profile as JProfile
from minisched_tpu.state import objects as JO
from minisched_tpu_torch import faults
from minisched_tpu_torch.config import SchedulerConfig
from minisched_tpu_torch.engine.scheduler import (DEGRADATION_LADDER,
                                                  _Supervisor)
from minisched_tpu_torch.faults import (FAULTS, GATES, FaultInjected,
                                        FaultWorkerDeath, parse_spec)
from minisched_tpu_torch.scenario.runner import Cluster
from minisched_tpu_torch.service.defaultconfig import Profile
from minisched_tpu_torch.state import objects as TO


@pytest.fixture(autouse=True)
def registry():
    faults.configure("")
    jfaults.configure("")
    yield FAULTS
    faults.configure("")
    jfaults.configure("")


# ---- grammar / registry units -------------------------------------------


def test_gate_catalog_is_the_jax_catalog():
    """Same gates in the same order: a spec parses alike in both
    packages and each gate's PRNG stream has the same seed."""
    assert GATES == jfaults.GATES


def test_spec_grammar_accepts_catalog_forms():
    spec = ("step:err@0.02,fetch:corrupt@3,commit:die@once,"
            "informer:stall@2s,bind:err@5,residency:stall@50msx0.25")
    by_gate = {r.gate: r for r in parse_spec(spec)}
    assert by_gate["step"].prob == pytest.approx(0.02)
    assert by_gate["fetch"].nth == 3 and by_gate["fetch"].action == "corrupt"
    assert by_gate["commit"].nth == 1 and by_gate["commit"].action == "die"
    assert by_gate["informer"].stall_s == pytest.approx(2.0)
    assert by_gate["informer"].nth == 1  # bare duration = fire once
    assert by_gate["bind"].nth == 5
    r = by_gate["residency"]
    assert r.stall_s == pytest.approx(0.05) and r.prob == pytest.approx(0.25)
    for mine, theirs in zip(parse_spec(spec), jfaults.parse_spec(spec)):
        assert (mine.gate, mine.action, mine.nth, mine.prob, mine.stall_s) \
            == (theirs.gate, theirs.action, theirs.nth, theirs.prob,
                theirs.stall_s)


@pytest.mark.parametrize("bad", [
    "nope:err@1",        # unknown gate
    "step:frob@1",       # unknown action
    "step:err@zzz",      # junk trigger
    "step:err@1.5",      # probability must be < 1
    "step:err@0",        # call numbers are 1-based
    "step:stall@3",      # stall needs a duration
    "step:err",          # no trigger at all
])
def test_spec_grammar_rejects_junk(bad):
    with pytest.raises(ValueError):
        parse_spec(bad)


def test_unarmed_registry_is_noop(registry):
    assert not registry.enabled
    assert registry.hit("step") is None
    assert registry.calls()["step"] == 0
    assert all(v == 0 for v in registry.counts().values())


def test_nth_trigger_fires_exactly_once(registry):
    faults.configure("step:err@3")
    fired = 0
    for _ in range(10):
        try:
            registry.hit("step")
        except FaultInjected:
            fired += 1
    assert fired == 1 and registry.counts()["step"] == 1
    assert registry.calls()["step"] == 10


def _pattern(module, spec, seed):
    module.configure(spec, seed)
    out = []
    for _ in range(64):
        try:
            module.FAULTS.hit("step")
            out.append(0)
        except module.FaultInjected:
            out.append(1)
    return out


def test_probability_trigger_is_seed_reproducible_and_jax_equal():
    first = _pattern(faults, "step:err@0.5", 42)
    assert first == _pattern(faults, "step:err@0.5", 42)
    assert 0 < sum(first) < 64
    assert first == _pattern(jfaults, "step:err@0.5", 42)


def test_stall_action_sleeps_and_counts(registry):
    faults.configure("step:stall@60ms")
    t0 = time.perf_counter()
    assert registry.hit("step") is None  # stall returns, never raises
    assert time.perf_counter() - t0 >= 0.05
    assert registry.counts()["step"] == 1


def test_die_action_is_distinguishable(registry):
    faults.configure("commit:die@once")
    with pytest.raises(FaultWorkerDeath):
        registry.hit("commit")
    assert issubclass(FaultWorkerDeath, FaultInjected)


def test_supervisor_ladder_and_probation_unit():
    class _FakeSched:
        config = SchedulerConfig(platform="cpu", probation_batches=2)
        _batch_seq = _step_counter = 0

        def __init__(self):
            self.counts = {}

        def _sup_count(self, k, n=1):
            self.counts[k] = self.counts.get(k, 0) + n

        def _slo_burning_any(self):
            # no SLO sentinel in this unit harness, as in
            # tests/test_faults.py (the burning gate's own tests are in
            # tests/test_torch_timeline.py)
            return False

    fake = _FakeSched()
    sup = _Supervisor(fake)
    assert DEGRADATION_LADDER[sup.level] == "resident"
    assert sup.allows_residency() and not sup.sync_only()
    for expect in ("upload", "sync", "quarantine"):
        sup.escalate("test")
        assert DEGRADATION_LADDER[sup.level] == expect
    sup.escalate("test")  # the bottom rung is sticky, not an overflow
    assert DEGRADATION_LADDER[sup.level] == "quarantine"
    assert sup.sync_only() and not sup.allows_residency()
    for expect in ("sync", "upload", "resident"):
        sup.note_clean()
        sup.note_clean()
        assert DEGRADATION_LADDER[sup.level] == expect
    sup.note_clean()  # clean at the top is a no-op
    assert sup.level == 0
    assert fake.counts["supervisor_escalations"] == 3
    assert fake.counts["supervisor_recoveries"] == 3
    sup.escalate("test")  # a mid-probation fault resets the clean streak
    sup.note_clean()
    sup.escalate("test")
    sup.note_clean()
    assert DEGRADATION_LADDER[sup.level] == "sync"


# ---- engine containment (one Cluster burst per path) --------------------

PLUGINS = ["NodeUnschedulable", "NodeResourcesFit",
           "NodeResourcesLeastAllocated"]
N_SCHED, N_DOOMED = 18, 2
PORT = (Cluster, Profile, TO, SchedulerConfig, faults)
JAX = (JCluster, JProfile, JO, JConfig, jfaults)


def _config(pkg, pipeline=True, **kw):
    kw.setdefault("max_batch_size", 6)
    kw.setdefault("batch_window_s", 0.3)
    kw.setdefault("backoff_initial_s", 0.05)
    kw.setdefault("backoff_max_s", 0.3)
    kw.setdefault("probation_batches", 1)
    if pkg is PORT:
        kw["platform"] = "cpu"
    return pkg[3](pipeline=pipeline, **kw)


def _make_pods(O):
    """18 schedulable pods of unique priorities and sizes, then 2 doomed
    ones (a CPU no node has) at the lowest priorities: the last batch,
    a real failure tranche for the commit path."""
    pods, pri = [], 500
    for i in range(N_SCHED):
        pods.append(O.Pod(
            metadata=O.ObjectMeta(name=f"p{i}", namespace="default"),
            spec=O.PodSpec(requests={"cpu": 100 + 17 * i}, priority=pri)))
        pri -= 1
    for i in range(N_DOOMED):
        pods.append(O.Pod(
            metadata=O.ObjectMeta(name=f"doom{i}", namespace="default"),
            spec=O.PodSpec(requests={"cpu": 10 ** 9}, priority=pri)))
        pri -= 1
    return pods


def _run_burst(pkg, spec, pipeline=True, settle_s=60, **kw):
    """tests/test_faults.py's burst on ``pkg`` under fault spec ``spec``:
    four nodes of distinct sizes, the pods above, every schedulable pod
    bound and every doomed one parked, then probe pods until the ladder
    is back at "resident". Returns (placements {name: node}, metrics)."""
    cluster_cls, profile_cls, O, _, module = pkg
    c = cluster_cls()
    try:
        c.start(profile=profile_cls(plugins=list(PLUGINS)),
                config=_config(pkg, pipeline, **kw),
                with_pv_controller=False)
        module.configure(spec, 0)
        for i, cpu in enumerate((64000, 48000, 40000, 36000)):
            c.create_node(f"n{i}", cpu=cpu)
        c.create_objects(_make_pods(O))
        sched_names = [f"p{i}" for i in range(N_SCHED)]
        doom_names = [f"doom{i}" for i in range(N_DOOMED)]
        deadline = time.monotonic() + settle_s
        while time.monotonic() < deadline:
            placements, parked = {}, set()
            for p in c.list_pods():
                if p.spec.node_name:
                    placements[p.metadata.name] = p.spec.node_name
                elif p.status.unschedulable_plugins:
                    parked.add(p.metadata.name)
            if (all(n in placements for n in sched_names)
                    and all(n in parked for n in doom_names)):
                break
            time.sleep(0.05)
        assert all(n in placements for n in sched_names), placements
        assert all(n in parked for n in doom_names), parked
        sched = c.service.scheduler
        m = sched.metrics()
        # Zero doubly-bound: every counted bind is one placed pod.
        assert m["pods_bound"] == len(placements), (m["pods_bound"],
                                                    len(placements))
        probe = 0
        deadline = time.monotonic() + 30
        while (sched.metrics()["degradation_state"] != "resident"
               and time.monotonic() < deadline):
            c.create_pod(f"probe{probe}", cpu=10)
            c.wait_for_pod_bound(f"probe{probe}", timeout=30)
            probe += 1
            time.sleep(0.1)
        return placements, sched.metrics()
    finally:
        module.configure("")
        c.shutdown()


_REFS = {}


def _reference(pkg, pipeline=True, **kw):
    """The fault-free burst of one package and config, run once per
    module."""
    key = (pkg[0].__module__, pipeline, tuple(sorted(kw.items())))
    if key not in _REFS:
        placed, m = _run_burst(pkg, "", pipeline, **kw)
        assert m["batch_faults"] == 0 and m["watchdog_trips"] == 0
        assert all(v == 0 for k, v in m.items()
                   if k.startswith("fault_fires_"))
        assert m["degradation_state"] == "resident"
        _REFS[key] = placed, m
    return _REFS[key]


def _fault_free(pipeline=True, **kw):
    """The port's fault-free placements, checked equal to the JAX
    engine's: (placements, port metrics)."""
    placed, m = _reference(PORT, pipeline, **kw)
    assert placed == _reference(JAX, pipeline, **kw)[0]
    return placed, m


def _fires(m):
    return {g: m[f"fault_fires_{g}"] for g in GATES}


@pytest.mark.parametrize("pipeline", [False, True])
def test_engine_gates_fire_and_recovered_decisions_are_bit_identical(
        pipeline):
    """The flagship schedule: a step fault (exception containment), a
    corrupted readback (detector containment), a commit-flush fault and
    an informer dispatch fault, each fired once. The port absorbs all of
    them, ends at "resident" with the JAX engine's fire counts, and
    places every pod where the fault-free run (= the JAX engine's) did:
    the supervisor's PRNG-rewind replay."""
    ref, _ = _fault_free(pipeline)
    spec = "step:err@2,fetch:corrupt@3,commit:err@1,informer:err@1"
    placed, m = _run_burst(PORT, spec, pipeline)
    jplaced, jm = _run_burst(JAX, spec, pipeline)
    for gate in ("step", "fetch", "commit", "informer"):
        assert m[f"fault_fires_{gate}"] == 1, (gate, m)
    assert _fires(m) == _fires(jm)
    assert m["batch_faults"] >= 1 and m["batch_retries"] >= 1
    assert m["supervisor_escalations"] >= 1
    assert m["supervisor_recoveries"] >= 1
    assert m["degradation_state"] == jm["degradation_state"] == "resident"
    assert placed == ref == jplaced


def test_fetch_corrupt_on_first_batch_hits_detector():
    """A corrupt readback on the engine's first fetch trips the resolve
    sanity detector like any other batch."""
    ref, _ = _fault_free(False)
    placed, m = _run_burst(PORT, "fetch:corrupt@1", False)
    assert m["fault_fires_fetch"] == 1
    assert m["batch_faults"] >= 1
    assert m["supervisor_escalations"] >= 1
    assert m["degradation_state"] == "resident"
    assert placed == ref


def test_residency_corrupt_trips_desync_detector_and_resyncs():
    """With the carry cross-check armed (resident_check_every=1), a
    scribbled host mirror is caught before the step consumes the carry,
    counted as a desync and healed by a full re-upload; decisions stay
    those of the fault-free run."""
    ref, ref_m = _fault_free(False, resident_check_every=1)
    assert ref_m["resident_checks"] >= 2  # the detector ran
    assert ref_m["residency_desyncs"] == 0
    placed, m = _run_burst(PORT, "residency:corrupt@2", False,
                           resident_check_every=1)
    assert m["fault_fires_residency"] == 1
    assert m["residency_desyncs"] >= 1
    assert m["supervisor_escalations"] >= 1
    assert m["degradation_state"] == "resident"
    assert placed == ref


def test_shortlist_corrupt_caught_by_certification_cross_check():
    """With the cross-check armed (shortlist_check_every=1), a
    shortlist mispick invisible to the range check is caught by the
    full-width comparison, counted, the engine reverts to the full
    kernel for good (shortlist_width 0), and the replay lands every pod
    where the fault-free run did."""
    ref, ref_m = _fault_free(False, shortlist_check_every=1)
    assert ref_m["shortlist_checks"] >= 2
    assert ref_m["shortlist_desyncs"] == 0
    assert ref_m["shortlist_width"] > 0
    placed, m = _run_burst(PORT, "shortlist_repair:corrupt@2", False,
                           shortlist_check_every=1)
    assert m["fault_fires_shortlist_repair"] == 1
    assert m["shortlist_desyncs"] == 1
    assert m["shortlist_width"] == 0
    assert m["batch_faults"] >= 1
    assert m["supervisor_escalations"] >= 1
    assert m["degradation_state"] == "resident"
    assert placed == ref


@pytest.mark.parametrize("pipeline", [False, True])
def test_bind_gate_reconciles_without_losing_or_double_binding(pipeline):
    """An aborted bulk bind reconciles per pod against the store: no pod
    lost, none bound twice (_run_burst's pods_bound check)."""
    placed, m = _run_burst(PORT, "bind:err@1", pipeline)
    assert m["fault_fires_bind"] == 1
    assert m["bind_conflicts"] >= 1
    assert len(placed) >= N_SCHED


def test_commit_worker_death_drains_restarts_and_stays_live():
    """commit:die escapes the commit worker's exception guard like a
    dying thread: the pipeline slot drains, the worker restarts, the
    dead flush's tranche is requeued, the doomed pods still get their
    verdicts and every pod lands where the fault-free run put it."""
    ref, _ = _fault_free(True)
    placed, m = _run_burst(PORT, "commit:die@once", True)
    assert m["fault_fires_commit"] == 1
    assert m["worker_deaths"] == 1
    assert m["supervisor_escalations"] >= 1
    assert m["degradation_state"] == "resident"
    assert placed == ref


def test_quarantine_rung_requeues_and_still_never_loses_pods():
    """Three step faults in a row exhaust the ladder: the batch is
    requeued at the backoff ceiling, the loop stays live, the pods bind
    when they return, and they land where the JAX engine puts them
    under the same faults."""
    spec = "step:err@1,step:err@2,step:err@3"
    placed, m = _run_burst(PORT, spec, True)
    jplaced, jm = _run_burst(JAX, spec, True)
    assert m["fault_fires_step"] == 3
    assert m["quarantined_batches"] == jm["quarantined_batches"] == 1
    assert m["supervisor_escalations"] >= 3
    assert m["degradation_state"] == jm["degradation_state"] == "resident"
    assert placed == jplaced and len(placed) >= N_SCHED


def test_watchdog_trips_on_a_stalled_step_and_probation_recovers():
    """A step stalled past ``watchdog_s`` counts one trip and degrades
    one rung; the batch itself completed, so decisions are the
    fault-free run's, and probation climbs back to "resident"."""
    ref, _ = _fault_free(False)
    placed, m = _run_burst(PORT, "step:stall@400ms", False, watchdog_s=0.2)
    assert m["fault_fires_step"] == 1
    assert m["watchdog_trips"] == 1 and m["batch_faults"] == 0
    assert m["supervisor_escalations"] >= 1
    assert m["supervisor_recoveries"] >= 1
    assert m["degradation_state"] == "resident"
    assert placed == ref


def test_tracer_and_journal_record_the_ladder():
    """With the flight recorder and the journal armed, a faulted burst's
    spans and instants show where the ladder moved, and decisions are
    those of the fault-free run."""
    from minisched_tpu_torch import obs
    from minisched_tpu_torch.obs import journal

    ref, _ = _fault_free(False)
    obs.configure(True)
    journal.configure("1")
    try:
        placed, m = _run_burst(PORT, "step:err@2", False)
        names = {e["name"] for e in obs.TRACE.events()}
        kinds = {e["kind"] for e in journal.JOURNAL.entries()}
    finally:
        obs.configure(False)
        journal.configure("")
    assert placed == ref and m["fault_fires_step"] == 1
    assert {"prepare", "step.dispatch", "resolve", "fetch.decision",
            "commit", "bind.bulk", "fault.step",
            "supervisor.escalate", "supervisor.recover"} <= names
    assert {"fault.step", "supervisor.escalate", "supervisor.retry",
            "supervisor.recover"} <= kinds


# ---- lifecycle gate: the scenario driver's step -------------------------


def test_lifecycle_gate_skips_steps_but_loses_nothing(registry):
    """An err at the driver's step seam skips the tick (counted) and
    retries it shortly after: the generator still completes and the
    ledger stays whole, as in the JAX package, step for step."""
    from minisched_tpu import lifecycle as jlc
    from minisched_tpu_torch.lifecycle import (LifecycleDriver,
                                               PoissonArrivals)

    def run(cluster_cls, driver_cls, arrivals_cls, reg):
        d = driver_cls(cluster_cls(), seed=3)
        d.add(arrivals_cls("arrivals", rate_pps=40, duration_s=1.0,
                           prefix="flt"))
        d.install_default_invariants()
        reg.configure("lifecycle:err@2,lifecycle:err@5")
        d.run()
        fired = reg.FAULTS.counts()["lifecycle"]
        reg.configure("")
        return d, fired

    d, fired = run(Cluster, LifecycleDriver, PoissonArrivals, faults)
    assert fired == 2
    assert d.faulted_steps == 2
    assert d.view.counters.get("pods_created", 0) > 5
    d.check_invariants()
    jd, jfired = run(JCluster, jlc.LifecycleDriver, jlc.PoissonArrivals,
                     jfaults)
    assert (fired, d.event_lines()) == (jfired, jd.event_lines())


# ---- lease gate (fleet/lease.py) -----------------------------------------


def test_lease_gate_err_drops_heartbeat(registry):
    """``lease:err`` drops the renewal before it reaches the store:
    counted, the store's ``renewed_at`` unmoved, the shard still held."""
    from minisched_tpu_torch.fleet.lease import LeaseManager
    from minisched_tpu_torch.state.store import ClusterStore

    store = ClusterStore()
    clk = [0.0]
    mgr = LeaseManager(store, "rA", ttl_s=10.0, clock=lambda: clk[0])
    assert mgr.try_acquire(0)
    stamp = store.get("Lease", "shard-0").renewed_at
    faults.configure("lease:err@1")
    clk[0] = 1.0
    assert mgr.renew(0) is False
    assert mgr.counters["heartbeats_dropped"] == 1
    assert FAULTS.counts()["lease"] == 1
    assert store.get("Lease", "shard-0").renewed_at == stamp
    assert mgr.holds(0)
    assert mgr.renew(0) is True
    assert store.get("Lease", "shard-0").renewed_at == 1.0


def test_lease_gate_corrupt_stale_heartbeat_loses_cas(registry):
    """``lease:corrupt`` sends the heartbeat with a rewound
    resource_version: the store's CAS rejects it, the rejection is
    counted and store truth stays as the last honest write left it."""
    from minisched_tpu_torch.fleet.lease import LeaseManager
    from minisched_tpu_torch.state.store import ClusterStore

    store = ClusterStore()
    clk = [0.0]
    mgr = LeaseManager(store, "rA", ttl_s=10.0, clock=lambda: clk[0])
    assert mgr.try_acquire(0)
    before = store.get("Lease", "shard-0")
    faults.configure("lease:corrupt@1")
    clk[0] = 1.0
    assert mgr.renew(0) is False
    assert mgr.counters["stale_heartbeats_rejected"] == 1
    after = store.get("Lease", "shard-0")
    assert (after.holder, after.epoch, after.renewed_at) == \
        ("rA", before.epoch, before.renewed_at)
    assert mgr.renew(0) is True
    assert store.get("Lease", "shard-0").renewed_at == 1.0


def test_corrupted_lease_cannot_mint_two_owners(registry):
    """A zombie holder whose every heartbeat is corrupt cannot keep its
    shard against a live peer, and store truth never names two owners
    or moves an epoch without a CAS win."""
    from minisched_tpu_torch.fleet.lease import LeaseManager
    from minisched_tpu_torch.state.store import ClusterStore

    store = ClusterStore()
    clk = [0.0]
    zombie = LeaseManager(store, "rZ", ttl_s=1.0, clock=lambda: clk[0])
    peer = LeaseManager(store, "rP", ttl_s=1.0, clock=lambda: clk[0])
    assert zombie.try_acquire(0)
    faults.configure("lease:corrupt@1,lease:corrupt@2,lease:corrupt@3")
    clk[0] = 0.5
    assert zombie.renew(0) is False
    assert store.get("Lease", "shard-0").renewed_at == 0.0
    clk[0] = 1.5
    assert peer.try_acquire(0)
    truth = store.get("Lease", "shard-0")
    assert (truth.holder, truth.epoch) == ("rP", 2)
    assert zombie.holds(0) and peer.holds(0)
    assert zombie.renew(0) is False
    assert not zombie.holds(0)
    assert zombie.counters["losses"] == 1
    truth = store.get("Lease", "shard-0")
    assert (truth.holder, truth.epoch) == ("rP", 2)
    assert peer.epoch_of(0) == 2 and zombie.epoch_of(0) == 0

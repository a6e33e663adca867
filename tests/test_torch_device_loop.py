"""The device loop (config.device_loop; ops/pipeline.build_loop_step and
the engine's tranche machinery) against the JAX package.

Op level: the port's build_loop_step against the JAX one on the same
slot inputs, every slot's packed bytes and the final carried ``free``
bitwise (tolerance none). Engine level, the cases of
tests/test_device_loop.py: each burst puts every object in the store
before the engine starts, so both engines pop the same batches, and the
placements and the deterministic counters (LOOP_COUNTERS) must be equal
across packages, and the placements equal to the port's run without the
loop. Left out of every counter comparison: the clocks and the gap
components (host timing). The mid-tranche divergence case requeues pods
on the binder's timing and is held to the JAX test's bar only.
"""
import jax
import numpy as np
import pytest

from minisched_tpu.encode import NodeFeatureCache as JCache
from minisched_tpu.encode import encode_pods as jencode
from minisched_tpu.ops.pipeline import build_loop_step as jbuild_loop
from minisched_tpu.service.defaultconfig import Profile as JProfile
from minisched_tpu.state import objects as JO
from minisched_tpu_torch.encode import NodeFeatureCache, to_torch
from minisched_tpu_torch.ops import prng
from minisched_tpu_torch.ops.pipeline import build_loop_step
from minisched_tpu_torch.service.defaultconfig import Profile
from minisched_tpu_torch.state import objects as TO
from torch_obs_parity import JAX, PORT, disarm_all, engine_modes
from torch_parity import BENCH_PROFILE, bench_cluster, build_cache
from minisched_tpu_torch.scenario.runner import wait_until

ZONE = "topology.kubernetes.io/zone"
LOOP_PROFILE = dict(name="loop",
                    plugins=["NodeUnschedulable", "NodeResourcesFit"],
                    plugin_args={"NodeResourcesFit": {"score_strategy": None}})
SPREAD_PROFILE = dict(name="loop",
                      plugins=["NodeUnschedulable", "NodeResourcesFit",
                               "PodTopologySpread"],
                      plugin_args={"NodeResourcesFit":
                                   {"score_strategy": None}})
# The counters that do not depend on timing: batches, dispatches and
# fetches, tranches, slots and breaks, the fault ladder's, the transfer
# ledger and the scored rows.
LOOP_COUNTERS = ("batches", "steps_dispatched", "decision_fetches",
                 "loop_tranches", "loop_iterations", "loop_breaks",
                 "batch_faults", "batch_retries", "supervisor_escalations",
                 "residency_resyncs", "residency_hits", "fetch_bytes_total",
                 "h2d_bytes_total", "scored_rows_total", "pods_bound",
                 "loop_depth_effective", "degradation_level")


@pytest.fixture(autouse=True)
def _disarmed():
    disarm_all()
    yield
    disarm_all()


def _config(pkg, loop, *, pipeline=True, resident=True, shortlist=True,
            depth=4, **kw):
    kw.setdefault("max_batch_size", 8)
    kw.setdefault("batch_window_s", 0.3)
    kw.setdefault("backoff_initial_s", 0.05)
    kw.setdefault("backoff_max_s", 0.2)
    return pkg.config(device_loop=loop, loop_depth=depth, pipeline=pipeline,
                      device_resident=resident, shortlist=shortlist, **kw)


def _plain_pods(O, n, cpu0=100):
    """Loop-safe pods with distinct priorities and requests."""
    return [O.Pod(metadata=O.ObjectMeta(name=f"p-{i}", namespace="default"),
                  spec=O.PodSpec(requests={"cpu": cpu0 + i},
                                 priority=1000 - i))
            for i in range(n)]


def _burst(pkg, config, pods_fn=_plain_pods, n=24, *, profile=LOOP_PROFILE,
           nodes=6, cpu=640000, spec="", before_start=None, timeout=120.0):
    """Nodes and pods in the store, ``spec`` armed, then the engine:
    waits until every pod is bound and folded. Returns (placements,
    metrics, scheduler)."""
    O = pkg.O
    c = pkg.Cluster()
    try:
        for i in range(nodes):
            c.create_node(f"n{i}", cpu=cpu, labels={ZONE: "ab"[i % 2]})
        pods = pods_fn(O, n)
        c.create_objects(pods)
        if before_start is not None:
            before_start(c)
        if spec:
            pkg.faults.configure(spec)
        c.start(pkg.Profile(**profile), config, with_pv_controller=False)
        sched = c.service.scheduler
        want = len(pods)
        assert wait_until(
            lambda: sched.metrics()["pods_bound"] >= want
            and sched.metrics()["pods_assigned"] >= want
            and sum(1 for p in c.list_pods() if p.spec.node_name) >= want,
            timeout=timeout), (pkg.name, sched.metrics()["pods_bound"], want)
        placed = {p.key: p.spec.node_name for p in c.list_pods()
                  if p.spec.node_name}
        assert sorted(p.metadata.name for p in c.list_pods()) == sorted(
            p.metadata.name for p in pods)
        return placed, sched.metrics(), sched
    finally:
        pkg.faults.configure("")
        c.shutdown()


def _both(kw_fn, *args, **kw):
    """The same burst on both engines: (jax run, port run)."""
    return (_burst(JAX, kw_fn(JAX), *args, **kw)[:2],
            _burst(PORT, kw_fn(PORT), *args, **kw)[:2])


def _same(jm, pm, keys=LOOP_COUNTERS):
    for k in keys:
        assert jm[k] == pm[k], (k, jm[k], pm[k])


# ---- op level -------------------------------------------------------------


def _slots(O, cache, n_slots=3, P=16):
    """Ragged slots (6, 5, 4 pods) encoded at one pod pad."""
    out = []
    for s in range(n_slots):
        pods = [O.Pod(metadata=O.ObjectMeta(name=f"b{s}-{i}",
                                            namespace="default"),
                      spec=O.PodSpec(requests={"cpu": 100 + 10 * s + i},
                                     priority=100 - i))
                for i in range(6 - s)]
        out.append(jencode(pods, P, cfg=cache.cfg, registry=cache.registry))
    return out


@pytest.mark.parametrize("assignment,shortlist", [
    ("greedy", 128), ("greedy", None), ("auction", 128), ("auction", None)])
@pytest.mark.parametrize("slim", [True, False])
def test_loop_step_matches_jax(assignment, shortlist, slim):
    """Every slot's packed decision (slim and i32 layouts) and the final
    carry of the port's loop equal the JAX loop's bitwise, on ragged
    slots whose free chains from slot to slot."""
    nodes, _pods = bench_cluster(JO, 40, 8, 3)
    cache = build_cache(JCache, nodes)
    nf, _names, _sv, _incs = cache.snapshot_versioned(pad=48)
    af = cache.snapshot_assigned(pad=16)
    slots = _slots(JO, cache)
    counters = np.array([7, 8, 9], dtype=np.uint32)
    jloop = jbuild_loop(JProfile(**BENCH_PROFILE).build(),
                        assignment=assignment, shortlist=shortlist,
                        slim=slim)
    eb_stack = jax.tree_util.tree_map(lambda *xs: np.stack(xs), *slots)
    want_packs, want_free = jloop(eb_stack, nf, af, counters,
                                  jax.random.PRNGKey(5))
    loop = build_loop_step(Profile(**BENCH_PROFILE).build(),
                           assignment=assignment, shortlist=shortlist,
                           slim=slim)
    base = prng.PRNGKey(5)
    packs, free = loop([to_torch(eb, "cpu") for eb in slots],
                       to_torch(nf, "cpu"), to_torch(af, "cpu"),
                       [prng.fold_in(base, int(c)) for c in counters])
    want_packs = np.asarray(want_packs)
    assert packs.shape == want_packs.shape
    for j in range(3):
        np.testing.assert_array_equal(packs[j].numpy(), want_packs[j])
    np.testing.assert_array_equal(free.numpy().view(np.int32),
                                  np.asarray(want_free).view(np.int32))
    if not slim:
        assert all(want_packs[j][1].any() for j in range(3))


# ---- engine level: bit identity ------------------------------------------


@pytest.mark.parametrize("pipeline,resident,shortlist", engine_modes())
def test_loop_matches_jax_per_mode(pipeline, resident, shortlist):
    """The loop's placements and counters equal the JAX engine's in each
    of the six engine modes, equal the port's placements without the
    loop, and the ring really fused (tranches, fewer dispatches than
    batches)."""
    def cfg(pkg, loop=True):
        return _config(pkg, loop, pipeline=pipeline, resident=resident,
                       shortlist=shortlist)

    (jp, jm), (pp, pm) = _both(cfg)
    off, m_off, _s = _burst(PORT, cfg(PORT, loop=False))
    assert pp == jp
    assert pp == off
    _same(jm, pm)
    assert pm["loop_tranches"] >= 1 and pm["loop_iterations"] >= 2
    assert pm["steps_dispatched"] < pm["batches"]
    assert m_off["loop_tranches"] == 0
    assert m_off["steps_dispatched"] == m_off["batches"]


def test_ragged_tail_matches_jax():
    """28 pods at batch 8: the 4-pod tail slot pads to the ring's pod
    bucket and decides as at its own (upload mode: no slim check, so the
    first tranche takes all four batches)."""
    (jp, jm), (pp, pm) = _both(lambda pkg: _config(pkg, True,
                                                   resident=False), n=28)
    assert pp == jp
    _same(jm, pm)
    assert pm["loop_iterations"] == 4 and pm["loop_breaks"] == 0
    off, _m, _s = _burst(PORT, _config(PORT, False, resident=False), n=28)
    assert pp == off


def test_single_fetch_ledger_matches_jax():
    """One blocking decision read back per dispatch, both well under the
    batch count at depth 4 over 64 pods, and the carry kept across
    tranches (one residency establish)."""
    (jp, jm), (pp, pm) = _both(lambda pkg: _config(pkg, True), n=64)
    assert pp == jp
    _same(jm, pm)
    assert pm["decision_fetches"] == pm["steps_dispatched"]
    assert pm["steps_dispatched"] * 2 <= pm["batches"]
    assert pm["residency_resyncs"] == 1


# ---- engagement gates -----------------------------------------------------


def _unsafe_pods(O, _n):
    spread = [O.Pod(
        metadata=O.ObjectMeta(name=f"sp-{i}", namespace="default",
                              labels={"app": "s"}),
        spec=O.PodSpec(
            requests={"cpu": 100}, priority=500 - i,
            topology_spread_constraints=[O.TopologySpreadConstraint(
                max_skew=1, topology_key=ZONE,
                when_unsatisfiable="DoNotSchedule",
                label_selector=O.LabelSelector(match_labels={"app": "s"}))]))
        for i in range(8)]
    gang = [O.Pod(metadata=O.ObjectMeta(name=f"g-{i}", namespace="default"),
                  spec=O.PodSpec(requests={"cpu": 100}, priority=100 - i,
                                 pod_group="team", pod_group_min=4))
            for i in range(4)]
    return spread + gang


def test_unsafe_batches_are_declined_alike():
    """Gangs and hard-spread pods never ride the ring: both engines run
    them per batch and place them alike."""
    (jp, jm), (pp, pm) = _both(lambda pkg: _config(pkg, True),
                               _unsafe_pods, profile=SPREAD_PROFILE)
    assert pp == jp and len(pp) == 12
    assert pm["loop_tranches"] == 0 and pm["loop_iterations"] == 0
    _same(jm, pm, ("batches", "steps_dispatched", "loop_tranches"))


def test_loop_off_is_a_noop():
    """device_loop=False (the default): no loop listener, zero loop
    counters, the gauge at 0, the JAX engine's placements."""
    (jp, jm), (pp, pm) = _both(lambda pkg: _config(pkg, False), n=16)
    assert pp == jp
    for k in ("loop_tranches", "loop_iterations", "loop_breaks",
              "loop_depth_effective"):
        assert pm[k] == 0 == jm[k], k
    c = PORT.Cluster()
    try:
        c.start(PORT.Profile(**LOOP_PROFILE), _config(PORT, False),
                with_pv_controller=False)
        assert c.service.scheduler._loop_listener is None
    finally:
        c.shutdown()


# ---- containment ----------------------------------------------------------


@pytest.mark.parametrize("spec,kind", [("step:err@3", "staging"),
                                       ("fetch:corrupt@2", "fetch")])
def test_tranche_fault_is_contained_as_in_jax(spec, kind):
    """A step fault while the ring stages (the tranche's second slot),
    or a scribbled stacked fetch (slot 0's sanity check trips): the
    tranche breaks back to per-batch dispatch, replays with the original
    PRNG draws, and every pod lands on its fault-free node; the break,
    the fault counters and the ladder's end state equal the JAX
    engine's, and the break and retry notes are journaled alike."""
    base, _m, _s = _burst(PORT, _config(PORT, False))
    out = {}
    for pkg in (JAX, PORT):
        pkg.journal.configure("1")
        try:
            placed, m, _s = _burst(pkg, _config(pkg, True), spec=spec)
            kinds = [e["kind"] for e in pkg.journal.JOURNAL.entries()
                     if e["kind"].startswith(("loop.", "supervisor."))]
        finally:
            pkg.journal.configure("")
        out[pkg.name] = (placed, m, kinds)
    (jp, jm, jk), (pp, pm, pk) = out["jax"], out["port"]
    assert pp == jp == base
    _same(jm, pm, LOOP_COUNTERS + ("fault_fires_step", "fault_fires_fetch"))
    assert pm["loop_breaks"] == 1
    assert pk == jk and "loop.break" in pk
    if kind == "staging":
        assert pm["fault_fires_step"] == 1
        assert pm["degradation_state"] == "resident"
    else:
        assert pm["batch_faults"] >= 1 and pm["supervisor_escalations"] >= 1


def test_mid_tranche_divergence_breaks_and_reconverges():
    """Host truth moving off the carried chain between slots (a bulk
    bind that binds only half its pods: the rest are unassumed and
    requeued) breaks the ring or lands between tranches; every pod binds
    once and the listener protocol reconverges with no desync. The
    requeued pods rejoin on the binder's timing, so this is held to the
    JAX test's bar, not to its placements."""
    import threading

    def flaky(c):
        orig = c.store.bind_pods
        tripped = threading.Event()

        def fb(items):
            if not tripped.is_set() and len(items) > 1:
                tripped.set()
                return orig(items[: len(items) // 2])
            return orig(items)
        c.store.bind_pods = fb

    placed, m, _s = _burst(PORT, _config(PORT, True), before_start=flaky)
    assert len(placed) == 24
    assert m["bind_conflicts"] > 0
    assert m["residency_desyncs"] == 0
    assert m["loop_tranches"] >= 1


def test_drain_dyn_rows_surfaces_out_of_pad_rows():
    """The validator's drain hands back every marked row, one past the
    tranche's pad included, with authoritative values, and leaves the
    residency epoch protocol alone; both caches agree row for row."""
    out = {}
    for O, cache_cls in ((JO, JCache), (TO, NodeFeatureCache)):
        cache = cache_cls()

        def node(i, O=O):
            return O.Node(metadata=O.ObjectMeta(name=f"d{i}"),
                          spec=O.NodeSpec(),
                          status=O.NodeStatus(allocatable={
                              "cpu": 1000, "memory": 1 << 30, "pods": 100}))

        for i in range(3):
            cache.upsert_node(node(i))
        res_lst = cache.register_dyn_listener()
        cache.snapshot_resident(pad=4, dyn=res_lst)
        e0 = res_lst.epoch
        loop_lst = cache.register_dyn_listener()
        loop_lst.rows.clear()
        cache.account_bind(O.Pod(
            metadata=O.ObjectMeta(name="w", namespace="default"),
            spec=O.PodSpec(requests={"cpu": 100})), node_name="d1")
        for i in range(3, 7):
            cache.upsert_node(node(i))
        rows, fvals, pvals = cache.drain_dyn_rows(loop_lst)
        assert int(rows.max()) >= 4
        k = rows.tolist().index(cache.row_of("d1"))
        assert fvals[k][O.RESOURCE_INDEX["cpu"]] == 900.0
        assert not loop_lst.rows and res_lst.epoch == e0
        out[O is TO] = (rows, fvals, pvals)
    for a, b in zip(out[False], out[True]):
        np.testing.assert_array_equal(a, b)


# ---- composition ----------------------------------------------------------


def test_tuner_steps_the_depth_down_as_in_jax():
    """The tuned rung halves the effective depth per tune step (floor
    1), untouched when the controller is disarmed, as the JAX
    controller does; the engine's gauge reads the same dial."""
    for pkg in (JAX, PORT):
        pkg.overload.configure("min_batch=16")
        try:
            ov = pkg.overload.OverloadController()
            assert [ov.effective_loop_depth(8)] == [8]
            got = []
            for steps in (1, 2, 5):
                ov.tune_steps = steps
                got.append(ov.effective_loop_depth(8))
            assert got == [4, 2, 1]
        finally:
            pkg.overload.configure("")
        ov2 = pkg.overload.OverloadController()
        ov2.tune_steps = 3
        assert ov2.effective_loop_depth(8) == 8
    c = PORT.Cluster()
    try:
        c.start(PORT.Profile(**LOOP_PROFILE), _config(PORT, True, depth=8),
                with_pv_controller=False)
        sched = c.service.scheduler
        assert sched.metrics()["loop_depth_effective"] == 8
        PORT.overload.configure("min_batch=16")
        try:
            sched._overload.tune_steps = 2
            assert sched.metrics()["loop_depth_effective"] == 2
        finally:
            sched._overload.tune_steps = 0
            PORT.overload.configure("")
    finally:
        c.shutdown()


def test_watchdog_judges_a_slot_by_its_share():
    """A slot is judged by its share of the tranche's window: an 8 s
    window over 8 slots (1 s each) does not trip a 1 s deadline, while
    the same stamps on a per-batch batch do."""
    from minisched_tpu_torch.engine.scheduler import _Batch

    c = PORT.Cluster()
    try:
        c.start(PORT.Profile(**LOOP_PROFILE),
                _config(PORT, True, watchdog_s=1.0), with_pv_controller=False)
        sched = c.service.scheduler

        def window(share):
            b = _Batch()
            b.t_encode = b.t_dispatch = b.t_fetch_start = 0.0
            b.t_fetched = 8.0
            b.step_share = share
            return b

        sched._watchdog_check(window(8.0 / 8))
        assert sched.metrics()["watchdog_trips"] == 0
        assert sched._sup.level == 0
        sched._watchdog_check(window(None))
        assert sched.metrics()["watchdog_trips"] == 1
        assert sched._sup.level == 1
    finally:
        c.shutdown()


def test_timeline_keeps_its_cadence_under_the_loop():
    """Each resolved slot ticks the timeline like a batch: an every-batch
    cadence over a fused stream gives the JAX engine's row count, a row
    a batch after the first."""
    out = {}
    for pkg in (JAX, PORT):
        pkg.timeseries.configure(True, every="1", capacity=256)
        try:
            _p, m, _s = _burst(pkg, _config(pkg, True))
        finally:
            pkg.timeseries.configure(False)
        out[pkg.name] = m
    jm, pm = out["jax"], out["port"]
    assert pm["loop_tranches"] >= 1
    assert pm["timeline_snapshots"] == jm["timeline_snapshots"]
    assert pm["timeline_snapshots"] >= pm["batches"] - 1


# ---- the auction in the loop (tests/test_auction.py:409,430) -------------


def _au_pods(O, n):
    return [O.Pod(metadata=O.ObjectMeta(name=f"a-{i}", namespace="default"),
                  spec=O.PodSpec(requests={"cpu": 100 + 7 * i},
                                 priority=1000 - i))
            for i in range(n)]


def test_auction_loop_ragged_tail_matches_jax():
    """Auction batches ride the ring (slot k+1's free is slot k's
    free_after, its prices start fresh): a 28-pod stream at batch 8
    with a 4-pod tail slot equals the JAX engine's and the per-batch
    auction's placements."""
    def cfg(pkg, loop=True):
        return _config(pkg, loop, resident=False, assignment="auction")

    (jp, jm), (pp, pm) = _both(cfg, _au_pods, n=28)
    off, _m, _s = _burst(PORT, cfg(PORT, False), _au_pods, n=28)
    assert pp == jp == off
    _same(jm, pm)
    assert pm["loop_iterations"] == 4 and pm["loop_breaks"] == 0
    assert pm["steps_dispatched"] < pm["batches"]


def test_auction_loop_breakout_matches_jax():
    """A step fault mid-tranche on the auction ring: per-batch replay
    with the original draws, the fault-free placements, one break."""
    def cfg(pkg):
        return _config(pkg, True, assignment="auction")

    base, _m, _s = _burst(PORT, _config(PORT, False, assignment="auction"),
                          _au_pods)
    (jp, jm), (pp, pm) = _both(cfg, _au_pods, spec="step:err@3")
    assert pp == jp == base
    _same(jm, pm, LOOP_COUNTERS + ("fault_fires_step",))
    assert pm["loop_breaks"] == 1 and pm["fault_fires_step"] == 1


# ---- crash-stop and provenance --------------------------------------------


def test_abandon_between_slots_drops_the_staged_tail_as_in_jax():
    """The crash-stop flag seen after slot 0 of a tranche: the staged
    slots after it are neither resolved nor committed (their pods stay
    pending), counted in loop_abandoned_slots and journaled, as in the
    JAX engine."""
    out = {}
    for pkg in (JAX, PORT):
        def arm(c, pkg=pkg):
            cls = pkg.scheduler.Scheduler
            orig = cls._commit_batch

            def commit(self, b):
                orig(self, b)
                if getattr(b, "loop_slot", None) == 0:
                    self._abandoned = True
            c._restore = (cls, orig)
            cls._commit_batch = commit

        pkg.journal.configure("1")
        c = pkg.Cluster()
        try:
            for i in range(6):
                c.create_node(f"n{i}", cpu=640000)
            c.create_objects(_plain_pods(pkg.O, 24))
            arm(c)
            try:
                c.start(pkg.Profile(**LOOP_PROFILE), _config(pkg, True),
                        with_pv_controller=False)
                sched = c.service.scheduler
                assert wait_until(
                    lambda: sched.metrics().get("loop_abandoned_slots", 0)
                    > 0, timeout=60)
            finally:
                c._restore[0]._commit_batch = c._restore[1]
            assert wait_until(lambda: sched.metrics()["pods_bound"]
                              >= sched.metrics()["pods_assigned"], timeout=30)
            m = sched.metrics()
            bound = sorted(p.key for p in c.list_pods() if p.spec.node_name)
            notes = [(e["kind"], e.get("slot"), e.get("slots_staged"),
                      e.get("pods_staged"))
                     for e in pkg.journal.JOURNAL.entries()
                     if e["kind"] == "loop.abandon"]
        finally:
            pkg.journal.configure("")
            c.shutdown()
        out[pkg.name] = (bound, m["loop_abandoned_slots"], notes)
    assert out["port"] == out["jax"]
    bound, n_abandoned, notes = out["port"]
    assert n_abandoned >= 1 and len(bound) < 24 and len(notes) == 1


def test_provenance_of_a_loop_run_matches_jax():
    """With the journal armed each bound pod's provenance record names the
    loop mode and its ring slot, field for field the JAX engine's (the
    wall-clock stamps aside)."""
    out = {}
    for pkg in (JAX, PORT):
        pkg.journal.configure("1")
        try:
            placed, m, sched = _burst(pkg, _config(pkg, True))
            recs = {k: {f: v for f, v in (sched.provenance(k) or {}).items()
                        if not f.endswith("_unix")} for k in placed}
        finally:
            pkg.journal.configure("")
        out[pkg.name] = recs
    assert out["port"] == out["jax"]
    modes = {r["mode"] for r in out["port"].values()}
    assert "loop" in modes
    assert any(r["loop_slot"] is not None and r["loop_slot"] > 0
               for r in out["port"].values())


def test_abandon_stops_the_engine_without_draining():
    """abandon(), the crash-stop: the loop stops and nothing scheduled
    afterwards binds, in both packages."""
    import time

    for pkg in (JAX, PORT):
        c = pkg.Cluster()
        try:
            c.create_node("n0", cpu=64000)
            c.start(pkg.Profile(**LOOP_PROFILE), _config(pkg, True),
                    with_pv_controller=False)
            sched = c.service.scheduler
            sched.abandon()
            assert sched._abandoned and sched._thread is None
            c.create_pod("late", cpu=10)
            time.sleep(0.5)
            assert not c.get_pod("late").spec.node_name, pkg.name
        finally:
            c.shutdown()

"""The maintained arbitration index (config.index; ops/index.py and the
engine's _ArbIndex, _index_dispatch, _settle_index) against the JAX
package.

Op level: build, refresh, append and assign against the JAX ops on the
same numpy inputs: the raw and feasible planes, the served score matrix,
the packed decision buffer and free_after, bitwise (tolerance none), at
scan widths 1, 16, 128 and N, with a real repair on column N-1 beside
padding slots. Engine level, the cases of tests/test_index.py, of
tests/test_faults.py:402 and the 64-class fallback: the same store
content and seed through both engines, placements and INDEX_COUNTERS
equal. index_races depends on timing (a cache mutation landing between
a batch's drain and its dispatch: the informer's confirmation of the
previous batch's binds), and a race moves the other index counters with
it. So the engine runs feed one batch a burst: the first is in the store
before the engine starts, each later one is created once the previous
is bound and the cache has been quiet for a while, and no confirmation
is in flight when a batch prepares. A pair of runs where either engine
still raced is run again (up to three times). Left out of the counter
comparison: the clocks.
"""
import time

import jax
import numpy as np
import pytest

from minisched_tpu.encode import NodeFeatureCache as JCache
from minisched_tpu.encode import encode_pods as jencode
from minisched_tpu.ops import index as jindex
from minisched_tpu.service.defaultconfig import Profile as JProfile
from minisched_tpu.state import objects as JO
from minisched_tpu_torch.encode import to_torch
from minisched_tpu_torch.engine.scheduler import _ArbIndex
from minisched_tpu_torch.ops import index as tindex
from minisched_tpu_torch.ops import prng
from minisched_tpu_torch.plugins.base import PluginSet
from minisched_tpu_torch.plugins.tainttoleration import TaintToleration
from minisched_tpu_torch.scenario.runner import wait_until
from minisched_tpu_torch.service.defaultconfig import Profile
from torch_obs_parity import JAX, PORT, disarm_all, engine_modes
from torch_parity import bench_cluster

PLUGINS = ["NodeUnschedulable", "NodeResourcesFit",
           "NodeResourcesLeastAllocated"]
INDEX_COUNTERS = ("batches", "steps_dispatched", "decision_fetches",
                  "index_hits", "index_rebuilds", "index_appends",
                  "index_fallbacks", "index_repair_rows",
                  "index_uncertified", "index_checks", "index_desyncs",
                  "index_cooldowns", "index_width",
                  "index_classes_registered", "scored_rows_total",
                  "fetch_bytes_total", "batch_faults", "pods_bound")


@pytest.fixture(autouse=True)
def _disarmed():
    disarm_all()
    yield
    disarm_all()


def _profile(plugins=None):
    return dict(name="idx", plugins=list(plugins or PLUGINS))


def _config(pkg, index, **kw):
    kw.setdefault("max_batch_size", 6)
    kw.setdefault("batch_window_s", 0.3)
    kw.setdefault("backoff_initial_s", 0.05)
    kw.setdefault("backoff_max_s", 0.2)
    kw.setdefault("index_k", 8)
    return pkg.config(index=index, **kw)


def _pods(O, n, *, shapes=0, cpu0=100, pri0=1000, prefix=""):
    """Index-safe pods: ``shapes=0`` one class a pod (distinct request
    and priority); ``shapes=k`` k classes shared across bursts."""
    pods = []
    for i in range(n):
        if shapes:
            name, pri, cpu = f"{prefix}p{i}x0", pri0, cpu0 + (i % shapes) * 50
        else:
            name, pri, cpu = f"{prefix}p-{i}", pri0 - i, cpu0 + 17 * i
        pods.append(O.Pod(metadata=O.ObjectMeta(name=name,
                                                namespace="default"),
                          spec=O.PodSpec(requests={"cpu": cpu},
                                         priority=pri)))
    return pods


def _run(pkg, config, bursts, *, plugins=None,
         node_cpus=(64000, 48000, 40000, 36000), node_taints=None,
         nodes=None, spec="", between=None, expect=None, journal=False,
         bundles=False, timeout=120.0):
    """One engine run. ``bursts(O)`` returns a list of pod lists: the first
    is in the store with the nodes before the engine starts, each later
    one is created once the previous settled, after ``between(cluster,
    i)``. ``nodes(O)`` replaces the ``node_cpus`` nodes. Waits for
    ``expect`` (default: every pod) bound. ``journal`` arms the journal
    and returns its index.* kinds and rebuild causes; ``bundles`` arms
    incident bundles in a fresh directory and returns its listing.
    Returns (placements, metrics, extras)."""
    import tempfile

    O = pkg.O
    bursts = bursts(O)
    c = pkg.Cluster()
    x = {}
    bdir = tempfile.mkdtemp() if bundles else None
    try:
        if nodes is not None:
            c.create_objects(nodes(O))
        for i, cpu in enumerate(() if nodes is not None else node_cpus):
            c.create_node(f"n{i}", cpu=cpu,
                          taints=(node_taints(O) or {}).get(i)
                          if node_taints else None)
        c.create_objects(bursts[0])
        if journal:
            pkg.journal.configure("1")
        if bdir:
            pkg.bundle.configure(bdir)
        if spec:
            pkg.faults.configure(spec)
        c.start(pkg.Profile(**_profile(plugins)), config,
                with_pv_controller=False)
        sched = c.service.scheduler
        want = 0
        for bi, burst in enumerate(bursts):
            if bi:
                if between is not None:
                    between(c, bi - 1)
                    time.sleep(0.4)  # the informer lands the node update
                c.create_objects(burst)
            want += len(burst) if expect is None else expect[bi]
            assert wait_until(
                lambda: sched.metrics()["pods_bound"] >= want
                and sum(1 for p in c.list_pods() if p.spec.node_name)
                >= want, timeout=timeout), (pkg.name, bi, want)
            _quiet(sched.cache)
        assert wait_until(lambda: sched.metrics()["pods_assigned"] >= want,
                          timeout=30)
        placed = {p.key: p.spec.node_name for p in c.list_pods()
                  if p.spec.node_name}
        x["parked"] = {p.key: sorted(p.status.unschedulable_plugins)
                       for p in c.list_pods() if not p.spec.node_name}
        x["sched"] = sched
        if journal:
            entries = pkg.journal.JOURNAL.entries()
            x["kinds"] = [e["kind"] for e in entries
                          if e["kind"].startswith(("index.", "loop."))]
            x["causes"] = [e.get("cause") for e in entries
                           if e["kind"] == "index.rebuild"]
        if bdir:
            import os

            x["bundles"] = sorted(os.listdir(bdir))
        return placed, sched.metrics(), x
    finally:
        pkg.faults.configure("")
        pkg.journal.configure("")
        pkg.bundle.configure("")
        c.shutdown()


def _quiet(cache, span=0.15) -> None:
    """Wait until the cache's version holds still for ``span`` seconds:
    the informer has confirmed every bind."""
    last = cache.version
    while True:
        time.sleep(span)
        if cache.version == last:
            return
        last = cache.version


def _pair(cfg_fn, bursts, **kw):
    """The same run on both engines, again (up to three times) while
    either saw an index race. Returns ((jax placements, metrics, extra),
    (port ...))."""
    for _ in range(3):
        j = _run(JAX, cfg_fn(JAX), bursts, **kw)
        p = _run(PORT, cfg_fn(PORT), bursts, **kw)
        if j[1]["index_races"] == 0 and p[1]["index_races"] == 0:
            break
    assert j[1]["index_races"] == 0 and p[1]["index_races"] == 0
    return j, p


def _same(jm, pm, keys=INDEX_COUNTERS):
    for k in keys:
        assert jm[k] == pm[k], (k, jm[k], pm[k])


# ---- op level ---------------------------------------------------------------


def _raw_setup(n_nodes=12, n_pods=8, seed=3):
    rng = np.random.default_rng(seed)
    cache = JCache(capacity=max(16, n_nodes))
    for i in range(n_nodes):
        cache.upsert_node(JO.Node(
            metadata=JO.ObjectMeta(name=f"n{i}"), spec=JO.NodeSpec(),
            status=JO.NodeStatus(allocatable={
                "cpu": float(4000 + 1000 * int(rng.integers(0, 8))),
                "memory": float(64 << 30), "pods": 110.0})))
    pods = [JO.Pod(metadata=JO.ObjectMeta(name=f"p{i}x0",
                                          namespace="default"),
                   spec=JO.PodSpec(requests={
                       "cpu": float(250 * (1 + int(rng.integers(0, 3))))}))
            for i in range(n_pods)]
    eb = jencode(pods, 16, registry=cache.registry)
    nf, _names = cache.snapshot(pad=16)
    af = cache.snapshot_assigned(pad=16)
    return eb, nf, af


def _planes_equal(jstate, tstate):
    for f in ("raw", "feasible", "score"):
        want = np.asarray(getattr(jstate, f))
        got = getattr(tstate, f).numpy()
        if want.dtype == np.float32:
            want, got = want.view(np.int32), got.view(np.int32)
        np.testing.assert_array_equal(got, want, err_msg=f)


@pytest.mark.parametrize("k_eff", [1, 16, 128, 16_000])
def test_index_ops_match_jax(k_eff):
    """build, refresh (two columns narrowed, two widened into winners,
    the last column N-1 among them, padding slots beside it), append
    (a subset build completed) and assign at scan width ``k_eff`` (N
    when past the node pad) all equal the JAX ops bitwise."""
    plugins = PLUGINS + ["NodeResourcesBalancedAllocation"]
    jops = jindex.build_index_ops(JProfile(**_profile(plugins)).build(),
                                  k_eff)
    tops = tindex.build_index_ops(Profile(**_profile(plugins)).build(),
                                  k_eff)
    eb, nf, af = _raw_setup(n_nodes=16)
    pf_t, nf_t, af_t = (to_torch(x, "cpu") for x in (eb.pf, nf, af))
    # build
    js0 = jops[0](eb.pf, nf, af)
    ts0 = tops[0](pf_t, nf_t, af_t)
    _planes_equal(js0, ts0)
    # refresh: column 15 (= N-1) is a real node among the repairs
    free = np.array(nf.free)
    free[2] *= 0.25
    free[5] *= 0.5
    free[9] = free[9] * 4.0 + 100000.0
    free[15] = free[15] * 4.0 + 200000.0
    nf2 = nf._replace(free=free)
    nf2_t = to_torch(nf2, "cpu")
    rows_pad = np.full((8,), 16, dtype=np.int32)
    rows_pad[:4] = (2, 5, 9, 15)
    js1 = jops[1](js0, eb.pf, nf2, af, rows_pad)
    ts1 = tops[1](ts0, pf_t, nf2_t, af_t, rows_pad)
    _planes_equal(js1, ts1)
    _planes_equal(jops[0](eb.pf, nf2, af), ts1)  # = a fresh build
    # append: a five-class build completed by the other rows
    part = np.array(eb.pf.valid).copy()
    part[5:] = False
    jsub = jops[0](eb.pf._replace(valid=part), nf, af)
    tsub = tops[0](pf_t._replace(valid=to_torch(part, "cpu")), nf_t, af_t)
    _planes_equal(jsub, tsub)
    app = np.full((16,), 16, dtype=np.int32)
    app[:11] = np.arange(5, 16, dtype=np.int32)
    _planes_equal(jops[2](jsub, eb.pf, nf, af, app),
                  tops[2](tsub, pf_t, nf_t, af_t, app))
    _planes_equal(js0, tops[2](tsub, pf_t, nf_t, af_t, app))
    # assign over the refreshed state
    cls = np.arange(16, dtype=np.int32)
    jkey = jax.random.fold_in(jax.random.PRNGKey(7), 3)
    jpacked, jfree = jops[3](js1, cls, eb.pf.valid, eb.pf.requests, free,
                             jkey)
    tpacked, tfree = tops[3](ts1, to_torch(cls, "cpu"), pf_t.valid,
                             pf_t.requests, to_torch(free, "cpu"),
                             prng.fold_in(prng.PRNGKey(7), 3))
    np.testing.assert_array_equal(tpacked.numpy(), np.asarray(jpacked))
    np.testing.assert_array_equal(tfree.numpy().view(np.int32),
                                  np.asarray(jfree).view(np.int32))
    chosen, assigned, _rep = tindex.unpack_index_decision(
        tpacked.numpy().copy(), 16)
    assert assigned.sum() > 0
    assert tindex.index_buffer_bytes(16) == jindex.index_buffer_bytes(16) \
        == tpacked.numel()


def test_corrupt_slab_matches_jax():
    score = np.random.default_rng(0).random((5, 7)).astype(np.float32)
    for n_live in (1, 7):
        np.testing.assert_array_equal(
            tindex.corrupt_slab(to_torch(score, "cpu"), n_live).numpy(),
            np.asarray(jindex.corrupt_slab(jax.numpy.asarray(score),
                                           n_live)))


def test_index_eligibility_matches_jax():
    """Topology or affinity state and plugins that are not column-local
    keep a profile out, as in the JAX package; a declared row-local
    normalize (TaintToleration's min-shift) is eligible, an undeclared
    override is not."""
    for plugins in (PLUGINS, PLUGINS + ["PodTopologySpread"],
                    PLUGINS + ["NodeAffinity"],
                    PLUGINS + ["TaintToleration"],
                    ["NodeUnschedulable", "NodeResourcesFit", "NodeNumber"]):
        assert tindex.index_eligible(Profile(**_profile(plugins)).build()) \
            == jindex.index_eligible(JProfile(**_profile(plugins)).build()), \
            plugins

    class _Undeclared(TaintToleration):
        name = "UndeclaredNormalize"
        normalize_row_local = False

    base = Profile(**_profile()).build()
    assert not tindex.index_eligible(
        PluginSet(base.plugins + [_Undeclared()], base.weights))


def test_seventy_bench_classes_overflow_the_default_registry():
    """The bench pods (pod-{i}-{i % 10}, 7 CPU sizes) make 70 classes: a
    class is the whole feature row, the name suffix included. The
    default registry of 64 returns None (a counted fallback) where 128
    holds them all."""
    from minisched_tpu_torch.encode import NodeFeatureCache, encode_pods
    from minisched_tpu_torch.state import objects as TO

    _nodes, pods = bench_cluster(TO, 16, 1024, 0)
    cache = NodeFeatureCache()
    eb = encode_pods(pods, 1024, cfg=cache.cfg, registry=cache.registry)
    full = _ArbIndex(None, 8, 128)
    assert full.classify(eb.pf, 1024) is not None
    assert len(full.rows) == 70
    assert _ArbIndex(None, 8, 64).classify(eb.pf, 1024) is None


# ---- engine level: bit identity --------------------------------------------


def _one(n, size=None, **kw):
    """``n`` pods (``_pods``' keywords), in bursts of ``size`` (one batch
    each), or one burst."""
    def make(O):
        pods = _pods(O, n, **kw)
        step = size or n
        return [pods[i:i + step] for i in range(0, n, step)]
    return make


@pytest.mark.parametrize("pipeline,resident,shortlist", engine_modes())
def test_index_matches_jax_per_mode(pipeline, resident, shortlist):
    """The index's placements and counters equal the JAX engine's in each
    of the six engine modes, and equal the port's placements without
    the index; the index really served."""
    def cfg(pkg, index=True):
        return _config(pkg, index, pipeline=pipeline,
                       device_resident=resident, shortlist=shortlist)

    (jp, jm, _), (pp, pm, _) = _pair(cfg, _one(18, 6))
    off, m_off, _ = _run(PORT, cfg(PORT, False), _one(18, 6))
    assert pp == jp == off
    _same(jm, pm)
    assert pm["index_hits"] >= 1 and pm["index_desyncs"] == 0
    assert m_off["index_hits"] == 0 and m_off["index_width"] == 0


def test_index_with_the_device_loop_matches_jax():
    """Loop and index both on: the placements and counters equal the JAX
    engine's. An index-served batch has no Decision to check the first
    slim fetch against, so in both packages the ring stays closed while
    the index serves."""
    def cfg(pkg):
        return _config(pkg, True, device_loop=True, loop_depth=4)

    (jp, jm, _), (pp, pm, _) = _pair(cfg, _one(18, 6))
    assert pp == jp
    _same(jm, pm, INDEX_COUNTERS + ("loop_tranches", "loop_iterations",
                                    "loop_breaks"))


def test_row_normalized_profile_matches_jax():
    """TaintToleration's min-shift normalize rides the index (the raw
    untolerated counts are kept per column, the shift re-derived by the
    finalize pass): with a PreferNoSchedule taint on n0 the placements
    equal the JAX engine's and the index-off run's."""
    def taints(O):
        return {0: [O.Taint(key="ded", value="gpu",
                            effect="PreferNoSchedule")]}

    kw = dict(plugins=PLUGINS + ["TaintToleration"], node_taints=taints)
    (jp, jm, _), (pp, pm, _) = _pair(lambda pkg: _config(pkg, True),
                                     _one(18, 6), **kw)
    off, _m, _ = _run(PORT, _config(PORT, False), _one(18, 6), **kw)
    assert pp == jp == off
    _same(jm, pm)
    assert pm["index_hits"] >= 1
    assert any(v != "n0" for v in off.values())


def test_index_off_registers_nothing():
    """index=False: no index, no listener, zero gauges and counters, the
    full step's scored-rows ledger."""
    (jp, jm, _), (pp, pm, px) = _pair(lambda pkg: _config(pkg, False),
                                      _one(8, 6))
    assert pp == jp
    assert px["sched"]._index is None
    assert pm["index_hits"] == pm["index_rebuilds"] == pm["index_width"] == 0
    assert pm["scored_rows_total"] == jm["scored_rows_total"] > 0
    assert not px["sched"].cache._index_listeners


def test_ineligible_profile_keeps_the_per_batch_dataflow():
    (jp, jm, _), (pp, pm, px) = _pair(
        lambda pkg: _config(pkg, True), _one(10),
        plugins=PLUGINS + ["PodTopologySpread"])
    assert pp == jp and len(pp) == 10
    assert px["sched"]._index is None
    assert pm["index_width"] == 0 and pm["index_hits"] == 0


def _bursts(*specs):
    """Bursts named apart: each spec is _pods' keyword arguments."""
    def make(O):
        return [_pods(O, n, prefix=f"b{i}", **kw)
                for i, (n, kw) in enumerate(specs)]
    return make


def test_steady_state_served_by_refresh_as_in_jax():
    """Bursts of two repeated classes: one rebuild, then in-place
    repairs; every served batch's scored rows under the full step's
    P_pad x N; counters and placements equal the JAX engine's."""
    bursts = _bursts((24, dict(shapes=2)), (24, dict(shapes=2)),
                     (24, dict(shapes=2)))

    def cfg(pkg, index=True):
        return _config(pkg, index, pipeline=False, max_batch_size=24,
                       index_classes=32)

    (jp, jm, _), (pp, pm, _) = _pair(cfg, bursts)
    off, m_off, _ = _run(PORT, cfg(PORT, False), bursts)
    assert pp == jp == off
    _same(jm, pm)
    assert pm["batch_series"]["scored_rows"] == \
        jm["batch_series"]["scored_rows"]
    assert pm["index_hits"] >= 2 and pm["index_repair_rows"] >= 1
    full_cost = m_off["scored_rows_total"] / max(1, int(m_off["batches"]))
    assert all(s < full_cost for s in pm["batch_series"]["scored_rows"])


def test_contention_repairs_in_scan_as_in_jax():
    """K=1 with one class contending for the best node: the scan's
    certificate refuses and repairs in place (counted); the batch still
    serves and equals the JAX engine's."""
    kw = dict(node_cpus=(8000, 7000, 6500, 6000, 9000, 7500))
    (jp, jm, _), (pp, pm, _) = _pair(
        lambda pkg: _config(pkg, True, index_k=1, pipeline=False),
        _one(10, 6, shapes=1, cpu0=3000), **kw)
    assert pp == jp
    _same(jm, pm)
    assert pm["index_hits"] >= 1 and pm["index_uncertified"] >= 1


def test_unassigned_row_falls_back_to_the_full_step_as_in_jax():
    """A pod no node fits: the speculative result is discarded, the full
    step runs with the same draw, the doomed pod parks with the full
    step's plugin attribution, its batch-mates place as without the
    index; the fallback is counted and journaled as in the JAX
    engine."""
    def burst(O):
        pods = _pods(O, 5, shapes=1)
        pods.append(O.Pod(metadata=O.ObjectMeta(name="doom",
                                                namespace="default"),
                          spec=O.PodSpec(requests={"cpu": 10 ** 9},
                                         priority=1)))
        return [pods]

    kw = dict(node_cpus=(64000, 48000), expect=[5])
    (jp, jm, jx), (pp, pm, px) = _pair(
        lambda pkg: _config(pkg, True, pipeline=False), burst,
        journal=True, **kw)
    off, _m, _x = _run(PORT, _config(PORT, False, pipeline=False), burst,
                       **kw)
    assert pp == jp == off
    assert px["parked"]["default/doom"] == jx["parked"]["default/doom"]
    assert px["parked"]["default/doom"]
    _same(jm, pm)
    assert pm["index_fallbacks"] >= 1
    assert px["kinds"] == jx["kinds"] and "index.fallback" in px["kinds"]


def test_registry_overflow_is_a_counted_fallback_as_in_jax():
    (jp, jm, _), (pp, pm, _) = _pair(
        lambda pkg: _config(pkg, True, index_classes=2, pipeline=False),
        _one(12, 6))
    assert pp == jp and len(pp) == 12
    _same(jm, pm)
    assert pm["index_fallbacks"] >= 1 and pm["index_desyncs"] == 0


def test_seventy_classes_at_64_are_fallbacks_in_both_packages():
    """The bench workload's 70 classes against the default registry of
    64: every batch is a counted fallback in both engines, and the
    placements are the JAX engine's."""
    def bench(O):
        pods = bench_cluster(O, 1, 700, 0)[1]
        return [pods[:350], pods[350:]]

    def nodes(O):
        return bench_cluster(O, 120, 1, 0)[0]

    (jp, jm, _), (pp, pm, _) = _pair(
        lambda pkg: pkg.config(index=True, max_batch_size=350),
        bench, nodes=nodes,
        plugins=PLUGINS + ["NodeResourcesBalancedAllocation"])
    assert pp == jp and len(pp) == 700
    _same(jm, pm)
    assert pm["index_fallbacks"] == pm["batches"] == 2
    assert pm["index_hits"] == 0 and pm["index_classes_registered"] == 64


def test_clean_cross_check_passes_as_in_jax():
    (jp, jm, _), (pp, pm, _) = _pair(
        lambda pkg: _config(pkg, True, index_check_every=1, pipeline=False),
        _one(12, 6))
    assert pp == jp
    _same(jm, pm)
    assert pm["index_checks"] >= 1 and pm["index_desyncs"] == 0
    assert pm["index_width"] > 0


def test_index_corrupt_caught_by_the_cross_check():
    """tests/test_faults.py:402 on both engines: ``index:corrupt``
    scribbles one served entry per class; the cross-check catches it,
    counts one desync, disables the index (width 0), writes the
    index_revert bundle, and the supervised replay lands every pod on
    the fault-free run's node."""
    def cfg(pkg):
        return _config(pkg, True, pipeline=False, index_check_every=1)

    (jr, jrm, _), (pr, prm, _) = _pair(cfg, _one(12, 6))
    (jp, jm, jx), (pp, pm, px) = _pair(cfg, _one(12, 6),
                                       spec="index:corrupt@2",
                                       bundles=True, journal=True)
    assert pp == jp == pr == jr
    for k in ("fault_fires_index", "batch_faults", "supervisor_escalations",
              "degradation_state") + INDEX_COUNTERS:
        assert pm[k] == jm[k], k
    assert pm["index_desyncs"] == 1 and pm["index_width"] == 0
    assert pm["batch_faults"] == 1
    assert px["bundles"] == jx["bundles"]
    assert any(n.startswith("incident-index_revert") for n in px["bundles"])
    assert px["kinds"] == jx["kinds"]
    assert "index.desync" in px["kinds"] and "index.disable" in px["kinds"]


# ---- the index and the residency -------------------------------------------


def test_residency_desync_invalidates_and_rebuilds_as_in_jax():
    """A carry desync (residency:corrupt and the every-batch carry check)
    invalidates the index, whose last refresh scored against the
    distrusted carry; the next index batch rebuilds (counted, journaled
    as index.invalidate) and the placements equal the index-off run's."""
    bursts = _bursts((6, {}), (6, dict(cpu0=300)), (6, dict(cpu0=500)),
                     (6, dict(cpu0=700)))

    def cfg(pkg, index=True):
        return _config(pkg, index, pipeline=False, resident_check_every=1,
                       probation_batches=1)

    (jp, jm, jx), (pp, pm, px) = _pair(cfg, bursts,
                                       spec="residency:corrupt@2",
                                       journal=True)
    off, _m, _x = _run(PORT, _config(PORT, False, pipeline=False), bursts)
    assert pp == jp == off
    _same(jm, pm, INDEX_COUNTERS + ("residency_desyncs",))
    assert pm["residency_desyncs"] >= 1 and pm["index_rebuilds"] >= 2
    assert pm["index_desyncs"] == 0
    assert px["kinds"] == jx["kinds"] and "index.invalidate" in px["kinds"]


def test_narrowing_repairs_and_widening_rebuilds_as_in_jax():
    """A cordon (narrowing) is repaired in place with no rebuild; the
    uncordon (widening) bumps the invalidation epoch and the next index
    batch rebuilds, in both engines alike."""
    bursts = _bursts((6, dict(shapes=2)), (6, dict(shapes=2)),
                     (6, dict(shapes=2)))
    seen = {}

    def between(c, i):
        m = c.service.scheduler.metrics()
        seen.setdefault(c, []).append(int(m["index_rebuilds"]))
        if i == 0:
            c.cordon("n1")
        else:
            c.uncordon("n1")

    def cfg(pkg):
        return _config(pkg, True, pipeline=False, max_batch_size=8,
                       index_classes=32)

    (jp, jm, _), (pp, pm, _) = _pair(cfg, bursts, between=between)
    assert pp == jp
    _same(jm, pm)
    assert not any(v == "n1" for k, v in pp.items() if "/b1" in k)
    rebuilds = list(seen.values())[-1]
    assert int(pm["index_rebuilds"]) == rebuilds[1] + 1
    assert pm["index_repair_rows"] >= 1


def test_loop_tranche_break_leaves_the_index_consistent_as_in_jax():
    """Loop and index with a step fault breaking a tranche: the replay
    runs per batch, the delta protocol keeps the index consistent, and
    the placements equal the fault-free run without either."""
    def cfg(pkg):
        return _config(pkg, True, device_loop=True, loop_depth=4,
                       probation_batches=1)

    (jp, jm, _), (pp, pm, _) = _pair(cfg, _one(18), spec="step:err@2")
    off, _m, _x = _run(PORT, _config(PORT, False), _one(18))
    assert pp == jp == off
    _same(jm, pm, INDEX_COUNTERS + ("loop_breaks", "fault_fires_step"))
    assert pm["fault_fires_step"] == 1 and pm["index_desyncs"] == 0


def test_k_dial_moves_are_live_and_rebuild_free_as_in_jax():
    """The K-dial on the indexed-scan width: a narrow (1) and a widen
    (4 x base) take effect at the next batch with no rebuild; placements
    equal the JAX engine's and the index-off run's."""
    dial = {}

    def between(c, i):
        sched = c.service.scheduler
        idx = sched._index
        idx.k_target = 1 if i == 0 else idx.k_base * 4
        dial.setdefault(c, []).append(int(sched.metrics()["index_rebuilds"]))

    bursts = _bursts((6, dict(shapes=2)), (6, dict(shapes=2)),
                     (6, dict(shapes=2)))

    def cfg(pkg, index=True):
        return _config(pkg, index, pipeline=False, max_batch_size=8,
                       index_classes=32)

    (jp, jm, _), (pp, pm, _) = _pair(cfg, bursts, between=between)
    off, _m, _x = _run(PORT, cfg(PORT, False), bursts)
    assert pp == jp == off
    _same(jm, pm)
    got = list(dial.values())[-1]
    assert int(pm["index_rebuilds"]) == got[0] == got[1]


def test_overload_k_dial_and_its_disarm_reach_the_index():
    """The overload controller's shortlist target also retunes the
    indexed-scan width, and a runtime disarm restores the configured
    width, in both engines alike (the controller's verdicts stubbed)."""
    out = {}
    for pkg in (JAX, PORT):
        c = pkg.Cluster()
        try:
            c.start(pkg.Profile(**_profile()),
                    _config(pkg, True, index_k=32), with_pv_controller=False)
            sched = c.service.scheduler
            ov = sched._overload
            pkg.slo.configure("create_bound_p99=1000")
            sched._slo_sentinel = pkg.slo.SLOSentinel.from_config(
                pkg.slo.SLO)
            ov.note_window = lambda *a, **k: True
            ov.shortlist_target = lambda base: None if base is None \
                else base * 2
            sched._drive_overload({})
            widened = sched._index.k_target
            sched._overload_disarm_check()
            out[pkg.name] = (widened, sched._index.k_target)
        finally:
            pkg.slo.configure("")
            c.shutdown()
    assert out["port"] == out["jax"] == (64, 32)


def test_fresh_class_in_bucket_appends_without_rebuild_as_in_jax():
    bursts = _bursts((12, dict(shapes=2)), (12, dict(shapes=4)))

    def cfg(pkg, index=True):
        return _config(pkg, index, pipeline=False, max_batch_size=24,
                       index_classes=32)

    (jp, jm, _), (pp, pm, _) = _pair(cfg, bursts)
    off, _m, _x = _run(PORT, cfg(PORT, False), bursts)
    assert pp == jp == off
    _same(jm, pm)
    assert pm["index_appends"] >= 1 and pm["index_rebuilds"] == 1


def test_class_pad_crossing_rebuilds_with_its_cause_as_in_jax():
    """A deterministic trigger for the JAX test's class-pad crossing:
    every burst is one batch. Burst 0 registers 10 classes (pad 16,
    cold), burst 1 appends 4 (14), burst 2 brings 8 more (22, past the
    pad): that rebuild's journaled cause is "class-pad", in both
    engines."""
    bursts = _bursts((10, dict(shapes=10)), (4, dict(shapes=4, cpu0=2000)),
                     (8, dict(shapes=8, cpu0=4000)))
    (jp, jm, jx), (pp, pm, px) = _pair(
        lambda pkg: _config(pkg, True, pipeline=False, max_batch_size=12,
                            index_classes=32), bursts, journal=True)
    assert pp == jp
    _same(jm, pm)
    # The first cause is the node sync's invalidation epoch (the nodes
    # arrive after the engine registers its listener), then the crossing.
    assert px["causes"] == jx["causes"]
    assert px["causes"][-1] == "class-pad" and len(px["causes"]) == 2
    assert pm["index_appends"] == 4
    assert pm["index_rebuilds"] == 2


def test_provenance_of_an_index_run_matches_jax():
    """With the journal armed each pod's provenance record names its
    index posture, "hit" or "fallback" (the doomed pod's batch), field
    for field the JAX engine's (the wall-clock stamps aside)."""
    def bursts(O):
        served = _pods(O, 6, shapes=2, prefix="a")
        doomed = _pods(O, 3, shapes=1, prefix="b", cpu0=300)
        doomed.append(O.Pod(metadata=O.ObjectMeta(name="doom",
                                                  namespace="default"),
                            spec=O.PodSpec(requests={"cpu": 10 ** 9},
                                           priority=1)))
        return [served, doomed]

    (jp, jm, jx), (pp, pm, px) = _pair(
        lambda pkg: _config(pkg, True, pipeline=False), bursts,
        journal=True, expect=[6, 3])

    def records(x, placed):
        return {k: {f: v for f, v in (x["sched"].provenance(k) or {}).items()
                    if not f.endswith("_unix")}
                for k in list(placed) + ["default/doom"]}

    assert pp == jp
    want, got = records(jx, jp), records(px, pp)
    assert got == want
    assert {r.get("index") for r in got.values()} == {"hit", "fallback"}

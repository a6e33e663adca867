"""Fused multi-tenant arbitration on the port (service.service.
TenantFusionCoordinator, encode/cache.TenantCacheMux, ops/pipeline.
build_tenant_step) against the JAX package.

Op level: the port's build_tenant_step against the JAX one on the same
lanes (weights, keys, free rows and live pod counts that differ from
lane to lane, one pod pad), every lane's packed (6+F, P) decision and
its free after bitwise (tolerance none); each lane also equals the
port's per-batch step on its inputs. Coordinator level, the cases of
tests/test_tenants.py: every round single-stepped on quiet caches
(tests/torch_tenant_parity.py), the port's per-tenant placements equal
the JAX coordinator's, fused and sequential, in the sync, pipelined,
upload and index modes, and the deterministic counters are equal across
packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from minisched_tpu.encode import NodeFeatureCache as JCache
from minisched_tpu.encode import encode_pods as jencode
from minisched_tpu.ops.pipeline import build_tenant_step as jbuild_tenant
from minisched_tpu.service.defaultconfig import Profile as JProfile
from minisched_tpu.state import objects as JO
from minisched_tpu_torch.encode import to_torch
from minisched_tpu_torch.engine import overload
from minisched_tpu_torch.ops import prng
from minisched_tpu_torch.ops import select as S
from minisched_tpu_torch.ops.pipeline import build_step, build_tenant_step
from minisched_tpu_torch.ops.residency import pack_decision_i32
from minisched_tpu_torch.service.defaultconfig import Profile
from minisched_tpu_torch.service.service import (Tenant,
                                                 TenantFusionCoordinator,
                                                 tenants_fuse_from_env)
from torch_obs_parity import disarm_all
from torch_parity import BENCH_PROFILE, bench_cluster, build_cache
import torch_tenant_parity as TP

NAMES3 = ["t0", "t1", "t2"]


@pytest.fixture(autouse=True)
def _disarmed():
    disarm_all()
    yield
    disarm_all()


# ---- op level ---------------------------------------------------------------


def _lanes(O, cache, T=3, P=16):
    """T ragged lanes (7, 5, 3, ... pods) encoded at one pod pad."""
    out = []
    for t in range(T):
        pods = [O.Pod(metadata=O.ObjectMeta(name=f"l{t}-{i}",
                                            namespace="default"),
                      spec=O.PodSpec(requests={"cpu": 250 * (1 + (i + t) % 6)},
                                     priority=100 - i))
                for i in range(7 - 2 * t)]
        out.append(jencode(pods, P, cfg=cache.cfg, registry=cache.registry))
    return out


@pytest.mark.parametrize("shortlist", [128, 1, None])
def test_tenant_step_matches_jax(shortlist):
    """Each lane's packed planes and free after equal the JAX fused
    step's bitwise; lanes differ in weights, keys, free rows and live
    pods (a ragged pad); K = 1 forces repairs; shortlist off runs the
    greedy assignment per lane."""
    nodes, _ = bench_cluster(JO, 40, 8, 3)
    cache = build_cache(JCache, nodes)
    nf, _names, _sv, _incs = cache.snapshot_versioned(pad=48)
    af = cache.snapshot_assigned(pad=16)
    lanes = _lanes(JO, cache)
    T = len(lanes)
    frees = [np.minimum(nf.free, cap).astype(np.float32)
             for cap in (np.inf, 3000.0, 1500.0)]
    counters = [11, 12, 40]
    w_stack = np.array([[1.0, 1.0], [2.0, 1.0], [1.0, 3.0]],
                       dtype=np.float32)
    jfused = jbuild_tenant(JProfile(**BENCH_PROFILE).build(),
                           cfg=cache.cfg, shortlist=shortlist)
    eb_stack = jax.tree_util.tree_map(lambda *xs: np.stack(xs), *lanes)
    nf_stack = nf._replace(free=np.stack(frees),
                           used_ports=np.stack([nf.used_ports] * T))
    af_stack = jax.tree_util.tree_map(lambda *xs: np.stack(xs), *[af] * T)
    jkey = jax.random.PRNGKey(5)
    keys = jnp.stack([jax.random.fold_in(jkey, c) for c in counters])
    want_packed, want_free = jfused(eb_stack, nf_stack, af_stack, keys,
                                    w_stack)
    want_packed, want_free = np.asarray(want_packed), np.asarray(want_free)

    pset = Profile(**BENCH_PROFILE).build()
    step = build_tenant_step(pset, shortlist=shortlist)
    base = prng.PRNGKey(5)
    pkeys = [prng.fold_in(base, c) for c in counters]
    ebs = [to_torch(eb, "cpu") for eb in lanes]
    nfs = [to_torch(nf._replace(free=f), "cpu") for f in frees]
    afs = [to_torch(af, "cpu")] * T
    packed, free = step(ebs, nfs, afs, pkeys, w_stack)
    assert tuple(packed.shape) == want_packed.shape
    for t in range(T):
        np.testing.assert_array_equal(packed[t].numpy(), want_packed[t])
        np.testing.assert_array_equal(free[t].numpy().view(np.int32),
                                      want_free[t].view(np.int32))
    if shortlist == 1:  # the top node alone never certifies a tie
        assert want_packed[:, 5].any()
    # Each lane is the per-batch step on its own inputs, weights and key.
    solo = build_step(pset, shortlist=shortlist)
    for t in range(T):
        d = solo(ebs[t], nfs[t], afs[t], pkeys[t], has_gang=False,
                 hard_spread=False, w_vec=w_stack[t])
        np.testing.assert_array_equal(
            packed[t].numpy(),
            pack_decision_i32(d.chosen, d.assigned, d.gang_rejected,
                              d.feasible_counts, d.feasible_static,
                              d.reject_counts,
                              d.shortlist_repaired).numpy())
    # The tenant step is memoized without the weights.
    assert build_tenant_step(pset, shortlist=shortlist) is step


def test_weight_seam_keeps_the_solo_step_bitwise():
    """w_vec with the profile's own weights gives the step's decision
    bit for bit (equal float32 multiplies), and doubled weights double
    the totals."""
    import torch

    nodes, _ = bench_cluster(JO, 40, 8, 3)
    cache = build_cache(JCache, nodes)
    nf, _n, _v, _i = cache.snapshot_versioned(pad=48)
    eb = to_torch(_lanes(JO, cache)[0], "cpu")
    nf = to_torch(nf, "cpu")
    af = to_torch(cache.snapshot_assigned(pad=16), "cpu")
    pset = Profile(**BENCH_PROFILE).build()
    step = build_step(pset, shortlist=128)
    key = prng.PRNGKey(3)
    own = np.array([pset.weight_of(p) for p in pset.score_plugins],
                   dtype=np.float32)
    a = step(eb, nf, af, key, has_gang=False, hard_spread=False)
    b = step(eb, nf, af, key, has_gang=False, hard_spread=False, w_vec=own)
    for x, y in zip(a, b):
        assert x.shape == y.shape and torch.equal(x, y)
    # Doubled weights double every feasible total exactly.
    ex = build_step(pset, shortlist=128, explain=True)
    one = ex(eb, nf, af, key, has_gang=False, hard_spread=False, w_vec=own)
    two = ex(eb, nf, af, key, has_gang=False, hard_spread=False,
             w_vec=2 * own)
    feas = one.total_scores > S.NEG
    assert feas.any()
    assert torch.equal(two.total_scores[feas], 2 * one.total_scores[feas])


def test_lane_form_equals_the_solo_shortlist_assignment():
    """greedy_assign_shortlist_lanes on CPU tensors: each lane equals
    greedy_assign_shortlist with the lane's seed (the plain versions of
    the lane kernels), repairs included."""
    import torch

    rng = np.random.default_rng(7)
    T, P, N, R = 3, 12, 20, 3
    scores = torch.from_numpy(
        rng.integers(0, 4, (T, P, N)).astype(np.float32))
    scores[1, 3] = S.NEG
    req = torch.from_numpy(rng.integers(1, 4, (T, P, R)).astype(np.float32))
    free = torch.from_numpy(rng.integers(0, 6, (T, N, R)).astype(np.float32))
    seeds = [0xFFFFFFFF, 7, 0x80000001]
    r = S.greedy_assign_shortlist_lanes(scores, req, free, seeds, k=3)
    for t in range(T):
        want = S.greedy_assign_shortlist(scores[t], req[t], free[t],
                                         seeds[t], k=3)
        for x, y in zip(r, want):
            assert torch.equal(x[t], y)
    assert r.repaired.any()


# ---- coordinator level: bit identity -----------------------------------


MODES = [("sync", dict(pipeline=False)),
         ("pipelined", dict(pipeline=True)),
         ("upload", dict(device_resident=False)),
         ("index", dict(index=True, index_classes=32))]


@pytest.mark.parametrize("mode,kw", MODES)
def test_fused_matches_sequential_and_jax_per_mode(mode, kw):
    """Per tenant, the port's fused placements equal its sequential
    ones and the JAX coordinator's in both modes, and the deterministic
    counters equal the JAX package's: fusion engaged on every lane."""
    waves = [(10, 10, 10)]
    runs = {(pkg.name, fuse): TP.run(pkg, fuse, waves, **kw)
            for pkg in (TP.JAX, TP.PORT) for fuse in (0, 8)}
    ref = runs[("jax", 0)][0]
    for k, (placed, _m) in runs.items():
        assert placed == ref, (mode, k)
    assert sum(len(v) for v in ref.values()) == 30
    jm, pm = runs[("jax", 8)][1], runs[("port", 8)][1]
    TP.same_counters(jm, pm, NAMES3)
    TP.same_counters(runs[("jax", 0)][1], runs[("port", 0)][1], NAMES3)
    assert pm["tenant_lanes_fused"] >= 2, pm
    assert pm["tenant_lanes_fused"] + pm["tenant_solo_fallbacks"] >= 3


def test_ragged_tenant_batches_match_jax():
    """Ragged demand (3/11/6 pods) pads to the round's pod pad with
    invalid rows; placements equal the sequential run's and JAX's."""
    waves = [(3, 11, 6)]
    seq, _ = TP.run(TP.PORT, 0, waves)
    fused, pm = TP.run(TP.PORT, 8, waves)
    jfused, jm = TP.run(TP.JAX, 8, waves)
    assert fused == seq == jfused
    assert pm["tenant_lanes_fused"] == 3
    TP.same_counters(jm, pm, NAMES3)


def test_fused_issues_fewer_dispatches_and_fetches():
    """One fused group serves T lanes: dispatches and fetches collapse
    against the sequential run, as in the JAX package."""
    waves = [(8, 8, 8, 8)]
    _s, ms = TP.run(TP.PORT, 0, waves, n_tenants=4)
    _f, mf = TP.run(TP.PORT, 8, waves, n_tenants=4)
    rounds = mf["tenant_rounds"]
    assert mf["steps_dispatched_total"] == rounds
    assert mf["decision_fetches_total"] == rounds
    assert ms["steps_dispatched_total"] >= 4 * rounds
    assert ms["decision_fetches_total"] >= 4 * rounds
    assert mf["tenant_fetch_bytes"] > 0


def test_mid_round_race_falls_back_solo_as_in_jax():
    """A cache mutation between a lane's submit and the fused dispatch
    (through ``_pre_dispatch_hook``) sends that lane solo, counted, and
    the placements still equal the sequential run's."""
    waves = [(6, 6, 6)]
    seq, _ = TP.run(TP.PORT, 0, waves)
    out = {}
    for pkg in (TP.JAX, TP.PORT):
        fired = []

        def hook(coord, fired=fired):
            def pre():
                if not fired:
                    fired.append(1)
                    coord.engine("t0").cache.version += 1
            coord.mux._pre_dispatch_hook = pre

        out[pkg.name] = TP.run(pkg, 8, waves, hook=hook)
        assert fired
    (jp, jm), (pp, pm) = out["jax"], out["port"]
    assert pp == seq == jp
    assert pm["tenant_races"] == pm["tenant_solo_fallbacks"] == 1, pm
    assert pm["t0_tenant_races"] == 1 and pm["t1_tenant_races"] == 0
    TP.same_counters(jm, pm, NAMES3)


def test_coordinator_counts_kernel_free_lanes_on_the_cpu():
    """On CPU tensors the fused step takes the plain versions: no kernel
    is launched, and every lane's launches would be booked on lane 0."""
    _p, pm = TP.run(TP.PORT, 8, [(4, 4, 4)])
    assert all(pm[f"{nm}_kernel_launches"] == 0 for nm in NAMES3)


# ---- attribution never crosses tenants -----------------------------------


def test_provenance_and_journal_attribution_stay_per_tenant():
    """With the journal armed, every bound pod's provenance carries the
    owning tenant's profile and only its engine holds it; the journal's
    batch events are tagged per tenant."""
    from minisched_tpu_torch.obs import journal as journal_mod

    journal_mod.configure("1")
    names = ["t0", "t1"]
    tenants = [Tenant(name=nm, store=TP.mk_store(TP.PORT)) for nm in names]
    coord = TenantFusionCoordinator(tenants, TP.config(TP.PORT), fuse=8)
    try:
        coord.start()
        for nm in names:
            coord.store(nm).create_many(TP.pods(TP.PORT.O, 5, nm))
        TP._wait(lambda: sum(len(v) for v in TP.bound(coord, names).values())
                 == 10, what="binds")
        for nm, other in (("t0", "t1"), ("t1", "t0")):
            for i in range(5):
                key = f"default/{nm}-p{i}"
                rec = coord.engine(nm).provenance(key)
                assert rec is not None, key
                assert rec["profile"] == nm, rec
                assert coord.engine(other).provenance(key) is None
                assert coord.provenance(key)["profile"] == nm
        profiles = {e.get("profile") for e in journal_mod.JOURNAL.entries()
                    if e["kind"].startswith("batch")}
        assert profiles <= set(names), profiles
        assert coord.metrics()["tenant_lanes_fused"] >= 1
    finally:
        coord.shutdown()
        journal_mod.configure("")


# ---- per-tenant shed budgets ---------------------------------------------


def test_quiet_tenant_shed_budget_holds_under_noisy_burst():
    """A noisy tenant at the shedding rung sheds only ITS low-priority
    arrivals (a profile-scoped ``shed_priority``); the quiet tenant's
    pods of the same priority all bind."""
    overload.configure("shed_priority=0,hold=99,probation=99;"
                       "noisy:shed_priority=500")
    names = ["quiet", "noisy"]
    tenants = [Tenant(name=nm, store=TP.mk_store(TP.PORT)) for nm in names]
    coord = TenantFusionCoordinator(tenants, TP.config(TP.PORT), fuse=8)
    try:
        coord.start()
        coord.engine("noisy")._overload.level = 2
        O = TP.PORT.O
        coord.store("quiet").create_many(TP.pods(O, 4, "quiet", prio=0))
        coord.store("noisy").create_many(TP.pods(O, 4, "noisy", prio=0))
        coord.store("noisy").create_many(
            TP.pods(O, 2, "noisy-hi", prio=1000, cpu0=200))

        def done():
            b = TP.bound(coord, names)
            return len(b["quiet"]) == 4 and len(b["noisy"]) >= 2

        TP._wait(done, what="quiet's pods and noisy's high pods bound")
        b = TP.bound(coord, names)
        assert {f"noisy-hi-p{i}" for i in range(2)} <= set(b["noisy"])
        m = coord.metrics()
        assert m["noisy_shed_total"] >= 1, m
        assert m["quiet_shed_total"] == 0, m
    finally:
        coord.shutdown()


# ---- env knob, construction --------------------------------------------


def test_tenants_fuse_env_parsing(monkeypatch):
    monkeypatch.delenv("MINISCHED_TENANTS_FUSE", raising=False)
    assert tenants_fuse_from_env() == 0
    monkeypatch.setenv("MINISCHED_TENANTS_FUSE", "8")
    assert tenants_fuse_from_env() == 8
    monkeypatch.setenv("MINISCHED_TENANTS_FUSE", "junk")
    assert tenants_fuse_from_env() == 0
    monkeypatch.setenv("MINISCHED_TENANTS_FUSE", "")
    assert tenants_fuse_from_env() == 0
    monkeypatch.setenv("MINISCHED_TENANTS_FUSE", "4")
    coord = TenantFusionCoordinator(
        [Tenant(name="x", store=TP.mk_store(TP.PORT))],
        TP.config(TP.PORT))
    try:
        assert coord.fused and coord.mux.max_lanes == 4
        assert coord.engine("x")._tenant_mux is coord.mux
    finally:
        coord.shutdown()


def test_coordinator_rejects_duplicate_and_empty_tenants():
    with pytest.raises(ValueError):
        TenantFusionCoordinator([], fuse=0)
    with pytest.raises(ValueError):
        TenantFusionCoordinator(
            [Tenant(name="x", store=TP.mk_store(TP.PORT)),
             Tenant(name="x", store=TP.mk_store(TP.PORT))], fuse=0)


def test_engines_need_a_card_unless_the_platform_is_named():
    """The coordinator's engines run on cuda:0 unless the config names a
    device: with no card and platform="", construction raises."""
    import torch

    from minisched_tpu_torch.config import SchedulerConfig

    if torch.cuda.is_available():
        pytest.skip("a card is present: platform='' is valid here")
    with pytest.raises(Exception):
        TenantFusionCoordinator(
            [Tenant(name="x", store=TP.mk_store(TP.PORT))],
            SchedulerConfig(platform=""), fuse=8)


def test_unfused_lanes_of_differing_statics_stay_apart():
    """Lanes whose static node encodings differ (other node names) do not
    share a group: each takes its own fused dispatch, and the placements
    equal the sequential run's."""
    O = TP.PORT.O

    def run(fuse):
        stores = []
        for t in range(2):
            s = TP.mk_store(TP.PORT)
            s.create(O.Node(metadata=O.ObjectMeta(name=f"extra-{'ab'[t]}"),
                            spec=O.NodeSpec(),
                            status=O.NodeStatus(allocatable={
                                "cpu": 1000.0, "memory": float(1 << 30),
                                "pods": 110.0})))
            stores.append(s)
        coord = TenantFusionCoordinator(
            [Tenant(name=f"t{t}", store=stores[t]) for t in range(2)],
            TP.config(TP.PORT), fuse=fuse)
        try:
            for eng in coord.engines.values():
                eng._shared.ensure_started()
            for t in range(2):
                stores[t].create_many(TP.pods(O, 5, f"t{t}"))
            TP._wait(lambda: sum(e.queue.pending_count()
                                 for e in coord.engines.values()) == 10)
            TP.step_until_drained(coord, ["t0", "t1"])
            return TP.bound(coord, ["t0", "t1"]), coord.metrics()
        finally:
            coord.shutdown()

    seq, _ = run(0)
    fused, m = run(8)
    assert fused == seq
    assert m["tenant_groups_round_max"] == 2 and m["tenant_dispatches"] == 2

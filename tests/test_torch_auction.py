"""The port's auction assignment against the JAX package, bitwise
(tolerance 0: a one-ulp difference moves a winner): auction_assign_plain
and auction_assign_shortlist_plain on every output (chosen, assigned,
free_after, repaired) against the JAX functions as the engine runs them,
compiled; build_step(assignment="auction") on every Decision field; and
the engine's placements and shared counters under
SchedulerConfig(assignment="auction").

XLA's CPU backend contracts ``scores + noise * eps`` into one fused
multiply-add when it compiles the auction (an eager call rounds twice),
and ``v_best + noise * (eps / 2)`` inside the loop body always; the FMA
cases below are built so that one rounding and two pick different
winners."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _semantics_inputs
from minisched_tpu import faults as jfaults
from minisched_tpu.config import SchedulerConfig as JConfig
from minisched_tpu.encode import NodeFeatureCache as JCache
from minisched_tpu.encode import encode_pods as jencode
from minisched_tpu.ops.auction import auction_assign as jauction
from minisched_tpu.ops.bid_select import auction_assign_shortlist as jbid
from minisched_tpu.ops.pipeline import build_step as jbuild
from minisched_tpu.ops.select import tie_noise_from_cols as jnoise
from minisched_tpu.plugins import PluginSet as JPluginSet
from minisched_tpu.scenario.runner import Cluster as JCluster
from minisched_tpu.service.defaultconfig import Profile as JProfile
from minisched_tpu.service.defaultconfig import make_plugin as jmake
from minisched_tpu.state import objects as JO
from minisched_tpu_torch import faults
from minisched_tpu_torch.config import SchedulerConfig
from minisched_tpu_torch.encode import features as TF
from minisched_tpu_torch.encode import to_torch
from minisched_tpu_torch.ops import prng
from minisched_tpu_torch.ops.auction import (auction_assign,
                                             auction_assign_plain,
                                             max_rounds_for)
from minisched_tpu_torch.ops.bid_select import (
    auction_assign_shortlist, auction_assign_shortlist_plain)
from minisched_tpu_torch.ops.pipeline import build_step
from minisched_tpu_torch.plugins import PluginSet
from minisched_tpu_torch.scenario.runner import Cluster
from minisched_tpu_torch.service.defaultconfig import Profile
from minisched_tpu_torch.state import objects as TO
from minisched_tpu_torch.state.objects import pod_requests
from test_torch_engine import MODES, SHARED_METRICS, _run_cluster
from test_torch_faults import PORT, _fault_free, _run_burst
from test_torch_plugins_full import encode_both
from torch_parity import (AUCTION_CASES, AUCTION_SELECT_CASES, BENCH_PROFILE,
                          auction_adversarial, auction_fold_case,
                          auction_instance, auction_select_case,
                          auction_strength_case, auction_tie_case,
                          bench_cluster, bits_equal, build_cache,
                          port_plugin,
                          full_cluster, mixed_cluster, sampled_cluster)

NEG = -3.0e38
FIELDS = ("chosen", "assigned", "free_after")

_jit_auction = jax.jit(jauction, static_argnames=("eps", "max_rounds"))
_jit_bid = jax.jit(jbid, static_argnames=("eps", "max_rounds", "k"))


def _seed(s):
    return jax.random.PRNGKey(s), prng.bits(prng.PRNGKey(s))


def _same(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype == np.float32:
        a, b = a.view(np.int32), b.view(np.int32)
    return a.shape == b.shape and np.array_equal(a, b)


# Every instance runs through the JAX functions inside one padded shape,
# so that each static argument (k, max_rounds) costs one compile for all
# of them; an instance larger than the pad (the batch past the kernels'
# old cap) runs at its own shape.
PAD_P, PAD_N, PAD_R = 64, 320, 4


def _padded(scores, req, free, prio):
    """The instance inside PAD_P x PAD_N x PAD_R, deciding as the instance
    itself: NEG rows with zero requests (infeasible, so they never bid and
    the default budget, 9P+8, still cannot run out), NEG columns (below
    every real column in lax.top_k's order, so a shortlist of K <= N keeps
    its set and its kth) and axes requested and free at 0. A priority of
    None is all zeros, as in both packages."""
    P, N = scores.shape
    R = req.shape[1]
    pad_p, pad_n, pad_r = ((PAD_P, PAD_N, PAD_R)
                           if P <= PAD_P and N <= PAD_N and R <= PAD_R
                           else (P, N, R))
    s = np.full((pad_p, pad_n), NEG, np.float32)
    s[:P, :N] = scores
    r = np.zeros((pad_p, pad_r), np.float32)
    r[:P, :R] = req
    f = np.zeros((pad_n, pad_r), np.float32)
    f[:N, :R] = free
    pr = np.zeros((pad_p,), np.int32)
    if prio is not None:
        pr[:P] = prio
    return (jnp.asarray(s), jnp.asarray(r), jnp.asarray(f),
            jnp.asarray(pr))


class _Cut:
    """A JAX result cut back to the instance's P x N x R."""

    def __init__(self, res, P, N, R):
        self.chosen = np.asarray(res.chosen)[:P]
        self.assigned = np.asarray(res.assigned)[:P]
        self.free_after = np.asarray(res.free_after)[:N, :R]
        if hasattr(res, "repaired"):
            self.repaired = np.asarray(res.repaired)[:P]


def _run(scores, req, free, s, *, prio=None, k=None, max_rounds=None):
    """(JAX result, port result) of the dense auction (k None) or the bid
    shortlist at width k, on the same numpy inputs and seed (the JAX
    functions on the instance padded, the port on the instance)."""
    jkey, seed = _seed(s)
    *ja, jp = _padded(scores, req, free, prio)
    tp = None if prio is None else torch.from_numpy(
        np.asarray(prio, np.int32))
    ta = tuple(torch.from_numpy(np.ascontiguousarray(a))
               for a in (scores, req, free))
    if k is None:
        want = _jit_auction(*ja, jkey, max_rounds=max_rounds, priority=jp)
        got = auction_assign_plain(*ta, seed, max_rounds=max_rounds,
                                   priority=tp)
    else:
        want = _jit_bid(*ja, jkey, max_rounds=max_rounds, priority=jp, k=k)
        got = auction_assign_shortlist_plain(*ta, seed,
                                             max_rounds=max_rounds,
                                             priority=tp, k=k)
    return _Cut(want, *scores.shape, req.shape[1]), got


def _check(want, got, fields=FIELDS):
    for f in fields:
        assert _same(getattr(want, f), getattr(got, f).numpy()), f


def _noise(s):
    """The tie noise lattice of seed ``s`` (the JAX package's), as a
    function of (i, cols) for the instance searches."""
    seed = jax.random.bits(jax.random.PRNGKey(s), (), jnp.uint32)
    return lambda i, cols: np.asarray(jnoise(
        seed, jnp.asarray(i, jnp.uint32), jnp.asarray(cols, jnp.uint32)))


def _extra(k):
    return () if k is None else ("repaired",)


@pytest.mark.parametrize("case", sorted(AUCTION_CASES))
def test_auction_plain_matches_jax(case):
    """tests/test_auction.py's instances (random, scarce, contention,
    three priority bands, adversarial plateaus), a plateau, signed zeros,
    infeasible and padded rows."""
    make, prio, _widths = AUCTION_CASES[case]
    scores, req, free = make()
    want, got = _run(scores, req, free, 7, prio=prio)
    _check(want, got)
    assert got.assigned.sum() > 0


@pytest.mark.parametrize("case,k", [(c, k) for c in sorted(AUCTION_CASES)
                                    for k in AUCTION_CASES[c][2]])
def test_bid_shortlist_plain_matches_jax(case, k):
    """Every output, repaired included, at each case's widths (K=1, K=N
    and narrow shortlists that repair), and equal to the dense auction."""
    make, prio, _widths = AUCTION_CASES[case]
    scores, req, free = make()
    want, got = _run(scores, req, free, 7, prio=prio, k=k)
    _check(want, got, FIELDS + ("repaired",))
    _, dense = _run(scores, req, free, 7, prio=prio)
    _check(dense, got)
    if case == "plateau":
        assert int(got.repaired.sum()) == 0
    if case == "padded":
        assert not got.assigned[[2, 9, 16, 17, 18, 19]].any()
    if case == "signed zeros":
        assert int(got.assigned.sum()) == 12


@pytest.mark.parametrize("trial,P,N,k", [(0, 24, 48, 4), (1, 40, 64, 16),
                                         (2, 12, 24, 2), (3, 32, 32, 32)])
def test_bid_shortlist_widths_match_jax(trial, P, N, k):
    """tests/test_auction.py's width sweep with three priority bands."""
    scores, req, free = auction_instance(P, N, seed=20 + trial)
    prio = (np.arange(P) % 3) * 7
    want, got = _run(scores, req, free, trial, prio=prio, k=k)
    _check(want, got, FIELDS + ("repaired",))


@pytest.mark.parametrize("seed", range(6))
def test_bid_shortlist_adversarial_repairs_match_jax(seed):
    scores, req, free = auction_adversarial(seed)
    want, got = _run(scores, req, free, seed, k=2)
    _check(want, got, FIELDS + ("repaired",))
    if seed == 0:
        assert int(got.repaired.sum()) >= 1


@pytest.mark.parametrize("case", AUCTION_SELECT_CASES)
def test_bid_shortlist_selection_paths_match_jax(case):
    """The card's selection cases (tests/torch_parity.auction_select_case:
    ties at kth past the list's capacity, whole-row plateaus, zeros at
    kth, K = N, rows of 65,536 columns on every path) at their own
    shapes, unpadded: every output, repaired included, against the
    compiled JAX function."""
    scores, req, free, k = auction_select_case(case)
    jkey, seed = _seed(5)
    want = _jit_bid(jnp.asarray(scores), jnp.asarray(req), jnp.asarray(free),
                    jkey, k=k)
    got = auction_assign_shortlist_plain(
        *(torch.from_numpy(a) for a in (scores, req, free)), seed, k=k)
    _check(want, got, FIELDS + ("repaired",))
    assert int(got.assigned.sum()) > 0


def test_bid_shortlist_counts_closed_candidates_as_repairs():
    """An active pod whose candidates are all closed while kth > NEG is
    uncertified (m = NEG is not above kth): the dense round decides it
    and it counts as repaired, as in JAX."""
    # Pods 0-3 want nodes 0-1 most (K=2 holds exactly those); the nodes
    # fit one pod each, then close for every request of the band.
    scores = np.tile(np.array([[90, 80, 10, 5, 1]], np.float32), (4, 1))
    req = np.full((4, 1), 2.0, np.float32)
    free = np.array([[2], [2], [2], [2], [1]], np.float32)
    want, got = _run(scores, req, free, 3, k=2)
    _check(want, got, FIELDS + ("repaired",))
    assert int(got.repaired.sum()) >= 2
    assert int(got.assigned.sum()) == 4


@pytest.mark.parametrize("k", [None, 1, 2])
def test_fold_is_one_fused_multiply_add(k):
    scores, fused_winner = auction_fold_case(_noise(5))
    req = np.ones((1, 1), np.float32)
    free = np.ones((2, 1), np.float32)
    want, got = _run(scores, req, free, 5, k=k)
    _check(want, got, FIELDS + _extra(k))
    assert int(got.chosen[0]) == fused_winner


@pytest.mark.parametrize("k", [None, 1, 2])
def test_strength_is_one_fused_multiply_add(k):
    scores, fused_winner, split_winner = auction_strength_case(_noise(5))
    assert fused_winner != split_winner
    P = scores.shape[0]
    req = np.ones((P, 1), np.float32)
    free = np.array([[1.0], [0.0]], np.float32)  # node 0 fits one pod
    want, got = _run(scores, req, free, 5, k=k)
    _check(want, got, FIELDS + _extra(k))
    assert int(np.flatnonzero(got.chosen.numpy() == 0)[0]) == fused_winner


@pytest.mark.parametrize("k", [None, 3])
def test_equal_strengths_go_to_the_higher_row(k):
    """lax.sort is stable: of two bidders with equal strength on one node
    the higher row holds the higher rank and wins."""
    want, got = _run(*auction_tie_case(_noise(11)), 11, k=k)
    _check(want, got, FIELDS + _extra(k))
    assert int(got.chosen[3]) == 0 and int(got.chosen[1]) == 2


@pytest.mark.parametrize("k", [None, 2])
@pytest.mark.parametrize("budget", [1, 2, 4])
def test_round_budget_exhaustion_matches_jax(k, budget):
    """A budget that runs out mid-contention leaves feasible pods
    unassigned, exactly where JAX leaves them. (The default budget,
    9P+8, cannot run out: each win costs at most 8 rounds and each band
    ending with an unassigned pod 8 more, 8P at most.)"""
    scores, req, free = auction_adversarial(1)
    want, got = _run(scores, req, free, 1, k=k, max_rounds=budget)
    _check(want, got, FIELDS + _extra(k))
    assert int((~got.assigned).sum()) > 0
    _, full = _run(scores, req, free, 1, k=k)
    assert int(full.assigned.sum()) > int(got.assigned.sum())


def test_round_budget_formula():
    assert max_rounds_for(1024) == 9224
    assert max_rounds_for(16) == 256


def test_dispatch_takes_the_plain_version_on_cpu():
    scores, req, free = auction_instance(16, 32, seed=2)
    ta = [torch.from_numpy(a) for a in (scores, req, free)]
    seed = prng.bits(prng.PRNGKey(0))
    stats = torch.zeros((3,), dtype=torch.int32)
    a = auction_assign(*ta, seed)
    b = auction_assign_plain(*ta, seed, stats=stats)
    rounds, bids, full = stats.tolist()
    assert rounds > 0 and bids >= 16 and full == bids
    c = auction_assign_shortlist(*ta, seed, k=4)
    for f in FIELDS:
        assert _same(getattr(a, f).numpy(), getattr(b, f).numpy())
        assert _same(getattr(c, f).numpy(), getattr(b, f).numpy())


# ---- build_step(assignment="auction") ------------------------------------

def _step_both(jps, tps, eb, nf, af, k, sample=None, seed=0, counter=7,
               teb=None, tnf=None, taf=None):
    """Both packages' auction steps on one encoded batch (the port's own
    encode where given): every Decision field bitwise."""
    jstep = _jax_step(jps, k, sample)
    want = jstep(eb, nf, af,
                 jax.random.fold_in(jax.random.PRNGKey(seed), counter))
    step = build_step(tps, shortlist=k, assignment="auction",
                      sample_nodes=sample)
    got = step(*(to_torch(x, "cpu") for x in (teb or eb, tnf or nf,
                                              taf or af)),
               prng.fold_in(prng.PRNGKey(seed), counter))
    for f in got._fields:
        assert bits_equal(np.asarray(getattr(want, f)),
                          getattr(got, f).numpy()), f
    return got


_JAX_STEPS = {}


def _jax_step(jps, k, sample):
    """The JAX package's auction step, built once per plugin set, width
    and sample, so cases of one shape share its compile."""
    key = (id(jps), k, sample)
    if key not in _JAX_STEPS:
        _JAX_STEPS[key] = (jps, jbuild(jps, pallas=False, shortlist=k,
                                       assignment="auction",
                                       sample_nodes=sample))
    return _JAX_STEPS[key][1]


_BENCH_SETS = []


def _bench_sets():
    if not _BENCH_SETS:
        _BENCH_SETS.append((JProfile(**BENCH_PROFILE).build(),
                            Profile(**BENCH_PROFILE).build()))
    return _BENCH_SETS[0]


def _gang_batch(n_nodes, n_pods, cpu, gang=8):
    """bench.py's config-5 batch (pods in gangs of ``gang`` at quorum
    ``gang``) on a bench cluster of ``n_nodes`` nodes of ``cpu`` mCPU."""
    nodes, pods = bench_cluster(JO, n_nodes, n_pods, 3)
    for n in nodes:
        n.status.allocatable["cpu"] = float(cpu)
    for i, p in enumerate(pods):
        p.spec.pod_group = f"gang-{i // gang}"
        p.spec.pod_group_min = gang
        p.spec.priority = 2 - (i // gang) % 3
    cache = build_cache(JCache, nodes)
    eb = jencode(pods, bucket(n_pods), cfg=cache.cfg,
                 registry=cache.registry,
                 gang_bound_fn=cache.gang_bound_count)
    nf, _names, _sv, _incs = cache.snapshot_versioned(pad=bucket(n_nodes))
    return eb, nf, cache.snapshot_assigned(pad=16)


def bucket(n):
    return 1 << max(4, (n - 1).bit_length())


@pytest.mark.parametrize("k", [None, 1, 4, 128])
@pytest.mark.parametrize("seed", [0, 2])
def test_step_auction_matches_jax(k, seed):
    """mixed_cluster's batch (three priority bands, gangs of 3, tight
    capacity, pre-bound pods), unsampled."""
    nodes, pods, bound = mixed_cluster(JO, 100, 40, seed)
    cache = build_cache(JCache, nodes, bound)
    nf, _names, _sv, _incs = cache.snapshot_versioned(pad=112)
    eb = jencode(pods, 48, cfg=cache.cfg, registry=cache.registry,
                 gang_bound_fn=cache.gang_bound_count)
    d = _step_both(*_bench_sets(), eb, nf, cache.snapshot_assigned(pad=64),
                   k, seed=seed)
    assert d.assigned.any()


@pytest.mark.parametrize("k", [None, 2, 16])
def test_step_auction_gang_semantics_matches_jax(k):
    """__graft_entry__'s hard-semantics batch: gangs evicted and
    readmitted around the auction."""
    eb, nf, af, _names = _semantics_inputs()
    d = _step_both(*_bench_sets(), eb, nf, af, k, counter=3)
    assert d.gang_rejected.any()


@pytest.mark.parametrize("k", [None, 8])
@pytest.mark.parametrize("quorum", ["met", "failed"])
def test_step_auction_gangs_of_eight_match_jax(k, quorum):
    """Config 5's shape: 48 pods in six gangs of 8 at quorum 8, three
    priority bands; with room for all (quorum met) or for about four
    gangs (quorum failed: gang_rejected, the rest re-admitted)."""
    cpu = 16000 if quorum == "met" else 2000
    eb, nf, af = _gang_batch(24, 48, cpu)
    d = _step_both(*_bench_sets(), eb, nf, af, k)
    if quorum == "met":
        assert int(d.assigned.sum()) == 48 and not d.gang_rejected.any()
    else:
        assert d.gang_rejected.any() and d.assigned.any()


@pytest.mark.parametrize("k", [None, 16])
def test_step_auction_sampled_matches_jax(k):
    """The sampled step (K=128 of 300 nodes): the auction runs on the
    sample's columns and the outputs map back to global rows."""
    nodes, pods = bench_cluster(JO, 300, 60, 5)
    for i, p in enumerate(pods):
        p.spec.priority = i % 2
    cache = build_cache(JCache, nodes)
    eb = jencode(pods, 64, cfg=cache.cfg, registry=cache.registry)
    nf, _names, _sv, _incs = cache.snapshot_versioned(pad=304)
    d = _step_both(*_bench_sets(), eb, nf, cache.snapshot_assigned(pad=16),
                   k, sample=128)
    assert int(d.assigned.sum()) == 60


TOPO = ["NodeUnschedulable", "NodeResourcesFit", "PodTopologySpread",
        "InterPodAffinity"]


@pytest.mark.parametrize("k", [None, 8])
def test_step_auction_hard_spread_keeps_the_static_filter(k):
    """A DoNotSchedule batch under the auction builds no domain caps (the
    greedy scan alone carries running counts): scan_groups all False,
    feasible_static = feasible_counts, every field as JAX."""
    jx, tx = encode_both(lambda O: full_cluster(O, 64, 40, 1, hard=True),
                         p_pad=64, selspread=False)
    (jeb, jnf, jaf, _), (teb, tnf, taf, _) = jx, tx
    jps = JPluginSet([jmake(n) for n in TOPO])
    tps = PluginSet([port_plugin(n) for n in TOPO])
    d = _step_both(jps, tps, jeb, jnf, jaf, k, teb=teb, tnf=tnf, taf=taf)
    assert not d.scan_groups.any()
    assert torch.equal(d.feasible_static, d.feasible_counts)
    assert d.assigned.any()


def test_build_step_rejects_unknown_assignment():
    with pytest.raises(ValueError, match="unknown assignment"):
        build_step(Profile(**BENCH_PROFILE).build(), assignment="hungarian")


# ---- the engine under SchedulerConfig(assignment="auction") --------------

def _auction_kw(**kw):
    return dict(assignment="auction", **kw)


@pytest.mark.parametrize("pipeline,resident,shortlist", MODES)
def test_engine_auction_modes_match_jax(pipeline, resident, shortlist):
    """240 pods in batches of 64 on 120 bench nodes under the auction and
    the same config in both packages: placements and every shared
    counter equal; K=2 repairs some bids and certifies the rest."""
    kw = _auction_kw(max_batch_size=64, seed=1, pipeline=pipeline,
                     device_resident=resident, shortlist=shortlist,
                     shortlist_k=2)
    want, jm = _run_cluster(JCluster, JO, JProfile(**BENCH_PROFILE),
                            JConfig(**kw), 120, 240, 1)
    got, m = _run_cluster(Cluster, TO, Profile(**BENCH_PROFILE),
                          SchedulerConfig(platform="cpu", **kw), 120, 240, 1)
    assert got == want
    for key in SHARED_METRICS:
        assert m[key] == jm[key], key
    assert m["shortlist_width"] == jm["shortlist_width"] == (
        2 if shortlist else 0)
    if shortlist:
        assert 0 < m["shortlist_repairs"]
    assert m["kernel_launches"] == 0


@pytest.mark.parametrize("pipeline,resident,shortlist",
                         [MODES[0], MODES[1], MODES[4]])
def test_sampled_engine_auction_matches_jax(pipeline, resident, shortlist,
                                            monkeypatch):
    """1,200 nodes x 256 pods in batches of 64: every batch samples K=512
    nodes and one pod fits only outside every sample, so its batch runs
    the full-axis residual pass, on the auction too."""
    from minisched_tpu_torch.engine.scheduler import Scheduler

    residuals = []
    orig = Scheduler._run_residual

    def counted(self, b, rows, *a):
        residuals.append(len(rows))
        return orig(self, b, rows, *a)

    monkeypatch.setattr(Scheduler, "_run_residual", counted)
    kw = _auction_kw(max_batch_size=64, pipeline=pipeline,
                     device_resident=resident, shortlist=shortlist)
    want, jm = _run_cluster(JCluster, JO, JProfile(**BENCH_PROFILE),
                            JConfig(**kw), 0, 0, 0, recipe=sampled_cluster)
    got, m = _run_cluster(Cluster, TO, Profile(**BENCH_PROFILE),
                          SchedulerConfig(platform="cpu", **kw), 0, 0, 0,
                          recipe=sampled_cluster)
    assert got == want
    for key in SHARED_METRICS:
        assert m[key] == jm[key], key
    assert residuals and got["bench/only-fits-big"] == "big-node"


def _au_profile(pkg_profile):
    return pkg_profile(name="au", plugins=["NodeUnschedulable",
                                           "NodeResourcesFit",
                                           "NodeResourcesLeastAllocated"])


def _au_pods(O, n):
    """tests/test_auction.py's pods: unique priorities (a fixed batch
    split) and unique requests (a wrong free carry moves placements)."""
    return [O.Pod(metadata=O.ObjectMeta(name=f"ap-{i}", namespace="default"),
                  spec=O.PodSpec(requests={"cpu": 100 + i},
                                 priority=1000 - i))
            for i in range(n)]


def _au_run(pkg, n_pods=24, **kw):
    """tests/test_auction.py's engine harness on either package: 6 nodes
    of 640 cores, batches of 8 over a 0.3 s window."""
    cluster_cls, profile_cls, O, config_cls = pkg
    kw = _auction_kw(max_batch_size=8, batch_window_s=0.3,
                     backoff_initial_s=0.05, backoff_max_s=0.2, **kw)
    if cluster_cls is Cluster:
        kw["platform"] = "cpu"
    c = cluster_cls()
    try:
        c.start(profile=_au_profile(profile_cls), config=config_cls(**kw),
                with_pv_controller=False)
        for i in range(6):
            c.create_node(f"n{i}", cpu=640000)
        c.create_objects(_au_pods(O, n_pods))
        assert wait_for(lambda: all(p.spec.node_name
                                    for p in c.list_pods()), 60)
        sched = c.service.scheduler
        assert wait_for(lambda: sched.metrics()["pods_assigned"] >= n_pods,
                        30)
        return ({p.metadata.name: p.spec.node_name for p in c.list_pods()},
                sched.metrics())
    finally:
        c.shutdown()


def wait_for(cond, timeout):
    from minisched_tpu_torch.scenario.runner import wait_until

    return wait_until(cond, timeout=timeout)


T_PKG = (Cluster, Profile, TO, SchedulerConfig)
J_PKG = (JCluster, JProfile, JO, JConfig)


@pytest.mark.parametrize("pipeline", [False, True])
def test_auction_residency_carry_bit_identical(pipeline):
    """Auction batches ride the residency carry and commit the upload
    path's placements, which are the JAX engine's."""
    up, m0 = _au_run(T_PKG, device_resident=False, pipeline=pipeline)
    on, m1 = _au_run(T_PKG, device_resident=True, pipeline=pipeline)
    jon, _ = _au_run(J_PKG, device_resident=True, pipeline=pipeline)
    assert on == up == jon
    assert m0["residency_hits"] == 0
    assert m1["residency_hits"] >= 1 and m1["residency_resyncs"] == 1
    assert m1["residency_desyncs"] == 0


def test_auction_engine_bid_shortlist_bit_identical():
    """shortlist_k=4 routes the step through the bid shortlist: the
    full-row auction's placements, the width reported."""
    off, m0 = _au_run(T_PKG, shortlist=False)
    on, m1 = _au_run(T_PKG, shortlist=True, shortlist_k=4,
                     shortlist_check_every=1)
    jon, jm = _au_run(J_PKG, shortlist=True, shortlist_k=4)
    assert on == off == jon
    assert m0["shortlist_width"] == 0
    assert m1["shortlist_width"] == jm["shortlist_width"] == 4
    assert m1["shortlist_checks"] >= 1 and m1["shortlist_desyncs"] == 0


def test_auction_nomination_window_carry():
    """An outstanding nomination rides the carried free under the
    auction as an order-free per-node correction, is reversed before
    adoption, and the batch cannot take the nominated capacity."""
    c = Cluster()
    sched = None
    try:
        c.start(profile=_au_profile(Profile),
                config=SchedulerConfig(**_auction_kw(
                    platform="cpu", max_batch_size=8, batch_window_s=0.3,
                    backoff_initial_s=0.05, backoff_max_s=0.2)),
                with_pv_controller=False)
        c.create_node("an-0", cpu=1000)
        c.create_node("an-1", cpu=1000)
        c.create_pod("au-warm", cpu=100)
        c.wait_for_pod_bound("au-warm", timeout=30)
        sched = c.service.scheduler
        ghost = TO.Pod(metadata=TO.ObjectMeta(name="au-ghost",
                                              namespace="default"),
                       spec=TO.PodSpec(requests={"cpu": 900}))
        import time

        with sched._nom_lock:
            sched._nominations["default/au-ghost"] = (
                "an-0", TF.resources_vector(pod_requests(ghost)),
                time.monotonic() + 60.0)
        for i in range(3):
            c.create_pod(f"au-bys-{i}", cpu=300)
        for i in range(3):
            p = c.wait_for_pod_bound(f"au-bys-{i}", timeout=30)
            assert p.spec.node_name == "an-1", p.spec.node_name
        m = sched.metrics()
        assert m["residency_nomination_carries"] >= 1
        assert m["residency_resyncs"] == 1 and m["residency_desyncs"] == 0
        res = sched._residency
        assert np.array_equal(res.free_dev.numpy(), res.mirror_free)
    finally:
        if sched is not None:
            with sched._nom_lock:
                sched._nominations.pop("default/au-ghost", None)
        c.shutdown()


@pytest.fixture
def fault_registries():
    faults.configure("")
    jfaults.configure("")
    yield
    faults.configure("")
    jfaults.configure("")


def test_auction_mirror_corrupt_trips_desync_detector_and_resyncs(
        fault_registries):
    """``auction_mirror:corrupt`` books a phantom debit on a row the batch
    never debited, inside the host mirror's replay: only the carry
    cross-check (resident_check_every=1) sees it. It counts a desync,
    re-uploads, and the replay lands every pod where the fault-free run
    (= the JAX engine's) did."""
    kw = dict(assignment="auction", resident_check_every=1)
    ref, ref_m = _fault_free(False, **kw)
    assert ref_m["resident_checks"] >= 2 and ref_m["residency_desyncs"] == 0
    placed, m = _run_burst(PORT, "auction_mirror:corrupt@2", False, **kw)
    assert m["fault_fires_auction_mirror"] == 1
    assert m["residency_desyncs"] >= 1
    assert m["supervisor_escalations"] >= 1
    assert m["degradation_state"] == "resident"
    assert placed == ref


def test_engine_accepts_only_known_assignments():
    from minisched_tpu_torch.engine.scheduler import Scheduler
    from minisched_tpu_torch.state.store import ClusterStore

    with pytest.raises(ValueError, match="unknown assignment"):
        Scheduler(ClusterStore(), Profile(**BENCH_PROFILE).build(),
                  SchedulerConfig(platform="cpu", assignment="hungarian"))

"""The port's InterPodAffinity and PodTopologySpread scores held to the
plain reference of upstream's (tests/upstream_topology_ref.py), and the
engine on the benchmark's hard-spread and claims mixes cut to 400 nodes.

The clusters are random and seeded: bound pods carry every direction of
term (preferred affinity and anti-affinity, required affinity and
anti-affinity) under the hostname, zone and rack keys, within their own
namespace, another or both, with empty selectors among them; the
incoming pods carry preferred terms and spread constraints of both
kinds. Integer weights times integer counts are exact in float32, so the
raw and the normalized rows are compared bit for bit.
"""
import dataclasses
import gc

import numpy as np
import pytest
import torch

import upstream_topology_ref as ref
from benchmark import harness, spec, workload
from benchmark.tests.tiny import SPREAD, TINY_BATCH, TINY_NODES, tiny_run
from minisched_tpu_torch.encode import NodeFeatureCache, encode_pods, to_torch
from minisched_tpu_torch.encode.cache import SymBatch
from minisched_tpu_torch.ops import prng
from minisched_tpu_torch.ops.pipeline import _evaluate, build_step, cycle_state
from minisched_tpu_torch.plugins.base import PluginSet
from minisched_tpu_torch.plugins.interpodaffinity import InterPodAffinity
from minisched_tpu_torch.plugins.podtopologyspread import PodTopologySpread
from minisched_tpu_torch.scenario.runner import Cluster, wait_until
from minisched_tpu_torch.service.defaultconfig import (full_scheduler_profile,
                                                       make_plugin)
from minisched_tpu_torch.state import objects as O
from torch_parity import JaxInterPodAffinity, jax_rules, on_jax_rules

KEYS = (ref.HOSTNAME, "zone", "rack")
NAMESPACES = ("a", "b")
LABELS = {"app": ("web", "db", "cache"), "tier": ("fe", "be")}
CLAIMS = "kube-default-50k.backlog10k-claims"


def _labels(rng) -> dict:
    out = {}
    for k, vals in LABELS.items():
        if rng.random() < 0.8:
            out[k] = str(rng.choice(vals))
    return out


def _selector(rng) -> O.LabelSelector:
    if rng.random() < 0.2:
        return O.LabelSelector()  # empty: matches every pod
    k = str(rng.choice(list(LABELS)))
    return O.LabelSelector(match_labels={k: str(rng.choice(LABELS[k]))})


def _term(rng, many_ns: bool = True) -> O.PodAffinityTerm:
    """A term in its owner's namespace, another, or (``many_ns``) both:
    the encoder represents an incoming pod's own term with one
    namespace at most; the bound pods' terms are matched on the host."""
    r = rng.random()
    namespaces = ([] if r < 0.6 else [str(rng.choice(NAMESPACES))]
                  if r < 0.8 or not many_ns else list(NAMESPACES))
    return O.PodAffinityTerm(label_selector=_selector(rng),
                             topology_key=str(rng.choice(KEYS)),
                             namespaces=namespaces)


def _weighted(rng, n, many_ns):
    return [O.WeightedPodAffinityTerm(weight=int(rng.integers(1, 101)),
                                      term=_term(rng, many_ns))
            for _ in range(n)]


def _affinity(rng, bound: bool) -> O.Affinity:
    """Preferred terms on every pod; required ones on bound pods only
    (an incoming pod's would filter, not score)."""
    return O.Affinity(
        pod_affinity=O.PodAffinity(
            required=[_term(rng)] if bound and rng.random() < 0.3 else [],
            preferred=_weighted(rng, int(rng.integers(0, 3)), bound)),
        pod_anti_affinity=O.PodAntiAffinity(
            required=([_term(rng)] if bound and rng.random() < 0.1
                      else []),
            preferred=_weighted(rng, int(rng.integers(0, 3)), bound)))


def _pod(rng, name: str, bound: bool) -> O.Pod:
    spec_ = O.PodSpec(requests={"cpu": 100.0})
    if rng.random() < 0.7:
        spec_.affinity = _affinity(rng, bound)
    if not bound:
        spec_.topology_spread_constraints = [
            O.TopologySpreadConstraint(
                max_skew=int(rng.integers(1, 4)),
                topology_key=str(rng.choice(KEYS)),
                when_unsatisfiable=str(rng.choice(
                    ["DoNotSchedule", "ScheduleAnyway"])),
                label_selector=_selector(rng))
            for _ in range(int(rng.integers(0, 3)))]
    return O.Pod(metadata=O.ObjectMeta(name=name,
                                       namespace=str(rng.choice(NAMESPACES)),
                                       labels=_labels(rng)),
                 spec=spec_)


def _cluster(seed: int):
    """(nodes, [(bound pod, node index)], incoming pods)."""
    rng = np.random.default_rng([seed, 24])
    n_nodes = int(rng.integers(24, 80))
    zones, racks = int(rng.integers(2, 6)), int(rng.integers(3, 9))
    nodes = []
    for i in range(n_nodes):
        labels = {ref.HOSTNAME: f"n{i}", "zone": f"z{i % zones}"}
        if i % 7:  # every 7th node lacks the rack key
            labels["rack"] = f"r{i % racks}"
        nodes.append(O.Node(
            metadata=O.ObjectMeta(name=f"n{i}", labels=labels),
            status=O.NodeStatus(allocatable={
                "cpu": 64000.0, "memory": float(64 << 30), "pods": 110.0})))
    bound = [(_pod(rng, f"b{j}", True), int(rng.integers(0, n_nodes)))
             for j in range(int(rng.integers(10, 60)))]
    pods = [_pod(rng, f"p{j}", False) for j in range(12)]
    return nodes, bound, pods


def _port_rows(plugin, seed: int):
    """The port's raw and normalized rows for the incoming pods of
    cluster ``seed``, with the feasible mask and the node order."""
    nodes, bound, pods = _cluster(seed)
    cache = NodeFeatureCache()
    cache.upsert_nodes_bulk(nodes)
    for pod, j in bound:
        assert cache.account_bind(pod, nodes[j].metadata.name)
    # Encode first: constraints register keys the snapshot must hold.
    eb = encode_pods(pods, 16, cfg=cache.cfg, registry=cache.registry,
                     overflow=cache.overflow, sym_table=SymBatch(cache))
    nf, names, _sv, _incs = cache.snapshot_versioned(pad=128)
    af = cache.snapshot_assigned(pad=128)
    eb, nf, af = (to_torch(x, "cpu") for x in (eb, nf, af))
    ctx = cycle_state(PluginSet([plugin], {}), eb, nf, af)
    raw = plugin.score(eb.pf, nf, ctx)
    rng = np.random.default_rng([seed, 25])
    feasible = (eb.pf.valid[:, None] & nf.valid[None, :]
                & torch.from_numpy(rng.random(raw.shape) < 0.7))
    return (nodes, bound, pods, names, raw, plugin.normalize(raw, feasible),
            feasible)


def _encoded(seed: int, n_pad: int = 128):
    """Cluster ``seed`` encoded with its symmetric table, as tensors:
    (eb, nf, af)."""
    nodes, bound, pods = _cluster(seed)
    cache = NodeFeatureCache()
    cache.upsert_nodes_bulk(nodes)
    for pod, j in bound:
        cache.account_bind(pod, nodes[j].metadata.name)
    eb = encode_pods(pods, 16, cfg=cache.cfg, registry=cache.registry,
                     sym_table=SymBatch(cache))
    assert eb.sym is not None and eb.pf.sym_slot.shape[1] > 0
    nf, _names, _sv, _incs = cache.snapshot_versioned(pad=n_pad)
    af = cache.snapshot_assigned(pad=128)
    return tuple(to_torch(x, "cpu") for x in (eb, nf, af))


TOPO_SET = ["NodeResourcesFit", "InterPodAffinity", "PodTopologySpread"]


def _bits(x: torch.Tensor) -> np.ndarray:
    return x.contiguous().view(torch.int32).numpy()


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("which", ["InterPodAffinity", "PodTopologySpread"])
def test_scores_match_the_upstream_reference(which, seed):
    plugin = (InterPodAffinity() if which == "InterPodAffinity"
              else PodTopologySpread())
    raw_fn, norm_fn = ((ref.inter_pod_affinity_raw,
                        ref.inter_pod_affinity_normalize)
                       if which == "InterPodAffinity" else
                       (ref.pod_topology_spread_raw,
                        ref.pod_topology_spread_normalize))
    nodes, bound, pods, names, raw, norm, feasible = _port_rows(plugin,
                                                                seed)
    by_name = {n.metadata.name: n for n in nodes}
    cols = [c for c, name in enumerate(names) if name is not None]
    order = [by_name[names[c]] for c in cols]
    col_of = {names[c]: k for k, c in enumerate(cols)}
    bound_ref = [(p, col_of[nodes[j].metadata.name]) for p, j in bound]
    nonzero = 0
    for i, pod in enumerate(pods):
        want = raw_fn(pod, order, bound_ref)
        got = raw[i, cols]
        assert np.array_equal(_bits(got), _bits(want)), (i, got, want)
        want_n = norm_fn(want, feasible[i, cols])
        got_n = norm[i, cols]
        assert np.array_equal(_bits(got_n), _bits(want_n)), (i, got_n,
                                                              want_n)
        nonzero += int((want != 0).any())
    # The cases score something: every seed has pods with non-zero rows.
    assert nonzero > 0


@pytest.mark.parametrize("seed", range(4))
def test_symmetric_part_is_the_bound_pods_terms(seed):
    """Without the symmetric part (the JAX package's rule) the raw score
    is the reference's with the bound pods' own terms left out."""
    nodes, bound, pods, names, raw, _norm, _f = _port_rows(
        JaxInterPodAffinity(), seed)
    by_name = {n.metadata.name: n for n in nodes}
    cols = [c for c, name in enumerate(names) if name is not None]
    order = [by_name[names[c]] for c in cols]
    col_of = {names[c]: k for k, c in enumerate(cols)}
    termless = []
    for p, j in bound:
        bare = dataclasses.replace(p, spec=dataclasses.replace(
            p.spec, affinity=None))
        termless.append((bare, col_of[nodes[j].metadata.name]))
    for i, pod in enumerate(pods):
        want = ref.inter_pod_affinity_raw(pod, order, termless)
        assert np.array_equal(_bits(raw[i, cols]), _bits(want)), i


def _raw_rows(plugin, nodes, bound, pods):
    """The port's raw rows of ``pods`` over ``nodes`` with ``bound`` ((pod,
    node index)) bound, in the order of ``nodes``."""
    cache = NodeFeatureCache()
    cache.upsert_nodes_bulk(nodes)
    for pod, j in bound:
        assert cache.account_bind(pod, nodes[j].metadata.name)
    eb = encode_pods(pods, 16, cfg=cache.cfg, registry=cache.registry,
                     overflow=cache.overflow, sym_table=SymBatch(cache))
    nf, names, _sv, _incs = cache.snapshot_versioned(pad=16)
    af = cache.snapshot_assigned(pad=16)
    eb, nf, af = (to_torch(x, "cpu") for x in (eb, nf, af))
    raw = plugin.score(eb.pf, nf, cycle_state(PluginSet([plugin], {}), eb,
                                              nf, af))
    col = {name: c for c, name in enumerate(names) if name is not None}
    return raw[:len(pods), [col[n.metadata.name] for n in nodes]]


def test_nil_selector_matches_no_pod_but_on_the_pods_own_terms():
    """A nil selector (None) matches no pod, as upstream's: a bound pod's
    term with one adds nothing, in the port as in the reference. The
    port's encoder (the JAX package's) reads None on the incoming pod's
    own term as matching every pod: the departure the reference notes,
    pinned here as the reference's row with an empty selector there."""
    nodes = [O.Node(metadata=O.ObjectMeta(
        name=f"n{i}", labels={ref.HOSTNAME: f"n{i}", "zone": f"z{i // 2}"}),
        status=O.NodeStatus(allocatable={"cpu": 8000.0, "pods": 110.0}))
        for i in range(4)]

    def pod(name, sel, weight):
        term = O.PodAffinityTerm(label_selector=sel, topology_key="zone")
        return O.Pod(metadata=O.ObjectMeta(name=name, namespace="a",
                                           labels={"app": "web"}),
                     spec=O.PodSpec(requests={"cpu": 100.0},
                                    affinity=O.Affinity(
                                        pod_affinity=O.PodAffinity(
                                            preferred=[
                                                O.WeightedPodAffinityTerm(
                                                    weight=weight,
                                                    term=term)]))))

    bound = [(pod("nil", None, 7), 0), (pod("empty", O.LabelSelector(), 5),
                                        2)]
    incoming = pod("in", None, 3)
    got = _raw_rows(InterPodAffinity(), nodes, bound, [incoming])[0]
    # own term (None read as every pod): 3 a zone; the bound nil term:
    # nothing; the bound empty term: 5 in z1.
    assert got.tolist() == [3.0, 3.0, 8.0, 8.0]
    upstream = ref.inter_pod_affinity_raw(incoming, nodes, bound)
    assert upstream.tolist() == [0.0, 0.0, 5.0, 5.0]
    as_empty = pod("in", O.LabelSelector(), 3)
    assert np.array_equal(
        _bits(got), _bits(ref.inter_pod_affinity_raw(as_empty, nodes,
                                                     bound)))


@pytest.mark.parametrize("seed", range(4))
def test_scorers_normalize_over_the_deferred_skew_check(seed):
    """Where the caps scan enforces a hard spread (the filter stands down
    for its groups: ``spread_scan_groups``), the scorers normalize over
    the nodes that pass the skew check on the batch's starting state, as
    upstream's, which score only the nodes that passed every filter. The
    JAX package's rules normalize over the nodes feasible without it."""
    eb, nf, af = _encoded(seed)
    ps = PluginSet([make_plugin(n) for n in TOPO_SET])
    ctx = cycle_state(ps, eb, nf, af)
    frozen = _evaluate(ps, eb.pf, nf, ctx)[1]
    deferred = dict(ctx, spread_scan_groups=torch.ones(
        eb.gf.valid.shape[0], dtype=torch.bool))
    differs = 0
    for rules in (ps, PluginSet([on_jax_rules(p) for p in ps.plugins])):
        _t, feasible, _c, _r, (_m, raws, norms) = _evaluate(
            rules, eb.pf, nf, deferred, explain=True)
        assert bool((feasible & ~frozen).any())  # the filter stood down
        scored = frozen if rules is ps else feasible
        for p, raw, norm in zip(rules.score_plugins, raws, norms):
            assert np.array_equal(_bits(norm),
                                  _bits(p.normalize(raw, scored))), p.name
            differs += int(not torch.equal(norm, p.normalize(raw,
                                                             feasible)))
    # The two ranges give other rows in each case.
    assert differs > 0


def test_terms_follow_binds_and_deletes():
    """The cache's term index follows binds and unbinds: a pod's table
    rows equal the reference after some of the bound pods leave, and an
    index left empty stamps no slot and ships no table."""
    nodes, bound, pods = _cluster(3)
    cache = NodeFeatureCache()
    cache.upsert_nodes_bulk(nodes)
    for pod, j in bound:
        cache.account_bind(pod, nodes[j].metadata.name)
    gone = bound[::2]
    for pod, _j in gone:
        cache.account_unbind(pod.key)
    kept = bound[1::2]
    plugin = InterPodAffinity()
    eb = encode_pods(pods, 16, cfg=cache.cfg, registry=cache.registry,
                     sym_table=SymBatch(cache))
    nf, names, _sv, _incs = cache.snapshot_versioned(pad=128)
    af = cache.snapshot_assigned(pad=128)
    eb_t, nf_t, af_t = (to_torch(x, "cpu") for x in (eb, nf, af))
    raw = plugin.score(eb_t.pf, nf_t,
                       cycle_state(PluginSet([plugin], {}), eb_t, nf_t,
                                   af_t))
    cols = [c for c, name in enumerate(names) if name is not None]
    by_name = {n.metadata.name: n for n in nodes}
    col_of = {names[c]: k for k, c in enumerate(cols)}
    order = [by_name[names[c]] for c in cols]
    kept_ref = [(p, col_of[nodes[j].metadata.name]) for p, j in kept]
    for i, pod in enumerate(pods):
        want = ref.inter_pod_affinity_raw(pod, order, kept_ref)
        assert np.array_equal(_bits(raw[i, cols]), _bits(want)), i
    for pod, _j in kept:
        cache.account_unbind(pod.key)
    assert cache.sym_stats()[1] == 0
    eb2 = encode_pods(pods, 16, cfg=cache.cfg, registry=cache.registry,
                      sym_table=SymBatch(cache))
    assert eb2.sym is None and eb2.pf.sym_slot.shape == (16, 0)


@pytest.mark.parametrize("bulk", [False, True])
def test_term_index_keeps_nothing_tracked_per_bound_pod(bulk):
    """A bound pod's entry in the term index holds strings and numbers
    alone: after one collection the interpreter's collector tracks none
    of the entries, so the index adds no object per bound pod to the
    older generations' walk."""
    nodes, bound, _pods = _cluster(5)
    cache = NodeFeatureCache()
    cache.upsert_nodes_bulk(nodes)
    items = [(pod, nodes[j].metadata.name) for pod, j in bound]
    if bulk:
        assert cache.account_bind_bulk(items) == []
    else:
        for pod, name in items:
            assert cache.account_bind(pod, name)
    entries = list(cache._pod_sym.values())
    assert entries
    gc.collect()
    assert not any(gc.is_tracked(e) for e in entries)


@pytest.mark.parametrize("seed", [12345678901, 9400000001])
def test_hard_spread_mix_is_correct(seed):
    """The benchmark's hard-spread mix at 400 nodes on the CPU: every
    guarantee holds and each judged pod takes a node upstream's scores
    rank highest (the limits of benchmark/reference/limits.json)."""
    from benchmark import run

    rec = tiny_run(SPREAD, seed=seed)
    correct, shown = run.judge(rec["compared"], run.limits(SPREAD))
    assert correct, shown
    assert rec["compared"]["gaps_judged"] >= 100
    assert rec["counters"]["sym_affinity_slots_total"] > 0


def _claims_run(profile, seed: int = 5):
    """The claims mix cut to 400 nodes and 256 pods, every object in the
    store before the engine starts: (placements, metrics)."""
    cell = spec.cell(CLAIMS)
    cl = dict(cell.config["cluster"], nodes=TINY_NODES)
    nodes = workload.make_nodes(cl, seed, O)
    source = workload.PodSource(cell.traffic["pod"], cl["zones"], seed)
    objs = source.objects(range(256), O)
    config = dict(cell.config, scheduler=dict(cell.config["scheduler"],
                                              max_batch_size=TINY_BATCH))
    c = Cluster()
    c.create_objects(nodes)
    c.create_objects(objs)
    c.start(profile, harness.scheduler_config(config, seed, "cpu"),
            with_pv_controller=False)
    try:
        assert wait_until(lambda: all(p.spec.node_name
                                      for p in c.list_pods()), timeout=60)
        sched = c.service.scheduler
        assert wait_until(lambda: sched.metrics()["pods_assigned"] >= 256,
                          timeout=60)
        return ({p.metadata.name: p.spec.node_name for p in c.list_pods()},
                sched.metrics())
    finally:
        c.shutdown()


def test_claims_mix_places_as_before():
    """No pod of the claims mix carries a term: upstream's rules stamp no
    symmetric slot, keep no term, and place every pod where the JAX
    package's rules do."""
    got, m = _claims_run(full_scheduler_profile())
    want, _m = _claims_run(jax_rules(full_scheduler_profile()))
    assert got == want and len(got) == 256
    assert m["sym_affinity_slots_total"] == 0
    assert m["sym_affinity_terms"] == 0


def test_the_spread_cell_loads_with_its_metrics():
    """BENCHMARK.json's hard-spread cell, found by name: one chip, its
    configuration (50,000 nodes in three zones, nothing cut) and mix, the
    two end-to-end metrics, its five ``.spread`` per-layer metrics and the
    claims cell's ``.backlog`` ones it also reads (all but the shortlist
    kernel's roofline, which the caps scan replaces, and the three the
    ``.spread`` ones name), each with a reader that finds nothing to read
    in an empty record."""
    bench = spec.benchmark()
    cell = spec.cell(SPREAD)
    assert cell.chips == 1
    config = next(c for c in bench["configs"]
                  if c["name"] == "kube-default-50k-adaptive")
    assert config["reduced"] == []
    assert cell.config["name"] == config["name"]
    assert cell.config["cluster"]["nodes"] == 50000
    assert cell.config["cluster"]["zones"] == 3
    assert cell.traffic["pod"]["spread"]["when_unsatisfiable"] == (
        "DoNotSchedule")
    assert [m["name"] for m in cell.end_to_end] == ["pods_per_s", "setup_s"]
    layers = {m["name"]: m for m in cell.per_layer}
    spread = {"sym_affinity_ms", "caps_scan_roofline", "prepare_ms",
              "resolve_ms", "step_device_ms"}
    backlog = {"batch_fill", "step_ms", "bind_ms", "device_idle",
               "gc_pause_share", "prepare_cpu_ms", "resolve_cpu_ms",
               "fetch_wait_ms", "host_syncs", "step_device_span_ms",
               "gc_pause_ms"}
    assert set(layers) == ({f"{m}.spread" for m in spread}
                           | {f"{m}.backlog" for m in backlog})
    assert all(m["moves"] == "pods_per_s" for m in layers.values())
    assert set(cell.readers) == set(layers) | {"pods_per_s", "setup_s"}
    empty = {"counters": {"batches": 0.0}, "profile": None, "shapes": None,
             "seconds": 0.0}
    for name in layers:
        assert cell.readers[name](empty) is None, name


@pytest.mark.parametrize("seed", range(3))
def test_mesh_step_reads_the_symmetric_rows(seed):
    """The sharded step on a (2,4) mesh of CPU devices (each node shard
    gathers its own columns of the table) decides as the single-device
    step, bit for bit, in explain mode (so every raw and normalized
    score is compared too)."""
    from minisched_tpu_torch.parallel import build_sharded_step, make_mesh
    from minisched_tpu_torch.parallel.mesh import shard_features
    from minisched_tpu_torch.service.defaultconfig import make_plugin

    eb, nf, af = _encoded(seed)
    ps = PluginSet([make_plugin(n) for n in TOPO_SET])
    key = prng.fold_in(prng.PRNGKey(seed), 3)
    want = build_step(ps, explain=True)(eb, nf, af, key, hard_spread=False)
    mesh = make_mesh([torch.device("cpu")] * 8)
    got = build_sharded_step(ps, mesh, explain=True, assignment="greedy")(
        *shard_features(mesh, eb, nf, af), key)
    for f in ("chosen", "assigned"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    for f in ("raw_scores", "norm_scores", "total_scores"):
        assert np.array_equal(_bits(getattr(got, f)),
                              _bits(getattr(want, f))), f


@pytest.mark.parametrize("seed", range(3))
def test_sampled_step_gathers_the_symmetric_rows(seed):
    """A sampled step (K of the node rows) hands InterPodAffinity the
    symmetric rows of its sampled nodes: the full axis' rows gathered on
    the sample equal the rows the sampled nodes' own domains give."""
    from minisched_tpu_torch.ops.topology import sym_node_rows

    eb, nf, af = _encoded(seed)
    seen = []

    class Recording(InterPodAffinity):
        def score(self, pf, nf_, ctx):
            seen.append((nf_, ctx["sym_rows"]))
            return super().score(pf, nf_, ctx)

    step = build_step(PluginSet([Recording()]), sample_nodes=32)
    d = step(eb, nf, af, prng.fold_in(prng.PRNGKey(seed), 5),
             hard_spread=False)
    (nf_s, rows), = seen
    assert nf_s.valid.shape[0] == rows.shape[1] == 32
    assert torch.equal(rows, sym_node_rows(nf_s, eb.sym))
    assert rows.abs().sum() > 0 and bool(d.assigned.any())


def _spread_mix_run(kw, seed: int = 11, n_pods: int = 256):
    """The hard-spread mix cut to 400 nodes and ``n_pods`` pods, every
    object in the store before the engine starts, under the engine knobs
    ``kw``: placements."""
    cell = spec.cell(SPREAD)
    cl = dict(cell.config["cluster"], nodes=TINY_NODES)
    source = workload.PodSource(cell.traffic["pod"], cl["zones"], seed)
    config = dict(cell.config, scheduler=dict(cell.config["scheduler"],
                                              max_batch_size=TINY_BATCH,
                                              **kw))
    c = Cluster()
    c.create_objects(workload.make_nodes(cl, seed, O))
    c.create_objects(source.objects(range(n_pods), O))
    c.start(harness.profile(config),
            harness.scheduler_config(config, seed, "cpu"),
            with_pv_controller=False)
    try:
        assert wait_until(lambda: all(p.spec.node_name
                                      for p in c.list_pods()), timeout=60)
        sched = c.service.scheduler
        assert wait_until(lambda: sched.metrics()["pods_assigned"]
                          >= n_pods, timeout=60)
        assert sched.metrics()["sym_affinity_slots_total"] > 0
        return {p.metadata.name: p.spec.node_name for p in c.list_pods()}
    finally:
        c.shutdown()


def test_engine_modes_agree_on_the_spread_mix():
    """Synchronous, pipelined and device-resident cycles, with the
    shortlist or the full kernel, read the same symmetric table and
    place every pod of the hard-spread mix alike."""
    modes = [dict(pipeline=False, device_resident=False, shortlist=False),
             dict(pipeline=True, device_resident=False, shortlist=True),
             dict(pipeline=True, device_resident=True, shortlist=True)]
    runs = [_spread_mix_run(kw) for kw in modes]
    assert len(runs[0]) == 256
    assert all(r == runs[0] for r in runs[1:])

"""The port's mesh (minisched_tpu_torch/parallel/) against the JAX
package's: the mesh shapes, the feature shardings, the sharded step on
every Decision field bitwise (greedy, auction, explain, capacity
causality, hard gang/spread/anti semantics), the chunked-gather scan
chunk by chunk, the mesh engine's placements against the JAX engine's,
topology and preemption, startup validation, the shortlist knob, the
two-profile kitchen sink and the two-process gloo dryrun.

The JAX side runs on conftest's eight host devices; the port on a
virtual mesh of eight CPU shards, ``make_mesh([cpu] * 8)``. Inputs come
from one recipe through each package's own encoder. Tolerance: none."""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minisched_tpu.config import SchedulerConfig as JConfig
from minisched_tpu.encode import NodeFeatureCache as JCache
from minisched_tpu.encode import encode_pods as jencode
from minisched_tpu.parallel import build_sharded_step as jbuild_sharded
from minisched_tpu.parallel import make_hybrid_mesh as jhybrid
from minisched_tpu.parallel import make_mesh as jmake_mesh
from minisched_tpu.parallel import shard_features as jshard
from minisched_tpu.parallel.mesh import feature_shardings as jshardings
from minisched_tpu.parallel.sharded_assign import \
    make_sharded_assign as jsharded_assign
from minisched_tpu.plugins import PluginSet as JPluginSet
from minisched_tpu.service.defaultconfig import Profile as JProfile
from minisched_tpu.service.defaultconfig import make_plugin as jmake
from minisched_tpu.service.service import SchedulerService as JService
from minisched_tpu.state import objects as JO
from minisched_tpu.state.store import ClusterStore as JStore
from minisched_tpu_torch.config import SchedulerConfig
from minisched_tpu_torch.encode import NodeFeatureCache, encode_pods, to_torch
from minisched_tpu_torch.ops import prng
from minisched_tpu_torch.ops.greedy_kernel import chunk_seed
from minisched_tpu_torch.ops.pipeline import build_step
from minisched_tpu_torch.ops.select import (greedy_assign_plain,
                                            tie_noise_from_cols)
from minisched_tpu_torch.parallel import (build_sharded_step,
                                          make_hybrid_mesh, make_mesh,
                                          shard_features)
from minisched_tpu_torch.parallel.mesh import (Sharding, ShardedTensor,
                                               feature_shardings)
from minisched_tpu_torch.parallel.sharded_assign import (
    _chunk_size, make_sharded_assign)
from minisched_tpu_torch.plugins import PluginSet
from minisched_tpu_torch.service.defaultconfig import Profile, make_plugin
from minisched_tpu_torch.service.service import SchedulerService
from minisched_tpu_torch.state import objects as TO
from minisched_tpu_torch.state.store import ClusterStore
from torch_parity import bits_equal, full_cluster, greedy_case

CPU8 = [torch.device("cpu")] * 8
ZONE = "topology.kubernetes.io/zone"


@pytest.fixture(scope="module")
def eight_devices():
    devs = jax.devices("cpu")
    if len(devs) < 8:
        pytest.skip("needs 8 virtual devices")
    return devs[:8]


def encode_both(recipe, p_pad, n_pad=None, selspread=False):
    """One cluster built in both packages: per package (eb, nf, af,
    names), numpy leaves. ``recipe(O)`` -> (nodes, pods, bound)."""
    out = []
    for O, cache_cls, enc in ((JO, JCache, jencode),
                              (TO, NodeFeatureCache, encode_pods)):
        nodes, pods, bound = recipe(O)
        cache = cache_cls()
        if selspread:
            cache.enable_owner_pairs()
        cache.upsert_nodes_bulk(nodes)
        for pod, node_name in bound:
            pod.spec.node_name = node_name
            cache.account_bind(pod)
        eb = enc(pods, p_pad, cfg=cache.cfg, registry=cache.registry,
                 gang_bound_fn=cache.gang_bound_count,
                 selector_spread=selspread,
                 anti_forbidden_fn=cache.anti_forbidden_for)
        nf, names, _sv, _incs = cache.snapshot_versioned(pad=n_pad)
        af = cache.snapshot_assigned()
        out.append((eb, nf, af, names))
    return out


def _torch(tx):
    return tuple(to_torch(x, "cpu") for x in tx[:3])


def assert_decisions_equal(want, got):
    for f in got._fields:
        assert bits_equal(np.asarray(getattr(want, f)),
                          getattr(got, f).numpy()), f


def _nodes_numbered(O, n):
    return [O.Node(metadata=O.ObjectMeta(name=f"n{i}"), spec=O.NodeSpec(),
                   status=O.NodeStatus(allocatable={
                       "cpu": float(1000 + (i % 7) * 100),
                       "memory": float(16 << 30), "pods": 110.0}))
            for i in range(n)]


def _numbered(O, n_nodes=32, n_pods=16):
    """tests/test_parallel.make_inputs: NodeNumber-scored nodes."""
    pods = [O.Pod(metadata=O.ObjectMeta(name=f"p{i}", namespace="default"),
                  spec=O.PodSpec(requests={"cpu": float(100 + (i % 3) * 50),
                                           "memory": float(1 << 30)}))
            for i in range(n_pods)]
    return _nodes_numbered(O, n_nodes), pods, []


def _semantics(O):
    """__graft_entry__._semantics_inputs: gang quorum met and missed,
    DoNotSchedule spread against existing skew, required anti-affinity
    against a running pod, all under capacity-1 scarcity (16 nodes in 4
    zones, 3 pods bound)."""
    nodes = [O.Node(metadata=O.ObjectMeta(name=f"sn{i:02d}",
                                          labels={ZONE: f"z{i % 4}"}),
                    status=O.NodeStatus(allocatable={"cpu": 4000,
                                                     "pods": 1}))
             for i in range(16)]

    def pod(name, labels=None, **spec):
        return O.Pod(metadata=O.ObjectMeta(name=name, namespace="default",
                                           labels=labels or {}),
                     spec=O.PodSpec(requests={"cpu": 100}, **spec))

    bound = [(pod("run-s0", {"app": "s"}), "sn00"),
             (pod("run-s1", {"app": "s"}), "sn04"),
             (pod("run-a0", {"app": "anti"}), "sn01")]
    pods = [pod(f"ga{i}", priority=100, pod_group="gang-a", pod_group_min=4)
            for i in range(4)]
    pods += [pod(f"sp{i}", {"app": "s"}, priority=50,
                 topology_spread_constraints=[O.TopologySpreadConstraint(
                     max_skew=1, topology_key=ZONE,
                     when_unsatisfiable="DoNotSchedule",
                     label_selector=O.LabelSelector(
                         match_labels={"app": "s"}))])
             for i in range(4)]
    pods += [pod(f"an{i}", {"app": "anti"}, priority=50,
                 affinity=O.Affinity(pod_anti_affinity=O.PodAntiAffinity(
                     required=[O.PodAffinityTerm(
                         label_selector=O.LabelSelector(
                             match_labels={"app": "anti"}),
                         topology_key=ZONE)])))
             for i in range(4)]
    pods += [pod(f"gb{i}", priority=1, pod_group="gang-b", pod_group_min=10)
             for i in range(10)]
    return nodes, pods, bound


def _both_sharded(recipe, plugins, assignment, *, p_pad, eight_devices,
                  explain=False, seed=42, selspread=False, n_pad=None):
    """The JAX sharded step and the port's on one batch, plus the port's
    single-device step (caps off: the sharded assignment keeps the
    static spread verdict, as JAX's does)."""
    jx, tx = encode_both(recipe, p_pad, n_pad, selspread)
    (jeb, jnf, jaf, names) = jx
    jps = JPluginSet([jmake(n) for n in plugins])
    tps = PluginSet([make_plugin(n) for n in plugins])
    jmesh = jmake_mesh(eight_devices)
    want = jbuild_sharded(jps, jmesh, jeb, jnf, jaf, explain=explain,
                          assignment=assignment)(
        *jshard(jmesh, jeb, jnf, jaf), jax.random.PRNGKey(seed))
    mesh = make_mesh(CPU8)
    eb, nf, af = _torch(tx)
    key = prng.PRNGKey(seed)
    got = build_sharded_step(tps, mesh, eb, nf, af, explain=explain,
                             assignment=assignment)(
        *shard_features(mesh, eb, nf, af), key)
    single = build_step(tps, assignment=assignment, explain=explain)(
        eb, nf, af, key, hard_spread=False)
    return want, got, single, names


# ---- the mesh and its shardings -----------------------------------------


def test_mesh_axes(eight_devices):
    mesh = make_mesh(CPU8)
    assert mesh.axis_names == ("pod", "node")
    assert mesh.devices.shape == (2, 4) == jmake_mesh(eight_devices
                                                      ).devices.shape
    assert make_mesh(CPU8[:1]).devices.shape == (1, 1)
    assert make_mesh(CPU8[:2]).devices.shape == (1, 2)
    assert mesh.shape == {"pod": 2, "node": 4}
    # One process, no group: the hybrid mesh is make_mesh.
    assert make_hybrid_mesh(devices=CPU8).devices.shape == (2, 4)
    h4 = make_hybrid_mesh(pod_axis_size=4, devices=CPU8)
    assert h4.devices.shape == (4, 2) == jhybrid(
        pod_axis_size=4, devices=eight_devices).devices.shape
    with pytest.raises(ValueError, match="divisible"):
        make_mesh(CPU8[:6], pod_axis_size=4)


def test_feature_shardings_match_jax(eight_devices):
    """Every leaf splits over the same axis in both packages, and a put
    then a gather gives the leaf back."""
    jx, tx = encode_both(lambda O: full_cluster(O, 32, 24, 0), 32)
    jmesh, mesh = jmake_mesh(eight_devices), make_mesh(CPU8)
    jtrees = jshardings(jmesh, *jx[:3])
    ttrees = feature_shardings(mesh, *tx[:3])

    def flat(tree):
        out = []
        for leaf in tree:
            nested = (isinstance(leaf, tuple) and hasattr(leaf, "_fields")
                      and not isinstance(leaf, Sharding))
            out.extend(flat(leaf) if nested else [leaf])
        return out

    for jt, tt in zip(jtrees, ttrees):
        jl, tl = flat(jt), flat(tt)
        assert len(jl) == len(tl)
        for js, ts in zip(jl, tl):
            want = tuple(js.spec)
            want = want + (None,) * (len(ts.spec) - len(want))
            got = ts.spec + (None,) * (len(want) - len(ts.spec))
            assert got[:len(want)] == want[:len(got)], (js.spec, ts.spec)
    eb, nf, af = _torch(tx)
    for tree in shard_features(mesh, eb, nf, af):
        for st in flat(tree):
            assert isinstance(st, ShardedTensor)
            assert len(st.blocks) == 8
            src, st.source = st.source, None
            assert torch.equal(st.full(), src)


# ---- the sharded step against the JAX package's -------------------------


@pytest.mark.parametrize("assignment", ["greedy", "auction"])
def test_sharded_step_matches_jax(eight_devices, assignment):
    """tests/test_parallel.test_sharded_step_matches_single_chip and
    test_sharded_auction_matches_single_chip: every Decision field."""
    want, got, single, _ = _both_sharded(
        _numbered, ["NodeUnschedulable", "NodeNumber"], assignment,
        p_pad=16, eight_devices=eight_devices, seed=42)
    assert_decisions_equal(want, got)
    assert_decisions_equal(single.__class__(*(t.numpy() for t in single)),
                           got)
    assert int(got.assigned.sum()) > 0


@pytest.mark.parametrize("assignment", ["greedy", "auction"])
def test_sharded_explain_matches_jax(eight_devices, assignment):
    """Explain mode on a cluster of every label and topology feature:
    the (F,P,N) / (S,P,N) stacks and the (P,N) totals gathered from the
    blocks, every field bitwise."""
    plugins = ["NodeUnschedulable", "NodeResourcesFit",
               "NodeResourcesLeastAllocated", "PodTopologySpread",
               "InterPodAffinity", "TaintToleration", "NodeAffinity",
               "SelectorSpread", "VolumeRestrictions"]
    want, got, single, _ = _both_sharded(
        lambda O: full_cluster(O, 48, 30, 1), plugins, assignment,
        p_pad=32, eight_devices=eight_devices, explain=True, seed=5,
        selspread=True)
    assert got.filter_masks.shape[0] > 0 and got.raw_scores.shape[0] > 0
    assert_decisions_equal(want, got)
    for f in single._fields:
        assert bits_equal(getattr(single, f).numpy(),
                          getattr(got, f).numpy()), f


def test_sharded_capacity_causality(eight_devices):
    """The chunk scan's carried free matrix stays right across shards:
    16 nodes that fit one pod each, 16 pods, each on its own node (the
    JAX default assignment, the auction, and the greedy scan)."""
    def recipe(O):
        nodes = [O.Node(metadata=O.ObjectMeta(name=f"n{i}"),
                        spec=O.NodeSpec(),
                        status=O.NodeStatus(allocatable={
                            "cpu": 100.0, "memory": float(16 << 30),
                            "pods": 110.0})) for i in range(16)]
        pods = [O.Pod(metadata=O.ObjectMeta(name=f"p{i}",
                                            namespace="default"),
                      spec=O.PodSpec(requests={"cpu": 100.0}))
                for i in range(16)]
        return nodes, pods, []

    for assignment in ("auction", "greedy"):
        want, got, _, _ = _both_sharded(
            recipe, ["NodeUnschedulable"], assignment, p_pad=16, n_pad=16,
            eight_devices=eight_devices, seed=0)
        assert_decisions_equal(want, got)
        assert bool(got.assigned.all())
        assert len(set(got.chosen.tolist())) == 16


def test_hybrid_mesh_single_process_and_step(eight_devices):
    """In one process the hybrid mesh is the (2,4) mesh and the greedy
    sharded step over it equals the JAX one and the single-device step."""
    mesh = make_hybrid_mesh(devices=CPU8)
    jx, tx = encode_both(_numbered, 16)
    eb, nf, af = _torch(tx)
    tps = PluginSet([make_plugin("NodeUnschedulable"),
                     make_plugin("NodeNumber")])
    key = prng.PRNGKey(7)
    got = build_sharded_step(tps, mesh, eb, nf, af, assignment="greedy")(
        eb, nf, af, key)
    single = build_step(tps)(eb, nf, af, key)
    for f in single._fields:
        assert torch.equal(getattr(single, f), getattr(got, f)), f
    jmesh = jhybrid(devices=eight_devices)
    jps = JPluginSet([jmake("NodeUnschedulable"), jmake("NodeNumber")])
    jeb, jnf, jaf, _ = jx
    want = jbuild_sharded(jps, jmesh, jeb, jnf, jaf, assignment="greedy")(
        *jshard(jmesh, jeb, jnf, jaf), jax.random.PRNGKey(7))
    assert_decisions_equal(want, got)


@pytest.mark.parametrize("assignment", ["auction", "greedy"])
def test_sharded_hard_semantics_gang_spread_anti(eight_devices, assignment):
    """tests/test_parallel.test_sharded_hard_semantics_gang_spread_anti
    on the full profile: gang A placed whole, gang B rejected whole, no
    spread pod in the skewed zone, no anti pod beside its repeller, no
    double-booked node; the port's sharded decision equals JAX's."""
    from minisched_tpu.service.defaultconfig import full_scheduler_profile \
        as jfull
    from minisched_tpu_torch.service.defaultconfig import \
        full_scheduler_profile

    jx, tx = encode_both(_semantics, 32, 16)
    jeb, jnf, jaf, names = jx
    jmesh = jmake_mesh(eight_devices)
    want = jbuild_sharded(jfull().build(), jmesh, jeb, jnf, jaf,
                          assignment=assignment)(
        *jshard(jmesh, jeb, jnf, jaf), jax.random.PRNGKey(7))
    eb, nf, af = _torch(tx)
    mesh = make_mesh(CPU8)
    got = build_sharded_step(full_scheduler_profile().build(), mesh, eb, nf,
                             af, assignment=assignment)(
        *shard_features(mesh, eb, nf, af), prng.PRNGKey(7))
    assert_decisions_equal(want, got)
    chosen, assigned = got.chosen.numpy(), got.assigned.numpy()
    zone = {i: int(names[i][2:]) % 4 for i in range(len(names)) if names[i]}
    assert assigned[0:4].all()
    assert not assigned[12:22].any() and got.gang_rejected[12:22].all()
    assert all(zone[int(chosen[i])] != 0 for i in range(4, 8) if assigned[i])
    assert all(zone[int(chosen[i])] != 1 for i in range(8, 12)
               if assigned[i])
    picked = chosen[assigned].tolist()
    assert len(set(picked)) == len(picked)


# ---- the chunked-gather scan ---------------------------------------------


@pytest.mark.parametrize("seed", [0, 0xFFFFFFFF, 0x9E3779B9])
@pytest.mark.parametrize("row0", [0, 1, 128, 4095, 1 << 20])
def test_chunk_seed_shifts_the_noise_lattice(seed, row0):
    """A launch over rows [row0, row0 + C) under chunk_seed(seed, row0)
    draws, at local row r, the noise of global row row0 + r."""
    cols = torch.arange(300, dtype=torch.int64)
    for r in (0, 1, 77, 127):
        assert torch.equal(
            tie_noise_from_cols(chunk_seed(seed, row0), r, cols),
            tie_noise_from_cols(seed, row0 + r, cols))


@pytest.mark.parametrize("seed", [0, 1])
def test_chunked_scan_matches_plain_and_jax(eight_devices, seed):
    """The sharded scan's chunk launches (shifted seeds, free carried)
    equal one greedy_assign_plain over the batch and the JAX package's
    make_sharded_assign, with and without a gang to evict."""
    rng = np.random.default_rng(seed)
    P, N = 384, 64  # pod shards of 192 rows: 4 chunks of 96
    scores, requests, free0 = greedy_case(rng, P, N, R=4, quant=4,
                                          cpu_free=2000.0)
    groups = np.full((P,), -1, dtype=np.int32)
    groups[300:340] = 0          # 40 members, a quorum of 41: evicted
    gmin = np.array([41], dtype=np.int32)
    key = prng.PRNGKey(seed)
    mesh = make_mesh(CPU8)
    launches = []
    assign = make_sharded_assign(
        mesh, observe=lambda c, blk, req, free, s, r: launches.append(
            (c, blk, req, free, s, r)))
    for gids in (np.full((P,), -1, dtype=np.int32), groups):
        launches.clear()
        got = assign(torch.from_numpy(scores), torch.from_numpy(requests),
                     torch.from_numpy(free0), torch.from_numpy(gids),
                     torch.from_numpy(gmin), key)
        C = _chunk_size(P // 2)
        assert C == 96 and len(launches) % (P // C) == 0
        for c, blk, req, free, s, r in launches[-(P // C):]:
            assert s == chunk_seed(prng.bits(key), c * C)
            want_c = greedy_assign_plain(blk, req, free, s)
            for a, b in zip(want_c, r):
                assert torch.equal(a, b)
        jwant = jsharded_assign(jmake_mesh(eight_devices))(
            jnp.asarray(scores), jnp.asarray(requests), jnp.asarray(free0),
            jnp.asarray(gids), jnp.asarray(gmin), jax.random.PRNGKey(seed))
        for f in ("chosen", "assigned", "free_after", "gang_rejected"):
            assert bits_equal(np.asarray(getattr(jwant, f)),
                              getattr(got, f).numpy()), f
        if (gids < 0).all():
            whole = greedy_assign_plain(torch.from_numpy(scores),
                                        torch.from_numpy(requests),
                                        torch.from_numpy(free0),
                                        prng.bits(key))
            for a, b in zip(whole, got[:3]):
                assert torch.equal(a, b)
        else:
            assert bool(got.gang_rejected[300:340].all())


def test_build_step_assign_fn_gates():
    """The assign_fn hook's gates, as the JAX step's: no node sampling
    and no shortlist with a custom assignment stage."""
    ps = PluginSet([make_plugin("NodeUnschedulable")])
    fn = make_sharded_assign(make_mesh(CPU8))
    with pytest.raises(ValueError, match="assign_fn"):
        build_step(ps, sample_nodes=8, assign_fn=fn)
    with pytest.raises(ValueError, match="shortlist"):
        build_step(ps, shortlist=16, assign_fn=fn)
    step = build_step(ps, assign_fn=fn)
    _, tx = encode_both(_numbered, 16)
    eb, nf, af = _torch(tx)
    d = step(eb, nf, af, prng.PRNGKey(3))
    single = build_step(ps)(eb, nf, af, prng.PRNGKey(3))
    for f in single._fields:
        assert torch.equal(getattr(single, f), getattr(d, f)), f


def test_sharded_step_validates_its_inputs():
    ps = PluginSet([make_plugin("NodeUnschedulable")])
    mesh = make_mesh(CPU8)
    with pytest.raises(ValueError, match="assignment"):
        build_sharded_step(ps, mesh, assignment="hungarian")
    with pytest.raises(ValueError, match="Mesh"):
        build_sharded_step(ps, "not-a-mesh")
    from minisched_tpu_torch.plugins.tainttoleration import TaintToleration

    class _RowReader(TaintToleration):
        name = "RowReader"

        def normalize(self, scores, feasible):
            return scores - scores.max(dim=1, keepdim=True).values

    with pytest.raises(ValueError, match="rescale"):
        build_sharded_step(PluginSet([_RowReader()]), mesh)
    _, tx = encode_both(lambda O: _numbered(O, n_nodes=18), 16, n_pad=18)
    eb, nf, af = _torch(tx)
    with pytest.raises(ValueError, match="divide"):
        build_sharded_step(ps, mesh, assignment="greedy")(
            eb, nf, af, prng.PRNGKey(0))


# ---- the mesh engine -----------------------------------------------------


def _mk_node(O, name, cpu=4000.0, pods=110.0):
    return O.Node(metadata=O.ObjectMeta(name=name), spec=O.NodeSpec(),
                  status=O.NodeStatus(allocatable={
                      "cpu": cpu, "memory": 16 << 30, "pods": pods}))


def _mk_pod(O, name, cpu=100.0, priority=0):
    return O.Pod(metadata=O.ObjectMeta(name=name, namespace="default"),
                 spec=O.PodSpec(requests={"cpu": cpu, "memory": 1 << 30},
                                priority=priority))


def test_engine_on_mesh_readme_scenario():
    from minisched_tpu_torch.scenario.runner import Cluster, default_scenario

    c = Cluster()
    c.start(config=SchedulerConfig(mesh=make_mesh(CPU8), platform="cpu"),
            with_pv_controller=False)
    try:
        default_scenario(c)
        assert c.service.scheduler.metrics()["shortlist_width"] == 0
    finally:
        c.shutdown()


def test_engine_burst_on_mesh_matches_jax_single_device():
    """A 2,000-pod burst on 256 nodes: the port's mesh engine (greedy,
    the engine default) places every pod exactly as the JAX package's
    single-device engine with the same seed (the JAX suite holds its own
    mesh engine equal to it)."""
    N_PODS, N_NODES = 2000, 256
    plugins = ["NodeUnschedulable", "NodeResourcesFit",
               "NodeResourcesLeastAllocated",
               "NodeResourcesBalancedAllocation"]

    def run(O, Store, Service, Prof, config):
        store = Store()
        for i in range(N_NODES):
            store.create(_mk_node(O, f"bn{i:03d}",
                                  cpu=4000.0 + (i % 5) * 500))
        for i in range(N_PODS):
            store.create(_mk_pod(O, f"bp{i:04d}", cpu=100.0 + (i % 3) * 50))
        svc = Service(store)
        svc.start_scheduler(Prof(name="default-scheduler", plugins=plugins),
                            config)
        try:
            deadline = time.time() + 120
            while time.time() < deadline:
                if all(p.spec.node_name for p in store.list("Pod")):
                    break
                time.sleep(0.1)
            return ({p.key: p.spec.node_name for p in store.list("Pod")},
                    svc.scheduler.metrics())
        finally:
            svc.shutdown_scheduler()

    got, m = run(TO, ClusterStore, SchedulerService, Profile,
                 SchedulerConfig(mesh=make_mesh(CPU8), platform="cpu",
                                 max_batch_size=2048, batch_window_s=0.3,
                                 seed=7))
    want, _ = run(JO, JStore, JService, JProfile,
                  JConfig(max_batch_size=2048, batch_window_s=0.3, seed=7))
    assert len(got) == N_PODS and all(got.values())
    diffs = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
    assert not diffs, (len(diffs), dict(list(diffs.items())[:5]))
    assert m["shortlist_width"] == 0 and m["sampled_batches"] == 0


def _topology_preemption(mesh):
    """tests/test_parallel.test_engine_on_mesh_topology_and_preemption on
    the port: hard spread over two zones, then a high-priority pod that
    only preemption can place. Returns the final placements."""
    store = ClusterStore()
    for i in range(8):
        n = _mk_node(TO, f"zn{i}", pods=2.0)
        n.metadata.labels = {ZONE: f"z{i % 2}"}
        store.create(n)
    svc = SchedulerService(store)
    svc.start_scheduler(
        Profile(name="default-scheduler",
                plugins=["NodeUnschedulable", "NodeResourcesFit",
                         "PodTopologySpread", "InterPodAffinity",
                         "NodeResourcesLeastAllocated",
                         "DefaultPreemption"]),
        SchedulerConfig(mesh=mesh, seed=3, platform="cpu"))
    try:
        for i in range(6):
            p = _mk_pod(TO, f"sp{i}")
            p.metadata.labels = {"app": "s"}
            p.spec.topology_spread_constraints = [
                TO.TopologySpreadConstraint(
                    max_skew=1, topology_key=ZONE,
                    when_unsatisfiable="DoNotSchedule",
                    label_selector=TO.LabelSelector(
                        match_labels={"app": "s"}))]
            store.create(p)
        deadline = time.time() + 60
        while time.time() < deadline:
            pods = [p for p in store.list("Pod")
                    if p.metadata.name.startswith("sp")]
            if all(p.spec.node_name for p in pods):
                break
            time.sleep(0.1)
        zones = {"z0": 0, "z1": 0}
        for p in pods:
            assert p.spec.node_name, f"{p.key} never bound"
            zones[store.get("Node", p.spec.node_name).metadata.labels[
                ZONE]] += 1
        assert abs(zones["z0"] - zones["z1"]) <= 1, zones
        fill = [store.create(_mk_pod(TO, f"fill{i}", cpu=3500.0,
                                     priority=1)) for i in range(8)]
        deadline = time.time() + 60
        while time.time() < deadline:
            if all(store.get("Pod", f.key).spec.node_name for f in fill):
                break
            time.sleep(0.1)
        hi = store.create(_mk_pod(TO, "hi", cpu=3500.0, priority=100))
        deadline = time.time() + 60
        while time.time() < deadline:
            try:
                if store.get("Pod", hi.key).spec.node_name:
                    break
            except Exception:
                pass
            time.sleep(0.1)
        assert store.get("Pod", hi.key).spec.node_name, \
            "the high-priority pod never bound through preemption"
        return {p.key: p.spec.node_name for p in store.list("Pod")}
    finally:
        svc.shutdown_scheduler()


def test_engine_on_mesh_topology_and_preemption(monkeypatch):
    """Hard spread holds and preemption places the high-priority pod on
    the mesh engine. The preemption op runs on full-axis leaves on the
    mesh's first device, and its four outputs equal the op's on the
    same inputs off the mesh."""
    from minisched_tpu_torch.ops import preempt

    mesh = make_mesh(CPU8)
    calls = []
    build = preempt.build_preempt_op

    def recording(plugin_set, **kw):
        op = build(plugin_set, **kw)

        def run(eb, nf, af):
            out = op(eb, nf, af)
            calls.append((plugin_set, kw, eb, nf, af, out))
            return out
        return run

    monkeypatch.setattr(preempt, "build_preempt_op", recording)
    placed = _topology_preemption(mesh)
    assert placed["default/hi"]
    assert calls, "the mesh engine never ran the preemption op"
    for plugin_set, kw, eb, nf, af, out in calls:
        assert nf.valid.device == mesh.device
        assert nf.valid.shape[0] % 4 == 0 and nf.valid.shape[0] >= 8
        want = build(plugin_set, **kw)(*(to_torch(x, "cpu")
                                         for x in (eb, nf, af)))
        assert len(out) == len(want) == 4
        for a, b in zip(want, out):
            assert torch.equal(a, b)


def test_mesh_config_validated_at_startup():
    """A bad mesh or assignment fails at start_scheduler, not as an
    endless retry loop on the scheduling thread."""
    svc = SchedulerService(ClusterStore())
    with pytest.raises(ValueError, match="mesh"):
        svc.start_scheduler(Profile(), SchedulerConfig(mesh="not-a-mesh",
                                                       platform="cpu"))
    svc2 = SchedulerService(ClusterStore())
    with pytest.raises(ValueError, match="assignment"):
        svc2.start_scheduler(
            Profile(), SchedulerConfig(mesh=make_mesh(CPU8),
                                       assignment="Auction",
                                       platform="cpu"))
    with pytest.raises(ValueError, match="assignment"):
        build_sharded_step(PluginSet([make_plugin("NodeUnschedulable")]),
                           make_mesh(CPU8), assignment="hungarian")


def test_engine_mesh_mode_knob_equality():
    """tests/test_shortlist.test_engine_mesh_mode_knob_equality: the
    shortlist knob changes nothing on a mesh (full (P,N) rows), the
    width gauge reads 0, and the sharded step runs."""
    from minisched_tpu_torch.scenario import Cluster

    def run(shortlist):
        c = Cluster()
        try:
            c.start(profile=Profile(
                name="default-scheduler",
                plugins=["NodeUnschedulable", "NodeResourcesFit",
                         "PodTopologySpread",
                         "NodeResourcesLeastAllocated"]),
                config=SchedulerConfig(
                    mesh=make_mesh(CPU8), platform="cpu",
                    shortlist=shortlist, shortlist_k=128, pipeline=False,
                    device_resident=False, max_batch_size=8,
                    batch_window_s=0.3, backoff_initial_s=0.05,
                    backoff_max_s=0.2), with_pv_controller=False)
            for i, zone in enumerate(("a", "a", "b", "b", "c", "c")):
                c.create_node(f"n{i}", cpu=64000, labels={ZONE: zone})
            pods, pri = [], 100
            for i in range(8):
                pods.append(TO.Pod(
                    metadata=TO.ObjectMeta(name=f"sp-{i}",
                                           namespace="default",
                                           labels={"app": "spread"}),
                    spec=TO.PodSpec(
                        requests={"cpu": 100}, priority=pri - i,
                        topology_spread_constraints=[
                            TO.TopologySpreadConstraint(
                                max_skew=1, topology_key=ZONE,
                                when_unsatisfiable="DoNotSchedule",
                                label_selector=TO.LabelSelector(
                                    match_labels={"app": "spread"}))])))
            for i in range(4):
                pods.append(TO.Pod(
                    metadata=TO.ObjectMeta(name=f"g-{i}",
                                           namespace="default"),
                    spec=TO.PodSpec(requests={"cpu": 200},
                                    priority=90 - i, pod_group="gang1",
                                    pod_group_min=4)))
            for i in range(12):
                pods.append(TO.Pod(
                    metadata=TO.ObjectMeta(name=f"pl-{i}",
                                           namespace="default"),
                    spec=TO.PodSpec(requests={"cpu": 300},
                                    priority=80 - i)))
            c.create_objects(pods)
            names = [p.metadata.name for p in pods]
            deadline = time.monotonic() + 60
            placed = {}
            while time.monotonic() < deadline:
                placed = {p.metadata.name: p.spec.node_name
                          for p in c.list_pods() if p.spec.node_name}
                if all(n in placed for n in names):
                    break
                time.sleep(0.05)
            assert all(n in placed for n in names), \
                sorted(set(names) - set(placed))
            return placed, c.service.scheduler.metrics()
        finally:
            c.shutdown()

    on, m_on = run(True)
    off, m_off = run(False)
    assert m_on["shortlist_width"] == 0 == m_off["shortlist_width"]
    assert m_on["steps_dispatched"] >= 1
    assert on == off


def test_kitchen_sink_mesh_multiprofile_integration():
    """tests/test_multiprofile.test_kitchen_sink_mesh_multiprofile_
    integration on the port: two profiles over one cluster state and one
    mesh config, scheduling hard spread, a gang, a PVC-backed pod (the
    PV controller running) and a priority preemption."""
    from minisched_tpu_torch.errors import NotFoundError
    from minisched_tpu_torch.scenario import Cluster

    sel = TO.LabelSelector(match_labels={"app": "web"})
    c = Cluster()
    try:
        c.start(profile=[
            Profile(name="default-scheduler",
                    plugins=["NodeUnschedulable", "NodeResourcesFit",
                             "PodTopologySpread", "InterPodAffinity",
                             "VolumeBinding", "DefaultPreemption"],
                    plugin_args={"NodeResourcesFit":
                                 {"score_strategy": None}}),
            Profile(name="batch-sched",
                    plugins=["NodeUnschedulable", "NodeResourcesFit"]),
        ], config=SchedulerConfig(mesh=make_mesh(CPU8), platform="cpu",
                                  backoff_initial_s=0.05, backoff_max_s=0.2,
                                  batch_window_s=0.1),
            with_pv_controller=True)
        for i in range(8):
            c.create_node(f"n{i}", cpu=1000, labels={ZONE: f"z{i % 4}"},
                          accelerator=1 if i == 0 else 0)
        c.create_pod("filler", spec=TO.PodSpec(
            requests={"cpu": 100, "accelerator": 1}))
        filler_node = c.wait_for_pod_bound("filler",
                                           timeout=30.0).spec.node_name
        assert filler_node == "n0"
        for i in range(8):
            c.create_pod(f"web{i}", labels={"app": "web"},
                         spec=TO.PodSpec(
                             requests={"cpu": 100},
                             topology_spread_constraints=[
                                 TO.TopologySpreadConstraint(
                                     max_skew=1, topology_key=ZONE,
                                     when_unsatisfiable="DoNotSchedule",
                                     label_selector=sel)]))
        for i in range(4):
            c.create_pod(f"gang{i}",
                         spec=TO.PodSpec(requests={"cpu": 100},
                                         scheduler_name="batch-sched",
                                         pod_group="team", pod_group_min=4))
        c.create_pv("pv1", storage=1 << 30)
        c.create_pvc("claim1")
        c.create_pod("db", spec=TO.PodSpec(
            requests={"cpu": 100},
            volumes=[TO.VolumeClaim(claim_name="claim1")]))
        for name in ([f"web{i}" for i in range(8)]
                     + [f"gang{i}" for i in range(4)] + ["db"]):
            c.wait_for_pod_bound(name, timeout=60.0)
        zcounts = {}
        for i in range(8):
            nd = c.store.get("Node", c.get_pod(f"web{i}").spec.node_name)
            z = nd.metadata.labels[ZONE]
            zcounts[z] = zcounts.get(z, 0) + 1
        assert max(zcounts.values()) - min(zcounts.values()) <= 1, zcounts
        assert all(c.get_pod(f"gang{i}").spec.node_name for i in range(4))
        assert c.store.get("PersistentVolumeClaim",
                           "default/claim1").phase == "Bound"
        c.create_pod("critical",
                     spec=TO.PodSpec(requests={"cpu": 100,
                                               "accelerator": 1},
                                     priority=100))
        crit = c.wait_for_pod_bound("critical", timeout=60.0)
        assert crit.spec.node_name == filler_node
        with pytest.raises(NotFoundError):
            c.store.get("Pod", "default/filler")
    finally:
        c.shutdown()


# ---- the multi-process dryrun --------------------------------------------


def test_two_process_dcn_dryrun():
    """tests/test_dcn.test_two_process_dcn_dryrun on the port: two worker
    processes join one gloo group, the hybrid mesh's pod axis spans
    them, and both report the decision equal to a single-device
    recompute."""
    from minisched_tpu_torch.parallel.dcn_dryrun import run_dcn_dryrun

    out = run_dcn_dryrun(nprocs=2, timeout_s=120.0, platform="cpu")
    assert "DCN-OK 0" in out and "DCN-OK 1" in out
    assert "DCN == single-device" in out
    assert "16/16 scheduled" in out

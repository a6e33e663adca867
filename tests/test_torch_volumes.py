"""The volume family on the port against the JAX package: the engine's
volume-derived encode inputs (readiness, claim mount rows, cloud typing,
the zone requirement and the attach-slot charge of pods whose claim is
already mounted), the eight volume plugin columns bitwise, sampled and
unsampled, arbitrate_rwo's cases, and the scenarios of
tests/test_volume_plugins.py on both engines."""
import time

import numpy as np
import pytest

from minisched_tpu.config import SchedulerConfig as JConfig
from minisched_tpu.engine.queue import QueuedPodInfo as JQueued
from minisched_tpu.engine.scheduler import Scheduler as JScheduler
from minisched_tpu.plugins import PluginSet as JPluginSet
from minisched_tpu.scenario.runner import Cluster as JCluster
from minisched_tpu.service.defaultconfig import Profile as JProfile
from minisched_tpu.service.defaultconfig import make_plugin as jmake
from minisched_tpu.state import objects as JO
from minisched_tpu.state.store import ClusterStore as JStore
from minisched_tpu_torch.config import SchedulerConfig
from minisched_tpu_torch.engine.queue import QueuedPodInfo
from minisched_tpu_torch.engine.scheduler import Scheduler
from minisched_tpu_torch.plugins import PluginSet
from minisched_tpu_torch.scenario.runner import Cluster, wait_until
from minisched_tpu_torch.service.defaultconfig import Profile, make_plugin
from minisched_tpu_torch.state import objects as TO
from minisched_tpu_torch.state.store import ClusterStore
from torch_parity import bits_equal

ZONE = "topology.kubernetes.io/zone"

# (package objects, Cluster, Profile, config factory, Scheduler, store,
# QueuedPodInfo, PluginSet, make_plugin) per package.
JAX = (JO, JCluster, JProfile, lambda **kw: JConfig(**kw), JScheduler,
       JStore, JQueued, JPluginSet, jmake)
PORT = (TO, Cluster, Profile,
        lambda **kw: SchedulerConfig(platform="cpu", **kw), Scheduler,
        ClusterStore, QueuedPodInfo, PluginSet, make_plugin)
PACKAGES = pytest.mark.parametrize("pkg", [JAX, PORT], ids=["jax", "port"])


def _fast(make_cfg, **kw):
    kw.setdefault("backoff_initial_s", 0.05)
    kw.setdefault("backoff_max_s", 0.2)
    return make_cfg(**kw)


# ---- F2: the attach-slot charge of a pod whose claim is mounted ---------

def _mounted_claim_run(pkg):
    """NodeUnschedulable + NodeResourcesFit, one node with one attach
    slot and a Bound claim: p1 mounts it, then p2 shares it. The claim is
    pinned to n1 when p2 is encoded, so p2 needs no new slot there."""
    O, cluster_cls, prof, cfg = pkg[:4]
    c = cluster_cls()
    c.start(profile=prof(plugins=["NodeUnschedulable", "NodeResourcesFit"]),
            config=_fast(cfg), with_pv_controller=False)
    try:
        c.create_node("n1", attachable_volumes=1)
        c.create_pvc("claim-a", phase="Bound")
        spec = lambda: O.PodSpec(requests={"cpu": 100},  # noqa: E731
                                 volumes=[O.VolumeClaim(claim_name="claim-a")])
        out = []
        for name in ("p1", "p2"):
            c.create_pod(name, spec=spec())
            wait_until(lambda: bool(c.get_pod(name).spec.node_name), 3.0)
            out.append(c.get_pod(name).spec.node_name or "not bound")
        return tuple(out)
    finally:
        c.shutdown()


def test_mounted_claim_is_not_charged_a_new_attach_slot():
    """The JAX engine hands the encoder its volume callbacks under every
    profile: a claim pinned to a node costs no new slot there. The port
    must place p2 like it does."""
    want = _mounted_claim_run(JAX)
    assert want == ("n1", "n1")
    assert _mounted_claim_run(PORT) == want


def _volume_store(O, store_cls, n_extra=0):
    """Three nodes in two zones (and ``n_extra`` more); claims pinned (h1
    on n1), shared (on n1 and n2), unused, cloud-typed, pending,
    WaitForFirstConsumer with candidate PVs in one zone and in two, and
    PVs in two zones."""
    st = store_cls()

    def node(name, zone):
        st.create(O.Node(metadata=O.ObjectMeta(name=name,
                                               labels={ZONE: zone}),
                         status=O.NodeStatus(allocatable={
                             "cpu": 8000.0, "pods": 110.0,
                             "attachable-volumes": 8.0})))

    def pv(name, zone, *, cls="", phase="Available", claim=""):
        st.create(O.PersistentVolume(
            metadata=O.ObjectMeta(name=name, labels={ZONE: zone}),
            capacity={"ephemeral-storage": float(1 << 30)},
            storage_class=cls, phase=phase, claim_ref=claim))

    def pvc(name, *, phase="Bound", volume="", cls="", mode="Immediate"):
        st.create(O.PersistentVolumeClaim(
            metadata=O.ObjectMeta(name=name, namespace="default"),
            request={"ephemeral-storage": float(1 << 30)},
            storage_class=cls, volume_name=volume, phase=phase,
            binding_mode=mode))

    for name, zone in (("n1", "za"), ("n2", "zb"), ("n3", "za")):
        node(name, zone)
    for i in range(n_extra):
        node(f"x{i}", ("za", "zb", "zc")[i % 3])
    pv("pv-a", "za", phase="Bound", claim="default/claim-za")
    pv("pv-b", "zb", phase="Bound", claim="default/claim-zb")
    pv("pv-w1", "za", cls="wf1")
    pv("pv-w2", "za", cls="wf2")
    pv("pv-w3", "zb", cls="wf2")
    for name in ("claim-pin", "claim-multi", "claim-unused", "claim-ebs",
                 "claim-unused2"):
        pvc(name)
    pvc("claim-za", volume="pv-a")
    pvc("claim-zb", volume="pv-b")
    pvc("claim-pend", phase="Pending")
    pvc("claim-wf1", phase="Pending", cls="wf1", mode="WaitForFirstConsumer")
    pvc("claim-wf2", phase="Pending", cls="wf2", mode="WaitForFirstConsumer")

    def vols(*names):
        return [O.VolumeClaim(claim_name=n,
                              volume_type="aws-ebs" if n == "claim-ebs"
                              else "") for n in names]

    bound = []
    for name, node_name, claims in (("h1", "n1", ("claim-pin",)),
                                    ("m1", "n1", ("claim-multi",)),
                                    ("m2", "n2", ("claim-multi",))):
        p = O.Pod(metadata=O.ObjectMeta(name=name, namespace="default"),
                  spec=O.PodSpec(requests={"cpu": 100.0},
                                 volumes=vols(*claims), node_name=node_name))
        st.create(p)
        bound.append(p)
    batch = []
    for i, claims in enumerate((
            ("claim-pin", "claim-unused"), ("claim-multi",),
            ("claim-unused",), ("claim-ebs", "claim-unused2"),
            ("claim-pend",), ("claim-wf1",), ("claim-wf2",),
            ("claim-za", "claim-zb"), ("claim-za",), (),
            ("claim-wf1", "claim-zb"), ("claim-zb", "claim-pin"))):
        p = O.Pod(metadata=O.ObjectMeta(name=f"q{i}", namespace="default"),
                  spec=O.PodSpec(requests={"cpu": 100.0},
                                 volumes=vols(*claims)))
        st.create(p)
        batch.append(p)
    return st, bound, batch


def _engine_encode(pkg, plugins, n_extra=0, full=False):
    """The engine's encode of the claim-carrying batch → its pod leaves,
    or with ``full`` (eb, nf, af, names), numpy leaves."""
    O, _c, _p, cfg, sched_cls, store_cls, queued, pset, make = pkg
    st, bound, batch = _volume_store(O, store_cls, n_extra)
    eng = sched_cls(st, pset([make(n) for n in plugins]), cfg())
    try:
        for n in st.list("Node"):
            eng.cache.upsert_node(n)
        for p in bound:
            assert eng.cache.account_bind(st.get("Pod", p.key))
        qs = [queued(pod=p) for p in batch]
        eb = eng._encode_batch(qs, [q.pod for q in qs], 16)[-1]
        if not full:
            return eb.pf
        nf, names, _sv, _incs = eng.cache.snapshot_versioned()
        return eb, nf, eng.cache.snapshot_assigned(), names
    finally:
        eng.shutdown()


@pytest.mark.parametrize("plugins", [
    ["NodeUnschedulable", "NodeResourcesFit"],
    ["NodeUnschedulable", "NodeResourcesFit", "VolumeBinding",
     "VolumeRestrictions", "VolumeZone", "NodeVolumeLimits", "EBSLimits"],
], ids=["bench", "volumes"])
def test_engine_encode_volume_fields_match_jax(plugins):
    """Every volume field and the requests of the engines' encodes are
    bitwise equal, under a profile without a volume plugin too."""
    want = _engine_encode(JAX, plugins)
    got = _engine_encode(PORT, plugins)
    for f in ("requests", "claim_rows", "claim_typed", "zone_key",
              "zone_dom", "volumes_ready"):
        assert bits_equal(np.asarray(getattr(want, f)),
                          np.asarray(getattr(got, f))), f
    # the batch reaches every case: pinned, multi and unused rows, a
    # typed slot, a pending claim, a one-zone WFFC requirement and the
    # impossible domain
    rows = np.asarray(got.claim_rows)
    assert (rows >= 0).any() and (rows == -1).any() and (rows == -2).any()
    assert np.asarray(got.claim_typed).any()
    assert not np.asarray(got.volumes_ready)[:12].all()
    assert (np.asarray(got.zone_dom) == -2).any()
    assert (np.asarray(got.zone_key)[:12] > 0).any()


# ---- the eight volume plugins, column by column ------------------------

VOLUME_PLUGINS = ["VolumeBinding", "VolumeRestrictions", "VolumeZone",
                  "NodeVolumeLimits", "EBSLimits", "GCEPDLimits",
                  "AzureDiskLimits", "CinderLimits"]


@pytest.mark.parametrize("name", VOLUME_PLUGINS)
def test_volume_plugin_matches_jax(name):
    """The plugin's filter column bitwise on the engine-encoded claim
    batch, then the step with it (NodeUnschedulable + NodeResourcesFit +
    the plugin), unsampled and on an 8-node sample of 43: every Decision
    field bitwise. The claim pinned to n1 lies outside the sample, so its
    pods read 0-feasible there (the engine's residual pass decides them)."""
    import jax

    from minisched_tpu.ops.pipeline import build_step as jbuild_step
    from minisched_tpu_torch.encode import to_torch
    from minisched_tpu_torch.ops import prng
    from minisched_tpu_torch.ops.pipeline import (_select_node_sample,
                                                  build_step)
    from test_torch_plugins_full import assert_decisions_equal

    plugins = ["NodeUnschedulable", "NodeResourcesFit", name]
    jeb, jnf, jaf, names = _engine_encode(JAX, plugins, 40, full=True)
    teb, tnf, taf, names_t = _engine_encode(PORT, plugins, 40, full=True)
    assert names == names_t
    jp, tp = jmake(name), make_plugin(name)
    assert (jp.is_filter, jp.is_score, jp.column_local,
            jp.needs_topology) == (tp.is_filter, tp.is_score,
                                   tp.column_local, tp.needs_topology)
    assert [(e.resource, int(e.action_type))
            for e in jp.events_to_register()] == [
        (e.resource, int(e.action_type)) for e in tp.events_to_register()]
    eb, nf, af = (to_torch(x, "cpu") for x in (teb, tnf, taf))
    want = np.asarray(jp.filter(jeb.pf, jnf, {}))
    got = tp.filter(eb.pf, nf, {}).numpy()
    assert bits_equal(want, got)
    jps = JPluginSet([jmake(n) for n in plugins])
    tps = PluginSet([make_plugin(n) for n in plugins])
    for k in (None, 8):
        jd = jbuild_step(jps, sample_nodes=k)(
            jeb, jnf, jaf, jax.random.fold_in(jax.random.PRNGKey(3), 1))
        key = prng.fold_in(prng.PRNGKey(3), 1)
        td = build_step(tps, sample_nodes=k)(eb, nf, af, key)
        assert_decisions_equal(jd, td)
    _key, skey = prng.split(key)
    sample = set(_select_node_sample(nf, skey, 8).tolist())
    assert names.index("n1") not in sample


def test_volume_filters_reject_what_they_should():
    """The claim batch exercises every filter: the pinned pod fits only n1,
    the pending claim nowhere, the two-zone pod nowhere, the za-bound pod
    only in za."""
    from minisched_tpu_torch.encode import to_torch

    teb, tnf, _taf, names = _engine_encode(PORT, ["VolumeBinding"], 0,
                                           full=True)
    eb, nf = to_torch(teb, "cpu"), to_torch(tnf, "cpu")
    real = [i for i, n in enumerate(names) if n is not None]
    col = {n: make_plugin(n).filter(eb.pf, nf, {}).numpy()[:, real]
           for n in ("VolumeRestrictions", "VolumeBinding", "VolumeZone")}
    n_of = [names[i] for i in real]
    assert [n_of[j] for j in np.nonzero(col["VolumeRestrictions"][0])[0]
            ] == ["n1"]
    assert not col["VolumeBinding"][4].any()       # pending claim
    assert not col["VolumeZone"][7].any()          # PVs in two zones
    assert sorted(n_of[j] for j in np.nonzero(col["VolumeZone"][8])[0]
                  ) == ["n1", "n3"]                # claim-za → zone za


# ---- arbitrate_rwo's cases (tests/test_volume_plugins.py) --------------

def _arb_batch(*specs):
    """(batch, assigned, chosen, vol_memo) from (name, node_row_or_None,
    gang, claims) tuples; every claim is UNUSED at encode time."""
    from minisched_tpu_torch.state.objects import CLAIM_UNUSED, claim_keys

    batch, rows = [], []
    vol_memo = {}
    for name, row, gang, claims in specs:
        spec = TO.PodSpec(
            requests={"cpu": 100},
            volumes=[TO.VolumeClaim(claim_name=c) for c in claims])
        if gang:
            spec.pod_group, spec.pod_group_min = gang, 1
        pod = TO.Pod(metadata=TO.ObjectMeta(name=name, namespace="d"),
                     spec=spec)
        batch.append(QueuedPodInfo(pod=pod))
        rows.append(-1 if row is None else row)
        vol_memo[pod.key] = (True, [CLAIM_UNUSED] * len(claim_keys(pod)))
    assigned = np.array([r >= 0 for r in rows])
    chosen = np.array([max(r, 0) for r in rows])
    return batch, assigned, chosen, vol_memo


ARB_CASES = {
    # second pod on another node for a shared unused claim is revoked;
    # same-node sharers and unrelated claims are untouched
    "basic": ([("p0", 1, None, ["x"]), ("p1", 2, None, ["x"]),
               ("p2", 1, None, ["x"]), ("p3", 3, None, ["y"])],
              {1}, set()),
    # a pod revoked only by a pin whose owner is itself revoked (gang
    # atomicity over another claim) is rescued
    "rescue": ([("hi", 1, None, ["a"]), ("g1", 2, "G", ["a"]),
                ("g2", 2, "G", ["b"]), ("low", 3, None, ["b"])],
               {1, 2}, set()),
    # the rescued pod's pin governs later same-claim pods
    "rescued-pins": ([("hi", 1, None, ["a"]), ("g1", 2, "G", ["a"]),
                      ("g2", 2, "G", ["b"]), ("mid", 3, None, ["b"]),
                      ("tail", 4, None, ["b"])],
                     {1, 2, 4}, set()),
    # gang members demanding one claim on different nodes park the gang
    "intra-gang": ([("g1", 1, "G", ["x"]), ("g2", 2, "G", ["x"]),
                    ("bystander", 5, None, ["y"])],
                   {0, 1}, {"d/G"}),
}


@pytest.mark.parametrize("case", sorted(ARB_CASES))
def test_arbitrate_rwo_cases_match_jax(case):
    from minisched_tpu.engine.scheduler import arbitrate_rwo as jarb
    from minisched_tpu_torch.engine.scheduler import arbitrate_rwo

    specs, want_rev, want_parked = ARB_CASES[case]
    batch, a, c, memo = _arb_batch(*specs)
    revoked, parked = arbitrate_rwo(batch, a, c, memo)
    assert (revoked, parked) == (want_rev, want_parked)
    jbatch = [JQueued(pod=JO.Pod(
        metadata=JO.ObjectMeta(name=q.pod.metadata.name, namespace="d"),
        spec=JO.PodSpec(requests={"cpu": 100},
                        pod_group=q.pod.spec.pod_group,
                        pod_group_min=q.pod.spec.pod_group_min,
                        volumes=[JO.VolumeClaim(claim_name=v.claim_name)
                                 for v in q.pod.spec.volumes])))
              for q in batch]
    assert jarb(jbatch, a, c, memo) == (revoked, parked)


def test_arbitrate_rwo_no_two_survivors_share_claim_differently():
    """Safety under a cascade: committed pods never bind one claim to two
    nodes."""
    from minisched_tpu_torch.engine.scheduler import arbitrate_rwo
    from minisched_tpu_torch.state.objects import claim_keys

    batch, a, c, memo = _arb_batch(
        ("p0", 1, None, ["a"]), ("g1", 2, "G", ["a", "b"]),
        ("g2", 3, "G", ["c"]), ("h1", 3, "H", ["b", "c"]),
        ("h2", 4, "H", ["d"]), ("p5", 5, None, ["d", "a"]),
        ("p6", 1, None, ["a", "d"]))
    revoked, _parked = arbitrate_rwo(batch, a, c, memo)
    placed = {}
    for i in range(len(batch)):
        if i in revoked:
            continue
        for ck in claim_keys(batch[i].pod):
            assert placed.setdefault(ck, int(c[i])) == int(c[i])


# ---- tests/test_volume_plugins.py on both engines ----------------------

def _start(pkg, plugins, **kw):
    c = pkg[1]()
    c.start(profile=pkg[2](plugins=list(plugins)), config=_fast(pkg[3], **kw),
            with_pv_controller=False)
    return c


def _vspec(O, *claims, cpu=100.0, typ=""):
    return O.PodSpec(requests={"cpu": cpu},
                     volumes=[O.VolumeClaim(claim_name=c, volume_type=typ)
                              for c in claims])


def _final(c):
    return {p.metadata.name: p.spec.node_name for p in c.list_pods()}


def _both(scenario):
    """Run the scenario on both engines; each asserts the JAX test's
    expectations, and the final placements must be equal."""
    want = scenario(JAX)
    assert scenario(PORT) == want


def _pins(pkg):
    O = pkg[0]
    c = _start(pkg, ["VolumeRestrictions"])
    try:
        c.create_node("vr-node1")
        c.create_pvc("claim-a", phase="Bound")
        c.create_pod("vr-p1", spec=_vspec(O, "claim-a"))
        assert c.wait_for_pod_bound("vr-p1", timeout=30).spec.node_name == (
            "vr-node1")
        c.create_node("vr-node2")
        c.create_pod("vr-p2", spec=_vspec(O, "claim-a"))
        assert c.wait_for_pod_bound("vr-p2", timeout=10).spec.node_name == (
            "vr-node1")
        c.create_pod("vr-p3", spec=_vspec(O, "claim-b"))
        c.wait_for_pod_bound("vr-p3", timeout=10)
        return {k: v for k, v in _final(c).items() if k != "vr-p3"}
    finally:
        c.shutdown()


def test_volume_restrictions_pins_claim_to_its_node():
    _both(_pins)


@PACKAGES
def test_volume_restrictions_releases_on_pod_delete(pkg):
    O = pkg[0]
    c = _start(pkg, ["VolumeRestrictions"])
    try:
        c.create_node("vrr-node1", pods=1)
        c.create_pvc("claim-c", phase="Bound")
        c.create_pod("vrr-p1", spec=_vspec(O, "claim-c"))
        c.wait_for_pod_bound("vrr-p1", timeout=30)
        c.create_node("vrr-node2")
        c.create_pod("vrr-p2", spec=_vspec(O, "claim-c"))
        assert c.wait_for_pod_pending("vrr-p2",
                                      timeout=30).status.unschedulable_plugins
        c.delete_pod("vrr-p1")
        c.wait_for_pod_bound("vrr-p2", timeout=10)
    finally:
        c.shutdown()


def _zone(pkg):
    O = pkg[0]
    c = _start(pkg, ["VolumeZone"])
    try:
        c.create_node("z1-node", labels={ZONE: "z1"})
        c.create_node("z2-node", labels={ZONE: "z2"})
        c.create_pv("pv-z1", zone="z1", phase="Bound",
                    claim_ref="default/claim-z")
        c.create_pvc("claim-z", volume_name="pv-z1")
        for i in range(3):
            c.create_pod(f"vz-p{i}", spec=_vspec(O, "claim-z"))
            assert c.wait_for_pod_bound(f"vz-p{i}",
                                        timeout=30).spec.node_name == "z1-node"
        c.create_pod("vz-free")
        c.wait_for_pod_bound("vz-free", timeout=10)
        return _final(c)
    finally:
        c.shutdown()


def test_volume_zone_restricts_to_pv_zone():
    _both(_zone)


def _zone_parks(pkg):
    O = pkg[0]
    c = _start(pkg, ["VolumeZone"])
    try:
        c.create_node("zx-node", labels={ZONE: "z9"})
        c.create_pv("pv-z3", zone="z3", phase="Bound",
                    claim_ref="default/claim-x")
        c.create_pvc("claim-x", volume_name="pv-z3")
        c.create_pod("vzx-p", spec=_vspec(O, "claim-x"))
        pending = c.wait_for_pod_pending("vzx-p", timeout=30)
        assert "VolumeZone" in pending.status.unschedulable_plugins
        c.create_node("z3-node", labels={ZONE: "z3"})
        assert c.wait_for_pod_bound("vzx-p", timeout=10).spec.node_name == (
            "z3-node")
        return _final(c)
    finally:
        c.shutdown()


def test_volume_zone_no_matching_zone_parks_pod():
    _both(_zone_parks)


def _limits(pkg):
    O = pkg[0]
    c = _start(pkg, ["NodeVolumeLimits"])
    try:
        c.create_node("nvl-node", attachable_volumes=2)
        c.create_pod("nvl-p1", spec=_vspec(O, "c1", "c2"))
        c.wait_for_pod_bound("nvl-p1", timeout=30)
        c.create_pod("nvl-p2", spec=_vspec(O, "c3"))
        pending = c.wait_for_pod_pending("nvl-p2", timeout=30)
        assert "NodeVolumeLimits" in pending.status.unschedulable_plugins
        c.create_pod("nvl-free")
        c.wait_for_pod_bound("nvl-free", timeout=10)
        c.delete_pod("nvl-p1")
        c.wait_for_pod_bound("nvl-p2", timeout=10)
        return _final(c)
    finally:
        c.shutdown()


def test_node_volume_limits_filters_and_attributes():
    _both(_limits)


def _colocate(pkg):
    O = pkg[0]
    c = _start(pkg, ["VolumeRestrictions"])
    try:
        c.create_node("co-node1")
        c.create_node("co-node2")
        c.create_pvc("claim-shared", phase="Bound")
        for i in range(3):
            c.create_pod(f"co-p{i}", spec=_vspec(O, "claim-shared"))
        nodes = {c.wait_for_pod_bound(f"co-p{i}", timeout=30).spec.node_name
                 for i in range(3)}
        assert len(nodes) == 1, f"RWO claim split across nodes: {nodes}"
    finally:
        c.shutdown()


@PACKAGES
def test_shared_unpinned_claim_colocates_within_one_batch(pkg):
    _colocate(pkg)


def test_shared_unpinned_claim_in_one_batch_places_like_jax():
    """All objects in the store before start: one batch, the RWO
    arbitration revokes two pods, and the next cycle pins them, on both
    engines alike."""
    out = []
    for pkg in (JAX, PORT):
        O, cluster_cls, prof, cfg = pkg[:4]
        c = cluster_cls()
        c.create_objects([O.Node(metadata=O.ObjectMeta(name=f"co-n{i}"),
                                 status=O.NodeStatus(allocatable={
                                     "cpu": 4000.0, "pods": 110.0}))
                          for i in range(4)])
        c.create_objects([O.PersistentVolumeClaim(
            metadata=O.ObjectMeta(name=f"cl{k}", namespace="default"),
            phase="Bound") for k in range(3)])
        c.create_objects([O.Pod(
            metadata=O.ObjectMeta(name=f"co-p{i}", namespace="default"),
            spec=_vspec(O, f"cl{i % 3}", cpu=100.0 * (1 + i % 4)))
            for i in range(12)])
        c.start(profile=prof(plugins=["NodeUnschedulable",
                                      "NodeResourcesFit",
                                      "NodeResourcesLeastAllocated",
                                      "VolumeRestrictions"]),
                config=_fast(cfg), with_pv_controller=False)
        try:
            assert wait_until(lambda: all(p.spec.node_name
                                          for p in c.list_pods()), 30)
            out.append(_final(c))
        finally:
            c.shutdown()
    assert out[0] == out[1]
    for k in range(3):
        assert len({out[1][f"co-p{i}"] for i in range(k, 12, 3)}) == 1


def _zero_slots(pkg):
    O = pkg[0]
    c = _start(pkg, ["NodeVolumeLimits"])
    try:
        c.create_node("zero-node", attachable_volumes=0)
        c.create_pod("za-p1", spec=_vspec(O, "c-z"))
        pending = c.wait_for_pod_pending("za-p1", timeout=30)
        assert "NodeVolumeLimits" in pending.status.unschedulable_plugins
        c.create_pod("za-free")
        c.wait_for_pod_bound("za-free", timeout=10)
        return _final(c)
    finally:
        c.shutdown()


def test_explicit_zero_attachable_volumes_honored():
    _both(_zero_slots)


def _no_double_charge(pkg):
    O = pkg[0]
    c = _start(pkg, ["VolumeRestrictions", "NodeVolumeLimits"])
    try:
        c.create_node("dc-node", attachable_volumes=1)
        c.create_pod("dc-p1", spec=_vspec(O, "claim-dc"))
        c.wait_for_pod_bound("dc-p1", timeout=30)
        c.create_pod("dc-p2", spec=_vspec(O, "claim-dc"))
        assert c.wait_for_pod_bound("dc-p2", timeout=10).spec.node_name == (
            "dc-node")
        c.create_pod("dc-p3", spec=_vspec(O, "claim-other"))
        pending = c.wait_for_pod_pending("dc-p3", timeout=30)
        assert "NodeVolumeLimits" in pending.status.unschedulable_plugins
        return _final(c)
    finally:
        c.shutdown()


def test_shared_claim_does_not_double_charge_attach_slot():
    _both(_no_double_charge)


def _multi_zone(pkg):
    O = pkg[0]
    c = _start(pkg, ["VolumeZone"])
    try:
        c.create_node("mz-node", labels={ZONE: "za"})
        c.create_pv("pv-za", zone="za", phase="Bound",
                    claim_ref="default/claim-za")
        c.create_pvc("claim-za", volume_name="pv-za")
        c.create_pv("pv-zb", zone="zb", phase="Bound",
                    claim_ref="default/claim-zb")
        c.create_pvc("claim-zb", volume_name="pv-zb")
        c.create_pod("mz-p", spec=_vspec(O, "claim-za", "claim-zb"))
        pending = c.wait_for_pod_pending("mz-p", timeout=30)
        assert "VolumeZone" in pending.status.unschedulable_plugins
        return _final(c)
    finally:
        c.shutdown()


def test_multi_zone_pvs_make_pod_unschedulable():
    _both(_multi_zone)


def _gang_rwo(pkg):
    O = pkg[0]
    c = _start(pkg, ["NodeName", "VolumeRestrictions"])
    try:
        c.create_node("rg-n1")
        c.create_node("rg-n2")
        c.create_pvc("claim-rg", phase="Bound")
        c.create_pod("rg-x", spec=O.PodSpec(
            requests={"cpu": 100}, priority=10, required_node_name="rg-n1",
            volumes=[O.VolumeClaim(claim_name="claim-rg")]))
        c.create_pod("rg-g1", spec=O.PodSpec(
            requests={"cpu": 100}, required_node_name="rg-n2",
            volumes=[O.VolumeClaim(claim_name="claim-rg")],
            pod_group="rgang", pod_group_min=2))
        c.create_pod("rg-g2", spec=O.PodSpec(
            requests={"cpu": 100}, required_node_name="rg-n2",
            pod_group="rgang", pod_group_min=2))
        c.wait_for_pod_bound("rg-x", timeout=30)
        time.sleep(0.5)
        assert not c.get_pod("rg-g1").spec.node_name
        assert not c.get_pod("rg-g2").spec.node_name
        return _final(c)
    finally:
        c.shutdown()


def test_rwo_revocation_takes_whole_gang():
    _both(_gang_rwo)


def _registry_full(pkg):
    O = pkg[0]
    c = _start(pkg, ["VolumeZone"])
    try:
        sched = c.service.scheduler
        for k in ("k1", "k2", "k3"):  # fill slots 1-3 (slot 0 = hostname)
            assert sched.cache.registry.index_of(k) > 0
        c.create_node("rf-node", labels={ZONE: "zf"})
        c.create_pv("pv-rf", zone="zf", phase="Bound",
                    claim_ref="default/claim-rf")
        c.create_pvc("claim-rf", volume_name="pv-rf")
        c.create_pod("rf-p", spec=_vspec(O, "claim-rf"))
        pending = c.wait_for_pod_pending("rf-p", timeout=30)
        assert "VolumeZone" in pending.status.unschedulable_plugins
        return _final(c)
    finally:
        c.shutdown()


def test_zone_requirement_fails_closed_when_registry_full():
    _both(_registry_full)


def _batch_capacity(pkg):
    O = pkg[0]
    c = _start(pkg, ["NodeVolumeLimits"])
    try:
        c.create_node("batch-node", attachable_volumes=2)
        for i in range(3):
            c.create_pod(f"bv-p{i}", spec=_vspec(O, f"bc{i}"))

        def settled():
            pods = [c.get_pod(f"bv-p{i}") for i in range(3)]
            bound = [p for p in pods if p.spec.node_name]
            parked = [p for p in pods if not p.spec.node_name
                      and p.status.unschedulable_plugins]
            return len(bound) == 2 and len(parked) == 1
        assert wait_until(settled, 30)
    finally:
        c.shutdown()


@PACKAGES
def test_volume_capacity_respected_within_one_batch(pkg):
    _batch_capacity(pkg)


def _cinder_blocks(pkg):
    O = pkg[0]
    c = _start(pkg, ["CinderLimits"])
    try:
        c.create_node("cin-node1")
        n = c.get_node("cin-node1")
        n.status.allocatable["attachable-volumes-cinder"] = 1.0
        c.store.update(n)
        c.create_pvc("cin-a", phase="Bound")
        c.create_pvc("cin-b", phase="Bound")
        c.create_pod("cin-p1", spec=_vspec(O, "cin-a", typ="cinder"))
        c.wait_for_pod_bound("cin-p1", timeout=30)
        c.create_pod("cin-p2", spec=_vspec(O, "cin-b", typ="cinder"))
        pending = c.wait_for_pod_pending("cin-p2", timeout=30)
        assert "CinderLimits" in pending.status.unschedulable_plugins
        c.delete_pod("cin-p1")
        c.wait_for_pod_bound("cin-p2", timeout=10)
        return _final(c)
    finally:
        c.shutdown()


def test_cinder_limits_filter_blocks_over_limit_node():
    _both(_cinder_blocks)


def _cinder_default(pkg):
    O = pkg[0]
    c = _start(pkg, ["CinderLimits"])
    try:
        c.create_node("cin-free")
        c.create_pvc("cin-z", phase="Bound")
        c.create_pod("plain", spec=O.PodSpec(requests={"cpu": 50}))
        c.create_pod("cin-typed", spec=_vspec(O, "cin-z", typ="cinder"))
        c.wait_for_pod_bound("plain", timeout=30)
        c.wait_for_pod_bound("cin-typed", timeout=30)
        return _final(c)
    finally:
        c.shutdown()


def test_cinder_default_ceiling_admits_plain_pods():
    _both(_cinder_default)


# ---- full_scheduler_profile() ------------------------------------------

def test_full_profile_builds_like_jax():
    """The port's full_scheduler_profile() has the JAX package's default
    filter and score lists, weights and PostFilter."""
    from minisched_tpu.service import defaultconfig as jdc
    from minisched_tpu_torch.service import defaultconfig as tdc

    assert tdc.DEFAULT_FILTER_PLUGINS == jdc.DEFAULT_FILTER_PLUGINS
    assert tdc.DEFAULT_SCORE_PLUGINS == jdc.DEFAULT_SCORE_PLUGINS
    jprof, tprof = jdc.full_scheduler_profile(), tdc.full_scheduler_profile()
    assert (tprof.name, tprof.plugins, tprof.weights) == (
        jprof.name, jprof.plugins, jprof.weights)
    jps, tps = jprof.build(), tprof.build()
    for attr in ("filter_plugins", "score_plugins", "permit_plugins",
                 "postfilter_plugins"):
        assert ([p.name for p in getattr(tps, attr)]
                == [p.name for p in getattr(jps, attr)]), attr
    assert ([tps.weight_of(p) for p in tps.score_plugins]
            == [jps.weight_of(p) for p in jps.score_plugins])


@pytest.mark.parametrize("pipeline,resident,shortlist", [
    (False, False, False), (True, True, True), (False, False, True),
    (True, False, True), (False, True, True), (True, True, False)])
def test_full_profile_engine_matches_jax(pipeline, resident, shortlist):
    """A full-profile burst (pinned, unused, shared, zone-bound and
    cloud-typed claims, host ports, taints) at 120 nodes x 240 pods in
    batches of 64, in the six engine modes: placements and the shared
    counters equal the JAX engine's."""
    from minisched_tpu.service.defaultconfig import (
        full_scheduler_profile as jfull)
    from minisched_tpu_torch.service.defaultconfig import (
        full_scheduler_profile)
    from test_torch_engine import SHARED_METRICS, _run_cluster
    from torch_parity import volume_cluster

    kw = dict(max_batch_size=64, seed=4, pipeline=pipeline,
              device_resident=resident, shortlist=shortlist, shortlist_k=8)
    want, jm = _run_cluster(JCluster, JO, jfull(), JConfig(**kw), 0, 0, 0,
                            recipe=volume_cluster)
    got, m = _run_cluster(Cluster, TO, full_scheduler_profile(),
                          SchedulerConfig(platform="cpu", **kw), 0, 0, 0,
                          recipe=volume_cluster)
    assert got == want
    for k in SHARED_METRICS:
        assert m[k] == jm[k], (k, m[k], jm[k])
    assert m["pods_bound"] == len([k for k in got if "/vp" in k])


@pytest.mark.parametrize("pipeline,resident,shortlist", [
    (False, False, False), (True, True, True)])
def test_claim_pinned_outside_the_sample_matches_jax(pipeline, resident,
                                                     shortlist, monkeypatch):
    """1,200 nodes under the default sampling with VolumeRestrictions in
    the profile: a pod shares the claim of the pod bound on big-node,
    which ranks far below every sample. Its claim row maps to K in the
    sampled step, it reads 0-feasible, and the full-axis residual pass
    places it on big-node, as the JAX engine does."""
    from test_torch_engine import SHARED_METRICS, _run_cluster
    from torch_parity import BENCH_PLUGINS, sampled_cluster

    def recipe(O):
        first, pods = sampled_cluster(O)
        for p in first:
            if getattr(p.metadata, "name", "") == "resident":
                p.spec.volumes = [O.VolumeClaim(claim_name="pin-x")]
        first.append(O.PersistentVolumeClaim(
            metadata=O.ObjectMeta(name="pin-x", namespace="bench"),
            phase="Bound"))
        mate = O.Pod(metadata=O.ObjectMeta(name="claim-mate",
                                           namespace="bench"),
                     spec=O.PodSpec(requests={"cpu": 250.0},
                                    volumes=[O.VolumeClaim(
                                        claim_name="pin-x")]))
        return first, [mate] + pods

    residuals = []
    orig = Scheduler._run_residual

    def counted(self, b, rows, *a):
        residuals.extend(b.batch[i].pod.metadata.name for i in rows)
        return orig(self, b, rows, *a)

    monkeypatch.setattr(Scheduler, "_run_residual", counted)
    plugins = BENCH_PLUGINS + ["VolumeRestrictions"]
    kw = dict(max_batch_size=64, pipeline=pipeline,
              device_resident=resident, shortlist=shortlist)
    want, jm = _run_cluster(
        JCluster, JO, JProfile(name="v", plugins=plugins,
                               plugin_args={"NodeResourcesFit":
                                            {"score_strategy": None}}),
        JConfig(**kw), 0, 0, 0, recipe=recipe)
    got, m = _run_cluster(
        Cluster, TO, Profile(name="v", plugins=plugins,
                             plugin_args={"NodeResourcesFit":
                                          {"score_strategy": None}}),
        SchedulerConfig(platform="cpu", **kw), 0, 0, 0, recipe=recipe)
    assert got == want
    for k in SHARED_METRICS:
        assert m[k] == jm[k], (k, m[k], jm[k])
    assert got["bench/claim-mate"] == "big-node"
    assert "claim-mate" in residuals
    assert m["sampled_batches"] == m["batches"]

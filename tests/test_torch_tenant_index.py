"""Indexed fused-tenant arbitration on the port (ops/pipeline.
build_tenant_index_step, the mux's indexed groups, the engine's
_tenant_index_stage) against the JAX package.

Op level: the port's build_tenant_index_step against the JAX one on the
same stacked slabs, class rows, valid rows, requests, free rows and
keys, every lane's packed row and free after bitwise (tolerance none),
and each lane's row equal to the solo ``ops/index`` assign's buffer.
Coordinator level, the cases of tests/test_tenant_index.py and the
``tenant_index`` case of tests/test_faults.py, every round
single-stepped on quiet caches (tests/torch_tenant_parity.py): the
port's placements equal the JAX coordinator's, fused and sequential, and
the port's fused-full run, in the sync, pipelined, upload and
device-loop modes; the deterministic counters are equal across
packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minisched_tpu import faults as jfaults
from minisched_tpu.engine.queue import bucket_major_quotas as jquotas
from minisched_tpu.ops.pipeline import \
    build_tenant_index_step as jbuild_tenant_index
from minisched_tpu_torch import faults as tfaults
from minisched_tpu_torch.encode.cache import step_bucket
from minisched_tpu_torch.engine.queue import bucket_major_quotas
from minisched_tpu_torch.obs import journal as tjournal
from minisched_tpu_torch.ops import index as tindex
from minisched_tpu_torch.ops import prng
from minisched_tpu_torch.ops.pipeline import build_tenant_index_step
from minisched_tpu_torch.ops.select import NEG
from torch_obs_parity import disarm_all
import torch_tenant_parity as TP

NAMES3 = ["t0", "t1", "t2"]


@pytest.fixture(autouse=True)
def _disarmed():
    disarm_all()
    yield
    disarm_all()


def _cfg(**kw):
    kw.setdefault("index", True)
    kw.setdefault("index_k", 8)
    kw.setdefault("index_classes", 32)
    return kw


def _class_pods(O, n, tag):
    """Pods cycling eight request shapes (unique priorities), so the
    index registry warms on the first wave."""
    return TP.pods(O, n, tag, classes=8)


def _run(pkg, fuse, waves, **kw):
    return TP.run(pkg, fuse, waves, pod_fn=_class_pods, **_cfg(**kw))


# ---- op level ---------------------------------------------------------------


@pytest.mark.parametrize("k_eff", [8, 2])
def test_tenant_index_step_matches_jax(k_eff):
    """Each lane's packed row and free after equal the JAX fused indexed
    step's bitwise, on lanes with their own slabs, class rows, ragged
    valid rows, requests, free rows and keys; K = 2 on tight free rows
    forces in-scan repairs. Each row also equals the solo assign's."""
    rng = np.random.default_rng(11)
    T, C, P, N, R = 3, 6, 10, 24, 2
    slabs = rng.integers(0, 5, (T, C, N)).astype(np.float32)
    slabs[rng.random((T, C, N)) < 0.2] = NEG
    cls = rng.integers(0, C, (T, P)).astype(np.int32)
    valid = np.zeros((T, P), dtype=bool)
    for t, live in enumerate((10, 7, 4)):
        valid[t, :live] = True
    req = rng.integers(1, 3, (T, P, R)).astype(np.float32)
    free = rng.integers(1, 4, (T, N, R)).astype(np.float32)
    counters = [3, 4, 90]
    jkeys = jnp.stack([jax.random.fold_in(jax.random.PRNGKey(2), c)
                       for c in counters])
    want_packed, want_free = jbuild_tenant_index(k_eff)(
        slabs, cls, valid, req, free, jkeys)
    want_packed, want_free = np.asarray(want_packed), np.asarray(want_free)

    keys = [prng.fold_in(prng.PRNGKey(2), c) for c in counters]
    tt = torch.from_numpy
    step = build_tenant_index_step(k_eff)
    packed, free_after = step([tt(s) for s in slabs], [tt(c) for c in cls],
                              [tt(v) for v in valid], [tt(r) for r in req],
                              [tt(f) for f in free], keys)
    assert tuple(packed.shape) == want_packed.shape
    for t in range(T):
        np.testing.assert_array_equal(packed[t].numpy(), want_packed[t])
        np.testing.assert_array_equal(free_after[t].numpy().view(np.int32),
                                      want_free[t].view(np.int32))
    if k_eff == 2:
        assert any(tindex.unpack_index_decision(
            np.array(packed.numpy()[t]), P)[2].any() for t in range(T))
    # Each row is the solo assign's buffer.
    from minisched_tpu_torch.plugins.base import PluginSet

    _b, _r, _a, assign = tindex.build_index_ops(PluginSet([]), k_eff)
    for t in range(T):
        st = tindex.IndexState(raw=None, feasible=None, score=tt(slabs[t]))
        p1, f1 = assign(st, tt(cls[t]), tt(valid[t]), tt(req[t]),
                        tt(free[t]), keys[t])
        assert torch.equal(p1, packed[t]) and torch.equal(f1, free_after[t])
    assert build_tenant_index_step(k_eff) is step


def test_bucket_major_quotas_match_jax():
    """The port's queue apportions a round's slots by bucket group as the
    JAX queue does."""
    for demands, weights, cap, buckets in [
            ([5, 0, 40, 8, 30], [1.0, 1.0, 2.0, 1.0, 1.0], 24,
             [16, 0, 48, 16, 48]),
            ([10, 10, 10], [1.0, 1.0, 1.0], 12, [16, 16, 16]),
            ([3, 3, 20, 20], [1.0] * 4, 48, [16, 16, 24, 24])]:
        assert (bucket_major_quotas(demands, weights, cap, buckets)
                == jquotas(demands, weights, cap, buckets))


# ---- coordinator level: bit identity -----------------------------------


@pytest.mark.parametrize("mode,kw", [
    ("sync", dict(pipeline=False)),
    ("pipelined", dict(pipeline=True)),
    ("upload", dict(device_resident=False)),
    ("device-loop", dict(device_loop=True, loop_depth=4)),
])
def test_fused_indexed_matches_sequential_full_and_jax(mode, kw):
    """With the index armed, the port's fused placements equal its
    sequential indexed run's, its fused-full run's and the JAX
    coordinator's; the first wave's lanes eject (cold) and rebuild solo,
    the second serves fused-indexed on every lane; the counters equal
    the JAX package's."""
    waves = [(8, 8, 8), (8, 8, 8)]
    seq, _ = _run(TP.PORT, 0, waves, **kw)
    full, _ = _run(TP.PORT, 8, waves, **dict(kw, index=False))
    fused, pm = _run(TP.PORT, 8, waves, **kw)
    jfused, jm = _run(TP.JAX, 8, waves, **kw)
    assert fused == seq == full == jfused, mode
    TP.same_counters(jm, pm, NAMES3)
    assert pm["tenant_index_dispatches"] == 1 and pm["tenant_index_lanes"] == 3
    for nm in NAMES3:
        assert pm[f"{nm}_index_lane_ejects"] == 1, pm
        assert pm[f"{nm}_index_fused_hits"] == 1, pm


def test_fused_indexed_scored_rows_match_sequential_indexed():
    """A fused indexed serve evaluates no plugin row; repairs and
    rebuilds book as in the sequential indexed engine, so
    scored_rows_total agrees per tenant across fuse on and off."""
    waves = [(8, 8, 8)] * 3
    _s, ms = _run(TP.PORT, 0, waves)
    _f, mf = _run(TP.PORT, 8, waves)
    for nm in NAMES3:
        assert (mf[f"{nm}_scored_rows_total"]
                == ms[f"{nm}_scored_rows_total"]), nm
    assert mf["steps_dispatched_total"] < ms["steps_dispatched_total"]


def test_mid_round_race_on_indexed_lane_falls_back_solo_as_in_jax():
    """A cache mutation between an indexed lane's submit and the fused
    dispatch sends that lane's full step solo, counted; the placements
    equal the sequential indexed run's and JAX's."""
    waves = [(6, 6, 6), (6, 6, 6)]
    seq, _ = _run(TP.PORT, 0, waves)
    out = {}
    for pkg in (TP.JAX, TP.PORT):
        fired = []

        def hook(coord, fired=fired):
            def pre():
                if not fired:
                    fired.append(1)
                    coord.engine("t0").cache.version += 1
            coord.mux._pre_dispatch_hook = pre

        out[pkg.name] = _run(pkg, 8, waves, hook=hook)
        assert fired
    (jp, jm), (pp, pm) = out["jax"], out["port"]
    assert pp == seq == jp
    assert pm["tenant_races"] == pm["tenant_solo_fallbacks"] == 1, pm
    assert pm["tenant_index_lanes"] == 2
    TP.same_counters(jm, pm, NAMES3)


def test_widening_invalidation_ejects_only_that_lane():
    """A node's allocatable grown on t1 alone (a widening mutation no
    slab patch expresses) ejects t1's lane, which rebuilds through its
    solo indexed dispatch; the other lanes stay fused-indexed; placements
    equal the sequential run's and JAX's."""
    def between(coord, _w):
        store = coord.store("t1")
        node = store.get("Node", TP.node_name(3))
        node.status.allocatable["cpu"] += 8000.0
        store.update(node)

    waves = [(8, 8, 8), (8, 8, 8)]
    seq, _ = _run(TP.PORT, 0, waves, between=between)
    fused, pm = _run(TP.PORT, 8, waves, between=between)
    jfused, jm = _run(TP.JAX, 8, waves, between=between)
    assert fused == seq == jfused
    assert pm["t1_index_lane_ejects"] == pm["t0_index_lane_ejects"] + 1, pm
    assert pm["t1_index_rebuilds"] == pm["t0_index_rebuilds"] + 1, pm
    assert pm["tenant_index_lanes"] == 2, pm
    TP.same_counters(jm, pm, NAMES3)


def _flat_pods(O, n, tag, *, cpu0=100):
    """Pods whose class rows all land in ONE warm 8-row set: constant
    priority and a non-digit name tail (no name suffix), so only the 8
    cycled request shapes tell them apart and the registry never crosses
    its class-pad bucket."""
    return [O.Pod(
        metadata=O.ObjectMeta(name=f"{tag}-{i}x", namespace="default"),
        spec=O.PodSpec(requests={"cpu": float(cpu0 + 17 * (i % 8))},
                       priority=0))
        for i in range(n)]


def test_mixed_bucket_round_fuses_two_groups():
    """Two small tenants and two large ones: after a warm-up wave, one
    round fuses one indexed group per pod bucket (>= 2 groups, no solo
    fallback), and placements equal the sequential run's and JAX's."""
    names = [f"t{i}" for i in range(4)]
    waves = [(8, 8, 8, 8), (3, 3, 20, 20)]
    assert step_bucket(3, 16) != step_bucket(20, 16)
    kw = dict(names=names, max_batch_size=48)
    seq, _ = TP.run(TP.PORT, 0, waves, pod_fn=_flat_pods, **_cfg(**kw))
    fused, pm = TP.run(TP.PORT, 8, waves, pod_fn=_flat_pods, **_cfg(**kw))
    jfused, jm = TP.run(TP.JAX, 8, waves, pod_fn=_flat_pods, **_cfg(**kw))
    assert fused == seq == jfused
    assert pm["tenant_groups_round_max"] >= 2, pm
    assert pm["tenant_solo_fallbacks"] == 0
    assert pm["tenant_index_lanes"] >= 4
    TP.same_counters(jm, pm, names)


def test_fused_indexed_provenance_and_journal_stay_per_tenant():
    """Warm batches serve fused-indexed: provenance records carry
    ``fused-hit`` under the owning tenant only, and the index.fused_serve
    / index.lane_eject / index.slab_repair notes carry the owning
    tenant's profile."""
    names = ["t0", "t1"]
    seen = {}

    def hook(coord):
        tjournal.configure("1")
        seen["coord"] = coord

    try:
        _p, m = _run(TP.PORT, 8, [(5, 5), (5, 5)], names=names, hook=hook)
        coord = seen["coord"]
        assert m["tenant_index_dispatches"] >= 1
        for nm, other in (("t0", "t1"), ("t1", "t0")):
            assert m[f"{nm}_index_fused_hits"] >= 1, m
            for i in range(5):
                key = f"default/{nm}-w1-p{i}"
                rec = coord.engine(nm).provenance(key)
                assert rec is not None and rec["profile"] == nm, rec
                assert rec["index"] == "fused-hit", rec
                assert coord.engine(other).provenance(key) is None
        entries = tjournal.JOURNAL.entries()
        for kind in ("index.fused_serve", "index.lane_eject"):
            profs = {e.get("profile") for e in entries if e["kind"] == kind}
            assert profs == set(names), (kind, profs)
        profs = {e.get("profile") for e in entries
                 if e["kind"] == "index.slab_repair"}
        assert profs <= set(names)
    finally:
        tjournal.configure("")


def test_tenant_index_corrupt_caught_on_its_lane_alone():
    """``tenant_index:corrupt`` scribbles a copy of one lane's slab
    before the fused gather: that lane's cross-check
    (index_check_every=1) catches it, its engine desyncs once and runs
    its supervised retry, its index alone is parked, the other lanes
    settle undisturbed, and every pod lands where the fault-free run put
    it, as in the JAX package."""
    names = ["ta", "tb", "tc"]
    waves = [(6, 6, 6)] * 3
    kw = dict(names=names, pipeline=False, probation_batches=1,
              backoff_max_s=0.3, index_check_every=1)

    def run(pkg, spec):
        def hook(_coord):
            pkg_faults = jfaults if pkg is TP.JAX else tfaults
            pkg_faults.configure(spec, seed=0)

        try:
            return _run(pkg, 8, waves, hook=hook if spec else None, **kw)
        finally:
            jfaults.configure("")
            tfaults.configure("")

    ref, ref_m = run(TP.PORT, "")
    assert ref_m["tenant_index_dispatches"] >= 2
    assert sum(ref_m[f"{nm}_index_desyncs"] for nm in names) == 0
    placed, m = run(TP.PORT, "tenant_index:corrupt@2")
    jplaced, jm = run(TP.JAX, "tenant_index:corrupt@2")
    assert placed == ref == jplaced
    assert m["ta_fault_fires_tenant_index"] == 1
    desyncs = {nm: m[f"{nm}_index_desyncs"] for nm in names}
    assert sum(desyncs.values()) == 1, desyncs
    hit = max(desyncs, key=desyncs.get)
    assert m[f"{hit}_index_width"] == 0
    assert m[f"{hit}_batch_faults"] >= 1
    for nm in names:
        if nm != hit:
            assert m[f"{nm}_index_width"] > 0
            assert m[f"{nm}_batch_faults"] == 0
    TP.same_counters(jm, m, names)

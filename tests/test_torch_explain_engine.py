"""The port's engine in explain mode against the JAX engine's.

One store content, seed and ``SchedulerConfig(explain=True)`` give the
same placements, byte-identical annotation strings on every pod and the
same ``filter_verdict`` answers for nodes outside each pod's top-k
annotation, at 120 nodes and at 1,200 (where the default config would
sample nodes; explain mode must not). Config 4 hard in explain mode
runs without the in-scan caps on both engines and keeps every zone
within its skew. A pinned brownout (overload rung 3) pauses explain
ingestion on both engines alike. With a recorder, ``metrics()`` reports
the JAX engine's ``resultstore_*`` keys with the same values.
"""
import json

import pytest

from minisched_tpu_torch.explain import (FILTER_RESULT_KEY,
                                         FINAL_SCORE_RESULT_KEY,
                                         SCORE_RESULT_KEY)
from minisched_tpu_torch.ops import spreadcap
from test_torch_spread_engine import C4, _c4
from torch_obs_parity import (JAX, LATER_SLICE_KEYS, PORT, bench_burst,
                              disarm_all, pin_rung, placements, wait_until)
from torch_parity import jax_rules, sampled_cluster

KEYS = (FILTER_RESULT_KEY, SCORE_RESULT_KEY, FINAL_SCORE_RESULT_KEY)


@pytest.fixture(autouse=True)
def disarm():
    disarm_all()
    yield
    disarm_all()


def _explain_view(out):
    """A white_box for bench_burst: drains the result store, then records
    every pod's three annotation strings and, for each pod with an
    annotation, filter_verdict on its chosen node and on the first
    three nodes (by name) outside its annotation."""
    def white_box(sched):
        rs = sched.recorder
        assert rs is not None and rs.drain(timeout=60)
        nodes = sorted(n.metadata.name for n in sched.store.list("Node"))
        ann, verdicts = {}, {}
        for pod in sched.store.list("Pod"):
            a = pod.metadata.annotations
            ann[pod.key] = tuple(a.get(k) for k in KEYS)
            if a.get(FILTER_RESULT_KEY) is None:
                continue
            listed = json.loads(a[FILTER_RESULT_KEY])
            outside = [n for n in nodes if n not in listed][:3]
            verdicts[pod.key] = {n: rs.filter_verdict(pod.key, n)
                                 for n in outside + [pod.spec.node_name]}
        out.update(ann=ann, verdicts=verdicts, stats=rs.stats(),
                   nodes=len(nodes))
    return white_box


def _both(kw, recipe=None, n_nodes=120, n_pods=300, profile=None):
    views = {}
    results = {}
    for pkg in (PORT, JAX):
        views[pkg.name] = {}
        more = {} if recipe is None else {"recipe": recipe}
        if profile is not None:
            more["profile"] = profile
        results[pkg.name] = _burst(pkg, kw, views[pkg.name], n_nodes,
                                   n_pods, **more)
    (got, m), (want, jm) = results["port"], results["jax"]
    assert got == want
    assert views["port"]["ann"] == views["jax"]["ann"]
    assert views["port"]["verdicts"] == views["jax"]["verdicts"]
    return got, m, jm, views["port"]


def _burst(pkg, kw, view, n_nodes, n_pods, recipe=None, profile=None):
    if profile is None:
        return bench_burst(pkg, dict(kw, explain=True), n_nodes=n_nodes,
                           n_pods=n_pods, recipe=recipe,
                           white_box=_explain_view(view))
    # config 4: bench_burst's flow with the config-4 profile
    c = pkg.Cluster()
    nodes, pods = recipe(pkg.O)
    c.create_objects(nodes)
    c.create_objects(pods)
    prof = pkg.Profile(name="c4", plugins=profile)
    if pkg is PORT:
        prof = jax_rules(prof)
    c.start(prof,
            pkg.config(**dict(kw, explain=True)))
    try:
        sched = c.service.scheduler
        assert wait_until(lambda: all(p.spec.node_name
                                      for p in c.list_pods()), timeout=90)
        assert wait_until(lambda: sched.metrics()["pods_assigned"]
                          >= len(pods), timeout=90)
        _explain_view(view)(sched)
        return placements(c), sched.metrics()
    finally:
        c.shutdown()


@pytest.mark.parametrize("pipeline", [True, False])
@pytest.mark.parametrize("size", ["120", "1200"])
def test_explain_engine_matches_jax(size, pipeline):
    kw = dict(max_batch_size=64, seed=1, pipeline=pipeline)
    recipe = sampled_cluster if size == "1200" else None
    got, m, jm, view = _both(kw, recipe=recipe)
    assert m["sampled_batches"] == 0
    assert m["batches"] == jm["batches"]
    annotated = [k for k, a in view["ann"].items() if a[0] is not None]
    # every pod the engine scheduled carries all three annotations (the
    # 1,200-node cluster's resident pod was bound before the engine)
    assert len(annotated) == len(got) - (size == "1200")
    assert all(None not in view["ann"][k] for k in annotated)
    top_k = min(128, view["nodes"])
    for k in annotated:
        assert len(json.loads(view["ann"][k][0])) == top_k
        # the chosen node passed every filter
        chosen = view["verdicts"][k][got[k]]
        assert chosen and set(chosen.values()) == {"passed"}
    if size == "1200":
        assert all(len(v) == 4 for v in view["verdicts"].values())
    # the result store's retention counters, as the JAX engine reports
    # them; every other key but the later slices' is reported too
    rs_keys = {k for k in jm if k.startswith("resultstore_")}
    assert rs_keys == {f"resultstore_{k}" for k in
                       ("results", "filter_bits", "queued", "evictions")}
    assert {k: m[k] for k in rs_keys} == {k: jm[k] for k in rs_keys}
    assert set(jm) - set(m) <= LATER_SLICE_KEYS


def test_explain_c4_hard_matches_jax(monkeypatch):
    """Config 4 hard (DoNotSchedule max_skew 1) in explain mode: the
    caps never run on the port (the host arbitration and its repair keep
    the skew), placements and annotations equal the JAX engine's, and
    no zone is over its skew. The repair runs up to 64 rounds a batch so
    that every batch places all its pods in the cycle: a pod that fails
    a cycle comes back when its backoff expires, and the next batch's
    contents then follow the wall clock, in either engine."""
    def no_caps(*_a, **_k):
        raise AssertionError("the in-scan caps ran in explain mode")

    monkeypatch.setattr(spreadcap, "build_domain_caps", no_caps)
    got, m, jm, _view = _both(dict(max_batch_size=64, seed=2,
                                   spread_repair_iters=64),
                              recipe=lambda O: _c4(O, 120, 300, True),
                              profile=C4)
    assert m["batch_faults"] == 0 and m["pods_failed"] == 0
    assert m["spread_repaired"] > 0
    assert m["hard_spread_batches"] == m["batches"] == jm["batches"]
    zone_of = {f"node-{i}-{i % 10}": f"z{i % 16}" for i in range(120)}
    counts = {z: 0 for z in set(zone_of.values())}
    for node in got.values():
        counts[zone_of[node]] += 1
    assert sum(counts.values()) == 300
    assert max(counts.values()) - min(counts.values()) <= 1


def test_pinned_brownout_pauses_explain_as_jax():
    """Rung 3 pinned with explain on: every batch's ingestion is skipped
    and counted on both engines, and no pod carries an annotation."""
    spec = "hold=1000000,probation=1000000,min_batch=16,brownout_pct=20"
    views = {}
    res = {}
    for pkg in (PORT, JAX):
        pkg.slo.configure("create_bound_p99=1000,queue_wait_p95=1000")
        pkg.overload.configure(spec)
        views[pkg.name] = {}
        res[pkg.name] = bench_burst(
            pkg, dict(max_batch_size=64, seed=1, explain=True),
            pin=pin_rung(pkg, 3, sl_exp=0, shortlist_k=128),
            white_box=_explain_view(views[pkg.name]))
    (got, m), (want, jm) = res["port"], res["jax"]
    assert got == want
    assert m["overload_level"] == jm["overload_level"] == 3
    assert (m["overload_explain_skipped"] == jm["overload_explain_skipped"]
            == m["batches"] > 0)
    for v in views.values():
        assert all(a == (None, None, None) for a in v["ann"].values())
        assert v["stats"]["results"] == v["stats"]["filter_bits"] == 0

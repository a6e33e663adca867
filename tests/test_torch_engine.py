"""The port's engine against the JAX engine: one store content, one seed
and one SchedulerConfig give the same pod→node placements and the same
counters over several batches, in every mode of (pipeline,
device_resident, shortlist); device residency uploads only deltas in
steady state and corrects failed binds, node deletes and pad changes
without losing a pod. The README scenario passes on the port."""
import threading

import numpy as np
import pytest
import torch

from minisched_tpu.config import SchedulerConfig as JConfig
from minisched_tpu.engine.scheduler import Scheduler as JScheduler
from minisched_tpu.scenario.runner import Cluster as JCluster
from minisched_tpu.service.defaultconfig import Profile as JProfile
from minisched_tpu.state import objects as JO
from minisched_tpu.state.store import ClusterStore as JStore
from minisched_tpu_torch.config import SchedulerConfig
from minisched_tpu_torch.engine.scheduler import Scheduler
from minisched_tpu_torch.ops import _cuda_build
from minisched_tpu_torch.scenario.runner import (Cluster, default_scenario,
                                                 run_scenario, wait_until)
from minisched_tpu_torch.service.defaultconfig import Profile
from minisched_tpu_torch.state import objects as TO
from minisched_tpu_torch.state.store import ClusterStore
from torch_parity import (BENCH_PROFILE, PORTS_PROFILE, bench_cluster,
                          mixed_cluster, port_heavy_cluster, sampled_cluster)


def _jax_config(**kw):
    return JConfig(pipeline=False, device_resident=False, shortlist=False,
                   **kw)


# (pipeline, device_resident, shortlist): all off, all on (the default),
# and the mixed modes of tests/test_shortlist.py and
# tests/test_device_residency.py.
MODES = [(False, False, False), (True, True, True), (False, False, True),
         (True, False, True), (False, True, True), (True, True, False)]
# Metrics both engines define alike.
SHARED_METRICS = ("pods_seen", "pods_assigned", "pods_failed", "pods_bound",
                  "batches", "shortlist_repairs", "residency_hits",
                  "residency_resyncs", "fetch_bytes_total")


def _placements(cluster):
    return {p.key: p.spec.node_name for p in cluster.list_pods()}


def _run_cluster(cluster_cls, O, profile, config, n_nodes, n_pods, seed,
                 recipe=None, white_box=None):
    nodes, pods = (bench_cluster(O, n_nodes, n_pods, seed) if recipe is None
                   else recipe(O))
    c = cluster_cls()
    c.create_objects(nodes)
    c.create_objects(pods)  # everything in the store before start
    c.start(profile, config)
    try:
        assert wait_until(
            lambda: all(p.spec.node_name for p in c.list_pods()),
            timeout=60)
        # The binder may bind a batch's pods before the scheduling thread
        # folds that batch into the metrics: wait until every pod's
        # assignment is counted before reading them.
        sched = c.service.scheduler
        assert wait_until(
            lambda: sched.metrics()["pods_assigned"] >= len(pods),
            timeout=60)
        if white_box is not None:
            white_box(sched)
        return _placements(c), sched.metrics()
    finally:
        c.shutdown()


@pytest.mark.parametrize("seed", [0, 3])
def test_engine_placements_match_jax(seed):
    """~300 pods in batches of 64 through Cluster().start() on both
    packages."""
    want, jm = _run_cluster(JCluster, JO, JProfile(**BENCH_PROFILE),
                            _jax_config(max_batch_size=64, seed=seed),
                            120, 300, seed)
    got, m = _run_cluster(Cluster, TO, Profile(**BENCH_PROFILE),
                          SchedulerConfig(platform="cpu", max_batch_size=64,
                                          seed=seed),
                          120, 300, seed)
    assert got == want
    assert m["batches"] == jm["batches"] >= 5
    assert m["pods_bound"] == 300
    assert m["kernel_launches"] == 0  # CPU tensors take the plain version


@pytest.mark.parametrize("pipeline,resident,shortlist", MODES)
def test_engine_modes_match_jax(pipeline, resident, shortlist):
    """300 pods in batches of 64 under the same config on both packages:
    placements and every shared counter equal. K=2 makes some of the
    shortlist's steps repair and certifies the rest."""
    kw = dict(max_batch_size=64, seed=1, pipeline=pipeline,
              device_resident=resident, shortlist=shortlist, shortlist_k=2)
    want, jm = _run_cluster(JCluster, JO, JProfile(**BENCH_PROFILE),
                            JConfig(**kw), 120, 300, 1)
    got, m = _run_cluster(Cluster, TO, Profile(**BENCH_PROFILE),
                          SchedulerConfig(platform="cpu", **kw), 120, 300, 1)
    assert got == want
    for k in SHARED_METRICS:
        assert m[k] == jm[k], k
    assert m["shortlist_width"] == jm["shortlist_width"] == (
        2 if shortlist else 0)
    if shortlist:
        assert 0 < m["shortlist_repairs"] < m["pods_seen"]
    if resident:
        assert m["residency_resyncs"] == 1
        assert m["residency_hits"] == m["batches"] - 1
    assert m["kernel_launches"] == 0 and all(
        m[f"kernel_launches_{k}"] == 0 for k in _cuda_build.KERNELS)


@pytest.mark.parametrize("pipeline,resident,shortlist", MODES)
def test_sampled_engine_matches_jax(pipeline, resident, shortlist,
                                    monkeypatch):
    """1,200 nodes x 256 pods in batches of 64 under an otherwise
    unmodified SchedulerConfig: the default samples K=512 of the nodes
    per batch (percentage_of_nodes_to_score=0 is auto), and one pod
    fits only on a node outside every sample, so its batch takes the
    same-cycle full-axis residual pass. Placements and every shared
    counter equal the JAX engine's."""
    kw = dict(max_batch_size=64, pipeline=pipeline,
              device_resident=resident, shortlist=shortlist)
    residuals = []
    orig = getattr(Scheduler, "_run_residual", None)

    def counted(self, b, rows, *a):
        residuals.append(len(rows))
        return orig(self, b, rows, *a)

    monkeypatch.setattr(Scheduler, "_run_residual", counted, raising=False)
    want, jm = _run_cluster(JCluster, JO, JProfile(**BENCH_PROFILE),
                            JConfig(**kw), 0, 0, 0, recipe=sampled_cluster)
    got, m = _run_cluster(Cluster, TO, Profile(**BENCH_PROFILE),
                          SchedulerConfig(platform="cpu", **kw), 0, 0, 0,
                          recipe=sampled_cluster)
    assert got == want
    assert got["bench/only-fits-big"] == "big-node"
    for k in SHARED_METRICS:
        assert m[k] == jm[k], k
    assert m["pods_failed"] == 0 and m["pods_bound"] == 257
    assert residuals == [1]


@pytest.mark.parametrize("pipeline,resident,shortlist",
                         [(False, False, False), (True, True, True)])
def test_port_heavy_burst_matches_jax(pipeline, resident, shortlist):
    """The JAX package's port-heavy residency burst
    (tests/test_device_residency.py:491) under its NodePorts profile, in
    batches of 8: placements and shared counters equal the JAX engine's;
    with residency on, the device-side port insertions equal the host
    mirror and fill most rows."""
    kw = dict(max_batch_size=8, seed=2, pipeline=pipeline,
              device_resident=resident, shortlist=shortlist)

    def device_equals_mirror(sched):
        res = sched._residency
        assert np.array_equal(res.ports_dev.numpy(), res.mirror_ports)
        assert np.array_equal(res.free_dev.numpy(), res.mirror_free)
        assert (res.mirror_ports != 0).sum() >= 24

    want, jm = _run_cluster(JCluster, JO, JProfile(**PORTS_PROFILE),
                            JConfig(**kw), 0, 0, 0,
                            recipe=port_heavy_cluster)
    got, m = _run_cluster(Cluster, TO, Profile(**PORTS_PROFILE),
                          SchedulerConfig(platform="cpu", **kw), 0, 0, 0,
                          recipe=port_heavy_cluster,
                          white_box=device_equals_mirror if resident
                          else None)
    assert got == want and len(got) == 24
    for k in SHARED_METRICS:
        assert m[k] == jm[k], k
    assert m["batches"] == 3
    if resident:
        assert m["residency_resyncs"] == 1
        assert m["residency_hits"] == 2


def test_pipelined_loop_matches_sync_loop():
    """The pipelined loop is bit-identical to the synchronous one, with
    ports (the device-side port insertion) and residency on."""
    def run(pipeline):
        nodes, pods = bench_cluster(TO, 60, 200, 4)
        for i, p in enumerate(pods[:80]):
            p.spec.ports = [TO.ContainerPort(host_port=20000 + i % 9)]
        c = Cluster()
        c.create_objects(nodes)
        c.create_objects(pods)
        c.start(Profile(**BENCH_PROFILE),
                SchedulerConfig(platform="cpu", max_batch_size=32, seed=4,
                                pipeline=pipeline))
        try:
            assert wait_until(
                lambda: all(p.spec.node_name for p in c.list_pods()),
                timeout=60)
            sched = c.service.scheduler
            res = sched._residency
            assert np.array_equal(res.ports_dev.numpy(), res.mirror_ports)
            assert (res.mirror_ports != 0).sum() > 0
            assert np.array_equal(res.free_dev.numpy(), res.mirror_free)
            return _placements(c), sched.metrics()
        finally:
            c.shutdown()

    sync, sm = run(False)
    pipe, pm = run(True)
    assert pipe == sync
    assert pm["batches"] == sm["batches"] >= 6
    assert pm["residency_resyncs"] == sm["residency_resyncs"] == 1


def _burst(config, fault=None, n_nodes=30, n_pods=120):
    """Bench-cluster burst through Cluster(); returns (placements,
    metrics, cluster) with the cluster still running."""
    nodes, pods = bench_cluster(TO, n_nodes, n_pods, 2)
    c = Cluster()
    c.create_objects(nodes)
    c.start(Profile(**BENCH_PROFILE), config)
    if fault is not None:
        fault(c)
    c.create_objects(pods)
    assert wait_until(lambda: all(p.spec.node_name for p in c.list_pods()),
                      timeout=60)
    return _placements(c), c.service.scheduler.metrics(), c


def _cfg(**kw):
    kw.setdefault("max_batch_size", 16)
    kw.setdefault("backoff_initial_s", 0.05)
    kw.setdefault("backoff_max_s", 0.2)
    return SchedulerConfig(platform="cpu", **kw)


def test_steady_state_uploads_only_deltas():
    """One full dynamic-leaf upload (the establish), then delta-corrected
    hits only; fewer bytes up than the upload-every-batch path and a
    slimmer fetch per batch."""
    _p, fb, c = _burst(_cfg(device_resident=False))
    c.shutdown()
    _p, rs, c = _burst(_cfg())
    c.shutdown()
    assert rs["residency_resyncs"] == 1, rs
    assert rs["residency_hits"] == rs["batches"] - 1
    assert fb["residency_hits"] == fb["residency_resyncs"] == 0
    assert rs["h2d_bytes_total"] < fb["h2d_bytes_total"]
    assert (rs["fetch_bytes_total"] / rs["batches"]
            < fb["fetch_bytes_total"] / fb["batches"])


def test_failed_bind_corrects_without_resync():
    """A bind conflict unassumes pods after the device debited their
    rows: the listener marks the rows, the next batch uploads the
    correction, the pods bind on retry; no resync."""
    tripped = threading.Event()

    def fault(c):
        orig = c.store.bind_pods

        def flaky(items):
            if not tripped.is_set():
                tripped.set()
                return orig(items[: len(items) // 2])
            return orig(items)

        c.store.bind_pods = flaky

    _p, m, c = _burst(_cfg(), fault=fault)
    try:
        res = c.service.scheduler._residency
        assert wait_until(lambda: np.array_equal(
            res.free_dev.numpy(), res.mirror_free), timeout=5)
    finally:
        c.shutdown()
    assert tripped.is_set() and m["bind_conflicts"] > 0
    assert m["residency_resyncs"] == 1, m
    assert m["residency_hits"] >= 2


def test_node_delete_mid_stream_stays_consistent():
    c = Cluster()
    try:
        c.start(Profile(**BENCH_PROFILE), _cfg())
        for i in range(6):
            c.create_node(f"n{i}", cpu=64000)
        for i in range(6):
            c.create_pod(f"wave1-{i}", cpu=100)
        for i in range(6):
            c.wait_for_pod_bound(f"wave1-{i}", timeout=30)
        c.store.delete("Node", "n5")
        assert wait_until(
            lambda: c.service.scheduler.cache.row_of("n5") is None,
            timeout=10)
        for i in range(6):
            c.create_pod(f"wave2-{i}", cpu=100)
        for i in range(6):
            p = c.wait_for_pod_bound(f"wave2-{i}", timeout=30)
            assert p.spec.node_name != "n5"
        m = c.service.scheduler.metrics()
        assert m["residency_hits"] >= 1
        assert m["batch_faults"] == 0
    finally:
        c.shutdown()


def test_pad_change_forces_rebase():
    """Nodes added past the node pad's bucket: the next snapshot resolves
    a new pad, the listener rebases, and the engine re-establishes (a
    second resync) and keeps binding."""
    c = Cluster()
    try:
        c.start(Profile(**BENCH_PROFILE), _cfg())
        for i in range(10):
            c.create_node(f"a{i}", cpu=8000)
        c.create_pod("first", cpu=100)
        c.wait_for_pod_bound("first", timeout=30)
        for i in range(30):
            c.create_node(f"b{i}", cpu=8000)
        assert wait_until(
            lambda: c.service.scheduler.cache.node_count() == 40, timeout=10)
        for i in range(5):
            c.create_pod(f"later-{i}", cpu=100)
        for i in range(5):
            c.wait_for_pod_bound(f"later-{i}", timeout=30)
        m = c.service.scheduler.metrics()
        assert m["residency_resyncs"] == 2, m
        assert m["batch_faults"] == 0
    finally:
        c.shutdown()


def _engine(sched_cls, store_cls, O, profile, config, seed):
    nodes, pods, bound = mixed_cluster(O, 40, 150, seed)
    store = store_cls()
    store.create_many(nodes)
    for pod, node_name in bound:
        pod.spec.node_name = node_name
    store.create_many([p for p, _ in bound] + pods)
    sched = sched_cls(store, profile.build(), config)
    sched._shared.ensure_started()
    assert wait_until(lambda: sched.queue.stats()["active"] == len(pods),
                      timeout=10)
    return sched, store


@pytest.mark.parametrize("profile", ["bench", "live"])
@pytest.mark.parametrize("seed", [0, 1])
def test_schedule_batch_decisions_match_jax(profile, seed):
    """schedule_batch on the same pod lists under tight capacity, gangs,
    cordons and tolerations: identical decisions batch after batch, and
    identical failure verdicts (unschedulable plugins) in the store."""
    if profile == "bench":
        kw = BENCH_PROFILE
    else:  # the live profile, permits allowed at once
        kw = dict(plugin_args={"NodeNumber": {"permit_delay": False}})
    jsched, jstore = _engine(JScheduler, JStore, JO, JProfile(**kw),
                             _jax_config(max_batch_size=48, seed=seed), seed)
    tsched, tstore = _engine(Scheduler, ClusterStore, TO, Profile(**kw),
                             SchedulerConfig(platform="cpu",
                                             max_batch_size=48, seed=seed),
                             seed)
    try:
        for _ in range(3):
            jb = jsched.queue.pop_batch(48, timeout=1.0)
            tb = tsched.queue.pop_batch(48, timeout=1.0)
            assert [q.pod.key for q in jb] == [q.pod.key for q in tb]
            jd = jsched.schedule_batch(jb)
            td = tsched.schedule_batch(tb)
            for f in td._fields:
                assert np.array_equal(np.asarray(getattr(jd, f)),
                                      getattr(td, f).numpy()), f
        for sched in (jsched, tsched):  # binds land asynchronously
            assert wait_until(lambda s=sched: s.metrics()["pods_bound"]
                              == s.metrics()["pods_assigned"], timeout=10)

        def verdicts(store):
            return {p.key: (p.spec.node_name,
                            tuple(p.status.unschedulable_plugins))
                    for p in store.list("Pod")}

        assert verdicts(jstore) == verdicts(tstore)
        jm, tm = jsched.metrics(), tsched.metrics()
        for k in ("pods_seen", "pods_assigned", "pods_failed"):
            assert jm[k] == tm[k], k
        assert tm["pods_failed"] > 0
    finally:
        jsched.shutdown()
        tsched.shutdown()


def test_readme_scenario_on_cpu():
    run_scenario(default_scenario, config=SchedulerConfig(platform="cpu"))


def test_default_cluster_needs_the_card():
    c = Cluster()
    if torch.cuda.is_available():
        c.start()
        c.shutdown()
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        c.start()
    assert c.service.scheduler is None


@pytest.mark.parametrize("pipeline", [False, True])
def test_failure_verdicts_flush_in_both_loops(pipeline):
    """Pods that can never fit take the failure path (flushed on the
    commit worker in pipelined mode): their rejecting plugin is recorded
    while every pod that fits binds, and the resident state still equals
    its host mirror."""
    c = Cluster()
    try:
        c.start(Profile(**BENCH_PROFILE), _cfg(pipeline=pipeline))
        for i in range(4):
            c.create_node(f"n{i}", cpu=2000)
        c.create_node("cordoned", cpu=64000, unschedulable=True)
        for i in range(12):
            c.create_pod(f"fits-{i}", cpu=500)
        for i in range(3):
            c.create_pod(f"huge-{i}", cpu=10000)
        for i in range(12):
            c.wait_for_pod_bound(f"fits-{i}", timeout=30)
        for i in range(3):
            pod = c.wait_for_pod_pending(f"huge-{i}", timeout=30)
            assert not pod.spec.node_name
            assert "NodeResourcesFit" in pod.status.unschedulable_plugins
        sched = c.service.scheduler
        m = sched.metrics()
        assert m["pods_failed"] >= 3 and m["batch_faults"] == 0
        res = sched._residency
        assert np.array_equal(res.free_dev.numpy(), res.mirror_free)
    finally:
        c.shutdown()

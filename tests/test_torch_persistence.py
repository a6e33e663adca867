"""The port's store persistence against the JAX package's.

Mirrors tests/test_persistence.py (the checkpointer's atomic write and
its skip when nothing changed, the interval thread, restore on boot, the
service's and Cluster's checkpoint wiring, a real ``kill -9`` of the
port's ``scenario.remote --serve --platform cpu`` process and a restart
on the same snapshot), tests/test_chaos.py's checkpoints racing churn
and tests/test_faults.py's ``checkpoint`` gate. A snapshot that one
package writes restores in the other to equal objects, resource version
and uid counter.
"""
import itertools
import json
import os
import signal
import subprocess
import sys
import threading
import time

import pytest

from minisched_tpu.state import objects as JO
from minisched_tpu.state import persistence as jpersistence
from minisched_tpu.state.store import ClusterStore as JStore
from minisched_tpu_torch import faults
from minisched_tpu_torch.config import SchedulerConfig
from minisched_tpu_torch.errors import (AlreadyExistsError, ConflictError,
                                        NotFoundError)
from minisched_tpu_torch.faults import FAULTS, FaultInjected
from minisched_tpu_torch.scenario.runner import Cluster
from minisched_tpu_torch.state import objects as obj
from minisched_tpu_torch.state.persistence import (Checkpointer,
                                                   open_or_restore)
from minisched_tpu_torch.state.store import ClusterStore
from torch_parity import bench_cluster, mixed_cluster

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = dict(platform="cpu")


def _node(name, unschedulable=False):
    return obj.Node(metadata=obj.ObjectMeta(name=name),
                    spec=obj.NodeSpec(unschedulable=unschedulable),
                    status=obj.NodeStatus(allocatable={
                        "cpu": 4000.0, "memory": 16 << 30, "pods": 110.0}))


def _pod(name):
    return obj.Pod(metadata=obj.ObjectMeta(name=name, namespace="default"),
                   spec=obj.PodSpec(requests={"cpu": 100.0}))


def _wait(pred, timeout=30.0, interval=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        v = pred()
        if v:
            return v
        time.sleep(interval)
    raise AssertionError("condition not met within timeout")


@pytest.fixture
def registry():
    faults.configure("")
    yield FAULTS
    faults.configure("")


# ---- Checkpointer unit behavior -----------------------------------------


def test_checkpoint_atomic_and_skip_unchanged(tmp_path):
    path = str(tmp_path / "snap.json")
    store = ClusterStore()
    store.create(_node("n1"))
    cp = Checkpointer(store, path)  # no interval thread
    assert cp.checkpoint() is True
    assert cp.checkpoint() is False  # rv unchanged: no write
    mtime = os.path.getmtime(path)
    store.create(_node("n2"))
    assert cp.checkpoint() is True
    restored = open_or_restore(path)
    assert restored.count("Node") == 2
    assert restored.resource_version() == store.resource_version()
    assert [p for p in os.listdir(tmp_path) if ".tmp." in p] == []
    assert os.path.getmtime(path) >= mtime
    cp.close()


def test_interval_checkpoint_runs(tmp_path):
    path = str(tmp_path / "snap.json")
    store = ClusterStore()
    cp = Checkpointer(store, path, interval_s=0.05)
    store.create(_node("n1"))
    _wait(lambda: os.path.exists(path), timeout=5.0)
    _wait(lambda: json.load(open(path))["resource_version"] >= 1,
          timeout=5.0)
    cp.close()
    assert open_or_restore(path).count("Node") == 1


def test_open_or_restore_fresh_when_missing(tmp_path):
    store = open_or_restore(str(tmp_path / "nope.json"))
    assert store.resource_version() == 0
    assert sum(store.stats()["objects"].values()) == 0
    with pytest.raises(ValueError):
        Checkpointer(store, "")


def test_torn_write_never_observed(tmp_path):
    path = str(tmp_path / "snap.json")
    store = ClusterStore()
    cp = Checkpointer(store, path)
    for i in range(20):
        store.create(_node(f"n{i}"))
        cp.checkpoint()
        snap = json.load(open(path))
        assert len(snap["objects"]["Node"]) == i + 1
    cp.close()


def test_checkpoint_fault_preserves_previous_snapshot(tmp_path, registry):
    """The ``checkpoint`` gate fires before any disk touch: the previous
    complete snapshot stays as it was."""
    path = str(tmp_path / "state.json")
    store = ClusterStore()
    store.create(_node("ck-n0"))
    cp = Checkpointer(store, path)
    assert cp.checkpoint() is True
    rv0 = json.load(open(path))["resource_version"]
    store.create(_node("ck-n1"))
    faults.configure("checkpoint:err@1")
    with pytest.raises(FaultInjected):
        cp.checkpoint()
    assert json.load(open(path))["resource_version"] == rv0
    assert registry.counts()["checkpoint"] == 1
    faults.configure("")
    assert cp.checkpoint() is True
    assert json.load(open(path))["resource_version"] > rv0
    cp.close()


# ---- snapshots across the two packages ----------------------------------


def _fill(O, store):
    """Nodes, pending pods, bound pods (mixed_cluster: priorities, gangs,
    tolerations, nodes without memory) and a deletion, so the snapshot's
    resource version runs ahead of its objects'."""
    nodes, pending, bound = mixed_cluster(O, 24, 40, seed=5)
    store.create_many(nodes)
    store.create_many(pending)
    for pod, node in bound:
        store.create(pod)
        store.bind_pod(pod.key, node)
    store.delete("Pod", pending[0].key)


def _dicts(O, store):
    return {kind: sorted((O.to_dict(o) for o in store.list(kind)),
                         key=lambda d: json.dumps(d, sort_keys=True))
            for kind in ("Node", "Pod")}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_snapshot_restores_across_packages(tmp_path, monkeypatch, writer):
    """A snapshot one package writes restores in the other (and in
    itself) to equal objects, resource version and uid counter: the next
    uid after the restore is the same in both."""
    W, Store = (JO, JStore) if writer == "jax" else (obj, ClusterStore)
    src = Store()
    _fill(W, src)
    path = str(tmp_path / "x.json")
    src.save(path)
    for O in (JO, obj):
        monkeypatch.setattr(O, "_uid_counter", itertools.count(1))
    port = ClusterStore.load(path)
    jax = jpersistence.open_or_restore(path)
    assert port.resource_version() == jax.resource_version() \
        == src.resource_version()
    assert _dicts(obj, port) == _dicts(JO, jax) == _dicts(W, src)
    assert isinstance(port.get("Node", port.list("Node")[0].key), obj.Node)
    max_uid = max(int(o.metadata.uid[4:]) for k in ("Node", "Pod")
                  for o in src.list(k))
    fresh = [port.create(_node("after")),
             jax.create(JO.Node(metadata=JO.ObjectMeta(name="after"),
                                status=JO.NodeStatus(
                                    allocatable={"cpu": 1.0})))]
    assert fresh[0].metadata.uid == fresh[1].metadata.uid \
        == f"uid-{max_uid + 1}"


def test_bench_snapshot_round_trips(tmp_path):
    """bench_cluster at 1,200 nodes through the port's checkpointer loads
    in the JAX package to equal objects, and back."""
    nodes, pods = bench_cluster(obj, 1200, 256, seed=2)
    store = ClusterStore()
    store.create_many(nodes)
    store.create_many(pods)
    path = str(tmp_path / "bench.json")
    Checkpointer(store, path).close()
    jax = JStore.load(path)
    assert _dicts(JO, jax) == _dicts(obj, store)
    jax.save(path)
    assert _dicts(obj, ClusterStore.load(path)) == _dicts(obj, store)


# ---- service-lifecycle wiring (in-process deployment) -------------------


def test_cluster_restart_resumes_from_checkpoint(tmp_path):
    path = str(tmp_path / "cluster.json")
    c1 = Cluster(persist_path=path)
    c1.start(config=SchedulerConfig(**CPU))
    c1.create_node("node-a")
    c1.create_pod("bound-pod")
    c1.wait_for_pod_bound("bound-pod", timeout=60.0)
    c1.create_node("node-b", unschedulable=True)
    c1.create_pod("pending-pod", cpu=999999)
    c1.wait_for_pod_pending("pending-pod", timeout=30.0)
    pre_uids = {p.metadata.uid for p in c1.list_pods()}
    c1.shutdown()  # final checkpoint

    c2 = Cluster(persist_path=path)
    c2.start(config=SchedulerConfig(**CPU))
    try:
        assert c2.get_pod("bound-pod").spec.node_name == "node-a"
        c2.create_node("node-big", cpu=2_000_000)
        p = c2.wait_for_pod_bound("pending-pod", timeout=60.0)
        assert p.spec.node_name == "node-big"
        fresh = c2.create_pod("post-restart-pod")
        assert fresh.metadata.uid not in pre_uids
        c2.wait_for_pod_bound("post-restart-pod", timeout=30.0)
    finally:
        c2.shutdown()


def test_service_rejects_checkpoint_path_on_remote_store(tmp_path):
    from minisched_tpu_torch.apiserver import RemoteStore
    from minisched_tpu_torch.service.service import SchedulerService

    with pytest.raises(ValueError):
        SchedulerService(RemoteStore("http://127.0.0.1:1"),
                         checkpoint_path=str(tmp_path / "x.json"))


def test_cluster_rejects_store_plus_persist_path(tmp_path):
    with pytest.raises(ValueError):
        Cluster(store=ClusterStore(),
                persist_path=str(tmp_path / "x.json"))


def test_checkpoint_route_409_without_persistence():
    from minisched_tpu_torch.apiserver import APIServer, RemoteStore

    api = APIServer(ClusterStore()).start()
    try:
        with pytest.raises(ConflictError):
            RemoteStore(api.address).checkpoint()
    finally:
        api.shutdown()


def test_checkpoint_route_writes_and_shutdown_checkpoints(tmp_path):
    """POST /checkpoint writes the served store (a skip when nothing
    changed), and shutdown writes the last state; the file loads in the
    JAX package too."""
    from minisched_tpu_torch.apiserver import APIServer, RemoteStore

    path = str(tmp_path / "api.json")
    store = ClusterStore()
    api = APIServer(store, persist_path=path, persist_interval_s=0).start()
    try:
        rs = RemoteStore(api.address)
        rs.create(_node("cr-n0"))
        out = rs.checkpoint()
        assert out == {"checkpointed": True, "wrote": True, "path": path}
        assert rs.checkpoint()["wrote"] is False
        rs.create(_node("cr-n1"))
    finally:
        api.shutdown()
    assert JStore.load(path).count("Node") == 2


# ---- the kill -9 e2e over the wire --------------------------------------


def _spawn_server(tmp_path, persist_path):
    env = dict(os.environ, MINISCHED_PERSIST_PATH=persist_path,
               MINISCHED_PERSIST_INTERVAL="0.2")
    proc = subprocess.Popen(
        [sys.executable, "-m", "minisched_tpu_torch.scenario.remote",
         "--serve", "--platform", "cpu"],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True, env=env,
        cwd=REPO)
    line = proc.stdout.readline().strip()
    assert line.startswith("LISTENING "), line
    return proc, line.split(" ", 1)[1]


def test_kill_dash_nine_resume(tmp_path):
    """Create a workload, SIGKILL the port's simulator process, restart
    it on the same snapshot path: bound pods stayed bound, the pending
    pod reschedules, uids advance."""
    from minisched_tpu_torch.apiserver import RemoteStore

    persist = str(tmp_path / "wire.json")
    proc, addr = _spawn_server(tmp_path, persist)
    try:
        rs = RemoteStore(addr)
        _wait(rs.healthz, timeout=30)
        rs.create(_node("node-a"))
        rs.create(_pod("bound-pod"))
        _wait(lambda: rs.get("Pod", "default/bound-pod").spec.node_name,
              timeout=90.0)
        big = _pod("pending-pod")
        big.spec.requests["cpu"] = 999999.0
        rs.create(big)
        _wait(lambda: rs.get(
            "Pod", "default/pending-pod").status.unschedulable_plugins,
            timeout=60.0)
        pre_uids = {p.metadata.uid for p in rs.list("Pod")}
        assert rs.checkpoint()["checkpointed"] is True
    finally:
        proc.send_signal(signal.SIGKILL)  # no shutdown checkpoint
        proc.wait(timeout=10)

    proc, addr = _spawn_server(tmp_path, persist)
    try:
        rs = RemoteStore(addr)
        _wait(rs.healthz, timeout=30)
        assert rs.get("Pod", "default/bound-pod").spec.node_name == "node-a"
        assert rs.get("Pod", "default/pending-pod").spec.node_name == ""
        node_big = _node("node-big")
        node_big.status.allocatable["cpu"] = 2_000_000.0
        rs.create(node_big)
        _wait(lambda: rs.get(
            "Pod", "default/pending-pod").spec.node_name, timeout=90.0)
        fresh = rs.create(_pod("post-restart-pod"))
        assert fresh.metadata.uid not in pre_uids
    finally:
        try:
            proc.stdin.close()
            proc.wait(timeout=10)
        except Exception:
            proc.kill()
            proc.wait()


# ---- checkpoints racing churn (tests/test_chaos.py) ---------------------


def _guarded(errors):
    def deco(fn):
        def run():
            try:
                fn()
            except Exception as e:  # pragma: no cover - failure path
                errors.append(e)
        return run
    return deco


def test_chaos_checkpoint_under_churn_restores_consistent_state(tmp_path):
    """Interval checkpoints race live scheduling and churn: every
    observed snapshot parses, its resource version is at least every
    contained object's and never goes backwards; the last restores into
    a cluster the port's engine keeps scheduling on."""
    path = str(tmp_path / "churn.json")
    c = Cluster()
    c.start(config=SchedulerConfig(backoff_initial_s=0.05,
                                   backoff_max_s=0.3, batch_window_s=0.0,
                                   **CPU),
            with_pv_controller=False)
    cp = Checkpointer(c.store, path, interval_s=0.02)
    errors: list = []
    stop = threading.Event()
    for i in range(10):
        c.create_node(f"ck-n{i}")

    @_guarded(errors)
    def pod_churn():
        i = 0
        while not stop.is_set():
            c.create_pod(f"ck-p{i}")
            if i >= 6 and i % 3 == 0:
                try:
                    c.delete_pod(f"ck-p{i - 6}")
                except NotFoundError:
                    pass
            i += 1
            time.sleep(0.003)

    @_guarded(errors)
    def node_churn():
        j = 0
        while not stop.is_set():
            try:
                c.delete_node(f"ck-n{j % 10}")
                time.sleep(0.004)
                c.create_node(f"ck-n{j % 10}")
            except (NotFoundError, AlreadyExistsError):
                pass
            j += 1
            time.sleep(0.004)

    observed = []

    @_guarded(errors)
    def snapshot_reader():
        last_rv = -1
        while not stop.is_set():
            if os.path.exists(path):
                with open(path) as f:
                    snap = json.load(f)  # parseable always (atomic rename)
                rv = snap["resource_version"]
                if rv < last_rv:
                    errors.append(AssertionError(
                        f"snapshot rv went backwards: {rv} < {last_rv}"))
                    return
                last_rv = rv
                observed.append(rv)
                for kind, col in snap["objects"].items():
                    for key, d in col.items():
                        if d["metadata"]["resource_version"] > rv:
                            errors.append(AssertionError(
                                f"snapshot rv {rv} < contained {kind} "
                                f"{key}'s (mid-mutation capture)"))
                            return
            time.sleep(0.005)

    threads = [threading.Thread(target=t, daemon=True)
               for t in (pod_churn, node_churn, snapshot_reader)]
    for t in threads:
        t.start()
    time.sleep(2.5)
    stop.set()
    for t in threads:
        t.join(timeout=10)
    c.shutdown()
    cp.close()
    assert not errors, errors[:3]
    assert len(set(observed)) >= 2

    restored = open_or_restore(path)
    assert JStore.load(path).resource_version() == \
        restored.resource_version()
    c2 = Cluster(store=restored)
    c2.start(config=SchedulerConfig(backoff_initial_s=0.05,
                                    backoff_max_s=0.3, **CPU),
             with_pv_controller=False)
    try:
        c2.create_node("ck-fresh")
        c2.create_pod("ck-post")
        assert c2.wait_for_pod_bound("ck-post", timeout=30).spec.node_name
    finally:
        c2.shutdown()

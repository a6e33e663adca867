"""The port's native fastclone (minisched_tpu_torch/native): it builds
under minisched_tpu_torch/_build/, matches the Python clone over the
whole object-tree shape space, and a failed build raises; the Python
walk runs only under MINISCHED_NO_NATIVE=1."""
import dataclasses
import gc
import itertools
import os
import subprocess
import sys
import time
import types
import weakref

import pytest

from minisched_tpu_torch import native
from minisched_tpu_torch.native import NativeBuildError, load
from minisched_tpu_torch.state import objects as obj
from minisched_tpu_torch.state.objects import _clone, deepcopy_obj

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rich_pod():
    return obj.Pod(
        metadata=obj.ObjectMeta(name="np", namespace="ns",
                                labels={"a": "b", "c": "d"},
                                annotations={"k": "v"}),
        spec=obj.PodSpec(
            requests={"cpu": 100.0, "memory": 1 << 30},
            priority=7,
            tolerations=[obj.Toleration(key="t", operator="Exists",
                                        effect="NoSchedule")],
            ports=[obj.ContainerPort(host_port=80)],
            volumes=[obj.VolumeClaim(claim_name="vc")],
            topology_spread_constraints=[obj.TopologySpreadConstraint(
                max_skew=1, topology_key="zone",
                when_unsatisfiable="DoNotSchedule",
                label_selector=obj.LabelSelector(
                    match_labels={"x": "y"}))],
            affinity=obj.Affinity(
                node_affinity=obj.NodeAffinity(
                    required=obj.NodeSelector(node_selector_terms=[
                        obj.NodeSelectorTerm(match_expressions=[
                            obj.NodeSelectorRequirement(
                                key="k", operator="In",
                                values=["v1", "v2"])])]),
                    preferred=[obj.PreferredSchedulingTerm(
                        weight=3,
                        preference=obj.NodeSelectorTerm())]),
                pod_anti_affinity=obj.PodAntiAffinity(required=[
                    obj.PodAffinityTerm(
                        label_selector=obj.LabelSelector(
                            match_labels={"q": "r"}),
                        topology_key="zone",
                        namespaces=["n1", "n2"])])),
        ),
        status=obj.PodStatus(unschedulable_plugins=["A", "B"],
                             message="m", nominated_node_name="n"))


SAMPLES = [
    _rich_pod(),
    obj.Node(metadata=obj.ObjectMeta(name="nn"),
             spec=obj.NodeSpec(unschedulable=True,
                               taints=[obj.Taint(key="a", value="b",
                                                 effect="NoExecute")]),
             status=obj.NodeStatus(allocatable={"cpu": 1.5, "pods": 9})),
    obj.PersistentVolume(metadata=obj.ObjectMeta(name="pv"),
                         capacity={"ephemeral-storage": 5.0},
                         storage_class="sc", phase="Available"),
    obj.Event(metadata=obj.ObjectMeta(name="ev", namespace="d"),
              reason="r", message="m", involved_object="Pod:d/x"),
]


def test_native_builds_and_matches_python_clone():
    mod = load()
    assert mod is not None
    for sample in SAMPLES:
        got = deepcopy_obj(sample)          # native path (via objects.py)
        ref = _clone(sample)                # pure-Python walk
        assert obj.to_dict(got) == obj.to_dict(ref)
        # isolation: mutating the clone leaves the original untouched
        got.metadata.labels["mut"] = "x"
        assert "mut" not in sample.metadata.labels


def test_native_shares_immutables_and_rebuilds_containers():
    mod = load()
    assert mod is not None
    p = _rich_pod()
    c = mod and deepcopy_obj(p)
    assert c.metadata.name is p.metadata.name          # str shared
    assert c.metadata.labels is not p.metadata.labels  # dict rebuilt
    assert c.spec.tolerations is not p.spec.tolerations
    assert c.spec is not p.spec


def test_python_walk_under_no_native(monkeypatch):
    """MINISCHED_NO_NATIVE=1 pins the pure-Python clone; the store keeps
    working end-to-end."""
    env = dict(os.environ, MINISCHED_NO_NATIVE="1")
    code = (
        "from minisched_tpu_torch.state.store import ClusterStore\n"
        "from minisched_tpu_torch.state import objects as obj\n"
        "import minisched_tpu_torch.native as n\n"
        "assert n.load() is None\n"
        "s = ClusterStore()\n"
        "s.create(obj.Pod(metadata=obj.ObjectMeta(name='x',"
        " namespace='d'), spec=obj.PodSpec(requests={'cpu': 1})))\n"
        "assert s.get('Pod', 'd/x').spec.requests == {'cpu': 1}\n"
        "print('fallback ok')\n")
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "fallback ok" in r.stdout


def test_unregistered_type_takes_python_walk():
    mod = load()
    assert mod is not None

    class Weird:
        def __init__(self):
            self.x = 1

    # deepcopy_obj must survive a type the native module never saw
    out = deepcopy_obj({"w": Weird()})
    assert out["w"].x == 1 and out["w"] is not None


def test_deep_nesting_raises_instead_of_crashing():
    """Pathological nesting must surface as RecursionError (the Python
    walk's failure mode), never a C-stack segfault."""
    mod = load()
    assert mod is not None
    deep = cur = []
    for _ in range(200_000):
        nxt = []
        cur.append(nxt)
        cur = nxt
    with pytest.raises(RecursionError):
        mod.clone(deep)


def test_library_lands_under_the_port_build_dir():
    load()
    st = native.status()
    assert st["native"]
    assert os.path.dirname(st["path"]) == os.path.join(
        ROOT, "minisched_tpu_torch", "_build")
    assert os.path.exists(st["path"])


@pytest.mark.parametrize("compiler", ["no-such-cc", "false"])
def test_build_failure_raises_unless_no_native(compiler, monkeypatch,
                                               tmp_path):
    """A compiler that is missing or fails makes load() and deepcopy_obj
    raise; only MINISCHED_NO_NATIVE=1 selects the Python walk."""
    monkeypatch.delenv("MINISCHED_NO_NATIVE", raising=False)
    monkeypatch.setattr(native, "_mod", None)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "COMPILERS", (compiler,))
    monkeypatch.setattr(obj, "_native", None)
    with pytest.raises(NativeBuildError, match=compiler):
        load()
    pod = _rich_pod()
    with pytest.raises(NativeBuildError):
        deepcopy_obj(pod)
    assert os.listdir(tmp_path) == []  # no half-built library left
    monkeypatch.setenv("MINISCHED_NO_NATIVE", "1")
    assert load() is None
    assert obj.to_dict(deepcopy_obj(pod)) == obj.to_dict(pod)


# ---- the store's copies leave the collector's lists ------------------------

def _containers(root):
    """Every container of a stored tree: instances, their ``__dict__``,
    dicts, lists, tuples and sets (each once)."""
    seen, stack, out = set(), [root], []
    while stack:
        v = stack.pop()
        if id(v) in seen or type(v) in (str, int, float, bool, type(None)):
            continue
        seen.add(id(v))
        out.append(v)
        if isinstance(v, dict):
            stack.extend(v.keys())
            stack.extend(v.values())
        elif isinstance(v, (list, tuple, set, frozenset)):
            stack.extend(v)
        elif dataclasses.is_dataclass(v):
            out.append(v.__dict__)
            stack.extend(v.__dict__.values())
    return out


def _node(name="n1"):
    return obj.Node(metadata=obj.ObjectMeta(name=name, labels={"zone": "z"}),
                    spec=obj.NodeSpec(taints=[obj.Taint(key="a")]),
                    status=obj.NodeStatus(allocatable={"cpu": 4.0}))


def _write(store, path):
    """Run one write path of the store on a pod; returns (stored object,
    the watch event it appended or None, the objects it stored)."""
    from minisched_tpu_torch.state.store import ClusterStore

    if path == "restore":
        src = ClusterStore()
        src.create_many([_node(), _rich_pod()])
        store = ClusterStore.restore(src.snapshot())
        return store, store._objects["Pod"]["ns/np"], None, 2
    store.create(_node())
    if path == "event":
        store.create(obj.Event(metadata=obj.ObjectMeta(name="e",
                                                       namespace="d"),
                               reason="Scheduled", involved_object="Pod:x"))
        return store, store._objects["Event"]["d/e"], store._log[-1], 2
    if path == "create_many":
        store.create_many([_rich_pod(), obj.Pod(metadata=obj.ObjectMeta(
            name="q", namespace="ns"))])
        return store, store._objects["Pod"]["ns/np"], store._log[-2], 3
    store.create(_rich_pod())
    n = 2
    if path == "update":
        p = store.get("Pod", "ns/np")
        p.metadata.labels["new"] = "x"
        p.spec.tolerations.append(obj.Toleration(key="k"))
        store.update(p)
        n += 1
    elif path == "bind_pod":
        store.bind_pod("ns/np", "n1")
        n += 1
    elif path == "bind_pods":
        assert store.bind_pods([("ns/np", "n1")]) == ["ns/np"]
        n += 1
    elif path == "fail_pods":
        assert store.fail_pods([("ns/np", {"B", "A"}, "no fit")]) == []
        n += 1
    elif path == "delete":
        store.delete("Pod", "ns/np")
        return store, store._log[-1].object, store._log[-1], n
    return store, store._objects["Pod"]["ns/np"], store._log[-1], n


WRITE_PATHS = ["create", "create_many", "update", "bind_pod", "bind_pods",
               "fail_pods", "delete", "event", "restore"]


@pytest.mark.parametrize("path", WRITE_PATHS)
def test_store_write_paths_untrack_what_they_keep(path):
    """After each write path, no container of the stored tree and not
    the watch event it appended is on the collector's lists, and the
    counters count every object stored, all untracked."""
    from minisched_tpu_torch.state.store import ClusterStore

    assert load() is not None
    store, stored, ev, n = _write(ClusterStore(), path)
    tracked = [type(c).__name__ for c in _containers(stored)
               if gc.is_tracked(c)]
    assert tracked == []
    if ev is not None:
        assert ev.object is stored and not gc.is_tracked(ev)
    for col in store._objects.values():
        for o in col.values():
            assert not any(gc.is_tracked(c) for c in _containers(o))
    assert store.stats()["snapshots_untracked_total"] == n
    assert store.snapshot_counts() == {"snapshots_untracked_total": n,
                                       "snapshots_tracked_total": 0}


def test_store_copies_handed_out_stay_tracked():
    """get() and list() copies belong to callers, who mutate them: they
    stay on the collector's lists; so does the caller's own object."""
    from minisched_tpu_torch.state.store import ClusterStore

    store = ClusterStore()
    mine = _rich_pod()
    store.create(mine)
    for c in [store.get("Pod", "ns/np")] + store.list("Pod") + [mine]:
        assert gc.is_tracked(c) and gc.is_tracked(c.__dict__)
        assert gc.is_tracked(c.spec.tolerations)
        assert gc.is_tracked(c.spec.affinity.node_affinity)


def _python_walk(monkeypatch):
    """Resolve the clone anew under MINISCHED_NO_NATIVE=1: the Python
    walk, as a process started with it runs."""
    monkeypatch.setenv("MINISCHED_NO_NATIVE", "1")
    monkeypatch.setattr(obj, "_native", None)


@pytest.mark.parametrize("path", WRITE_PATHS)
def test_native_and_python_walk_store_equal_objects(path, monkeypatch):
    """Both walks store equal objects and events; the Python walk's
    stay tracked and are counted so."""
    from minisched_tpu_torch.state import store as store_mod
    from minisched_tpu_torch.state.store import ClusterStore

    monkeypatch.setattr(store_mod, "time", types.SimpleNamespace(
        time=lambda: 1.0, monotonic=time.monotonic))

    def written():
        obj._uid_counter = itertools.count(1)
        store, stored, ev, n = _write(ClusterStore(), path)
        return (obj.to_dict(stored), ev and (ev.type, ev.kind,
                                             ev.resource_version),
                {k: {key: obj.to_dict(o) for key, o in col.items()}
                 for k, col in store._objects.items()},
                store.snapshot_counts(), n, stored)

    uid = obj._uid_counter
    try:
        native_w = written()
        _python_walk(monkeypatch)
        python_w = written()
    finally:
        obj._uid_counter = uid
    assert native_w[:3] == python_w[:3]
    n = native_w[4]
    assert native_w[3] == {"snapshots_untracked_total": n,
                           "snapshots_tracked_total": 0}
    assert python_w[3] == {"snapshots_untracked_total": 0,
                           "snapshots_tracked_total": n}
    assert gc.is_tracked(python_w[5])


def test_counters_add_up_to_the_objects_written():
    from minisched_tpu_torch.state.store import ClusterStore

    store = ClusterStore()
    store.create_many([_node(f"n{i}") for i in range(5)])
    store.create_many([obj.Pod(metadata=obj.ObjectMeta(
        name=f"p{i}", namespace="d")) for i in range(8)])
    assert store.bind_pods([(f"d/p{i}", "n1") for i in range(4)]
                           + [("d/gone", "n1")]) == [f"d/p{i}"
                                                     for i in range(4)]
    store.fail_pods([("d/p5", ["A"], "m"), ("d/p6", ["B"], "m")])
    store.bind_pod("d/p7", "n2")
    store.delete("Pod", "d/p0")
    store.create(obj.Event(metadata=obj.ObjectMeta(name="e", namespace="d")))
    want = 5 + 8 + 4 + 2 + 1 + 1
    st = store.stats()
    assert st["snapshots_untracked_total"] == want
    assert st["snapshots_tracked_total"] == 0
    restored = type(store).restore(store.snapshot())
    assert restored.snapshot_counts()["snapshots_untracked_total"] == (
        sum(restored.stats()["objects"].values()))


# ---- safety: untracked is not leaked -------------------------------------

def test_untracked_snapshots_are_freed_by_their_reference_counts():
    """Stored versions of a pod (created, then bound) are freed once the
    pod is deleted and the watch log is trimmed past it: untracked
    objects still die by reference count."""
    from minisched_tpu_torch.state.store import ClusterStore

    store = ClusterStore(max_log=2)
    store.create(_node())
    store.create(_rich_pod())
    refs = [weakref.ref(store._objects["Pod"]["ns/np"])]
    store.bind_pods([("ns/np", "n1")])
    refs.append(weakref.ref(store._objects["Pod"]["ns/np"]))
    refs.append(weakref.ref(store._objects["Pod"]["ns/np"].spec))
    # Off the collector's lists, only their reference counts can free
    # them: no collection can.
    assert not any(gc.is_tracked(r()) for r in refs)
    store.delete("Pod", "ns/np")
    assert all(r() is not None for r in refs)   # the log holds them
    for i in range(3):
        store.create(_node(f"m{i}"))
    assert [r() for r in refs] == [None, None, None]


def _burst(n_nodes=120, n_pods=300):
    from minisched_tpu_torch.config import SchedulerConfig
    from minisched_tpu_torch.scenario.runner import Cluster, wait_until
    from minisched_tpu_torch.service.defaultconfig import Profile
    from torch_parity import BENCH_PROFILE, bench_cluster

    nodes, pods = bench_cluster(obj, n_nodes, n_pods, seed=7)
    c = Cluster()
    c.create_objects(nodes)
    c.create_objects(pods)
    c.start(Profile(**BENCH_PROFILE),
            SchedulerConfig(platform="cpu", max_batch_size=64, seed=3))
    try:
        assert wait_until(lambda: all(p.spec.node_name
                                      for p in c.list_pods()), timeout=90)
        m = c.service.scheduler.metrics()
        return {p.key: p.spec.node_name for p in c.list_pods()}, m
    finally:
        c.shutdown()


def test_engine_placements_equal_native_and_python_walk(monkeypatch):
    """One store content and seed: the engine places every pod on the
    same node whether the store's copies are untracked or not; the
    engine's metrics carry the store's counters."""
    native_p, native_m = _burst()
    _python_walk(monkeypatch)
    python_p, python_m = _burst()
    assert native_p == python_p and len(native_p) == 300
    assert native_m["snapshots_tracked_total"] == 0
    assert native_m["snapshots_untracked_total"] >= 120 + 2 * 300
    assert python_m["snapshots_untracked_total"] == 0
    assert python_m["snapshots_tracked_total"] >= 120 + 2 * 300


# Tracked objects left per bound pod after a full collection, at 400
# nodes and 2,048 pods of the benchmark's cell (tools/gc_census.py). With
# the store's copies on the collector's lists it read 36.3; with them off,
# 2.1-2.4 (the engine's queue entries and their tuples and lists). The
# bound leaves room for work of the set-up's batch that lands after the
# first count.
RETAINED_PER_POD_BOUND = 10.0


def test_tracked_objects_retained_per_bound_pod():
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        import gc_census
    finally:
        sys.path.remove(os.path.join(ROOT, "tools"))
    out = gc_census.run(gc_census.CELL, nodes=400, pods=2048,
                        seed=9700000001, top=8)
    assert out["pods_bound"] == 2048
    assert out["retained_per_pod"]["total"] <= RETAINED_PER_POD_BOUND, out
    assert out["store"]["snapshots_tracked_total"] == 0

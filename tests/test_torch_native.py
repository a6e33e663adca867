"""The port's native fastclone (minisched_tpu_torch/native): it builds
under minisched_tpu_torch/_build/, matches the Python clone over the
whole object-tree shape space, and a failed build raises; the Python
walk runs only under MINISCHED_NO_NATIVE=1."""
import os
import subprocess
import sys

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
    monkeypatch.setattr(obj, "_native_clone", None)
    with pytest.raises(NativeBuildError, match=compiler):
        load()
    pod = _rich_pod()
    with pytest.raises(NativeBuildError):
        deepcopy_obj(pod)
    assert os.listdir(tmp_path) == []  # no half-built library left
    monkeypatch.setenv("MINISCHED_NO_NATIVE", "1")
    assert load() is None
    assert obj.to_dict(deepcopy_obj(pod)) == obj.to_dict(pod)

"""Programmable scenario runner — the user-facing API.

Rebuild of reference sched.go: main() boots config → control plane → pv
controller → scheduler service, then hands a client to a user-editable
scenario function that drives and asserts scheduler behavior
(sched.go:30-68, scenario at :70-143). Here the "client" is a Cluster
facade over the in-process store with the same verbs the reference scenario
uses via client-go (create nodes/pods, get, list, observe phase) plus
polling asserts in place of the reference's fixed sleeps (sched.go:109,134).
"""
from __future__ import annotations

import time
from typing import Callable, List, Optional

from ..config import SchedulerConfig
from ..pvcontroller.controller import PVController
from ..service.service import ProfileSpec, SchedulerService
from ..state import objects as obj
from ..state.store import ClusterStore


def wait_until(pred: Callable[[], bool], timeout: float = 5.0,
               interval: float = 0.02) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return pred()


class Cluster:
    """Scenario-facing cluster client (the reference passes a client-go
    clientset; the verbs the scenario needs are mirrored 1:1)."""

    def __init__(self, store: Optional[ClusterStore] = None,
                 persist_path: Optional[str] = None,
                 persist_interval_s: float = 30.0):
        """``persist_path``: boot from the last snapshot at that path (if
        any) and checkpoint on an interval and at shutdown, the
        reference's restart-against-the-same-etcd durability
        (docker-compose.yml:20-21) for the in-process deployment."""
        if store is not None and persist_path:
            # A pre-built store would skip the restore yet still
            # checkpoint over the snapshot at that path, destroying the
            # state from before the restart.
            raise ValueError(
                "pass either store= or persist_path=, not both: a "
                "pre-built store would clobber the snapshot it never "
                "restored")
        if store is None:
            if persist_path:
                from ..state.persistence import open_or_restore

                store = open_or_restore(persist_path)
            else:
                store = ClusterStore()
        self.store = store
        self.service = SchedulerService(
            self.store, checkpoint_path=persist_path,
            checkpoint_interval_s=persist_interval_s)
        self.pv_controller: Optional[PVController] = None

    # ---- boot (reference sched.go:30-68) -------------------------------

    def start(self, profile: ProfileSpec = None,
              config: Optional[SchedulerConfig] = None,
              with_pv_controller: bool = True,
              fleet: Optional[int] = None) -> "Cluster":
        """Boot the scheduler (on the card unless ``config.platform``
        says otherwise) and, by default, the PV controller. ``fleet`` at
        2 or more boots a replicated scheduler fleet (shard leases and
        takeover, ``SchedulerService._start_fleet``) instead of one
        engine; None defers to ``MINISCHED_FLEET``."""
        if with_pv_controller:
            self.pv_controller = PVController(self.store)
            self.pv_controller.start()
        try:
            self.service.start_scheduler(profile, config, fleet=fleet)
        except BaseException:
            self.shutdown()
            raise
        return self

    def shutdown(self) -> None:
        self.service.shutdown_scheduler()
        if self.pv_controller is not None:
            self.pv_controller.shutdown()

    # ---- object helpers (reference scenario verbs, sched.go:74-143) ----

    def create_node(self, name: str, *, unschedulable: bool = False,
                    cpu: float = 4000, memory: float = 16 << 30,
                    pods: float = 110, labels: Optional[dict] = None,
                    taints: Optional[list] = None,
                    accelerator: float = 0,
                    attachable_volumes: Optional[float] = None) -> obj.Node:
        allocatable = {"cpu": cpu, "memory": memory, "pods": pods,
                       "accelerator": accelerator}
        if attachable_volumes is not None:  # explicit 0 = no attach slots
            allocatable["attachable-volumes"] = attachable_volumes
        node = obj.Node(
            metadata=obj.ObjectMeta(name=name, labels=labels or {}),
            spec=obj.NodeSpec(unschedulable=unschedulable, taints=taints or []),
            status=obj.NodeStatus(allocatable=allocatable))
        return self.store.create(node)

    def create_pv(self, name: str, *, storage: float = 1 << 30,
                  storage_class: str = "", zone: Optional[str] = None,
                  phase: str = "Available",
                  claim_ref: str = "") -> obj.PersistentVolume:
        labels = {"topology.kubernetes.io/zone": zone} if zone else {}
        pv = obj.PersistentVolume(
            metadata=obj.ObjectMeta(name=name, labels=labels),
            capacity={"ephemeral-storage": storage},
            storage_class=storage_class, phase=phase, claim_ref=claim_ref)
        return self.store.create(pv)

    def create_pvc(self, name: str, namespace: str = "default", *,
                   storage: float = 1 << 30, storage_class: str = "",
                   volume_name: str = "",
                   phase: Optional[str] = None) -> obj.PersistentVolumeClaim:
        pvc = obj.PersistentVolumeClaim(
            metadata=obj.ObjectMeta(name=name, namespace=namespace),
            request={"ephemeral-storage": storage},
            storage_class=storage_class, volume_name=volume_name,
            phase=phase or ("Bound" if volume_name else "Pending"))
        return self.store.create(pvc)

    def create_pod(self, name: str, *, namespace: str = "default",
                   cpu: float = 100, memory: float = 0,
                   labels: Optional[dict] = None,
                   spec: Optional[obj.PodSpec] = None, **spec_kwargs) -> obj.Pod:
        if spec is None:
            requests = {"cpu": cpu}
            if memory:
                requests["memory"] = memory
            spec = obj.PodSpec(requests=requests, **spec_kwargs)
        pod = obj.Pod(metadata=obj.ObjectMeta(name=name, namespace=namespace,
                                              labels=labels or {}),
                      spec=spec)
        return self.store.create(pod)

    def create_objects(self, objs: list) -> list:
        """Bulk submission: one store transaction for a burst of objects
        (scenario analog of a big workload apply; see store.create_many)."""
        return self.store.create_many(objs)

    def get_pod(self, name: str, namespace: str = "default") -> obj.Pod:
        return self.store.get("Pod", f"{namespace}/{name}")

    def get_node(self, name: str) -> obj.Node:
        return self.store.get("Node", name)

    def list_pods(self) -> List[obj.Pod]:
        return self.store.list("Pod")

    def list_nodes(self) -> List[obj.Node]:
        return self.store.list("Node")

    def delete_pod(self, name: str, namespace: str = "default") -> None:
        self.store.delete("Pod", f"{namespace}/{name}")

    def delete_node(self, name: str) -> None:
        self.store.delete("Node", name)

    # ---- node mutation verbs (client-go patch/cordon analogs) ----------
    # Nodes could previously only be BORN unschedulable; these mutate a
    # live node through the same store→watch→informer path the create
    # verbs use, so the engine observes them exactly like a kubectl
    # cordon/drain (the lifecycle generators drive churn through here).

    def update_node(self, name: str, *, unschedulable: Optional[bool] = None,
                    labels: Optional[dict] = None,
                    taints: Optional[list] = None,
                    allocatable: Optional[dict] = None,
                    replace_labels: bool = False) -> obj.Node:
        """Mutate a live node (get → modify → update CAS-free, like a
        strategic-merge patch). ``labels`` merge by default
        (``replace_labels=True`` substitutes the whole map); ``taints``
        replace; ``allocatable`` axes merge."""
        node = self.store.get("Node", name)
        if unschedulable is not None:
            node.spec.unschedulable = bool(unschedulable)
        if taints is not None:
            node.spec.taints = list(taints)
        if labels is not None:
            if replace_labels:
                node.metadata.labels = dict(labels)
            else:
                node.metadata.labels.update(labels)
        if allocatable is not None:
            node.status.allocatable.update(allocatable)
        return self.store.update(node)

    def cordon(self, name: str) -> obj.Node:
        """Mark unschedulable (kubectl cordon): new placements stop; a
        purely-narrowing update, so the engine skips the requeue scan."""
        return self.update_node(name, unschedulable=True)

    def uncordon(self, name: str) -> obj.Node:
        return self.update_node(name, unschedulable=False)

    def drain(self, name: str, *, delete_pods: bool = True) -> List[obj.Pod]:
        """kubectl-drain shape: cordon, then evict (delete) every pod
        bound to the node. Returns the evicted pod objects — recreating
        replacements is the caller's (controller's) job, exactly as with
        a real drain."""
        from ..errors import NotFoundError

        self.cordon(name)
        evicted: List[obj.Pod] = []
        if delete_pods:
            for p in self.list_pods():
                if p.spec.node_name == name:
                    try:
                        self.store.delete("Pod", p.key)
                    except NotFoundError:
                        continue  # deleted concurrently: already gone
                    evicted.append(p)
        return evicted

    # ---- assertions ----------------------------------------------------

    def wait_for_pod_bound(self, name: str, namespace: str = "default",
                           timeout: float = 5.0) -> obj.Pod:
        """Reference sched.go:134-140: poll until the pod is bound."""
        ok = wait_until(
            lambda: bool(self.get_pod(name, namespace).spec.node_name), timeout)
        pod = self.get_pod(name, namespace)
        if not ok:
            raise AssertionError(
                f"pod {namespace}/{name} not bound within {timeout}s "
                f"(phase={pod.status.phase}, "
                f"unschedulable_plugins={pod.status.unschedulable_plugins})")
        # Event recording is asynchronous (state/events.py sink worker) and
        # the bind commit becomes visible BEFORE the binder enqueues the
        # Scheduled event — so wait for the pod's own event, not just a
        # queue drain, before scenarios assert on store Events.
        sched = self.service.scheduler
        if sched is not None:
            involved = f"Pod:{pod.key}"
            wait_until(
                lambda: any(e.reason == "Scheduled"
                            and e.involved_object == involved
                            for e in self.store.list("Event")), timeout=2.0)
        return pod

    def wait_for_pod_pending(self, name: str, namespace: str = "default",
                             timeout: float = 3.0) -> obj.Pod:
        """Reference sched.go:109-119: the pod must still be pending (and the
        scheduler must have *tried* — recorded rejecting plugins)."""
        wait_until(
            lambda: bool(self.get_pod(name, namespace).status.unschedulable_plugins),
            timeout)
        pod = self.get_pod(name, namespace)
        if pod.spec.node_name:
            raise AssertionError(
                f"pod {namespace}/{name} unexpectedly bound to {pod.spec.node_name}")
        if not pod.status.unschedulable_plugins:
            # Judged on the RE-FETCHED pod (an attempt landing just past
            # the wait deadline still counts) — and fail HERE with the
            # real story rather than letting a silent timeout surface as
            # a baffling empty unschedulable_plugins assert downstream.
            raise AssertionError(
                f"pod {namespace}/{name}: no scheduling attempt recorded "
                f"within {timeout}s (phase={pod.status.phase})")
        return pod


def run_scenario(scenario: Callable[[Cluster], None],
                 profile: ProfileSpec = None,
                 config: Optional[SchedulerConfig] = None) -> None:
    """Boot everything, run the scenario, tear down (reference main →
    start() → scenario(client), teardown deferred in reverse sched.go:40-60)."""
    cluster = Cluster()
    cluster.start(profile, config)
    try:
        scenario(cluster)
    finally:
        cluster.shutdown()


def default_scenario(c: Cluster) -> None:
    """The reference's built-in scenario (sched.go:70-143): nine
    unschedulable nodes, a pod that must stay pending with its rejecting
    plugin recorded, then node10 appears and the pod must bind to it."""
    for i in range(9):
        c.create_node(f"node{i}", unschedulable=True)
    c.create_pod("pod1")
    # Generous timeout: the first scheduling attempt builds the kernel.
    pod = c.wait_for_pod_pending("pod1", timeout=120.0)
    print(f"pod1 pending as expected "
          f"(unschedulable_plugins={pod.status.unschedulable_plugins})")
    c.create_node("node10")
    pod = c.wait_for_pod_bound("pod1", timeout=15.0)
    print(f"pod1 is bound to {pod.spec.node_name}")
    assert pod.spec.node_name == "node10"


if __name__ == "__main__":
    # Runs on the first CUDA device (SchedulerConfig.platform = "").
    run_scenario(default_scenario)
    print("scenario OK")

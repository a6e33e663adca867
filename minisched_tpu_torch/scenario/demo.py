"""Advanced-feature demo scenario: everything the rebuild adds beyond the
reference's README scenario, driven through the same user-facing API.

  1. a 3-zone cluster with labeled nodes,
  2. a deployment whose replicas carry a PodTopologySpread constraint —
     replicas land balanced across zones,
  3. an all-or-nothing gang (pod_group/pod_group_min) that must wait for
     quorum before ANY member binds (BASELINE config 5),
  4. explain mode: per-pod × per-node × per-plugin verdicts published as
     pod annotations (reference scheduler/plugin/resultstore capability),
     plus the full-N filter_verdict query beyond the top-k annotation,
  5. priority preemption: a critical pod evicts lower-priority pods from
     the only node with its scarce resource, with the freed capacity
     reserved via nominated_node_name (upstream DefaultPreemption).

Runs on the first CUDA device: ``python -m minisched_tpu_torch.scenario.demo``;
on the CPU: ``python -m minisched_tpu_torch.scenario.demo --platform cpu``.
"""
from __future__ import annotations

import argparse
import json

from ..config import SchedulerConfig
from ..service.defaultconfig import Profile
from ..state import objects as obj
from .runner import Cluster, wait_until

ZONE_KEY = "topology.kubernetes.io/zone"


def demo_scenario(c: Cluster) -> None:
    # -- 1. three zones, two nodes each --------------------------------
    for i in range(6):
        c.create_node(f"zone-node{i}", cpu=2000,
                      labels={ZONE_KEY: f"z{i % 3}"})

    # -- 2. spread-constrained deployment ------------------------------
    sel = obj.LabelSelector(match_labels={"app": "web"})
    spread = obj.TopologySpreadConstraint(
        max_skew=1, topology_key=ZONE_KEY,
        when_unsatisfiable="DoNotSchedule", label_selector=sel)
    c.create_objects([
        obj.Pod(metadata=obj.ObjectMeta(name=f"web-{i}", namespace="default",
                                        labels={"app": "web"}),
                spec=obj.PodSpec(requests={"cpu": 200},
                                 topology_spread_constraints=[spread]))
        for i in range(6)])
    zones = {f"z{i}": 0 for i in range(3)}  # count EVERY zone: a 3-3-0
    # split is a skew-3 violation a present-zones-only dict would hide
    for i in range(6):
        # Generous: the first scheduling attempt may build the kernels.
        p = c.wait_for_pod_bound(f"web-{i}", timeout=120)
        zones[c.get_node(p.spec.node_name).metadata.labels[ZONE_KEY]] += 1
    assert max(zones.values()) - min(zones.values()) <= 1, zones
    print(f"spread: 6 replicas balanced across zones "
          f"{dict(sorted(zones.items()))}")

    # -- 3. gang: no member binds below quorum -------------------------
    c.create_objects([
        obj.Pod(metadata=obj.ObjectMeta(name=f"trainer-{i}",
                                        namespace="default"),
                spec=obj.PodSpec(requests={"cpu": 100}, pod_group="train",
                                 pod_group_min=4))
        for i in range(3)])  # 3 members < quorum 4 → all park
    assert wait_until(lambda: all(
        c.get_pod(f"trainer-{i}").status.unschedulable_plugins
        for i in range(3)), timeout=20), "gang members never attempted"
    assert not any(c.get_pod(f"trainer-{i}").spec.node_name for i in range(3))
    print("gang: 3/4 members parked (quorum not met, none bound)")

    c.create_pod("trainer-3", cpu=100, pod_group="train", pod_group_min=4)
    for i in range(4):
        c.wait_for_pod_bound(f"trainer-{i}", timeout=20)
    print("gang: 4th member arrived — whole gang bound atomically")

    # -- 4. explain annotations ----------------------------------------
    from ..explain import annotation as ann

    ok = wait_until(lambda: ann.FILTER_RESULT_KEY in (
        c.get_pod("web-0").metadata.annotations or {}), timeout=10)
    assert ok, "explain annotations not recorded"
    verdicts = json.loads(
        c.get_pod("web-0").metadata.annotations[ann.FILTER_RESULT_KEY])
    some_node = next(iter(verdicts))
    print(f"explain: web-0 filter verdicts on {some_node}: "
          f"{verdicts[some_node]}")

    # Full-N coverage beyond the top-k annotation: any node is queryable.
    rs = c.service.result_store
    rs.drain(timeout=10)
    any_node = next(n.metadata.name for n in c.list_nodes())
    v = rs.filter_verdict("default/web-0", any_node)
    print(f"explain: full-N verdict for web-0 on {any_node}: {v}")

    # -- 5. priority preemption ----------------------------------------
    # the only accelerator node is full of low-priority batch pods; a
    # critical pod needing all 4 chips must evict them
    c.create_node("edge-node", cpu=1000, accelerator=4)
    c.create_objects([obj.Pod(
        metadata=obj.ObjectMeta(name=f"batch-{i}", namespace="default"),
        spec=obj.PodSpec(requests={"cpu": 100, "accelerator": 2},
                         priority=1)) for i in range(2)])
    for i in range(2):
        c.wait_for_pod_bound(f"batch-{i}", timeout=20)
    c.create_objects([obj.Pod(
        metadata=obj.ObjectMeta(name="critical", namespace="default"),
        spec=obj.PodSpec(requests={"cpu": 100, "accelerator": 4},
                         priority=1000))])
    crit = c.wait_for_pod_bound("critical", timeout=30)
    evicted = [e.message for e in c.store.list("Event")
               if e.reason == "Preempted"]
    print(f"preemption: critical bound to {crit.spec.node_name} "
          f"(nominated {crit.status.nominated_node_name}); "
          f"evicted: {evicted}")
    print("demo OK")


def main(platform: str = "") -> None:
    """The demo on ``platform`` (SchedulerConfig.platform: "" = the
    first CUDA device, "cpu" = the CPU)."""
    c = Cluster()
    c.start(profile=Profile(plugins=[
                "NodeUnschedulable", "NodeResourcesFit",
                "NodeResourcesLeastAllocated", "PodTopologySpread",
                "DefaultPreemption"]),
            config=SchedulerConfig(explain=True, backoff_initial_s=0.05,
                                   backoff_max_s=0.3, max_batch_size=32,
                                   batch_window_s=0.05, platform=platform))
    try:
        demo_scenario(c)
    finally:
        c.shutdown()


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--platform", default="",
                    help='"" (the first CUDA device, the default) or "cpu"')
    main(ap.parse_args().platform)

"""Scheduler profiles and the plugin registry.

A profile is declarative: {plugin name: enabled/weight/args}. The
reference's live profile is NodeUnschedulable filter + NodeNumber
score/permit (reference minisched/initialize.go:185-186); the registry
holds the plugins this package implements.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Union

from ..plugins.base import BatchedPlugin, PluginSet
from ..plugins.imagelocality import ImageLocality
from ..plugins.interpodaffinity import InterPodAffinity
from ..plugins.nodeaffinity import NodeAffinity
from ..plugins.nodename import NodeName
from ..plugins.nodenumber import NodeNumber
from ..plugins.nodeports import NodePorts
from ..plugins.nodepreferavoidpods import NodePreferAvoidPods
from ..plugins.noderesources import (NodeResourcesBalancedAllocation,
                                     NodeResourcesFit,
                                     NodeResourcesLeastAllocated,
                                     NodeResourcesMostAllocated)
from ..plugins.nodeunschedulable import NodeUnschedulable
from ..plugins.podtopologyspread import PodTopologySpread
from ..plugins.selectorspread import SelectorSpread
from ..plugins.tainttoleration import TaintToleration

# Registry of plugin factories by name (reference plugin.NewRegistry).
_REGISTRY: Dict[str, Callable[..., BatchedPlugin]] = {
    "NodeUnschedulable": NodeUnschedulable,
    "NodeNumber": NodeNumber,
    "NodePorts": NodePorts,
    "NodeResourcesFit": NodeResourcesFit,
    "NodeResourcesLeastAllocated": NodeResourcesLeastAllocated,
    "NodeResourcesMostAllocated": NodeResourcesMostAllocated,
    "NodeResourcesBalancedAllocation": NodeResourcesBalancedAllocation,
    "PodTopologySpread": PodTopologySpread,
    "InterPodAffinity": InterPodAffinity,
    "SelectorSpread": SelectorSpread,
    "TaintToleration": TaintToleration,
    "NodeAffinity": NodeAffinity,
    "NodeName": NodeName,
    "ImageLocality": ImageLocality,
    "NodePreferAvoidPods": NodePreferAvoidPods,
}

# Plugins of the JAX package's registry that this package does not have
# yet, with the slice of the port that brings them.
_NOT_YET = {
    **{n: "the volume slice (with the engine's volume state and RWO "
          "arbitration)"
       for n in ("VolumeBinding", "VolumeRestrictions", "VolumeZone",
                 "NodeVolumeLimits", "EBSLimits", "GCEPDLimits",
                 "AzureDiskLimits", "CinderLimits")},
    "DefaultPreemption": "the preemption slice (ops/preempt.py and the "
                         "PostFilter)",
}


def registered_plugins() -> List[str]:
    return sorted(_REGISTRY)


def make_plugin(name: str, **args) -> BatchedPlugin:
    try:
        factory = _REGISTRY[name]
    except KeyError:
        if name in _NOT_YET:
            raise KeyError(f"plugin {name!r} is not ported yet; it comes "
                           f"with {_NOT_YET[name]}") from None
        raise KeyError(f"unknown plugin {name!r}; registered: "
                       f"{registered_plugins()}") from None
    return factory(**args)


def _resolve_args(v: Union[dict, str, None]) -> dict:
    """Plugin args as factory kwargs: a dict, a JSON string, or None."""
    if v is None:
        return {}
    if isinstance(v, str):
        return json.loads(v)
    return dict(v)


@dataclass
class Profile:
    """One scheduling profile: enabled plugins, weights, per-plugin args.
    ``score_disabled``/``filter_disabled`` disable ONE extension point of
    a multi-point plugin; ``disabled`` removes the plugin entirely."""

    name: str = "default-scheduler"
    plugins: List[str] = field(
        default_factory=lambda: ["NodeUnschedulable", "NodeNumber"])
    disabled: List[str] = field(default_factory=list)
    weights: Dict[str, float] = field(default_factory=dict)
    plugin_args: Dict[str, dict] = field(default_factory=dict)
    score_disabled: List[str] = field(default_factory=list)
    filter_disabled: List[str] = field(default_factory=list)

    def build(self) -> PluginSet:
        instances = []
        for n in self.plugins:
            if n in self.disabled:
                continue
            inst = make_plugin(n, **_resolve_args(self.plugin_args.get(n)))
            if n in self.score_disabled:
                inst.score_active = False
            if n in self.filter_disabled:
                inst.filter_active = False
            instances.append(inst)
        return PluginSet(instances, self.weights)


def default_scheduler_profile() -> Profile:
    """The reference's live configuration (minisched/initialize.go:185-186):
    NodeUnschedulable filter + NodeNumber score/permit."""
    return Profile()


def default_plugin_set(**overrides) -> PluginSet:
    prof = default_scheduler_profile()
    for k, v in overrides.items():
        setattr(prof, k, v)
    return prof.build()

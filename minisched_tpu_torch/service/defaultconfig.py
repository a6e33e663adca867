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
from ..plugins.nodevolumelimits import (AzureDiskLimits, CinderLimits,
                                        EBSLimits, GCEPDLimits,
                                        NodeVolumeLimits)
from ..plugins.podtopologyspread import PodTopologySpread
from ..plugins.preemption import DefaultPreemption
from ..plugins.selectorspread import SelectorSpread
from ..plugins.tainttoleration import TaintToleration
from ..plugins.volumebinding import VolumeBinding
from ..plugins.volumerestrictions import VolumeRestrictions
from ..plugins.volumezone import VolumeZone

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
    "VolumeBinding": VolumeBinding,
    "VolumeRestrictions": VolumeRestrictions,
    "VolumeZone": VolumeZone,
    "NodeVolumeLimits": NodeVolumeLimits,
    "EBSLimits": EBSLimits,
    "GCEPDLimits": GCEPDLimits,
    "AzureDiskLimits": AzureDiskLimits,
    # Registered but, as upstream, in no default list below: Cinder gates
    # only cinder-typed volumes; profiles opt in by name (SelectorSpread
    # likewise).
    "CinderLimits": CinderLimits,
    "DefaultPreemption": DefaultPreemption,
}


def registered_plugins() -> List[str]:
    return sorted(_REGISTRY)


def make_plugin(name: str, **args) -> BatchedPlugin:
    try:
        factory = _REGISTRY[name]
    except KeyError:
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


# The upstream v1beta2 default filter and score plugin lists the reference
# wraps one for one (reference scheduler/defaultconfig/defaultconfig.go:
# 17-33).
DEFAULT_FILTER_PLUGINS: List[str] = [
    "NodeUnschedulable", "NodeName", "TaintToleration", "NodeAffinity",
    "NodePorts", "NodeResourcesFit", "VolumeRestrictions", "EBSLimits",
    "GCEPDLimits", "NodeVolumeLimits", "AzureDiskLimits", "VolumeBinding",
    "VolumeZone", "PodTopologySpread", "InterPodAffinity",
]
DEFAULT_SCORE_PLUGINS: List[tuple] = [  # (name, default profile weight)
    ("NodeResourcesBalancedAllocation", 1.0), ("ImageLocality", 1.0),
    ("InterPodAffinity", 1.0), ("NodeResourcesFit", 1.0),
    ("NodeAffinity", 1.0), ("PodTopologySpread", 2.0),
    ("TaintToleration", 1.0),
]


def full_scheduler_profile() -> Profile:
    """Every upstream default plugin enabled with default weights (one
    plugin instance covers both extension points where upstream lists it
    in both), and upstream's default PostFilter, DefaultPreemption."""
    plugins = list(DEFAULT_FILTER_PLUGINS)
    for name, _w in DEFAULT_SCORE_PLUGINS:
        if name not in plugins:
            plugins.append(name)
    plugins.append("DefaultPreemption")
    return Profile(name="full-scheduler", plugins=plugins,
                   weights={n: w for n, w in DEFAULT_SCORE_PLUGINS})


def default_scheduler_profile() -> Profile:
    """The reference's live configuration (minisched/initialize.go:185-186):
    NodeUnschedulable filter + NodeNumber score/permit."""
    return Profile()


def default_plugin_set(**overrides) -> PluginSet:
    prof = default_scheduler_profile()
    for k, v in overrides.items():
        setattr(prof, k, v)
    return prof.build()

"""Scheduler configuration: multi-profile conversion + plugin-args merging.

Analog of the reference's KubeSchedulerConfiguration machinery:

  * ``SchedulerConfiguration`` — the top-level config object
    (v1beta2.KubeSchedulerConfiguration): named profiles + non-profile
    fields.
  * ``convert_configuration_for_simulator`` — the conversion at
    reference scheduler/scheduler.go:97-142: (1) only changes to
    Profiles.Plugins are accepted (every non-profile field is reset to its
    default); (2) each profile's filter/score enabled sets are replaced by
    the wrapped default sets minus the profile's disabled entries
    (plugin.ConvertForSimulator, plugins.go:146-202); (3) plugin args are
    merged over the defaulted PluginConfig (plugin.NewPluginConfig,
    plugins.go:77-141). Exercised by the 8 table cases at
    scheduler_test.go:278-369 (held against the JAX package's conversion
    in tests/test_torch_service_config.py).
  * ``PluginArgs``/``resolve_args`` — the Raw-vs-Object contract of
    NewPluginConfig: args may arrive as a JSON string (Raw) or a structured
    dict (Object); when both are set, Object wins (plugins.go:73-75,98-107).
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Union

from .defaultconfig import (DEFAULT_FILTER_PLUGINS, DEFAULT_SCORE_PLUGINS,
                            Profile)

DEFAULT_SCHEDULER_NAME = "default-scheduler"


@dataclass
class PluginArgs:
    """Per-plugin args in the two upstream encodings (runtime.RawExtension):
    ``raw`` is a JSON string, ``object`` a structured dict. Object takes
    precedence when both are set (reference plugins.go:98-107)."""

    raw: Optional[str] = None
    object: Optional[dict] = None

    def resolve(self) -> dict:
        out: dict = {}
        if self.raw:
            out.update(json.loads(self.raw))
        if self.object is not None:
            out = dict(self.object)
        return out


def resolve_args(v: Union[dict, str, PluginArgs, None]) -> dict:
    """Normalize any accepted args encoding to kwargs for the factory."""
    if v is None:
        return {}
    if isinstance(v, PluginArgs):
        return v.resolve()
    if isinstance(v, str):
        return json.loads(v)
    return dict(v)


# The defaulted PluginConfig the reference merges user args over
# (plugins.go:83-88 reads DefaultSchedulerConfig().Profiles[0].PluginConfig;
# these are the rebuild's factory-arg equivalents of the upstream defaulted
# args objects for the plugins that HAVE defaulted args).
DEFAULT_PLUGIN_ARGS: Dict[str, dict] = {
    # upstream NodeResourcesFitArgs{ScoringStrategy: LeastAllocated,
    # Resources: cpu+memory}
    "NodeResourcesFit": {"score_strategy": "LeastAllocated",
                         "resources": ("cpu", "memory")},
    # upstream NodeResourcesBalancedAllocationArgs{Resources: cpu+memory}
    "NodeResourcesBalancedAllocation": {"resources": ("cpu", "memory")},
}


def new_plugin_config(user: Optional[Dict[str, Any]]) -> Dict[str, dict]:
    """Merge user plugin args over the defaulted PluginConfig (reference
    NewPluginConfig, plugins.go:77-141): defaults for every plugin with
    defaulted args are always present; user entries override per key;
    PluginArgs.object beats .raw."""
    merged = {name: dict(args) for name, args in DEFAULT_PLUGIN_ARGS.items()}
    for name, v in (user or {}).items():
        base = merged.setdefault(name, {})
        base.update(resolve_args(v))
    return merged


@dataclass
class SchedulerConfiguration:
    """Top-level scheduler config (v1beta2.KubeSchedulerConfiguration).
    Non-profile fields exist to prove the conversion contract: they are
    RESET to defaults by convert_configuration_for_simulator, mirroring
    "we accept only changes to Profiles" (scheduler.go:94-95,126-131)."""

    profiles: List[Profile] = field(default_factory=list)
    parallelism: int = 16            # upstream default; ignored by minisched
    percentage_of_nodes_to_score: int = 0  # upstream default (adaptive)


def convert_profile_for_simulator(p: Profile) -> Profile:
    """Per-profile conversion (reference plugin.ConvertForSimulator,
    plugins.go:146-202): the enabled filter/score sets become the DEFAULT
    sets minus the profile's disabled entries. Disabling "*" keeps the
    user's own enabled list for that extension point instead (the
    reference keeps the DeepCopy'd user list when "*" is disabled)."""
    full_off = set(p.disabled)
    f_off = set(p.filter_disabled) | full_off
    s_off = set(p.score_disabled) | full_off

    if "*" in f_off:
        filters = [n for n in p.plugins]
    else:
        filters = [n for n in DEFAULT_FILTER_PLUGINS if n not in f_off]
    if "*" in s_off:
        scores = [n for n in p.plugins]
        weights = dict(p.weights)
    else:
        scores = [n for n, _w in DEFAULT_SCORE_PLUGINS if n not in s_off]
        weights = {n: w for n, w in DEFAULT_SCORE_PLUGINS if n not in s_off}

    plugins: List[str] = []
    for n in filters + scores:
        if n not in plugins:
            plugins.append(n)
    return Profile(
        name=p.name,
        plugins=plugins,
        weights=weights,
        plugin_args=new_plugin_config(p.plugin_args),
        filter_disabled=sorted(set(plugins) - set(filters)),
        score_disabled=sorted(set(plugins) - set(scores)),
    )


def convert_configuration_for_simulator(
        cfg: SchedulerConfiguration) -> SchedulerConfiguration:
    """reference convertConfigurationForSimulator (scheduler.go:97-142):
    empty Profiles get one default profile; each profile's Plugins are
    converted; every non-profile field is reset to its default value."""
    profiles = cfg.profiles or [
        Profile(name=DEFAULT_SCHEDULER_NAME, plugins=[])]
    return SchedulerConfiguration(
        profiles=[convert_profile_for_simulator(p) for p in profiles])

"""Snapshot restore's decoder: ``from_dict(kind, d)`` for the kinds a
snapshot holds, through the compiled codec (state/codec.py) — a
50k-node restore decodes every object, and restore time is the
restart-to-first-batch cost."""
from __future__ import annotations

from typing import Any, Dict

from . import objects as obj
from .codec import build

_KIND_TYPES = {
    "Pod": obj.Pod,
    "Node": obj.Node,
    "PersistentVolume": obj.PersistentVolume,
    "PersistentVolumeClaim": obj.PersistentVolumeClaim,
    "Event": obj.Event,
    "PodDisruptionBudget": obj.PodDisruptionBudget,
}


def from_dict(kind: str, d: Dict[str, Any]) -> Any:
    return build(_KIND_TYPES[kind], d)

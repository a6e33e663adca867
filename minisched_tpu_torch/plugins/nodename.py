"""NodeName filter: pod.spec.required_node_name must equal the node's name
(upstream nodename plugin, wrapped by the reference's simulator registry at
scheduler/plugin/plugins.go:24-70)."""
from __future__ import annotations

import torch

from .base import BatchedPlugin


class NodeName(BatchedPlugin):
    name = "NodeName"
    column_local = True  # per-column name-hash equality

    def filter(self, pf, nf, ctx) -> torch.Tensor:
        wanted = pf.required_node[:, None]
        return (wanted == 0) | (wanted == nf.name_hash[None, :])

"""The cross-shard operations of the sharded step, behind one interface.

GSPMD inserts these in the JAX package; here the sharded step and the
sharded assignment call them by name, so the same code runs on a mesh
in one process and on a hybrid mesh across processes.

  * Along "node" (always inside one process): ``node_all_gather`` (cat
    of the shards' blocks), ``node_max`` / ``node_min`` (pmax / pmin)
    and ``node_sum`` (psum). Max and min are exact in any order; the
    sums the step takes are of integer-valued counts below 2**24, exact
    in any order too, and are added in shard order all the same.
  * Along "pod": ``pod_all_gather`` (the pod-split leaves of the
    decision, the gathered score rows of the auction) and
    ``pod_broadcast`` (the chunk gather's owner row, which the JAX
    package writes as a psum of zeros over the non-owners; a broadcast
    moves the owner's bits, so a -0.0 stays -0.0).

``InProcessCollectives`` holds every pod row in this process: the pod
axis is a cat, the owner's row is local. ``DistCollectives`` runs the
pod axis over a ``torch.distributed`` group, one pod row per rank (the
multi-process dryrun, parallel/dcn_dryrun.py). Over gloo, an operation
the installed build does not take on CUDA tensors is staged through
host buffers here, explicitly (``staged``): that is the transport of
the pod axis, and every step computation stays on its device. A failed
collective raises.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch


class InProcessCollectives:
    """Every mesh position in this process."""

    kind = "in-process"

    def __init__(self, mesh):
        self.mesh = mesh
        self.rank = 0
        self.staged: List[str] = []

    # -- node axis ---------------------------------------------------------

    def node_all_gather(self, parts: List[torch.Tensor], dim: int,
                        device) -> torch.Tensor:
        """The node shards' blocks concatenated along ``dim`` on
        ``device``."""
        if len(parts) == 1:
            return parts[0].to(device)
        return torch.cat([p.to(device) for p in parts], dim=dim)

    def _fold(self, parts, device, op) -> torch.Tensor:
        acc = parts[0].to(device)
        for p in parts[1:]:
            acc = op(acc, p.to(device))
        return acc

    def node_max(self, parts: List[torch.Tensor], device) -> torch.Tensor:
        return self._fold(parts, device, torch.maximum)

    def node_min(self, parts: List[torch.Tensor], device) -> torch.Tensor:
        return self._fold(parts, device, torch.minimum)

    def node_sum(self, parts: List[torch.Tensor], device) -> torch.Tensor:
        """Sum in shard order; callers pass integer-valued counts."""
        return self._fold(parts, device, torch.add)

    # -- pod axis ----------------------------------------------------------

    def pod_all_gather(self, rows: Dict[int, torch.Tensor], dim: int,
                       device) -> torch.Tensor:
        """Every pod row's tensor concatenated along ``dim`` in row
        order, on ``device``."""
        return torch.cat([rows[i].to(device) for i in sorted(rows)],
                         dim=dim)

    def pod_broadcast(self, owner: int, value: Optional[torch.Tensor],
                      shape, dtype, device) -> torch.Tensor:
        """The owner pod row's tensor on every row (here: local)."""
        return value.to(device)


class DistCollectives(InProcessCollectives):
    """The pod axis over a ``torch.distributed`` group (one pod row per
    rank); the node axis stays in-process."""

    kind = "torch.distributed"

    def __init__(self, mesh):
        import torch.distributed as dist

        super().__init__(mesh)
        self._dist = dist
        self.group = mesh.group
        self.rank = dist.get_rank(self.group)
        self.world = dist.get_world_size(self.group)
        self.backend = str(dist.get_backend(self.group))
        self.staged = []
        dev = mesh.devices[self.rank, 0]
        if self.backend == "gloo" and dev.type == "cuda":
            self.staged = self._probe_gloo_cuda(dev)

    def _probe_gloo_cuda(self, device) -> List[str]:
        """The operations this gloo build refuses on CUDA tensors, tried
        once on a one-element tensor. Every rank probes in the same
        order, and gloo checks the device before it communicates, so a
        refusal is a local exception on every rank alike."""
        dist = self._dist
        staged = []
        t = torch.zeros((1,), dtype=torch.int32, device=device)
        for name, op in (
                ("all_gather", lambda: dist.all_gather(
                    [torch.empty_like(t) for _ in range(self.world)], t,
                    group=self.group)),
                ("broadcast", lambda: dist.broadcast(
                    t, src=self._global(0), group=self.group))):
            try:
                op()
                torch.cuda.synchronize(device)
            except (RuntimeError, ValueError):
                staged.append(name)
        return staged

    def _global(self, rank: int) -> int:
        dist = self._dist
        if self.group is None or self.group is dist.group.WORLD:
            return rank
        return dist.get_global_rank(self.group, rank)

    def pod_all_gather(self, rows: Dict[int, torch.Tensor], dim: int,
                       device) -> torch.Tensor:
        t = rows[self.rank].to(device).contiguous()
        stage = "all_gather" in self.staged and t.is_cuda
        src = t.cpu() if stage else t
        outs = [torch.empty_like(src) for _ in range(self.world)]
        self._dist.all_gather(outs, src, group=self.group)
        out = torch.cat(outs, dim=dim)
        return out.to(device) if stage else out

    def pod_broadcast(self, owner: int, value: Optional[torch.Tensor],
                      shape, dtype, device) -> torch.Tensor:
        if owner == self.rank:
            buf = value.to(device).contiguous()
        else:
            buf = torch.empty(tuple(shape), dtype=dtype, device=device)
        stage = "broadcast" in self.staged and buf.is_cuda
        host = buf.cpu() if stage else buf
        self._dist.broadcast(host, src=self._global(owner),
                             group=self.group)
        return host.to(device) if stage else host


def make_collectives(mesh):
    if mesh.group is None:
        return InProcessCollectives(mesh)
    return DistCollectives(mesh)

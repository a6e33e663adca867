"""Mesh-scalable capacity-aware assignment: the chunked-gather greedy
scan.

The greedy assignment is sequential over pods: each pod's pick needs its
whole score row and the free matrix every earlier pod debited. On a
("pod", "node") mesh the (P, N) score matrix is the one large array and
stays cut over both axes; the requests, the free matrix and the gang
vectors are small and replicated. The scan runs over P/C chunks of C
rows:

  * a chunk's (C, N_local) blocks are gathered from the owner pod row
    (``pod_broadcast``) across the node axis (``node_all_gather``) into
    one (C, N) block: two collectives per C rows, the score matrix moved
    once per attempt, the least exact sequential greedy needs;
  * the block runs through ``select.greedy_assign`` on the replicated
    free matrix: one launch of the greedy kernel (csrc/greedy_assign.cu)
    per chunk on a card, its plain version on the CPU, with the seed
    shifted to the chunk's first row (``greedy_kernel.chunk_seed``), so
    every pod draws the tie noise of its global row; ``free`` is carried
    on the device from one launch to the next. The decisions equal one
    greedy launch over the whole batch, bit for bit;
  * ``ops/gang.gang_admission`` wraps every attempt, and a gang
    re-attempt gathers the chunks again.

C divides the pod-shard size, so every chunk has exactly one owner row
along the pod axis.
"""
from __future__ import annotations

import torch

from ..ops import prng
from ..ops.gang import gang_admission
from ..ops.greedy_kernel import chunk_seed
from ..ops.select import NEG, AssignResult, greedy_assign
from .mesh import NODE_AXIS, POD_AXIS, Sharding, ShardedTensor, put


def _chunk_size(p_local: int, target: int = 128) -> int:
    """Largest divisor of the pod-shard size ≤ target."""
    c = min(target, p_local)
    while p_local % c:
        c -= 1
    return max(c, 1)


def make_sharded_assign(mesh, observe=None):
    """``assign_fn(scores, requests, free0, group_ids, group_min, key,
    has_gang=None, priority=None) -> GangResult``, the assignment stage
    of ``ops/pipeline.build_step`` on a ("pod", "node") mesh. ``scores``
    is the (P, N) masked total, a ``ShardedTensor`` cut ("pod", "node")
    or a whole tensor (cut here); the other inputs are whole.
    ``priority`` is unused: the scan's rows are already in priority
    order. ``observe(c, block, requests, free_in, seed, result)``, when
    given, sees each chunk's launch (its inputs and its AssignResult)."""
    pax = mesh.shape[POD_AXIS]
    nax = mesh.shape[NODE_AXIS]
    coll = mesh.collectives
    local_rows = set(mesh.local_pod_rows())
    both = Sharding(mesh, (POD_AXIS, NODE_AXIS))

    def assign(scores, requests, free0, group_ids, group_min, key,
               has_gang=None, priority=None):
        if not isinstance(scores, ShardedTensor):
            scores = put(scores, both)
        p_tot, n = scores.shape
        p_local = p_tot // pax
        C = _chunk_size(p_local)
        dev = mesh.device
        requests = requests.to(dev)
        free0 = free0.to(dev)
        seed = prng.bits(key)

        def gather(c: int) -> torch.Tensor:
            owner, off = divmod(c * C, p_local)
            blk = None
            if owner in local_rows:
                blk = coll.node_all_gather(
                    [scores.block(owner, j)[off:off + C]
                     for j in range(nax)], 1, dev)
            return coll.pod_broadcast(owner, blk, (C, n), torch.float32,
                                      dev)

        def attempt_fn(pod_ok: torch.Tensor) -> AssignResult:
            free = free0
            chosen = torch.empty((p_tot,), dtype=torch.int32, device=dev)
            assigned = torch.empty((p_tot,), dtype=torch.bool, device=dev)
            for c in range(p_tot // C):
                rows = slice(c * C, (c + 1) * C)
                # Rows the gang admission has not admitted score NEG, as
                # ops/gang.gang_assign masks them.
                blk = torch.where(pod_ok[rows, None], gather(c), NEG)
                seed_c = chunk_seed(seed, c * C)
                r = greedy_assign(blk, requests[rows], free, seed_c)
                if observe is not None:
                    observe(c, blk, requests[rows], free, seed_c, r)
                chosen[rows] = r.chosen
                assigned[rows] = r.assigned
                free = r.free_after
            return AssignResult(chosen, assigned, free)

        return gang_admission(attempt_fn, group_ids.to(dev),
                              group_min.to(dev), has_gang)

    return assign

"""Host selection: capacity-aware greedy assignment of one batch.

Two pods of one batch may both want the same scarce capacity, so pods
are assigned one after another in row (priority) order, each against the
free-resource matrix that all earlier pods of the batch have already
debited — exactly what a one-pod-at-a-time scheduler would have seen.

Ties among the best-scoring fitting nodes break on seeded noise: a
murmur3 finalizer of (seed, pod row, node column). The definition is the
JAX package's, bit for bit, so both packages pick the same node.

``greedy_assign``, ``shortlist_select`` and ``greedy_assign_shortlist``
dispatch on the device of their inputs: CPU tensors take the plain
PyTorch versions below, CUDA tensors the hand-written kernels
(ops/greedy_kernel.py, ops/select_kernel.py, ops/shortlist_kernel.py),
which raise rather than fall back. ``greedy_assign_shortlist_lanes`` is
the lane form the fused tenant step runs: T independent batches of one
shape, each with its own seed, in one selection launch and one scan
launch (the JAX package's ``jax.vmap`` of the selection and the scan).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .spreadcap import caps_mask, caps_update

NEG = -3.0e38  # effectively -inf for masked scores (exact in float32)

GOLDEN = 0x9E3779B9
_COL_MULT = 0x85EBCA77
_M32 = 0xFFFFFFFF


def fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer on u32 values held in int64 (PyTorch's CPU
    kernels have no u32 add or shift, so every step re-masks to 32
    bits)."""
    x = x ^ (x >> 16)
    x = (x * 0x85EBCA6B) & _M32
    x = x ^ (x >> 13)
    x = (x * 0xC2B2AE35) & _M32
    x = x ^ (x >> 16)
    return x


def tie_noise_from_cols(seed: int, i, cols: torch.Tensor) -> torch.Tensor:
    """Counter-based uniform noise in [0,1): fmix32 of (seed + i*golden)
    + column index, as float32. ``i`` is an int or an int tensor that
    broadcasts against ``cols`` (int64 column indices)."""
    x = (cols * _COL_MULT + seed + (i * GOLDEN) % (1 << 32)) & _M32
    x = fmix32(x)
    # x>>8 < 2^24: exact in float32, and the power-of-two scale is exact.
    return (x >> 8).to(torch.float32) * (1.0 / (1 << 24))


def fma_f32(a: torch.Tensor, b: torch.Tensor,
            c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` of float32 tensors rounded once, as a fused
    multiply-add does, on any device. The product is exact in float64;
    the sum is rounded to float64 with round-to-odd (TwoSum gives its
    error, and an inexact even result steps one ulp toward the error),
    which makes the final rounding to float32 correct (53 >= 24 + 2)."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bp = s - p
    err = (p - (s - bp)) + (c - bp)
    even = (s.view(torch.int64) & 1) == 0
    s = torch.where((err != 0) & even,
                    torch.nextafter(s, s + err), s)
    return s.float()


def tie_noise(seed: int, i, n: int, device=None) -> torch.Tensor:
    return tie_noise_from_cols(
        seed, i, torch.arange(n, dtype=torch.int64, device=device))


class AssignResult(NamedTuple):
    chosen: torch.Tensor      # (P,) int32 node row, -1 if unassigned
    assigned: torch.Tensor    # (P,) bool
    free_after: torch.Tensor  # (N,R) float32 remaining free resources


def _full_row_pick(srow: torch.Tensor, req: torch.Tensor,
                   free: torch.Tensor, seed: int, i: int, cols,
                   mask=None):
    """One pod's pick over the whole row: among nodes whose free row
    covers ``req`` on every axis (and that ``mask`` allows), the largest
    score, then the largest tie noise, then the smallest column. Returns
    (column, ok) with ok False when no fitting node scores above NEG."""
    fits = (free >= req[None, :]).all(dim=1)
    if mask is not None:
        fits &= mask
    s = torch.where(fits, srow, NEG)
    m = s.max()
    if not bool(m > NEG):
        return -1, False
    noise = tie_noise_from_cols(seed, i, cols)
    key = torch.where((s >= m) & fits, noise, -1.0)
    return int(cols[key == key.max()].min()), True


def greedy_assign_plain(scores: torch.Tensor, requests: torch.Tensor,
                        free0: torch.Tensor, seed: int,
                        caps=None) -> AssignResult:
    """The plain PyTorch version of the greedy-assignment kernel and,
    with ``caps``, of the caps scan kernel (ops/caps_kernel.py).

    scores:   (P,N) float32 with NEG on infeasible pairs
    requests: (P,R) float32 per-pod resource requests
    free0:    (N,R) float32 free resources entering the batch
    seed:     the batch's u32 tie-break seed (ops/prng.bits)
    caps:     optional ops/spreadcap.DomainCaps, the running
              per-(group, domain) counts of the hard-spread skew caps

    Per pod: among nodes whose free resources cover the request on every
    axis, take the largest score, then the largest tie noise, then the
    smallest column; assign when that score is above NEG and debit the
    node's free row by the request. With ``caps``, the fitting nodes are
    further masked by ``caps_mask`` against the counts as the earlier
    pods of the batch left them, and each assignment adds one to the
    chosen node's domain in every group the pod matches
    (``caps_update``): the JAX package's ``greedy_assign(caps=...)``.
    """
    counts = None if caps is None else caps.counts0.clone()
    P, N = scores.shape
    device = scores.device
    free = free0.clone()
    cols = torch.arange(N, dtype=torch.int64, device=device)
    chosen = torch.full((P,), -1, dtype=torch.int32, device=device)
    assigned = torch.zeros((P,), dtype=torch.bool, device=device)
    for i in range(P):
        mask = None if caps is None else caps_mask(caps, counts, i)
        idx, ok = _full_row_pick(scores[i], requests[i], free, seed, i, cols,
                                 mask=mask)
        if ok:
            free[idx] = free[idx] - requests[i]
            chosen[i] = idx
            assigned[i] = True
            if caps is not None:
                counts = caps_update(caps, counts, i, idx)
    return AssignResult(chosen, assigned, free)


def greedy_assign(scores: torch.Tensor, requests: torch.Tensor,
                  free0: torch.Tensor, seed: int, caps=None) -> AssignResult:
    """Assign pods to nodes in row order (the caller pre-sorts rows by
    priority). ``caps`` (ops/spreadcap.DomainCaps) masks each pod's
    choice by the hard-spread skew of the running domain counts. CPU
    tensors run the plain versions; CUDA tensors launch the hand-written
    kernels (the greedy kernel, or with ``caps`` the caps scan kernel)."""
    if scores.device.type == "cpu":
        return greedy_assign_plain(scores, requests, free0, seed, caps)
    if caps is not None:
        from .caps_kernel import caps_scan_cuda

        return caps_scan_cuda(scores, requests, free0, seed, caps)
    from .greedy_kernel import greedy_assign_cuda

    return greedy_assign_cuda(scores, requests, free0, seed)


class ShortlistAssignResult(NamedTuple):
    """AssignResult plus the repair ledger of a certified shortlist
    scan."""

    chosen: torch.Tensor      # (P,) int32 node row, -1 if unassigned
    assigned: torch.Tensor    # (P,) bool
    free_after: torch.Tensor  # (N,R) float32 remaining free resources
    repaired: torch.Tensor    # (P,) bool — the step fell back to a
    #                           full-row rescan (the certificate could not
    #                           prove the true argmax was in the shortlist)


_NOISE_ONE = 1 << 24  # the noise key of 2.0 in the plain selection's key2


def order_key(x: torch.Tensor) -> torch.Tensor:
    """float32 values as int32 keys in lax.top_k's total order: the bits
    of a negative float with the 31 low bits flipped, so -0.0 (key -1)
    sorts below +0.0 (key 0). Its own inverse on int32 keys."""
    b = x.view(torch.int32) if x.dtype == torch.float32 else x
    return torch.where(b < 0, b ^ 0x7FFFFFFF, b)


def shortlist_select_plain(scores: torch.Tensor, seed: int, k: int):
    """Per-pod top-K candidate shortlists, ordered by (score, tie noise)
    — the order the greedy scan consults — plus the certification bound.
    The plain PyTorch version of the selection kernel
    (ops/select_kernel.py).

    Returns ``(cand (P,K) int32 node columns, kth (P,) float32,
    kth_noise (P,) float32)``: ``kth`` is the K-th largest score, and
    every node outside the shortlist is lexicographically at most
    ``(kth, kth_noise)``.

    Two top-k passes, as the JAX package's lax.top_k pair:
      1. ``kth`` = the K-th largest raw score in lax.top_k's total order
         (+0.0 above -0.0): the first pass runs over ``order_key`` of the
         scores and maps the K-th key back to its float. At most K-1
         nodes score above it (float compare), so all of them are in the
         shortlist.
      2. a composite key — 2.0 for score > kth, the node's tie noise for
         score == kth (float compares, as in JAX), -1 otherwise — whose
         top K fills the remaining slots with the boundary nodes of
         largest noise. At least K nodes score >= kth and at most K-1
         above it, so the K-th composite key is always a boundary node's
         noise: that is ``kth_noise``.

    ``torch.topk`` breaks ties among equal keys differently from
    ``lax.top_k`` (which takes the lower index first), so the second
    pass runs over a unique int64 key: the composite key as an exact
    integer (2.0 → 2^24, noise → its 24-bit integer x >> 8, -1 → -1)
    shifted up 32 bits, with 0xFFFFFFFF - column below. Its descending
    order is (key descending, column ascending), lax.top_k's order, so
    ``cand`` equals the JAX package's column for column.
    """
    P, N = scores.shape
    device = scores.device
    kkey = torch.topk(order_key(scores), k, dim=1).values[:, -1]
    kth = order_key(kkey).view(torch.float32).contiguous()
    cols = torch.arange(N, dtype=torch.int64, device=device)[None, :]
    rows = torch.arange(P, dtype=torch.int64, device=device)[:, None]
    # The noise lattice as 24-bit integers (int64 masked to 32 bits: the
    # CPU has no u32 add or shift); as float it is key * 2^-24 exactly.
    x = (cols * _COL_MULT + seed + (rows * GOLDEN) % (1 << 32)) & _M32
    key2 = fmix32(x) >> 8
    del x
    kcol = kth[:, None]
    key2 = torch.where(scores > kcol, _NOISE_ONE,
                       torch.where(scores == kcol, key2, -1))
    key2 = key2 * (1 << 32) + (_M32 - cols)
    top = torch.topk(key2, k, dim=1)
    del key2
    cand = top.indices.to(torch.int32)
    kth_noise = ((top.values[:, -1] >> 32).to(torch.float32)
                 * (1.0 / (1 << 24)))
    return cand, kth, kth_noise


def shortlist_select(scores: torch.Tensor, seed: int, k: int):
    """``shortlist_select_plain``'s contract on any device: CPU tensors
    take the plain version, CUDA tensors the hand-written selection
    kernel (ops/select_kernel.py), which raises rather than fall back."""
    if scores.device.type == "cpu":
        return shortlist_select_plain(scores, seed, k)
    from .select_kernel import shortlist_select_cuda

    return shortlist_select_cuda(scores, seed, k)[:3]


def greedy_assign_shortlist_plain(scores: torch.Tensor,
                                  requests: torch.Tensor,
                                  free0: torch.Tensor, seed: int,
                                  cand: torch.Tensor, kth: torch.Tensor,
                                  kth_noise: torch.Tensor
                                  ) -> ShortlistAssignResult:
    """The plain PyTorch version of the shortlist scan kernel: the
    certified K-wide greedy scan over ``shortlist_select``'s output.

    Per pod, in row order: gather the candidates' free rows; among the
    fitting candidates take m = the best score, wn = the best noise at
    m, win = the smallest column at (m, wn). The step is certified when
    m > kth, or m == kth and wn > kth_noise, or kth <= NEG (fewer than K
    feasible nodes: the shortlist is the row); then win is the full
    row's winner. Otherwise the pod takes the full-row pick and is
    marked repaired. A winner above NEG is debited, as in the full scan,
    so every output equals greedy_assign_plain's.
    """
    P, N = scores.shape
    device = scores.device
    free = free0.clone()
    cols = torch.arange(N, dtype=torch.int64, device=device)
    cand_scores = torch.gather(scores, 1, cand.long())
    chosen = torch.full((P,), -1, dtype=torch.int32, device=device)
    assigned = torch.zeros((P,), dtype=torch.bool, device=device)
    repaired = torch.zeros((P,), dtype=torch.bool, device=device)
    for i in range(P):
        req = requests[i]
        cids = cand[i].long()
        fits = (free[cids] >= req[None, :]).all(dim=1)
        s = torch.where(fits, cand_scores[i], NEG)
        m = s.max()
        noise = tie_noise_from_cols(seed, i, cids)
        tie = (s >= m) & fits
        wn = torch.where(tie, noise, -1.0).max()
        win = torch.where(tie & (noise == wn), cids, N).min()
        certified = bool((m > kth[i]) | ((m == kth[i]) & (wn > kth_noise[i]))
                         | (kth[i] <= NEG))
        if certified:
            idx, ok = int(win), bool(m > NEG)
        else:
            idx, ok = _full_row_pick(scores[i], req, free, seed, i, cols)
            repaired[i] = True
        if ok:
            free[idx] = free[idx] - req
            chosen[i] = idx
            assigned[i] = True
    return ShortlistAssignResult(chosen, assigned, free, repaired)


def greedy_assign_shortlist(scores: torch.Tensor, requests: torch.Tensor,
                            free0: torch.Tensor, seed: int,
                            k: int = 128) -> ShortlistAssignResult:
    """``greedy_assign`` with the sequential scan compressed to per-pod
    top-K shortlists: bit-identical decisions, certified per step, with
    a counted full-row repair where the certificate fails.

    The selection and the scan dispatch on the device of their inputs:
    CPU tensors take the plain versions, CUDA tensors the hand-written
    kernels (ops/select_kernel.py, ops/shortlist_kernel.py), which raise
    rather than fall back; the selection kernel also hands the scan the
    candidates' scores."""
    P, N = scores.shape
    k = min(max(int(k), 1), N)
    if scores.device.type == "cpu":
        cand, kth, kth_noise = shortlist_select_plain(scores, seed, k)
        return greedy_assign_shortlist_plain(scores, requests, free0, seed,
                                             cand, kth, kth_noise)
    from .select_kernel import shortlist_select_cuda
    from .shortlist_kernel import shortlist_scan_cuda

    cand, kth, kth_noise, cand_scores = shortlist_select_cuda(scores, seed, k)
    return shortlist_scan_cuda(scores, cand, kth, kth_noise, requests,
                               free0, seed, cand_scores=cand_scores)


def lane_seeds(seeds, device) -> torch.Tensor:
    """The lanes' u32 seeds as a (T,) int32 tensor on ``device`` (the bit
    patterns), for the lane kernels. On a card the copy leaves pinned
    host memory without waiting for the card."""
    host = torch.tensor([(int(s) & _M32) - ((int(s) & 0x80000000) << 1)
                         for s in seeds], dtype=torch.int32)
    if torch.device(device).type == "cpu":
        return host
    return host.pin_memory().to(device, non_blocking=True)


def shortlist_select_lanes_plain(scores: torch.Tensor, seeds, k: int):
    """The plain version of the selection kernel's lane form:
    ``shortlist_select_plain`` over each lane of ``scores`` (T,P,N) with
    its seed, stacked: (cand (T,P,K), kth (T,P), kth_noise (T,P))."""
    outs = [shortlist_select_plain(scores[t], int(sd), k)
            for t, sd in enumerate(seeds)]
    return tuple(torch.stack(parts) for parts in zip(*outs))


def greedy_assign_shortlist_lanes_plain(scores, requests, free0, seeds,
                                        cand, kth, kth_noise
                                        ) -> ShortlistAssignResult:
    """The plain version of the scan kernel's lane form:
    ``greedy_assign_shortlist_plain`` over each lane (every input with a
    leading T axis), stacked."""
    outs = [greedy_assign_shortlist_plain(scores[t], requests[t], free0[t],
                                          int(sd), cand[t], kth[t],
                                          kth_noise[t])
            for t, sd in enumerate(seeds)]
    return ShortlistAssignResult(*(torch.stack(parts)
                                   for parts in zip(*outs)))


def greedy_assign_shortlist_lanes(scores: torch.Tensor,
                                  requests: torch.Tensor,
                                  free0: torch.Tensor, seeds,
                                  k: int = 128) -> ShortlistAssignResult:
    """``greedy_assign_shortlist`` over T lanes at once: ``scores``
    (T,P,N), ``requests`` (T,P,R), ``free0`` (T,N,R) and ``seeds`` the T
    lanes' u32 seeds (host ints). Lane t's outputs equal
    ``greedy_assign_shortlist(scores[t], requests[t], free0[t],
    seeds[t], k)``, with a leading T axis. CPU tensors loop the plain
    versions over the lanes; CUDA tensors make one selection launch and
    one scan launch for every lane (ops/select_kernel.py,
    ops/shortlist_kernel.py), which raise rather than fall back."""
    T, P, N = scores.shape
    k = min(max(int(k), 1), N)
    if scores.device.type == "cpu":
        cand, kth, kth_noise = shortlist_select_lanes_plain(scores, seeds, k)
        return greedy_assign_shortlist_lanes_plain(
            scores, requests, free0, seeds, cand, kth, kth_noise)
    from .select_kernel import shortlist_select_lanes_cuda
    from .shortlist_kernel import shortlist_scan_lanes_cuda

    seeds_dev = lane_seeds(seeds, scores.device)
    cand, kth, kth_noise, cand_scores = shortlist_select_lanes_cuda(
        scores, seeds_dev, k)
    return shortlist_scan_lanes_cuda(scores, cand, kth, kth_noise, requests,
                                     free0, seeds_dev,
                                     cand_scores=cand_scores)

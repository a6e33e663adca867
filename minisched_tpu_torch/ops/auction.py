"""Auction assignment: the opt-in ``assignment="auction"`` of BASELINE
config 5 (gangs and coscheduling), a port of the JAX package's
``minisched_tpu/ops/auction.py``.

The greedy assignment (select.py) is a chain of P dependent steps. The
auction replaces it with parallel bidding rounds (Bertsekas, the
non-displacing variant):

  round: every unassigned pod of the current priority band bids on its
         best node at the current prices (value = score - price); each
         node accepts its strongest bidder (strengths are made unique by
         seeded noise and the row, so one pod wins per node); a winner
         that no longer fits the node's free capacity is refused, but the
         node's price still rises by the winner's Bertsekas margin
         (v_best - v_second + EPS), which sends it to its next-best node.

Pods bid in descending priority BANDS: a band runs until every pod of it
is assigned or STALE_ROUNDS rounds pass without an assignment; then the
next lower band bids against the remaining capacity with prices reset to
0. The rounds of all bands share one budget, ``max_rounds_for(P)``. A
won slot is kept (non-displacing), so under heavy contention a feasible
pod can stay unassigned; the engine retries it in a later batch.

Exactness against the JAX package, which the tests hold bitwise:

  * the tie-break noise under EPS is folded into the scores once, and
    XLA's CPU backend contracts ``scores + noise * EPS`` into one fused
    multiply-add where it compiles the function (the engine's jitted
    step; an eager call does not), and ``v_best + noise * (EPS / 2)``
    inside the loop body always: both are ``select.fma_f32`` here and
    ``__fmaf_rn`` in the kernels;
  * the strength ranks are ``argsort(argsort(strength))`` over
    ``lax.sort``'s total order (−0.0 below +0.0, a stable sort): here
    over ``select.order_key``; a node's winner is the bidder of largest
    (strength, row);
  * the debit and the price rise add one winner per node (ranks are a
    permutation), so ``free[best] -= request`` and ``prices[best] +=
    gamma`` over the winners are the JAX package's one-hot matmuls bit
    for bit; a matmul on the card could run in TF32.

``auction_assign_plain`` is the literal PyTorch version, a host loop over
rounds (the tests and CPU tensors). ``auction_assign`` dispatches on the
device of its inputs: CUDA tensors launch the hand-written kernel
(ops/auction_kernel.py, csrc/auction.cu), which runs the whole loop in
one launch and raises rather than fall back.
"""
from __future__ import annotations

from typing import Optional

import torch

from .select import NEG, AssignResult, fma_f32, order_key, tie_noise_from_cols

# Rounds without a new assignment before a band is judged capacity-blocked
# and the next band starts.
STALE_ROUNDS = 8
NEG_BAND = -(2 ** 31) + 1  # below every priority: no band left


def max_rounds_for(P: int) -> int:
    """The shared round budget of a P-row batch. Every win resets the
    stale count, so a band costs at most 8 rounds per win plus 8 when it
    ends with an unassigned pod: 8·P rounds at most, inside the budget."""
    return max(256, (1 + STALE_ROUNDS) * P + STALE_ROUNDS)


# The least price rise (the JAX default, the only value the engine uses),
# and half of it for the strength noise, as the float32 values the JAX
# expressions take (a Python float against a float32 array).
EPS = float(torch.tensor(1e-2, dtype=torch.float32))
HALF_EPS = float(torch.tensor(1e-2 * 0.5, dtype=torch.float32))


def fold_scores(scores: torch.Tensor, seed: int) -> torch.Tensor:
    """``where(scores > NEG, fma(noise, EPS, scores), NEG)``: each pair's
    tie noise (seed, pod row, node column) times EPS added with one
    rounding."""
    P, N = scores.shape
    dev = scores.device
    rows = torch.arange(P, dtype=torch.int64, device=dev)[:, None]
    cols = torch.arange(N, dtype=torch.int64, device=dev)[None, :]
    noise = tie_noise_from_cols(seed, rows, cols)
    e = torch.full((), EPS, dtype=torch.float32, device=dev)
    return torch.where(scores > NEG, fma_f32(noise, e, scores), NEG)


def priorities(priority, P: int, device) -> torch.Tensor:
    if priority is None:
        return torch.zeros((P,), dtype=torch.int32, device=device)
    return priority.to(torch.int32)


def top2(value: torch.Tensor):
    """Per row: the largest value, the first column holding it
    (``jnp.argmax``) and the largest over the other columns."""
    v_best = value.max(dim=1).values
    best = value.argmax(dim=1)
    v2 = value.scatter(1, best[:, None], NEG).max(dim=1).values
    return v_best, best, v2


class Rounds:
    """The loop state of the banded rounds and its two shared halves: the
    round's open nodes, and everything after the bids."""

    def __init__(self, scores: torch.Tensor, requests: torch.Tensor,
                 free0: torch.Tensor, seed: int,
                 max_rounds: Optional[int], priority):
        P, N = scores.shape
        dev = scores.device
        self.N, self.seed = N, seed
        self.requests = requests
        self.max_rounds = (max_rounds_for(P) if max_rounds is None
                           else int(max_rounds))
        self.eps = torch.full((), EPS, dtype=torch.float32, device=dev)
        self.half = torch.full((), HALF_EPS, dtype=torch.float32,
                               device=dev)
        self.rows = torch.arange(P, dtype=torch.int64, device=dev)
        self.prio = priorities(priority, P, dev)
        self.feasible = (scores > NEG).any(dim=1)
        self.chosen = torch.full((P,), -1, dtype=torch.int32, device=dev)
        self.free = free0.clone()
        self.prices = torch.zeros((N,), dtype=torch.float32, device=dev)
        self.rnd = 0
        self.stale = 0
        self.bid_rows = 0   # (round, pod) bids reduced
        self.full_rows = 0  # of them over the pod's full row
        self.band = int(torch.where(self.feasible, self.prio,
                                    NEG_BAND).max()) if P else NEG_BAND

    def running(self) -> bool:
        return self.rnd < self.max_rounds and self.band > NEG_BAND

    def open_nodes(self):
        """(active (P,), node_open (N,)): the band's unassigned pods, and
        the nodes whose free capacity covers the smallest request of any
        of them that can bid, on every axis."""
        active = (self.chosen < 0) & (self.prio == self.band)
        bidder = active & self.feasible
        self.bid_rows += int(bidder.sum())
        min_req = torch.where(bidder[:, None], self.requests,
                              float("inf")).min(dim=0).values
        node_open = (self.free >= min_req).all(dim=1)
        return active, node_open

    def dense_bids(self, folded, active, node_open):
        value = torch.where((folded > NEG) & active[:, None]
                            & node_open[None, :],
                            folded - self.prices[None, :], NEG)
        return top2(value)

    def settle(self, active, v_best, best, v2) -> None:
        """The rest of a round: ranks, winners, capacity, debits, prices,
        the stale count and the band control."""
        has_bid = active & (v_best > NEG)
        gamma = torch.where(v2 > NEG, v_best - v2, 0.0) + self.eps
        noise = tie_noise_from_cols(self.seed, self.rnd, self.rows)
        strength = fma_f32(noise, self.half,
                           torch.where(has_bid, v_best, NEG))
        rank = torch.argsort(torch.argsort(order_key(strength), stable=True),
                             stable=True)
        rank = torch.where(has_bid, rank, -1)
        node_best = torch.full((self.N,), -1, dtype=rank.dtype,
                               device=rank.device).scatter_reduce(
            0, best, rank, reduce="amax", include_self=True)
        win = has_bid & (rank == node_best[best])
        wfits = (self.free[best] >= self.requests).all(dim=1)
        win_ok = win & wfits
        self.chosen = torch.where(win_ok, best.to(torch.int32), self.chosen)
        w = win_ok.nonzero().flatten()
        self.free[best[w]] = self.free[best[w]] - self.requests[w]
        w = win.nonzero().flatten()
        self.prices[best[w]] = self.prices[best[w]] + gamma[w]
        self.stale = 0 if bool(win_ok.any()) else self.stale + 1
        left = (self.chosen < 0) & self.feasible
        if (not bool((left & (self.prio == self.band)).any())
                or self.stale >= STALE_ROUNDS):
            self.band = int(torch.where(left & (self.prio < self.band),
                                        self.prio, NEG_BAND).max())
            self.stale = 0
            self.prices.zero_()
        self.rnd += 1

    def finish(self, stats: Optional[torch.Tensor]) -> None:
        """Fill ``stats`` (int32 (3,)) with the rounds run, the bids
        reduced (an infeasible pod bids nothing and is not counted) and
        those of them taken over a full row."""
        if stats is not None:
            stats.copy_(torch.tensor([self.rnd, self.bid_rows,
                                      self.full_rows], dtype=torch.int32))


def auction_assign_plain(scores: torch.Tensor, requests: torch.Tensor,
                         free0: torch.Tensor, seed: int,
                         max_rounds: Optional[int] = None, priority=None,
                         stats: Optional[torch.Tensor] = None
                         ) -> AssignResult:
    """The plain PyTorch version of the auction kernel.

    scores:   (P,N) float32 with NEG on infeasible pairs
    requests: (P,R) float32; free0: (N,R) float32
    seed:     the batch's u32 tie-break seed (ops/prng.bits)
    priority: optional (P,) int32: pods bid in descending bands
    stats:    optional int32 (3,) tensor: rounds run, bids reduced, bids
              over a full row (Rounds.finish)
    """
    st = Rounds(scores, requests, free0, seed, max_rounds, priority)
    folded = fold_scores(scores, seed)
    while st.running():
        active, node_open = st.open_nodes()
        v_best, best, v2 = st.dense_bids(folded, active, node_open)
        st.settle(active, v_best, best, v2)
    st.full_rows = st.bid_rows
    st.finish(stats)
    return AssignResult(st.chosen, st.chosen >= 0, st.free)


def auction_assign(scores: torch.Tensor, requests: torch.Tensor,
                   free0: torch.Tensor, seed: int,
                   max_rounds: Optional[int] = None,
                   priority=None) -> AssignResult:
    """``auction_assign_plain``'s contract on any device: CPU tensors take
    the plain version, CUDA tensors the auction kernel."""
    if scores.device.type == "cpu":
        return auction_assign_plain(scores, requests, free0, seed,
                                    max_rounds, priority)
    from .auction_kernel import auction_cuda

    return auction_cuda(scores, requests, free0, seed, max_rounds, priority)

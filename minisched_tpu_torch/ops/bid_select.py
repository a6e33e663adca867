"""Bid shortlist: the auction's rounds over each pod's top-K candidates,
certified per round, with a counted full-row repair. A port of the JAX
package's ``minisched_tpu/ops/bid_select.py``.

The noise-folded scores (auction.fold_scores) are ranked once per pod in
``lax.top_k``'s order (value by total order, lowest column first among
ties); ``kth`` is the K-th value. Within a band prices start at 0 and
only rise, and the masks only lower a value to NEG, so every node outside
the shortlist is worth at most ``kth``. With ``m`` the best candidate
value of the round and ``v2_s`` the best with the winning column
excluded, a pod's round is certified iff::

    (m > kth) & (v2_s >= kth)    or    kth <= NEG

(the true argmax is a candidate, the lowest tied candidate column is the
dense argmax, and the margin is exact; or the row has fewer than K
feasible nodes). An active pod that is not certified takes the dense
round's (v_best, best, v2) over its full row and is marked in
``repaired``, an OR over rounds: an active pod whose candidates are all
closed while ``kth > NEG`` counts as a repair too. Everything after the
bids is the dense round's, so ``auction_assign_shortlist`` equals
``auction.auction_assign`` bitwise for any K.

``auction_assign_shortlist_plain`` is the literal PyTorch version;
``auction_assign_shortlist`` dispatches on the device of its inputs:
CUDA tensors launch the hand-written kernel (ops/auction_kernel.py,
csrc/bid_auction.cu), which selects the shortlists and runs the whole
loop in one launch, and raises rather than fall back.
"""
from __future__ import annotations

from typing import Optional

import torch

from .auction import Rounds, fold_scores
from .select import NEG, ShortlistAssignResult, order_key


def bid_shortlist(folded: torch.Tensor, k: int):
    """``lax.top_k(folded, k)``: (values (P,K), columns (P,K) int32) in
    its order. A unique int64 key, the value's total-order key above and
    the column's complement below, makes torch.topk break ties as
    lax.top_k does (lowest column first)."""
    N = folded.shape[1]
    cols = torch.arange(N, dtype=torch.int64, device=folded.device)
    key = order_key(folded).to(torch.int64) * (1 << 32) + (0xFFFFFFFF - cols)
    cand = torch.topk(key, k, dim=1).indices
    return torch.gather(folded, 1, cand), cand.to(torch.int32)


def auction_assign_shortlist_plain(scores: torch.Tensor,
                                   requests: torch.Tensor,
                                   free0: torch.Tensor, seed: int,
                                   max_rounds: Optional[int] = None,
                                   priority=None, k: int = 128,
                                   stats: Optional[torch.Tensor] = None
                                   ) -> ShortlistAssignResult:
    """The plain PyTorch version of the bid-shortlist kernel: the
    arguments of auction.auction_assign_plain plus the width ``k``
    (clamped to N; any K decides as the dense auction)."""
    P, N = scores.shape
    k = min(max(int(k), 1), N)
    st = Rounds(scores, requests, free0, seed, max_rounds, priority)
    folded = fold_scores(scores, seed)
    s_vals, cand = bid_shortlist(folded, k)
    cand = cand.long()
    kth = s_vals[:, -1]
    repaired = torch.zeros((P,), dtype=torch.bool, device=scores.device)
    while st.running():
        active, node_open = st.open_nodes()
        v_cand = torch.where((s_vals > NEG) & active[:, None]
                             & node_open[cand],
                             s_vals - st.prices[cand], NEG)
        m = v_cand.max(dim=1).values
        best_s = torch.where(v_cand == m[:, None], cand, N).min(dim=1).values
        v2_s = torch.where(cand == best_s[:, None], NEG,
                           v_cand).max(dim=1).values
        cert = ((m > kth) & (v2_s >= kth)) | (kth <= NEG)
        uncert = active & ~cert
        v_best, best, v2 = m, best_s, v2_s
        if bool(uncert.any()):
            v_best_f, best_f, v2_f = st.dense_bids(folded, active, node_open)
            v_best = torch.where(uncert, v_best_f, m)
            best = torch.where(uncert, best_f, best_s)
            v2 = torch.where(uncert, v2_f, v2_s)
        repaired |= uncert
        st.full_rows += int(uncert.sum())
        st.settle(active, v_best, best, v2)
    st.finish(stats)
    return ShortlistAssignResult(st.chosen, st.chosen >= 0, st.free,
                                 repaired)


def auction_assign_shortlist(scores: torch.Tensor, requests: torch.Tensor,
                             free0: torch.Tensor, seed: int,
                             max_rounds: Optional[int] = None,
                             priority=None, k: int = 128
                             ) -> ShortlistAssignResult:
    """``auction_assign_shortlist_plain``'s contract on any device: CPU
    tensors take the plain version, CUDA tensors the bid-shortlist
    kernel."""
    if scores.device.type == "cpu":
        return auction_assign_shortlist_plain(scores, requests, free0, seed,
                                              max_rounds, priority, k)
    from .auction_kernel import bid_auction_cuda

    return bid_auction_cuda(scores, requests, free0, seed, max_rounds,
                            priority, k)

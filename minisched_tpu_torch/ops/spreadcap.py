"""In-scan domain capacity for hard topology spread.

The batched step evaluates DoNotSchedule skew against PRE-batch counts
(plugins/podtopologyspread.py filter): every pod of a batch sees the same
frozen feasibility. A sequential scheduler re-evaluates skew against
RUNNING counts at each placement, so balanced rotation fills every
domain in one pass.

This module moves that running-count evaluation into the greedy scan
(ops/select.greedy_assign with ``caps``): the scan carries a per-(group,
domain) count table, each pod's feasible nodes are masked by the running
counts and the running min, and each assignment adds one to the chosen
node's domain in every group the pod MATCHES (membership, not just its
own constraints) — the math of the engine's host arbitration
(_SpreadGroupState), executed at choice time.

Bounded compaction: up to ``max_groups`` hard-referenced selector groups
are enforced, each with up to ``max_domains`` distinct topology domains
(zones and racks compact; kubernetes.io/hostname has N domains and
overflows). Slots whose group is not selected or not compactable are not
enforced in the scan: the static filter verdict stands for them and the
engine's arbitration and repair are the backstop. The PodTopologySpread
filter skips its static skew rejection exactly for the groups the scan
enforces (``scan_groups``, ctx["spread_scan_groups"]).

Every step here is a tensor op on the device of its inputs, with no read
back to the host: where the JAX package calls ``jnp.unique(size=H)`` the
values are sorted, ranked by a cumulative sum and scattered into H slots
with a spill column, which needs no data-dependent shape.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..encode import features as F

# Python literals, as in the JAX package.
BIG_GID = 2 ** 30
BIG_DOM = 2 ** 30
BIG_F = 3.0e38


class DomainCaps(NamedTuple):
    """Inputs for in-scan hard-spread enforcement (H selected groups,
    K compact domains)."""

    slot_h: torch.Tensor      # (P,C) int32 — constraint slot → selected-
    #                           group index, -1 = slot not enforced in-scan
    slot_skew: torch.Tensor   # (P,C) float32 — max_skew per slot
    domc: torch.Tensor        # (H,N) int32 — compact domain per node, -1 none
    counts0: torch.Tensor     # (H,K) float32 — pre-batch matching counts
    dexist: torch.Tensor      # (H,K) bool — domain exists on some node
    match: torch.Tensor       # (P,H) bool — batch pod matches group
    any_enforced: torch.Tensor  # () bool — any slot enforced this batch
    scan_groups: torch.Tensor  # (G,) bool — global group enforced in-scan


def _sorted_unique_padded(x: torch.Tensor, size: int, fill: int
                          ) -> torch.Tensor:
    """The ``size`` smallest distinct values of each row of ``x`` (2-D),
    ascending, padded with ``fill`` (which must not be below any value):
    ``jnp.unique(size=..., fill_value=...)`` row by row, without a data-
    dependent shape. Equal values share their rank, so the scatter's
    duplicate writes to one slot carry one value."""
    rows, n = x.shape
    s = torch.sort(x, dim=1).values
    is_new = torch.ones_like(s, dtype=torch.bool)
    is_new[:, 1:] = s[:, 1:] != s[:, :-1]
    rank = torch.cumsum(is_new.to(torch.int64), dim=1) - 1
    col = torch.where(rank < size, rank, size)  # spill column `size`
    out = torch.full((rows, size + 1), fill, dtype=x.dtype, device=x.device)
    return out.scatter_(1, col, s)[:, :size], s, is_new, rank


def _pod_group_match(pf, gf, gsel: torch.Tensor) -> torch.Tensor:
    """(P,H) bool: batch pod p matches selected group gsel[h] — the
    batch-pod twin of ops.topology.group_assigned_match (an all-zero
    selector matches all, ns_hash 0 any namespace), on the pod's own
    encoded ns_hash and label_pairs."""
    gsafe = torch.clamp(gsel, 0, gf.valid.shape[0] - 1).long()
    sel = gf.sel_pairs.index_select(0, gsafe)              # (H,QT)
    gns = gf.ns_hash.index_select(0, gsafe)                # (H,)
    gvalid = gf.valid.index_select(0, gsafe) & (gsel < BIG_GID)
    ns_ok = (gns[None, :] == 0) | (gns[None, :] == pf.ns_hash[:, None])
    present = (sel[None, :, :, None]
               == pf.label_pairs[:, None, None, :]).any(dim=-1)  # (P,H,QT)
    sel_ok = (present | (sel[None, :, :] == 0)).all(dim=2)
    return pf.valid[:, None] & gvalid[None, :] & ns_ok & sel_ok


def build_domain_caps(pf, gf, nf, counts_dom, dom_exists, *,
                      max_groups: int = 8,
                      max_domains: int = 128) -> DomainCaps:
    """Select up to H hard-referenced groups, compact their domain ids to
    K slots, and gather pre-batch counts from the step's (G,D) topology
    tables."""
    H, K = max_groups, max_domains
    P, C = pf.spread_group.shape
    G = gf.valid.shape[0]

    hard_slot = ((pf.spread_group >= 0)
                 & (pf.spread_mode == F.SPREAD_DO_NOT_SCHEDULE)
                 & pf.valid[:, None])                           # (P,C)
    hard_gids = torch.where(hard_slot, pf.spread_group, BIG_GID)
    gsel = _sorted_unique_padded(hard_gids.reshape(1, -1), H,
                                 BIG_GID)[0][0]                 # (H,) sorted

    gsafe = torch.clamp(gsel, 0, G - 1).long()
    key_h = gf.key_idx.index_select(0, gsafe)
    node_dom = nf.topo_domains.index_select(
        0, torch.clamp(key_h, 0, nf.topo_domains.shape[0] - 1).long())
    node_dom = torch.where((gsel < BIG_GID)[:, None], node_dom, -1)

    # Compact each group's domain ids into K slots by sort + dense rank;
    # more than K distinct domains disables enforcement for the group.
    dom_or_big = torch.where(node_dom >= 0, node_dom, BIG_DOM)
    uniq_k, sorted_dom, is_new, rank = _sorted_unique_padded(
        dom_or_big, K, BIG_DOM)
    # The JAX package counts BIG_DOM padding out of the distinct values
    # (and routes it to the spill column, which the padding fill equals).
    is_new = is_new & (sorted_dom < BIG_DOM)
    n_distinct = torch.where(is_new, rank + 1, 0).max(dim=1).values
    compactable = n_distinct <= K

    # pos = (number of uniq_k entries <= the node's domain) - 1.
    pos = torch.searchsorted(uniq_k.contiguous(), dom_or_big.contiguous(),
                             right=True) - 1
    pos_safe = torch.clamp(pos, 0, K - 1)
    hit = torch.gather(uniq_k, 1, pos_safe) == dom_or_big
    domc = torch.where((node_dom >= 0) & hit & compactable[:, None],
                       pos_safe, -1).to(torch.int32)            # (H,N)

    D = counts_dom.shape[1]
    uniq_safe = torch.clamp(uniq_k, 0, D - 1).long()
    counts0 = torch.gather(counts_dom.index_select(0, gsafe), 1, uniq_safe)
    dexist = (torch.gather(dom_exists.index_select(0, gsafe), 1, uniq_safe)
              & (uniq_k < BIG_DOM))
    counts0 = torch.where(dexist, counts0, 0.0)

    enforce_h = (gsel < BIG_GID) & compactable                  # (H,)

    # Constraint slot → selected-group index (a left search in the
    # sorted gsel), enforced only when the group is.
    spos = torch.searchsorted(gsel.contiguous(),
                              hard_gids.reshape(-1).contiguous()
                              ).reshape(P, C)
    spos_safe = torch.clamp(spos, 0, H - 1)
    slot_ok = (hard_slot & (gsel[spos_safe] == hard_gids)
               & enforce_h[spos_safe])
    slot_h = torch.where(slot_ok, spos_safe, -1).to(torch.int32)

    match = _pod_group_match(pf, gf, gsel) & enforce_h[None, :]
    scan_groups = ((torch.arange(G, dtype=gsel.dtype,
                                 device=gsel.device)[:, None]
                    == gsel[None, :]) & enforce_h[None, :]).any(dim=1)
    return DomainCaps(
        slot_h=slot_h,
        slot_skew=pf.spread_max_skew.to(torch.float32),
        domc=domc, counts0=counts0, dexist=dexist, match=match,
        any_enforced=slot_ok.any(), scan_groups=scan_groups)


def caps_mask(caps: DomainCaps, counts: torch.Tensor, i: int) -> torch.Tensor:
    """(N,) bool: nodes pod row ``i`` may take under the RUNNING counts —
    the filter's formula, count(node's domain) + 1 - min over existing
    domains <= max_skew, on the scan-carried state. Nodes whose domain is
    uncompacted or missing pass here (the static filter owns them)."""
    mins = torch.where(caps.dexist, counts, BIG_F).min(dim=1).values  # (H,)
    N = caps.domc.shape[1]
    ok = torch.ones((N,), dtype=torch.bool, device=counts.device)
    for c in range(caps.slot_h.shape[1]):
        h = caps.slot_h[i, c]
        hs = torch.clamp(h, 0, caps.domc.shape[0] - 1)
        dom_n = caps.domc[hs]                                       # (N,)
        cnt_n = counts[hs][torch.clamp(dom_n, 0, counts.shape[1] - 1).long()]
        okc = ((cnt_n + 1.0 - mins[hs]) <= caps.slot_skew[i, c]) | (dom_n < 0)
        ok = ok & (okc | (h < 0))
    return ok


def caps_update(caps: DomainCaps, counts: torch.Tensor, i: int,
                chosen: int) -> torch.Tensor:
    """New (H,K) counts after pod row ``i`` takes node ``chosen``: every
    group the pod MATCHES gains one in the chosen node's domain
    (membership semantics, as the host arbitration counts)."""
    dj = caps.domc[:, chosen]                                       # (H,)
    upd = caps.match[i] & (dj >= 0)
    rows = torch.arange(counts.shape[0], device=counts.device)
    out = counts.clone()
    out[rows, torch.clamp(dj, 0, counts.shape[1] - 1).long()] += \
        upd.to(counts.dtype)
    return out

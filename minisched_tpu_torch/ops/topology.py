"""Topology-domain counting for spread and inter-pod affinity.

"How many matching pods are in this topology domain", for every
selector group of the batch at once:

  1. match (G × A): which assigned pods match each selector GROUP — exact
     hashed-pair comparison, G = distinct (key, ns, selector) tuples in the
     batch (deployment replicas share one), A = assigned-pod corpus.
  2. counts_dom (G × D): a scatter-add of the matches over each group's
     domain ids (domain = node row for kubernetes.io/hostname, hashed
     label value otherwise).
  3. counts_node (G × N): each node's domain count gathered back; min/max
     over existing domains feed the skew math.

Pods then gather their group's row (``gather_group_rows``) with a device
index tensor, never a Python list, so the step does not wait for the
card. The summed values are 0/1 in float32 and stay below 2**24, so the
order of the scatter's additions cannot change a bit.
"""
from __future__ import annotations

from typing import Dict

import torch


def group_assigned_match(gf, af) -> torch.Tensor:
    """(G, A) bool: assigned pod a matches group g's namespace + selector.
    An all-zero selector with a valid group matches all (upstream empty
    LabelSelector)."""
    ns_ok = (gf.ns_hash[:, None] == 0) | (
        gf.ns_hash[:, None] == af.ns_hash[None, :])
    sel_ok = torch.ones_like(ns_ok)
    for q in range(gf.sel_pairs.shape[1]):
        want = gf.sel_pairs[:, q, None]                       # (G,1)
        present = torch.zeros_like(ns_ok)
        for l in range(af.label_pairs.shape[1]):
            present |= want == af.label_pairs[None, :, l]
        sel_ok &= present | (want == 0)
    return gf.valid[:, None] & ns_ok & sel_ok & af.valid[None, :]


def group_topology_state(nf, af, gf, num_domains: int
                         ) -> Dict[str, torch.Tensor]:
    """Shared cycle state for topology plugins:

      counts_node (G,N) float32 — matching assigned pods in node n's domain
      dom_valid   (G,N) bool — node has the group's topology key
      min_count   (G,)  float32 — min count over domains that exist on nodes
      max_count   (G,)  float32 — max count over existing domains
      has_match   (G,)  bool — some assigned pod matches the group at all
      counts_dom  (G,D) float32 — matching count per domain
      dom_exists  (G,D) bool — the domain exists on some node
    """
    part = topology_partials(nf, af, gf, num_domains,
                             group_assigned_match(gf, af).to(torch.float32),
                             row0=0, n_total=nf.valid.shape[0])
    return topology_tables(part, part["counts_dom"], part["dom_count"] > 0,
                           part["has_match"])


def topology_partials(nf, af, gf, num_domains: int, match: torch.Tensor,
                      row0: int, n_total: int) -> Dict[str, torch.Tensor]:
    """The per-domain tables as one node shard sees them: ``nf`` holds
    the node rows [row0, row0 + n) of an ``n_total``-row axis, and only
    the assigned pods bound to those rows count here. ``match`` is
    ``group_assigned_match(gf, af)`` as float32. Summed over the node
    shards, ``counts_dom`` and ``dom_count`` are the whole axis' tables
    (0/1 values: the sums are exact in any order), and ``has_match``
    ORs; ``topology_tables`` finishes them. One shard of the whole axis
    (row0 = 0) is the single-device state."""
    G = gf.valid.shape[0]
    n = nf.valid.shape[0]
    D = num_domains
    node_dom = nf.topo_domains.index_select(0, gf.key_idx.long())  # (G,n)
    dom_valid = (node_dom >= 0) & nf.valid[None, :] & gf.valid[:, None]
    rows = torch.clamp(af.node_row.long(), 0, n_total - 1)
    mine = (rows >= row0) & (rows < row0 + n)
    local = torch.clamp(rows - row0, 0, n - 1)
    a_dom = torch.where(mine[None, :], node_dom.index_select(1, local),
                        -1)                                  # (G,A)
    a_ok = (a_dom >= 0) & af.valid[None, :]
    a_ids = torch.clamp(a_dom, 0, D - 1).long()

    hit = match * a_ok
    counts_dom = torch.zeros((G, D), dtype=torch.float32,
                             device=hit.device).scatter_add_(1, a_ids, hit)
    node_ids = torch.clamp(node_dom, 0, D - 1).long()
    dom_count = torch.zeros((G, D), dtype=torch.float32,
                            device=hit.device).scatter_add_(
        1, node_ids, dom_valid.to(torch.float32))
    return {"counts_dom": counts_dom, "dom_count": dom_count,
            "has_match": (hit != 0).any(dim=1), "dom_valid": dom_valid,
            "node_ids": node_ids}


def topology_tables(part: Dict[str, torch.Tensor], counts_dom: torch.Tensor,
                    dom_exists: torch.Tensor, has_match: torch.Tensor
                    ) -> Dict[str, torch.Tensor]:
    """``group_topology_state``'s tables for the node rows of ``part``
    (``topology_partials``) from the whole axis' ``counts_dom``,
    ``dom_exists`` and ``has_match``."""
    dom_valid, node_ids = part["dom_valid"], part["node_ids"]
    counts_node = torch.where(dom_valid, torch.gather(counts_dom, 1, node_ids),
                              0.0)
    big = 3.0e38
    min_count = torch.where(
        dom_exists.any(dim=1),
        torch.where(dom_exists, counts_dom, big).min(dim=1).values, 0.0)
    max_count = torch.where(dom_exists, counts_dom, 0.0).max(dim=1).values
    return {"counts_node": counts_node, "dom_valid": dom_valid,
            "min_count": min_count, "max_count": max_count,
            "has_match": has_match, "counts_dom": counts_dom,
            "dom_exists": dom_exists}


def gather_group_rows(group_idx: torch.Tensor, table: torch.Tensor,
                      fill: float = 0.0) -> torch.Tensor:
    """table (G,N) gathered by group_idx (P,) → (P,N); ``fill`` where
    idx < 0."""
    safe = torch.clamp(group_idx, 0, table.shape[0] - 1).long()
    out = table.index_select(0, safe)
    return torch.where((group_idx >= 0)[:, None], out, fill)


def sym_node_rows(nf, sym) -> torch.Tensor:
    """(T,N) float32: each node's summed weight of the bound pods' terms
    in table row t (features.SymTerms), read from the node's domain under
    row t's topology key; 0 where the node lacks the key. Domain ids are
    global (hostname: the node row), so any node subset (a sample, a
    mesh shard) reads its own columns."""
    dom = nf.topo_domains.index_select(0, sym.key_idx.long())   # (T,N)
    width = sym.dom_w.shape[1]
    w = torch.gather(sym.dom_w, 1, torch.clamp(dom, 0, width - 1).long())
    return torch.where((dom >= 0) & (dom < width), w, 0.0)

"""Maintained arbitration index: per-pod-class score rows kept on the
device across batches and repaired by the same sparse deltas that keep
``free`` resident.

Pods with bit-identical feature rows score every node identically under
column-local plugins, so a score row belongs to the pod's CLASS, not the
pod. The index keeps, per registered class, the pre-normalize planes
(per-scorer raw scores (S,C,N) and the AND of the filters (C,N)) and the
served masked total (C,N) derived from them:

  * ``build``   — one full (C,N) filter+score pass over the classes.
  * ``refresh`` — re-evaluate the column-local planes at only the changed
    node columns (cache deltas and the previous batch's debits), write
    them in place, then re-derive the served matrix. Every other column
    kept its truth, so the state equals a fresh build against the same
    snapshot.
  * ``append``  — evaluate only fresh class rows over the full node axis
    and write them in: a new class costs O(N) evaluations, not a
    rebuild.
  * ``assign``  — gather each batch pod's class row into a (P,N) score
    view (no plugin evaluation) and run the certified shortlist scan
    over it (select.greedy_assign_shortlist: the selection and scan
    kernels for CUDA tensors, their plain versions on the CPU). Inputs,
    seed and machinery equal the full step's assignment, so decisions
    and ``free_after`` are bitwise the full step's.

The served matrix is re-derived after every repair by the finalize pass:
normalize, weighted float32 sum and NEG mask over the full planes, the
op sequence of ops/pipeline._evaluate from the normalize on. Row
reductions inside a normalize (max, min) are recomputed from the planes,
so a column repair that moves a row's extremum re-values the row
exactly; row-local normalizes (index_eligible) make each class row equal
the step's per-pod row bitwise.

Batches the scan cannot serve are the engine's to repair: a batch with
an unassigned live row discards the speculative result and re-runs the
full step with the batch's PRNG draw (engine/scheduler._settle_index).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..plugins.base import BatchedPlugin, PluginSet
from . import prng
from .pipeline import _gather_nodes
from .residency import _bytes_of, _packbits
from .select import NEG, greedy_assign_shortlist


class IndexState(NamedTuple):
    """The device-resident index: per registered class the current
    pre-normalize planes (repaired column by column) and the served
    masked total derived from them. ``score`` is a pure function of
    ``(raw, feasible)``; every mutation re-derives it."""

    raw: torch.Tensor       # (S,C,N) float32 per-scorer raw scores
    feasible: torch.Tensor  # (C,N) bool AND of the filters
    score: torch.Tensor     # (C,N) float32 masked total per class row


def index_eligible(plugin_set: PluginSet) -> bool:
    """May this profile's decisions be served from a maintained index?
    Every active plugin column-local (its filter and score at node n
    read only node n's column), none needing topology or node-affinity
    group state (they read the assigned-pod corpus and batch tables,
    which move every batch), and every scorer's normalize row-local
    (the identity, or a declared ``normalize_row_local`` override): a
    cross-row normalize would couple class rows the step never
    couples."""
    active = plugin_set.filter_plugins + plugin_set.score_plugins
    for p in active:
        if p.needs_topology or p.needs_node_affinity:
            return False
        if not getattr(p, "column_local", False):
            return False
    for p in plugin_set.score_plugins:
        if ((type(p).normalize is not BatchedPlugin.normalize
             or type(p).rescale is not BatchedPlugin.rescale)
                and not getattr(p, "normalize_row_local", False)):
            return False
    return True


def _live(rows_pad, bound: int) -> torch.Tensor:
    """The entries of a host index vector below ``bound`` (the padding
    sentinels are >= bound), as an int64 tensor."""
    rows = np.asarray(rows_pad, dtype=np.int64)
    return torch.from_numpy(rows[rows < bound])


def build_index_ops(plugin_set: PluginSet, k_eff: int):
    """(build, refresh, append, assign) for one profile at indexed-scan
    width ``k_eff`` (any width is exact: the certified scan's in-scan
    repairs absorb a narrow one, so the K-dial needs no rebuild)."""
    if k_eff < 1:
        raise ValueError(f"index scan width {k_eff} must be >= 1")
    filters = plugin_set.filter_plugins
    scorers = plugin_set.score_plugins
    weights = [plugin_set.weight_of(p) for p in scorers]

    def evaluate_raw(class_pf, nf, af):
        """The column-local half of the step's evaluation for the class
        rows: the AND over the filters in order and each scorer's raw
        float32 score, up to the normalize. Eligible plugins read no
        context beyond ``af``. Returns (raw (S,C,M), feasible (C,M))."""
        ctx = {"af": af}
        feasible = class_pf.valid[:, None] & nf.valid[None, :]
        for p in filters:
            feasible = feasible & p.filter(class_pf, nf, ctx)
        raws = [p.score(class_pf, nf, ctx).to(torch.float32)
                for p in scorers]
        raw = (torch.stack(raws) if raws else torch.zeros(
            (0,) + tuple(feasible.shape), dtype=torch.float32,
            device=feasible.device))
        return raw, feasible

    def finalize(raw, feasible):
        """The row-local half over the full planes: normalize, weighted
        float32 sum, NEG mask, in ops/pipeline._evaluate's order."""
        total = torch.zeros(feasible.shape, dtype=torch.float32,
                            device=feasible.device)
        for i, (p, w) in enumerate(zip(scorers, weights)):
            norm = p.normalize(raw[i], feasible).to(torch.float32)
            total = total + w * norm
        return torch.where(feasible, total, NEG)

    def build(class_pf, nf, af) -> IndexState:
        """A full (C,N) evaluation and finalize. Padding class rows are
        invalid: NEG everywhere, never chosen."""
        raw, feas = evaluate_raw(class_pf, nf, af)
        return IndexState(raw=raw, feasible=feas, score=finalize(raw, feas))

    def refresh(state: IndexState, class_pf, nf, af,
                rows_pad) -> IndexState:
        """Re-evaluate the changed node columns ``rows_pad`` (a host int
        vector, padded with sentinels >= N), write them into copies of
        the planes and finalize. Only the live entries are evaluated and
        written: a sentinel clamped to column N-1 would be a duplicate
        index beside a real repair of that column, and a duplicate index
        write is order-undefined on CUDA."""
        dev = state.score.device
        cols = _live(rows_pad, nf.valid.shape[0]).to(dev)
        if cols.numel() == 0:
            return state
        new_raw, new_feas = evaluate_raw(class_pf, _gather_nodes(nf, cols),
                                         af)
        raw = state.raw.index_copy(2, cols, new_raw)
        feas = state.feasible.index_copy(1, cols, new_feas)
        return IndexState(raw=raw, feasible=feas, score=finalize(raw, feas))

    def append(state: IndexState, class_pf, nf, af,
               rows_pad) -> IndexState:
        """Evaluate only the fresh class rows ``rows_pad`` (a host int
        vector, padded with sentinels >= C) over the full node axis,
        write them in and finalize. Existing rows keep their planes (a
        class's features never change) and finalize is row-local, so
        their served rows come out unchanged."""
        dev = state.score.device
        rows = _live(rows_pad, class_pf.valid.shape[0]).to(dev)
        if rows.numel() == 0:
            return state
        pf_sub = class_pf._replace(**{f: getattr(class_pf, f)[rows]
                                      for f in class_pf._fields})
        new_raw, new_feas = evaluate_raw(pf_sub, nf, af)
        raw = state.raw.index_copy(1, rows, new_raw)
        feas = state.feasible.index_copy(0, rows, new_feas)
        return IndexState(raw=raw, feasible=feas, score=finalize(raw, feas))

    def assign(state: IndexState, cls, valid, requests, free0, key):
        """The certified shortlist scan over the class rows gathered per
        pod (``cls`` (P,) class rows on the device): no plugin
        evaluation. Returns one uint8 buffer [chosen i32 × P | assigned
        bits | repaired bits] and the carried ``free_after``;
        ``repaired`` is the scan's in-scan full-row repair ledger (exact,
        counted, never a fallback)."""
        scores_p = torch.where(valid[:, None], state.score[cls.long()], NEG)
        n = free0.shape[0]
        r = greedy_assign_shortlist(scores_p, requests, free0,
                                    prng.bits(key), k=min(k_eff, n))
        packed = torch.cat([_bytes_of(r.chosen.to(torch.int32)),
                            _packbits(r.assigned), _packbits(r.repaired)])
        return packed, r.free_after

    return build, refresh, append, assign


def corrupt_slab(score: torch.Tensor, n_live: int) -> torch.Tensor:
    """The ``index`` fault gate's scribble on a (C,N) score slab: one
    node column per class gets an unbeatable cached score (columns 0 and
    1 alternating by class, so no uniform winner can shadow it): a
    range-sane score the scan's certificate accepts, decision-wrong.
    Only the ``index_check_every`` cross-check can catch it."""
    c = score.shape[0]
    alt = np.minimum(np.arange(c) % 2, max(n_live - 1, 0))
    out = score.clone()
    out[torch.arange(c, device=score.device),
        torch.from_numpy(alt).to(score.device)] = 1e6
    return out


def unpack_index_decision(buf: np.ndarray, p: int) -> Tuple:
    """Host inverse of ``assign``'s pack over the fetched (writable)
    uint8 buffer → (chosen i32, assigned bool, repaired bool)."""
    nb = (p + 7) // 8
    chosen = buf[:4 * p].view(np.int32)
    o = 4 * p
    assigned = np.unpackbits(buf[o:o + nb])[:p].astype(bool)
    o += nb
    repaired = np.unpackbits(buf[o:o + nb])[:p].astype(bool)
    return chosen, assigned, repaired


def index_buffer_bytes(p: int) -> int:
    """Size of ``assign``'s fetch buffer (bytes)."""
    return 4 * p + 2 * ((p + 7) // 8)

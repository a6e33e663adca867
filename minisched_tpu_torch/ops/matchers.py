"""Dense matchers over hashed label and taint features.

Each matcher is a tensor function over (P, …) pod features × (N, …) node
features returning a (P, N) matrix — the batched counterpart of the
per-pair predicates the reference's plugins evaluate one node at a time
(reference minisched/minisched.go:124-137). 0 is the empty-slot sentinel
everywhere.

The JAX package writes each matcher as one broadcast over every slot
axis, which XLA fuses; PyTorch would materialize it (a (P,K,N,T) bool
is 0.9 GB at 1024 pods × 53,248 nodes). Here the small slot axes are
Python loops around (P,N) tensors. The results are booleans and small
integer counts, so the order of the reductions cannot change a bit.
"""
from __future__ import annotations

import torch

from ..encode import features as F


def _present(want: torch.Tensor, have: torch.Tensor) -> torch.Tensor:
    """(P,N) bool: ``want`` (P,) equals some slot of ``have`` (N,L)."""
    out = want[:, None] == have[None, :, 0]
    for l in range(1, have.shape[1]):
        out |= want[:, None] == have[None, :, l]
    return out


def pairs_subset(query: torch.Tensor,
                 node_pairs: torch.Tensor) -> torch.Tensor:
    """All non-empty query pair hashes present in node label pairs.

    query: (P, Q) int32, node_pairs: (N, L) int32 → (P, N) bool.
    The dense form of pod.spec.node_selector matching (ANDed key=value).
    """
    P, N = query.shape[0], node_pairs.shape[0]
    ok = torch.ones((P, N), dtype=torch.bool, device=query.device)
    for q in range(query.shape[1]):
        want = query[:, q]
        ok &= _present(want, node_pairs) | (want == 0)[:, None]
    return ok


def _select_expr(op, val_in, key_in):
    """One expression's verdict (P,N) from its operator (P,)."""
    op = op[:, None]
    out = (op == F.OP_IN) & val_in
    out |= (op == F.OP_NOT_IN) & ~val_in
    out |= (op == F.OP_EXISTS) & key_in
    out |= (op == F.OP_DOES_NOT_EXIST) & ~key_in
    return out


def term_matches(op: torch.Tensor, key: torch.Tensor, vals: torch.Tensor,
                 node_pairs: torch.Tensor,
                 node_keys: torch.Tensor) -> torch.Tensor:
    """Evaluate ORed NodeSelectorTerms of ANDed expressions.

    op/key: (P, T, E) int32, vals: (P, T, E, V) int32,
    node_pairs/node_keys: (N, L) int32 → (P, N) bool (any term, all
    exprs). Operators: In / NotIn / Exists / DoesNotExist. A term with no
    expressions (all op == 0) does not match.
    """
    P, T, E = op.shape
    N = node_pairs.shape[0]
    dev = op.device
    out = torch.zeros((P, N), dtype=torch.bool, device=dev)
    for t in range(T):
        all_exprs = torch.ones((P, N), dtype=torch.bool, device=dev)
        for e in range(E):
            # 0 is the empty slot on both sides: unguarded, padding-zero
            # values would match padding-zero label slots.
            val_in = torch.zeros((P, N), dtype=torch.bool, device=dev)
            for v in range(vals.shape[3]):
                want = vals[:, t, e, v]
                val_in |= (want != 0)[:, None] & _present(want, node_pairs)
            k = key[:, t, e]
            key_in = (k != 0)[:, None] & _present(k, node_keys)
            expr_ok = _select_expr(op[:, t, e], val_in, key_in)
            all_exprs &= expr_ok | (op[:, t, e] == F.OP_NONE)[:, None]
        nonempty = (op[:, t, :] != F.OP_NONE).any(dim=1)
        out |= all_exprs & nonempty[:, None]
    return out


def _tolerated(pf, taint_pairs, taint_keys, taint_effects, t: int):
    """(P,N) bool: some toleration of the pod covers taint slot t of the
    node (upstream v1.Toleration.ToleratesTaint; see objects.Toleration)."""
    nk = taint_keys[None, :, t]
    np_ = taint_pairs[None, :, t]
    ne = taint_effects[None, :, t]
    out = torch.zeros((pf.tol_ops.shape[0], taint_keys.shape[0]),
                      dtype=torch.bool, device=taint_keys.device)
    for k in range(pf.tol_ops.shape[1]):
        tk = pf.tol_keys[:, k, None]
        to = pf.tol_ops[:, k, None]
        te = pf.tol_effects[:, k, None]
        tp = pf.tol_pairs[:, k, None]
        key_ok = (tk == 0) | (tk == nk)  # an empty key matches any taint
        effect_ok = (te == F.EFFECT_NONE) | (te == ne)
        value_ok = (to == F.TOL_EXISTS) | (tp == np_)
        out |= (to != F.TOL_NONE) & key_ok & effect_ok & value_ok
    return out


def tolerations_cover(pf, taint_pairs: torch.Tensor, taint_keys: torch.Tensor,
                      taint_effects: torch.Tensor,
                      effects_requiring_toleration: tuple) -> torch.Tensor:
    """(P, N) bool: every node taint with an effect in
    ``effects_requiring_toleration`` is tolerated by the pod.

    pf tol_* arrays: (P, K); node taint arrays: (N, T)."""
    P, N = pf.tol_ops.shape[0], taint_keys.shape[0]
    ok = torch.ones((P, N), dtype=torch.bool, device=taint_keys.device)
    for t in range(taint_keys.shape[1]):
        needs = torch.zeros((N,), dtype=torch.bool, device=taint_keys.device)
        for e in effects_requiring_toleration:
            needs |= taint_effects[:, t] == e
        ok &= _tolerated(pf, taint_pairs, taint_keys, taint_effects, t) \
            | ~needs[None, :]
    return ok


def untolerated_count(pf, taint_pairs, taint_keys, taint_effects,
                      effect: int) -> torch.Tensor:
    """(P, N) float32: number of node taints with ``effect`` the pod does
    not tolerate (drives TaintToleration scoring)."""
    P, N = pf.tol_ops.shape[0], taint_keys.shape[0]
    count = torch.zeros((P, N), dtype=torch.int32, device=taint_keys.device)
    for t in range(taint_keys.shape[1]):
        is_effect = (taint_effects[:, t] == effect)[None, :]
        count += (is_effect & ~_tolerated(pf, taint_pairs, taint_keys,
                                          taint_effects, t)).to(torch.int32)
    return count.to(torch.float32)

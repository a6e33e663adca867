"""Invariant layer: the checks that turn every lifecycle soak into a
correctness oracle.

Each invariant is a callable ``fn(view) -> list[str]`` (empty = holds);
the driver runs all of them after every generator step and retries a
non-empty result through its settle window (live mode: the event
broadcaster commits Preempted events asynchronously and informers lag
the store by design) before raising
:class:`~.driver.InvariantViolation`.

The default set:

  * **no_pod_lost** — every pod the ledger expects is in the store, or
    its absence is explained by a Preempted event (then it moves to the
    preempted ledger for the reconciler); and no tombstoned pod ever
    resurfaces (resurrection = a stale queue entry re-binding a deleted
    incarnation).
  * **bound_on_live_nodes** — a bound pod's node exists. The store
    refuses bindings to missing nodes and ``delete_node`` sweeps
    post-delete, so any violation is a real engine/GC defect, not a
    tolerated transient.
  * **disruption_budget** (per registered budget) — re-derived from the
    STORE, not the budget object: cordoned live members of the pool
    never exceed max_unavailable. The budget's own high-water is
    checked too (trust, but verify both sides).
  * **monotone_versions** — the store's resource_version and every
    observed object's metadata.resource_version only ever advance
    (generation counters are monotone across churn, delete/recreate
    included).
  * **no_overcommit** — no live node's bound pods exceed its
    allocatable on any axis (the chaos-suite capacity contract, now
    checked continuously instead of at quiescence only).
  * **stable_bindings** — once a pod incarnation (uid) is bound, its
    node NEVER changes: the no-double-bind oracle for fleet failover,
    re-derived from the store every step (a takeover that re-scheduled
    an already-bound pod would trip it immediately).
  * **lease_integrity** — shard-lease fencing re-derived from the
    store: epochs never regress and the holder never changes without an
    epoch bump (two live owners of one shard would require exactly such
    a bumpless swap). Vacuously green outside fleet runs.
  * **steward_uniqueness** — at most one steward lease exists, its
    epoch is monotone, and the crown never changes hands without an
    epoch bump (the self-governing fleet's election fence, re-derived
    from the store). Vacuously green outside elected-fleet runs.
"""
from __future__ import annotations

from typing import Dict, List, Tuple


def no_pod_lost(view) -> List[str]:
    store_keys = {p.key for p in view.store.list("Pod")}
    viols = []
    missing = [k for k in view.expected_pods if k not in store_keys]
    if missing:
        preempted = view.preempted_event_keys()
        for k in missing:
            if k in preempted:
                view.note_preempted(k)
            else:
                viols.append(f"pod {k} silently lost "
                             "(absent, no Preempted event)")
    resurrected = store_keys & view.deleted_pods
    for k in sorted(resurrected):
        viols.append(f"pod {k} resurrected after deletion")
    return viols


def bound_on_live_nodes(view) -> List[str]:
    nodes = {n.metadata.name for n in view.store.list("Node")}
    return [f"pod {p.key} bound to missing node {p.spec.node_name!r}"
            for p in view.store.list("Pod")
            if p.spec.node_name and p.spec.node_name not in nodes]


def budget_respected(budget):
    """Closure invariant over one :class:`~.driver.DisruptionBudget`."""

    def check(view) -> List[str]:
        viols = []
        cordoned = [
            n.metadata.name for n in view.store.list("Node")
            if n.metadata.labels.get("minisched.io/pool") == budget.pool
            and n.spec.unschedulable]
        if len(cordoned) > budget.max_unavailable:
            viols.append(
                f"pool {budget.pool!r}: {len(cordoned)} cordoned "
                f"({sorted(cordoned)}) > max_unavailable "
                f"{budget.max_unavailable}")
        if budget.high_water > budget.max_unavailable:
            viols.append(
                f"pool {budget.pool!r}: budget high-water "
                f"{budget.high_water} > {budget.max_unavailable}")
        return viols

    return check


class MonotoneVersions:
    """Stateful: remembers the highest resource_version seen globally
    and per object; any regression is a violation."""

    def __init__(self):
        self._rv = 0
        self._per_obj: Dict[Tuple[str, str], int] = {}

    def __call__(self, view) -> List[str]:
        viols = []
        rv = view.store.resource_version()
        if rv < self._rv:
            viols.append(f"store resource_version regressed {rv} < {self._rv}")
        self._rv = max(self._rv, rv)
        for kind in ("Node", "Pod"):
            for o in view.store.list(kind):
                k = (kind, o.key)
                r = o.metadata.resource_version
                last = self._per_obj.get(k, 0)
                if r < last:
                    viols.append(
                        f"{kind} {o.key} resource_version regressed "
                        f"{r} < {last}")
                else:
                    self._per_obj[k] = r
        return viols


def no_overcommit(view) -> List[str]:
    nodes = {n.metadata.name: n for n in view.store.list("Node")}
    used: Dict[str, Dict[str, float]] = {}
    for p in view.store.list("Pod"):
        if p.spec.node_name and p.spec.node_name in nodes:
            u = used.setdefault(p.spec.node_name, {})
            for k, v in p.spec.requests.items():
                u[k] = u.get(k, 0.0) + v
    viols = []
    for name, u in used.items():
        alloc = nodes[name].status.allocatable
        for k, v in u.items():
            if v > alloc.get(k, 0) + 1e-6:
                viols.append(f"node {name} over-committed on {k}: "
                             f"{v} > {alloc.get(k)}")
    return viols


class StableBindings:
    """Stateful: remembers every bound pod incarnation's node (keyed by
    uid so a delete/recreate under the same name is a fresh incarnation,
    not a rebind) and flags any later observation that shows a DIFFERENT
    node — the doubly-bound pod a split-brain fleet would produce. The
    store's bind CAS makes this structurally impossible; this check is
    the independent oracle that says so from observed truth alone."""

    def __init__(self):
        self._bound: Dict[str, Tuple[str, str]] = {}  # uid -> (key, node)

    def __call__(self, view) -> List[str]:
        viols = []
        for p in view.store.list("Pod"):
            if not p.spec.node_name:
                continue
            prev = self._bound.get(p.metadata.uid)
            if prev is None:
                self._bound[p.metadata.uid] = (p.key, p.spec.node_name)
            elif prev[1] != p.spec.node_name:
                viols.append(
                    f"pod {p.key} rebound {prev[1]!r} -> "
                    f"{p.spec.node_name!r} (double bind)")
        return viols


class LeaseIntegrity:
    """Stateful: the shard-lease fencing contract re-derived from store
    truth. Per lease, the epoch is monotone and the holder only changes
    together with an epoch bump — renewals keep (holder, epoch) fixed,
    claims/takeovers bump. A bumpless holder swap is exactly the write
    the CAS exists to forbid. Empty-store (non-fleet) runs are green."""

    def __init__(self):
        self._seen: Dict[str, Tuple[int, str]] = {}  # name -> (epoch, holder)

    def __call__(self, view) -> List[str]:
        viols = []
        for lease in view.store.list("Lease"):
            last = self._seen.get(lease.key)
            if last is not None:
                epoch0, holder0 = last
                if lease.epoch < epoch0:
                    viols.append(
                        f"lease {lease.key} epoch regressed "
                        f"{lease.epoch} < {epoch0}")
                elif lease.holder != holder0 and lease.epoch == epoch0:
                    viols.append(
                        f"lease {lease.key} holder changed "
                        f"{holder0!r} -> {lease.holder!r} without an "
                        f"epoch bump")
            self._seen[lease.key] = (lease.epoch, lease.holder)
        return viols


class StewardUniqueness:
    """Stateful: the steward-election fencing contract (self-governing
    fleet, fleet/election.py) re-derived from store truth. The steward
    role lives in ONE named Lease (``shardmap.steward_name()``); this
    invariant pins exactly what the election CAS must guarantee:

      * no duplicate steward record ever appears (a second lease with
        the steward's reserved shard sentinel would be two thrones);
      * the steward epoch is monotone — a regression would un-fence
        every directive the newer steward already stamped;
      * the crown never changes hands without an epoch bump — a
        bumpless swap is exactly the two-live-stewards write the CAS
        exists to forbid.

    Non-elected runs (no steward lease in the store) are vacuously
    green, so the invariant is safe in every default soak."""

    STEWARD_NAME = "steward"

    def __init__(self):
        self._last: Tuple[int, str] = (0, "")  # (epoch, holder)

    def __call__(self, view) -> List[str]:
        viols = []
        crowns = [l for l in view.store.list("Lease")
                  if l.key == self.STEWARD_NAME or l.shard < 0]
        if not crowns:
            return viols
        if len(crowns) > 1:
            viols.append(
                "duplicate steward leases: "
                + ", ".join(sorted(l.key for l in crowns)))
        lease = next((l for l in crowns if l.key == self.STEWARD_NAME),
                     crowns[0])
        epoch0, holder0 = self._last
        if lease.epoch < epoch0:
            viols.append(f"steward epoch regressed "
                         f"{lease.epoch} < {epoch0}")
        elif (lease.holder and holder0 and lease.holder != holder0
                and lease.epoch == epoch0):
            viols.append(
                f"steward changed {holder0!r} -> {lease.holder!r} "
                f"without an epoch bump (two live stewards)")
        self._last = (max(lease.epoch, epoch0), lease.holder or holder0)
        return viols


def default_invariants(driver):
    """(name, fn) pairs the driver installs by default — the standard
    oracle plus one budget invariant per registered pool budget."""
    out = [
        ("no_pod_lost", no_pod_lost),
        ("bound_on_live_nodes", bound_on_live_nodes),
        ("monotone_versions", MonotoneVersions()),
        ("no_overcommit", no_overcommit),
        ("stable_bindings", StableBindings()),
        ("lease_integrity", LeaseIntegrity()),
        ("steward_uniqueness", StewardUniqueness()),
    ]
    for pool, b in sorted(driver.budgets().items()):
        out.append((f"disruption_budget[{pool}]", budget_respected(b)))
    return out

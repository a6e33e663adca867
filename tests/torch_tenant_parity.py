"""Shared recipes of the tenant fusion parity tests: one coordinator
runner that drives either package's TenantFusionCoordinator on the same
stores, with every round single-stepped.

Rounds are stepped with ``serve_round()`` (no serve thread): each wave's
pods are in the tenants' stores and queued before the first round, and
after each round the runner waits until every bind the round made is in
the store and each tenant's cache has gone quiet (the informer confirmed
the binds). Then no cache mutation lands between a lane's submit and the
mux's dispatch, or between an index drain and its serve, and the
batches, the races and so every counter follow the inputs, not the
informer's timing.
"""
import time
from types import SimpleNamespace

from minisched_tpu.config import SchedulerConfig as JConfig
from minisched_tpu.service.defaultconfig import Profile as JProfile
from minisched_tpu.service.service import Tenant as JTenant
from minisched_tpu.service.service import \
    TenantFusionCoordinator as JCoordinator
from minisched_tpu.state import objects as JO
from minisched_tpu.state.store import ClusterStore as JStore
from minisched_tpu_torch.config import SchedulerConfig
from minisched_tpu_torch.service.defaultconfig import Profile
from minisched_tpu_torch.service.service import (Tenant,
                                                 TenantFusionCoordinator)
from minisched_tpu_torch.state import objects as TO
from minisched_tpu_torch.state.store import ClusterStore

JAX = SimpleNamespace(name="jax", O=JO, Store=JStore, Tenant=JTenant,
                      Coordinator=JCoordinator, Profile=JProfile,
                      config=lambda **kw: JConfig(**kw))
PORT = SimpleNamespace(name="port", O=TO, Store=ClusterStore, Tenant=Tenant,
                       Coordinator=TenantFusionCoordinator, Profile=Profile,
                       config=lambda **kw: SchedulerConfig(platform="cpu",
                                                           **kw))

NODE_CPUS = (64000, 48000, 40000, 36000)

# Counters of the coordinator's metrics that follow the inputs alone on a
# single-stepped run (no clock, no gap, no byte count of host timing).
TENANT_COUNTERS = ("tenant_rounds", "tenant_dispatches", "tenant_fetches",
                   "tenant_groups", "tenant_lanes_fused", "tenant_races",
                   "tenant_solo_fallbacks", "tenant_index_dispatches",
                   "tenant_index_lanes", "tenant_groups_round_max",
                   "steps_dispatched_total", "decision_fetches_total",
                   "tenant_rounds_served")
ENGINE_COUNTERS = ("batches", "pods_bound", "tenant_fused_lanes",
                   "tenant_races", "tenant_solo_fallbacks",
                   "steps_dispatched", "decision_fetches", "index_hits",
                   "index_fused_hits", "index_lane_ejects", "index_rebuilds",
                   "index_fallbacks", "index_races", "index_repair_rows",
                   "index_appends", "index_checks", "index_desyncs",
                   "scored_rows_total", "batch_faults")


def config(pkg, **kw):
    kw.setdefault("max_batch_size", 24)
    kw.setdefault("batch_window_s", 0.3)
    kw.setdefault("backoff_initial_s", 0.05)
    kw.setdefault("backoff_max_s", 0.2)
    return pkg.config(**kw)


def node_name(i: int) -> str:
    """Node names end in a letter: the default profile's NodeNumber
    permit parks a pod for as many seconds as its node's trailing digit,
    which would pace every round by the binds' waits."""
    return f"vn-n{'abcdefgh'[i]}"


def mk_store(pkg, node_cpus=NODE_CPUS):
    """One tenant's virtual cluster. Node NAMES are the same in every
    tenant: ``name_hash`` is a static leaf, so only then do the tenants'
    static encodings match and their lanes fuse."""
    O = pkg.O
    s = pkg.Store()
    for i, cpu in enumerate(node_cpus):
        s.create(O.Node(
            metadata=O.ObjectMeta(name=node_name(i)), spec=O.NodeSpec(),
            status=O.NodeStatus(allocatable={
                "cpu": float(cpu), "memory": float(64 << 30),
                "pods": 110.0})))
    return s


def pods(O, n, tag, *, cpu0=100, prio=None, classes=None):
    """Deterministic per-tenant pods with unique priorities (they pin the
    pop and scan order); ``classes=k`` cycles k request shapes, so that
    the index registry warms quickly."""
    return [O.Pod(
        metadata=O.ObjectMeta(name=f"{tag}-p{i}", namespace="default"),
        spec=O.PodSpec(
            requests={"cpu": float(cpu0 + 17 * (i % classes if classes
                                                 else i))},
            priority=(1000 - i if prio is None else prio)))
        for i in range(n)]


def bound(coord, names):
    return {nm: {p.metadata.name: p.spec.node_name
                 for p in coord.store(nm).list("Pod") if p.spec.node_name}
            for nm in names}


def _wait(cond, timeout=60.0, what=""):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


def quiet(*caches, span=0.15) -> None:
    """Wait until every cache's version holds still for ``span``
    seconds."""
    last = [c.version for c in caches]
    while True:
        time.sleep(span)
        now = [c.version for c in caches]
        if now == last:
            return
        last = now


def settle(coord, names) -> None:
    """After a round: every placement the engines made is bound in the
    stores, and every tenant's cache is quiet."""
    engines = [coord.engine(nm) for nm in names]
    _wait(lambda: all(
        sum(1 for p in coord.store(nm).list("Pod") if p.spec.node_name)
        >= eng.metrics()["pods_bound"] and eng.metrics()["pods_bound"]
        >= eng.metrics()["pods_assigned"]
        for nm, eng in zip(names, engines)), what="binds")
    quiet(*(eng.cache for eng in engines))


def step_until_drained(coord, names, max_rounds=200) -> None:
    for _ in range(max_rounds):
        if not any(coord.engine(nm).queue.pending_count() for nm in names):
            return
        coord.serve_round()
        settle(coord, names)
    raise AssertionError("the queues did not drain")


def run(pkg, fuse, waves, *, n_tenants=3, names=None, hook=None,
        between=None, pod_fn=None, weights=None, **cfg_kw):
    """One single-stepped coordinator run: ``waves`` is a list of
    per-tenant pod counts; each wave's pods are created and queued, then
    rounds are stepped until the queues drain. ``hook(coord)`` runs
    before the first wave, ``between(coord, w)`` before wave w > 0.
    Returns (placements, metrics)."""
    names = names or [f"t{i}" for i in range(n_tenants)]
    tenants = [pkg.Tenant(name=nm, store=mk_store(pkg),
                          weight=(weights[i] if weights else 1.0))
               for i, nm in enumerate(names)]
    coord = pkg.Coordinator(tenants, config(pkg, **cfg_kw), fuse=fuse)
    pod_fn = pod_fn or (lambda O, n, tag: pods(O, n, tag))
    if hook is not None:
        hook(coord)
    try:
        for eng in coord.engines.values():
            eng._shared.ensure_started()
        for w, counts in enumerate(waves):
            caches = [coord.engine(nm).cache for nm in names]
            if w and between is not None:
                between(coord, w)
                quiet(*caches)
            for nm, n in zip(names, counts):
                if n:
                    coord.store(nm).create_many(pod_fn(pkg.O, n,
                                                       f"{nm}-w{w}"))
            _wait(lambda: [coord.engine(nm).queue.pending_count()
                           for nm in names] == list(counts),
                  what="the wave's pods queued")
            quiet(*caches)
            step_until_drained(coord, names)
        return bound(coord, names), coord.metrics()
    finally:
        coord.shutdown()


def same_counters(jm, pm, names, keys=ENGINE_COUNTERS,
                  tenant_keys=TENANT_COUNTERS):
    for k in tenant_keys:
        assert jm.get(k, 0) == pm.get(k, 0), (k, jm.get(k), pm.get(k))
    for nm in names:
        for k in keys:
            key = f"{nm}_{k}"
            assert jm.get(key, 0) == pm.get(key, 0), (key, jm.get(key),
                                                      pm.get(key))

"""Shared recipes of the observability and overload parity tests: both
packages' modules side by side, their singletons disarmed together, and
one burst runner that drives either engine on the same store content."""
from types import SimpleNamespace

from minisched_tpu import faults as jfaults
from minisched_tpu import obs as jobs
from minisched_tpu.config import SchedulerConfig as JConfig
from minisched_tpu.engine import overload as joverload
from minisched_tpu.engine import scheduler as jscheduler
from minisched_tpu.engine.queue import SchedulingQueue as JQueue
from minisched_tpu.obs import bundle as jbundle
from minisched_tpu.obs import journal as jjournal
from minisched_tpu.obs import slo as jslo
from minisched_tpu.obs import timeseries as jtimeseries
from minisched_tpu.ops.pipeline import build_step as jbuild_step
from minisched_tpu.scenario.runner import Cluster as JCluster
from minisched_tpu.service.defaultconfig import Profile as JProfile
from minisched_tpu.state import objects as JO
from minisched_tpu_torch import faults as tfaults
from minisched_tpu_torch import obs as tobs
from minisched_tpu_torch.config import SchedulerConfig
from minisched_tpu_torch.engine import overload as toverload
from minisched_tpu_torch.engine import scheduler as tscheduler
from minisched_tpu_torch.engine.queue import SchedulingQueue as TQueue
from minisched_tpu_torch.obs import bundle as tbundle
from minisched_tpu_torch.obs import journal as tjournal
from minisched_tpu_torch.obs import slo as tslo
from minisched_tpu_torch.obs import timeseries as ttimeseries
from minisched_tpu_torch.scenario.runner import Cluster, wait_until
from minisched_tpu_torch.service.defaultconfig import Profile
from minisched_tpu_torch.state import objects as TO
from torch_parity import BENCH_PROFILE, bench_cluster

JAX = SimpleNamespace(
    name="jax", Cluster=JCluster, Profile=JProfile, O=JO, Queue=JQueue,
    config=lambda **kw: JConfig(**kw), faults=jfaults, obs=jobs,
    journal=jjournal, timeseries=jtimeseries, slo=jslo,
    overload=joverload, bundle=jbundle, scheduler=jscheduler)
PORT = SimpleNamespace(
    name="port", Cluster=Cluster, Profile=Profile, O=TO, Queue=TQueue,
    config=lambda **kw: SchedulerConfig(platform="cpu", **kw),
    faults=tfaults, obs=tobs, journal=tjournal, timeseries=ttimeseries,
    slo=tslo, overload=toverload, bundle=tbundle, scheduler=tscheduler)

# The JAX engine's metrics() keys the port does not report yet: they
# belong to modules of later slices (the persistent compile cache). A
# slice that ports one of those modules removes its keys here.
LATER_SLICE_KEYS = frozenset({
    "compile_cache_on",
})


def engine_modes():
    """(pipeline, device_resident, shortlist): the six modes of
    tests/test_torch_engine.py."""
    return [(False, False, False), (True, True, True), (False, False, True),
            (True, False, True), (False, True, True), (True, True, False)]


def disarm_all():
    """Disarm every telemetry, actuation and fault singleton of both
    packages (overload first: its disarm releases the sentinel it
    implied, which releases the timeline)."""
    for pkg in (JAX, PORT):
        pkg.overload.configure("")
        pkg.slo.configure("")
        pkg.timeseries.configure(False)
        pkg.obs.configure(False)
        pkg.journal.configure("")
        pkg.bundle.configure("")
        pkg.faults.configure("")


def placements(cluster):
    return {p.key: p.spec.node_name for p in cluster.list_pods()}


def bench_burst(pkg, kw, n_nodes=120, n_pods=300, seed=1, recipe=None,
                white_box=None, pin=None, settle_s=90):
    """Every pod of bench_cluster (or ``recipe(O)``: (first, pods)) in the
    store before the engine starts, then wait until all are bound and
    counted. ``pin(scheduler)`` runs before the engine's loop starts;
    ``white_box(scheduler)`` after the burst. Returns (placements,
    metrics)."""
    first, pods = (bench_cluster(pkg.O, n_nodes, n_pods, seed)
                   if recipe is None else recipe(pkg.O))
    c = pkg.Cluster()
    c.create_objects(first)
    c.create_objects(pods)
    sched_cls = pkg.scheduler.Scheduler
    orig_start = sched_cls.start

    def pinned_start(self):
        pin(self)
        orig_start(self)

    if pin is not None:
        sched_cls.start = pinned_start
    try:
        c.start(pkg.Profile(**BENCH_PROFILE), pkg.config(**kw))
    finally:
        sched_cls.start = orig_start
    try:
        sched = c.service.scheduler
        assert wait_until(
            lambda: all(p.spec.node_name for p in c.list_pods()),
            timeout=settle_s)
        # Counted too: a bulk bind feeds the lifecycle histograms before
        # it adds its pods to ``pods_bound``, so a snapshot between the
        # two reads more histogram entries than bound pods.
        assert wait_until(
            lambda: (lambda m: m["pods_assigned"] >= len(pods)
                     and m["pods_bound"] >= len(pods))(sched.metrics()),
            timeout=settle_s)
        if white_box is not None:
            white_box(sched)
        return placements(c), sched.metrics()
    finally:
        c.shutdown()


def pin_rung(pkg, level, sl_exp=0, shortlist_k=None, tune_steps=None):
    """A ``pin`` for bench_burst: the overload controller held at
    ``level`` (tune depth ``tune_steps``, by default as the ladder sets
    it; shortlist exponent ``sl_exp``) with its hysteresis clocks at
    zero, and the engine's
    step rebuilt at the tuner's width, as the JAX engine's
    ``_drive_overload`` applies it. Arm the controller with a huge
    ``hold`` so that no window moves it."""
    def pin(sched):
        ov = sched._overload
        ov.level = level
        ov.tune_steps = (min(level, pkg.overload.OVERLOAD.tune_max)
                         if tune_steps is None else tune_steps)
        ov.sl_exp = sl_exp
        ov._since_change = ov._sl_since = 0
        want = ov.shortlist_target(sched._sl_base)
        if want is not None and want != sched._shortlist_k:
            sched._shortlist_k = want
            if pkg is JAX:
                sched._step = jbuild_step(
                    sched.plugin_set, explain=sched.config.explain,
                    assignment=sched.config.assignment, shortlist=want)
            else:
                sched._set_shortlist_k(want)
        if shortlist_k is not None:
            assert sched._shortlist_k == shortlist_k
    return pin

"""The port's overload controller against the JAX package's.

Each package arms its own ``OVERLOAD`` (and the sentinel and timeline it
implies) through its own ``configure``. The controllers take the
sequences of tests/test_overload.py and give equal levels, effective
knobs, shortlist targets and metrics; the spec grammars accept and
reject the same strings; both queues' shed lanes shed and release the
same pods. On the engine, at 120 nodes and at 1,200 (sampled): the
disarmed engine, the armed engine over clean traffic and the JAX
engine armed alike place every pod the same way in all six modes;
rungs 1 (the tuner: batches of a quarter, K=512) and 3 (brownout: node
sampling at ``brownout_pct``) pinned with ``hold=1000000`` place as the
JAX engine does on the same pins; a rung-2 burst loses no pod and sheds
as many as the JAX engine; brownout is entered and left in ladder
order.
"""
import time

import pytest

from minisched_tpu.engine import overload as jov
from minisched_tpu_torch.engine import overload as tov
from torch_obs_parity import (JAX, PORT, bench_burst, disarm_all,
                              engine_modes, pin_rung)
from torch_parity import sampled_cluster


@pytest.fixture(autouse=True)
def disarm():
    disarm_all()
    yield
    disarm_all()


# ---- grammar and arming ----------------------------------------------------

SPECS = [
    "1", "", "shed_priority=500,min_batch=8,hold=3,brownout_pct=25",
    "shed_priority=0,hold=1;noisy:shed_priority=500",
    "shed_priority=0;a:shed_priority=1;b:shed_priority=-3",
    "frobnicate=1", "shed_priority", "hold=0", "shed_backoff=0",
    "brownout_pct=100", "brownout_pct=0", "min_batch=zzz", "tune_max=-1",
    "idle_open=-0.5", "window_step=-1", "timeline_stretch=0",
    "probation=0", "shed_backoff_max=0", "http_reject_level=-1",
    "1;noisy:min_batch=4", "1;:shed_priority=5", "1;noisy",
    "hold=2,,probation=3,", "1;;noisy:shed_priority=7",
]


@pytest.mark.parametrize("spec", SPECS)
def test_spec_grammar_matches_jax(spec):
    def outcome(mod):
        try:
            return mod.parse_spec_overrides(spec)
        except ValueError:
            return "rejected"
    assert outcome(tov) == outcome(jov)


def test_arming_chain_in_each_package():
    """Overload implies the sentinel, which implies the timeline, in
    each package on its own singletons; the disarm is symmetric."""
    for pkg in (JAX, PORT):
        other = PORT if pkg is JAX else JAX
        pkg.overload.configure("1")
        assert pkg.overload.OVERLOAD.enabled
        assert pkg.slo.SLO.enabled and pkg.timeseries.TIMELINE.enabled
        assert not other.overload.OVERLOAD.enabled
        assert not other.slo.SLO.enabled
        pkg.overload.configure("")
        assert not pkg.overload.OVERLOAD.enabled
        assert not pkg.slo.SLO.enabled
        assert not pkg.timeseries.TIMELINE.enabled
    assert tov.OVERLOAD_LADDER == jov.OVERLOAD_LADDER
    assert tov._KNOBS == jov._KNOBS


# ---- the controller state machine ------------------------------------------


class _Pod:
    def __init__(self, prio):
        self.spec = type("S", (), {"priority": prio})()


def _state(c, mod):
    """Everything observable of a controller: level, tune depth,
    shortlist exponent, every effective knob at a few bases, the gates
    and its metrics."""
    return (c.level, c.tune_steps, c.sl_exp, sorted(c.last_burning),
            [c.effective_max_batch(b) for b in (8, 64, 1024)],
            [c.effective_window(b) for b in (0.0, 0.01, 0.5)],
            [c.effective_idle(b) for b in (0.0, 0.1)],
            [c.effective_loop_depth(b) for b in (1, 8)],
            [c.shortlist_target(b) for b in (None, 8, 16, 128, 1000)],
            [c.effective_pct_nodes(b) for b in (0, 20, 60, 100)],
            c.brownout_active, c.timeline_stretch, c.shedding,
            [c.admits(_Pod(p)) for p in (-1, 0, 499, 500, 1000)],
            c.metrics())


def _run(mod, spec, script, name="engine"):
    """``script``: a list of (burning set, repairs delta) windows, or
    ("set", attr, value) pokes; returns the state after each step."""
    mod.configure(spec)
    c = mod.OverloadController(name=name)
    out = [_state(c, mod)]
    for step in script:
        if step[0] == "set":
            setattr(c, step[1], step[2])
        else:
            out.append(c.note_window(set(step[0]), step[1]))
        out.append(_state(c, mod))
    c.explain_skip()
    out.append(c.http_reject_reason())
    out.append(_state(c, mod))
    mod.configure("")
    return out


BURN = {"queue_wait_p95"}
LAT = {"create_bound_p99"}
SCRIPTS = {
    # Oscillating burn/clean: the ladder only ratchets up, then sustained
    # clean windows walk it down one rung per probation.
    "ratchet": ("hold=2,probation=2",
                [(BURN if i % 2 == 0 else (), 0.0) for i in range(16)]
                + [((), 0.0)] * 20),
    # Repairs widen K, a latency burn with no repairs narrows it.
    "tuner": ("hold=1,probation=1",
              [(LAT, 0.0), (LAT, 5.0), (LAT, 0.0), (LAT, 0.0), (LAT, 0.0),
               (LAT, 3.0), (LAT, 3.0), (LAT, 3.0), ((), 0.0), ((), 0.0),
               ((), 0.0), ((), 0.0)]),
    # The knob catalogue at pinned levels, as test_overload.py pokes it.
    "knobs": ("min_batch=16,brownout_pct=40,hold=1,probation=1,"
              "shed_priority=500",
              [("set", "level", 2), ("set", "tune_steps", 2),
               ("set", "level", 3), ("set", "sl_exp", 2),
               ("set", "sl_exp", -2), ("set", "sl_exp", -4),
               ("set", "level", 1), ("set", "tune_steps", 1)]),
    # A per-profile shed budget.
    "budget": ("shed_priority=0,hold=1;noisy:shed_priority=500",
               [(BURN, 0.0), (BURN, 0.0), (BURN, 0.0), (BURN, 1.0)]),
    # http_reject_level reached and the brownout's explain skip.
    "reject": ("http_reject_level=2,hold=1,probation=1",
               [(BURN, 0.0), (BURN, 0.0), (BURN, 0.0), ((), 0.0)]),
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
@pytest.mark.parametrize("profile", ["engine", "noisy"])
def test_controller_sequences_match_jax(name, profile):
    spec, script = SCRIPTS[name]
    assert _run(tov, spec, script, profile) == _run(jov, spec, script,
                                                    profile)


def test_ladder_hysteresis_on_the_port():
    """test_overload.py's ladder contract on the port's controller: no
    flapping under oscillating input, one rung per hold window, recovery
    in order, counters summing."""
    tov.configure("hold=2,probation=2")
    c = tov.OverloadController()
    levels = []
    for i in range(16):
        c.note_window(BURN if i % 2 == 0 else set())
        levels.append(c.level)
    assert levels == sorted(levels) and c.level == 3
    changes = [i for i in range(1, 16) if levels[i] != levels[i - 1]]
    assert all(b - a >= 2 for a, b in zip(changes, changes[1:]))
    rec = []
    for _ in range(20):
        c.note_window(set())
        rec.append(c.level)
    assert rec[-1] == 0 and rec == sorted(rec, reverse=True)
    m = c.metrics()
    assert m["overload_escalations"] == m["overload_recoveries"] == 3
    assert m["overload_brownouts"] == 1
    assert m["overload_transitions"] == 6
    assert c.sl_exp == 0 and c.tune_steps == 0


def test_idle_open_gates_in_both_packages():
    states = []
    for mod in (jov, tov):
        mod.configure("shed_priority=500,idle_open=0.2,http_reject_level=2")
        c = mod.OverloadController()
        c.level = 3
        low = _Pod(0)
        got = [c.admits(low), c.http_reject_reason() is not None]
        time.sleep(0.25)
        got += [c.admits(low), c.http_reject_reason() is None, c.level]
        c.note_window(BURN)
        got += [c.admits(low), c.http_reject_reason() is not None]
        states.append(got)
        mod.configure("")
    assert states[0] == states[1] == [False, True, True, True, 3, False,
                                      True]


def _qpod(O, name, prio):
    return O.Pod(metadata=O.ObjectMeta(name=name, namespace="default"),
                 spec=O.PodSpec(requests={"cpu": 10}, priority=prio))


def _shed_lane(pkg):
    pkg.overload.configure("shed_priority=500")
    c = pkg.overload.OverloadController()
    c.level = 2
    q = pkg.Queue({}, backoff_initial=0.05, backoff_max=0.2)
    q.set_admission(c.admits, backoff_fn=lambda: (5.0, 5.0))
    try:
        O = pkg.O
        q.add(_qpod(O, "low-1", 0))
        q.add(_qpod(O, "high-1", 1000))
        q.add_many([_qpod(O, "low-2", 100), _qpod(O, "high-2", 500)])
        out = [q.stats()]
        out.append(sorted(b.pod.metadata.name for b in q.pop_batch(
            8, timeout=1.0)))
        c.level = 1
        out.append(q.release_shed())
        out.append(q.stats())
        out.append(sorted(b.pod.metadata.name for b in q.pop_batch(
            8, timeout=1.0)))
        return out
    finally:
        q.close()
        pkg.overload.configure("")


def test_shed_lane_matches_jax():
    """Both queues shed only the low-priority arrivals, pop the rest,
    and release the lane whole on recovery."""
    got, want = _shed_lane(PORT), _shed_lane(JAX)
    assert got == want
    assert want[0]["shed"] == 2 and want[1] == ["high-1", "high-2"]
    assert want[2] == 2 and want[4] == ["low-1", "low-2"]


def test_idle_queue_releases_a_stuck_shedding_lane_on_the_port():
    tov.configure("shed_priority=500")
    c = tov.OverloadController()
    c.level = 3
    q = PORT.Queue({}, backoff_initial=0.05, backoff_max=0.2)
    q.set_admission(c.admits, backoff_fn=lambda: (0.1, 0.3))
    try:
        q.add(_qpod(PORT.O, "stranded", 0))
        assert q.stats()["shed"] == 1
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline and q.stats()["shed"]:
            time.sleep(0.02)
        st = q.stats()
        assert st["shed"] == 0 and st["active"] == 1 and (
            st["shed_readmitted"] == 1)
    finally:
        q.close()


def test_a_shed_wave_is_re_offered_whole_on_the_port():
    """Pods shed in one ingress transaction fall due together: a gate
    slow enough that the wave's parks span several flush passes still
    sees the whole wave re-admitted in one pass by the idle override,
    each pod shed once: a re-admitted first part would make the queue
    busy for the rest, which the closed gate would re-park."""
    def closed_gate(pod):
        time.sleep(0.005)
        return False

    q = PORT.Queue({}, backoff_initial=0.05, backoff_max=0.2)
    q.set_admission(closed_gate, backoff_fn=lambda: (0.2, 0.2))
    try:
        q.add_many([_qpod(PORT.O, f"low-{i}", 0) for i in range(20)])
        assert q.stats()["shed"] == 20
        deadline = time.monotonic() + 3.0
        while time.monotonic() < deadline and q.stats()["shed"]:
            time.sleep(0.02)
        st = q.stats()
        assert st["shed"] == 0 and st["active"] == 20
        assert st["shed_total"] == st["shed_readmitted"] == 20
    finally:
        q.close()


# ---- the engine ------------------------------------------------------------

SIZES = {"120": dict(max_batch_size=64, seed=1),
         "1200": dict(max_batch_size=64, seed=0)}


def _burst(pkg, size, kw, **more):
    if size == "1200":
        return bench_burst(pkg, kw, recipe=sampled_cluster, **more)
    return bench_burst(pkg, kw, **more)


@pytest.mark.parametrize("size", sorted(SIZES))
@pytest.mark.parametrize("pipeline,resident,shortlist", engine_modes())
def test_armed_clean_places_as_disarmed_and_as_jax(size, pipeline, resident,
                                                   shortlist):
    """The controller armed with its default knobs over a clean burst
    actuates nothing: placements equal the disarmed port's and the armed
    JAX engine's, no pod shed, no reject, the bases in force."""
    kw = dict(SIZES[size], pipeline=pipeline, device_resident=resident,
              shortlist=shortlist)
    base, m0 = _burst(PORT, size, kw)
    assert m0["overload_level"] == 0 and m0["shed_total"] == 0
    PORT.overload.configure("1")
    got, m1 = _burst(PORT, size, kw)
    JAX.overload.configure("1")
    want, jm = _burst(JAX, size, kw)
    assert got == base == want
    assert m1["pods_bound"] == m0["pods_bound"] == jm["pods_bound"]
    for m in (m1, jm):
        assert m["overload_level"] == 0 and m["shed_total"] == 0
        assert m["admission_rejects_total"] == 0
        assert m["overload_max_batch"] == 64
        assert m["overload_shortlist_k"] == (128 if shortlist else 0)
    assert m1["sampled_batches"] == (m1["batches"] if size == "1200"
                                     else 0)


PINS = {
    # rung 1: the tuner at two steps and K widened twice (K=512)
    "tuned": dict(level=1, tune_steps=2, sl_exp=2, shortlist_k=512),
    # rung 3: brownout, node sampling at brownout_pct
    "brownout": dict(level=3, sl_exp=0, shortlist_k=128),
}
# The node sample each pin draws at 1,200 nodes in batches of 16: the
# auto percentage (41%) gives K=512; brownout_pct=20 pulls it to 256.
# (At the default brownout_pct of 50 the sample would reach half the
# node pad and the engine would score the full axis instead.)
PIN_SAMPLE_K = {"tuned": 512, "brownout": 256}
QUIET_SLO = "create_bound_p99=1000,queue_wait_p95=1000"


@pytest.mark.parametrize("size", sorted(SIZES))
@pytest.mark.parametrize("rung", sorted(PINS))
@pytest.mark.parametrize("pipeline", [True, False])
def test_pinned_rungs_place_as_jax(size, rung, pipeline):
    """Rungs 1 and 3 pinned (``hold=1000000``: no window moves the
    level): the port places every pod where the JAX engine does on the
    same pin, with the pinned knobs in force."""
    kw = dict(SIZES[size], pipeline=pipeline)
    spec = "hold=1000000,probation=1000000,min_batch=16,brownout_pct=20"
    pin = PINS[rung]
    picked = []

    def sample_k(sched):
        n = sched.cache.node_count()
        picked.append(sched._sampled_step(sched._node_pad(n), 16, False)[1])

    for pkg in (PORT, JAX):
        # A sentinel that never burns: a burning window would set the
        # tune depth to the level's (the JAX engine's first compiles
        # alone exceed the default create-to-bound objective).
        pkg.slo.configure(QUIET_SLO)
        pkg.overload.configure(spec)
    got, m = _burst(PORT, size, kw, pin=pin_rung(PORT, **pin),
                    white_box=sample_k)
    want, jm = _burst(JAX, size, kw, pin=pin_rung(JAX, **pin))
    assert got == want
    for mm in (m, jm):
        assert mm["overload_level"] == pin["level"]
        assert mm["overload_max_batch"] == 16
        assert mm["overload_shortlist_k"] == pin["shortlist_k"]
        # sampled_cluster's "resident" pod was bound before the burst
        assert mm["pods_bound"] == len(got) - (size == "1200")
    assert m["batches"] == jm["batches"]
    if size == "1200":
        assert m["sampled_batches"] == m["batches"]
        assert picked == [PIN_SAMPLE_K[rung]]
    else:
        assert picked == [None] and m["sampled_batches"] == 0
    if rung == "brownout":
        assert m["brownout_active"] == jm["brownout_active"] == 1


def _rung2_burst(pkg, n_high=24, n_low=24):
    """Level 2 pinned before the informers list the pods (every object
    is in the store first, so the low-priority half reaches the gate in
    one transaction); tune depth 0, so one batch takes every admitted
    pod and the queue is idle when the shed pods are re-offered. Every
    pod must bind. Returns (metrics, bound names, pod count)."""
    O = pkg.O
    pkg.timeseries.configure(True, every="1", capacity=512)
    pkg.overload.configure("hold=1000000,probation=1000000,shed_priority=500,"
                           "shed_backoff=1,shed_backoff_max=1")
    c = pkg.Cluster()
    c.create_objects([O.Node(
        metadata=O.ObjectMeta(name=f"n{i}"),
        status=O.NodeStatus(allocatable={"cpu": 640000.0,
                                         "memory": float(1 << 40),
                                         "pods": 10000.0}))
        for i in range(4)])
    pods = [O.Pod(metadata=O.ObjectMeta(name=f"p{i}", namespace="default"),
                  spec=O.PodSpec(requests={"cpu": 50},
                                 priority=1000 if i % 2 else 0))
            for i in range(n_high + n_low)]
    c.create_objects(pods)
    sched_cls = pkg.scheduler.Scheduler
    orig = sched_cls.start

    def pinned(self):
        pin_rung(pkg, 2, tune_steps=0)(self)
        orig(self)

    sched_cls.start = pinned
    try:
        c.start(pkg.Profile(plugins=["NodeUnschedulable", "NodeResourcesFit",
                                     "NodeResourcesLeastAllocated"]),
                pkg.config(max_batch_size=64, seed=3),
                with_pv_controller=False)
    finally:
        sched_cls.start = orig
    try:
        sched = c.service.scheduler
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            if sched.metrics()["pods_bound"] >= len(pods):
                break
            time.sleep(0.05)
        m = sched.metrics()
        bound = {p.metadata.name for p in c.list_pods() if p.spec.node_name}
        return m, bound, len(pods)
    finally:
        c.shutdown()


def test_rung2_burst_loses_nothing_and_sheds_as_jax():
    m, bound, n = _rung2_burst(PORT)
    jm, jbound, _ = _rung2_burst(JAX)
    assert len(bound) == len(jbound) == n
    assert m["pods_bound"] == jm["pods_bound"] == n
    assert m["shed_total"] == jm["shed_total"] == 24
    assert m["queue_shed_pods"] == jm["queue_shed_pods"] == 24
    assert m["queue_shed"] == jm["queue_shed"] == 0
    assert m["overload_level"] == jm["overload_level"] == 2


def _ladder_walk(pkg):
    """Drive the ladder through real snapshot windows: an objective
    every window with a bind breaches walks it up to brownout; a
    reconfigured sentinel that never burns walks it down. Returns the
    journal's (kind, to) transitions and the final metrics."""
    O = pkg.O
    pkg.journal.configure("1")
    pkg.timeseries.configure(True, every="1", capacity=512)
    pkg.slo.configure("create_bound_p99=0.000001,short=30,long=60")
    pkg.overload.configure("hold=1,probation=3,timeline_stretch=2")
    c = pkg.Cluster()
    c.start(pkg.Profile(plugins=["NodeUnschedulable", "NodeResourcesFit",
                                 "NodeResourcesLeastAllocated"]),
            pkg.config(max_batch_size=4, seed=5), with_pv_controller=False)
    try:
        for i in range(4):
            c.create_node(f"n{i}", cpu=640000, pods=10000)
        sched = c.service.scheduler
        ov = sched._overload
        made = [0]

        def wave(k=3):
            c.create_objects([
                O.Pod(metadata=O.ObjectMeta(name=f"w{made[0] + j}",
                                            namespace="default"),
                      spec=O.PodSpec(requests={"cpu": 10}, priority=1000))
                for j in range(k)])
            made[0] += k

        deadline = time.monotonic() + 60
        while ov.level < 3 and time.monotonic() < deadline:
            wave()
            time.sleep(0.05)
        assert ov.level == 3, f"never reached brownout ({ov.level})"
        assert sched.metrics()["brownout_active"] == 1
        assert sched._timeline.stretch == 2
        pkg.slo.configure("create_bound_p99=1000,queue_wait_p95=1000,"
                          "short=30,long=60")
        deadline = time.monotonic() + 90
        while ov.level > 0 and time.monotonic() < deadline:
            wave()
            time.sleep(0.05)
        assert wait_bound(sched, made)
        m = sched.metrics()
        assert sched._timeline.stretch == 1
        steps = [(e["kind"], e["to"]) for e in pkg.journal.JOURNAL.entries()
                 if e["kind"] in ("overload.escalate", "overload.recover")]
        levels = [e.get("overload_level", 0)
                  for e in sched.timeline()["entries"]]
        return steps, levels, m, made[0]
    finally:
        c.shutdown()


def wait_bound(sched, made):
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        if sched.metrics()["pods_bound"] >= made[0]:
            return True
        time.sleep(0.05)
    return False


def test_brownout_enters_and_leaves_in_ladder_order():
    want = [("overload.escalate", "tuned"), ("overload.escalate", "shedding"),
            ("overload.escalate", "brownout"), ("overload.recover", "shedding"),
            ("overload.recover", "tuned"), ("overload.recover", "normal")]
    for pkg in (PORT, JAX):
        steps, levels, m, made = _ladder_walk(pkg)
        assert steps == want, (pkg.name, steps)
        assert all(abs(b - a) <= 1 for a, b in zip(levels, levels[1:]))
        assert m["overload_level"] == 0 and m["brownout_active"] == 0
        assert m["overload_escalations"] == m["overload_recoveries"] == 3
        assert m["overload_brownouts"] == 1
        assert (m["overload_transitions"]
                == m["overload_escalations"] + m["overload_recoveries"])
        assert m["pods_bound"] == made and m["shed_total"] == 0
        disarm_all()

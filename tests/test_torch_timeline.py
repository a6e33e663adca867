"""The port's telemetry ring and SLO sentinel against the JAX package's.

Each package arms its own process-wide singletons through its own
``configure`` (``obs/timeseries.py`` and ``obs/slo.py`` in both). The
same sequence of ``metrics()``-shaped dicts fed to both
``TimelineTracker``s gives equal rows; the same rings fed to both
``SLOSentinel``s give equal alerts and ``last_cleared``; both grammars
accept and reject the same strings. Wall-clock fields (``t``, ``unix``)
are checked for type and sign only. On the engine: an armed burst
snapshots, the sentinel's alert reaches the supervisor as an early
warning, and placements stay those of the disarmed engine and of the
JAX engine armed alike.
"""
import time

import pytest

from minisched_tpu.obs import slo as jslo
from minisched_tpu.obs import timeseries as jts
from minisched_tpu_torch.obs import slo as tslo
from minisched_tpu_torch.obs import timeseries as tts
from minisched_tpu_torch.engine.scheduler import (SLO_PREARM_BATCHES,
                                                  SLO_PREARM_WATCHDOG_S)
from torch_obs_parity import (JAX, PORT, bench_burst, disarm_all,
                              engine_modes)

WALL = ("t", "unix")


@pytest.fixture(autouse=True)
def disarm():
    disarm_all()
    yield
    disarm_all()


def _wall_free(entry):
    """``entry`` without its wall-clock fields, which must be numbers >= 0."""
    for k in WALL:
        if k in entry:
            assert isinstance(entry[k], (int, float)) and entry[k] >= 0, k
    return {k: v for k, v in entry.items() if k not in WALL}


def _metrics_seq(n):
    """``n`` metrics()-shaped dicts: growing counters and gauges,
    histogram counts whose window deltas stay positive, a desync and a
    fault fire partway."""
    out = []
    for i in range(1, n + 1):
        out.append({
            "batches": i, "pods_bound": 3 * i, "pods_failed": i // 4,
            "degradation_level": 1 if 5 <= i < 8 else 0,
            "batch_faults": i // 6, "quarantined_batches": 0,
            "supervisor_escalations": i // 5, "bind_conflicts": 0,
            "watchdog_trips": 0, "supervisor_early_warnings": i // 7,
            "shortlist_repairs": 2 * i, "queue_shed_total": i // 3,
            "queue_active": 10 - i % 10, "queue_backoff": i % 3,
            "queue_unschedulable": 1, "shortlist_width": 128,
            "waiting_pods": 0, "overload_level": min(i // 4, 3),
            "queue_shed": i % 2,
            "residency_desyncs": 1 if i >= 9 else 0, "shortlist_desyncs": 0,
            "fault_fires_step": i // 5, "fault_fires_fetch": 0,
            "histograms": {
                "pod_create_to_bound_s": {
                    "bounds": [0.1, 1.0], "counts": [2 * i, i, i // 3],
                    "sum": 0.0, "count": 3 * i + i // 3},
                "pod_queue_wait_s": {
                    "bounds": [0.05, 0.5], "counts": [i, i // 2, 0],
                    "sum": 0.0, "count": i + i // 2},
            },
        })
    return out


def _feed(ts, seq, every, capacity, tags=None):
    ts.configure(True, every=every, capacity=capacity)
    state = {"i": 0}
    tr = ts.TimelineTracker(lambda: seq[state["i"]], name="bench")
    rows = []
    for i in range(len(seq)):
        state["i"] = i
        if tags and i in tags:
            ts.note_activity(*tags[i])
        e = tr.tick()
        if e is not None:
            rows.append(e)
    ts.configure(False)
    return rows, tr


@pytest.mark.parametrize("every,capacity", [("1", 512), ("2", 4),
                                            ("3", 8)])
def test_timeline_rows_match_jax(every, capacity):
    """The same metrics sequence through both trackers: every row equal
    (gauges, counter deltas, histogram-delta quantiles, tags, seq,
    profile), the same ring after wrapping, the same drop count."""
    seq = _metrics_seq(24)
    tags = {3: ("reclaim", 3), 7: ("invariant_violation", 1),
            8: ("upgrade", 2)}
    want, jtr = _feed(jts, seq, every, capacity, tags)
    got, ttr = _feed(tts, seq, every, capacity, tags)
    assert want and [_wall_free(e) for e in got] == [
        _wall_free(e) for e in want]
    assert [_wall_free(e) for e in ttr.entries()] == [
        _wall_free(e) for e in jtr.entries()]
    assert ttr.snapshots() == jtr.snapshots()
    assert ttr.dropped() == jtr.dropped()
    jdoc, tdoc = jtr.to_doc(since=2), ttr.to_doc(since=2)
    jdoc["entries"] = [_wall_free(e) for e in jdoc["entries"]]
    tdoc["entries"] = [_wall_free(e) for e in tdoc["entries"]]
    assert tdoc == jdoc


def test_timeline_disarmed_and_wall_clock_cadence():
    assert not tts.TIMELINE.enabled
    tts.note_activity("x")
    assert tts.TIMELINE.activity() == {}
    tr = tts.TimelineTracker(lambda: {})
    assert tr.entries() == [] and tr.to_doc()["enabled"] is False
    tts.configure(True, every="50ms", capacity=8)
    seq = _metrics_seq(3)
    state = {"i": 0}
    tr = tts.TimelineTracker(lambda: seq[state["i"]])
    assert tr.tick() is None  # prime
    assert tr.tick() is None  # inside the window
    time.sleep(0.06)
    state["i"] = 1
    assert tr.tick() is not None
    tts.configure(True, every="1", capacity=8)  # new epoch: re-prime
    assert tr.tick() is None and tr.entries() == []
    assert tr.tick() is not None


@pytest.mark.parametrize("tok", ["8", "1", "2s", "500ms", "0.5s", "0",
                                 "-1", "0s", "-5s", "junk", "bogus",
                                 "", "3x", "ms"])
def test_parse_every_grammar_matches_jax(tok):
    def outcome(mod):
        try:
            return mod.parse_every(tok)
        except ValueError:
            return "rejected"
    assert outcome(tts) == outcome(jts)


@pytest.mark.parametrize("spec", [
    "1", "", "create_bound_p99=0.25,short=2,long=8,burn=0.4",
    "queue_wait_p95=0.3", "desync_rate=0,batch_fault_rate=1",
    "nope=1", "burn=2.0", "burn=0", "create_bound_p99", "short=-1",
    "long=0", "short=abc", ",,queue_wait_p95=1,,"])
def test_slo_grammar_matches_jax(spec):
    def outcome(mod):
        try:
            specs, s, l, b = mod.parse_spec(spec)
        except ValueError:
            return "rejected"
        return ([(sp.name, sp.kind, sp.key, sp.threshold, sp.incident)
                 for sp in specs], s, l, b)
    assert outcome(tslo) == outcome(jslo)


def _ring(values, dt=1.0, key="create_bound_p99_s", **extra):
    out = []
    for i, v in enumerate(values):
        e = {"t": i * dt, "degradation_level": 0, **extra}
        if v is not None:
            e[key] = v
        out.append(e)
    return out


RINGS = [
    _ring([0.1] * 8),
    _ring([0.1] * 7 + [5.0]),
    _ring([0.1] * 2 + [5.0] * 6),
    _ring([0.1] * 2 + [5.0] * 6),
    _ring([0.1] * 8),
    _ring([None, 5.0, None, 5.0, None, 5.0, None, 5.0]),
    _ring([None] * 8),
    [{"t": float(i), "d_desyncs": 1.0 if i == 19 else 0.0,
      "degradation_level": 2 if i > 15 else 0,
      "tags": {"invariant_violation": 1} if i == 18 else {},
      "queue_wait_p95_s": 3.0 if i % 2 else 0.1,
      "d_batch_faults": 0.0} for i in range(20)],
    _ring([0.1] * 8),
]


@pytest.mark.parametrize("spec", ["1", "create_bound_p99=0.5,short=2,"
                                  "long=6,burn=0.5", "burn=0.3,short=3,"
                                  "long=8"])
def test_sentinel_alerts_match_jax(spec):
    """The same sequence of rings through both sentinels: the alerts,
    ``last_cleared``, the burning flags and the read-only gauges equal
    after every evaluation."""
    sents = [mod.SLOSentinel(*mod.parse_spec(spec)) for mod in (jslo, tslo)]
    alerts = cleared = 0
    for ring in RINGS:
        want, got = (s.evaluate([dict(e) for e in ring]) for s in sents)
        assert got == want
        alerts += len(got)
        cleared += len(sents[1].last_cleared)
        assert sents[1].last_cleared == sents[0].last_cleared
        assert sents[1].burning == sents[0].burning
        now = ring[-1]["t"] + 1.0
        assert (sents[1].burning_now(ring, now)
                == sents[0].burning_now(ring, now))
    assert alerts >= 2 and cleared >= 1


def test_slo_arming_implies_timeline_in_each_package():
    for ts, sl in ((jts, jslo), (tts, tslo)):
        assert not ts.TIMELINE.enabled
        sl.configure("1")
        assert ts.TIMELINE.enabled and sl.SLO.enabled
        sl.configure("")
        assert not ts.TIMELINE.enabled
        ts.configure(True, every="3", capacity=32)
        sl.configure("create_bound_p99=0.5")
        assert ts.TIMELINE.every_batches == 3
        sl.configure("")
        assert ts.TIMELINE.enabled
        ts.configure(False)
    # the packages' singletons are their own
    tts.configure(True)
    assert not jts.TIMELINE.enabled
    assert tts.TIMELINE is not jts.TIMELINE and tslo.SLO is not jslo.SLO


@pytest.mark.parametrize("pipeline,resident,shortlist", engine_modes())
def test_armed_timeline_keeps_placements_and_snapshots(pipeline, resident,
                                                       shortlist):
    """The timeline and sentinel armed at every batch over a clean
    burst: the port places as it does disarmed and as the JAX engine
    does armed; it snapshots every batch after the first."""
    kw = dict(max_batch_size=32, seed=2, pipeline=pipeline,
              device_resident=resident, shortlist=shortlist)
    base, _ = bench_burst(PORT, kw)

    def arm(pkg):
        pkg.timeseries.configure(True, every="1", capacity=512)
        pkg.slo.configure("create_bound_p99=60,queue_wait_p95=60")

    arm(PORT)
    got, m = bench_burst(PORT, kw)
    arm(JAX)
    want, jm = bench_burst(JAX, kw)
    assert got == base == want
    assert m["timeline_snapshots"] == m["batches"] - 1 >= 4
    assert jm["timeline_snapshots"] == jm["batches"] - 1
    assert m["slo_alerts_total"] == jm["slo_alerts_total"] == 0
    assert m["supervisor_early_warnings"] == 0


def test_burning_slo_warns_the_supervisor_and_keeps_placements():
    """An objective every window breaches (create-to-bound p99 over
    1 µs): the sentinel alerts once on its rising edge, the supervisor
    counts an early warning and pre-arms the watchdog, and placements
    stay the disarmed engine's. The default queue_wait_p95 objective
    (2 s) is pinned out of reach, so that on a loaded host only the
    configured objective can burn and the counts stay exact."""
    kw = dict(max_batch_size=16, seed=4)
    base, _ = bench_burst(PORT, kw, n_pods=200)
    PORT.timeseries.configure(True, every="1", capacity=512)
    PORT.slo.configure("create_bound_p99=0.000001,queue_wait_p95=1000,"
                       "short=60,long=120")
    seen = {}

    def probe(sched):
        seen["prearm"] = sched._sup.prearm
        seen["doc"] = sched.timeline()

    got, m = bench_burst(PORT, kw, n_pods=200, white_box=probe)
    assert got == base
    assert m["slo_alerts_total"] == m["slo_alerts_create_bound_p99"] == 1
    assert m["supervisor_early_warnings"] == 1
    assert m["slo_burning_create_bound_p99"] == 1
    assert 0 < seen["prearm"] <= SLO_PREARM_BATCHES
    alerts = seen["doc"]["alerts"]
    assert [a["slo"] for a in alerts] == ["create_bound_p99"]
    assert seen["doc"]["snapshots"] == m["timeline_snapshots"] >= 2
    assert SLO_PREARM_WATCHDOG_S == 30.0


def test_prearmed_watchdog_and_probation_gate():
    """The supervisor's early-warning contract on a constructed engine:
    a warning pre-arms the watchdog and resets probation, and a burning
    symptom objective holds a degraded engine on its rung."""
    from minisched_tpu_torch.config import SchedulerConfig
    from minisched_tpu_torch.engine.scheduler import (DEGRADATION_LADDER,
                                                      Scheduler)
    from minisched_tpu_torch.service.defaultconfig import Profile
    from minisched_tpu_torch.state.store import ClusterStore
    from torch_parity import BENCH_PROFILE

    eng = Scheduler(ClusterStore(), Profile(**BENCH_PROFILE).build(),
                    SchedulerConfig(platform="cpu", probation_batches=1))
    try:
        sup = eng._sup
        sup.level = 1
        sup.early_warning("slo:test")
        assert sup.prearm == SLO_PREARM_BATCHES and sup._clean == 0
        assert eng.metrics()["supervisor_early_warnings"] == 1
        tslo.configure("1")
        eng._slo_sentinel = tslo.SLOSentinel.from_config(tslo.SLO)
        eng._slo_epoch = tslo.SLO.epoch
        eng._slo_sentinel.burning["queue_wait_p95"] = True
        sup.prearm = 1
        sup.note_clean()
        assert sup.level == 1 and sup.prearm == SLO_PREARM_BATCHES
        # the degraded-posture objective alone does not hold the climb
        eng._slo_sentinel.burning["queue_wait_p95"] = False
        eng._slo_sentinel.burning["degraded_fraction"] = True
        sup.note_clean()
        assert DEGRADATION_LADDER[sup.level] == "resident"
    finally:
        eng.shutdown()

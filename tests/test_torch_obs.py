"""The port engine's observability surface against the JAX engine's.

Each package arms its own singletons through its own ``configure``
(``obs``, ``obs/journal``, ``obs/timeseries``, ``obs/slo``,
``obs/bundle``, ``engine/overload``, ``faults``). The port's
``metrics()`` holds every key of the JAX engine's except those of
modules later slices port (``LATER_SLICE_KEYS``, which only shrinks);
on a pipelined burst the four gap components partition ``gap_s_total``
and every lifecycle histogram counts each bound pod once; the dispatch,
fetch and scored-row counters, the per-batch series and each pod's
provenance (node, batch, step and the path that served it) equal the
JAX engine's; the ``admission`` gate force-sheds an ingress transaction
and loses nothing; a quarantine freezes a bundle whose manifest lists
every file, which tools/postmortem.py accepts; the flight recorder
holds the engine's spans, each batch's carrying its id, and the
collector's pauses, and ``trace_next_batch`` writes a ``torch.profiler``
trace of one batch; the port-only counters (thread CPU per phase,
blocking reads, the step's device span, the collector watch) keep
their relations, and the benchmark's readers of them divide per batch;
upstream's symmetric InterPodAffinity term has its span and counters on
the benchmark's hard-spread mix and none on its claims mix.
Wall-clock fields are checked for type and sign only.
"""
import gc
import json
import os
import subprocess
import sys
import threading
import time

import pytest

from torch_obs_parity import (JAX, LATER_SLICE_KEYS, PORT, bench_burst,
                              disarm_all, placements)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PLUGINS = ["NodeUnschedulable", "NodeResourcesFit",
           "NodeResourcesLeastAllocated"]
GAPS = ("gather", "encode", "fetch", "commit")
HISTS = ("pod_queue_wait_s", "pod_decide_s", "pod_bind_s",
         "pod_create_to_bound_s")
SPANS = ("queue.pop", "encode.pods", "step.dispatch", "fetch.decision",
         "bind.bulk", "prepare", "resolve", "commit")
# The spans of one batch, each carrying the batch's id as ``seq``.
SEQ_SPANS = ("prepare", "step.dispatch", "fetch.decision", "resolve",
             "commit", "bind.bulk")
# The port's metrics() keys the JAX engine does not report.
PORT_ONLY_KEYS = frozenset(
    ["bind_s_total", "prepare_s_total", "resolve_s_total",
     "prepare_cpu_s_total", "resolve_cpu_s_total", "host_syncs_total",
     "fetch_wait_s_total", "step_device_span_s_total",
     "gc_collections_gen0", "gc_collections_gen1", "gc_collections_gen2",
     "gc_pause_s_total", "hard_spread_batches", "sampled_batches",
     "spread_repaired", "spread_revoked", "spread_revoked_enforced",
     "kernel_launches", "snapshots_untracked_total",
     "snapshots_tracked_total", "sym_affinity_s_total",
     "sym_affinity_slots_total", "sym_affinity_terms"]
    + [f"kernel_launches_{k}" for k in (
        "auction", "bid_auction", "caps_scan", "greedy_assign",
        "insert_ports", "shortlist_scan", "shortlist_select")])
# Two CPU clocks read against two wall clocks: their grains.
CLOCK_GRAIN_S = 1e-3


@pytest.fixture(autouse=True)
def disarm():
    disarm_all()
    yield
    disarm_all()


def _arm(pkg):
    pkg.obs.configure(True)
    pkg.journal.configure("1")
    pkg.timeseries.configure(True, every="1", capacity=512)
    pkg.slo.configure("create_bound_p99=1000,queue_wait_p95=1000")
    pkg.overload.configure("1")


def _armed_burst(pkg, kw, white_box=None):
    _arm(pkg)
    try:
        return bench_burst(pkg, kw, white_box=white_box)
    finally:
        disarm_all()


def _check_partition(m):
    total = sum(m[f"gap_{g}_s_total"] for g in GAPS)
    assert abs(total - m["gap_s_total"]) <= 1e-9 * max(1, m["batches"])
    ser = m["batch_series"]
    for g in GAPS:
        assert len(ser[f"gap_{g}_s"]) == m["batches"]
        assert all(isinstance(v, float) and v >= 0 for v in ser[f"gap_{g}_s"])
    for g in GAPS:
        assert m[f"gap_{g}_s_total"] >= 0.0
    for h in HISTS:
        assert m["histograms"][h]["count"] == m["pods_bound"], h


@pytest.mark.parametrize("pipeline", [True, False])
def test_metrics_surface_gap_partition_and_counters(pipeline):
    """One armed burst on each engine (journal, trace, timeline,
    sentinel and controller on): every JAX key but the later slices'
    is reported; the gap partition and the histogram counts hold; the
    counters and series that do not read a clock equal the JAX
    engine's."""
    kw = dict(max_batch_size=64, seed=1, pipeline=pipeline)
    got, m = _armed_burst(PORT, kw)
    want, jm = _armed_burst(JAX, kw)
    assert got == want
    assert LATER_SLICE_KEYS <= set(jm)
    assert not LATER_SLICE_KEYS & set(m)
    assert set(jm) - set(m) == LATER_SLICE_KEYS
    assert set(m) - set(jm) == PORT_ONLY_KEYS
    _check_partition(m)
    _check_partition(jm)
    for k in ("batches", "pods_bound", "steps_dispatched",
              "decision_fetches", "scored_rows_total", "last_scored_rows",
              "last_shapes", "last_batch_size", "batch_sizes",
              "timeline_snapshots", "timeline_dropped", "overload_level",
              "shed_total", "degradation_level", "provenance_records",
              "provenance_evictions", "journal_dropped",
              "journal_dropped_by_fault", "slo_alerts_total",
              "supervisor_early_warnings", "overload_max_batch",
              "overload_window_s", "overload_shortlist_k",
              "brownout_active", "admission_rejects_total"):
        assert m[k] == jm[k], k
    for k in ("scored_rows", "shortlist_repairs", "h2d_bytes",
              "fetch_bytes"):
        assert m["batch_series"][k] == jm["batch_series"][k], k
    assert m["steps_dispatched"] == m["batches"] >= 5
    assert m["decision_fetches"] >= m["batches"]
    assert m["scored_rows_total"] == sum(m["batch_series"]["scored_rows"])
    for k in ("encode_s_total", "commit_s_total", "step_dispatch_s_total",
              "encode_overlap_s", "commit_overlap_s", "last_encode_s",
              "last_step_s", "last_commit_s", "gap_s_total"):
        assert isinstance(m[k], float) and m[k] >= 0.0, k
    assert m["commit_s_total"] == pytest.approx(m["resolve_s_total"])
    if not pipeline:
        assert m["encode_overlap_s"] == m["commit_overlap_s"] == 0.0
    assert m["journal_events"] > 0 and m["provenance_records"] == 300
    for k, v in m.items():
        if k.startswith("slo_burning_"):
            assert v == jm[k] == 0, k
    # Each phase's CPU against its wall time over the same windows; the
    # blocking reads (every batch fetches its decision) inside the step
    # window; no CUDA events on the CPU.
    for phase in ("prepare", "resolve"):
        cpu, wall = m[f"{phase}_cpu_s_total"], m[f"{phase}_s_total"]
        assert 0.0 < cpu <= wall + CLOCK_GRAIN_S * m["batches"], phase
    assert m["host_syncs_total"] >= m["batches"]
    assert 0.0 < m["fetch_wait_s_total"] <= m["step_s_total"]
    assert m["step_device_span_s_total"] == 0.0


def test_gap_clock_covers_the_commit_wait():
    """A burst whose batches carry failure verdicts in pipelined mode:
    the flush runs on the commit worker, and the scheduling thread's
    wait on it lands in the commit slot of the gap and the rest in
    commit_overlap_s; the partition still holds."""
    O = PORT.O
    c = PORT.Cluster()
    try:
        c.start(PORT.Profile(plugins=list(PLUGINS)),
                PORT.config(max_batch_size=8, batch_window_s=0.05,
                            backoff_initial_s=5.0, backoff_max_s=5.0),
                with_pv_controller=False)
        for i in range(2):
            c.create_node(f"n{i}", cpu=4000)
        c.create_objects([O.Pod(
            metadata=O.ObjectMeta(name=f"p{i}", namespace="default"),
            spec=O.PodSpec(requests={"cpu": 200 if i % 2 else 1e9}))
            for i in range(64)])
        sched = c.service.scheduler

        def settled():
            m = sched.metrics()
            return m["pods_seen"] >= 64 and m["pods_bound"] >= 32

        assert PORT_wait(settled)
        m = sched.metrics()
        _check_partition(m)
        assert m["pods_failed"] >= 32
        assert m["gap_commit_s_total"] + m["commit_overlap_s"] > 0.0
        assert m["encode_overlap_s"] >= 0.0
    finally:
        c.shutdown()


def PORT_wait(cond, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.05)
    return False


@pytest.mark.parametrize("pipeline", [True, False])
def test_provenance_matches_jax(pipeline):
    """Each pod's provenance record: node, batch, step, engine mode,
    rung, residency posture, shortlist width and outcome as the JAX
    engine records them (wall-clock stamps: numbers > 0)."""
    kw = dict(max_batch_size=64, seed=3, pipeline=pipeline)
    recs = {}
    PORT.journal.configure("1")
    got, _ = bench_burst(PORT, kw, white_box=lambda s: recs.setdefault(
        "port", {k: s.provenance(k) for k in placements_of(s)}))
    disarm_all()
    JAX.journal.configure("1")
    want, _ = bench_burst(JAX, kw, white_box=lambda s: recs.setdefault(
        "jax", {k: s.provenance(k) for k in placements_of(s)}))
    assert got == want
    assert recs["port"].keys() == recs["jax"].keys() and len(got) == 300
    for key, rec in recs["port"].items():
        jrec = recs["jax"][key]
        for stamp in ("decided_unix", "bound_unix"):
            assert isinstance(rec.pop(stamp), float)
            jrec.pop(stamp)
        assert rec == jrec, key
        assert rec["node"] == got[key] and rec["outcome"] == "bound"
        assert rec["mode"] == ("pipelined" if pipeline else "sync")


def placements_of(sched):
    return [p.key for p in sched.store.list("Pod")]


def test_admission_gate_force_sheds_and_loses_nothing():
    """``admission:corrupt@1`` force-sheds the first ingress transaction
    whole (the pods created before the engine started, in one add): the
    lane re-admits them after the shed backoff and every pod binds, as
    on the JAX engine; the shed is journaled once."""
    out = {}
    for pkg in (PORT, JAX):
        pkg.journal.configure("1")
        pkg.faults.configure("admission:corrupt@1", 0)
        _got, m = bench_burst(pkg, dict(max_batch_size=64, seed=1))
        kinds = [e["kind"] for e in pkg.journal.JOURNAL.entries()]
        out[pkg.name] = (m["fault_fires_admission"], m["shed_total"],
                         m["queue_shed_pods"], m["queue_shed_readmitted"],
                         m["pods_bound"], kinds.count("queue.shed"),
                         kinds.count("fault.admission"))
        disarm_all()
    assert out["port"] == out["jax"] == (1, 300, 300, 300, 300, 1, 1)


def _quarantine_bundle(pkg, tmp):
    """Three step faults in a row exhaust the degradation ladder on a
    four-node burst: the quarantine freezes an incident bundle."""
    O = pkg.O
    pkg.journal.configure("1")
    pkg.obs.configure(True)
    pkg.timeseries.configure(True, every="1")
    pkg.bundle.configure(tmp)
    c = pkg.Cluster()
    try:
        c.start(pkg.Profile(plugins=list(PLUGINS)),
                pkg.config(max_batch_size=7, batch_window_s=0.3,
                           batch_idle_s=0.1, backoff_initial_s=0.05,
                           backoff_max_s=0.3, probation_batches=1),
                with_pv_controller=False)
        pkg.faults.configure("step:err@1,step:err@2,step:err@3", 0)
        for i, cpu in enumerate((64000, 48000, 40000, 36000)):
            c.create_node(f"n{i}", cpu=cpu)
        c.create_objects([O.Pod(
            metadata=O.ObjectMeta(name=f"p{i}", namespace="default"),
            spec=O.PodSpec(requests={"cpu": 100 + 17 * i}, priority=500 - i))
            for i in range(14)])
        sched = c.service.scheduler
        assert PORT_wait(lambda: sched.metrics()["pods_bound"] == 14)
        m = sched.metrics()
        assert m["quarantined_batches"] == 1
        return os.path.join(tmp, "incident-quarantine"), m
    finally:
        c.shutdown()
        disarm_all()


def test_quarantine_bundle_is_complete_and_postmortem_accepts_it(tmp_path):
    path, m = _quarantine_bundle(PORT, str(tmp_path / "port"))
    jpath, _ = _quarantine_bundle(JAX, str(tmp_path / "jax"))
    man = json.load(open(os.path.join(path, "manifest.json")))
    jman = json.load(open(os.path.join(jpath, "manifest.json")))
    assert man["schema"] == jman["schema"] == 1
    assert man["incident_class"] == "quarantine"
    assert man["files"] == jman["files"] == sorted(
        ["config.json", "journal.jsonl", "metrics.json", "timeline.json",
         "trace.json"])
    assert sorted(os.listdir(path)) == sorted(man["files"]
                                              + ["manifest.json"])
    metrics = json.load(open(os.path.join(path, "metrics.json")))
    assert metrics["quarantined_batches"] == 1
    assert set(metrics) >= {"histograms", "gap_s_total", "journal_events"}
    kinds = [json.loads(line)["kind"]
             for line in open(os.path.join(path, "journal.jsonl"))]
    assert "supervisor.quarantine" in kinds and "fault.step" in kinds
    r = subprocess.run([sys.executable, os.path.join(REPO, "tools",
                                                     "postmortem.py"),
                        path, "--quiet"], capture_output=True, text=True)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "schema-valid bundle" in r.stdout
    assert "[fault.step]" in r.stdout


def test_flight_recorder_spans_and_dump(tmp_path, monkeypatch):
    """The armed recorder holds the engine's spans on the port, each of
    a batch's spans with the batch's id (every id from 1 to the batch
    count, once per span name), a forced collection as a ``gc`` span,
    and its wall anchor; an unarmed dump with the collector watch off
    is valid and empty, as on the JAX engine, and the placements are
    the armed run's."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import trace_view

    seen = {}

    def dump(sched):
        gc.collect()
        seen["path"] = sched.dump_trace(str(tmp_path / "trace.json"))

    PORT.obs.configure(True)
    armed, m = bench_burst(PORT, dict(max_batch_size=64, seed=1),
                           white_box=dump)
    doc = json.load(open(seen["path"]))
    trace_view.validate(doc)
    names = {e["name"] for e in doc["traceEvents"]}
    assert set(SPANS) | {"gc"} <= names, set(SPANS) - names
    assert any(e["name"] == "gc" and e["args"]["generation"] == 2
               for e in doc["traceEvents"])
    assert doc["otherData"]["wall_t0_ns"] > 0
    for name in SEQ_SPANS:
        seqs = [e["args"]["seq"] for e in doc["traceEvents"]
                if e.get("ph") == "X" and e["name"] == name]
        assert sorted(seqs) == list(range(1, m["batches"] + 1)), name
    PORT.obs.configure(False)
    PORT.obs.GC_WATCH.uninstall()
    monkeypatch.setattr(PORT.obs.GC_WATCH, "install", lambda: None)
    plain, _ = bench_burst(PORT, dict(max_batch_size=64, seed=1),
                           white_box=dump)
    doc = json.load(open(seen["path"]))
    trace_view.validate(doc)
    assert not [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    assert plain == armed


@pytest.mark.parametrize("armed", [True, False])
def test_collector_watch_counts_and_traces(armed, tmp_path):
    """A forced collection raises the gen-2 count and the pause seconds;
    armed, it is a ``gc`` span of generation 2 on the collecting thread
    in the recorder's Chrome document; disarmed, the document holds no
    span."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import trace_view

    watch = PORT.obs.GC_WATCH
    watch.install()
    PORT.obs.configure(armed)
    before = watch.counters()
    gc.collect()
    after = watch.counters()
    assert after["gc_collections_gen2"] == before["gc_collections_gen2"] + 1
    assert after["gc_pause_s_total"] > before["gc_pause_s_total"]
    doc = json.load(open(PORT.obs.TRACE.export_chrome(
        str(tmp_path / "gc.json"))))
    trace_view.validate(doc)
    spans = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    if armed:
        # An automatic gen-1 collection may fall in the window too.
        full = [e for e in spans if e["name"] == "gc"
                and e["args"]["generation"] == 2]
        assert len(full) == 1
        lanes = {e["tid"]: e["args"]["name"] for e in doc["traceEvents"]
                 if e.get("ph") == "M"}
        gc_tid = full[0]["tid"]
        assert lanes[gc_tid] == threading.current_thread().name
    else:
        assert not spans


def test_collector_span_never_waits_for_the_registry_lock():
    """A collection on a thread with no ring while that thread holds the
    recorder's registry lock (a collection can start inside the
    recorder): the callback records no span, counts it as dropped, and
    does not deadlock."""
    watch = PORT.obs.GC_WATCH
    watch.install()
    rec = PORT.obs.configure(True)
    done = []

    def collect_under_the_lock():
        with rec._lock:
            gc.collect()
        done.append(True)

    t = threading.Thread(target=collect_under_the_lock)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive() and done
    assert rec.dropped() >= 1
    assert not [e for e in rec.events() if e["name"] == "gc"]


def test_recorder_keeps_every_span_under_collections():
    """Threads (more than cores) open spans while allocating enough for
    the collector to run gen-1 and gen-2 collections in their midst,
    with a short switch interval: every ring holds each span and each
    ``gc`` span it was handed (no slot lost to a collection's append),
    and the ``gc`` spans recorded or counted as dropped match the
    collections the watch saw."""
    watch = PORT.obs.GC_WATCH
    watch.install()
    rec = PORT.obs.configure(True)
    before = watch.counters()
    n_threads, n_spans = 2 * (os.cpu_count() or 4), 2000
    thresholds = gc.get_threshold()
    interval = sys.getswitchinterval()

    def work():
        junk = []
        for i in range(n_spans):
            with PORT.obs.span("stress", i=i):
                junk.append([{} for _ in range(8)])
            if len(junk) > 200:
                junk.clear()

    gc.set_threshold(50, 2, 2)
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
        gc.set_threshold(*thresholds)
    gc.disable()   # the snapshot below sees no further collection
    try:
        after = watch.counters()
        with rec._lock:
            rings = [(r.n, list(r.buf)) for r in rec._rings]
        unrecorded = rec._gc_unrecorded
    finally:
        gc.enable()
    assert all(n == len(buf) for n, buf in rings)
    evs = [e for _n, buf in rings for e in buf]
    assert sum(e[1] == "stress" for e in evs) == n_threads * n_spans
    collected = sum(after[f"gc_collections_gen{g}"]
                    - before[f"gc_collections_gen{g}"] for g in (1, 2))
    assert collected > 0
    assert sum(e[1] == "gc" for e in evs) + unrecorded == collected


@pytest.mark.parametrize("metric,counter,per_batch", [
    ("prepare_cpu_ms.backlog", "prepare_cpu_s_total", 250.0),
    ("resolve_cpu_ms.backlog", "resolve_cpu_s_total", 250.0),
    ("fetch_wait_ms.backlog", "fetch_wait_s_total", 250.0),
    ("host_syncs.backlog", "host_syncs_total", 0.25),
    ("step_device_span_ms.backlog", "step_device_span_s_total", 250.0),
    ("gc_pause_ms.backlog", "gc_pause_s_total", 250.0),
    ("sym_affinity_ms.spread", "sym_affinity_s_total", 250.0)])
def test_benchmark_readers_of_the_port_counters(metric, counter, per_batch):
    """Each reader divides its counter by the window's batches (ms of
    seconds; host_syncs as a count); None with no batch, and None where
    the program has no such counter."""
    from benchmark import spec

    read = spec.load_reader("metrics", metric)
    assert read({"counters": {"batches": 4.0, counter: 1.0}}) == (
        pytest.approx(per_batch))
    assert read({"counters": {"batches": 0.0, counter: 0.0}}) is None
    assert read({"counters": {"batches": 4.0}}) is None


def test_trace_next_batch_writes_a_profiler_trace(tmp_path):
    """``trace_next_batch`` on the CPU: the next batch runs inside a
    torch.profiler scope (CPU activity only, as the engine's device is
    the CPU) and its Chrome trace lands in the directory; the traced
    batch decides as the untraced run does."""
    O = PORT.O
    from torch_parity import BENCH_PROFILE, bench_cluster

    nodes, pods = bench_cluster(O, 120, 120, 2)
    runs = []
    for traced in (False, True):
        c = PORT.Cluster()
        try:
            c.create_objects(nodes)
            c.start(PORT.Profile(**BENCH_PROFILE),
                    PORT.config(max_batch_size=64, seed=2))
            sched = c.service.scheduler
            assert PORT_wait(lambda: sched.cache.node_count() == 120)
            if traced:
                PORT.obs.configure(True)
                sched.trace_next_batch(str(tmp_path))
            c.create_objects(pods)
            assert PORT_wait(lambda: sched.metrics()["pods_bound"] == 120)
            runs.append(placements(c))
        finally:
            c.shutdown()
        nodes, pods = bench_cluster(O, 120, 120, 2)
    assert runs[0] == runs[1]
    doc = json.load(open(tmp_path / "trace.json"))
    names = {e.get("name") for e in doc["traceEvents"]}
    assert "prepare" in names and "resolve" in names
    assert not (tmp_path / "error.txt").exists()


def _mix_burst(cell_name: str, tmp_path, n_pods: int = 192, seed: int = 7):
    """The benchmark's cell ``cell_name`` cut to 400 nodes, ``n_pods`` of
    its pods in batches of 64, every object in the store before the
    engine starts, the recorder armed: (metrics, the recorder's spans)."""
    from benchmark import harness, spec, workload

    cell = spec.cell(cell_name)
    cl = dict(cell.config["cluster"], nodes=400)
    config = dict(cell.config, scheduler=dict(cell.config["scheduler"],
                                              max_batch_size=64))
    source = workload.PodSource(cell.traffic["pod"], cl["zones"], seed)
    PORT.obs.configure(True)
    c = PORT.Cluster()
    c.create_objects(workload.make_nodes(cl, seed, PORT.O))
    c.create_objects(source.objects(range(n_pods), PORT.O))
    c.start(harness.profile(config),
            harness.scheduler_config(config, seed, "cpu"),
            with_pv_controller=False)
    try:
        sched = c.service.scheduler
        assert PORT_wait(lambda: all(p.spec.node_name
                                     for p in c.list_pods()))
        assert PORT_wait(lambda: sched.metrics()["pods_assigned"]
                         >= n_pods)
        doc = json.load(open(sched.dump_trace(str(tmp_path / "t.json"))))
        return sched.metrics(), [e for e in doc["traceEvents"]
                                 if e.get("ph") == "X"]
    finally:
        c.shutdown()


@pytest.mark.parametrize("cell", [
    "kube-default-50k-adaptive.backlog10k-spread-hard",
    "kube-default-50k.backlog10k-claims"])
def test_symmetric_affinity_span_and_counters(cell, tmp_path):
    """On the hard-spread mix every pod (app=bench) matches the one term
    group of the bound pods' preferred zone terms once any is bound:
    each batch after that stamps one slot a pod, in an
    ``encode.sym_affinity`` span carrying the batch's id, and the host
    seconds count. On the claims mix no pod carries a term: no slot, no
    term, no second, no span."""
    m, spans = _mix_burst(cell, tmp_path)
    sym = [e for e in spans if e["name"] == "encode.sym_affinity"]
    if cell.endswith("claims"):
        assert m["sym_affinity_slots_total"] == 0
        assert m["sym_affinity_terms"] == 0
        assert m["sym_affinity_s_total"] == 0.0
        assert not sym
        return
    assert m["sym_affinity_terms"] == 1
    assert m["sym_affinity_s_total"] > 0.0
    seqs = sorted(e["args"]["seq"] for e in sym)
    assert seqs and len(set(seqs)) == len(seqs)
    assert 2 <= seqs[0] and seqs[-1] <= m["batches"]
    # One slot a pod in every batch that had a table (batch ``seq``'s
    # size is batch_sizes[seq - 1]).
    sizes = m["batch_sizes"]
    assert len(sizes) == m["batches"]
    assert m["sym_affinity_slots_total"] == sum(sizes[q - 1] for q in seqs)

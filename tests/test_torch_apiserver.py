"""The port's HTTP API server, its client and its engine over the wire,
against the JAX package's.

Mirrors tests/test_apiserver.py (CRUD, errors, bulk create, the watch
long-poll and its 410, auth, flow control, the Prometheus exposition),
tests/test_remote_engine.py (the engine as a pure network client), the
RemoteStore cases of tests/test_faults.py (a flaky server, the retry
deadline, the ``http`` gate) and of tests/test_overload.py (the overload
429, the back-off on it, the circuit breaker) and the outage arc of
tests/test_election.py. Then the two packages side by side: one script
of requests to both servers over equal stores gives equal answers, each
package's client drives the other's server, and the port's engine over
the port's wire places 512 pods on 1,200 bench nodes as the JAX engine
over the JAX wire does. A pod that fits nowhere lands unschedulable with
its plugins recorded when the port's engine runs over RemoteStore (the
store has no ``fail_pods``).
"""
import itertools
import json
import re
import socket
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from minisched_tpu import config as jconfig
from minisched_tpu.apiserver import APIServer as JAPIServer
from minisched_tpu.apiserver import RemoteStore as JRemoteStore
from minisched_tpu.service.defaultconfig import Profile as JProfile
from minisched_tpu.service.service import SchedulerService as JService
from minisched_tpu.state import objects as JO
from minisched_tpu.state.store import ClusterStore as JStore
from minisched_tpu_torch import faults
from minisched_tpu_torch.apiserver import APIServer, RemoteStore
from minisched_tpu_torch.apiserver.client import _TokenBucket
from minisched_tpu_torch.config import SchedulerConfig
from minisched_tpu_torch.engine import overload
from minisched_tpu_torch.errors import (AlreadyExistsError, ConflictError,
                                        NotFoundError, UnauthorizedError)
from minisched_tpu_torch.faults import FAULTS, FaultInjected
from minisched_tpu_torch.obs import journal
from minisched_tpu_torch.service.defaultconfig import Profile
from minisched_tpu_torch.service.service import SchedulerService
from minisched_tpu_torch.state import objects as obj
from minisched_tpu_torch.state.store import ClusterStore
from minisched_tpu_torch.utils.breaker import CircuitBreaker
from torch_obs_parity import disarm_all
from torch_parity import BENCH_PROFILE, bench_cluster

CPU = dict(platform="cpu")


@pytest.fixture(autouse=True)
def disarmed():
    disarm_all()
    yield
    disarm_all()


@pytest.fixture
def remote():
    store = ClusterStore()
    api = APIServer(store).start()
    yield store, RemoteStore(api.address)
    api.shutdown()


def _node(name, unschedulable=False, cpu=4000.0, O=obj):
    return O.Node(metadata=O.ObjectMeta(name=name),
                  spec=O.NodeSpec(unschedulable=unschedulable),
                  status=O.NodeStatus(allocatable={
                      "cpu": cpu, "memory": 16 << 30, "pods": 110.0}))


def _pod(name, cpu=100.0, O=obj):
    return O.Pod(metadata=O.ObjectMeta(name=name, namespace="default"),
                 spec=O.PodSpec(requests={"cpu": cpu, "memory": 1 << 30}))


def _wait(pred, timeout=30.0, interval=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        v = pred()
        if v:
            return v
        time.sleep(interval)
    raise AssertionError("condition not met within timeout")


# ---- the wire surface (tests/test_apiserver.py) -------------------------


def test_crud_round_trip_over_the_wire(remote):
    store, rs = remote
    created = rs.create(_node("w-n0", unschedulable=True))
    assert created.metadata.resource_version > 0
    assert rs.get("Node", "w-n0").spec.unschedulable is True
    rs.create(obj.Pod(
        metadata=obj.ObjectMeta(name="w-p0", namespace="default",
                                labels={"a": "b"}),
        spec=obj.PodSpec(requests={"cpu": 100},
                         tolerations=[obj.Toleration(key="t",
                                                     operator="Exists")])))
    p = rs.get("Pod", "default/w-p0")
    assert p.spec.tolerations[0].operator == "Exists"
    assert p.metadata.labels == {"a": "b"}
    assert {o.metadata.name for o in rs.list("Pod")} == {"w-p0"}
    p.metadata.labels["c"] = "d"
    updated = rs.update(p)
    assert updated.metadata.resource_version > p.metadata.resource_version
    assert store.get("Pod", "default/w-p0").metadata.labels["c"] == "d"
    rs.delete("Pod", "default/w-p0")
    with pytest.raises(NotFoundError):
        rs.get("Pod", "default/w-p0")


def test_empty_namespace_key_survives_per_object_routes(remote):
    store, rs = remote
    rs.create(_node("ns-n0"))
    rs.create(obj.Pod(metadata=obj.ObjectMeta(name="bare"),
                      spec=obj.PodSpec(requests={"cpu": 100})))
    assert store.get("Pod", "/bare").metadata.name == "bare"
    assert rs.get("Pod", "/bare").metadata.name == "bare"
    assert rs.bind_pod("/bare", "ns-n0").spec.node_name == "ns-n0"
    assert store.get("Pod", "/bare").spec.node_name == "ns-n0"
    rs.delete("Pod", "/bare")
    with pytest.raises(NotFoundError):
        rs.get("Pod", "/bare")


def test_error_mapping(remote):
    _store, rs = remote
    rs.create(_node("e-n0"))
    with pytest.raises(AlreadyExistsError):
        rs.create(_node("e-n0"))
    with pytest.raises(NotFoundError):
        rs.get("Node", "ghost")
    with pytest.raises(NotFoundError):
        rs.delete("Node", "ghost")
    with pytest.raises((RuntimeError, ConflictError, NotFoundError)):
        rs.update(_pod("never-created"))


def test_bulk_create_and_watch_long_poll(remote):
    store, rs = remote
    rs.create_many([_node(f"b-n{i}") for i in range(5)])
    events, cursor = rs.watch_events(0, kinds=["Node"], timeout=2.0)
    assert len(events) == 5 and all(e["type"] == "ADDED" for e in events)
    assert cursor == 5
    events2, cursor2 = rs.watch_events(cursor, kinds=["Node"], timeout=0.2)
    assert events2 == [] and cursor2 == cursor
    store.delete("Node", "b-n0")
    events3, cursor3 = rs.watch_events(cursor, kinds=["Node"], timeout=2.0)
    assert [e["type"] for e in events3] == ["DELETED"]
    assert cursor3 == cursor + 1


def test_watch_fell_behind_maps_to_gone(remote):
    store, rs = remote
    store._max_log = 4
    rs.create_many([_node(f"g-n{i}") for i in range(10)])
    with pytest.raises(ValueError):
        rs.watch_events(1, kinds=["Node"], timeout=0.5)


def test_remote_readme_scenario_inline():
    from minisched_tpu_torch.scenario.remote import run_remote_scenario

    store = ClusterStore()
    svc = SchedulerService(store)
    svc.start_scheduler(config=SchedulerConfig(
        backoff_initial_s=0.05, backoff_max_s=0.2, batch_window_s=0.0,
        **CPU))
    api = APIServer(store).start()
    try:
        run_remote_scenario(api.address)
    finally:
        api.shutdown()
        svc.shutdown_scheduler()


def test_watch_cursor_advances_past_filtered_churn(remote):
    store, rs = remote
    rs.create(_pod("wf-p0"))
    evs, cursor = rs.watch_events(0, kinds=["Pod"], timeout=1.0)
    assert len(evs) == 1
    store.create_many([_node(f"wf-n{i}") for i in range(20)])
    evs2, cursor2 = rs.watch_events(cursor, kinds=["Pod"], timeout=0.2)
    assert evs2 == [] and cursor2 == cursor + 20


def test_put_key_body_mismatch_rejected(remote):
    _store, rs = remote
    rs.create(_pod("pm-a"))
    rs.create(_pod("pm-b"))
    a = rs.get("Pod", "default/pm-a")
    a.metadata.name = "pm-b"
    with pytest.raises(RuntimeError, match="400"):
        rs._call("PUT", "/apis/Pod/default/pm-a", obj.to_dict(a))


def _raw(address, method, path, body=None, headers=None):
    """One request by urllib: (status, decoded body or text)."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(
        address + path, data=data, method=method,
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            status, raw, ctype = r.status, r.read(), r.headers[
                "Content-Type"]
    except urllib.error.HTTPError as e:
        status, raw, ctype = e.code, e.read(), e.headers["Content-Type"]
    text = raw.decode()
    return status, (json.loads(text) if "json" in ctype else text)


def test_409_reason_field_disambiguates(remote):
    store, rs = remote
    rs.create(_node("r-n0"))
    n = obj.to_dict(store.get("Node", "r-n0"))
    status, body = _raw(rs.address, "POST", "/apis/Node", n)
    assert status == 409 and body["reason"] == "AlreadyExists"
    stale = dict(n)
    stale["metadata"] = dict(n["metadata"], resource_version=1,
                             name="r-n0")
    store.update(store.get("Node", "r-n0"))
    status, body = _raw(rs.address, "PUT", "/apis/Node/r-n0", stale)
    assert status == 409 and body["reason"] == "Conflict"
    with pytest.raises(AlreadyExistsError):
        rs.create(_node("r-n0"))
    with pytest.raises(ConflictError):
        rs.update(obj.from_dict("Node", stale), check_version=True)
    rs.update(obj.from_dict("Node", stale))  # unconditional by default


def test_bearer_token_auth_rejects_and_admits():
    api = APIServer(ClusterStore(), token="s3cret").start()
    try:
        assert RemoteStore(api.address).healthz()
        with pytest.raises(UnauthorizedError):
            RemoteStore(api.address).list("Node")
        with pytest.raises(UnauthorizedError):
            RemoteStore(api.address, token="wrong").list("Node")
        rs = RemoteStore(api.address, token="s3cret")
        rs.create(_node("n1"))
        assert [n.metadata.name for n in rs.list("Node")] == ["n1"]
        rs.delete("Node", "n1")
    finally:
        api.shutdown()


def test_max_inflight_answers_429_and_client_retries():
    store = ClusterStore()
    api = APIServer(store, max_inflight=1).start()
    try:
        rs = RemoteStore(api.address)
        assert api._inflight.acquire(blocking=False)
        release = threading.Timer(0.5, api._inflight.release)
        release.start()
        t0 = time.monotonic()
        rs.create(_node("n1"))  # 429, Retry-After, retry, 201
        assert time.monotonic() - t0 >= 0.9
        release.join()
        assert store.get("Node", "n1").metadata.name == "n1"
    finally:
        api.shutdown()


def test_max_inflight_surfaces_429_when_retries_exhausted():
    api = APIServer(ClusterStore(), max_inflight=1).start()
    try:
        rs = RemoteStore(api.address)
        assert api._inflight.acquire(blocking=False)
        try:
            with pytest.raises(RuntimeError, match="429"):
                rs._call("GET", "/apis/Node", _retries=0)
        finally:
            api._inflight.release()
    finally:
        api.shutdown()


def test_watch_long_poll_exempt_from_inflight_budget():
    store = ClusterStore()
    api = APIServer(store, max_inflight=1).start()
    try:
        rs = RemoteStore(api.address)
        started = threading.Event()

        def long_poll():
            started.set()
            rs.watch_events(0, timeout=3.0)

        t = threading.Thread(target=long_poll, daemon=True)
        t.start()
        started.wait(2.0)
        time.sleep(0.2)
        t0 = time.monotonic()
        rs.create(_node("n1"))
        assert time.monotonic() - t0 < 0.8, "create was flow-controlled"
        t.join(timeout=10)
    finally:
        api.shutdown()


def test_client_token_bucket_paces_requests():
    tb = _TokenBucket(qps=50, burst=2)
    t0 = time.monotonic()
    for _ in range(2):
        tb.take()
    assert time.monotonic() - t0 < 0.5
    for _ in range(3):
        tb.take()
    assert time.monotonic() - t0 >= 0.05


def test_metrics_endpoint_prometheus_exposition():
    store = ClusterStore()
    api = APIServer(store).start()
    try:
        store.create(_node("m-n0"))
        store.create(_pod("m-p0"))
        api.metrics_providers.append(
            lambda: {"batches": 3, "pods_assigned": 7,
                     "batch_sizes": [1, 2]})
        api.histogram_providers.append(lambda: {"pod_bind_s": {
            "bounds": [0.1, 1.0], "counts": [2, 1, 0], "sum": 0.9,
            "count": 3}})
        urllib.request.urlopen(f"{api.address}/apis/Node", timeout=5).read()
        body = urllib.request.urlopen(f"{api.address}/metrics", timeout=5)
        assert body.headers["Content-Type"].startswith("text/plain")
        text = body.read().decode()
        assert 'minisched_store_objects{kind="Node"} 1' in text
        assert text.count("# TYPE minisched_store_objects gauge") == 1
        assert "minisched_engine_batches 3" in text
        assert "batch_sizes" not in text
        assert "minisched_apiserver_requests_get_total 1" in text
        assert "minisched_apiserver_scrapes_metrics_total 1" in text
        assert 'minisched_engine_pod_bind_s_bucket{le="1"} 3' in text
        assert 'minisched_engine_pod_bind_s_bucket{le="+Inf"} 3' in text
        assert 'minisched_fault_fires_total{gate="http"} 0' in text
    finally:
        api.shutdown()


def test_metrics_requires_auth_when_enabled():
    api = APIServer(ClusterStore(), token="tok").start()
    try:
        status, _ = _raw(api.address, "GET", "/metrics")
        assert status == 401
        status, text = _raw(api.address, "GET", "/metrics",
                            headers={"Authorization": "Bearer tok"})
        assert status == 200
        assert "minisched_apiserver_rejected_unauthorized_total 1" in text
    finally:
        api.shutdown()


def test_metrics_scrape_covers_live_engine():
    from minisched_tpu_torch.scenario.remote import wire_service

    store = ClusterStore()
    api = APIServer(store).start()
    svc = SchedulerService(store)
    try:
        svc.start_scheduler(
            Profile(name="default-scheduler",
                    plugins=["NodeUnschedulable", "NodeResourcesFit"]),
            SchedulerConfig(batch_window_s=0.05, backoff_initial_s=0.05,
                            **CPU))
        wire_service(api, svc)
        store.create(_node("mm-n0"))
        store.create(_pod("mm-p0"))
        _wait(lambda: svc.metrics().get("pods_assigned", 0) >= 1)
        text = urllib.request.urlopen(
            f"{api.address}/metrics", timeout=5).read().decode()
        assert "minisched_engine_pods_assigned 1" in text
        assert "minisched_engine_pod_create_to_bound_s_bucket" in text
        assert 'minisched_store_objects{kind="Pod"} 1' in text
        # The store's objects, all stored off the collector's lists.
        kept = re.search(r"^minisched_engine_snapshots_untracked_total "
                         r"(\d+)$", text, re.M)
        assert kept and int(kept.group(1)) >= 3
        assert "minisched_engine_snapshots_tracked_total 0" in text
        status, doc = _raw(api.address, "GET", "/timeline")
        assert status == 200 and "default-scheduler" in doc["timelines"]
        status, doc = _raw(api.address, "GET", "/journal")
        assert status == 200 and doc["entries"] == []
        status, _ = _raw(api.address, "GET", "/provenance/default/mm-p0")
        assert status == 404  # the journal is not armed
        rs = RemoteStore(api.address)
        assert rs.journal(0)["entries"] == []
        assert rs.provenance("default/mm-p0") is None
    finally:
        api.shutdown()
        svc.shutdown_scheduler()


# ---- the engine as a pure network client (tests/test_remote_engine.py) --


@pytest.fixture
def wire(request):
    max_log = getattr(request, "param", 100_000)
    store = ClusterStore(max_log=max_log)
    api = APIServer(store).start()
    rs = RemoteStore(api.address)
    svc = SchedulerService(rs)
    svc.start_scheduler(config=SchedulerConfig(
        backoff_initial_s=0.05, backoff_max_s=0.3, **CPU))
    yield store, rs, svc
    svc.shutdown_scheduler()
    api.shutdown()


def test_engine_over_wire_readme_scenario(wire):
    _store, rs, svc = wire
    rs.create_many([_node(f"node{i}", unschedulable=True)
                    for i in range(9)])
    rs.create(_pod("pod1"))
    pending = _wait(lambda: (
        p := rs.get("Pod", "default/pod1")).status.unschedulable_plugins
        and p or None)
    assert pending.status.unschedulable_plugins == ["NodeUnschedulable"]
    assert pending.spec.node_name == ""
    rs.create(_node("node10"))
    bound = _wait(lambda: (
        p := rs.get("Pod", "default/pod1")).spec.node_name and p or None,
        timeout=45.0)
    assert bound.spec.node_name == "node10"
    m = svc.scheduler.metrics()
    assert m["store_breaker_state"] == 0
    assert m["store_outages"] == 0 and m["store_down"] == 0


def test_engine_over_wire_burst(wire):
    _store, rs, _svc = wire
    rs.create_many([_node(f"bn{i}") for i in range(8)])
    rs.create_many([_pod(f"bp{i:03d}") for i in range(120)])
    _wait(lambda: all(p.spec.node_name for p in rs.list("Pod")),
          timeout=60.0)


@pytest.mark.parametrize("wire", [16], indirect=True)
def test_engine_over_wire_survives_watch_fell_behind(wire):
    store, rs, _svc = wire
    rs.create(_node("first"))
    store.create_many([_node(f"gap{i:02d}", unschedulable=True)
                       for i in range(79)])
    rs.create(_pod("after-gap"))
    bound = _wait(lambda: (
        p := rs.get("Pod", "default/after-gap")).spec.node_name and p
        or None, timeout=60.0)
    assert bound.spec.node_name == "first"


def test_remote_bind_subresource_contract(remote):
    _store, rs = remote
    rs.create(_node("n0"))
    rs.create(_pod("p0"))
    assert rs.bind_pod("default/p0", "n0").spec.node_name == "n0"
    with pytest.raises(ConflictError):
        rs.bind_pod("default/p0", "n0")
    with pytest.raises(NotFoundError):
        rs.bind_pod("default/ghost", "n0")
    rs.create_many([_pod(f"bk{i}") for i in range(3)])
    keys = rs.bind_pods([(f"default/bk{i}", "n0") for i in range(3)]
                        + [("default/ghost", "n0")])
    assert sorted(keys) == [f"default/bk{i}" for i in range(3)]


def test_remote_snapshot_is_atomic_cursor(remote):
    _store, rs = remote
    rs.create_many([_node(f"s{i}") for i in range(5)])
    items, cursor = rs.snapshot(["Node"])
    assert len(items["Node"]) == 5
    rs.create(_node("after"))
    events, _ = rs.watch_events(cursor, kinds=["Node"], timeout=2.0)
    assert [e["object"].metadata.name for e in events] == ["after"]


FIT = ["NodeUnschedulable", "NodeResourcesFit"]


def _unschedulable_over_wire(jax: bool):
    """A pod too big for every node under each package's engine over its
    own wire (the engine's store is a RemoteStore, which has neither
    ``fail_pods`` nor ``for_each``): (status of the pod, the PDB state
    the preemption path reads)."""
    Store, API, RS, Svc, P, O = (
        (JStore, JAPIServer, JRemoteStore, JService, JProfile, JO) if jax
        else (ClusterStore, APIServer, RemoteStore, SchedulerService,
              Profile, obj))
    cfg = (jconfig.SchedulerConfig(backoff_initial_s=0.05,
                                   backoff_max_s=0.2) if jax
           else SchedulerConfig(backoff_initial_s=0.05, backoff_max_s=0.2,
                                **CPU))
    store = Store()
    api = API(store).start()
    rs = RS(api.address)
    assert not hasattr(rs, "fail_pods") and not hasattr(rs, "for_each")
    svc = Svc(rs)
    svc.start_scheduler(P(name="fit", plugins=FIT), cfg)
    try:
        rs.create_many([_node(f"u{i}", cpu=1000.0, O=O) for i in range(3)])
        rs.create(_pod("small", O=O))
        rs.create(_pod("huge", cpu=64000.0, O=O))
        pod = _wait(lambda: (p := store.get("Pod", "default/huge"))
                    .status.unschedulable_plugins and p or None)
        _wait(lambda: store.get("Pod", "default/small").spec.node_name)
        store.create(O.PodDisruptionBudget(
            metadata=O.ObjectMeta(name="pdb", namespace="default"),
            spec=O.PDBSpec(min_available=0)))
        pdb = svc.scheduler._pdb_state()
        failed = _wait(lambda: svc.scheduler.metrics()["pods_failed"] >= 1)
        return (pod.spec.node_name, pod.status.unschedulable_plugins,
                pod.status.message, failed, [[ns, c] for ns, _sel, c in pdb])
    finally:
        svc.shutdown_scheduler()
        api.shutdown()


def test_unschedulable_pod_over_the_wire_records_its_plugins():
    """The failure flush and the PDB count fall back to per-pod
    get/update and to list() on a store without the bulk verbs: the pod
    lands unschedulable with its plugins recorded, as under the JAX
    engine, and the engine keeps running."""
    port = _unschedulable_over_wire(jax=False)
    assert port[0] == "" and port[1] == ["NodeResourcesFit"]
    assert port[3] is True and port[4] == [["default", 1]]
    assert port == _unschedulable_over_wire(jax=True)


def test_reconcile_store_requeues_from_store_truth():
    """reconcile_store after an outage: unbound routed pods come back
    into the queue, none is dropped, and store_reconciles counts it, as
    in the JAX engine."""
    out = []
    for jax in (False, True):
        Store, API, RS, Svc, P, O = (
            (JStore, JAPIServer, JRemoteStore, JService, JProfile, JO)
            if jax else (ClusterStore, APIServer, RemoteStore,
                         SchedulerService, Profile, obj))
        cfg = (jconfig.SchedulerConfig(backoff_initial_s=30,
                                       backoff_max_s=30) if jax
               else SchedulerConfig(backoff_initial_s=30, backoff_max_s=30,
                                    **CPU))
        store = Store()
        api = API(store).start()
        svc = Svc(RS(api.address))
        svc.start_scheduler(P(name="fit", plugins=FIT), cfg)
        try:
            store.create(_node("r0", cpu=1000.0, O=O))
            store.create(_pod("fits", O=O))
            store.create(_pod("huge", cpu=64000.0, O=O))
            _wait(lambda: store.get("Pod", "default/huge")
                  .status.unschedulable_plugins)
            _wait(lambda: store.get("Pod", "default/fits").spec.node_name)
            sched = svc.scheduler
            got = sched.reconcile_store(reason="test")
            out.append((got, sched.metrics()["store_reconciles"]))
        finally:
            svc.shutdown_scheduler()
            api.shutdown()
    assert out[0] == out[1] == ({"dropped": 0, "requeued": 1}, 1)


# ---- RemoteStore under a flaky server (tests/test_faults.py) ------------


class _FlakyHandler(BaseHTTPRequestHandler):
    """``script`` is consumed one entry per request: "reset" (close
    without answering), an int status (JSON error body), or "ok"."""

    script = []
    seen = []

    def _respond(self, status, body: bytes):
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _handle(self):
        n = int(self.headers.get("Content-Length") or 0)
        body = self.rfile.read(n) if n else b""
        self.seen.append((self.command, self.path))
        step = self.script.pop(0) if self.script else "ok"
        if step == "reset":
            self.connection.close()
            return
        if step == "ok":
            if self.command == "GET":
                self._respond(200, json.dumps(
                    {"items": [], "resource_version": 0}).encode())
            else:
                self._respond(200, body or b"{}")
            return
        reason = "ServiceUnavailable" if step == 503 else None
        self._respond(step, json.dumps(
            {"error": f"injected {step}", "reason": reason}).encode())

    do_GET = do_POST = do_PUT = do_DELETE = _handle

    def log_message(self, *a):
        pass


@pytest.fixture
def flaky():
    class H(_FlakyHandler):
        script, seen = [], []

    srv = ThreadingHTTPServer(("127.0.0.1", 0), H)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    rs = RemoteStore(f"http://127.0.0.1:{srv.server_address[1]}",
                     qps=0, retry_deadline_s=5.0)
    yield H, rs
    srv.shutdown()
    srv.server_close()


def test_remote_store_get_retries_reset_and_5xx(flaky):
    H, rs = flaky
    H.script[:] = ["reset", 500, "ok"]
    assert rs.list("Pod") == []
    assert len(H.seen) == 3


def test_remote_store_mutation_5xx_is_not_blindly_retried(flaky):
    H, rs = flaky
    H.script[:] = [500, "ok"]
    pod = obj.Pod(metadata=obj.ObjectMeta(name="x", namespace="default"),
                  spec=obj.PodSpec(requests={"cpu": 1}))
    with pytest.raises(RuntimeError):
        rs.create(pod)
    assert len(H.seen) == 1
    H.seen.clear()
    H.script[:] = [503, "ok"]
    assert rs.create(pod).metadata.name == "x"
    assert len(H.seen) == 2


def test_remote_store_retry_deadline_bounds_the_absorption(flaky):
    H, rs = flaky
    rs.retry_deadline_s = 0.4
    H.script[:] = [500] * 50
    t0 = time.monotonic()
    with pytest.raises(RuntimeError):
        rs.list("Pod")
    assert 0.3 <= time.monotonic() - t0 <= 5.0


def test_http_gate_fault_absorbed_by_retry():
    api = APIServer(ClusterStore()).start()
    try:
        rs = RemoteStore(api.address, retry_deadline_s=5.0)
        faults.configure("http:err@1")
        assert rs.list("Node") == []  # the injected wire fault absorbed
        assert FAULTS.counts()["http"] == 1
        faults.configure("http:err@1")
        rs.retry_deadline_s = 0.0
        with pytest.raises(FaultInjected):
            rs.list("Node")
    finally:
        faults.configure("")
        api.shutdown()


# ---- overload verdict, back-off and the breaker (test_overload.py) ------


def _overloaded_service():
    overload.configure("http_reject_level=2")
    store = ClusterStore()
    svc = SchedulerService(store)
    svc.start_scheduler(Profile(name="default-scheduler", plugins=FIT),
                        SchedulerConfig(**CPU))
    api = APIServer(store)
    api.admission_providers.append(svc.admission_reject_reason)
    api.metrics_providers.append(svc.metrics)
    return store, svc, api.start()


def test_apiserver_429_verdict_and_counters():
    _store, svc, api = _overloaded_service()
    try:
        svc.scheduler._overload.level = 2
        body = obj.to_dict(_pod("rejected"))
        status, payload = _raw(api.address, "POST", "/apis/Pod", body)
        assert status == 429 and payload["reason"] == "SchedulerOverloaded"
        status, _ = _raw(api.address, "POST", "/apis/Node",
                         obj.to_dict(_node("n-ok")))
        assert status == 201  # capacity traffic is never gated
        assert svc.metrics()["admission_rejects_total"] >= 1
        _, scrape = _raw(api.address, "GET", "/metrics")
        assert "minisched_apiserver_rejected_overloaded_total 1" in scrape
        assert "minisched_engine_overload_level" in scrape
        svc.scheduler._overload.level = 0
        status, _ = _raw(api.address, "POST", "/apis/Pod", body)
        assert status == 201
    finally:
        api.shutdown()
        svc.shutdown_scheduler()


def test_remote_store_backs_off_on_429_overload():
    _store, svc, api = _overloaded_service()
    rs = RemoteStore(api.address)
    try:
        ctrl = svc.scheduler._overload
        ctrl.level = 2
        t = time.monotonic()
        timer = threading.Timer(1.2, lambda: setattr(ctrl, "level", 0))
        timer.start()
        created = rs.create(_pod("backpressured"))
        assert created.metadata.resource_version > 0
        assert time.monotonic() - t >= 0.9
        timer.cancel()
    finally:
        api.shutdown()
        svc.shutdown_scheduler()


def test_circuit_breaker_states_and_probes():
    b = CircuitBreaker(threshold=3, reset_s=0.1)
    assert b.allow() and b.state_name == "closed"
    for _ in range(3):
        b.record_failure()
    assert b.state_name == "open" and not b.allow()
    time.sleep(0.12)
    assert b.allow() and b.state_name == "half-open"
    assert not b.allow()  # one probe in half-open
    b.record_failure()
    assert b.state_name == "open"
    time.sleep(0.12)
    assert b.allow()
    b.record_success()
    assert b.state_name == "closed" and b.allow()
    st = b.stats()
    assert st["breaker_opens_total"] == 2
    assert st["breaker_probes_total"] == 2
    assert st["breaker_fast_fails_total"] >= 2
    with pytest.raises(ValueError):
        CircuitBreaker(threshold=0)


def test_breaker_and_retry_schedules_match_jax():
    """The same sequence of verdicts drives both packages' breakers
    through the same states and counters, and the retry schedules are
    equal for the same inputs and the same draws."""
    from minisched_tpu.utils import breaker as jbreaker
    from minisched_tpu.utils import retry as jretry
    from minisched_tpu_torch.utils import retry

    script = "ffsfffaaffffsaf"
    states = []
    for mod in (jbreaker, None):
        b = (mod.CircuitBreaker if mod else CircuitBreaker)(
            threshold=3, reset_s=3600.0)
        seen = []
        for step in script:
            if step == "f":
                b.record_failure()
            elif step == "s":
                b.record_success()
            else:
                seen.append(b.allow())
            seen.append((b.state_name, b.next_probe_in() > 0))
        states.append((seen, b.stats()))
    assert states[0] == states[1]
    for kw in ({}, {"initial_duration": 0.05, "factor": 2.0, "steps": 9}):
        assert retry.backoff_durations(**kw) == jretry.backoff_durations(**kw)
    draws = [0.0, 0.25, 0.5, 0.999, 0.1, 0.7, 0.3, 0.9, 0.05, 0.6]
    for kw in ({}, {"initial_duration": 0.2, "factor": 3.0,
                    "max_duration": 2.0}):
        a = retry.jittered_delays(rng=iter(draws).__next__, **kw)
        b = jretry.jittered_delays(rng=iter(draws).__next__, **kw)
        assert [next(a) for _ in draws] == [next(b) for _ in draws]


def _dead_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_remote_store_breaker_probes_a_down_server():
    rs = RemoteStore(f"http://127.0.0.1:{_dead_port()}",
                     retry_deadline_s=1.5, breaker_threshold=3,
                     breaker_reset_s=0.2)
    with pytest.raises(Exception):
        rs.get("Pod", "default/nope")
    st = rs.breaker_stats()
    assert st["breaker_state"] != 0
    assert st["breaker_opens_total"] >= 1
    assert st["breaker_probes_total"] >= 1
    assert st["breaker_fast_fails_total"] >= 1


def test_remote_store_outage_reattach_arc():
    """Three consecutive wire failures declare the outage (journaled
    once); the first success closes it, fires on_reattach and counts."""
    journal.configure("1")
    srv = APIServer(ClusterStore()).start()
    port = srv.port
    try:
        rs = RemoteStore(srv.address, retry_deadline_s=0.0,
                         breaker_threshold=0)
        fired = []
        rs.on_reattach(lambda outage_s: fired.append(outage_s))
        rs.list("Pod")
        srv.shutdown()
        for _ in range(4):
            with pytest.raises(Exception):
                rs.list("Pod")
        assert rs.reattach_stats()["down"] and \
            rs.reattach_stats()["outages"] == 1
        srv = APIServer(ClusterStore(), port=port).start()
        _wait(lambda: rs.healthz(), timeout=10)
        stats = rs.reattach_stats()
        assert not stats["down"] and stats["reattaches"] == 1
        assert len(fired) == 1 and fired[0] >= 0
        kinds = [e["kind"] for e in journal.JOURNAL.to_doc()["entries"]]
        assert kinds.count("store.outage") == 1
        assert kinds.count("store.reattach") == 1
    finally:
        srv.shutdown()
        journal.configure("")


# ---- the two packages' wires side by side -------------------------------


def _stamps_out(v):
    """A decoded answer without the store's wall-clock stamps."""
    if isinstance(v, dict):
        if "stamps" in v:  # the slim bulk create: [rv, creation time]
            return {"stamps": [rv for rv, _ts in v["stamps"]]}
        return {k: (None if k in ("creation_timestamp", "scheduled_time")
                    else _stamps_out(x)) for k, x in v.items()}
    if isinstance(v, list):
        return [_stamps_out(x) for x in v]
    return v


def _wire_script(address):
    """One script of requests, every route of the server's docstring
    with its error answers: [(status, body without stamps)]."""
    def n(name, **kw):
        return JO.to_dict(_node(name, O=JO, **kw))

    def p(name, **kw):
        return JO.to_dict(_pod(name, O=JO, **kw))

    steps = [
        ("GET", "/healthz", None),
        ("POST", "/apis/Node", n("n0")),
        ("POST", "/apis/Node?bulk=1", [n("n1"), n("n2", unschedulable=True)]),
        ("POST", "/apis/Pod", p("p0")),
        ("POST", "/apis/Pod?bulk=1&slim=1", [p("p1"), p("p2"), p("p3")]),
        ("POST", "/apis/Node", n("n0")),                     # 409 exists
        ("GET", "/apis/Node", None),
        ("GET", "/apis/Pod/default/p0", None),
        ("GET", "/apis/Node/ghost", None),                  # 404
        ("PUT", "/apis/Pod/default/p1", p("p1", cpu=200.0)),
        ("PUT", "/apis/Pod/default/p0", p("p1")),           # 400 mismatch
        ("POST", "/bind/default/p0", {"node": "n0"}),
        ("POST", "/bind/default/p0", {"node": "n1"}),       # 409 bound
        ("POST", "/bind/default/ghost", {"node": "n1"}),    # 404
        ("POST", "/bind", [["default/p1", "n1"], ["default/ghost", "n1"],
                           ["default/p2", "n0"]]),
        ("DELETE", "/apis/Pod/default/p3", None),
        ("DELETE", "/apis/Pod/default/p3", None),           # 404
        ("GET", "/watch?from=0&kinds=Pod&timeout=0.2", None),
        ("GET", "/watch?from=3&timeout=0.2&limit=2", None),
        ("GET", "/snapshot?kinds=Node,Pod", None),
        ("GET", "/snapshot", None),
        ("POST", "/checkpoint", None),                      # 409 no path
        ("GET", "/journal?since=0", None),
        ("GET", "/journal?since=x", None),                  # 400
        ("GET", "/timeline", None),
        ("GET", "/provenance/default/p0", None),            # 404
        ("GET", "/", None),                                 # 404
        ("GET", "/metrics", None),
    ]
    return [(m, path, _raw(address, m, path, body)) for m, path, body
            in steps]


def test_one_script_gives_equal_answers_on_both_servers(monkeypatch):
    """The same requests to the port's server and the JAX server, each
    over an empty store, give equal statuses and equal decoded answers
    (wall-clock stamps aside); the Prometheus text is equal line for
    line. The request bodies are built alike for both (the uid counter
    that stamps them restarts)."""
    answers = []
    for Store, API in ((ClusterStore, APIServer), (JStore, JAPIServer)):
        monkeypatch.setattr(JO, "_uid_counter", itertools.count(1000))
        api = API(Store()).start()
        try:
            answers.append(_wire_script(api.address))
        finally:
            api.shutdown()
    port, jax = answers
    assert [a[:2] for a in port] == [a[:2] for a in jax]
    for (m, path, (ps, pb)), (_m, _p, (js, jb)) in zip(port, jax):
        assert ps == js, (m, path, ps, js)
        assert _stamps_out(pb) == _stamps_out(jb), (m, path)
    statuses = [a[2][0] for a in port]
    assert {200, 201, 400, 404, 409} <= set(statuses)


@pytest.mark.parametrize("client", ["port-on-jax", "jax-on-port"])
def test_each_client_drives_the_other_server(client):
    """Each package's RemoteStore drives the other package's server:
    CRUD, bulk create, bind, the typed errors, snapshot and watch."""
    if client == "port-on-jax":
        Store, API, RS, O = JStore, JAPIServer, RemoteStore, obj
        errs = (AlreadyExistsError, NotFoundError, ConflictError)
    else:
        from minisched_tpu import errors as jerrors

        Store, API, RS, O = ClusterStore, APIServer, JRemoteStore, JO
        errs = (jerrors.AlreadyExistsError, jerrors.NotFoundError,
                jerrors.ConflictError)
    store = Store()
    api = API(store).start()
    try:
        rs = RS(api.address)
        rs.create_many([_node(f"x{i}", O=O) for i in range(3)])
        rs.create(_pod("xp", O=O))
        with pytest.raises(errs[0]):
            rs.create(_node("x0", O=O))
        with pytest.raises(errs[1]):
            rs.get("Pod", "default/ghost")
        assert rs.bind_pod("default/xp", "x1").spec.node_name == "x1"
        with pytest.raises(errs[2]):
            rs.bind_pod("default/xp", "x2")
        items, cursor = rs.snapshot(["Node", "Pod"])
        assert [len(items[k]) for k in ("Node", "Pod")] == [3, 1]
        rs.delete("Node", "x2")
        evs, _ = rs.watch_events(cursor, kinds=["Node"], timeout=1.0)
        assert [(e["type"], e["object"].metadata.name) for e in evs] == [
            ("DELETED", "x2")]
        assert type(rs.get("Node", "x0")) is O.Node
        assert store.get("Pod", "default/xp").spec.node_name == "x1"
    finally:
        api.shutdown()


def _engine_over_wire(jax: bool, n_nodes=1200, n_pods=512):
    """bench_cluster's nodes and pods stored first in a server's store,
    then each package's engine started over its own package's wire with
    the default config and the bench profile; returns the placements and
    the engine's metrics once every pod is bound."""
    Store, API, RS, Svc, P, O = (
        (JStore, JAPIServer, JRemoteStore, JService, JProfile, JO) if jax
        else (ClusterStore, APIServer, RemoteStore, SchedulerService,
              Profile, obj))
    cfg = jconfig.SchedulerConfig() if jax else SchedulerConfig(**CPU)
    nodes, pods = bench_cluster(O, n_nodes, n_pods, seed=4)
    store = Store()
    store.create_many(nodes)
    store.create_many(pods)
    api = API(store, token="t0k", max_inflight=256).start()
    svc = Svc(RS(api.address, token="t0k"))
    svc.start_scheduler(P(**BENCH_PROFILE), cfg)
    try:
        sched = svc.scheduler
        _wait(lambda: all(p.spec.node_name for p in store.list("Pod")),
              timeout=120)
        # pods_assigned folds with the batch count, after the binds.
        _wait(lambda: sched.metrics()["pods_assigned"] >= n_pods
              and sched.metrics()["pods_bound"] >= n_pods, timeout=60)
        return ({p.key: p.spec.node_name for p in store.list("Pod")},
                sched.metrics())
    finally:
        svc.shutdown_scheduler()
        api.shutdown()


def test_engine_over_wire_places_as_jax_over_wire():
    """1,200 bench nodes and 512 pods in the server's store first: the
    port's engine over the port's wire places every pod where the JAX
    engine over the JAX wire does, in as many batches, and its metrics
    carry the client's breaker, closed."""
    port, m = _engine_over_wire(jax=False)
    want, jm = _engine_over_wire(jax=True)
    assert port == want and all(port.values())
    assert m["batches"] == jm["batches"]
    assert m["store_breaker_state"] == 0 == jm["store_breaker_state"]
    assert {k for k in jm if k.startswith("store_")} == \
        {k for k in m if k.startswith("store_")}
    assert m["store_breaker_opens_total"] == 0

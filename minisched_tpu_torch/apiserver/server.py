"""HTTP+JSON front on the cluster store — the out-of-process client
surface.

The reference boots a REAL kube-apiserver over HTTP and its scenario
drives the simulator through client-go like any external tool
(reference k8sapiserver/k8sapiserver.go:43-71, sched.go:42-68). The
rebuild's store is an in-process object — this module restores the
"any client can attach" property with a thin wire layer over the
store's existing CRUD + versioned watch:

    GET    /apis/{kind}                 → {"items": [...]}
    GET    /apis/{kind}/{key}           → object   (key = ns/name or name)
    POST   /apis/{kind}                 → create   (JSON object body)
    POST   /apis/{kind}?bulk=1          → create_many (JSON list body)
    PUT    /apis/{kind}/{key}           → update
    DELETE /apis/{kind}/{key}           → delete
    GET    /watch?from={rv}&kinds=a,b&timeout=s
           → {"events": [{type, kind, object, old, rv}], "cursor": rv}
             long-poll; 410 Gone when the cursor fell behind the retained
             log (client re-lists, exactly the k8s watch contract)
    GET    /snapshot?kinds=a,b           → {"items": {kind: [...]},
           "cursor": rv} — ATOMIC list + watch cursor (the client-go
           reflector's list-then-watch-from-listRV contract); lets a
           remote informer attach with no gap and no double delivery
    POST   /bind/{key}                   → bind one pod ({"node": name};
           the binding subresource: CAS, 409 if already bound)
    POST   /bind                         → bulk bind ([[key, node], ...]
           body → {"bound": [keys]}; already-bound/gone pods skipped)
    POST   /checkpoint                   → force a durability point now
           (requires persist_path; 409 otherwise) — the etcdctl-snapshot
           analog; interval + shutdown checkpoints run automatically
    GET    /healthz
    GET    /timeline                     → temporal-telemetry JSON:
           per-profile snapshot rings (gauges, window counter deltas,
           histogram-delta quantiles, attribution tags) + SLO alert
           logs from any provider registered through
           ``APIServer.timeline_providers`` (a co-located
           SchedulerService appends ``timeline()``). Empty-but-valid
           with MINISCHED_TIMELINE unset.
    GET    /metrics                      → Prometheus text exposition:
           server request/rejection counters, per-kind object counts,
           watch-log depth, plus any gauges registered through
           ``APIServer.metrics_providers`` (e.g. a co-located
           scheduler's cycle metrics). The real kube-apiserver serves
           /metrics the same way; the reference inherits it from the
           upstream server it embeds.

Errors map to status codes: 404 NotFound, 409 AlreadyExists/Conflict,
400 bad input, 401 missing/bad bearer token (auth enabled), 429 over the
in-flight budget (flow control). Server threads only touch the
thread-safe store; the scheduler service runs beside it in-process,
exactly like the reference's apiserver+scheduler pairing.

Auth + flow control (reference parity): the reference wires loopback
bearer-token authentication with an always-allow authorizer
(reference k8sapiserver/k8sapiserver.go:139-153) and API-server flow
control (k8sapiserver.go:203-208). The rebuild's analogs:

  * ``token=...`` — every request except ``/healthz`` must carry
    ``Authorization: Bearer <token>`` or is answered 401 with reason
    ``Unauthorized``. Once authenticated, everything is allowed — the
    reference's always-allow authorizer. ``token=None`` (default)
    disables authentication, the pre-existing open-simulator behavior.
  * ``max_inflight=N`` — at most N requests are served concurrently;
    excess requests are answered 429 with a ``Retry-After`` header and
    reason ``TooManyRequests`` (the k8s APF reject contract, which
    client-go honors by sleeping and retrying). ``/healthz`` is exempt,
    like the health probes APF's exempt priority level covers. 0 (the
    default) disables the limit.
"""
from __future__ import annotations

import json
import logging
import socket
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from ..errors import AlreadyExistsError, ConflictError, NotFoundError
from ..state import objects as obj
from ..state.store import ClusterStore

log = logging.getLogger(__name__)


class _TrackingHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer that remembers open connection sockets so
    shutdown() can SEVER established keep-alive clients. Without this a
    "restarted" apiserver only closes its front door: handler threads on
    existing connections keep serving the old sessions, which no real
    process restart ever does — and the client-side outage detection
    (RemoteStore's ride-through arc) would never see the outage."""

    def __init__(self, *args, **kwargs):
        self._conns: set = set()
        self._conns_lock = threading.Lock()
        super().__init__(*args, **kwargs)

    def process_request(self, request, client_address):
        with self._conns_lock:
            self._conns.add(request)
        super().process_request(request, client_address)

    def shutdown_request(self, request):
        with self._conns_lock:
            self._conns.discard(request)
        super().shutdown_request(request)

    def handle_error(self, request, client_address):
        import sys

        exc = sys.exc_info()[1]
        if isinstance(exc, (ConnectionError, TimeoutError)):
            return  # severed at shutdown / client vanished: expected
        super().handle_error(request, client_address)

    def close_all_connections(self) -> int:
        with self._conns_lock:
            conns = list(self._conns)
            self._conns.clear()
        for s in conns:
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                s.close()
            except OSError:
                pass
        return len(conns)


class APIServer:
    """Serve a ClusterStore over HTTP on localhost:port (0 = ephemeral)."""

    def __init__(self, store: ClusterStore, host: str = "127.0.0.1",
                 port: int = 0, token: str | None = None,
                 max_inflight: int = 0, persist_path: str | None = None,
                 persist_interval_s: float = 30.0):
        """``persist_path`` enables the etcd-durability analog at the
        apiserver tier, where the reference keeps it (state lives behind
        the apiserver in etcd, k8sapiserver/k8sapiserver.go:93-105;
        docker-compose.yml:20-21 mounts the data volume): interval
        checkpoints while serving, a final one on shutdown(), and an
        on-demand POST /checkpoint (the etcdctl-snapshot analog; makes
        kill-tests deterministic). Boot the store with
        state.persistence.open_or_restore(persist_path) to resume."""
        self.store = store
        self.token = token
        self.checkpointer = None
        if persist_path:
            from ..state.persistence import Checkpointer

            self.checkpointer = Checkpointer(store, persist_path,
                                             interval_s=persist_interval_s)
        # exposed for tests: deterministic saturation without timing games
        self._inflight = (threading.BoundedSemaphore(max_inflight)
                          if max_inflight > 0 else None)
        # /metrics extension point: callables returning {name: number};
        # a co-located SchedulerService appends the engine's metrics()
        # so one scrape covers the whole simulator (emitted with the
        # minisched_engine_ prefix). Providers must be thread-safe.
        self.metrics_providers: list = []
        # Histogram extension point: callables returning {name:
        # obs.Histogram snapshot dict (bounds/counts/sum/count)} —
        # emitted as native Prometheus histograms (`_bucket` with
        # cumulative le labels, `_sum`, `_count`) under the same
        # minisched_engine_ prefix. A co-located SchedulerService
        # appends metrics_histograms here (the per-pod latency
        # histograms the engine feeds from lifecycle stamps).
        self.histogram_providers: list = []
        # /timeline extension point: callables returning {profile name:
        # timeline document} (Scheduler.timeline() dicts — snapshot
        # ring + SLO alerts). A co-located SchedulerService appends
        # ``timeline()``; the endpoint merges every provider into one
        # JSON body. Providers must be thread-safe.
        self.timeline_providers: list = []
        # /journal extension point: callables taking the ?since cursor
        # and returning the decision-journal document (obs/journal
        # to_doc shape). The journal is process-wide, so the FIRST
        # provider's document answers; a co-located SchedulerService
        # appends ``journal``. Providers must be thread-safe.
        self.journal_providers: list = []
        # /provenance extension point: callables taking a pod key and
        # returning its decision-provenance record or None; the first
        # non-None answer wins (profiles share no pods), all-None = 404.
        # A co-located SchedulerService appends ``provenance``.
        self.provenance_providers: list = []
        # Overload admission extension point: callables returning None
        # (admit) or a reason string — a non-None verdict rejects POD
        # creates with a typed 429 (reason ``SchedulerOverloaded`` +
        # Retry-After), the k8s APF-style backpressure remote producers
        # honor by backing off. A co-located SchedulerService appends
        # ``admission_reject_reason`` (engine/overload.py); only pod
        # creates are gated — node adds / deletes / binds must keep
        # flowing, they are what RECOVERS an overloaded cluster.
        self.admission_providers: list = []
        # server-side request counters for /metrics (lock-guarded)
        self._counters: dict = {}
        self._counters_lock = threading.Lock()
        # In-flight MUTATING requests (POST/PUT/DELETE): handler threads
        # are daemons the socketserver does not join, so shutdown() must
        # drain these itself before the final checkpoint — otherwise a
        # client-acknowledged write could be missing from the snapshot a
        # restart restores.
        self._mutating = 0
        self._mutating_cv = threading.Condition()
        # Set at shutdown: handler threads on established keep-alive
        # connections outlive the accept loop, so new mutations must be
        # REJECTED (503) once draining starts or they could land after
        # the final checkpoint yet be acknowledged to the client.
        self._draining = threading.Event()
        handler = _make_handler(store, token, self._inflight,
                                self.metrics_providers, self._counters,
                                self._counters_lock, self.checkpointer,
                                self._mutating_cv, self._track_mutation,
                                self._draining, self.histogram_providers,
                                self.timeline_providers,
                                self.admission_providers,
                                self.journal_providers,
                                self.provenance_providers)
        self._httpd = _TrackingHTTPServer((host, port), handler)
        self._httpd.daemon_threads = True
        self.host, self.port = self._httpd.server_address[:2]
        self._thread: threading.Thread | None = None

    @property
    def address(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "APIServer":
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True, name="apiserver")
        self._thread.start()
        return self

    def _track_mutation(self, delta: int) -> None:
        with self._mutating_cv:
            self._mutating += delta
            if self._mutating == 0:
                self._mutating_cv.notify_all()

    def shutdown(self) -> None:
        self._draining.set()  # keep-alive handlers now 503 mutations
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        # The accept loop is stopped but in-flight handler threads are
        # daemons socketserver never joins — drain the mutating ones
        # (bounded) so every write a client saw acknowledged lands:
        # inside the final snapshot when a checkpoint is due, and before
        # the socket under it is severed either way.
        import time as _time

        deadline = _time.monotonic() + 5.0
        with self._mutating_cv:
            while self._mutating and _time.monotonic() < deadline:
                self._mutating_cv.wait(0.1)
            if self._mutating:
                log.warning(
                    "shutdown proceeding with %d mutating request(s) "
                    "still in flight", self._mutating)
        # Sever established keep-alive connections: a stopped apiserver
        # must look like a stopped PROCESS — no old session keeps
        # serving out of the dead accept loop. This is what makes a
        # restart visible to clients as an outage (the RemoteStore
        # ride-through arc) instead of a silent store swap.
        self._httpd.close_all_connections()
        if self.checkpointer is not None:
            self.checkpointer.close()
            self.checkpointer = None


def _make_handler(store: ClusterStore, token: str | None = None,
                  inflight: threading.BoundedSemaphore | None = None,
                  metrics_providers: list | None = None,
                  counters: dict | None = None,
                  counters_lock: threading.Lock | None = None,
                  checkpointer=None, mutating_cv=None,
                  track_mutation=None, draining=None,
                  histogram_providers: list | None = None,
                  timeline_providers: list | None = None,
                  admission_providers: list | None = None,
                  journal_providers: list | None = None,
                  provenance_providers: list | None = None):
    if counters is None:
        counters = {}
    if counters_lock is None:
        counters_lock = threading.Lock()

    def bump(name: str) -> None:
        with counters_lock:
            counters[name] = counters.get(name, 0) + 1

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        # TCP_NODELAY: without it, keep-alive clients hit the Nagle +
        # delayed-ACK interaction — the response's status/header/body
        # writes coalesce behind an unacked segment and every request
        # stalls ~40 ms (measured: 44 ms/req → 0.26 ms/req on loopback).
        disable_nagle_algorithm = True

        # ---- plumbing ---------------------------------------------------

        def log_message(self, fmt, *args):  # route through logging, quiet
            log.debug("apiserver: " + fmt, *args)

        def _send(self, code: int, payload,
                  headers: dict | None = None) -> None:
            # compact separators: ~10% smaller frames than the default's
            # ", "/": " padding, measurable at 2000-object bursts
            body = json.dumps(payload, separators=(",", ":")).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _error(self, code: int, msg: str,
                   reason: str | None = None,
                   headers: dict | None = None) -> None:
            # ``reason`` is the client-go status-reason analog: clients
            # switch on it structurally instead of sniffing message text
            # (409 folds AlreadyExists and Conflict into one code).
            body = {"error": msg}
            if reason is not None:
                body["reason"] = reason
            self._send(code, body, headers=headers)

        def _body(self):
            n = int(self.headers.get("Content-Length", "0"))
            return json.loads(self.rfile.read(n)) if n else None

        def _route(self):
            """(kind, key, query) from the request path; key may be ''.

            Interior empty segments are PRESERVED: an empty-namespace
            object's key is "/name", so its per-object routes carry a
            double slash (POST /bind//name, GET /apis/Pod//name) —
            collapsing it would look up "name" and 404, and the engine
            treats a bind 404 as pod-deleted and forgets the pod."""
            u = urlparse(self.path)
            parts = u.path.split("/")[1:]  # absolute path: drop leading ''
            while parts and parts[-1] == "":  # tolerate trailing slashes
                parts.pop()
            q = parse_qs(u.query)
            if not parts or not parts[0]:
                return None, None, q
            if parts[0] == "apis" and len(parts) >= 2:
                return parts[1], "/".join(parts[2:]), q
            return parts[0], "/".join(parts[1:]), q

        def _guard(self, fn):
            try:
                fn()
            except NotFoundError as e:
                self._error(404, str(e), reason="NotFound")
            except AlreadyExistsError as e:
                self._error(409, str(e), reason="AlreadyExists")
            except ConflictError as e:
                self._error(409, str(e), reason="Conflict")
            except (KeyError, TypeError, ValueError) as e:
                self._error(400, f"{type(e).__name__}: {e}")
            except ConnectionError:
                # The client died mid-exchange (a SIGKILL'd replica's
                # long-poll, a severed shutdown socket): nothing to
                # answer and nothing wrong server-side.
                self.close_connection = True
            except Exception as e:  # pragma: no cover - server must answer
                log.exception("apiserver internal error")
                self._error(500, f"{type(e).__name__}: {e}")

        # ---- auth + flow-control gate -----------------------------------

        def _drain_body(self) -> None:
            """Consume an unread request body before answering early
            (401/429): with keep-alive HTTP/1.1 the leftover bytes would
            otherwise be parsed as the NEXT request line, desyncing the
            connection for pipelining clients."""
            n = int(self.headers.get("Content-Length", "0") or 0)
            if n:
                self.rfile.read(n)

        def _gated(self, fn) -> None:
            """Run one request through authn (bearer token) and flow
            control (bounded in-flight); /healthz bypasses both so health
            probes stay useful under load and without credentials."""
            route = urlparse(self.path).path.strip("/")
            if route == "healthz":
                return fn()
            if route == "metrics":
                # A Prometheus scrape loop must not inflate the request
                # counters it reports — scrapes get their own counter
                # (still behind auth/flow control below).
                bump("scrapes_metrics")
            else:
                bump(f"requests_{self.command.lower()}")
            if token is not None:
                auth = self.headers.get("Authorization", "")
                if auth != f"Bearer {token}":
                    bump("rejected_unauthorized")
                    self._drain_body()
                    return self._error(
                        401, "missing or invalid bearer token",
                        reason="Unauthorized")
            # Long-running requests are EXEMPT from the in-flight budget,
            # exactly like upstream's max-in-flight filter exempts WATCH:
            # a single long-poll would otherwise pin a slot for its whole
            # timeout and starve all CRUD traffic at small budgets.
            if inflight is None or route == "watch":
                return fn()
            if not inflight.acquire(blocking=False):
                # the k8s APF reject: 429 + Retry-After; client-go sleeps
                # and retries, and so does RemoteStore
                bump("rejected_too_many_requests")
                self._drain_body()
                return self._error(429, "too many in-flight requests",
                                   reason="TooManyRequests",
                                   headers={"Retry-After": "1"})
            try:
                fn()
            finally:
                inflight.release()

        # ---- verbs ------------------------------------------------------

        def do_GET(self):
            self._gated(self._get)

        def _tracked(self, fn) -> None:
            # Mutating verbs register with the server's drain counter so
            # shutdown's final checkpoint waits for them (daemon handler
            # threads are not joined by socketserver) — and are REJECTED
            # outright once draining starts, so no acknowledged write can
            # postdate the final snapshot.
            if draining is not None and draining.is_set():
                self._drain_body()
                return self._error(503, "server is shutting down",
                                   reason="ServiceUnavailable")
            if track_mutation is None:
                return self._gated(fn)
            track_mutation(1)
            try:
                self._gated(fn)
            finally:
                track_mutation(-1)

        def do_POST(self):
            self._tracked(self._post)

        def do_PUT(self):
            self._tracked(self._put)

        def do_DELETE(self):
            self._tracked(self._delete)

        def _get(self):
            kind, key, q = self._route()
            if kind == "healthz":
                return self._send(200, {"ok": True})
            if kind == "metrics":
                return self._guard(self._metrics)
            if kind == "timeline":
                return self._guard(lambda: self._timeline(q))
            if kind == "journal":
                return self._guard(lambda: self._journal(q))
            if kind == "provenance":
                return self._guard(lambda: self._provenance(key))
            if kind == "watch":
                return self._guard(lambda: self._watch(q))
            if kind == "snapshot":
                return self._guard(lambda: self._snapshot(q))
            if kind is None:
                return self._error(404, "no route")

            def run():
                if key:
                    self._send(200, obj.to_dict(store.get(kind, key)))
                else:
                    self._send(200, {"items": [obj.to_dict(o)
                                               for o in store.list(kind)]})
            self._guard(run)

        def _metrics(self):
            """TYPED Prometheus text exposition (version 0.0.4): every
            series carries its `# HELP` and `# TYPE` lines, and latency
            histograms from ``histogram_providers`` (obs.Histogram
            snapshots) are emitted in the NATIVE histogram form —
            `_bucket` samples with cumulative ``le`` labels, `_sum`,
            `_count` — so Prometheus' histogram_quantile works on the
            scrape directly. Existing flat counter/gauge NAMES are
            unchanged (scrape-compatible with pre-flight-recorder
            dashboards). Keys are sanitized to metric-name characters;
            non-numeric provider values are skipped (providers may
            carry diagnostic fields like batch_sizes lists)."""
            import re as _re

            def clean(name: str) -> str:
                return _re.sub(r"[^a-zA-Z0-9_:]", "_", name)

            lines = []

            def emit(name, value, mtype="gauge", labels="",
                     help_text=None):
                lines.append(f"# HELP {name} "
                             f"{help_text or 'minisched ' + mtype}")
                lines.append(f"# TYPE {name} {mtype}")
                lines.append(f"{name}{labels} {value}")

            def emit_histogram(name, snap, help_text=None):
                """Native histogram exposition from an obs.Histogram
                snapshot (finite bucket bounds + one +Inf bucket;
                ``le`` labels are CUMULATIVE per the format)."""
                bounds = snap.get("bounds") or []
                cnts = snap.get("counts") or []
                if len(cnts) != len(bounds) + 1:
                    return  # not a histogram snapshot; skip quietly
                lines.append(
                    f"# HELP {name} "
                    f"{help_text or 'minisched latency histogram (s)'}")
                lines.append(f"# TYPE {name} histogram")
                cum = 0
                for b, c in zip(bounds, cnts):
                    cum += c
                    lines.append(f'{name}_bucket{{le="{format(b, "g")}"}}'
                                 f' {cum}')
                cum += cnts[-1]
                lines.append(f'{name}_bucket{{le="+Inf"}} {cum}')
                lines.append(f'{name}_sum {snap.get("sum", 0.0)}')
                lines.append(f'{name}_count {snap.get("count", cum)}')

            with counters_lock:
                snap = dict(counters)
            for k in sorted(snap):
                emit(f"minisched_apiserver_{clean(k)}_total", snap[k],
                     "counter",
                     help_text="apiserver request/rejection counter")
            st = store.stats()
            # one HELP/TYPE pair for the metric, then all its samples —
            # the 0.0.4 exposition format rejects repeated TYPE lines
            lines.append("# HELP minisched_store_objects live objects "
                         "per kind")
            lines.append("# TYPE minisched_store_objects gauge")
            for kind, n in sorted(st["objects"].items()):
                lines.append(
                    f'minisched_store_objects{{kind="{kind}"}} {n}')
            emit("minisched_store_resource_version",
                 st["resource_version"], "counter",
                 help_text="store resource version (monotonic)")
            emit("minisched_store_watch_log_depth", st["watch_log_depth"],
                 help_text="retained watch-log events")
            emit("minisched_store_watch_log_capacity",
                 st["watch_log_capacity"],
                 help_text="watch-log ring capacity")
            # Process-wide fault-gate fire counts (faults.py): gates
            # outside any engine (http, checkpoint, informer) would be
            # invisible to the engine providers' metrics; one scrape
            # covers the whole failure domain. All-zero = the run was
            # provably fault-free.
            from ..faults import FAULTS as _faults

            lines.append("# HELP minisched_fault_fires_total injected "
                         "fault-gate fires per gate (faults.py)")
            lines.append("# TYPE minisched_fault_fires_total counter")
            for gate, n in sorted(_faults.counts().items()):
                lines.append(
                    f'minisched_fault_fires_total{{gate="{gate}"}} {n}')
            for provider in (metrics_providers or ()):
                try:
                    for k, v in provider().items():
                        if (isinstance(v, (int, float))
                                and not isinstance(v, bool)):
                            emit(f"minisched_engine_{clean(k)}", v,
                                 "counter" if k.endswith(
                                     ("_total", "_bound", "_seen"))
                                 else "gauge",
                                 help_text=f"engine metric {k} "
                                           "(Scheduler.metrics)")
                        elif isinstance(v, dict) and "bounds" in v:
                            # a provider may inline histogram snapshots
                            emit_histogram(f"minisched_engine_{clean(k)}",
                                           v)
                except Exception:  # a broken provider must not 500 scrapes
                    log.exception("metrics provider failed")
            for provider in (histogram_providers or ()):
                try:
                    for k, v in provider().items():
                        emit_histogram(
                            f"minisched_engine_{clean(k)}", v,
                            help_text=f"engine lifecycle latency {k} "
                                      "(obs.Histogram, seconds)")
                except Exception:
                    log.exception("histogram provider failed")
            body = ("\n".join(lines) + "\n").encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _timeline(self, q):
            """Temporal-telemetry JSON: every provider's per-profile
            timeline documents merged into one body. A broken provider
            must not 500 the endpoint — its profiles are skipped and
            the error noted, same contract as the metrics providers.
            ``?since=<seq>`` returns only rows newer than the cursor
            (each document's ``next_seq`` is what the client hands back
            next poll — scrapers stop re-downloading the full ring);
            legacy zero-arg providers keep answering the full ring.
            Each profile's seq space is independent, so a MULTI-profile
            scraper polls one profile per request —
            ``?profile=<name>&since=<seq>`` — a single scalar cursor
            across profiles would starve the slower profile's rows."""
            import inspect

            try:
                since = int(q.get("since", ["0"])[0])
            except ValueError:
                return self._error(400, "since must be an integer")
            want_profile = q.get("profile", [None])[0]
            merged: dict = {}
            errors = 0
            for provider in (timeline_providers or ()):
                try:
                    # Signature-dispatched (NOT a TypeError fallback: a
                    # TypeError raised inside a modern provider's body
                    # must surface as that provider's error, never
                    # silently re-run it zero-arg).
                    try:
                        takes_since = bool(
                            inspect.signature(provider).parameters)
                    except (TypeError, ValueError):
                        takes_since = False
                    doc = provider(since) if takes_since else provider()
                    if isinstance(doc, dict):
                        merged.update(doc)
                except Exception:
                    errors += 1
                    log.exception("timeline provider failed")
            if want_profile is not None:
                merged = {k: v for k, v in merged.items()
                          if k == want_profile}
            body = {"timelines": merged}
            if errors:
                body["provider_errors"] = errors
            self._send(200, body)

        def _journal(self, q):
            """Decision-journal JSON (obs/journal.py): the process-wide
            causal event log from the first answering provider, filtered
            by the ``?since=<seq>`` cursor (poll with the last response's
            ``next_seq``). Empty-but-valid when no provider is wired or
            MINISCHED_JOURNAL is unset."""
            try:
                since = int(q.get("since", ["0"])[0])
            except ValueError:
                return self._error(400, "since must be an integer")
            errors = 0
            for provider in (journal_providers or ()):
                try:
                    doc = provider(since)
                    if isinstance(doc, dict):
                        return self._send(200, doc)
                except Exception:
                    errors += 1
                    log.exception("journal provider failed")
            if errors:
                # A CRASHED provider must not masquerade as an unarmed
                # journal (enabled:false would tell the operator to
                # stop looking exactly when the history matters) — the
                # _timeline provider_errors contract.
                return self._send(200, {"provider_errors": errors,
                                        "entries": []})
            self._send(200, {"enabled": False, "next_seq": 0,
                             "dropped": 0, "entries": []})

        def _provenance(self, key):
            """Per-pod decision provenance (obs/journal.ProvenanceStore
            via the engine): ``GET /provenance/<ns>/<name>``. The first
            provider holding a record answers; none = 404 (a pod the
            journal never saw, or MINISCHED_JOURNAL unset)."""
            if not key:
                return self._error(404, "no route")
            for provider in (provenance_providers or ()):
                try:
                    rec = provider(key)
                    if rec is not None:
                        return self._send(200, rec)
                except Exception:
                    log.exception("provenance provider failed")
            self._error(404, f"no provenance record for {key!r}",
                        reason="NotFound")

        def _watch(self, q):
            """Stateless long-poll watch: each call opens a cursor at
            ``from`` and drains up to ~1024 events (or times out empty).
            A cursor behind the retained log answers 410 Gone — the
            client re-lists and restarts, the k8s reflector contract."""
            frm = int(q.get("from", ["0"])[0])
            kinds = q.get("kinds", [""])[0]
            timeout = min(float(q.get("timeout", ["5"])[0]), 30.0)
            limit = min(int(q.get("limit", ["1024"])[0]), 4096)
            w = None
            try:
                w = store.watch(kinds=kinds.split(",") if kinds else None,
                                from_version=frm)
                evs = w.next_events(limit, timeout=timeout)
                # The watcher's own cursor, NOT the last matching event's
                # rv: it advanced past kind-filtered events too, so the
                # client neither rescans them next poll nor spuriously
                # falls behind on unrelated churn.
                cursor = w.cursor
            except ValueError as e:  # fell behind the retained log
                return self._error(410, str(e))
            finally:
                if w is not None:
                    w.stop()
            out = [{"type": e.type,  # plain str constants (store.EventType)
                    "kind": e.kind,
                    "object": obj.to_dict(e.object),
                    "old": (obj.to_dict(e.old_object)
                            if e.old_object is not None else None),
                    "rv": e.resource_version} for e in evs]
            self._send(200, {"events": out, "cursor": cursor})

        def _snapshot(self, q):
            """Atomic list + cursor: taken under one store lock via
            list_and_watch (the watcher only donates its start cursor)."""
            kinds = q.get("kinds", [""])[0]
            lists, w = store.list_and_watch(
                kinds=kinds.split(",") if kinds else None)
            cursor = w.cursor
            w.stop()
            self._send(200, {
                "items": {k: [obj.to_dict(o) for o in objs]
                          for k, objs in lists.items()},
                "cursor": cursor})

        def _post(self):
            kind, key, q = self._route()
            if kind == "checkpoint":
                # On-demand durability point (the etcdctl-snapshot
                # analog); 409 when the server wasn't started with a
                # persist path — there is nowhere to write.
                def run():
                    if checkpointer is None:
                        return self._error(
                            409, "server has no persist_path configured",
                            reason="Conflict")
                    wrote = checkpointer.checkpoint()
                    self._send(200, {"checkpointed": True, "wrote": wrote,
                                     "path": checkpointer.path})
                return self._guard(run)
            if kind == "bind":
                def run():
                    if key:  # single: the CAS contract, typed errors
                        node = (self._body() or {}).get("node", "")
                        self._send(200, obj.to_dict(
                            store.bind_pod(key, node)))
                    else:    # bulk: skip-and-report contract
                        pairs = [(p[0], p[1]) for p in self._body()]
                        self._send(200,
                                   {"bound": store.bind_pods(pairs)})
                return self._guard(run)
            if kind is None:
                return self._error(404, "no route")
            if kind == "Pod" and admission_providers:
                # Overload backpressure: a co-located engine at its
                # shed/brownout rung answers pod creates with a typed
                # 429-style verdict (counted, Retry-After) — the wire
                # analog of the queue-ingress shed lane. Only POD
                # creates: capacity-adding traffic must keep flowing.
                reason = None
                for provider in admission_providers:
                    try:
                        reason = provider()
                    except Exception:
                        log.exception("admission provider failed")
                        reason = None
                    if reason:
                        break
                if reason:
                    bump("rejected_overloaded")
                    self._drain_body()
                    return self._error(429, reason,
                                       reason="SchedulerOverloaded",
                                       headers={"Retry-After": "1"})

            def run():
                body = self._body()
                if q.get("bulk"):
                    created = store.create_many(
                        [obj.from_dict(kind, d) for d in body])
                    if q.get("slim"):
                        # The client already HOLDS the full objects — it
                        # only lacks what the store stamped. Echoing 2000
                        # full pods back doubles the create path's codec
                        # cost for nothing; slim returns just the stamps
                        # (same order as the request, the create_many
                        # contract).
                        self._send(201, {"stamps": [
                            [o.metadata.resource_version,
                             o.metadata.creation_timestamp]
                            for o in created]})
                        return
                    self._send(201, {"items": [obj.to_dict(o)
                                               for o in created]})
                else:
                    created = store.create(obj.from_dict(kind, body))
                    self._send(201, obj.to_dict(created))
            self._guard(run)

        def _put(self):
            kind, key, _q = self._route()
            if kind is None or not key:
                return self._error(404, "no route")

            def run():
                o = obj.from_dict(kind, self._body())
                if o.key != key:
                    return self._error(
                        400, f"body names {o.key!r} but URL targets "
                             f"{key!r}")
                # Optimistic concurrency over the wire (the k8s update
                # contract): a body carrying a resourceVersion asserts
                # "I am updating THAT revision" — stale → 409 Conflict.
                # rv 0 means the client didn't read first; take the
                # unconditional path the in-process store also offers.
                updated = store.update(
                    o, check_version=o.metadata.resource_version != 0)
                self._send(200, obj.to_dict(updated))
            self._guard(run)

        def _delete(self):
            kind, key, _q = self._route()
            if kind is None or not key:
                return self._error(404, "no route")

            def run():
                store.delete(kind, key)
                self._send(200, {"deleted": key})
            self._guard(run)

    return Handler

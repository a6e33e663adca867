"""HTTP client for the API server — the client-go analog.

``RemoteStore`` mirrors the ClusterStore verbs an external tool needs
(create / create_many / get / list / update / delete / watch_events) over
the wire, decoding JSON back into the typed API objects and mapping
status codes back onto the store's exception types — so scenario code
written against the in-process store drives a remote simulator unchanged
(reference sched.go:42-68 drives its apiserver through client-go the
same way).

client-go parity knobs:
  * ``token`` — bearer token sent as ``Authorization: Bearer ...`` (the
    reference's loopback restclient.Config carries one,
    k8sapiserver.go:139-153); a 401 raises ``UnauthorizedError``.
  * ``qps``/``burst`` — client-side token-bucket rate limiting, default
    5000/5000 exactly like the reference's restclient.Config
    (k8sapiserver.go:57-62); ``qps=0`` disables.
  * a 429 (server flow control) is honored by sleeping ``Retry-After``
    and retrying, the client-go default behavior.
"""
from __future__ import annotations

import http.client
import json
import logging
import os
import socket
import threading
import time
import urllib.parse
from typing import Any, Dict, List, Optional, Tuple

from ..errors import (AlreadyExistsError, ConflictError, NotFoundError,
                      UnauthorizedError, WatchFellBehindError)
from ..faults import FAULTS, FaultInjected
from ..obs.journal import note as jnote
from ..state import objects as obj
from ..utils.breaker import BreakerOpenError, CircuitBreaker
from ..utils.retry import jittered_delays

log = logging.getLogger(__name__)


class _ServerError(RuntimeError):
    """A non-2xx the generic handler folds to RuntimeError, carrying the
    structured status/reason so the transient-retry policy can
    discriminate (a 503 drain reject is provably-unapplied; a 500 on a
    mutation is not). Stays a RuntimeError: callers that caught the old
    generic error keep working."""

    def __init__(self, status: int, msg: str, reason=None):
        super().__init__(f"apiserver {status}: {msg}")
        self.status = status
        self.reason = reason


class _TokenBucket:
    """client-go flowcontrol.NewTokenBucketRateLimiter analog: ``burst``
    capacity refilled at ``qps`` tokens/s; ``take`` blocks until a token
    is available (client-go's Wait)."""

    def __init__(self, qps: float, burst: int):
        self.qps = float(qps)
        self.capacity = float(max(burst, 1))
        self._tokens = self.capacity
        self._last = time.monotonic()
        self._lock = threading.Lock()

    def take(self) -> None:
        with self._lock:
            now = time.monotonic()
            self._tokens = min(self.capacity,
                               self._tokens + (now - self._last) * self.qps)
            self._last = now
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                return
            # Sleep under the lock: queued callers drain strictly at the
            # refill rate, which is the limiter contract. The token that
            # matures at the end of the sleep is the one consumed.
            wait = (1.0 - self._tokens) / self.qps
            time.sleep(wait)
            self._tokens = 0.0
            self._last = time.monotonic()


class RemoteStore:
    def __init__(self, address: str, timeout: float = 10.0,
                 token: Optional[str] = None,
                 qps: float = 5000.0, burst: int = 5000,
                 retry_deadline_s: float = 5.0,
                 breaker_threshold: int = 6,
                 breaker_reset_s: float = 0.5):
        """``retry_deadline_s``: transient failures (connection refused/
        reset, 5xx, malformed frames) are retried with jittered
        exponential backoff until this much wall time has passed, then
        the last error propagates — so a server restart or a blip on the
        wire does not fail the first engine call that hits it. 0
        disables (every failure propagates immediately, the pre-retry
        behavior). Mutating verbs only retry failures that provably
        precede application (see _transient).

        A shared circuit breaker (utils/breaker.py) fronts the retry
        loop: ``breaker_threshold`` consecutive wire-class failures —
        across ALL threads, this is the client-wide health verdict —
        open it, after which a hard-down server is PROBED once per
        ``breaker_reset_s`` instead of hammered with a fresh connection
        per retry slot per thread until every deadline lapses. Calls
        arriving while it is open sleep toward the probe slot (still
        bounded by their own retry deadline). ``breaker_threshold=0``
        disables. State/counters surface via :meth:`breaker_stats` and
        the engine's ``/metrics`` (``store_breaker_*``)."""
        self.address = address.rstrip("/")
        self.retry_deadline_s = retry_deadline_s
        self.breaker = (CircuitBreaker(breaker_threshold, breaker_reset_s)
                        if breaker_threshold > 0 else None)
        # Apiserver-outage ride-through: after ``outage_after``
        # CONSECUTIVE wire-class failures the client declares the store
        # down (journaled ``store.outage``); the first successful
        # exchange afterwards closes the arc (``store.reattach``,
        # duration counted) and fires every ``on_reattach`` callback —
        # the seam where an engine reconciles its queue against store
        # truth (Scheduler.reconcile_store). Callbacks run on the
        # calling thread with no client lock held (they may re-enter the
        # store).
        self.outage_after = 3
        self._reattach_lock = threading.Lock()
        self._consec_failures = 0
        self._down_since: Optional[float] = None
        self._reattach_cbs: List[Any] = []
        self._reattach_counters: Dict[str, float] = {
            "outages": 0, "reattaches": 0, "last_outage_s": 0.0}
        u = urllib.parse.urlparse(self.address)
        if u.scheme not in ("http", "https"):
            raise ValueError(f"unsupported scheme in {address!r}; "
                             "expected http:// or https://")
        self._https = u.scheme == "https"
        self._host = u.hostname
        self._port = u.port or (443 if self._https else 80)
        self.timeout = timeout
        self.token = token
        self._limiter = _TokenBucket(qps, burst) if qps > 0 else None
        # One persistent keep-alive connection PER THREAD (informer pump,
        # binder workers, scenario thread each get their own — http.client
        # connections are not thread-safe). Reuse kills the
        # per-request TCP setup urllib paid; TCP_NODELAY on both ends
        # kills the Nagle/delayed-ACK stall (see server.py).
        self._local = threading.local()

    # ---- wire plumbing --------------------------------------------------

    def _conn(self) -> http.client.HTTPConnection:
        c = getattr(self._local, "conn", None)
        if c is None:
            cls = (http.client.HTTPSConnection if self._https
                   else http.client.HTTPConnection)
            c = cls(self._host, self._port, timeout=self.timeout)
            self._local.conn = c
        return c

    def _drop_conn(self) -> None:
        c = getattr(self._local, "conn", None)
        if c is not None:
            try:
                c.close()
            except Exception:
                pass
            self._local.conn = None

    def _request(self, method: str, path: str, data, headers,
                 timeout: float):
        """One HTTP exchange over the thread's persistent connection →
        (status, headers, body). ONLY an IDEMPOTENT request (GET) that
        hits a stale keep-alive failure on a REUSED connection retries
        once on a fresh one — for a mutating verb even a
        RemoteDisconnected does not prove the request never reached the
        server (it may have applied the mutation and died before writing
        a response byte — the kill -9 durability scenario), so resending
        could double-apply; the error propagates and the CALLER owns the
        ambiguity, exactly as with the old one-connection-per-request
        transport. Timeouts and mid-exchange failures always propagate;
        every failure path drops the connection."""
        stale = (http.client.RemoteDisconnected,
                 http.client.CannotSendRequest, BrokenPipeError,
                 ConnectionResetError)
        for attempt in (0, 1):
            conn = self._conn()
            fresh = conn.sock is None
            try:
                if fresh:
                    conn.connect()
                    conn.sock.setsockopt(socket.IPPROTO_TCP,
                                         socket.TCP_NODELAY, 1)
                conn.sock.settimeout(timeout)
                conn.request(method, path, body=data, headers=headers)
                resp = conn.getresponse()
                body = resp.read()  # drain fully so the conn is reusable
                return resp.status, resp.headers, body
            except stale:
                self._drop_conn()
                if fresh or attempt or method != "GET":
                    raise
            except (http.client.HTTPException, OSError):
                self._drop_conn()  # timeout/mid-exchange: never resend
                raise
        raise AssertionError("unreachable")

    # Wire faults retried as transient when the exchange provably did
    # not apply (connect refused: nothing was ever sent) or the verb is
    # idempotent. Everything mid-exchange on a mutation stays the
    # caller's ambiguity, exactly as _request documents.
    _SAFE_CONN_ERRORS = (ConnectionRefusedError,)
    _WIRE_ERRORS = (http.client.HTTPException, OSError)

    def _transient(self, e: Exception, method: str) -> bool:
        """Is this failure safe to retry for this verb? GETs: any wire
        fault, malformed frame, or 5xx. Mutations: only failures that
        provably precede application — connection refused (connect()
        failed; no bytes sent) and the server's 503 drain/unavailable
        reject (answered without touching the store). An injected
        ``http`` gate fault counts as transient for every verb: the gate
        models the wire eating the request, and absorbing it is the
        behavior the gate exists to prove."""
        if isinstance(e, FaultInjected):
            return True
        if isinstance(e, self._SAFE_CONN_ERRORS):
            return True
        if isinstance(e, _ServerError):
            if 500 <= e.status < 600:
                return (method == "GET" or e.status == 503
                        or e.reason == "ServiceUnavailable")
            return False
        if method != "GET":
            return False
        if isinstance(e, self._WIRE_ERRORS):
            return True
        # the malformed-JSON transport error is a bare RuntimeError
        return type(e) is RuntimeError

    def _call(self, method: str, path: str, body=None,
              timeout: Optional[float] = None, _retries: int = 2):
        """One logical API call with transient-failure absorption:
        jittered exponential backoff (utils/retry.py jittered_delays)
        bounded by ``retry_deadline_s`` wall time — a flaky server fails
        an engine verb only when it stays broken past the deadline, not
        on the first blip."""
        deadline = (time.monotonic() + self.retry_deadline_s
                    if self.retry_deadline_s > 0 else None)
        delays = jittered_delays(initial_duration=0.05, factor=2.0,
                                 max_duration=1.0)
        last_err: Optional[Exception] = None
        while True:
            if self.breaker is not None and not self.breaker.allow():
                # Open breaker: the server is known-down — don't touch
                # the socket. Sleep toward the next probe slot (bounded
                # by this call's own deadline) instead of burning a
                # retry on a guaranteed connection failure.
                e: Exception = BreakerOpenError(
                    f"circuit open to {self.address}")
                if last_err is not None:
                    e.__cause__ = last_err
                now = time.monotonic()
                if deadline is None or now >= deadline:
                    raise e
                wait = max(self.breaker.next_probe_in(), 0.01)
                time.sleep(min(wait, deadline - now))
                continue
            try:
                FAULTS.hit("http")  # fault gate: RemoteStore HTTP
                out = self._call_once(method, path, body=body,
                                      timeout=timeout, _retries=_retries)
                if self.breaker is not None:
                    self.breaker.record_success()
                self._note_wire_success()
                return out
            except (NotFoundError, UnauthorizedError, AlreadyExistsError,
                    ConflictError, WatchFellBehindError):
                # typed API verdicts are answers, not failures — the
                # wire is healthy, the breaker heals on them
                if self.breaker is not None:
                    self.breaker.record_success()
                self._note_wire_success()
                raise
            except Exception as e:
                # Remaining failures are wire-shaped (refused/reset/
                # timeout/5xx/malformed/injected) — feed the breaker
                # even when THIS verb cannot safely retry (a
                # mid-mutation disconnect still proves the server
                # unhealthy; the ambiguity stays the caller's). A
                # non-5xx _ServerError is an ANSWER (the server is up,
                # the request was bad) and heals the breaker instead.
                answered = (isinstance(e, _ServerError)
                            and not 500 <= e.status < 600)
                if self.breaker is not None:
                    if answered:
                        self.breaker.record_success()
                    else:
                        self.breaker.record_failure()
                if answered:
                    self._note_wire_success()
                else:
                    self._note_wire_failure()
                last_err = e
                now = time.monotonic()
                if (deadline is None or now >= deadline
                        or not self._transient(e, method)):
                    raise
                if (self.breaker is not None
                        and self.breaker.state != 0):
                    # Breaker tripped: it owns the pacing from here —
                    # the top of the loop sleeps toward the probe slot
                    # instead of this schedule's jittered dial-retry.
                    continue
                sleep = min(next(delays), max(0.0, deadline - now))
                log.warning("transient apiserver failure (%s %s: %s); "
                            "retrying in %.2fs", method, path, e, sleep)
                time.sleep(sleep)

    def _call_once(self, method: str, path: str, body=None,
                   timeout: Optional[float] = None, _retries: int = 2):
        if self._limiter is not None:
            self._limiter.take()
        data = (None if body is None
                else json.dumps(body, separators=(",", ":")).encode())
        headers = {"Content-Type": "application/json",
                   "Content-Length": str(len(data) if data else 0)}
        if self.token is not None:
            headers["Authorization"] = f"Bearer {self.token}"
        status, rheaders, raw = self._request(
            method, path, data, headers, timeout or self.timeout)
        if status < 400:
            try:
                return json.loads(raw)
            except ValueError:  # JSONDecodeError AND UnicodeDecodeError
                # A truncated/mangled 200 body is a TRANSPORT failure —
                # it must surface as the retryable RuntimeError class,
                # never as a ValueError the watch path could mistake for
                # the 410 fell-behind signal.
                raise RuntimeError(
                    f"apiserver returned malformed JSON "
                    f"({len(raw)} bytes)") from None
        reason = None
        retry_after = rheaders.get("Retry-After")
        try:
            payload = json.loads(raw)
            msg = payload.get("error", f"HTTP {status}")
            reason = payload.get("reason")
        except Exception:
            msg = f"HTTP {status}"
        if status == 404:
            raise NotFoundError(msg) from None
        if status == 401:
            raise UnauthorizedError(msg) from None
        if status == 429 and _retries > 0:
            # server flow control: honor Retry-After and retry
            # (client-go's default 429 handling)
            try:
                delay = min(max(0.0, float(retry_after or 1.0)), 5.0)
            except ValueError:
                delay = 1.0
            time.sleep(delay)
            return self._call_once(method, path, body=body,
                                   timeout=timeout, _retries=_retries - 1)
        if status == 409:
            # the server folds AlreadyExists and Conflict into 409
            # and disambiguates with a structured ``reason`` field
            # (the client-go status-reason analog); the message
            # sniff is only a fallback for pre-reason servers.
            if reason == "AlreadyExists" or (
                    reason is None and "already exists" in msg):
                raise AlreadyExistsError(msg) from None
            raise ConflictError(msg) from None
        if status == 410:
            raise WatchFellBehindError(msg) from None
        raise _ServerError(status, msg, reason)

    # ---- store verbs ----------------------------------------------------

    def create(self, o: Any) -> Any:
        kind = obj.kind_of(o)
        return obj.from_dict(kind, self._call(
            "POST", f"/apis/{kind}", obj.to_dict(o)))

    def create_many(self, objs: List[Any]) -> List[Any]:
        """Bulk create with the slim response: the server stamps
        rv/creation_timestamp and returns ONLY those (we already hold the
        full objects) — matching the in-process create_many contract,
        which stamps the caller's own objects and returns them."""
        if not objs:
            return []
        kind = obj.kind_of(objs[0])
        out = self._call("POST", f"/apis/{kind}?bulk=1&slim=1",
                         [obj.to_dict(o) for o in objs])
        for o, (rv, ts) in zip(objs, out["stamps"]):
            o.metadata.resource_version = rv
            o.metadata.creation_timestamp = ts
        return objs

    def get(self, kind: str, key: str) -> Any:
        return obj.from_dict(kind, self._call("GET", f"/apis/{kind}/{key}"))

    def list(self, kind: str) -> List[Any]:
        out = self._call("GET", f"/apis/{kind}")
        return [obj.from_dict(kind, d) for d in out["items"]]

    def update(self, o: Any, *, check_version: bool = False) -> Any:
        """Mirrors ClusterStore.update's signature: unconditional
        last-writer-wins by default (the drop-in contract), optimistic
        concurrency when ``check_version`` — the body's resourceVersion
        asserts "I am updating THAT revision" and a stale one raises
        ConflictError. The unconditional path zeroes the rv on the wire
        (the server treats rv != 0 as a version assertion)."""
        kind = obj.kind_of(o)
        body = obj.to_dict(o)
        if not check_version:
            body["metadata"]["resource_version"] = 0
        return obj.from_dict(kind, self._call(
            "PUT", f"/apis/{kind}/{o.key}", body))

    def delete(self, kind: str, key: str) -> None:
        self._call("DELETE", f"/apis/{kind}/{key}")

    def bind_pod(self, pod_key: str, node_name: str) -> Any:
        """The binding subresource (store.bind_pod CAS contract: 409 if
        already bound, 404 for a missing pod/node)."""
        return obj.from_dict("Pod", self._call(
            "POST", f"/bind/{pod_key}", {"node": node_name}))

    def bind_pods(self, assignments) -> List[str]:
        """Bulk binding commit; returns the newly-bound keys (store
        bind_pods skip-and-report contract)."""
        if not assignments:
            return []
        out = self._call("POST", "/bind",
                         [[k, n] for k, n in assignments])
        return out["bound"]

    def snapshot(self, kinds: Optional[List[str]] = None):
        """Atomic list + watch cursor (GET /snapshot): the reflector's
        list-then-watch-from-listRV contract over the wire."""
        q = "/snapshot"
        if kinds:
            q += "?kinds=" + ",".join(kinds)
        out = self._call("GET", q)
        items = {k: [obj.from_dict(k, d) for d in v]
                 for k, v in out["items"].items()}
        return items, out["cursor"]

    def list_and_watch(self, kinds: Optional[List[str]] = None):
        """(initial lists, watcher) with the SAME shape the in-process
        ClusterStore returns — so the informer factory (and therefore
        the whole scheduler engine) can attach to a remote apiserver as
        a pure network client (reference scheduler/scheduler.go:54-75:
        the scheduler reaches its apiserver exclusively through
        client-go list+watch)."""
        items, cursor = self.snapshot(kinds)
        return items, RemoteWatcher(self, kinds, cursor)

    def watch_events(self, cursor: int, kinds: Optional[List[str]] = None,
                     timeout: float = 5.0,
                     limit: int = 1024) -> Tuple[List[dict], int]:
        """One long-poll: up to ``limit`` events after ``cursor`` (dicts
        with type/kind/object/old/rv; objects decoded) and the new
        cursor — the server advances the cursor only past what it
        returned, so a small limit never skips events. Raises
        WatchFellBehindError when the cursor fell behind (re-list and
        restart — the k8s reflector contract)."""
        q = f"/watch?from={cursor}&timeout={timeout}&limit={limit}"
        if kinds:
            q += "&kinds=" + ",".join(kinds)
        out = self._call("GET", q, timeout=timeout + self.timeout)
        events = []
        for e in out["events"]:
            e = dict(e)
            e["object"] = obj.from_dict(e["kind"], e["object"])
            if e.get("old") is not None:
                e["old"] = obj.from_dict(e["kind"], e["old"])
            events.append(e)
        return events, out["cursor"]

    def checkpoint(self) -> dict:
        """POST /checkpoint — force a durability point now (the etcdctl
        snapshot analog). ConflictError when the server has no
        persist_path."""
        return self._call("POST", "/checkpoint")

    def journal(self, since: int = 0) -> dict:
        """GET /journal?since= — the serving process's decision-journal
        document (obs/journal.to_doc shape: ``entries`` + ``next_seq``),
        for a process that gathers another process's journal."""
        return self._call("GET", f"/journal?since={int(since)}")

    def provenance(self, pod_key: str) -> Optional[dict]:
        """GET /provenance/<pod> — the serving process's decision
        provenance record for one pod, None when it holds none."""
        from urllib.parse import quote

        # Keep '/' literal: the server splits the path and rejoins the
        # tail, so a namespaced key travels as /provenance/<ns>/<name>.
        try:
            return self._call("GET",
                              f"/provenance/{quote(pod_key, safe='/')}")
        except NotFoundError:
            return None

    def healthz(self) -> bool:
        try:
            return bool(self._call("GET", "/healthz").get("ok"))
        except Exception:
            return False

    def breaker_stats(self) -> dict:
        """Circuit-breaker state/counters for the /metrics surface
        (Scheduler.metrics() prefixes these ``store_``). Empty when the
        breaker is disabled."""
        return self.breaker.stats() if self.breaker is not None else {}

    # ---- apiserver-outage ride-through ----------------------------------

    def on_reattach(self, cb) -> None:
        """Register ``cb(outage_s: float)`` to fire on the first
        successful exchange after a detected outage — the client-side
        reconciliation hook (e.g. ``Scheduler.reconcile_store``). Callbacks
        run on whichever thread's call ended the outage, with no client
        lock held; exceptions are swallowed (a broken hook must never
        poison the call that just succeeded)."""
        with self._reattach_lock:
            self._reattach_cbs.append(cb)

    def reattach_stats(self) -> Dict[str, float]:
        """Outage/reattach counters for the /metrics surface
        (Scheduler.metrics() prefixes these ``store_``)."""
        with self._reattach_lock:
            out = dict(self._reattach_counters)
            out["down"] = 1.0 if self._down_since is not None else 0.0
            return out

    def _note_wire_failure(self) -> None:
        """One wire-class failure observed. Crossing ``outage_after``
        consecutive failures declares the outage (journaled once)."""
        with self._reattach_lock:
            self._consec_failures += 1
            if (self._down_since is not None
                    or self._consec_failures < self.outage_after):
                return
            self._down_since = time.monotonic()
            self._reattach_counters["outages"] += 1
        jnote("store.outage", address=self.address,
              replica=os.environ.get("MINISCHED_PROC_REPLICA", ""),
              after_failures=self.outage_after)
        log.warning("apiserver outage declared (%s): %d consecutive "
                    "wire failures", self.address, self.outage_after)

    def _note_wire_success(self) -> None:
        """One successful exchange. If an outage was open this closes
        the arc: journaled with its duration, counted, and every
        ``on_reattach`` callback fires (outside the lock — callbacks
        re-enter the store to re-list/reconcile)."""
        with self._reattach_lock:
            self._consec_failures = 0
            if self._down_since is None:
                return
            outage_s = time.monotonic() - self._down_since
            self._down_since = None
            self._reattach_counters["reattaches"] += 1
            self._reattach_counters["last_outage_s"] = round(outage_s, 3)
            cbs = list(self._reattach_cbs)
        jnote("store.reattach", address=self.address,
              replica=os.environ.get("MINISCHED_PROC_REPLICA", ""),
              outage_s=round(outage_s, 3))
        log.warning("apiserver reattached (%s) after %.2fs outage",
                    self.address, outage_s)
        for cb in cbs:
            try:
                cb(outage_s)
            except Exception:
                log.exception("reattach callback failed; continuing")


class RemoteWatcher:
    """Watcher-shaped adapter over the HTTP long-poll — the drop-in the
    informer factory needs (next_events / stop / cursor), so the engine's
    watch pump runs unchanged against a remote store.

    The fell-behind contract carries through: a cursor past the server's
    retained log answers 410 → watch_events raises ValueError → the
    informer re-lists through ``list_and_watch`` (the same recovery it
    performs in-process). Each ``next_events`` call is one HTTP
    long-poll; an idle engine therefore polls at its drain interval
    (~5 req/s at the informer's 0.2 s timeout) — chatty but stateless,
    the trade the reference's httptest apiserver makes too."""

    def __init__(self, rs: RemoteStore, kinds: Optional[List[str]],
                 cursor: int):
        from ..state.store import WatchEvent

        self._rs = rs
        self._kinds = kinds
        self._cursor = cursor
        self._stopped = False
        self._mk = WatchEvent

    @property
    def cursor(self) -> int:
        return self._cursor

    def next_events(self, max_n: int,
                    timeout: Optional[float] = None) -> list:
        if self._stopped:
            return []
        try:
            events, self._cursor = self._rs.watch_events(
                self._cursor, kinds=self._kinds,
                timeout=min(timeout if timeout is not None else 5.0, 30.0),
                limit=max_n)
        except WatchFellBehindError:
            raise  # 410 — the informer's re-list contract
        except UnauthorizedError:
            raise  # 401 is a permanent credential error, not a transient
        except Exception:
            # Transient network failure (connection reset, server accept
            # backlog overflow, a 5xx, a stalled long-poll): the informer
            # dispatch loop only handles ValueError, so ANY other
            # exception would kill the watch pump permanently — the
            # engine would then pend every future pod with healthz still
            # green. Back off briefly and report an empty poll; the
            # cursor is untouched, so nothing is skipped and the next
            # poll resumes exactly where this one failed.
            import time as _time

            log.warning("remote watch poll failed; retrying",
                        exc_info=True)
            _time.sleep(0.5)
            return []
        return [self._mk(type=e["type"], kind=e["kind"],
                         object=e["object"], old_object=e.get("old"),
                         resource_version=e["rv"])
                for e in events]

    def next_event(self, timeout: Optional[float] = None):
        evs = self.next_events(1, timeout=timeout)
        return evs[0] if evs else None

    def stop(self) -> None:
        self._stopped = True

"""The README scenario driven OVER THE WIRE — reference parity for
"an external process drives the simulator through its apiserver"
(reference boots kube-apiserver at k8sapiserver/k8sapiserver.go:43-71 and
sched.go:42-68 drives it through client-go).

    python -m minisched_tpu_torch.scenario.remote [--client-engine]
                                                  [--platform cpu]

``--serve``: boot store + scheduler service + HTTP apiserver and print
the listening address (the simulator process).
``--serve-store-only``: boot ONLY store + HTTP apiserver — no engine;
a remote client is expected to bring its own scheduler.
default: spawn the server as a SUBPROCESS, then run the README scenario
(sched.go:70-143) purely through HTTP via RemoteStore — 9 unschedulable
nodes, pod1 pends with NodeUnschedulable recorded, node10 arrives, pod1
binds to node10 — and shut the server down.
``--client-engine``: the reference's actual process shape
(scheduler/scheduler.go:54-75 — the scheduler is a PURE apiserver
client): spawn a store-only server, then run the ENGINE in this client
process over RemoteStore (informers long-polling /watch, bindings
through /bind) and drive the same scenario.
``--platform``: the engine's device (``SchedulerConfig.platform``), passed
on to the server process: "" (the default) is the first CUDA device and
raises without one; ``cpu`` runs each kernel's plain version.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

from ..state import objects as obj

# The directory holding this package: the server subprocess runs there so
# that ``-m minisched_tpu_torch...`` imports this copy of the package.
_PKG_PARENT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _scenario_config(platform: str):
    from ..config import SchedulerConfig

    return SchedulerConfig(backoff_initial_s=0.1, backoff_max_s=0.5,
                           batch_window_s=0.0, platform=platform)


def serve(store_only: bool = False, platform: str = "") -> None:
    """Simulator process: store (+ scheduler on ``platform`` unless
    ``store_only``) + HTTP front; prints the address, serves until stdin
    closes (parent exit kills us)."""
    from ..apiserver import APIServer
    from ..service.service import SchedulerService
    from ..state.store import ClusterStore

    # Durability (reference: etcd's data volume, docker-compose.yml:20-21):
    # restore the store from the last snapshot and keep checkpointing.
    persist_path = os.environ.get("MINISCHED_PERSIST_PATH") or None
    if persist_path:
        from ..state.persistence import open_or_restore

        store = open_or_restore(persist_path)
    else:
        store = ClusterStore()
    svc = None
    if not store_only:
        svc = SchedulerService(store)
        svc.start_scheduler(config=_scenario_config(platform))
    api = APIServer(store,
                    host=os.environ.get("MINISCHED_API_HOST", "127.0.0.1"),
                    port=int(os.environ.get("MINISCHED_API_PORT", "0")),
                    token=os.environ.get("MINISCHED_API_TOKEN") or None,
                    max_inflight=int(os.environ.get(
                        "MINISCHED_API_MAX_INFLIGHT", "0")),
                    persist_path=persist_path,
                    persist_interval_s=float(os.environ.get(
                        "MINISCHED_PERSIST_INTERVAL", "30"))
                    ).start()
    if svc is not None:
        wire_service(api, svc)
    print(f"LISTENING {api.address}", flush=True)
    try:
        sys.stdin.read()  # parent closes the pipe → exit
    except KeyboardInterrupt:
        pass
    finally:
        # Scheduler FIRST: api.shutdown() writes the final checkpoint,
        # and the co-located engine mutates the store in-process (not
        # via HTTP) — stopping it after the snapshot would lose binds
        # committed in the gap on a clean shutdown.
        if svc is not None:
            svc.shutdown_scheduler()
        api.shutdown()


def wire_service(api, svc) -> None:
    """Register a co-located SchedulerService's surfaces on an APIServer:
    one /metrics scrape covers every profile (flat gauges and the per-pod
    latency histograms), GET /timeline, /journal and /provenance/<pod>
    serve the engines' telemetry (empty or 404 while unarmed), and pod
    creates answer a typed 429 while an engine sheds (MINISCHED_OVERLOAD;
    a no-op when unset)."""
    api.metrics_providers.append(svc.metrics)
    api.histogram_providers.append(svc.metrics_histograms)
    api.timeline_providers.append(svc.timeline)
    api.journal_providers.append(svc.journal)
    api.provenance_providers.append(svc.provenance)
    api.admission_providers.append(svc.admission_reject_reason)


def _wait(pred, timeout: float = 30.0, interval: float = 0.1):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        v = pred()
        if v:
            return v
        time.sleep(interval)
    raise AssertionError("condition not met within timeout")


def run_remote_scenario(address: str) -> None:
    """The README scenario (reference sched.go:70-143), over HTTP."""
    from ..apiserver import RemoteStore

    rs = RemoteStore(address,
                     token=os.environ.get("MINISCHED_API_TOKEN") or None)
    _wait(rs.healthz, timeout=15)

    rs.create_many([obj.Node(
        metadata=obj.ObjectMeta(name=f"node{i}"),
        spec=obj.NodeSpec(unschedulable=True),
        status=obj.NodeStatus(allocatable={"cpu": 4000, "memory": 16 << 30,
                                           "pods": 110}))
        for i in range(9)])
    rs.create(obj.Pod(metadata=obj.ObjectMeta(name="pod1",
                                              namespace="default"),
                      spec=obj.PodSpec(requests={"cpu": 100})))

    # Generous timeout: the first scheduling attempt loads the kernels.
    pending = _wait(lambda: (
        p := rs.get("Pod", "default/pod1")).status.unschedulable_plugins
        and p or None, timeout=120)
    assert pending.status.unschedulable_plugins == ["NodeUnschedulable"], \
        pending.status.unschedulable_plugins
    assert pending.spec.node_name == ""
    print("pod1 pending as expected over the wire "
          f"(unschedulable_plugins={pending.status.unschedulable_plugins})")

    rs.create(obj.Node(
        metadata=obj.ObjectMeta(name="node10"),
        status=obj.NodeStatus(allocatable={"cpu": 4000, "memory": 16 << 30,
                                           "pods": 110})))
    bound = _wait(lambda: (
        p := rs.get("Pod", "default/pod1")).spec.node_name and p or None)
    assert bound.spec.node_name == "node10", bound.spec.node_name
    print(f"pod1 is bound to {bound.spec.node_name} over the wire")

    # watch surface: the whole history replays through the HTTP long-poll
    events, cursor = rs.watch_events(0, kinds=["Pod"], timeout=2.0)
    kinds_seen = {(e["type"]) for e in events}
    assert "ADDED" in kinds_seen and "MODIFIED" in kinds_seen, kinds_seen
    assert any(e["type"] == "MODIFIED"
               and e["object"].spec.node_name == "node10" for e in events)
    print(f"watch replayed {len(events)} Pod events to cursor {cursor}")
    print("remote scenario OK")


def run_client_engine_scenario(address: str, platform: str = "") -> None:
    """The SCHEDULER as a pure apiserver client (reference
    scheduler/scheduler.go:54-75): the engine in THIS process, on
    ``platform``, attaches to a store-only server over RemoteStore —
    informers long-poll /watch, failures update pods over PUT, bindings
    commit through /bind — then the README scenario runs against the
    same wire."""
    from ..apiserver import RemoteStore
    from ..service.service import SchedulerService

    rs = RemoteStore(address,
                     token=os.environ.get("MINISCHED_API_TOKEN") or None)
    _wait(rs.healthz, timeout=15)
    svc = SchedulerService(rs)
    svc.start_scheduler(config=_scenario_config(platform))
    try:
        run_remote_scenario(address)
        print("client-engine scenario OK (engine attached over the wire)")
    finally:
        svc.shutdown_scheduler()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="The README scenario over the HTTP API server.")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--serve", action="store_true",
                      help="serve a store and its scheduler; print the "
                           "address")
    mode.add_argument("--serve-store-only", action="store_true",
                      help="serve a store with no scheduler")
    mode.add_argument("--client-engine", action="store_true",
                      help="run the engine here, over the wire")
    ap.add_argument("--platform", default="",
                    help='the engine\'s device: "" (default) = cuda:0, '
                         'or cpu')
    args = ap.parse_args(argv)
    if args.serve or args.serve_store_only:
        serve(store_only=args.serve_store_only, platform=args.platform)
        return
    serve_flag = ("--serve-store-only" if args.client_engine
                  else "--serve")
    proc = subprocess.Popen(
        [sys.executable, "-m", "minisched_tpu_torch.scenario.remote",
         serve_flag, "--platform", args.platform],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
        cwd=_PKG_PARENT)
    try:
        line = proc.stdout.readline().strip()
        assert line.startswith("LISTENING "), line
        address = line.split(" ", 1)[1]
        if args.client_engine:
            run_client_engine_scenario(address, platform=args.platform)
        else:
            run_remote_scenario(address)
    finally:
        try:
            proc.stdin.close()  # server exits when the pipe closes
            proc.wait(timeout=30)
        except Exception:
            proc.kill()
            proc.wait()


if __name__ == "__main__":
    main()

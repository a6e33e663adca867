"""Where the time of the port's API-server wire goes, on the host, at
bench-50k.

    python tools/wire_timing.py [--nodes 50000] [--pods 10000]
                                [--batch 1024] [--reps 2]

Builds chip_smoke.py's bench store (the nodes and the pods), serves it
with the port's APIServer (bearer token, max_inflight=256, as
chip_smoke.py phase I1 and bench.py's wire cell serve it) and times, in
this one process, the parts of the informers' initial list over the
wire:

  server encode   ``to_dict`` of every object of ``/snapshot`` and its
                  ``json.dumps`` (the handler's work, timed in process);
  GET /snapshot   the raw HTTP exchange (the server's encode, the
                  transfer and the read of the body);
  client decode   ``json.loads`` of the body, then the codec's
                  ``from_dict`` of every object (RemoteStore.snapshot);
  in process      ``ClusterStore.list_and_watch`` of the same kinds (the
                  in-process informer's list, deep copies included);

then one batch of the burst: ``POST /bind`` of ``--batch`` pods and the
``/watch`` long-polls that return their bind confirmations to an
informer (bytes and time). Each part runs ``--reps`` times; every time
is printed. The last line is one JSON object with the medians. Needs no
card: the wire is host code.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
import urllib.request

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import bench_workload  # noqa: E402
from minisched_tpu_torch.apiserver import APIServer, RemoteStore  # noqa: E402
from minisched_tpu_torch.state import objects as O  # noqa: E402
from minisched_tpu_torch.state.store import ClusterStore  # noqa: E402

TOKEN = "wire-timing"
KINDS = ["Node", "Pod"]


def _clock(fn):
    t = time.perf_counter()
    out = fn()
    return time.perf_counter() - t, out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nodes", type=int, default=50_000)
    ap.add_argument("--pods", type=int, default=10_000)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args()

    nodes, pods = bench_workload(args.nodes, args.pods)
    store = ClusterStore()
    t_store, _ = _clock(lambda: (store.create_many(nodes),
                                 store.create_many(pods)))
    print(f"store: {args.nodes} nodes + {args.pods} pods in {t_store:.3f} s")
    api = APIServer(store, token=TOKEN, max_inflight=256).start()
    rs = RemoteStore(api.address, token=TOKEN)
    url = f"{api.address}/snapshot?kinds={','.join(KINDS)}"
    times: dict = {k: [] for k in (
        "server_encode_s", "get_snapshot_s", "client_json_s",
        "client_codec_s", "in_process_list_s", "bind_batch_s",
        "watch_batch_s")}
    size = 0
    try:
        for rep in range(args.reps):
            def encode():
                lists, w = store.list_and_watch(kinds=KINDS)
                w.stop()
                return json.dumps({"items": {
                    k: [O.to_dict(o) for o in objs]
                    for k, objs in lists.items()}}, separators=(",", ":"))
            dt, _ = _clock(encode)
            times["server_encode_s"].append(dt)

            def get():
                req = urllib.request.Request(
                    url, headers={"Authorization": f"Bearer {TOKEN}"})
                with urllib.request.urlopen(req, timeout=300) as r:
                    return r.read()
            dt, body = _clock(get)
            times["get_snapshot_s"].append(dt)
            size = len(body)
            dt, doc = _clock(lambda: json.loads(body))
            times["client_json_s"].append(dt)
            dt, _ = _clock(lambda: {k: [O.from_dict(k, d) for d in v]
                                    for k, v in doc["items"].items()})
            times["client_codec_s"].append(dt)
            del body, doc

            def listed():
                lists, w = store.list_and_watch(kinds=KINDS)
                w.stop()
                return lists
            dt, _ = _clock(listed)
            times["in_process_list_s"].append(dt)
            print(f"rep {rep}: " + ", ".join(
                f"{k} {v[-1]:.3f}" for k, v in times.items() if v)
                + f"; /snapshot {size} bytes")

        # One batch of the burst: its bulk bind and the watch polls that
        # bring the confirmations back to an informer.
        batches = [pods[i:i + args.batch]
                   for i in range(0, args.reps * args.batch, args.batch)]
        node_names = [n.metadata.name for n in nodes
                      if not n.spec.unschedulable]
        watch_bytes = []
        for b, batch in enumerate(batches):
            cursor = store.resource_version()
            pairs = [(p.key, node_names[(b * args.batch + i)
                                        % len(node_names)])
                     for i, p in enumerate(batch)]
            dt, bound = _clock(lambda: rs.bind_pods(pairs))
            assert len(bound) == len(batch), len(bound)
            times["bind_batch_s"].append(dt)

            def watch():
                got, cur, nbytes = 0, cursor, 0
                while got < len(batch):
                    req = urllib.request.Request(
                        f"{api.address}/watch?from={cur}&kinds=Pod"
                        f"&timeout=1&limit=4096",
                        headers={"Authorization": f"Bearer {TOKEN}"})
                    with urllib.request.urlopen(req, timeout=60) as r:
                        raw = r.read()
                    nbytes += len(raw)
                    doc = json.loads(raw)
                    for e in doc["events"]:
                        O.from_dict("Pod", e["object"])
                        O.from_dict("Pod", e["old"])
                    got += len(doc["events"])
                    cur = doc["cursor"]
                return nbytes
            dt, nbytes = _clock(watch)
            times["watch_batch_s"].append(dt)
            watch_bytes.append(nbytes)
            print(f"batch {b}: POST /bind of {len(batch)} pods "
                  f"{times['bind_batch_s'][-1]:.4f} s; /watch of their "
                  f"confirmations {dt:.4f} s, {nbytes} bytes (decoded)")
    finally:
        api.shutdown()
    out = {k: statistics.median(v) for k, v in times.items()}
    out.update(snapshot_bytes=size, watch_bytes_per_batch=watch_bytes[-1],
               nodes=args.nodes, pods=args.pods, batch=args.batch)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

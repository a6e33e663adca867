"""Multi-process dryrun: the sharded step over a hybrid mesh whose pod
axis spans OS processes.

The single-process mesh (``make_mesh``) keeps every shard in one
process. This module runs the other half: N worker processes join one
``torch.distributed`` group over gloo, ``make_hybrid_mesh`` puts the pod
axis on the group's ranks and ``DEVS_PER_PROC`` node shards in each
process, and ``build_sharded_step`` (the auction, its default) runs with
its pod-axis collectives between the processes
(parallel/collectives.DistCollectives). Every process must hold the
same decision, and it must equal a single-device recompute of
``ops/pipeline.build_step(assignment="auction")`` in every field.

On one card both workers sit on ``cuda:0``: NCCL refuses two ranks on
one device, so the pod axis rides gloo there too, staging through host
buffers any operation the installed gloo build does not take on CUDA
tensors (each worker prints which). Every step computation stays on the
card.

Run it on the CPU:  python -m minisched_tpu_torch.parallel.dcn_dryrun --platform cpu
and on the card with no flag (``cuda:0``).
"""
from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import time

DEVS_PER_PROC = 4


def _worker_inputs():
    """A small workload that shows a double booking: 64 capacity-1
    nodes, 1 in 7 cordoned, 16 pods. Every process builds the same
    inputs from the same spec (each process encodes the same replicated
    cluster state)."""
    from ..encode import NodeFeatureCache, encode_pods
    from ..state.objects import (Node, NodeSpec, NodeStatus, ObjectMeta,
                                 Pod, PodSpec)

    n_nodes, n_pods = 64, 16
    cache = NodeFeatureCache(capacity=n_nodes)
    for i in range(n_nodes):
        cache.upsert_node(Node(
            metadata=ObjectMeta(name=f"node{i}"),
            spec=NodeSpec(unschedulable=(i % 7 == 0)),
            status=NodeStatus(allocatable={
                "cpu": 4000 + (i % 5) * 500, "memory": 16 << 30,
                "pods": 1})))
    pods = [Pod(metadata=ObjectMeta(name=f"pod{i}", namespace="default"),
                spec=PodSpec(requests={"cpu": 100 + (i % 3) * 50,
                                       "memory": 1 << 30}))
            for i in range(n_pods)]
    eb = encode_pods(pods, n_pods, registry=cache.registry)
    nf, _ = cache.snapshot(pad=n_nodes)
    af = cache.snapshot_assigned()
    return eb, nf, af, n_nodes, n_pods


# The worker runs from ``python -c``: a CPU worker hides the CUDA devices
# before torch starts (utils/platform_guard), then the group forms before
# any input is built, then the step's modules load. It imports nothing
# but this package.
_BOOTSTRAP = """
import sys
sys.path.insert(0, {repo!r})
from minisched_tpu_torch.utils.platform_guard import enforce_cpu_only
enforce_cpu_only({platform!r})
import datetime
import torch.distributed as dist
dist.init_process_group("gloo", init_method="tcp://127.0.0.1:{port}",
                        world_size={nprocs}, rank={proc_id},
                        timeout=datetime.timedelta(seconds=60))
try:
    from minisched_tpu_torch.parallel.dcn_dryrun import worker_body
    worker_body({proc_id}, {nprocs}, {platform!r})
finally:
    dist.destroy_process_group()
"""


def worker_body(proc_id: int, nprocs: int, platform: str) -> None:
    """One participant, after the group has formed (see _BOOTSTRAP).
    Prints ``DCN-OK <proc_id>`` when the decision checks out."""
    import torch
    import torch.distributed as dist

    from ..encode import to_torch
    from ..ops import prng
    from ..ops.pipeline import build_step
    from ..service.defaultconfig import full_scheduler_profile
    from ..utils.platform_guard import wants_cpu
    from .mesh import make_hybrid_mesh, shard_features
    from .sharded import build_sharded_step

    assert dist.get_world_size() == nprocs
    device = torch.device("cpu" if wants_cpu(platform)
                          else (platform or "cuda:0"))
    # Pod axis = the processes, node axis = DEVS_PER_PROC shards here.
    mesh = make_hybrid_mesh(devices=[device] * DEVS_PER_PROC)
    assert mesh.devices.shape == (nprocs, DEVS_PER_PROC)
    coll = mesh.collectives

    eb, nf, af, n_nodes, n_pods = _worker_inputs()
    eb, nf, af = (to_torch(x, device) for x in (eb, nf, af))
    ps = full_scheduler_profile().build()
    key = prng.PRNGKey(0)
    step = build_sharded_step(ps, mesh, eb, nf, af)
    decision = step(*shard_features(mesh, eb, nf, af), key)

    # Agreement: every process's decision, all-gathered over the pod
    # axis, must be the same.
    for field in decision._fields:
        mine = getattr(decision, field)
        every = coll.pod_all_gather(
            {coll.rank: mine[None]}, 0, device)
        if not all(torch.equal(every[r], mine) for r in range(nprocs)):
            raise RuntimeError(f"proc {proc_id}: the processes disagree on "
                               f"{field}")
    assigned = decision.assigned.cpu()
    chosen = decision.chosen.cpu()
    n_assigned = int(assigned.sum())
    if n_assigned != n_pods:
        raise RuntimeError(
            f"proc {proc_id}: only {n_assigned}/{n_pods} assigned")
    picked = chosen[assigned].tolist()
    if len(set(picked)) != len(picked):
        raise RuntimeError(f"proc {proc_id}: double-booked capacity-1 "
                           f"nodes: {picked}")
    bad = [j for j in picked if j % 7 == 0]
    if bad:
        raise RuntimeError(
            f"proc {proc_id}: pods on unschedulable nodes {bad}")

    # Single-device parity: the collectives changed where the math ran,
    # not the math.
    d_local = build_step(ps, assignment="auction")(eb, nf, af, key)
    for field in d_local._fields:
        a, b = getattr(d_local, field), getattr(decision, field)
        if a.dtype != b.dtype or not torch.equal(a, b):
            raise RuntimeError(
                f"proc {proc_id}: DCN {field} diverges from "
                f"single-device: {b.tolist()} vs {a.tolist()}")
    print(f"DCN-OK {proc_id}: mesh {tuple(mesh.devices.shape)} "
          f"{mesh.axis_names} over {nprocs} processes x {DEVS_PER_PROC} "
          f"shards on {device}; pod axis {coll.kind}/{coll.backend}, "
          f"staged through host: {','.join(coll.staged) or 'none'}; "
          f"{n_assigned}/{n_pods} scheduled, distinct capacity-1 nodes, "
          "DCN == single-device", flush=True)


def run_dcn_dryrun(nprocs: int = 2, timeout_s: float = 300.0,
                   port: int = 0, platform: str = "") -> str:
    """Spawn ``nprocs`` workers on ``platform`` (``""`` = ``cuda:0``,
    which raises without a card; ``"cpu"`` hides the CUDA devices from
    the workers) and check that each prints DCN-OK. Returns their
    combined output; raises on any failure or timeout. Every worker is
    reaped on the way out."""
    from ..fleet.procfleet import child_device_env
    from ..utils.platform_guard import wants_cpu

    if not wants_cpu(platform):
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError(f"run_dcn_dryrun(platform={platform!r}) "
                               "needs a CUDA device and none is available; "
                               "pass platform='cpu' to run on the CPU")
    if port == 0:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
    repo = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    env = child_device_env(dict(os.environ), platform)
    procs = [subprocess.Popen(
        [sys.executable, "-u", "-c", _BOOTSTRAP.format(
            repo=repo, port=port, nprocs=nprocs, proc_id=i,
            platform=platform)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=repo) for i in range(nprocs)]
    deadline = time.monotonic() + timeout_s
    outs = []
    try:
        for p in procs:
            remaining = max(1.0, deadline - time.monotonic())
            out, _ = p.communicate(timeout=remaining)
            outs.append(out)
            if p.returncode != 0:
                raise RuntimeError(
                    f"DCN worker failed (rc={p.returncode}):\n{out}")
    except subprocess.TimeoutExpired:
        raise RuntimeError("DCN dryrun timed out:\n" + "\n".join(outs))
    finally:
        # A worker whose peer died blocks in a collective: kill the rest.
        for p in procs:
            if p.poll() is None:
                p.kill()
                try:
                    p.wait(timeout=5)
                except subprocess.TimeoutExpired:
                    pass
    combined = "\n".join(outs)
    for i in range(nprocs):
        if f"DCN-OK {i}" not in combined:
            raise RuntimeError(
                f"worker {i} did not report DCN-OK:\n{combined}")
    return combined


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--platform", default="",
                    help='"cpu", or "" for cuda:0 (the default)')
    print(run_dcn_dryrun(platform=ap.parse_args(argv).platform))


if __name__ == "__main__":
    main()

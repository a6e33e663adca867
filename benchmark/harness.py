"""Drive one cell of the port end to end and judge what it produced.

Set-up builds the cell's cluster from the seed in the port's store,
starts the port's scheduler service (``scenario.runner.Cluster``) with
the configuration's profile and knobs, waits until its informers hold
every node, and schedules one batch of the cell's own pods (the
analogue of scheduler_perf's ``initPods``). The window then runs the
traffic mix: a closed loop that keeps a backlog standing (the one kind
of loop the mixes name). After the window the loop stops, every pod
created is waited for (a minute at most), the device's peak memory is
read, the bindings are read back from the store, the service is shut
down, and the plain reference judges the bindings.

With ``trace`` the engine's spans are armed for the whole run and
``torch.profiler`` records the window's last seconds (host and device);
the run reports the per-layer metrics instead of the end-to-end ones.
"""
from __future__ import annotations

import gc
import importlib
import time
from typing import Dict, Optional

import numpy as np

from . import hostwatch, tracing, workload
from .reference import check

SYNC_TIMEOUT_S = 300.0
WARM_TIMEOUT_S = 300.0
CLOSED_POLL_S = 0.02    # how often the closed loop reads the bound count


def scheduler_config(config: dict, seed: int, device: str):
    from minisched_tpu_torch.config import SchedulerConfig

    knobs = dict(config["scheduler"])
    return SchedulerConfig(platform=device, seed=seed % (1 << 31), **knobs)


def profile(config: dict):
    """The configuration's profile: ``"profile"`` names the program's
    function that builds it, as ``"<module>:<function>"``."""
    module, _, fn = config["profile"].partition(":")
    return getattr(importlib.import_module(module), fn)()


def wait_until(pred, timeout: float, interval: float = 0.01) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return pred()


class Run:
    """One run of one cell: set-up, window, drain, judgement."""

    def __init__(self, cell, seed: int, seconds: float, trace: bool,
                 device: str):
        self.seed = seed
        self.seconds = float(seconds)
        self.trace = trace
        self.device = device
        self.config = cell.config
        self.traffic = cell.traffic
        self.cluster = None
        self.sched = None
        self.created = 0           # pods created so far (the next seq)
        self.window = (0.0, 0.0)
        self.counters0: dict = {}
        self.counters1: dict = {}
        self.profile: Optional[dict] = None
        self.memory_peak = 0
        self.host = hostwatch.HostWatch()

    # ---- the system ---------------------------------------------------

    def bound(self) -> int:
        return int(self.sched.metrics()["pods_bound"])

    def create(self, seqs) -> None:
        self.cluster.create_objects(self.source.objects(seqs, self.O))

    def setup(self) -> None:
        from minisched_tpu_torch import obs
        from minisched_tpu_torch.scenario.runner import Cluster
        from minisched_tpu_torch.state import objects as O

        self.O = O
        self.host.start()
        cl = self.config["cluster"]
        if self.trace:
            obs.configure(True)
        self.cluster = Cluster()
        self.cluster.create_objects(workload.make_nodes(cl, self.seed, O))
        self.cluster.start(profile(self.config),
                           scheduler_config(self.config, self.seed,
                                            self.device),
                           with_pv_controller=False)
        self.sched = self.cluster.service.scheduler
        if not wait_until(lambda: self.sched.cache.node_count()
                          == cl["nodes"], SYNC_TIMEOUT_S, 0.05):
            raise RuntimeError("the informers did not sync the nodes")
        self.source = workload.PodSource(self.traffic["pod"], cl["zones"],
                                         self.seed)
        warm = int(self.traffic["warm_pods"])
        self.create(range(warm))
        self.created = warm
        if not wait_until(lambda: self.bound() >= warm, WARM_TIMEOUT_S):
            raise RuntimeError(f"set-up: {self.bound()} of {warm} pods "
                               "bound")
        if self.trace:
            tracing.Profiler.warm(self.device)
        self._sync_device()

    def _sync_device(self) -> None:
        if self.device != "cpu":
            import torch

            torch.cuda.synchronize()

    # ---- the window ---------------------------------------------------

    def top_up(self) -> bool:
        """Create chunks until ``backlog`` pods wait; True if it made
        any."""
        backlog = int(self.traffic["backlog"])
        chunk = int(self.traffic["chunk"])
        made = False
        while self.created - self.bound() < backlog:
            self.create(range(self.created, self.created + chunk))
            self.created += chunk
            made = True
        return made

    def run_window(self):
        if self.traffic["loop"] != "closed":
            raise ValueError(f"unknown loop {self.traffic['loop']!r}")
        self.top_up()   # the backlog stands before the window opens
        prof = None
        t0 = time.time()
        t_end = t0 + self.seconds
        if self.trace:
            prof = tracing.Profiler(self, t_end, self.traffic)
        self.counters0 = self.sched.metrics()
        self.host.mark()
        while True:
            now = time.time()
            if now >= t_end:
                break
            if prof is not None:
                prof.poll(now)
            if not self.top_up():
                time.sleep(CLOSED_POLL_S)
        self.counters1 = self.sched.metrics()
        self.host.close()
        self.pending_at_close = self.created - int(
            self.counters1["pods_bound"])
        self.window = (t0, t_end)
        if prof is not None:
            prof.stop()
        return prof

    def drain(self) -> None:
        wait_until(lambda: self.bound() >= self.created,
                   float(self.traffic["drain_s"]), 0.02)
        self._sync_device()

    # ---- judgement ----------------------------------------------------

    def read_back(self) -> check.Pods:
        """The bindings, read back from the store, as the reference's
        arrays (every created pod, in creation order), and each pod's
        creation stamp."""
        M = self.created
        shapes = [self.source.shape(s) for s in range(M)]
        node = np.full(M, -1, dtype=np.int64)
        stamp = np.full(M, np.nan)
        self.created_at = np.full(M, np.nan)
        version = np.zeros(M, dtype=np.int64)
        mounts: Dict[str, set] = {}
        for pod in self.cluster.store.list("Pod"):
            s = workload.pod_seq(pod.metadata.name)
            self.created_at[s] = pod.metadata.creation_timestamp
            if pod.spec.node_name:
                node[s] = int(pod.spec.node_name.rsplit("-", 1)[1])
                stamp[s] = pod.status.scheduled_time
                version[s] = pod.metadata.resource_version
                for v in pod.spec.volumes:
                    mounts.setdefault(v.claim_name, set()).add(node[s])
        claim_nodes = np.zeros(M, dtype=np.int64)
        for s, sh in enumerate(shapes):
            if sh.claim_zone >= 0:
                claim_nodes[s] = len(mounts.get(f"c{s}", ()))
        return check.Pods(
            seq=np.arange(M),
            cpu=np.array([sh.cpu for sh in shapes]),
            memory=np.array([sh.memory for sh in shapes]),
            claim_zone=np.array([sh.claim_zone for sh in shapes]),
            spread=np.array([sh.spread for sh in shapes], dtype=bool),
            affinity=np.array([sh.affinity for sh in shapes], dtype=bool),
            node=node, stamp=stamp, version=version,
            claim_nodes=claim_nodes)

    def nodes(self) -> check.Nodes:
        cl = self.config["cluster"]
        cpu, cordoned, zone = workload.node_arrays(cl, self.seed)
        n = cl["nodes"]
        return check.Nodes(
            cpu=cpu, memory=np.full(n, float(cl["node_memory_bytes"])),
            pods=np.full(n, float(cl["node_max_pods"])),
            volumes=np.full(n, float(cl["attachable_volumes"])),
            cordoned=cordoned, zone=zone)

    def shutdown(self) -> None:
        self.host.stop()
        if self.cluster is not None:
            self.cluster.shutdown()
        self.cluster = None
        self.sched = None
        gc.collect()
        if self.device != "cpu":
            import torch

            torch.cuda.empty_cache()


def scoring(config: dict, traffic: dict) -> check.Scoring:
    """The reference's scoring rules for a configuration's weights and a
    mix's pod terms (upstream's: DoNotSchedule unscored, the preferred
    zone terms symmetric)."""
    w = config["score_weights"]
    spread = traffic["pod"].get("spread") or {}
    return check.Scoring(
        weight_fit=float(w["NodeResourcesFit"]),
        weight_balanced=float(w["NodeResourcesBalancedAllocation"]),
        max_skew=int(spread.get("max_skew", 0)),
        weight_affinity=float(w["InterPodAffinity"]),
        term_weight=float(spread.get("affinity_weight", 0)),
        weight_spread=float(w["PodTopologySpread"]))


def run(cell, seed: int, seconds: float, trace: bool, device: str,
        t_process: float, controls: tuple = (),
        variants: Optional[Dict[str, check.Scoring]] = None) -> dict:
    """One run: returns the record the metrics are read from, with the
    reference's comparison under ``compared``."""
    r = Run(cell, seed, seconds, trace, device)
    try:
        r.setup()
        prof = r.run_window()
        r.drain()
        if prof is not None:
            prof.finish()
            r.profile = prof.result
        if device != "cpu":
            import torch

            r.memory_peak = int(torch.cuda.max_memory_allocated())
        pods = r.read_back()
    finally:
        r.shutdown()
    t0, t_end = r.window
    nodes = r.nodes()
    warm = int(cell.traffic["warm_pods"])
    sample = check.sample(pods, int(cell.traffic["sample"]), seed,
                          np.arange(warm, r.created))
    rules = scoring(cell.config, cell.traffic)
    compared = check.compare(nodes, pods, rules, sample, controls=controls,
                             tie_seed=seed, variants=variants)
    in_window = (pods.stamp >= t0) & (pods.stamp < t_end)
    return {
        "setup_s": t0 - t_process,
        "seconds": t_end - t0,
        "bound_in_window": int(in_window.sum()),
        "bound_by_fifth": np.histogram(pods.stamp[in_window], bins=5,
                                       range=(t0, t_end))[0].tolist(),
        "c2b_s": (pods.stamp - r.created_at)[in_window],
        "created": r.created,
        "attempted": r.created - warm,
        "counters": tracing.counter_delta(r.counters0, r.counters1),
        "shapes": r.counters1.get("last_shapes"),
        "max_batch_size": int(cell.config["scheduler"]["max_batch_size"]),
        "profile": r.profile,
        "memory_peak_bytes": r.memory_peak,
        "compared": compared,
        "pending_at_close": r.pending_at_close,
        "host": r.host.summary(t0, t_end),
        "judged": (nodes, pods, rules, sample),
        "config": cell.config,
        "traffic": cell.traffic,
    }

"""Arithmetic the per-layer metric readers share: per-batch times from
the engine's counters, the device's share of the traced window, and the
least time a kernel's launched shape needs on the card.

Every reader returns None where its run holds nothing to read (no batch,
no trace, no launch of its kernel); the harness then leaves the metric
out of the result line.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

# Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at its
# 700 W limit): HBM3 bandwidth and float32 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# The resource axes every node row carries (cpu, memory, pods,
# ephemeral-storage, accelerator and five attach-slot axes).
RESOURCE_AXES = 10


def per_batch_ms(rec: dict, counter: str) -> Optional[float]:
    """A host phase's seconds over the window per batch, in ms."""
    c = rec["counters"]
    if not c.get("batches"):
        return None
    return 1e3 * c[counter] / c["batches"]


def batch_fill(rec: dict) -> Optional[float]:
    """Pods per batch as a share of ``max_batch_size``, in %."""
    c = rec["counters"]
    if not c.get("batches"):
        return None
    return 100.0 * c["pods_seen"] / c["batches"] / rec["max_batch_size"]


def _traced(rec: dict) -> Optional[dict]:
    prof = rec.get("profile")
    if not prof or prof["window_s"] <= 0 or prof["busy_s"] <= 0:
        return None
    return prof


def device_idle(rec: dict) -> Optional[float]:
    """The traced window's share in which no device operation ran, %."""
    prof = _traced(rec)
    if prof is None:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])


def step_device_ms(rec: dict) -> Optional[float]:
    """Device time of every operation but the hand-written kernels, per
    batch folded in the traced window, in ms."""
    from .tracing import HAND_KERNELS, kernel_name

    prof = _traced(rec)
    if prof is None or not prof["counters"].get("batches"):
        return None
    other = sum(v["s"] for k, v in prof["ops"].items()
                if kernel_name(k) not in HAND_KERNELS)
    return 1e3 * other / prof["counters"]["batches"]


def _rows_per_launch(prof: dict, shapes) -> Optional[tuple]:
    """(P, N) of the mean launch in the traced window: the batches'
    scored pod rows per batch over the padded node axis."""
    c = prof["counters"]
    if not c.get("batches") or not shapes:
        return None
    n = float(shapes[1])
    return c["scored_rows_total"] / c["batches"] / n, n


def kernel_roofline(rec: dict, kernel: str, bound_s) -> Optional[float]:
    """The least time of the mean launched shape over the kernel's mean
    device time in the trace, in %."""
    prof = _traced(rec)
    if prof is None:
        return None
    from .tracing import kernel_name

    ops = [v for k, v in prof["ops"].items() if kernel_name(k) == kernel]
    shape = _rows_per_launch(prof, rec.get("shapes"))
    if not ops or shape is None:
        return None
    op = {"s": sum(v["s"] for v in ops), "n": sum(v["n"] for v in ops)}
    p, n = shape
    return 100.0 * bound_s(p, n, rec) / (op["s"] / op["n"])


def select_bound_s(p: float, n: float, rec: dict) -> float:
    """Shortlist selection: the (P,N) scores read once, the (P,K)
    candidates and their scores and the (P,) bounds written once, over
    HBM; against one order-key compare per score over float32."""
    k = rec["config"]["scheduler"]["shortlist_k"]
    moved = 4 * p * n + 8 * p * k + 8 * p
    return max(moved / HBM_BYTES_PER_S, p * n / F32_OPS_PER_S)


def caps_bound_s(p: float, n: float, rec: dict) -> float:
    """Caps scan, for one DoNotSchedule group (H = 1, C = 1 slot) over
    the configuration's zones (K domains): scores, requests, slots,
    matches, domain rows and count tables read once, free in and out and
    the outputs written once, over HBM; against R fits, C domain
    verdicts and the score and noise order per pair over float32."""
    r, c, h = RESOURCE_AXES, 1, 1
    k = rec["config"]["cluster"]["zones"]
    moved = (4 * p * n + 4 * p * r + 8 * n * r + 8 * p * c + p * h
             + 4 * h * n + 5 * h * k + 5 * p)
    return max(moved / HBM_BYTES_PER_S, p * n * (r + c + 2) / F32_OPS_PER_S)


def nearest_rank(values, q: float) -> float:
    """The ``q`` quantile by nearest rank (infinite values sort last)."""
    v = np.sort(np.asarray(values, dtype=np.float64))
    return float(v[max(0, int(np.ceil(q * len(v))) - 1)])

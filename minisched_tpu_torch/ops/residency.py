"""Device-residency ops: sparse dynamic-leaf correction + slim readback.

  * ``apply_rows`` — the host→device half. The dynamic node-feature
    leaves (``free``, ``used_ports``) stay loop-carried on the device
    (engine/scheduler.py ``_DeviceResidency``); the host uploads only the
    rows where its cache diverged from the device's optimistic view
    (revoked placements, failed binds, informer churn) as a (rows,
    values) scatter instead of the full (N,R)/(N,PORT) matrices.
  * ``pack_decision_slim`` / ``unpack_decision_slim`` — the device→host
    half. The per-batch decision fetch packs its bool planes as bit
    planes (``np.packbits`` order, most significant bit first) and
    narrows the count planes to saturating i16 on the device: one u8
    buffer, byte for byte the JAX package's layout.
  * ``insert_ports`` — the batch's host-port insertions modelled on the
    resident ``used_ports``: the CUDA kernel csrc/insert_ports.cu for
    CUDA tensors, ``insert_ports_plain`` for CPU tensors, and
    ``replay_ports_host`` for the engine's host mirror, all with one
    first-zero-slot rule in pod order.

Order contract of the two carried planes (_DeviceResidency I1): the FREE
plane is tracked as an order-free per-node commutative debit aggregate;
the PORT plane runs the same integer first-zero-slot writes in pod order
on both sides.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..encode.cache import bucket_for

# Counts are narrowed to i16 with saturation: the engine only tests them
# for positivity / zero, so clipping a 50k-node count loses nothing.
I16_SAT = 32767


def _upload(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def apply_rows(state: torch.Tensor, rows: np.ndarray, values: np.ndarray,
               *, donate: bool = False) -> torch.Tensor:
    """Scatter host-truth ``values`` into device-resident ``state`` at
    ``rows`` (both host arrays). The upload is padded to a power-of-two
    bucket as in the JAX package (whose jitted scatter compiles once per
    bucket), and the transfer ledger books that padded size
    (``apply_rows_bytes``). The JAX package drops the pad rows with an
    out-of-range sentinel (``mode="drop"``); PyTorch has no drop mode,
    and a clipped sentinel would land on row N-1, so only the first
    ``len(rows)`` uploaded rows are scattered. Returns the new device
    array; with ``donate`` the input is updated in place and returned."""
    n = int(rows.shape[0])
    k = bucket_for(max(n, 1), 16)
    rows_pad = np.full((k,), state.shape[0], dtype=np.int32)
    rows_pad[:n] = rows
    vals_pad = np.zeros((k,) + values.shape[1:], dtype=values.dtype)
    vals_pad[:n] = values
    rows_dev = _upload(rows_pad, state.device)[:n].long()
    vals_dev = _upload(vals_pad, state.device)[:n]
    out = state if donate else state.clone()
    out.index_copy_(0, rows_dev, vals_dev)
    return out


def apply_rows_bytes(n: int, values: np.ndarray) -> int:
    """Host→device bytes an ``apply_rows`` correction of ``n`` rows
    uploads: the (rows, values) pair padded to the power-of-two bucket,
    with i32 row indices."""
    k = bucket_for(max(n, 1), 16)
    row_bytes = values.dtype.itemsize
    for d in values.shape[1:]:
        row_bytes *= d
    return k * (np.dtype(np.int32).itemsize + row_bytes)


def _bytes_of(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.uint8).reshape(-1)


def _i16(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, max=I16_SAT).to(torch.int16)


def _packbits(x: torch.Tensor) -> torch.Tensor:
    """np.packbits of a (P,) bool tensor: ceil(P/8) bytes, the first pod
    in the most significant bit, zero bits after the last pod. The bit
    weights are made on the device (128 >> j): a copy from the host
    would make the pack wait for the card."""
    p = x.shape[0]
    bits = torch.zeros(((p + 7) // 8) * 8, dtype=torch.int32,
                       device=x.device)
    bits[:p] = x.to(torch.int32)
    w = torch.bitwise_right_shift(
        torch.full((8,), 128, dtype=torch.int32, device=x.device),
        torch.arange(8, dtype=torch.int32, device=x.device))
    return (bits.view(-1, 8) * w).sum(dim=1).to(torch.uint8)


def pack_decision_slim(chosen, assigned, gang_rejected, feasible,
                       feasible_static, rejects, repaired) -> torch.Tensor:
    """Fuse the per-pod step outputs into ONE (B,) uint8 buffer:

        [chosen i32 × P] [assigned bits P/8] [gang_rejected bits P/8]
        [repaired bits P/8] [feasible i16 × P] [feasible_static i16 × P]
        [rejects i16 × F·P]

    ``chosen`` keeps i32; the count planes saturate at I16_SAT; each
    bool plane takes ceil(P/8) bytes. Little-endian, as the JAX
    package's bitcast on the same hosts, so the bytes are equal."""
    return torch.cat([
        _bytes_of(chosen.to(torch.int32)),
        _packbits(assigned),
        _packbits(gang_rejected),
        _packbits(repaired),
        _bytes_of(_i16(feasible)),
        _bytes_of(_i16(feasible_static)),
        _bytes_of(_i16(rejects)),
    ])


def pack_decision_i32(chosen, assigned, gang_rejected, feasible,
                      feasible_static, rejects, repaired) -> torch.Tensor:
    """The all-i32 fused decision pack as a (6+F, P) array (row order:
    chosen, assigned, gang_rejected, feasible, feasible_static,
    repaired, rejects…): the readback layout without device residency."""
    head = torch.stack([chosen.to(torch.int32), assigned.to(torch.int32),
                        gang_rejected.to(torch.int32),
                        feasible.to(torch.int32),
                        feasible_static.to(torch.int32),
                        repaired.to(torch.int32)])
    return torch.cat([head, rejects.to(torch.int32)], dim=0)


def unpack_decision_i32(buf: np.ndarray):
    """Host-side inverse of pack_decision_i32 over a writable fetched
    (6+F, P) i32 array → the same 7-tuple unpack_decision_slim returns."""
    return (buf[0], buf[1].astype(bool), buf[2].astype(bool),
            buf[3], buf[4], buf[6:], buf[5].astype(bool))


def slim_buffer_bytes(p: int, f: int) -> int:
    """Host-side size model of pack_decision_slim's buffer (bytes)."""
    return 4 * p + 3 * ((p + 7) // 8) + 2 * p + 2 * p + 2 * f * p


def unpack_decision_slim(buf: np.ndarray, p: int, f: int) -> Tuple:
    """Host-side inverse of pack_decision_slim over the fetched buffer
    (a WRITABLE np.uint8 copy). Counts widen back to i32. Returns
    (chosen, assigned, gang_rejected, feasible, feasible_static,
    rejects, repaired)."""
    nb = (p + 7) // 8
    o = 0
    chosen = buf[o:o + 4 * p].view(np.int32)
    o += 4 * p
    assigned = np.unpackbits(buf[o:o + nb])[:p].astype(bool)
    o += nb
    gang_rejected = np.unpackbits(buf[o:o + nb])[:p].astype(bool)
    o += nb
    repaired = np.unpackbits(buf[o:o + nb])[:p].astype(bool)
    o += nb
    feasible = buf[o:o + 2 * p].view(np.int16).astype(np.int32)
    o += 2 * p
    feasible_static = buf[o:o + 2 * p].view(np.int16).astype(np.int32)
    o += 2 * p
    rejects = (buf[o:o + 2 * f * p].view(np.int16)
               .reshape(f, p).astype(np.int32))
    return (chosen, assigned, gang_rejected, feasible, feasible_static,
            rejects, repaired)


def insert_ports_plain(state: torch.Tensor, rows: torch.Tensor,
                       ports: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of the port-insertion kernel: for each
    pod in row order with ``rows[i] >= 0``, each nonzero port of
    ``ports[i]`` in slot order lands in the first zero slot of that node's
    row (dropped when none is free). Returns the new state."""
    out = state.clone()
    for r, pp in zip(rows.tolist(), ports.tolist()):
        if r < 0:
            continue
        row = out[r]
        for p in pp:
            if not p:
                continue
            z = torch.nonzero(row == 0)
            if z.numel():
                row[int(z[0, 0])] = p
    return out


def insert_ports(state: torch.Tensor, rows: np.ndarray,
                 ports: np.ndarray) -> torch.Tensor:
    """Model the batch's host-port insertions on the device-resident
    ``used_ports``, so a port-heavy steady state stays upload-free.
    ``rows``/``ports`` are host arrays (chosen rows with -1 for pods that
    insert nothing, and the encoder's (P,PP) port matrix); the upload
    costs ``insert_ports_bytes``. CPU tensors take the plain version,
    CUDA tensors the kernel."""
    rows_dev = _upload(rows.astype(np.int32), state.device)
    ports_dev = _upload(ports.astype(np.int32), state.device)
    if state.device.type == "cpu":
        return insert_ports_plain(state, rows_dev, ports_dev)
    from .ports_kernel import insert_ports_cuda

    return insert_ports_cuda(state, rows_dev, ports_dev)


def insert_ports_bytes(p: int, pp: int) -> int:
    """Host→device bytes one insert_ports call uploads (rows + ports)."""
    return p * 4 + p * pp * 4


def replay_ports_host(mirror: np.ndarray, rows: np.ndarray,
                      ports: np.ndarray) -> None:
    """Host replay of insert_ports into the residency mirror, in the
    identical order (pod row ascending, port slots left to right) with
    the identical first-zero-slot rule — integer writes, so mirror and
    device agree bitwise. Mutates ``mirror`` in place."""
    for r, pp in zip(rows.tolist(), ports.tolist()):
        if r < 0:
            continue
        row = mirror[r]
        for p in pp:
            if not p:
                continue
            z = np.flatnonzero(row == 0)
            if z.size:
                row[z[0]] = p

"""Deterministic pod→shard partitioning — the fleet's ownership
contract.

``shard_of`` is a pure function of the pod KEY (namespace/name) and the
shard count: crc32 mod N. Every replica, the takeover sweep, the
invariant oracle, and the tests compute ownership independently and MUST
agree, so the function is deliberately dependency-free and stable across
processes/runs (no PYTHONHASHSEED exposure — ``hash()`` would silently
re-partition every restart). Shards are decoupled from replicas: the
shard count is fixed for a run (``MINISCHED_SHARDS``, default = replica
count) while leases move shards between replicas.
"""
from __future__ import annotations

import os
import zlib

#: Env knobs (documented in README): fleet replica count consumed by the
#: service wiring, shard count, and the lease TTL consumed by
#: fleet/lease.py.
FLEET_ENV = "MINISCHED_FLEET"
SHARDS_ENV = "MINISCHED_SHARDS"
LEASE_TTL_ENV = "MINISCHED_LEASE_TTL"
#: Out-of-process fleet (fleet/procfleet.py): N replica PROCESSES over
#: RemoteStore instead of N in-process engine threads.
FLEET_PROC_ENV = "MINISCHED_FLEET_PROC"
#: Elastic shard handoff spec (the process fleet's ShardRebalancer).
REBALANCE_ENV = "MINISCHED_REBALANCE"
#: Self-governing fleet (fleet/election.py): replicas
#: CAS-compete for an epoch-fenced steward lease instead of being
#: parented by a supervisor process — the steward runs
#: census/respawn/rebalance.
FLEET_ELECT_ENV = "MINISCHED_FLEET_ELECT"


def shard_of(pod_key: str, n_shards: int) -> int:
    """The ownership function: crc32(key) mod shards. Stable across
    processes, restarts, and replicas by construction."""
    return zlib.crc32(pod_key.encode("utf-8")) % n_shards


def lease_name(shard: int) -> str:
    """The store key of a shard's Lease object (cluster-scoped)."""
    return f"shard-{shard}"


def shards_from_env(default: int) -> int:
    try:
        n = int(os.environ.get(SHARDS_ENV, "") or default)
    except ValueError:
        n = default
    return max(1, n)


def fleet_from_env(default: int = 0) -> int:
    try:
        return int(os.environ.get(FLEET_ENV, "") or default)
    except ValueError:
        return default


def lease_ttl_from_env(default: float = 2.0) -> float:
    try:
        t = float(os.environ.get(LEASE_TTL_ENV, "") or default)
    except ValueError:
        t = default
    return max(0.05, t)


def fleet_proc_from_env(default: int = 0) -> int:
    try:
        return int(os.environ.get(FLEET_PROC_ENV, "") or default)
    except ValueError:
        return default


def status_name(replica: str) -> str:
    """The store key of a replica's ReplicaStatus heartbeat object."""
    return f"replica-{replica}"


def move_name(shard: int) -> str:
    """The store key of a shard's elastic-handoff directive (at most one
    in-flight move per shard by construction — the name IS the lock)."""
    return f"move-{shard}"


def fleet_elect_from_env(default: int = 0) -> int:
    try:
        return int(os.environ.get(FLEET_ELECT_ENV, "") or default)
    except ValueError:
        return default


def steward_name() -> str:
    """The store key of THE steward Lease (cluster-scoped, singular by
    construction — the name IS the uniqueness guarantee; ownership moves
    only through the same resource-version CAS as shard leases)."""
    return "steward"


def incarnation_name(replica: str) -> str:
    """The store key of a replica's Incarnation ledger record (the
    steward's store-visible census: expected incarnation, death/respawn
    tallies, exit codes)."""
    return f"incarnation-{replica}"

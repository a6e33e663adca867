"""Replicated scheduler fleet: shard-owned failover in one process.

The Omega/Borg shape (Schwarzkopf et al., EuroSys 2013; Verma et al.,
EuroSys 2015): N engine replicas against ONE shared store, pod ownership
partitioned by a deterministic shard map, every bind still a
compare-and-swap against store truth (no coordination on the hot path),
and lease-based failover so a peer claims a dead replica's shards with
an epoch bump and drains its pending pods.

``supervisor.FleetSupervisor`` runs the replicas as threads of one
process over the one store object, each engine on the device its
``SchedulerConfig.platform`` names (``cuda:0`` by default). The JAX
package's process fleet and steward election (replicas as OS processes
over ``RemoteStore``) are not part of this package yet.

Import the pieces directly (``fleet.shardmap`` is dependency-free so the
engine's ``wants_pod`` hot path can use it without an import cycle):

    from minisched_tpu_torch.fleet.shardmap import shard_of, lease_name
    from minisched_tpu_torch.fleet.lease import LeaseManager
    from minisched_tpu_torch.fleet.supervisor import FleetSupervisor
"""

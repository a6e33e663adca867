"""Replicated scheduler fleet: shard-owned failover, in one process or
as replica processes.

The Omega/Borg shape (Schwarzkopf et al., EuroSys 2013; Verma et al.,
EuroSys 2015): N engine replicas against ONE shared store, pod ownership
partitioned by a deterministic shard map, every bind still a
compare-and-swap against store truth (no coordination on the hot path),
and lease-based failover so a peer claims a dead replica's shards with
an epoch bump and drains its pending pods.

Two supervisors share the duck type (``start/kill/restart/shutdown/
census/metrics``): ``supervisor.FleetSupervisor`` runs the replicas as
threads of one process over the one store object, while
``procfleet.ProcFleetSupervisor`` runs each replica as its own OS
process over ``RemoteStore``, with its own interpreter and CUDA context
(SIGKILL fault injection, an exit-code census, elastic shard handoff by
``ShardMove`` directives, warm takeover after a pre-warm pass).
``election`` lets such replicas govern themselves: they elect a steward
that runs the census, the respawns and the rebalancing, with no parent.
Every engine runs on the device its ``SchedulerConfig.platform`` names
(``cuda:0`` by default).

Import the pieces directly (``fleet.shardmap`` is dependency-free so the
engine's ``wants_pod`` hot path can use it without an import cycle):

    from minisched_tpu_torch.fleet.shardmap import shard_of, lease_name
    from minisched_tpu_torch.fleet.lease import LeaseManager
    from minisched_tpu_torch.fleet.supervisor import FleetSupervisor
    from minisched_tpu_torch.fleet.procfleet import ProcFleetSupervisor
    from minisched_tpu_torch.fleet.election import ElectFleet
"""

"""NodeVolumeLimits filter.

Batched counterpart of the upstream volume-count limit plugins the
reference wraps (reference scheduler/plugin/plugins.go:24-70 registry:
NodeVolumeLimits plus the per-cloud EBS/GCEPD/AzureDisk variants — one
dense column here): a node can attach only so many volumes; a pod whose
claims would exceed the remaining headroom is filtered out.

Attachable volumes are a RESOURCE AXIS (state/objects.RESOURCES): nodes get
``allocatable["attachable-volumes"]`` (default
objects.DEFAULT_ATTACHABLE_VOLUMES when undeclared), pods implicitly
request one slot per PVC (objects.pod_requests), and the node cache's free
matrix tracks headroom incrementally. That design means the capacity-aware
greedy assignment also respects attach limits WITHIN a batch; this plugin
contributes the named filter column so rejections are attributed to
NodeVolumeLimits for requeue gating.

The resource axis is indexed with a Python int: a list index would copy
the index to the card and make the step wait on the host.
"""
from __future__ import annotations

import torch

from ..state.events import ActionType, ClusterEvent, GVK
from ..state.objects import RESOURCE_INDEX
from .base import BatchedPlugin

_VOL = RESOURCE_INDEX["attachable-volumes"]


class NodeVolumeLimits(BatchedPlugin):
    name = "NodeVolumeLimits"
    # NOT column-local: the pinned-claim surcharge compares against the
    # node AXIS POSITION (arange over N) — see VolumeRestrictions.
    column_local = False

    def events_to_register(self):
        # Freed attachments (pod delete) or raised limits (node update).
        return [ClusterEvent(GVK.POD, ActionType.DELETE),
                ClusterEvent(GVK.NODE,
                             ActionType.ADD | ActionType.UPDATE_NODE_ALLOCATABLE)]

    def filter(self, pf, nf, ctx) -> torch.Tensor:
        # Node-accurate demand: the static request charges unpinned/multi
        # claims; a PINNED claim (mounted on exactly one node) costs an
        # extra slot on every node EXCEPT its mount node. Without this,
        # a profile running NodeVolumeLimits alone could place the pod on
        # a full node the claim isn't mounted on.
        N = nf.valid.shape[0]
        need = pf.requests[:, _VOL][:, None].expand(pf.valid.shape[0], N)
        node_idx = torch.arange(N, dtype=torch.int32,
                                device=pf.valid.device)[None, :]
        for c in range(pf.claim_rows.shape[1]):
            row = pf.claim_rows[:, c:c + 1]                  # (P,1)
            untyped = ~pf.claim_typed[:, c:c + 1]            # (P,1)
            # Cloud-typed claims live on their per-cloud axes (charged per
            # pod by pod_requests) — they never consume generic slots.
            need = need + (untyped & (row >= 0) & (row != node_idx))
        return need <= nf.free[:, _VOL][None, :]


class CloudVolumeLimits(BatchedPlugin):
    """Per-cloud attach-limit filter (upstream EBSLimits / GCEPDLimits /
    AzureDiskLimits, wrapped by the reference registry at
    scheduler/plugin/plugins.go:24-70). Pod volumes typed with the matching
    VolumeClaim.volume_type charge the cloud's resource axis
    (objects.CLOUD_VOLUME_AXES); nodes default to upstream's per-driver
    ceilings (objects.DEFAULT_CLOUD_VOLUME_LIMITS) unless allocatable
    declares the axis. Because the axis rides the requests/free matrices,
    the greedy assignment respects it in-batch; this column attributes
    rejections to the named plugin. Typed claims are charged per pod (not
    per-claim-per-node like the generic axis) — two pods sharing one typed
    claim on a node consume two slots, a documented simplification."""

    column_local = True  # per-column axis compare only

    def __init__(self):
        self._axis = RESOURCE_INDEX[self.axis_name]

    axis_name = ""  # subclass binds

    def events_to_register(self):
        return [ClusterEvent(GVK.POD, ActionType.DELETE),
                ClusterEvent(GVK.NODE,
                             ActionType.ADD | ActionType.UPDATE_NODE_ALLOCATABLE)]

    def filter(self, pf, nf, ctx) -> torch.Tensor:
        return (pf.requests[:, self._axis][:, None]
                <= nf.free[:, self._axis][None, :])


class EBSLimits(CloudVolumeLimits):
    name = "EBSLimits"
    axis_name = "attachable-volumes-aws-ebs"


class GCEPDLimits(CloudVolumeLimits):
    name = "GCEPDLimits"
    axis_name = "attachable-volumes-gce-pd"


class AzureDiskLimits(CloudVolumeLimits):
    name = "AzureDiskLimits"
    axis_name = "attachable-volumes-azure-disk"


class CinderLimits(CloudVolumeLimits):
    """OpenStack Cinder attach limits — the last per-cloud variant the
    reference registry wraps (scheduler/plugin/plugins.go:24-70; upstream
    registers it but, like the other in-tree cloud filters, it only
    gates clusters whose pods carry cinder-typed volumes). Default
    ceiling is upstream's DefaultMaxCinderVolumes=256
    (objects.DEFAULT_CLOUD_VOLUME_LIMITS)."""

    name = "CinderLimits"
    axis_name = "attachable-volumes-cinder"

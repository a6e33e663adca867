from .base import BatchedPlugin, PluginSet  # noqa: F401
from .nodeunschedulable import NodeUnschedulable  # noqa: F401
from .nodenumber import NodeNumber  # noqa: F401
from .nodeports import NodePorts  # noqa: F401
from .noderesources import (  # noqa: F401
    NodeResourcesBalancedAllocation,
    NodeResourcesFit,
    NodeResourcesLeastAllocated,
    NodeResourcesMostAllocated,
)
from .imagelocality import ImageLocality  # noqa: F401
from .interpodaffinity import InterPodAffinity  # noqa: F401
from .nodeaffinity import NodeAffinity  # noqa: F401
from .nodename import NodeName  # noqa: F401
from .nodepreferavoidpods import NodePreferAvoidPods  # noqa: F401
from .nodevolumelimits import (  # noqa: F401
    AzureDiskLimits,
    CinderLimits,
    EBSLimits,
    GCEPDLimits,
    NodeVolumeLimits,
)
from .podtopologyspread import PodTopologySpread  # noqa: F401
from .preemption import DefaultPreemption  # noqa: F401
from .selectorspread import SelectorSpread  # noqa: F401
from .tainttoleration import TaintToleration  # noqa: F401
from .volumebinding import VolumeBinding  # noqa: F401
from .volumerestrictions import VolumeRestrictions  # noqa: F401
from .volumezone import VolumeZone  # noqa: F401

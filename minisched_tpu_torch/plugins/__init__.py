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

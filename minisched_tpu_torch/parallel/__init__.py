"""The mesh: the scheduling step over a ("pod", "node") grid of devices
(``SchedulerConfig.mesh``), and its multi-process dryrun."""
from .mesh import make_hybrid_mesh, make_mesh, shard_features  # noqa: F401
from .sharded import build_sharded_step  # noqa: F401

"""Cluster-lifecycle scenario engine: seed-deterministic, composable
workload-dynamics generators with an always-on invariant oracle.

See ``driver.py`` for the event-loop contract, ``generators.py`` for the
catalog (autoscaler loops, reclamation waves, rolling upgrades, diurnal
arrivals, tenant mixes), ``invariants.py`` for the checks every soak
enforces. The same engine as the JAX package's ``lifecycle/``: in pure
mode one seed gives the same event stream and state digest in both.
"""
from .driver import (AMPLITUDE_ENV, RATE_ENV, SEED_ENV, DisruptionBudget,
                     InvariantViolation, LifecycleDriver, LifecycleEvent,
                     LifecycleView, seed_from_env)
from .generators import (AutoscalerLoop, Generator, KillScheduler,
                         KillSteward, PoissonArrivals, ReclamationWave,
                         RestartApiserver, RestartScheduler,
                         RollingUpgrade, TenantMix)
from .invariants import (LeaseIntegrity, MonotoneVersions, StableBindings,
                         StewardUniqueness, bound_on_live_nodes,
                         budget_respected, default_invariants,
                         no_overcommit, no_pod_lost)

__all__ = [
    "AMPLITUDE_ENV", "RATE_ENV", "SEED_ENV",
    "AutoscalerLoop", "DisruptionBudget", "Generator",
    "InvariantViolation", "KillScheduler", "KillSteward",
    "LeaseIntegrity", "LifecycleDriver", "LifecycleEvent",
    "LifecycleView", "MonotoneVersions", "PoissonArrivals",
    "ReclamationWave", "RestartApiserver", "RestartScheduler",
    "RollingUpgrade", "StableBindings", "StewardUniqueness", "TenantMix",
    "bound_on_live_nodes", "budget_respected", "default_invariants",
    "no_overcommit", "no_pod_lost", "seed_from_env",
]

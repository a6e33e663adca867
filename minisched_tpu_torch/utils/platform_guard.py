"""Make a CPU request mean CPU only: an entry point asked for the CPU
never initializes CUDA.

The JAX package's guard strips accelerator backend factories when
``JAX_PLATFORMS=cpu``. Here the device comes from
``SchedulerConfig.platform`` alone, and a CPU run never needs a card; but
on a machine with one, any stray CUDA call (a ``.cuda()``, a
``torch.cuda`` query that creates a context) would give a CPU process a
CUDA context on the card, which costs device memory and outlives nothing
useful. So a CPU-only entry point (a replica process spawned with
``platform="cpu"``, the demo's ``--platform cpu``) hides every CUDA
device from its process before anything touches CUDA, and a spawner
hides them from a CPU child's environment before the child starts.

A CUDA request is never turned into a CPU run: for any platform other
than the CPU these functions change nothing, and the entry point runs
on the device its config names (or raises without one).
"""
from __future__ import annotations

import os
import sys
from typing import Dict

#: The variable the CUDA runtime reads at initialization: empty hides
#: every device from the process.
HIDE_ENV = "CUDA_VISIBLE_DEVICES"


def wants_cpu(platform: str) -> bool:
    """Does ``platform`` (a ``SchedulerConfig.platform``) name the CPU?
    ``""`` means ``cuda:0``."""
    return (platform or "").strip().lower().split(":")[0] == "cpu"


def guard_env(env: Dict[str, str], platform: str) -> Dict[str, str]:
    """A child environment for an entry point on ``platform``: with the
    CUDA devices hidden when it names the CPU, untouched otherwise."""
    if wants_cpu(platform):
        env[HIDE_ENV] = ""
    return env


def cuda_initialized() -> bool:
    """Has this process initialized CUDA? False when torch was never
    imported."""
    torch = sys.modules.get("torch")
    return bool(torch is not None and torch.cuda.is_initialized())


def enforce_cpu_only(platform: str) -> bool:
    """Hide every CUDA device from this process when ``platform`` names
    the CPU. Call it before the first CUDA call of the process (the
    runtime reads the variable once, at initialization). Returns True
    when the guard holds: the platform names the CPU and CUDA was not
    initialized yet. A non-CPU platform returns False and changes
    nothing."""
    if not wants_cpu(platform):
        return False
    os.environ[HIDE_ENV] = ""
    return not cuda_initialized()

"""minisched_tpu_torch — the scheduler of ``minisched_tpu`` on PyTorch and CUDA.

The same system as the JAX package beside it (a simulated cluster store
with watch streams, a scheduling queue with event-driven requeue and
backoff, a plugin framework, permit waits, asynchronous binding and a
scenario runner), with the batched scheduling step written in PyTorch
and its greedy assignment as a hand-written CUDA kernel for Hopper
(``csrc/greedy_assign.cu``). Entry points run on the first CUDA device
unless the configuration names another (``SchedulerConfig.platform``);
with no card they raise rather than run on the CPU.

Explain mode (``SchedulerConfig(explain=True)``) publishes each pod's
per-node, per-plugin filter verdicts and raw and final scores as pod
annotations through the service's result store (``explain/``), and
answers ``filter_verdict`` for any node. The store's structural clone
runs in a CPython C extension built on first use (``native/``;
``MINISCHED_NO_NATIVE=1`` selects the Python walk).
"""

__version__ = "0.1.0"

"""The PyTorch port stands alone: no jax, nothing of minisched_tpu.

Its entry points run on the card unless asked for the CPU, and the
kernel wrapper refuses CPU tensors instead of quietly running the plain
version.
"""
import ast
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import minisched_tpu_torch
from minisched_tpu_torch.config import SchedulerConfig
from minisched_tpu_torch.ops.greedy_kernel import greedy_assign_cuda
from minisched_tpu_torch.ops.select_kernel import shortlist_select_lanes_cuda
from minisched_tpu_torch.ops.shortlist_kernel import shortlist_scan_lanes_cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_DIR = os.path.join(ROOT, "minisched_tpu_torch")
PORT_FILES = sorted(
    os.path.relpath(os.path.join(d, f), ROOT)
    for d, _dirs, files in os.walk(PORT_DIR)
    for f in files if f.endswith(".py")) + ["chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "minisched_tpu")


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        minisched_tpu_torch.__path__, "minisched_tpu_torch."))


def _imported_roots(path):
    tree = ast.parse(open(os.path.join(ROOT, path)).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES)
def test_no_jax_or_reference_import(path):
    """No import of jax or of the module minisched_tpu / minisched_tpu.*
    (minisched_tpu_torch shares the prefix and is allowed)."""
    for name in _imported_roots(path):
        root = name.split(".")[0]
        assert root not in FORBIDDEN, f"{path} imports {name}"


def test_whole_port_imports_with_jax_blocked():
    mods = _port_modules()
    assert {"minisched_tpu_torch.engine.scheduler",
            "minisched_tpu_torch.faults", "minisched_tpu_torch.obs",
            "minisched_tpu_torch.obs.journal",
            "minisched_tpu_torch.ops.auction",
            "minisched_tpu_torch.ops.bid_select",
            "minisched_tpu_torch.ops.auction_kernel",
            "minisched_tpu_torch.explain",
            "minisched_tpu_torch.explain.annotation",
            "minisched_tpu_torch.explain.resultstore",
            "minisched_tpu_torch.native",
            "minisched_tpu_torch.utils",
            "minisched_tpu_torch.utils.retry",
            "minisched_tpu_torch.utils.breaker",
            "minisched_tpu_torch.scenario.demo",
            "minisched_tpu_torch.scenario.remote",
            "minisched_tpu_torch.apiserver",
            "minisched_tpu_torch.apiserver.server",
            "minisched_tpu_torch.apiserver.client",
            "minisched_tpu_torch.state.persistence",
            "minisched_tpu_torch.state.serde",
            "minisched_tpu_torch.service.config",
            "minisched_tpu_torch.fleet",
            "minisched_tpu_torch.fleet.shardmap",
            "minisched_tpu_torch.fleet.lease",
            "minisched_tpu_torch.fleet.supervisor",
            "minisched_tpu_torch.lifecycle",
            "minisched_tpu_torch.lifecycle.driver",
            "minisched_tpu_torch.lifecycle.generators",
            "minisched_tpu_torch.lifecycle.invariants"} <= set(mods)
    for path in ("minisched_tpu_torch/explain/resultstore.py",
                 "minisched_tpu_torch/native/__init__.py",
                 "minisched_tpu_torch/utils/retry.py",
                 "minisched_tpu_torch/utils/breaker.py",
                 "minisched_tpu_torch/scenario/demo.py",
                 "minisched_tpu_torch/scenario/remote.py",
                 "minisched_tpu_torch/apiserver/server.py",
                 "minisched_tpu_torch/apiserver/client.py",
                 "minisched_tpu_torch/state/persistence.py",
                 "minisched_tpu_torch/state/serde.py",
                 "minisched_tpu_torch/service/config.py",
                 "minisched_tpu_torch/fleet/shardmap.py",
                 "minisched_tpu_torch/fleet/lease.py",
                 "minisched_tpu_torch/fleet/supervisor.py",
                 "minisched_tpu_torch/lifecycle/driver.py",
                 "minisched_tpu_torch/lifecycle/generators.py",
                 "minisched_tpu_torch/lifecycle/invariants.py"):
        assert path in PORT_FILES
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'minisched_tpu'):\n"
            "    sys.modules[m] = None\n"
            "import importlib\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "from minisched_tpu_torch.service.service import (\n"
            "    Tenant, TenantFusionCoordinator, tenants_fuse_from_env)\n"
            "from minisched_tpu_torch.encode.cache import TenantCacheMux\n"
            "from minisched_tpu_torch.ops.pipeline import (\n"
            "    build_tenant_step, build_tenant_index_step)\n"
            "from minisched_tpu_torch.ops.select import (\n"
            "    greedy_assign_shortlist_lanes)\n"
            "from minisched_tpu_torch.fleet.supervisor import (\n"
            "    FleetSupervisor)\n"
            "from minisched_tpu_torch.lifecycle import (\n"
            "    LifecycleDriver, default_invariants)\n"
            "import chip_smoke\n"
            "assert not any(k == 'jax' or k.startswith('jax.')\n"
            "               for k, v in sys.modules.items() if v)\n"
            "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_default_platform_is_the_card():
    """platform="" means cuda:0 and never falls back to the CPU."""
    if torch.cuda.is_available():
        assert SchedulerConfig().device() == torch.device("cuda:0")
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            SchedulerConfig().device()
    assert SchedulerConfig(platform="cpu").device() == torch.device("cpu")


def test_kernel_wrapper_refuses_cpu_tensors():
    scores = torch.zeros((2, 3))
    with pytest.raises(ValueError, match="CUDA"):
        greedy_assign_cuda(scores, torch.zeros((2, 4)), torch.zeros((3, 4)),
                           0)


def test_lane_kernel_wrappers_refuse_cpu_tensors():
    """The tenant-lane forms of the selection and scan kernels launch or
    raise: CPU tensors are refused, never run through the plain
    versions."""
    T, P, N, K, R = 2, 3, 5, 2, 2
    seeds = torch.zeros((T,), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        shortlist_select_lanes_cuda(torch.zeros((T, P, N)), seeds, K)
    with pytest.raises(ValueError, match="CUDA"):
        shortlist_scan_lanes_cuda(
            torch.zeros((T, P, N)), torch.zeros((T, P, K), dtype=torch.int32),
            torch.zeros((T, P)), torch.zeros((T, P)), torch.zeros((T, P, R)),
            torch.zeros((T, N, R)), seeds)

"""The port's config layer and multi-profile service against the JAX
package's.

Mirrors tests/test_service_config.py (profiles and the registry, the
service's lifecycle, ``config_from_env``) and tests/test_multiprofile.py
(the reference's eight conversion cases, the Raw/Object args contract,
two profiles routed by ``spec.scheduler_name`` over one shared cache,
the flat metrics scrape), with ``MINISCHED_MESH_DEVICES`` building the
port's mesh (the mesh engine itself: tests/test_torch_parallel.py).
Each check feeds both packages the same
profiles, environment and store content: converted profiles, config
fields and placements must be equal.
"""
import dataclasses
import os
import time

import pytest
import torch

from minisched_tpu import config as jconfig
from minisched_tpu.service import config as jsc
from minisched_tpu.service import defaultconfig as jdc
from minisched_tpu.service.service import SchedulerService as JService
from minisched_tpu.state import objects as JO
from minisched_tpu.state.store import ClusterStore as JStore
from minisched_tpu_torch import config as tconfig
from minisched_tpu_torch.config import (EmptyEnvError, SchedulerConfig,
                                        config_from_env)
from minisched_tpu_torch.scenario.runner import Cluster, wait_until
from minisched_tpu_torch.service import config as tsc
from minisched_tpu_torch.service import defaultconfig as tdc
from minisched_tpu_torch.service.config import (DEFAULT_PLUGIN_ARGS,
                                                PluginArgs,
                                                SchedulerConfiguration,
                                                convert_configuration_for_simulator,
                                                new_plugin_config,
                                                resolve_args)
from minisched_tpu_torch.service.defaultconfig import (
    DEFAULT_FILTER_PLUGINS, DEFAULT_SCORE_PLUGINS, Profile,
    default_scheduler_profile, full_scheduler_profile, make_plugin,
    registered_plugins)
from minisched_tpu_torch.service.service import SchedulerService
from minisched_tpu_torch.state import objects as TO
from minisched_tpu_torch.state.store import ClusterStore
from torch_obs_parity import LATER_SLICE_KEYS
from torch_parity import bench_cluster

DEFAULT_FILTERS = list(DEFAULT_FILTER_PLUGINS)
DEFAULT_SCORES = [n for n, _ in DEFAULT_SCORE_PLUGINS]
CPU = dict(platform="cpu")
FAST = dict(backoff_initial_s=0.05, backoff_max_s=0.2)


def _built_names(profile):
    ps = profile.build()
    return ([p.name for p in ps.filter_plugins],
            [p.name for p in ps.score_plugins])


# ---- profiles / registry (reference plugins.go:24-70) -------------------


def test_default_profile_matches_reference_live_set():
    ps = default_scheduler_profile().build()
    assert [p.name for p in ps.filter_plugins] == ["NodeUnschedulable"]
    assert [p.name for p in ps.score_plugins] == ["NodeNumber"]
    assert [p.name for p in ps.permit_plugins] == ["NodeNumber"]
    assert _built_names(default_scheduler_profile()) == _built_names(
        jdc.default_scheduler_profile())


def test_full_profile_matches_reference_default_lists():
    ps = full_scheduler_profile().build()
    assert [p.name for p in ps.filter_plugins] == [
        "NodeUnschedulable", "NodeName", "TaintToleration", "NodeAffinity",
        "NodePorts", "NodeResourcesFit", "VolumeRestrictions", "EBSLimits",
        "GCEPDLimits", "NodeVolumeLimits", "AzureDiskLimits",
        "VolumeBinding", "VolumeZone", "PodTopologySpread",
        "InterPodAffinity"]
    spread = next(p for p in ps.score_plugins
                  if p.name == "PodTopologySpread")
    assert ps.weight_of(spread) == 2.0
    jps = jdc.full_scheduler_profile().build()
    assert _built_names(full_scheduler_profile()) == _built_names(
        jdc.full_scheduler_profile())
    assert ([ps.weight_of(p) for p in ps.score_plugins]
            == [jps.weight_of(p) for p in jps.score_plugins])


def test_registry_lists_and_rejects_unknown():
    assert registered_plugins() == jdc.registered_plugins()
    with pytest.raises(KeyError) as ei:
        make_plugin("NoSuchPlugin")
    assert "registered" in str(ei.value)


def test_profile_disable_removes_plugin():
    kw = dict(plugins=["NodeUnschedulable", "NodeNumber"],
              disabled=["NodeNumber"])
    ps = Profile(**kw).build()
    assert ps.names() == ["NodeUnschedulable"] == jdc.Profile(
        **kw).build().names()
    assert ps.score_plugins == []


def test_profile_weights_and_args_merge():
    """User weights and args reach the factory, in every args encoding
    the JAX package takes (a dict, a JSON string, PluginArgs)."""
    for args in ({"permit_delay": False}, '{"permit_delay": false}',
                 PluginArgs(object={"permit_delay": False})):
        ps = Profile(plugins=["NodeUnschedulable", "NodeNumber"],
                     weights={"NodeNumber": 5.0},
                     plugin_args={"NodeNumber": args}).build()
        nn = ps.score_plugins[0]
        assert ps.weight_of(nn) == 5.0
        assert nn.permit(None, "node3") == ("allow", 0.0, 0.0)


def test_profile_default_weight_used_when_unspecified():
    ps = Profile(plugins=["NodeNumber"]).build()
    nn = ps.score_plugins[0]
    assert ps.weight_of(nn) == nn.default_weight


# ---- service lifecycle (reference scheduler/scheduler.go:36-91) ---------


def test_service_start_shutdown_restart():
    svc = SchedulerService(ClusterStore())
    cfg = SchedulerConfig(**CPU, **FAST)
    prof = Profile(plugins=["NodeUnschedulable"])
    sched = svc.start_scheduler(prof, cfg)
    assert svc.scheduler is sched
    with pytest.raises(RuntimeError):
        svc.start_scheduler(prof, cfg)  # double start refused
    sched2 = svc.restart_scheduler()
    assert sched2 is not sched
    assert svc.get_scheduler_profile() is prof
    assert svc.get_scheduler_profiles() == [prof]
    assert sched2.config is cfg
    svc.shutdown_scheduler()
    assert svc.scheduler is None
    svc.shutdown_scheduler()  # idempotent


def test_service_explain_wires_result_store():
    svc = SchedulerService(ClusterStore())
    svc.start_scheduler(config=SchedulerConfig(explain=True, **CPU))
    try:
        assert svc.result_store is not None
        assert svc.scheduler.recorder is svc.result_store
    finally:
        svc.shutdown_scheduler()


def test_scheduler_metrics_accumulate():
    c = Cluster()
    try:
        c.start(config=SchedulerConfig(**CPU, **FAST),
                with_pv_controller=False)
        c.create_node("m-node")
        c.create_pod("m-pod")
        c.wait_for_pod_bound("m-pod", timeout=30)
        # The bind can land before the batch folds into the metrics.
        sched = c.service.scheduler
        assert wait_until(lambda: sched.metrics()["batches"] >= 1,
                          timeout=30)
        m = sched.metrics()
        assert m["batches"] >= 1 and m["pods_seen"] >= 1
        assert m["pods_assigned"] >= 1 and m["pods_bound"] >= 1
        assert m["last_batch_size"] >= 1
        assert m["step_s_total"] > 0 and m["encode_s_total"] > 0
        assert "queue_active" in m and "waiting_pods" in m
    finally:
        c.shutdown()


def test_fleet_knobs_raise_instead_of_running_one_engine(monkeypatch):
    """Both fleets are single-profile: asking a multi-profile service for
    2 or more replicas (threads or processes, by argument or by
    environment) raises and starts nothing, in both packages alike. The
    in-process fleet (``fleet`` or ``MINISCHED_FLEET`` at 2 or more)
    starts its replicas, and 0 and 1 run the one engine."""
    svc = SchedulerService(ClusterStore())
    jsvc = JService(JStore())
    two = [Profile(name="a"), Profile(name="b")]
    jtwo = [jdc.Profile(name="a"), jdc.Profile(name="b")]
    for kw, env in (({"fleet_proc": 3}, None),
                    ({"fleet": 2, "fleet_proc": 2}, None),
                    ({"fleet": 2}, None),
                    ({}, ("MINISCHED_FLEET_PROC", "4"))):
        if env is not None:
            monkeypatch.setenv(*env)
        with pytest.raises(ValueError, match="single-profile"):
            svc.start_scheduler(two, config=SchedulerConfig(**CPU), **kw)
        with pytest.raises(ValueError, match="single-profile"):
            jsvc.start_scheduler(jtwo, config=jconfig.SchedulerConfig(),
                                 **kw)
        assert svc.scheduler is None and svc.fleet is None
        if env is not None:
            monkeypatch.delenv(env[0])
    for kw, env in (({"fleet": 2}, None), ({}, ("MINISCHED_FLEET", "3"))):
        if env is not None:
            monkeypatch.setenv(*env)
        svc.start_scheduler(config=SchedulerConfig(**CPU), **kw)
        try:
            n = 2 if env is None else 3
            assert svc.fleet is not None and svc.fleet.n_replicas == n
            assert sorted(svc.schedulers) == [f"r{i}" for i in range(n)]
            assert svc.metrics()["fleet_replicas_live"] == n
        finally:
            svc.shutdown_scheduler()
        assert svc.scheduler is None and svc.fleet is None
        if env is not None:
            monkeypatch.delenv(env[0])
    monkeypatch.setenv("MINISCHED_FLEET", "1")
    svc.start_scheduler(config=SchedulerConfig(**CPU), fleet_proc=0)
    try:
        assert len(svc.schedulers) == 1 and svc.fleet is None
    finally:
        svc.shutdown_scheduler()


def test_fleet_proc_starts_replica_processes_of_the_port(monkeypatch):
    """``fleet_proc=2`` (and ``MINISCHED_FLEET_PROC=2``) start two replica
    processes of the port over the service's own API server, on the
    config's CPU: no engine in this process, the pods bound by the
    replicas, ``journal()`` the merged stream of every process,
    ``provenance()`` answered by the replica that placed the pod, and
    ``restart_scheduler`` brings the process fleet back. Every replica
    process is gone after shutdown."""
    from minisched_tpu_torch.fleet.election import _pid_dead
    from minisched_tpu_torch.fleet.procfleet import ProcFleetSupervisor
    from minisched_tpu_torch.obs import journal as journal_mod

    store = ClusterStore()
    for i in range(4):
        store.create(TO.Node(metadata=TO.ObjectMeta(name=f"pf-n{i}"),
                             status=TO.NodeStatus(allocatable={
                                 "cpu": 64000, "memory": 64 << 30,
                                 "pods": 110})))
    svc = SchedulerService(store)
    cfg = SchedulerConfig(**CPU, **FAST, max_batch_size=16,
                          batch_window_s=0.05, batch_idle_s=0.02)
    pids = []
    journal_mod.configure("1")
    try:
        for how, start, env in (
                ("argument", lambda: svc.start_scheduler(
                    config=cfg, fleet_proc=2), None),
                ("restart", svc.restart_scheduler, None),
                ("environment", lambda: svc.start_scheduler(config=cfg),
                 ("MINISCHED_FLEET_PROC", "2"))):
            if env is not None:
                monkeypatch.setenv(*env)
            assert start() is None  # no engine in this process
            fleet = svc.fleet
            assert isinstance(fleet, ProcFleetSupervisor)
            assert fleet.n_replicas == 2 and fleet.platform == "cpu"
            assert svc.scheduler is None and svc.schedulers == {}
            pids += [p.popen.pid for p in fleet._procs.values()]
            assert fleet.wait_ready(30) and fleet.wait_converged(10)
            tag = len(pids)
            for i in range(12):
                store.create(TO.Pod(
                    metadata=TO.ObjectMeta(name=f"pf{tag}-{i}",
                                           namespace="default"),
                    spec=TO.PodSpec(requests={"cpu": 100})))
            assert wait_until(lambda: all(p.spec.node_name
                                          for p in store.list("Pod")),
                              timeout=30)
            m = svc.metrics()
            assert m["fleet_replicas_live"] == 2 and m["proc_spawns"] == 2
            doc = svc.journal()
            assert {"p0", "p1", "supervisor"} <= set(doc["sources"])
            key = f"default/pf{tag}-0"
            assert wait_until(lambda: svc.provenance(key) is not None,
                              timeout=10)
            assert svc.provenance(key)["served_by"] in ("p0", "p1")
            if how == "argument":
                continue  # restarted next, without a shutdown
            svc.shutdown_scheduler()
            assert svc.fleet is None
    finally:
        svc.shutdown_scheduler()
        journal_mod.configure("")
        for pid in pids:
            if not _pid_dead(pid):
                os.kill(pid, 9)
    assert len(pids) == 6 and all(_pid_dead(pid) for pid in pids)


def test_trace_next_batch_writes_profile(tmp_path):
    import os

    c = Cluster()
    try:
        c.start(config=SchedulerConfig(**CPU, backoff_initial_s=0.05,
                                       backoff_max_s=0.2),
                with_pv_controller=False)
        c.create_node("tr-n0")
        c.service.scheduler.trace_next_batch(str(tmp_path))
        c.create_pod("tr-p0", cpu=100)
        c.wait_for_pod_bound("tr-p0", timeout=30)

        def files():
            return [os.path.join(r, f) for r, _, fs in os.walk(tmp_path)
                    for f in fs]

        assert wait_until(lambda: bool(files()), timeout=10)
        assert c.service.scheduler._trace_dir is None  # one-shot
    finally:
        c.shutdown()


# ---- env config (reference config/config.go:14-75) ----------------------

# Every knob config_from_env reads in both packages, with a value that is
# not its default.
ENV_KNOBS = {
    "MINISCHED_MAX_BATCH": "64", "MINISCHED_BATCH_WINDOW": "0.5",
    "MINISCHED_BATCH_IDLE": "0.1", "MINISCHED_EXPLAIN": "1",
    "MINISCHED_ASSIGNMENT": "auction", "MINISCHED_SEED": "7",
    "MINISCHED_BACKOFF_INITIAL": "0.25", "MINISCHED_BACKOFF_MAX": "3",
    "MINISCHED_PCT_NODES_TO_SCORE": "40", "MINISCHED_PIPELINE": "0",
    "MINISCHED_DEVICE_RESIDENT": "0", "MINISCHED_SHORTLIST": "0",
    "MINISCHED_SHORTLIST_K": "256", "MINISCHED_SHORTLIST_CHECK_EVERY": "3",
    "MINISCHED_DEVICE_LOOP": "1", "MINISCHED_LOOP_DEPTH": "4",
    "MINISCHED_INDEX": "1", "MINISCHED_INDEX_K": "64",
    "MINISCHED_INDEX_CLASSES": "128", "MINISCHED_INDEX_CHECK_EVERY": "2",
    "MINISCHED_WATCHDOG": "1.5", "MINISCHED_PROBATION_BATCHES": "5",
    "MINISCHED_RESIDENT_CHECK_EVERY": "6",
}
# Read with a default and never "required": empty means the default.
UNREQUIRED = ("MINISCHED_PLATFORM",)


def _clear_env(monkeypatch):
    for var in (*ENV_KNOBS, *UNREQUIRED, "MINISCHED_MESH_DEVICES",
                "MINISCHED_COMPILE_CACHE"):
        monkeypatch.delenv(var, raising=False)


def _shared_fields(port_cfg, jax_cfg):
    names = [f.name for f in dataclasses.fields(port_cfg)]
    assert len(names) == 31  # every JAX field, ``mesh`` included
    assert set(names) == {f.name for f in dataclasses.fields(jax_cfg)}
    return ({n: getattr(port_cfg, n) for n in names},
            {n: getattr(jax_cfg, n) for n in names})


def test_config_from_env_defaults(monkeypatch):
    _clear_env(monkeypatch)
    cfg = config_from_env()
    assert cfg.max_batch_size == 1024 and cfg.explain is False
    assert cfg.backoff_initial_s == 1.0 and cfg.backoff_max_s == 10.0
    assert cfg.platform == ""  # cuda:0: raises at start without a card
    port, jax = _shared_fields(cfg, jconfig.config_from_env())
    assert port == jax
    assert cfg == SchedulerConfig()


def test_config_from_env_overrides(monkeypatch):
    _clear_env(monkeypatch)
    for k, v in ENV_KNOBS.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("MINISCHED_PLATFORM", "cpu")
    cfg = config_from_env()
    assert cfg.max_batch_size == 64 and cfg.explain is True
    assert cfg.seed == 7 and cfg.batch_window_s == 0.5
    assert cfg.batch_idle_s == 0.1 and cfg.platform == "cpu"
    assert cfg.device_loop and cfg.index and not cfg.pipeline
    port, jax = _shared_fields(cfg, jconfig.config_from_env())
    assert port == jax
    # every knob moved its field off the default
    moved = {n for n, v in port.items()
             if v != getattr(SchedulerConfig(), n)}
    assert len(moved) == len(ENV_KNOBS) + 1


@pytest.mark.parametrize("var", sorted(ENV_KNOBS))
def test_config_from_env_empty_is_typed_error(monkeypatch, var):
    """reference config.ErrEmptyEnv (config/config.go:18), in both
    packages for every required knob."""
    _clear_env(monkeypatch)
    monkeypatch.setenv(var, "")
    with pytest.raises(EmptyEnvError, match=var):
        config_from_env()
    with pytest.raises(jconfig.EmptyEnvError, match=var):
        jconfig.config_from_env()
    assert issubclass(EmptyEnvError, ValueError)


@pytest.mark.parametrize("value", ["1", "2", "0"])
def test_config_from_env_mesh_devices(monkeypatch, value):
    """``MINISCHED_MESH_DEVICES=n`` builds a mesh over the platform's
    first n distinct devices (the CPU is one): 1 gives a (1,1) mesh on
    the platform's device, a count above the visible devices raises
    naming both counts (never a smaller layout), 0 gives no mesh."""
    _clear_env(monkeypatch)
    monkeypatch.setenv("MINISCHED_PLATFORM", "cpu")
    monkeypatch.setenv("MINISCHED_MESH_DEVICES", value)
    if value == "2":
        with pytest.raises(ValueError,
                           match="MINISCHED_MESH_DEVICES=2 but only 1 "):
            config_from_env()
        return
    cfg = config_from_env()
    if value == "0":
        assert cfg.mesh is None
        assert cfg == SchedulerConfig(platform="cpu")
        return
    assert cfg.mesh.devices.shape == (1, 1)
    assert cfg.mesh.device == torch.device("cpu")
    assert dataclasses.replace(cfg, mesh=None) == SchedulerConfig(
        platform="cpu")


@pytest.mark.parametrize("value", ["", "cc"])
def test_config_from_env_reads_compile_cache(monkeypatch, value):
    """``MINISCHED_COMPILE_CACHE`` is read as the JAX package reads it:
    any string, empty meaning off (never the typed empty error)."""
    _clear_env(monkeypatch)
    monkeypatch.setenv("MINISCHED_COMPILE_CACHE", value)
    cfg = config_from_env()
    assert cfg.compile_cache == value
    port, jax = _shared_fields(cfg, jconfig.config_from_env())
    assert port == jax
    assert cfg == SchedulerConfig(compile_cache=value)


def test_compile_cache_moves_the_kernel_build_directory(monkeypatch,
                                                        tmp_path):
    """The port's compile cache is its kernel build directory: an engine
    on a config naming one builds into and loads from it
    (``compile_cache_on`` 1, as the JAX engine reports an armed cache);
    the default config keeps the package's ``_build/`` (0)."""
    from minisched_tpu_torch.ops import _cuda_build

    monkeypatch.setattr(_cuda_build, "BUILD_DIR", _cuda_build.BUILD_DIR)
    default_dir = _cuda_build.BUILD_DIR
    svc = SchedulerService(ClusterStore())
    svc.start_scheduler(config=SchedulerConfig(**CPU))
    try:
        assert svc.metrics()["compile_cache_on"] == 0
    finally:
        svc.shutdown_scheduler()
    assert _cuda_build.BUILD_DIR == default_dir
    cache = tmp_path / "kernels"
    svc.start_scheduler(config=SchedulerConfig(**CPU,
                                               compile_cache=str(cache)))
    try:
        assert svc.metrics()["compile_cache_on"] == 1
    finally:
        svc.shutdown_scheduler()
    assert _cuda_build.BUILD_DIR == str(cache) and cache.is_dir()
    assert os.path.dirname(_cuda_build.library_path("shortlist_scan")) \
        == str(cache)
    # A directory that cannot be made leaves the cache off.
    blocker = tmp_path / "file"
    blocker.write_text("")
    assert not _cuda_build.enable_compile_cache(str(blocker / "sub"))
    assert _cuda_build.BUILD_DIR == str(cache)


def test_platform_from_env_cpu_runs_the_engine(monkeypatch):
    _clear_env(monkeypatch)
    monkeypatch.setenv("MINISCHED_PLATFORM", "cpu")
    monkeypatch.setenv("MINISCHED_BACKOFF_INITIAL", "0.05")
    c = Cluster()
    try:
        c.start(config=config_from_env(), with_pv_controller=False)
        assert str(c.service.scheduler.device) == "cpu"
        c.create_node("env-n0")
        c.create_pod("env-p0")
        assert c.wait_for_pod_bound("env-p0", timeout=30).spec.node_name
    finally:
        c.shutdown()
    assert tconfig.SchedulerConfig is SchedulerConfig


# ---- the reference's eight conversion cases ----------------------------


def _conversion_cases(M, dc):
    """(name, SchedulerConfiguration) over module ``M`` (service.config)
    and ``dc`` (service.defaultconfig) of one package."""
    P = dc.Profile
    return {
        "empty": M.SchedulerConfiguration(),
        "no-disabled": M.SchedulerConfiguration(
            profiles=[P(name="default-scheduler", plugins=[])]),
        "non-profile-fields": M.SchedulerConfiguration(
            profiles=[P(name="default-scheduler", plugins=[])],
            parallelism=999, percentage_of_nodes_to_score=77),
        "user-enabled-ignored": M.SchedulerConfiguration(
            profiles=[P(name="default-scheduler", plugins=["NodeNumber"])]),
        "multiple": M.SchedulerConfiguration(profiles=[
            P(name="default-scheduler", plugins=[]),
            P(name="default-scheduler2", plugins=[],
              score_disabled=["NodeResourcesFit"])]),
        "multiple-pluginconfig": M.SchedulerConfiguration(profiles=[
            P(name="default-scheduler", plugins=[],
              plugin_args={"NodeResourcesFit":
                           {"score_strategy": "MostAllocated"}}),
            P(name="default-scheduler2", plugins=[])]),
        "some-disabled": M.SchedulerConfiguration(
            profiles=[P(name="default-scheduler", plugins=[],
                        score_disabled=["TaintToleration"])]),
        "star-disabled": M.SchedulerConfiguration(
            profiles=[P(name="default-scheduler", plugins=["NodeNumber"],
                        score_disabled=["*"])]),
    }


CASES = sorted(_conversion_cases(tsc, tdc))


@pytest.mark.parametrize("case", CASES)
def test_conversion_matches_jax(case):
    """Every case converts to the same profiles (names, plugin lists,
    weights, merged args, per-point disables) and the same non-profile
    fields in both packages, and the converted profiles build the same
    filter and score lists."""
    got = convert_configuration_for_simulator(
        _conversion_cases(tsc, tdc)[case])
    want = jsc.convert_configuration_for_simulator(
        _conversion_cases(jsc, jdc)[case])
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for p, jp in zip(got.profiles, want.profiles):
        assert _built_names(p) == _built_names(jp)


def test_convert_empty_configuration():
    got = convert_configuration_for_simulator(SchedulerConfiguration())
    assert [p.name for p in got.profiles] == ["default-scheduler"]
    filters, scores = _built_names(got.profiles[0])
    assert filters == DEFAULT_FILTERS
    assert sorted(scores) == sorted(DEFAULT_SCORES)


def test_convert_resets_non_profile_fields():
    got = convert_configuration_for_simulator(SchedulerConfiguration(
        profiles=[Profile(name="default-scheduler", plugins=[])],
        parallelism=999, percentage_of_nodes_to_score=77))
    assert got.parallelism == SchedulerConfiguration().parallelism
    assert (got.percentage_of_nodes_to_score
            == SchedulerConfiguration().percentage_of_nodes_to_score)


def test_convert_multiple_profiles_custom_pluginconfig():
    got = convert_configuration_for_simulator(SchedulerConfiguration(
        profiles=[
            Profile(name="default-scheduler", plugins=[],
                    plugin_args={"NodeResourcesFit":
                                 {"score_strategy": "MostAllocated"}}),
            Profile(name="default-scheduler2", plugins=[])]))
    args1 = got.profiles[0].plugin_args["NodeResourcesFit"]
    assert args1["score_strategy"] == "MostAllocated"
    assert args1["resources"] == ("cpu", "memory")
    assert (got.profiles[1].plugin_args["NodeResourcesFit"]
            == DEFAULT_PLUGIN_ARGS["NodeResourcesFit"])


def test_convert_star_disable_keeps_user_list():
    got = convert_configuration_for_simulator(SchedulerConfiguration(
        profiles=[Profile(name="default-scheduler",
                          plugins=["NodeNumber"], score_disabled=["*"])]))
    filters, scores = _built_names(got.profiles[0])
    assert scores == ["NodeNumber"]
    assert filters == DEFAULT_FILTERS


# ---- NewPluginConfig raw/object contract --------------------------------


def test_plugin_args_object_beats_raw():
    pa = PluginArgs(raw='{"score_strategy": "LeastAllocated"}',
                    object={"score_strategy": "MostAllocated"})
    jpa = jsc.PluginArgs(raw=pa.raw, object=pa.object)
    assert resolve_args(pa) == {"score_strategy": "MostAllocated"}
    assert resolve_args(pa) == jsc.resolve_args(jpa)
    for v in ('{"a": 1}', {"b": 2}, None, PluginArgs(raw='{"c": 3}')):
        assert resolve_args(v) == jsc.resolve_args(
            jsc.PluginArgs(raw=v.raw) if isinstance(v, PluginArgs) else v)


def test_new_plugin_config_merges_defaults():
    user = {"NodeResourcesBalancedAllocation": {"resources": ("cpu",)},
            "NodeNumber": '{"permit_delay": false}'}
    merged = new_plugin_config(user)
    assert merged["NodeResourcesBalancedAllocation"]["resources"] == (
        "cpu",)
    assert merged["NodeResourcesFit"]["score_strategy"] == "LeastAllocated"
    assert merged == jsc.new_plugin_config(user)


# ---- two profiles on one store ------------------------------------------


def _mp_node(O, name, cpu=4000.0):
    return O.Node(metadata=O.ObjectMeta(name=name), spec=O.NodeSpec(),
                  status=O.NodeStatus(allocatable={
                      "cpu": cpu, "memory": float(16 << 30), "pods": 110.0}))


def _mp_pod(O, name, scheduler_name):
    return O.Pod(metadata=O.ObjectMeta(name=name, namespace="mp"),
                 spec=O.PodSpec(requests={"cpu": 100.0},
                                scheduler_name=scheduler_name))


def test_two_profile_scenario_routes_pods():
    store = ClusterStore()
    for i in range(4):
        store.create(_mp_node(TO, f"node{i}"))
    svc = SchedulerService(store)
    svc.start_scheduler(
        [Profile(name="profile-a",
                 plugins=["NodeUnschedulable", "NodeResourcesFit"]),
         Profile(name="profile-b",
                 plugins=["NodeUnschedulable", "NodeResourcesFit"])],
        SchedulerConfig(max_batch_size=16, **CPU))
    try:
        store.create(_mp_pod(TO, "pa", "profile-a"))
        store.create(_mp_pod(TO, "pb", "profile-b"))
        store.create(_mp_pod(TO, "orphan", "no-such-profile"))
        assert wait_until(lambda: {p.metadata.name for p in store.list("Pod")
                                   if p.spec.node_name} >= {"pa", "pb"},
                          timeout=30)
        assert wait_until(lambda: all(
            e.metrics()["pods_seen"] >= 1
            for e in svc.schedulers.values()), timeout=30)
        ma = svc.schedulers["profile-a"].metrics()
        mb = svc.schedulers["profile-b"].metrics()
        assert ma["pods_bound"] == 1 and ma["pods_seen"] == 1
        assert mb["pods_bound"] == 1 and mb["pods_seen"] == 1
        time.sleep(0.3)
        assert not store.get("Pod", "mp/orphan").spec.node_name
    finally:
        svc.shutdown_scheduler()


def test_duplicate_profile_names_rejected():
    svc = SchedulerService(ClusterStore())
    with pytest.raises(ValueError):
        svc.start_scheduler([Profile(name="x", plugins=["NodeUnschedulable"]),
                             Profile(name="x", plugins=["NodeUnschedulable"])],
                            SchedulerConfig(**CPU))
    assert svc.scheduler is None


def test_bad_later_profile_starts_nothing():
    """Every plugin set is built before any engine starts."""
    svc = SchedulerService(ClusterStore())
    with pytest.raises(KeyError):
        svc.start_scheduler([Profile(name="ok", plugins=["NodeNumber"]),
                             Profile(name="bad", plugins=["NoSuchPlugin"])],
                            SchedulerConfig(**CPU))
    assert svc.scheduler is None and svc._shared_state is None


def test_configuration_pct_carries_into_the_config():
    """A SchedulerConfiguration's non-default percentage_of_nodes_to_score
    reaches the engines' config, as in the JAX service."""
    profiles = [Profile(name="a", plugins=["NodeUnschedulable"]),
                Profile(name="b", plugins=["NodeUnschedulable"])]
    for cfg in (SchedulerConfig(**CPU), SchedulerConfig(
            percentage_of_nodes_to_score=30, **CPU)):
        svc = SchedulerService(ClusterStore())
        svc.start_scheduler(SchedulerConfiguration(
            profiles=profiles, percentage_of_nodes_to_score=60), cfg)
        try:
            assert {s.config.percentage_of_nodes_to_score
                    for s in svc.schedulers.values()} == {60}
            assert svc.get_scheduler_profiles() == profiles
        finally:
            svc.shutdown_scheduler()


def test_two_profiles_share_one_cache_and_informer_at_10k_nodes():
    import threading

    store = ClusterStore()
    store.create_many([TO.Node(
        metadata=TO.ObjectMeta(name=f"mp-n{i:05d}"),
        status=TO.NodeStatus(allocatable={"cpu": 1000, "pods": 110}))
        for i in range(10_000)])
    svc = SchedulerService(store)
    svc.start_scheduler([
        Profile(name="prof-a", plugins=["NodeUnschedulable",
                                        "NodeResourcesFit"]),
        Profile(name="prof-b", plugins=["NodeUnschedulable",
                                        "NodeResourcesFit",
                                        "NodeResourcesLeastAllocated"]),
    ], SchedulerConfig(batch_window_s=0.0, **CPU, **FAST))
    try:
        a, b = svc.schedulers["prof-a"], svc.schedulers["prof-b"]
        assert a.cache is b.cache and a._shared is b._shared
        assert a.cache.node_count() == 10_000
        pumps = [t for t in threading.enumerate()
                 if t.name == "informer-dispatch"]
        assert len(pumps) == 1, [t.name for t in pumps]
        store.create_many([
            TO.Pod(metadata=TO.ObjectMeta(name="mp-pa", namespace="default"),
                   spec=TO.PodSpec(requests={"cpu": 100},
                                   scheduler_name="prof-a")),
            TO.Pod(metadata=TO.ObjectMeta(name="mp-pb", namespace="default"),
                   spec=TO.PodSpec(requests={"cpu": 100},
                                   scheduler_name="prof-b"))])
        assert wait_until(lambda: all(
            store.get("Pod", f"default/mp-p{x}").spec.node_name
            for x in "ab"), timeout=30)
    finally:
        svc.shutdown_scheduler()


PROFILES = ("prof-a", "prof-b")
MP_PLUGINS = ["NodeUnschedulable", "NodeResourcesFit",
              "NodeResourcesLeastAllocated",
              "NodeResourcesBalancedAllocation"]


def _two_profile_run(n_nodes, n_pods, jax: bool):
    """bench_cluster's nodes and pods, the pods alternating between two
    profiles of one SchedulerConfiguration. prof-a's pods are in the
    store before the service starts; prof-b's are created in one
    transaction once every prof-a pod is bound and the cache is quiet,
    so each engine's batches do not depend on the other's timing."""
    O, Store, Service = (JO, JStore, JService) if jax else (
        TO, ClusterStore, SchedulerService)
    P, SC = (jdc.Profile, jsc.SchedulerConfiguration) if jax else (
        Profile, SchedulerConfiguration)
    nodes, pods = bench_cluster(O, n_nodes, n_pods, seed=3)
    for i, p in enumerate(pods):
        p.spec.scheduler_name = PROFILES[i % 2]
    half = {name: [p for p in pods if p.spec.scheduler_name == name]
            for name in PROFILES}
    store = Store()
    store.create_many(nodes)
    store.create_many(half["prof-a"])
    cfg = (jconfig.SchedulerConfig(**FAST) if jax
           else SchedulerConfig(**CPU, **FAST))
    svc = Service(store)
    svc.start_scheduler(SC(profiles=[
        P(name=n, plugins=MP_PLUGINS,
          plugin_args={"NodeResourcesFit": {"score_strategy": None}})
        for n in PROFILES]), cfg)

    def bound(name):
        # The binder can bind a batch's pods before the scheduling thread
        # folds that batch into the metrics: wait for both.
        return wait_until(lambda: all(
            store.get("Pod", p.key).spec.node_name for p in half[name])
            and svc.metrics()[f"{name}_pods_assigned"] >= len(half[name]),
            timeout=120)

    try:
        assert bound("prof-a")
        cache = svc.scheduler.cache
        v = -1
        while v != cache.version:  # quiet: no bind confirmation in flight
            v = cache.version
            time.sleep(0.2)
        store.create_many(half["prof-b"])
        assert bound("prof-b")
        m = svc.metrics()
        for name in PROFILES:
            assert m[f"{name}_pods_seen"] == len(half[name])
            assert m[f"{name}_pods_bound"] == len(half[name])
        return {p.key: p.spec.node_name for p in store.list("Pod")}, m
    finally:
        svc.shutdown_scheduler()


@pytest.mark.parametrize("n_nodes,n_pods", [(120, 240), (1200, 512)])
def test_two_profile_placements_match_jax(n_nodes, n_pods):
    """Two profiles on one store route pods by scheduler_name, and the
    placements equal the JAX service's on the same store content, at 120
    nodes and at 1,200 (where the default config samples nodes)."""
    port, m = _two_profile_run(n_nodes, n_pods, jax=False)
    want, jm = _two_profile_run(n_nodes, n_pods, jax=True)
    assert port == want
    if n_nodes >= 1200:
        assert all(m[f"{n}_sampled_batches"] >= 1 for n in PROFILES)
    for n in PROFILES:
        assert m[f"{n}_batches"] == jm[f"{n}_batches"]


def _service_metric_keys(pkg_svc, Store, Prof, cfg, multi):
    svc = pkg_svc(Store())
    assert svc.metrics() == {}  # nothing running yet
    profs = [Prof(name="default-scheduler",
                  plugins=["NodeUnschedulable", "NodeResourcesFit"]),
             Prof(name="batch-sched",
                  plugins=["NodeUnschedulable", "NodeResourcesFit"])]
    svc.start_scheduler(profs if multi else profs[0], cfg)
    try:
        m = svc.metrics()
        assert all(isinstance(v, (int, float)) for v in m.values())
        h = svc.metrics_histograms()
        return set(m), set(h)
    finally:
        svc.shutdown_scheduler()


def test_service_metrics_flatten_across_profiles():
    """SchedulerService.metrics() feeds one /metrics scrape: unprefixed
    engine keys for one profile, profile-prefixed keys for several; the
    port's keys hold every JAX key but the later slices', and the
    histogram feed is keyed alike."""
    tcfg = SchedulerConfig(batch_window_s=0.05, **CPU)
    jcfg = jconfig.SchedulerConfig(batch_window_s=0.05)
    single, single_h = _service_metric_keys(SchedulerService, ClusterStore,
                                            Profile, tcfg, False)
    multi, multi_h = _service_metric_keys(SchedulerService, ClusterStore,
                                          Profile, tcfg, True)
    jsingle, jsingle_h = _service_metric_keys(JService, JStore, jdc.Profile,
                                              jcfg, False)
    jmulti, jmulti_h = _service_metric_keys(JService, JStore, jdc.Profile,
                                            jcfg, True)
    assert "batches" in single and "batches" not in multi
    names = ("default-scheduler", "batch-sched")
    assert multi == {f"{n}_{k}" for n in names for k in single}
    assert multi_h == {f"{n}_{k}" for n in names for k in single_h}
    assert single_h == jsingle_h
    assert jsingle - single == LATER_SLICE_KEYS
    assert jmulti - multi == {f"{n}_{k}" for n in names
                              for k in LATER_SLICE_KEYS}

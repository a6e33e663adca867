"""Scheduler lifecycle service.

Rebuild of reference scheduler/scheduler.go: NewSchedulerService (:36),
StartScheduler (:50-80: informers + event broadcaster + the scheduler +
start informers + go Run) and ShutdownScheduler (:82-87), for one
profile and one engine. With ``SchedulerConfig.explain`` the service
also runs the result store (``result_store``), which publishes every
pod's per-plugin verdicts and scores as annotations.
"""
from __future__ import annotations

import logging
from typing import Optional

from ..config import SchedulerConfig
from ..engine.clusterstate import SharedClusterState
from ..engine.scheduler import Scheduler
from ..explain import ResultStore
from ..state.informer import ResourceEventHandlers
from .defaultconfig import Profile, default_scheduler_profile

log = logging.getLogger(__name__)


class SchedulerService:
    def __init__(self, store):
        self._store = store
        self._sched: Optional[Scheduler] = None
        self._shared_state: Optional[SharedClusterState] = None
        # The explain-mode result store of the running engine, else None.
        self.result_store: Optional[ResultStore] = None

    @property
    def scheduler(self) -> Optional[Scheduler]:
        """The running engine, or None."""
        return self._sched

    def start_scheduler(self, profile: Optional[Profile] = None,
                        config: Optional[SchedulerConfig] = None
                        ) -> Scheduler:
        if self._sched is not None:
            raise RuntimeError("scheduler already running")
        profile = profile or default_scheduler_profile()
        # Build the plugin set before anything starts, so a bad profile
        # (unknown plugin, bad args) leaves nothing half-started.
        plugin_set = profile.build()
        shared = SharedClusterState(self._store)
        recorder = None
        if config is not None and config.explain:
            # Annotations flush on the store's worker, off the scheduling
            # thread (the reference flushes on informer events).
            self.result_store = recorder = ResultStore(self._store,
                                                       async_flush=True)
            # Pod updates re-drive a flush that ran out of CAS retries
            # (results land on the pod's next update); a deleted pod's
            # records are evicted. Registered before the engine starts
            # the informers.
            shared.informer_factory.add_handlers(
                "Pod", ResourceEventHandlers(
                    on_update=lambda old, new: recorder.on_pod_event(
                        new.key),
                    on_update_many=lambda pairs: recorder.on_pod_events(
                        [new.key for _old, new in pairs]),
                    on_delete=lambda pod: recorder.delete_data(pod.key)))
        sched = Scheduler(self._store, plugin_set, config, recorder=recorder,
                          shared=shared, profile=profile.name)
        self._shared_state, self._sched = shared, sched
        sched.start()
        cfg = sched.config
        log.info("scheduler started (profile=%s, device=%s, pipeline=%s, "
                 "device_resident=%s, shortlist=%s k=%d)", profile.name,
                 sched.device, cfg.pipeline, cfg.device_resident,
                 cfg.shortlist, cfg.shortlist_k)
        return sched

    def shutdown_scheduler(self) -> None:
        if self._sched is not None:
            self._sched.shutdown()
            self._sched = None
            log.info("scheduler shut down")
        if self._shared_state is not None:
            self._shared_state.shutdown()
            self._shared_state = None

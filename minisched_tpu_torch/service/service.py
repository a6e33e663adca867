"""Scheduler lifecycle service.

Rebuild of reference scheduler/scheduler.go: NewSchedulerService (:36),
StartScheduler (:50-80: informers + event broadcaster + the scheduler +
start informers + go Run) and ShutdownScheduler (:82-87), for one
profile and one engine.
"""
from __future__ import annotations

import logging
from typing import Optional

from ..config import SchedulerConfig
from ..engine.clusterstate import SharedClusterState
from ..engine.scheduler import Scheduler
from .defaultconfig import Profile, default_scheduler_profile

log = logging.getLogger(__name__)


class SchedulerService:
    def __init__(self, store):
        self._store = store
        self._sched: Optional[Scheduler] = None
        self._shared_state: Optional[SharedClusterState] = None

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
        sched = Scheduler(self._store, plugin_set, config, shared=shared,
                          profile=profile.name)
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

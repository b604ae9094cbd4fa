"""Scheduler main loop.

Reference parity: pkg/scheduler/scheduler.go:71-245 (NewScheduler, Run,
runOnce, conf hot-reload via file watching).
"""

from __future__ import annotations

import logging
import os
import sys
import threading
import time
from typing import Optional

from volcano_tpu_torch.cache.cache import SchedulerCache
from volcano_tpu_torch.cache.cluster import Cluster
from volcano_tpu_torch.conf import SchedulerConf, load_conf
from volcano_tpu_torch.framework.framework import close_session, open_session
from volcano_tpu_torch.framework.plugins import get_action
from volcano_tpu_torch import goodput, metrics, trace

log = logging.getLogger(__name__)

DEFAULT_SCHEDULE_PERIOD = 1.0


class Scheduler:
    def __init__(self, cluster: Cluster, conf=None,
                 conf_path: Optional[str] = None,
                 schedule_period: float = DEFAULT_SCHEDULE_PERIOD,
                 scheduler_name: str = "volcano-tpu",
                 shard_index: Optional[int] = None,
                 shard_count: Optional[int] = None):
        self.cluster = cluster
        self.cache = SchedulerCache(cluster, scheduler_name)
        self.conf_path = conf_path
        self._conf_mtime = 0.0
        # subtree-partition identity (--shard-index/--shard-count):
        # survives conf hot-reloads by being re-applied in _load, so a
        # reloaded file can change plugins but not silently merge two
        # shards onto one subtree
        self._shard = (shard_index, shard_count) \
            if shard_index is not None and shard_count else None
        self.conf: SchedulerConf = self._load(conf)
        self.schedule_period = schedule_period
        self._stop = threading.Event()
        self.cycles = 0

    def _load(self, conf) -> SchedulerConf:
        if self.conf_path and os.path.exists(self.conf_path):
            self._conf_mtime = os.path.getmtime(self.conf_path)
            with open(self.conf_path) as f:
                loaded = load_conf(f.read())
        else:
            loaded = load_conf(conf)
        if self._shard is not None:
            idx, count = self._shard
            alloc = loaded.configurations.setdefault("allocate", {})
            alloc["shard-mode"] = "subtree"
            alloc["shard-index"] = idx
            alloc["shard-count"] = count
        return loaded

    def _maybe_reload_conf(self):
        """Hot reload on file change (scheduler.go:219-245)."""
        if not self.conf_path or not os.path.exists(self.conf_path):
            return
        mtime = os.path.getmtime(self.conf_path)
        if mtime != self._conf_mtime:
            log.info("scheduler conf changed, reloading")
            self.conf = self._load(None)   # re-applies shard identity

    def run_once(self):
        """One scheduling cycle (scheduler.go runOnce).  The whole
        cycle runs under a trace root span: open/close and every
        action are timed children, plugin callbacks aggregate under
        whichever span is innermost when they fire (trace.py)."""
        self._maybe_reload_conf()
        start = time.perf_counter()
        root = trace.begin_session(cycle=self.cycles)
        shard_conf = self.conf.configurations.get("allocate", {})
        if str(shard_conf.get("shard-mode", "")) == "subtree":
            # vtpctl shards reads per-shard cycle time off /traces by
            # this label; the conductor REPRODUCE line replays it
            root.labels["shard"] = (f"{shard_conf.get('shard-index', 0)}"
                                    f"/{shard_conf.get('shard-count', 1)}")
        ssn = None
        try:
            with trace.span("open_session", kind="action"):
                ssn = open_session(self.cache, self.conf)
            root.labels["session"] = ssn.uid
            # federated causal episodes riding this session's gangs
            # (podgroup annotation inherited from the router's
            # regional copy): the label makes this session a
            # /traces?episode= fragment the fleet stitcher can pull.
            # Only NOT-YET-RUNNING gangs qualify — once the gang runs,
            # later cycles are steady-state housekeeping, and labeling
            # them would extend the stitched episode wall past the
            # actual submit->running interval forever
            from volcano_tpu_torch.api import federation as fedapi
            from volcano_tpu_torch.api.types import PodGroupPhase
            episodic = [j.podgroup for j in ssn.jobs.values()
                        if j.podgroup is not None
                        and j.podgroup.phase in (PodGroupPhase.PENDING,
                                                 PodGroupPhase.INQUEUE)
                        and fedapi.episode_of(j.podgroup)]
            eps = trace.episode_label(
                fedapi.episode_of(pg) for pg in episodic)
            if eps:
                root.labels["episode"] = eps
                # the hop must be stamped HERE, off the gang's own
                # annotation: the stitcher's fallback is the global
                # job's CURRENT hop, which after a cutover would drag
                # this region's old admission-time sessions into the
                # destination's hop group and clamp-shift the whole
                # group forward past the real wall time
                root.labels["hop"] = str(min(
                    fedapi.episode_hop(pg) for pg in episodic))
            for name in self.conf.actions:
                action = get_action(name)
                if action is None:
                    log.warning("unknown action %s (skipped)", name)
                    continue
                t0 = time.perf_counter()
                with trace.span(name, kind="action"):
                    action.execute(ssn)
                metrics.observe("action_latency_seconds",
                                time.perf_counter() - t0, action=name)
            # goodput observatory: per-session fragmentation /
            # starvation / fleet-throughput gauges off the post-action
            # state (one O(nodes)+O(jobs) pass; volcano_tpu_torch/goodput.py).
            # Degrade-don't-crash: a metrics-only bug must never stop
            # scheduling — same posture as the agent-side handlers.
            try:
                with trace.span("observe", kind="action"):
                    goodput.observe_session(ssn)
            except Exception:  # noqa: BLE001
                log.exception("goodput session observation failed")
        finally:
            # a cycle that crashed ANYWHERE (open_session, an action,
            # close_session below) is exactly what the recorder must
            # capture: label it so the keep policy always records it
            exc = sys.exc_info()[1]
            if exc is not None:
                root.labels["error"] = type(exc).__name__
            jobs_pending = []
            try:
                if ssn is not None:
                    with trace.span("close_session", kind="action"):
                        close_session(ssn)
                    jobs_pending = list(ssn.touched_jobs
                                        | ssn.dirty_jobs)
            finally:
                exc = sys.exc_info()[1]
                if exc is not None and "error" not in root.labels:
                    root.labels["error"] = type(exc).__name__
                doc = trace.end_session(root,
                                        jobs_pending=jobs_pending)
                trace.publish(self.cache.cluster, doc)
        self.cycles += 1
        metrics.observe("e2e_scheduling_latency_seconds",
                        time.perf_counter() - start)
        return ssn

    def run(self, max_cycles: Optional[int] = None):
        while not self._stop.is_set():
            self.run_once()
            if max_cycles is not None and self.cycles >= max_cycles:
                break
            self._stop.wait(self.schedule_period)

    def stop(self):
        self._stop.set()

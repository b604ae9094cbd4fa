"""OpenSession / CloseSession (reference: framework/framework.go:34,63)."""

from __future__ import annotations

import logging
import time

from volcano_tpu_torch import metrics, trace
from volcano_tpu_torch.analysis import freezeaudit
from volcano_tpu_torch.conf import SchedulerConf
from volcano_tpu_torch.framework import job_updater
from volcano_tpu_torch.framework.plugins import get_plugin_builder
from volcano_tpu_torch.framework.session import Session

log = logging.getLogger(__name__)


def open_session(cache, conf: SchedulerConf) -> Session:
    t0 = time.perf_counter()
    snapshot = cache.snapshot()
    ssn = Session(cache, snapshot, conf)
    for tier in conf.tiers:
        for opt in tier.plugins:
            builder = get_plugin_builder(opt.name)
            if builder is None:
                log.warning("unknown plugin %s (skipped)", opt.name)
                continue
            plugin = builder(opt.arguments)
            ssn.plugins[opt.name] = plugin
            tp = time.perf_counter()
            with trace.span(opt.name, kind="plugin", point="open"):
                plugin.on_session_open(ssn)
            metrics.observe("plugin_latency_seconds",
                            time.perf_counter() - tp,
                            plugin=opt.name, point="open")
    metrics.observe("open_session_duration_seconds",
                    time.perf_counter() - t0)
    # plugins have finished their session setup: under VTP_RACE_AUDIT
    # the snapshot deep-freezes here, and stays frozen until the
    # session's first Statement commit (analysis/freezeaudit.py)
    freezeaudit.maybe_freeze_session(ssn)
    return ssn


def open_mirror_session(cache_stub, snapshot, conf: SchedulerConf
                        ) -> Session:
    """Session over a process-mirror snapshot — the worker half of
    the process-pool sweep (actions/procpool.py).  Same plugin
    construction as open_session minus the cache snapshot: resolution
    of the prepared PreFilter/PreScore forms happens HERE, in the
    worker, against shipped DATA only — callables never cross the
    process boundary (the ship seam's pure pickler enforces it).
    ``cache_stub`` carries the shipped read-only cluster maps plugins
    consult at open (procpool.MirrorCache); mutation routes on it are
    no-ops because workers only ever predicate and score."""
    ssn = Session(cache_stub, snapshot, conf)
    for tier in conf.tiers:
        for opt in tier.plugins:
            builder = get_plugin_builder(opt.name)
            if builder is None:
                log.warning("unknown plugin %s (skipped)", opt.name)
                continue
            plugin = builder(opt.arguments)
            ssn.plugins[opt.name] = plugin
            plugin.on_session_open(ssn)
    # defense-in-depth when the race auditor is armed in the worker
    # process: mirror snapshots freeze exactly like owner snapshots,
    # so a worker-side write outside the replay seams is a recorded
    # violation in the worker's own flushed report
    freezeaudit.maybe_freeze_session(ssn)
    return ssn


def close_mirror_session(ssn: Session) -> None:
    """Retire a mirror session before its snapshot absorbs the next
    delta (plugin close hooks and the job updater are OWNER-side
    duties; the worker only lifts the freeze)."""
    freezeaudit.thaw_session(ssn)


def close_session(ssn: Session) -> None:
    # lift the snapshot freeze first: plugin close hooks, the job
    # updater and the cache's post-session bookkeeping mutate freely
    freezeaudit.thaw_session(ssn)
    for name, plugin in reversed(list(ssn.plugins.items())):
        tp = time.perf_counter()
        with trace.span(name, kind="plugin", point="close"):
            plugin.on_session_close(ssn)
        metrics.observe("plugin_latency_seconds",
                        time.perf_counter() - tp,
                        plugin=name, point="close")
    job_updater.update_job_statuses(ssn)
    job_updater.remove_admission_gates(ssn)
    job_updater.publish_scheduling_reasons(ssn)
    # session mutations invalidate snapshot reuse for the objects they
    # touched, whether the ops committed or were discarded
    note = getattr(ssn.cache, "note_touched", None)
    if note is not None:
        note(ssn.touched_nodes, ssn.touched_jobs)
    ssn.cache.flush_binds()

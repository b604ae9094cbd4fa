"""Cache dumper — SIGUSR2-triggered JSON dump of scheduler state.

Reference parity: pkg/scheduler/cache/dumper.go (+ the unix-socket
klog-level endpoint, pkg/scheduler/util.go:95 — here exposed as
set_log_level()).
"""

from __future__ import annotations

import json
import logging
import signal
import time

log = logging.getLogger(__name__)


def snapshot_to_dict(snapshot) -> dict:
    return {
        "timestamp": time.time(),
        "nodes": {
            name: {
                "idle": node.idle.to_dict(),
                "used": node.used.to_dict(),
                "releasing": node.releasing.to_dict(),
                "pipelined": node.pipelined.to_dict(),
                "tasks": sorted(t.key for t in node.tasks.values()),
                "bind_generation": node.bind_generation,
            } for name, node in snapshot.nodes.items()
        },
        "jobs": {
            job.key: {
                "queue": job.queue,
                "min_available": job.min_available,
                "ready": job.ready_task_num(),
                "tasks": {t.key: {"status": t.status.value,
                                  "node": t.node_name}
                          for t in job.tasks.values()},
                "sub_jobs": {name: {"allocated": s.allocated_hypernode,
                                    "nominated": s.nominated_hypernode}
                             for name, s in job.sub_jobs.items()},
            } for job in snapshot.jobs.values()
        },
        "queues": sorted(snapshot.queues),
        "hypernodes": {
            name: {"tier": info.tier, "nodes": sorted(info.nodes)}
            for name, info in (snapshot.hypernodes.members.items()
                               if snapshot.hypernodes else {}.items())
        },
    }


class Dumper:
    """Dump the scheduler's latest snapshot to disk on SIGUSR2."""

    def __init__(self, scheduler, path: str = "/tmp/volcano-tpu-dump.json"):
        self.scheduler = scheduler
        self.path = path

    def dump(self) -> str:
        from volcano_tpu_torch import trace
        snapshot = self.scheduler.cache.snapshot()
        payload = snapshot_to_dict(snapshot)
        # flight-recorder section: the last kept session span trees
        # and the live per-job unschedulable-reason aggregate, so a
        # wedged scheduler is diagnosable post-hoc from ONE artifact
        # (what was it doing, and why is work pending)
        payload["trace"] = trace.dump_state()
        # goodput observatory section: the learned per-(job,
        # generation) throughput vectors and per-world-size rates —
        # what the grow gate and (later) a Gavel policy would decide
        # from (volcano_tpu_torch/goodput.py)
        book = getattr(self.scheduler.cache, "goodput_book", None)
        if book is not None:
            payload["goodput"] = book.dump_state()
        with open(self.path, "w") as f:
            json.dump(payload, f, indent=2, sort_keys=True)
        log.info("cache dumped to %s", self.path)
        return self.path

    def listen_for_signal(self):
        signal.signal(signal.SIGUSR2, lambda *_: self.dump())


def set_log_level(level: str):
    """Runtime log-level change (klog socket analogue)."""
    logging.getLogger("volcano_tpu_torch").setLevel(
        getattr(logging, level.upper(), logging.INFO))

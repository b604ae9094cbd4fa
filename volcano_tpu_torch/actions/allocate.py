"""Allocate action — the scheduler's hot loop.

Reference parity: actions/allocate/allocate.go:122-981.  Nested
priority queues (queue -> job -> task); per-task predicate + score;
statement-buffered placement committed only when the gang is ready
(or left pipelined when it can become ready on releasing resources);
hard-topology jobs dry-run across hypernode candidate domains and the
best-scoring domain is recovered (allocate.go:370-463).
"""

from __future__ import annotations

import logging
import time
from typing import Dict

from volcano_tpu_torch import metrics, trace
from volcano_tpu_torch.api.fit_error import (FitError, FitErrors,
                                       unschedulable)
from volcano_tpu_torch.api.job_info import JobInfo
from volcano_tpu_torch.api.types import PodGroupPhase, TaskStatus
from volcano_tpu_torch.framework.plugins import Action, register_action
from volcano_tpu_torch.util import PriorityQueue

from volcano_tpu_torch.actions.sweep import SpecCache, heap_best
from volcano_tpu_torch.actions.util import (
    predicate_nodes,
    prioritize_nodes,
    split_by_fit,
)

log = logging.getLogger(__name__)


def _record_insufficient(job, task, fit_nodes, spec_memo) -> None:
    """Per-node insufficient-resource fit errors for a task whose
    predicates passed but that fit NO node's idle or future-idle
    (the `1 node(s) Insufficient cpu`-style histogram).  fit_nodes
    may be the cached dict form ({name: node}) or a list.  The
    histogram is identical across a gang's identical siblings, so it
    is computed once per task_spec and replayed (the future_idle
    clone per node is the expensive part)."""
    entries = spec_memo.get(task.task_spec) if task.task_spec else None
    if entries is None:
        nodes = (fit_nodes.values() if isinstance(fit_nodes, dict)
                 else fit_nodes)
        entries = []
        for node in nodes:
            missing = node.future_idle().fit_delta(task.resreq)
            dims = ", ".join(sorted(missing.res)) or "resources"
            entries.append((node.name, f"Insufficient {dims}"))
        if task.task_spec:
            spec_memo[task.task_spec] = entries
    for node_name, reason in entries:
        job.record_fit_error(task, node_name, FitError(
            task, node_name, statuses=[unschedulable(reason)]))


class AllocateAction(Action):
    name = "allocate"

    def execute(self, ssn) -> None:
        enqueue_configured = "enqueue" in ssn.conf.actions

        jobs_per_queue: Dict[str, PriorityQueue] = {}
        shard_plan = self._subtree_plan(ssn)
        for job in ssn.jobs.values():
            if shard_plan is not None and not job.tasks_in_status(
                    TaskStatus.BINDING):
                # partitioned schedulers: every pending job has ONE
                # home shard driving its placement (stable hash, so
                # all shards agree without coordination).  The home
                # shard spills cross-subtree when its own subtrees
                # can't seat the gang; only those optimistic spills
                # ever race another shard, and the server's
                # check-and-bind arbitrates them.  A job with BINDING
                # tasks stays with whoever started it this cycle.
                from volcano_tpu_torch import shardmap
                idx, count = shard_plan
                if shardmap.home_shard(job.key, count) != idx:
                    continue
            if not self._job_eligible(ssn, job, enqueue_configured):
                continue
            queue = ssn.queues.get(job.queue)
            if queue is None or not queue.is_open():
                continue
            jobs_per_queue.setdefault(
                queue.name, PriorityQueue(ssn.job_order_fn)).push(job)

        queues = PriorityQueue(ssn.queue_order_fn,
                               (ssn.queues[qn] for qn in jobs_per_queue))
        while not queues.empty():
            queue = queues.pop()
            if ssn.overused(queue):
                log.debug("queue %s overused, skipping", queue.name)
                continue
            jobs = jobs_per_queue[queue.name]
            if jobs.empty():
                continue
            job = jobs.pop()
            # per-job child span: the trace's unit of latency
            # attribution (predicate/score aggregates land under it)
            with trace.span(job.key, kind="job", job=job.key,
                            queue=queue.name):
                self._allocate_job(ssn, queue, job)
            from volcano_tpu_torch.api.queue import DEQUEUE_FIFO
            if queue.queue.dequeue_strategy == DEQUEUE_FIFO and \
                    not ssn.job_ready(job):
                # strict FIFO: the head job blocks the queue until it
                # schedules (Queue.dequeueStrategy, types.go:459-519);
                # "traverse" (default behavior here) moves on
                log.debug("queue %s fifo head %s not ready; queue blocked",
                          queue.name, job.key)
                continue
            queues.push(queue)

    @staticmethod
    def _job_eligible(ssn, job: JobInfo, enqueue_configured: bool) -> bool:
        if not job.tasks_in_status(TaskStatus.PENDING):
            return False
        result = ssn.job_valid(job)
        if result is not None:
            ssn.set_job_pending_reason(job, result[0], result[1])
            return False
        if job.podgroup is not None and enqueue_configured and \
                job.podgroup.phase is PodGroupPhase.PENDING:
            # not admitted by enqueue yet (allocate.go:153-164)
            return False
        return True

    def _allocate_job(self, ssn, queue, job: JobInfo) -> None:
        if job.has_topology_constraint() and ssn.hypernodes is not None and \
                len(ssn.hypernodes.members) > 1:
            from volcano_tpu_torch.actions.topology_alloc import allocate_for_topology_job
            allocate_for_topology_job(ssn, queue, job)
            return

        stmt = ssn.statement()
        own_shard, mode = self._shard_view(ssn)
        if own_shard is not None:
            shard_nodes = [n for n in ssn.nodes.values()
                           if n.name in own_shard]
            self._allocate_tasks(ssn, queue, job, stmt, shard_nodes)
            if mode == "soft" and job.tasks_in_status(TaskStatus.PENDING):
                # spill what didn't fit the shard onto the full cluster
                self._allocate_tasks(ssn, queue, job, stmt,
                                     list(ssn.nodes.values()),
                                     record_errors=False)
        else:
            self._allocate_tasks(ssn, queue, job, stmt,
                                 list(ssn.nodes.values()))
        self._finish(ssn, job, stmt)

    @staticmethod
    def _subtree_plan(ssn):
        """(shard_index, shard_count) when the subtree partition is
        on (``shard-mode: subtree`` + a shard-count > 1), else None."""
        conf = ssn.conf.configurations.get("allocate", {})
        if str(conf.get("shard-mode", "none")) != "subtree":
            return None
        try:
            idx = int(conf.get("shard-index", 0))
            count = int(conf.get("shard-count", 1))
        except (TypeError, ValueError):
            return None
        if count <= 1 or not 0 <= idx < count:
            return None
        return idx, count

    @staticmethod
    def _shard_view(ssn):
        """(own shard node set, mode) — None when sharding is off.

        Candidate-node gradient by shard (allocate.go:886-919): hard
        restricts to the scheduler's NodeShard; soft prefers it.
        ``subtree`` mode instead derives ownership from the
        deterministic topology-subtree partition (volcano_tpu_torch/
        shardmap.py) shared with the keyspace-partitioned write plane;
        its spill gradient (``shard-spill``, default soft) is what
        makes cross-subtree gangs optimistic rather than stuck.
        """
        conf = ssn.conf.configurations.get("allocate", {})
        mode = str(conf.get("shard-mode", "none"))
        if mode == "subtree":
            plan = AllocateAction._subtree_plan(ssn)
            if plan is None:
                return None, "none"
            from volcano_tpu_torch import shardmap
            idx, count = plan
            own = shardmap.owned_nodes(
                shardmap.subtree_map(ssn.nodes.values()), count, idx)
            ssn.cache.shard_plan = f"{idx}/{count}"
            spill = str(conf.get("shard-spill", "soft"))
            return (own or None), \
                (spill if spill in ("soft", "hard") else "soft")
        if mode not in ("soft", "hard"):
            return None, "none"
        from volcano_tpu_torch.controllers.sharding import shard_nodes_for
        own = shard_nodes_for(ssn.cache.cluster,
                              ssn.cache.scheduler_name)
        if not own:
            return None, mode
        return set(own), mode

    def _finish(self, ssn, job: JobInfo, stmt) -> None:
        if ssn.job_ready(job):
            stmt.commit()
        elif ssn.job_pipelined(job):
            # keep reservations in-session; pods wait on releasing nodes
            pass
        else:
            stmt.discard()
            if job.fit_errors:
                errs = FitErrors()
                errs.set_error(job.fit_error())
                job.set_job_fit_errors(errs)
            ssn.set_job_pending_reason(
                job, "Unschedulable",
                job.fit_error() or
                f"job {job.key} not ready: {job.ready_task_num()}/"
                f"{job.min_available} tasks allocatable")

    @staticmethod
    def _allocate_tasks(ssn, queue, job: JobInfo, stmt,
                        candidate_nodes, record_errors: bool = True,
                        task_filter=None) -> int:
        """Try to place every pending non-best-effort task of *job* onto
        *candidate_nodes* (optionally restricted by *task_filter*).
        Returns number placed."""
        if task_filter is None:
            # gangCommit: batch — drain whole specs over the cached
            # sweep instead of walking pod-at-a-time; None means the
            # batch contract cannot hold and the walk below runs.
            # (task_filter is how the batch path delegates its own
            # non-cacheable leftovers here — never re-enter on it.)
            from volcano_tpu_torch.actions import gangcommit
            if gangcommit.enabled(ssn):
                placed = gangcommit.allocate_tasks_batched(
                    ssn, queue, job, stmt, candidate_nodes,
                    record_errors)
                if placed is not None:
                    return placed
        tasks = PriorityQueue(ssn.task_order_fn)
        for task in job.tasks_in_status(TaskStatus.PENDING):
            if task.best_effort:
                continue
            if task_filter is not None and not task_filter(task):
                continue
            tasks.push(task)

        placed = 0
        failed_specs = set()
        # A plugin with task-identity-dependent predicates (extender)
        # makes cached verdicts unsound: fall back to per-task sweeps.
        cache_enabled = not ssn.task_dependent_predicates

        def task_cacheable(task) -> bool:
            # bare pods default to spec "": they may be heterogeneous,
            # so only named (controller-stamped, identical) specs cache
            return cache_enabled and bool(task.task_spec)
        # Per-spec predicate/score/fit-class cache with single-node
        # invalidation + optional parallel leaf-shard sweep — the
        # machinery lives in actions/sweep.py (SpecCache) so the
        # static race pass can name the reader call tree and the
        # thread-pool pilot can fan it out over the frozen snapshot.
        cache = SpecCache(ssn, candidate_nodes, record_errors)
        use_heap = cache.use_heap
        has_grouped = cache.has_grouped
        insufficient_memo: Dict[str, list] = {}
        spec_error_rep: Dict[str, str] = {}   # failed spec -> task uid

        for task in tasks:
            t_task = time.perf_counter()
            if task.task_spec in failed_specs:
                # identical spec already failed everywhere this round
                # (fit-error memoization, allocate.go TaskHasFitErrors).
                # Share the representative's recorded errors so the
                # sibling is REPORTED as a blocker too, not mislabeled
                # Schedulable by the reason publisher
                if record_errors:
                    rep = spec_error_rep.get(task.task_spec)
                    if rep is not None and rep in job.fit_errors:
                        job.fit_errors.setdefault(
                            task.uid, job.fit_errors[rep])
                continue
            if not ssn.allocatable(queue, task):
                # skip just this task: a smaller sibling may still fit the
                # queue's share (allocate.go:744-747 uses continue).
                # RECORD the reason: without it the pod shows nothing
                # at all (scheduling-reason.md)
                if record_errors:
                    errs = job.fit_errors.setdefault(task.uid,
                                                     FitErrors())
                    errs.set_error(f"task would exceed queue "
                                   f"{queue.name}'s deserved share")
                log.debug("queue %s quota exhausted for task %s",
                          queue.name, task.key)
                continue

            status = ssn.pre_predicate(task)
            if status is not None:
                if record_errors:
                    job.record_fit_error(task, "",
                                         FitError(task, None,
                                                  statuses=[status]))
                    spec_error_rep.setdefault(task.task_spec, task.uid)
                failed_specs.add(task.task_spec)
                continue

            if task_cacheable(task):
                entry = cache.get(task.task_spec) or \
                    cache.build_entry(task)
                if use_heap:
                    # O(groups log n) pick straight off the cached heaps
                    group_scores = (ssn.grouped_batch_node_order(task)
                                    if has_grouped else None)
                    node = heap_best(entry, "idle", group_scores)
                    pipelined = False
                    if node is None:
                        node = heap_best(entry, "future", group_scores)
                        pipelined = node is not None
                    fit_nodes = entry["fits"]   # truthiness check below
                else:
                    fit_nodes = list(entry["fits"].values())
                    idle_fit, future_fit = split_by_fit(task, fit_nodes)
                    node = prioritize_nodes(ssn, task, idle_fit,
                                            base_scores=entry["scores"])
                    pipelined = False
                    if node is None:
                        node = prioritize_nodes(
                            ssn, task, future_fit,
                            base_scores=entry["scores"])
                        pipelined = node is not None
            else:
                fit_nodes = predicate_nodes(ssn, task, candidate_nodes,
                                            record_errors)
                idle_fit, future_fit = split_by_fit(task, fit_nodes)
                node = prioritize_nodes(ssn, task, idle_fit)
                pipelined = False
                if node is None:
                    node = prioritize_nodes(ssn, task, future_fit)
                    pipelined = node is not None
            if node is not None:
                if pipelined:
                    stmt.pipeline(task, node)
                else:
                    stmt.allocate(task, node)
                placed += 1
                metrics.observe("task_scheduling_latency_seconds",
                                time.perf_counter() - t_task,
                                action="allocate")
                cache.invalidate(node)
                continue

            if record_errors:
                if not fit_nodes:
                    failed_specs.add(task.task_spec)
                    spec_error_rep.setdefault(task.task_spec, task.uid)
                else:
                    # predicates passed somewhere but nothing had the
                    # resources (now or releasing): without an explicit
                    # record the task shows NO reason at all — the
                    # reference surfaces per-node "Insufficient cpu"
                    # entries here (node_info.go FutureIdle checks)
                    _record_insufficient(job, task, fit_nodes,
                                         insufficient_memo)
        return placed


register_action(AllocateAction())

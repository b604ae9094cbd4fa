"""Hard network-topology allocation: gradient search over hypernodes.

Reference parity: actions/allocate/allocate.go:370-463 (per-gradient,
per-hypernode dry-run with Statement discard/recover, committing the
best domain) + network-topology-aware gradient production + subgroup
domains (SubJobInfo.AllocatedHyperNode, sub_job_info.go:40).

GPU semantics: gradients are tier buckets ordered by NVLink closeness
— tier 1 (single NVLink domain) first, then InfiniBand tiers up to the
job's highestTierAllowed.  Within a tier, domains are ordered by the
HyperNodeOrder plugin score (domain binpack + job affinity).  A job
with subGroupPolicies places each subgroup in its own domain (e.g. one
NVLink domain per data-parallel replica) using statement savepoints, so
a multi-domain training job gets per-domain gang placement in one
pass.
"""

from __future__ import annotations

import logging
from typing import List, Optional

from volcano_tpu_torch.api.job_info import JobInfo, SubJobInfo
from volcano_tpu_torch.api.types import TaskStatus

log = logging.getLogger(__name__)


def candidate_domains(ssn, job: JobInfo,
                      max_tier: Optional[int] = None) -> List[List[str]]:
    """Tier-bucketed candidate hypernode domains (the 'gradients'),
    closest tier first, best-scored first within a tier."""
    if max_tier is None:
        nt = job.network_topology
        max_tier = nt.highest_tier_allowed if nt else None
    if max_tier is None:    # unbounded: every tier, lowest first
        max_tier = max(ssn.hypernodes.tiers, default=1)
    gradients = []
    for tier in ssn.hypernodes.tiers:
        if tier > max_tier:
            break
        names = [h.name for h in ssn.hypernodes.at_tier(tier) if h.nodes]
        if not names:
            continue
        scores = ssn.hyper_node_order(job, names)
        names.sort(key=lambda n: (-scores.get(n, 0.0), n))
        gradients.append(names)
    return gradients


def allocate_for_topology_job(ssn, queue, job: JobInfo) -> bool:
    sub_jobs = [s for s in job.sub_jobs.values()
                if s.name and s.min_member > 0]
    if sub_jobs:
        return _allocate_per_subjob(ssn, queue, job, sub_jobs)
    return _allocate_whole_job(ssn, queue, job)


def _domain_nodes(ssn, domain_name: str):
    info = ssn.hypernodes.members.get(domain_name)
    if info is None:
        return []
    return [ssn.nodes[n] for n in info.nodes if n in ssn.nodes]


def _allocate_whole_job(ssn, queue, job: JobInfo) -> bool:
    """Dry-run the whole job into candidate domains; commit the first
    (tier-closest, best-scored) domain where the gang becomes ready."""
    from volcano_tpu_torch.actions.allocate import AllocateAction

    # Nomination fast path: gangpreempt pinned a domain last cycle.
    nominated = {sub.nominated_hypernode
                 for sub in job.sub_jobs.values() if sub.nominated_hypernode}
    gradients = candidate_domains(ssn, job)
    if nominated:
        gradients.insert(0, sorted(nominated))

    for gradient in gradients:
        for domain_name in gradient:
            nodes = _domain_nodes(ssn, domain_name)
            if not nodes:
                continue
            stmt = ssn.statement()
            AllocateAction._allocate_tasks(ssn, queue, job, stmt, nodes,
                                           record_errors=False)
            if ssn.job_ready(job):
                for sub in job.sub_jobs.values():
                    sub.allocated_hypernode = domain_name
                    sub.nominated_hypernode = ""
                job.persist_nominations()
                stmt.commit()
                log.debug("topology job %s committed into domain %s",
                          job.key, domain_name)
                return True
            if ssn.job_pipelined(job):
                # gang becomes ready once this domain's releasing
                # resources free up — keep the reservations in-session
                return True
            stmt.discard()

    return _fail(ssn, job)


def _allocate_per_subjob(ssn, queue, job: JobInfo,
                         sub_jobs: List[SubJobInfo]) -> bool:
    """Place each subgroup into its own hypernode domain (its topology
    constraint, falling back to the job's), all within one statement
    with per-subgroup savepoints."""
    from volcano_tpu_torch.actions.allocate import AllocateAction

    stmt = ssn.statement()
    chosen = {}
    # name order for determinism, SubJobOrder plugins take precedence
    ordered = sorted(sorted(sub_jobs, key=lambda s: s.name),
                     key=_cmp_key(ssn))

    for sub in ordered:
        pending = [t for t in sub.tasks.values()
                   if t.status is TaskStatus.PENDING and not t.best_effort]
        if not pending:
            continue  # nothing to place; keep its allocated_hypernode
        nt = sub.network_topology or job.network_topology
        # nt present but tier None = explicitly unbounded; resolve here
        # so candidate_domains doesn't fall back to the job-level cap
        if nt is None:
            max_tier = None
        elif nt.highest_tier_allowed is None:
            max_tier = max(ssn.hypernodes.tiers, default=1)
        else:
            max_tier = nt.highest_tier_allowed
        placed = False
        gradients = candidate_domains(ssn, job, max_tier=max_tier)
        # sticky placement: an already-allocated subgroup scales up in
        # its own domain first; nominations next
        for pinned in (sub.nominated_hypernode, sub.allocated_hypernode):
            if pinned:
                gradients.insert(0, [pinned])
        for gradient in gradients:
            for domain_name in gradient:
                nodes = _domain_nodes(ssn, domain_name)
                if not nodes:
                    continue
                mark = len(stmt.operations)
                AllocateAction._allocate_tasks(
                    ssn, queue, job, stmt, nodes, record_errors=False,
                    task_filter=lambda t, s=sub: t.sub_job == s.name)
                # a domain counts only if it actually took new tasks
                # (a satisfied gang floor must not claim a full domain)
                if len(stmt.operations) > mark and \
                        (sub.is_ready() or sub.is_pipelined()):
                    chosen[sub.name] = domain_name
                    placed = True
                    break
                stmt.rollback_to(mark)
            if placed:
                break
        if not placed:
            if sub.is_ready():
                continue  # floor already met; extras wait for capacity
            stmt.discard()
            return _fail(ssn, job, subjob=sub.name)

    # tasks outside any policed subgroup may go anywhere in the cluster
    policed = {s.name for s in sub_jobs}
    AllocateAction._allocate_tasks(
        ssn, queue, job, stmt, list(ssn.nodes.values()),
        record_errors=False, task_filter=lambda t: t.sub_job not in policed)

    if ssn.job_ready(job):
        for sub in job.sub_jobs.values():
            if sub.name in chosen and not sub.allocated_hypernode:
                sub.allocated_hypernode = chosen[sub.name]
            if sub.name in chosen:
                sub.nominated_hypernode = ""
        job.persist_nominations()
        stmt.commit()
        log.debug("multi-domain job %s committed: %s", job.key, chosen)
        return True
    if ssn.job_pipelined(job):
        # keep in-session reservations on releasing resources, exactly
        # like the non-topology path (allocate.py _finish)
        return True
    stmt.discard()
    return _fail(ssn, job)


def _cmp_key(ssn):
    import functools

    def cmp(a, b):
        if ssn.sub_job_order_fn(a, b):
            return -1
        if ssn.sub_job_order_fn(b, a):
            return 1
        return 0
    return functools.cmp_to_key(cmp)


def _fail(ssn, job: JobInfo, subjob: str = "") -> bool:
    # clear stale nominations that failed validation (allocate.go:595-717)
    for sub in job.sub_jobs.values():
        sub.nominated_hypernode = ""
    job.persist_nominations()
    nt = job.network_topology
    if subjob:
        sub = job.sub_jobs.get(subjob)
        if sub is not None and sub.network_topology is not None:
            nt = sub.network_topology   # the binding constraint
    where = f"subgroup {subjob} of " if subjob else ""
    tier = nt.highest_tier_allowed if nt else None
    cap = "at any tier" if tier is None else f"within tier {tier}"
    ssn.set_job_pending_reason(
        job, "Unschedulable",
        f"no hypernode domain {cap} can hold {where}job "
        f"{job.key} (minAvailable={job.min_available})")
    return False

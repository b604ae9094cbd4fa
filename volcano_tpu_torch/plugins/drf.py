"""DRF plugin — dominant resource fairness across jobs.

Reference parity: plugins/drf/drf.go:263-391 (job share = max over
dimensions of allocated/cluster-total; order jobs by share; victims
from higher-share jobs).
"""

from __future__ import annotations

import logging
from itertools import zip_longest
from typing import Dict, List

from volcano_tpu_torch.api.job_info import JobInfo, TaskInfo
from volcano_tpu_torch.api.resource import MIN_RESOURCE, Resource
from volcano_tpu_torch.framework.plugins import Plugin, register_plugin
from volcano_tpu_torch.framework.session import EventHandler

log = logging.getLogger(__name__)


def _hierarchy_annotations(queue):
    """(path string, weights string) from a session QueueInfo (raw
    Queue underneath) or a raw Queue in unit seams."""
    raw = getattr(queue, "queue", queue)
    anns = getattr(raw, "annotations", {})
    from volcano_tpu_torch.webhooks.admission import (
        HIERARCHY_ANNOTATION, HIERARCHY_WEIGHTS_ANNOTATION)
    return (anns.get(HIERARCHY_ANNOTATION, ""),
            anns.get(HIERARCHY_WEIGHTS_ANNOTATION, ""))


class _JobAttr:
    __slots__ = ("allocated", "share")

    def __init__(self):
        self.allocated = Resource()
        self.share = 0.0


@register_plugin("drf")
class DRFPlugin(Plugin):
    name = "drf"

    def __init__(self, arguments=None):
        super().__init__(arguments)
        self.attrs: Dict[str, _JobAttr] = {}
        self.queue_attrs: Dict[str, _JobAttr] = {}
        self.total = Resource()
        # hdrf: hierarchical mode compares root-to-leaf queue-path
        # shares (reference drf.go hierarchical; conflicts with
        # proportion per pkg/scheduler/util.go:78-80)
        self.hierarchy = bool(self.arguments.get("drf.enable-hierarchy",
                                                 False))
        self._queues = {}
        # per-level hierarchy weights (drf.go:462-470: annotation
        # segments align with the path; node order compares
        # share/weight, not raw share)
        self._qweights: Dict[str, float] = {}

    def on_session_open(self, ssn):
        self.total = ssn.total_resource
        self._queues = ssn.queues
        if self.hierarchy:
            # parse EVERY queue's weight annotation once, before any
            # comparison: lazy per-chain parsing would let sibling
            # queues that disagree about an ancestor's weight rewrite
            # _qweights mid-sort, making the comparator inconsistent
            # (result depends on argument order).  First declaration
            # wins for the session; conflicts are logged once.
            self._qweights = {}
            for q in self._queues.values():
                self._parse_weights(q)
        for job in ssn.jobs.values():
            attr = _JobAttr()
            attr.allocated = job.allocated()
            self._update_share(attr)
            self.attrs[job.uid] = attr
            if self.hierarchy:
                for qname in self._queue_chain(job.queue):
                    qattr = self.queue_attrs.setdefault(qname, _JobAttr())
                    qattr.allocated.add(attr.allocated)
        for qattr in self.queue_attrs.values():
            self._update_share(qattr)
        # job_share gauges (reference metrics/job.go, drf-updated);
        # swapped atomically so vanished jobs drop without a scrape
        # ever seeing a half-cleared family
        from volcano_tpu_torch import metrics
        rows = []
        for uid, attr in self.attrs.items():
            job = ssn.jobs.get(uid)
            if job is not None:
                rows.append(("job_share",
                             {"job": f"{job.namespace}/{job.name}"
                              if job.name else uid}, attr.share))
        metrics.swap_gauge_families({"job_share"}, rows)

        ssn.add_job_order_fn(self.name, self._job_order)
        if self.hierarchy:
            ssn.add_queue_order_fn(self.name, self._queue_order)
        ssn.add_preemptable_fn(self.name, self._preemptable(ssn))
        ssn.add_event_handler(EventHandler(
            allocate_fn=lambda e: self._on_event(e, +1, ssn),
            deallocate_fn=lambda e: self._on_event(e, -1, ssn)))

    def _queue_chain(self, queue_name: str):
        """leaf -> root path of queue names (cycle-safe).

        Two hierarchy sources, matching the reference's dual model:
        the queue `parent` field (capacity-style tree), or the
        reference-style hierarchy ANNOTATION (`root/eng/ml`, rooted by
        the queue mutate webhook — drf.go hierarchicalQueue).  The
        annotation wins when present; its intermediate segments need
        not exist as Queue objects."""
        queue = self._queues.get(queue_name)
        chain = None
        if queue is not None:
            path, _ = _hierarchy_annotations(queue)
            segs = [s for s in path.split("/") if s]
            if segs:
                if segs[-1] != queue_name:
                    segs.append(queue_name)
                chain = list(reversed(segs))
        if chain is None:
            chain, seen = [], set()
            cur = queue_name
            while cur and cur not in seen and cur in self._queues:
                chain.append(cur)
                seen.add(cur)
                cur = self._queues[cur].parent
        # EVERY chain ends at the shared synthetic root, whichever
        # hierarchy source produced it — _path_shares compares these
        # vectors element-wise from the root end, so an unrooted chain
        # would misalign every comparison against a rooted one
        if chain and chain[-1] != "root":
            chain.append("root")
        return chain

    def _parse_weights(self, queue):
        """Session-open weight harvest for one queue: the weights
        annotation aligns root->leaf with the hierarchy path
        (drf.go:462-470); clamp to >=1.  Alignment is done on the
        RAW splits (an empty path segment drops its weight in
        tandem); an unrooted weight list beside a rooted path gets
        root weight 1 prepended — the same recovery mutate_queue
        applies — and any residual count mismatch is logged, not
        silently zip-truncated."""
        path, wstr = _hierarchy_annotations(queue)
        if not path or not wstr:
            return
        bad = False
        pairs = []
        for s, w in zip_longest(path.split("/"), wstr.split("/"),
                                fillvalue=""):
            if s:
                pairs.append((s, w))
            elif w:
                bad = True      # surplus weight with no path level
        if len(pairs) > 1 and pairs[0][0] == "root" and \
                not pairs[-1][1] and pairs[0][1] != "1":
            # rooted path + unrooted weights ('root/eng' + '3'):
            # shift weights down one level, root defaults to 1
            ws = [w for _, w in pairs]
            pairs = [(pairs[0][0], "1")] + \
                [(s, w) for (s, _), w in zip(pairs[1:], ws)]
        # weights key on the FULL path prefix, not the bare segment
        # name (reference drf.go buildHierarchy keys per hierarchy
        # NODE): 'root/a/team' and 'root/b/team' are different nodes
        # that may legitimately carry different weights — a bare-name
        # map collided them, first declaration silently winning.
        # Unrooted unit-seam annotations are aligned under the same
        # synthetic root _queue_chain appends.
        prefix = [] if pairs and pairs[0][0] == "root" else ["root"]
        for name, w in pairs:
            prefix.append(name)
            if not w:
                bad = True
                continue
            try:
                val = max(1.0, float(w))
            except ValueError:
                bad = True
                continue
            path_key = "/".join(prefix)
            prev = self._qweights.setdefault(path_key, val)
            if prev != val:
                log.warning(
                    "hdrf: conflicting weight for %r (%s vs %s); "
                    "keeping %s", path_key, prev, val, prev)
        if bad:
            log.warning(
                "hdrf: weights %r do not align with path %r on "
                "queue %s; unmatched levels default to weight 1",
                wstr, path, getattr(queue, "name", "?"))

    def _path_shares(self, queue_name: str):
        """Root-to-leaf share/weight vector for hierarchical
        comparison — a weight-3 sibling tolerates 3x the share of a
        weight-1 one before losing priority (drf.go:174).  Weight
        lookup is by path PREFIX ('root/a/team'), matching
        _parse_weights' keying, so a segment name reused in two
        subtrees resolves to its own node's weight."""
        shares = []
        prefix = []
        for q in reversed(self._queue_chain(queue_name)):
            prefix.append(q)
            if q in self.queue_attrs:
                shares.append(
                    self.queue_attrs[q].share
                    / self._qweights.get("/".join(prefix), 1.0))
        return shares

    def _queue_order(self, a, b) -> int:
        sa, sb = self._path_shares(a.name), self._path_shares(b.name)
        return -1 if sa < sb else (1 if sb < sa else 0)

    def _update_share(self, attr: _JobAttr):
        share = 0.0
        for dim, alloc in attr.allocated.res.items():
            t = self.total.get(dim)
            if t > MIN_RESOURCE:
                share = max(share, alloc / t)
        attr.share = share

    def _job_order(self, a: JobInfo, b: JobInfo) -> int:
        if self.hierarchy and a.queue != b.queue:
            sa, sb = self._path_shares(a.queue), self._path_shares(b.queue)
            if sa != sb:
                return -1 if sa < sb else 1
        sa = self.attrs[a.uid].share if a.uid in self.attrs else 0.0
        sb = self.attrs[b.uid].share if b.uid in self.attrs else 0.0
        return -1 if sa < sb else (1 if sb < sa else 0)

    def _preemptable(self, ssn):
        def fn(preemptor: TaskInfo, candidates: List[TaskInfo]):
            p_attr = self.attrs.get(preemptor.job)
            if p_attr is None:
                return None
            victims = []
            # simulate each victim's job share after eviction; only
            # victims whose post-eviction share stays above the
            # preemptor's share qualify (drf.go latest-share compare)
            shares: Dict[str, Resource] = {}
            for t in candidates:
                v_attr = self.attrs.get(t.job)
                if v_attr is None:
                    continue
                alloc = shares.get(t.job)
                if alloc is None:
                    alloc = v_attr.allocated.clone()
                    shares[t.job] = alloc
                alloc.sub_unchecked(t.resreq)
                tmp = _JobAttr()
                tmp.allocated = alloc
                self._update_share(tmp)
                if tmp.share >= p_attr.share:
                    victims.append(t)
                else:
                    alloc.add(t.resreq)  # roll back: would over-shoot
            return victims
        return fn

    def _on_event(self, event, sign: int, ssn=None):
        attr = self.attrs.get(event.task.job)
        if attr is None:
            return
        if sign > 0:
            attr.allocated.add(event.task.resreq)
        else:
            attr.allocated.sub_unchecked(event.task.resreq)
        self._update_share(attr)
        if self.hierarchy and ssn is not None:
            job = ssn.jobs.get(event.task.job)
            if job is not None:
                for qname in self._queue_chain(job.queue):
                    qattr = self.queue_attrs.get(qname)
                    if qattr is None:
                        continue
                    if sign > 0:
                        qattr.allocated.add(event.task.resreq)
                    else:
                        qattr.allocated.sub_unchecked(event.task.resreq)
                    self._update_share(qattr)

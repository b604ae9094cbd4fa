"""In-process fake cluster — the apiserver + kubelet stand-in.

Plays the role the reference fills with Kind+KWOK fake nodes
(benchmark/scripts/create-kwok-nodes.sh) and with the mock cache in unit
tests (pkg/scheduler/cache/cache_mock.go): holds the CRD objects,
accepts binds/evictions, and simulates pod lifecycle transitions so
controllers and the scheduler can be exercised end-to-end with zero real
machines.  Thread-safe: the scheduler loop and controllers may share it.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from volcano_tpu_torch.api.hypernode import HyperNode
from volcano_tpu_torch.api.node_info import Node
from volcano_tpu_torch.api.pod import Pod
from volcano_tpu_torch.api.podgroup import PodGroup
from volcano_tpu_torch.api.queue import Queue
from volcano_tpu_torch.api.types import (DEFAULT_QUEUE, RUN_TICKS_ANNOTATION,
                                   TaskStatus)
from volcano_tpu_torch.cache.cluster import Cluster, ClusterSnapshot, PriorityClass


class FakeCluster(Cluster):
    def __init__(self, admission=None):
        self._lock = threading.RLock()
        self.pods: Dict[str, Pod] = {}            # key: ns/name
        self.nodes: Dict[str, Node] = {}
        self.podgroups: Dict[str, PodGroup] = {}  # key: ns/name
        self.queues: Dict[str, Queue] = {DEFAULT_QUEUE: Queue(name=DEFAULT_QUEUE)}
        self.hypernodes: Dict[str, HyperNode] = {}
        self.priority_classes: Dict[str, PriorityClass] = {}
        self.vcjobs: Dict[str, object] = {}       # key: ns/name -> VCJob
        self.commands: List[dict] = []            # bus/v1alpha1 analogue
        # namespace -> annotations (the podgroup mutate webhook reads
        # the namespace's default-queue annotation from here)
        self.namespaces: Dict[str, Dict[str, str]] = {}
        self.jobflows: Dict[str, object] = {}     # flow/v1alpha1 JobFlow
        self.jobtemplates: Dict[str, object] = {} # flow/v1alpha1 JobTemplate
        self.cronjobs: Dict[str, object] = {}     # batch/v1alpha1 CronJob
        self.hyperjobs: Dict[str, object] = {}    # training/v1alpha1 HyperJob
        self.nodeshards: Dict[str, object] = {}   # shard/v1alpha1 NodeShard
        self.numatopologies: Dict[str, object] = {}  # nodeinfo/v1alpha1
        self.bandwidthreports: Dict[str, object] = {}  # api/netusage.py
        self.slicehealthreports: Dict[str, object] = {}  # api/slicehealth.py
        self.goodputreports: Dict[str, object] = {}    # api/goodput.py
        self.servingreports: Dict[str, object] = {}    # api/serving.py
        self.services: Dict[str, dict] = {}       # svc plugin artifacts
        self.config_maps: Dict[str, dict] = {}
        self.secrets: Dict[str, dict] = {}
        self.pvcs: Dict[str, dict] = {}           # volumebinding claims
        self.pvs: Dict[str, dict] = {}            # volumebinding volumes
        self.datasources: Dict[str, dict] = {}    # datadependency/v1alpha1
        self.regions: Dict[str, dict] = {}        # api/federation.py registry
        self.fleet_traces: Dict[str, dict] = {}   # federation/stitch.py docs
        self.router_breakers: Dict[str, dict] = {}  # federation/retry.py snaps
        self.slos: Dict[str, dict] = {}           # federation/slo.py doc
        self.events: List[Tuple[str, str, str]] = []
        self._run_progress: Dict[str, int] = {}   # pod uid -> ticks run
        self.binds: List[Tuple[str, str]] = []    # (pod key, node) history
        self.evictions: List[str] = []
        # admission chain applied on vcjob/queue create (webhooks)
        self.admission = admission
        # leader-election lease CAS + fencing-token floors: the
        # in-process analogue of StateServer.lease/advance_fence so
        # elections (router HA, sharded schedulers) unit-test with
        # zero wire.  lease_now is injectable: tests drive expiry
        # with a fake clock instead of sleeping out real TTLs.
        self.lease_now: Callable[[], float] = time.monotonic
        self._fake_leases: Dict[str, list] = {}  # name->[holder,exp,term]
        self._lease_terms: Dict[str, int] = {}
        self._fences: Dict[str, int] = {}
        self._fenced_counts: Dict[str, int] = {}
        # watchers notified on any mutation (controllers use this)
        self._watchers: List[Callable[[str, object], None]] = []

    # picklable for CLI state files: locks and watcher callbacks are
    # process-local and recreated on load
    def __getstate__(self):
        state = self.__dict__.copy()
        state.pop("_lock", None)
        state.pop("_watchers", None)
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._lock = threading.RLock()
        self._watchers = []
        # stores added after old state files were written
        from volcano_tpu_torch.cache.kinds import KINDS
        self.__dict__.setdefault("commands", [])
        self.__dict__.setdefault("_run_progress", {})
        self.__dict__.setdefault("lease_now", time.monotonic)
        self.__dict__.setdefault("_fake_leases", {})
        self.__dict__.setdefault("_lease_terms", {})
        self.__dict__.setdefault("_fences", {})
        self.__dict__.setdefault("_fenced_counts", {})
        for spec in KINDS.values():
            self.__dict__.setdefault(spec.attr, {})

    # -- mutation helpers (the "kubectl" surface) ----------------------

    def add_node(self, node: Node):
        with self._lock:
            self.nodes[node.name] = node
        self._notify("node", node)

    def remove_node(self, name: str):
        with self._lock:
            node = self.nodes.pop(name, None)
        if node:
            self._notify("node_deleted", node)
            # same lifetime rule as delete_object("node"): the node's
            # agent reports die with it
            for kind, attr in (("bandwidthreport", "bandwidthreports"),
                               ("slicehealthreport",
                                "slicehealthreports"),
                               ("goodputreport", "goodputreports"),
                               ("servingreport", "servingreports")):
                with self._lock:
                    had = name in getattr(self, attr)
                if had:
                    self.delete_object(kind, name)

    def add_pod(self, pod: Pod):
        if self.admission is not None and pod.key not in self.pods:
            pod = self.admission.admit_pod(pod, self)
        from volcano_tpu_torch import trace
        # store-side lifecycle stamp (first writer wins, so a retried
        # create keeps the original timestamp) — the `created` anchor
        # of the e2e phase decomposition (docs/design/tracing.md)
        trace.stamp_phase(pod.annotations, "created")
        with self._lock:
            self.pods[pod.key] = pod
        self._notify("pod", pod)

    def delete_pod(self, key: str):
        with self._lock:
            pod = self.pods.pop(key, None)
            if pod:
                self._run_progress.pop(pod.uid, None)
        if pod:
            self._notify("pod_deleted", pod)

    def add_podgroup(self, pg: PodGroup):
        from volcano_tpu_torch import trace
        trace.stamp_phase(pg.annotations, "created")
        with self._lock:
            self.podgroups[pg.key] = pg
        self._notify("podgroup", pg)

    def delete_podgroup(self, key: str):
        with self._lock:
            pg = self.podgroups.pop(key, None)
        if pg:
            self._notify("podgroup_deleted", pg)

    def add_queue(self, queue: Queue):
        with self._lock:
            self.queues[queue.name] = queue
        self._notify("queue", queue)

    def add_hypernode(self, hn: HyperNode):
        with self._lock:
            self.hypernodes[hn.name] = hn
        self._notify("hypernode", hn)

    def add_numatopology(self, topo):
        with self._lock:
            self.numatopologies[topo.name] = topo
        self._notify("numatopology", topo)

    # -- command bus (bus/v1alpha1 Command CRD analogue) ---------------

    def add_command(self, target_key: str, action: str):
        """Queue a delegated action (abort/resume/restart/...) against a
        vcjob; the job controller consumes and deletes it.  The cid
        uniquely names this command so the state server's WAL can
        journal a drain as the exact set it consumed — replay is then
        order-independent of add events whose journal records raced
        the drain's (docs/design/durability.md)."""
        import uuid
        cmd = {"target": target_key, "action": action,
               "cid": uuid.uuid4().hex[:12]}
        with self._lock:
            self.commands.append(cmd)
        self._notify("command", cmd)

    def drain_commands(self, target_key: str):
        with self._lock:
            cmds = getattr(self, "commands", [])
            mine = [c for c in cmds if c["target"] == target_key]
            self.commands = [c for c in cmds if c["target"] != target_key]
        return mine

    # -- vcjobs (admission-gated like the apiserver webhook path) ------

    def add_vcjob(self, job):
        """Create a vcjob; the admission chain (webhooks) mutates then
        validates — a rejection raises before anything is stored."""
        if self.admission is not None:
            job = self.admission.admit_job(job, self)
        with self._lock:
            self.vcjobs[job.key] = job
        self._notify("vcjob", job)
        return job

    def update_vcjob(self, job):
        if self.admission is not None:
            # spec re-validated on update (VERDICT r1: the chain used
            # to run on create only, so a job could be mutated into an
            # invalid spec post-create)
            job = self.admission.admit_job_update(job, self)
        with self._lock:
            self.vcjobs[job.key] = job
        self._notify("vcjob", job)

    def delete_vcjob(self, key: str):
        with self._lock:
            job = self.vcjobs.pop(key, None)
        if job:
            self._notify("vcjob_deleted", job)

    def delete_hypernode(self, name: str):
        with self._lock:
            hn = self.hypernodes.pop(name, None)
        if hn:
            self._notify("hypernode_deleted", hn)

    def add_priority_class(self, pc: PriorityClass):
        with self._lock:
            self.priority_classes[pc.name] = pc
        self._notify("priority_class", pc)

    # -- generic object store ------------------------------------------

    # per-kind admission dispatch (reference router/admission.go:35):
    # create paths run mutate+validate; vcjob updates re-validate spec
    _ADMIT_CREATE = {
        "vcjob": "admit_job", "queue": "admit_queue",
        "podgroup": "admit_podgroup", "hypernode": "admit_hypernode",
        "pod": "admit_pod", "jobflow": "admit_jobflow",
        "cronjob": "admit_cronjob",
    }

    def put_object(self, kind: str, obj, key: Optional[str] = None):
        from volcano_tpu_torch.cache.kinds import KINDS, key_for
        prev_goodput = prev_serving = None
        if kind == "goodputreport":
            # the node's PREVIOUS report is the fold's diff base (the
            # wire carries cumulative ledgers; see _fold_goodput_report)
            with self._lock:
                prev_goodput = self.goodputreports.get(
                    key_for(kind, obj, key))
        elif kind == "servingreport":
            # same cumulative-ledger diff base as goodput
            with self._lock:
                prev_serving = self.servingreports.get(
                    key_for(kind, obj, key))
        if kind == "vcjob" and key is None:
            # keep the admission-gated create path authoritative
            # (an explicit key marks an update/status flush — the
            # create chain must not re-run on those)
            return self.add_vcjob(obj)
        spec = KINDS[kind]
        k = key_for(kind, obj, key)
        if self.admission is not None:
            if k not in getattr(self, spec.attr):
                method = self._ADMIT_CREATE.get(kind)
                if method is not None:
                    obj = getattr(self.admission, method)(obj, self)
            elif kind == "vcjob":
                obj = self.admission.admit_job_update(obj, self)
        if (kind == "pod" and k not in self.pods) or \
                (kind == "podgroup" and k not in self.podgroups):
            from volcano_tpu_torch import trace
            trace.stamp_phase(obj.annotations, "created")
        with self._lock:
            if kind == "node":
                # keep the accounting/health folds sticky: a node
                # write from a mirror that predates a fold (the
                # agent's whole-node persist) must not erase the
                # folded summary — re-apply the stored reports before
                # the write lands.  Read-stick-store under this one
                # lock hold (RLock): a fold racing a dropped-lock
                # stick would still be erased.
                rep = self.bandwidthreports.get(k)
                health = self.slicehealthreports.get(k)
                cur = self.nodes.get(k)
                if rep is not None:
                    self._apply_bandwidth_fold(obj, rep)
                if health is not None:
                    self._apply_health_fold(obj, health)
                if cur is not None:
                    self._apply_quarantine_stick(obj, cur)
            if kind == "podgroup":
                # keep the goodput fold sticky: a whole-podgroup
                # write from a mirror predating a fold (controllers
                # persist podgroups from THEIR copies every sync)
                # must not erase the accumulated accounting.  Read-
                # stick-store under this one lock hold: a fold racing
                # a dropped-lock stick would still be erased.
                cur = self.podgroups.get(k)
                if cur is not None:
                    self._apply_goodput_stick(obj, cur)
                    self._apply_serving_stick(obj, cur)
            getattr(self, spec.attr)[k] = obj
        self._notify(kind, obj if spec.key_of else {"key": k, "obj": obj})
        if kind == "bandwidthreport":
            self._fold_bandwidth_report(obj)
        elif kind == "slicehealthreport":
            self._fold_health_report(obj)
        elif kind == "goodputreport":
            self._fold_goodput_report(obj, prev_goodput)
        elif kind == "servingreport":
            self._fold_serving_report(obj, prev_serving)
        return obj

    @staticmethod
    def _apply_bandwidth_fold(node, report) -> bool:
        """Merge a BandwidthReport's node-level summary into *node*'s
        annotations; returns True when anything changed."""
        from volcano_tpu_torch.api.netusage import (
            NODE_MEASURED_OFFLINE_ANNOTATION,
            NODE_MEASURED_ONLINE_ANNOTATION, NODE_SATURATED_ANNOTATION,
            NODE_VIOLATING_PODS_ANNOTATION)
        ann = node.annotations
        before = (ann.get(NODE_MEASURED_OFFLINE_ANNOTATION),
                  ann.get(NODE_MEASURED_ONLINE_ANNOTATION),
                  ann.get(NODE_SATURATED_ANNOTATION),
                  ann.get(NODE_VIOLATING_PODS_ANNOTATION))
        ann[NODE_MEASURED_OFFLINE_ANNOTATION] = \
            f"{report.offline_tx_mbps:.1f}"
        ann[NODE_MEASURED_ONLINE_ANNOTATION] = \
            f"{report.online_tx_mbps:.1f}"
        if report.saturated:
            ann[NODE_SATURATED_ANNOTATION] = "true"
        else:
            ann.pop(NODE_SATURATED_ANNOTATION, None)
        ann[NODE_VIOLATING_PODS_ANNOTATION] = str(report.violations)
        return before != (
            ann.get(NODE_MEASURED_OFFLINE_ANNOTATION),
            ann.get(NODE_MEASURED_ONLINE_ANNOTATION),
            ann.get(NODE_SATURATED_ANNOTATION),
            ann.get(NODE_VIOLATING_PODS_ANNOTATION))

    def _fold_bandwidth_report(self, report) -> None:
        """Fold a node agent's BandwidthReport summary into the node's
        annotations AT THE STORE — the server-side half of the
        accounting loop.  Doing it here (not in the agent) means every
        watch mirror, the scheduler's included, learns saturation from
        ordinary node events without decoding reports.  The fold is
        also re-applied on every node PUT (put_object above), so a
        whole-node persist from a mirror that hasn't seen the folded
        keys yet cannot erase them between reports."""
        with self._lock:
            node = self.nodes.get(getattr(report, "node", ""))
            if node is None:
                return
            changed = self._apply_bandwidth_fold(node, report)
        if changed:     # unchanged summary: no watch traffic
            self._notify("node", node)

    @staticmethod
    def _apply_quarantine_stick(obj, cur) -> None:
        """An ACTIVE quarantine TTL survives whole-node writes from
        mirrors that predate the stamp (the victim's own agent
        persists the full node from its mirror copy): if the incoming
        write lacks the annotation while the stored node carries an
        unexpired one, re-apply it.  An EXPIRED stamp is not sticky —
        that is exactly how the failover controller lifts it — and an
        incoming value always wins (a TTL refresh)."""
        import time as _time

        from volcano_tpu_torch.api.slicehealth import (
            NODE_QUARANTINED_UNTIL_ANNOTATION)
        if NODE_QUARANTINED_UNTIL_ANNOTATION in obj.annotations:
            return
        raw = cur.annotations.get(NODE_QUARANTINED_UNTIL_ANNOTATION)
        if raw is None:
            return
        try:
            if float(raw) > _time.time():
                obj.annotations[NODE_QUARANTINED_UNTIL_ANNOTATION] = raw
        except (TypeError, ValueError):
            pass

    @staticmethod
    def _apply_health_fold(node, report) -> bool:
        """Merge a SliceHealthReport's verdict into *node*'s
        annotations; returns True when it changed."""
        from volcano_tpu_torch.api.slicehealth import (NODE_HEALTH_ANNOTATION,
                                                 VERDICT_HEALTHY)
        ann = node.annotations
        before = ann.get(NODE_HEALTH_ANNOTATION)
        if report.verdict == VERDICT_HEALTHY:
            # healthy is the absence of the key, so nodes that never
            # ran an agent and nodes that recovered look identical
            ann.pop(NODE_HEALTH_ANNOTATION, None)
        else:
            ann[NODE_HEALTH_ANNOTATION] = report.verdict
        return before != ann.get(NODE_HEALTH_ANNOTATION)

    def _fold_health_report(self, report) -> None:
        """Store-side fold of a host health verdict into the node's
        annotations (same rationale as _fold_bandwidth_report: every
        watch mirror learns host health from ordinary node events)."""
        with self._lock:
            node = self.nodes.get(getattr(report, "node", ""))
            if node is None:
                return
            changed = self._apply_health_fold(node, report)
        if changed:
            self._notify("node", node)

    @staticmethod
    def _apply_goodput_stick(obj, cur) -> None:
        """A whole-podgroup write from a mirror that predates a
        goodput fold must not erase the folded summary: copy over any
        goodput key the incoming write lacks, and for the ACCUMULATED
        keys (allocated/productive pod-seconds, step, epoch) keep the
        larger value — the ledger only ever grows, so max() is the
        conflict-free merge of a stale-copy write racing a fold."""
        from volcano_tpu_torch.api import goodput as gapi
        ann, cur_ann = obj.annotations, cur.annotations
        for key in gapi.PG_FOLD_KEYS:
            if key not in cur_ann:
                continue
            if key not in ann:
                ann[key] = cur_ann[key]
            elif key in (gapi.PG_ALLOCATED_S_ANNOTATION,
                         gapi.PG_PRODUCTIVE_S_ANNOTATION,
                         gapi.PG_STEP_ANNOTATION,
                         gapi.PG_EPOCH_ANNOTATION,
                         gapi.PG_UPDATED_TS_ANNOTATION):
                if gapi.ann_float(cur_ann, key) > \
                        gapi.ann_float(ann, key):
                    ann[key] = cur_ann[key]

    def _fold_goodput_report(self, report, prev=None) -> None:
        """Fold a node agent's GoodputReport into the owning PODGROUP
        annotations AT THE STORE — the per-job half of the goodput
        loop (docs/design/goodput.md).  Doing it here (not in the
        agent) means every watch mirror — the scheduler's throughput-
        vector estimator included — learns per-job step rates and the
        productive/allocated ledger from ordinary podgroup events.

        The wire ledger is CUMULATIVE per pod; the fold accumulates
        the per-pod diff against *prev* (this node's previous stored
        report).  That makes the fold idempotent under retries — an
        agent whose post was folded but whose ack died re-sends the
        same cumulative values and contributes only the growth — while
        several nodes hosting one gang still accumulate without
        double counting.  A cumulative value BELOW the previous one is
        a restarted collector: the new absolute value is the diff."""
        from volcano_tpu_torch.api import goodput as gapi
        prev_by_uid = {u.uid: u for u in getattr(prev, "usages", ())} \
            if prev is not None else {}

        def ledger_diff(u, field):
            cur = getattr(u, field)
            p = prev_by_uid.get(u.uid)
            base = getattr(p, field) if p is not None else 0.0
            return cur - base if cur >= base else cur

        by_job: Dict[str, list] = {}
        for u in getattr(report, "usages", ()):
            if u.job:
                by_job.setdefault(u.job, []).append(u)
        for job_key, usages in by_job.items():
            with self._lock:
                pg = self.podgroups.get(job_key)
                if pg is None:
                    continue
                ann = pg.annotations
                before = {k: ann.get(k) for k in gapi.PG_FOLD_KEYS}
                step = max(u.step for u in usages)
                if step > gapi.ann_float(ann, gapi.PG_STEP_ANNOTATION):
                    ann[gapi.PG_STEP_ANNOTATION] = str(step)
                # the gang steps in lockstep: any healthy pod's rate
                # approximates the job's — take this report's max so
                # one straggling stale file cannot drag the estimate
                rate = max(u.steps_per_s for u in usages)
                ann[gapi.PG_STEP_RATE_ANNOTATION] = f"{rate:.3f}"
                ex_rate = max(u.examples_per_s for u in usages)
                if ex_rate > 0:
                    ann[gapi.PG_EXAMPLES_RATE_ANNOTATION] = \
                        f"{ex_rate:.3f}"
                alloc = gapi.ann_float(
                    ann, gapi.PG_ALLOCATED_S_ANNOTATION) + \
                    sum(ledger_diff(u, "allocated_s") for u in usages)
                prod = gapi.ann_float(
                    ann, gapi.PG_PRODUCTIVE_S_ANNOTATION) + \
                    sum(ledger_diff(u, "productive_s")
                        for u in usages)
                ann[gapi.PG_ALLOCATED_S_ANNOTATION] = f"{alloc:.3f}"
                ann[gapi.PG_PRODUCTIVE_S_ANNOTATION] = f"{prod:.3f}"
                if alloc > 0:
                    ann[gapi.PG_GOODPUT_ANNOTATION] = \
                        f"{min(1.0, prod / alloc):.4f}"
                ann[gapi.PG_GENERATION_ANNOTATION] = \
                    usages[0].generation
                epoch = max(u.epoch for u in usages)
                if epoch >= gapi.ann_float(ann,
                                           gapi.PG_EPOCH_ANNOTATION):
                    ann[gapi.PG_EPOCH_ANNOTATION] = str(epoch)
                ts = getattr(report, "ts", 0.0)
                # max-merge: a behind-wall-clock node's fold must not
                # regress the stamp (the estimator dedupes on it)
                if ts > gapi.ann_float(ann,
                                       gapi.PG_UPDATED_TS_ANNOTATION):
                    ann[gapi.PG_UPDATED_TS_ANNOTATION] = f"{ts:.3f}"
                changed = before != {k: ann.get(k)
                                     for k in gapi.PG_FOLD_KEYS}
            if changed:     # unchanged summary: no watch traffic
                self._notify("podgroup", pg)

    @staticmethod
    def _apply_serving_stick(obj, cur) -> None:
        """Same stale-copy protection as _apply_goodput_stick for the
        serving summary: copy keys the incoming write lacks, max-merge
        the monotone ones (request/SLO ledgers, epoch, stamp)."""
        from volcano_tpu_torch.api import serving as sapi
        ann, cur_ann = obj.annotations, cur.annotations
        for key in sapi.PG_FOLD_KEYS:
            if key not in cur_ann:
                continue
            if key not in ann:
                ann[key] = cur_ann[key]
            elif key in (sapi.PG_REQUESTS_ANNOTATION,
                         sapi.PG_SLO_OK_ANNOTATION,
                         sapi.PG_EPOCH_ANNOTATION,
                         sapi.PG_UPDATED_TS_ANNOTATION):
                if sapi.ann_float(cur_ann, key) > \
                        sapi.ann_float(ann, key):
                    ann[key] = cur_ann[key]

    def _fold_serving_report(self, report, prev=None) -> None:
        """Fold a node agent's ServingReport into the owning PODGROUP
        annotations at the store — the serving mirror of
        _fold_goodput_report.  Request/SLO-ok ledgers are CUMULATIVE
        per replica on the wire; the fold accumulates per-pod diffs
        against *prev* (idempotent under lost-ack re-post, no double
        counting across nodes).  QPS SUMS across a group's replicas
        (each serves its own share of the traffic), latency quantiles
        take the report's max (the group's p99 is bounded by its
        slowest replica — optimistic per-replica mixing would hide a
        hot-spotted one)."""
        from volcano_tpu_torch.api import serving as sapi
        prev_by_uid = {u.uid: u for u in getattr(prev, "usages", ())} \
            if prev is not None else {}

        def ledger_diff(u, field):
            cur = getattr(u, field)
            p = prev_by_uid.get(u.uid)
            base = getattr(p, field) if p is not None else 0
            return cur - base if cur >= base else cur

        by_job: Dict[str, list] = {}
        for u in getattr(report, "usages", ()):
            if u.job:
                by_job.setdefault(u.job, []).append(u)
        for job_key, usages in by_job.items():
            with self._lock:
                pg = self.podgroups.get(job_key)
                if pg is None:
                    continue
                ann = pg.annotations
                before = {k: ann.get(k) for k in sapi.PG_FOLD_KEYS}
                # the group summary spans EVERY node's stored report:
                # one group's replicas land on many hosts and each
                # agent reports only its own pods, so folding just the
                # incoming report would shrink the group QPS to the
                # last poster's share.  Usages are filtered to live
                # pod uids — a drained replica's final report stops
                # counting the moment its pod object is deleted
                live = {p.uid for p in self.pods.values()}
                group = [u for rep in self.servingreports.values()
                         for u in getattr(rep, "usages", ())
                         if u.job == job_key and u.uid in live]
                if not group:
                    group = usages
                qps = sum(u.qps for u in group)
                ann[sapi.PG_QPS_ANNOTATION] = f"{qps:.3f}"
                ann[sapi.PG_P50_MS_ANNOTATION] = \
                    f"{max(u.p50_ms for u in group):.3f}"
                ann[sapi.PG_P99_MS_ANNOTATION] = \
                    f"{max(u.p99_ms for u in group):.3f}"
                reqs = sapi.ann_float(
                    ann, sapi.PG_REQUESTS_ANNOTATION) + \
                    sum(ledger_diff(u, "requests") for u in usages)
                ok = sapi.ann_float(
                    ann, sapi.PG_SLO_OK_ANNOTATION) + \
                    sum(ledger_diff(u, "slo_ok") for u in usages)
                ann[sapi.PG_REQUESTS_ANNOTATION] = f"{reqs:.0f}"
                ann[sapi.PG_SLO_OK_ANNOTATION] = f"{ok:.0f}"
                ann[sapi.PG_REPLICAS_ANNOTATION] = str(len(group))
                epoch = max(u.epoch for u in group)
                if epoch >= sapi.ann_float(ann,
                                           sapi.PG_EPOCH_ANNOTATION):
                    ann[sapi.PG_EPOCH_ANNOTATION] = str(epoch)
                ts = getattr(report, "ts", 0.0)
                if ts > sapi.ann_float(ann,
                                       sapi.PG_UPDATED_TS_ANNOTATION):
                    ann[sapi.PG_UPDATED_TS_ANNOTATION] = f"{ts:.3f}"
                changed = before != {k: ann.get(k)
                                     for k in sapi.PG_FOLD_KEYS}
            if changed:     # unchanged summary: no watch traffic
                self._notify("podgroup", pg)

    def delete_object(self, kind: str, key: str) -> None:
        from volcano_tpu_torch.cache.kinds import KINDS
        spec = KINDS[kind]
        with self._lock:
            obj = getattr(self, spec.attr).pop(key, None)
        if obj is not None:
            self._notify(f"{kind}_deleted",
                         obj if spec.key_of else {"key": key, "obj": obj})
        if kind == "node" and obj is not None:
            # the node's agent reports die with it: the sticky
            # re-fold (put_object) would otherwise resurrect stale
            # saturation/health onto a REPLACEMENT host registering
            # under the same name
            for rkind, attr in (("bandwidthreport", "bandwidthreports"),
                                ("slicehealthreport",
                                 "slicehealthreports"),
                                ("goodputreport", "goodputreports"),
                                ("servingreport", "servingreports")):
                with self._lock:
                    had = key in getattr(self, attr)
                if had:
                    self.delete_object(rkind, key)

    def watch(self, fn: Callable[[str, object], None]):
        self._watchers.append(fn)

    def unwatch(self, fn: Callable[[str, object], None]):
        try:
            self._watchers.remove(fn)
        except ValueError:
            pass

    def _notify(self, kind: str, obj: object):
        for w in self._watchers:
            w(kind, obj)

    # -- Cluster interface --------------------------------------------

    def list_all(self) -> ClusterSnapshot:
        with self._lock:
            return ClusterSnapshot(
                pods=list(self.pods.values()),
                nodes=list(self.nodes.values()),
                podgroups=list(self.podgroups.values()),
                queues=list(self.queues.values()),
                hypernodes=list(self.hypernodes.values()),
                priority_classes=list(self.priority_classes.values()),
                vcjobs=list(self.vcjobs.values()),
            )

    def bind_pod(self, namespace: str, name: str, node_name: str,
                 ts_alloc: Optional[float] = None) -> None:
        """ts_alloc: the scheduler's placement-decision wall time,
        carried on the bind request so the `allocated` lifecycle stamp
        reflects the decision, not the (possibly batched) commit."""
        from volcano_tpu_torch import trace
        try:
            # telemetry must never fail (or half-apply) a bind: an
            # unparseable decision stamp from a hand-rolled client is
            # dropped, not raised after the pod already mutated
            ts_alloc = None if ts_alloc is None else float(ts_alloc)
        except (TypeError, ValueError):
            ts_alloc = None
        key = f"{namespace}/{name}"
        with self._lock:
            pod = self.pods.get(key)
            if pod is None:
                raise KeyError(f"bind: pod {key} not found")
            if pod.node_name and pod.node_name != node_name:
                raise ValueError(
                    f"bind conflict: pod {key} already on {pod.node_name}")
            if node_name not in self.nodes:
                raise KeyError(f"bind: node {node_name} not found")
            pod.node_name = node_name
            pod.phase = TaskStatus.BOUND
            trace.stamp_phase(pod.annotations, "allocated", ts_alloc)
            trace.stamp_phase(pod.annotations, "bound")
            self.binds.append((key, node_name))
        self._notify("pod", pod)

    def evict_pod(self, namespace: str, name: str, reason: str = "") -> None:
        key = f"{namespace}/{name}"
        with self._lock:
            pod = self.pods.get(key)
            if pod is None:
                return
            pod.phase = TaskStatus.RELEASING
            pod.status_message = reason
            self.evictions.append(key)
        self._notify("pod", pod)

    def nominate_pod(self, namespace: str, name: str, node_name: str) -> None:
        with self._lock:
            pod = self.pods.get(f"{namespace}/{name}")
            if pod is not None:
                pod.nominated_node = node_name
        if pod is not None:
            self._notify("pod", pod)

    def update_podgroup_status(self, pg: PodGroup) -> None:
        # the scheduler's per-cycle status flush is a WHOLE-podgroup
        # write from ITS mirror copy.  Normally that copy is a cycle
        # old at worst, but under gray failure (read-only degrade,
        # slow watch) it can be SECONDS stale — and without the same
        # goodput stick put_object applies, a stale flush erased the
        # folds that landed in between, visibly rewinding the
        # accumulated ledger (found by tools/chaos_conductor.py:
        # goodput_monotonic violation).  Max-merge is conflict-free,
        # so re-applying here is always safe.
        with self._lock:
            # read-stick-store under ONE lock hold: a fold landing
            # between a dropped-lock read and the store would still
            # be erased (the exact race the stick closes)
            cur = self.podgroups.get(pg.key)
            if cur is not None:
                self._apply_goodput_stick(pg, cur)
            self.podgroups[pg.key] = pg
        self._notify("podgroup", pg)

    def record_event(self, obj_key: str, reason: str, message: str) -> None:
        self.events.append((obj_key, reason, message))

    # -- leases + fencing tokens (StateServer.lease analogue) ----------

    def lease(self, name: str, holder: str, ttl: float = 15.0,
              release: bool = False, deadline=None) -> dict:
        """Same CAS + term contract as StateServer.lease: the term
        bumps on every acquisition that is not a live same-holder
        renewal, and is never reissued.  deadline is accepted for
        RemoteCluster signature parity (no wire here to bound)."""
        now = self.lease_now()
        with self._lock:
            cur = self._fake_leases.get(name)
            if release:
                if cur and cur[0] == holder:
                    del self._fake_leases[name]
                return {"acquired": False, "holder": "", "expires": 0,
                        "expires_in": 0,
                        "term": self._lease_terms.get(name, 0)}
            if cur is None or cur[1] < now or cur[0] == holder:
                if cur is not None and cur[0] == holder and \
                        cur[1] >= now:
                    term = cur[2] or self._lease_terms.get(name, 0)
                else:
                    term = self._lease_terms.get(name, 0) + 1
                    self._lease_terms[name] = term
                self._fake_leases[name] = [holder, now + ttl, term]
                return {"acquired": True, "holder": holder,
                        "expires": now + ttl,
                        "expires_in": round(ttl, 3), "term": term}
            return {"acquired": False, "holder": cur[0],
                    "expires": cur[1],
                    "expires_in": round(cur[1] - now, 3),
                    "term": cur[2]}

    def leases(self) -> dict:
        now = self.lease_now()
        with self._lock:
            return {name: {"holder": l[0],
                           "expires_in": round(l[1] - now, 3),
                           "term": l[2]}
                    for name, l in self._fake_leases.items()}

    def set_fence(self, name: str, term: int) -> None:
        """Signature parity with RemoteCluster.set_fence.  In-process
        stores don't enforce the fence on writes (no wire boundary to
        refuse at) — enforcement is proven against real servers."""
        self._fence = (name, int(term)) if name else None

    def advance_fence(self, name: str, term: int,
                      deadline=None) -> dict:
        with self._lock:
            cur = self._fences.get(name, 0)
            if int(term) > cur:
                self._fences[name] = cur = int(term)
            return {"name": name, "term": cur,
                    "refused": self._fenced_counts.get(name, 0)}

    def fences(self) -> dict:
        with self._lock:
            return {name: {"term": t,
                           "refused": self._fenced_counts.get(name, 0)}
                    for name, t in sorted(self._fences.items())}

    # -- kubelet simulation -------------------------------------------

    def tick(self):
        """Advance simulated pod lifecycle one step:
        Bound -> Running; Releasing -> deleted; and a RUNNING pod whose
        spec declares a finite workload (RUN_TICKS_ANNOTATION) succeeds
        once it has run that many ticks — the kubelet running a batch
        container to completion (reference: kubelet drives the pod
        phase, the job controller reacts,
        job_controller.go:415-542)."""
        with self._lock:
            to_delete = []
            started = []
            completed = []
            progress = self._run_progress
            from volcano_tpu_torch import trace
            for key, pod in self.pods.items():
                if pod.phase is TaskStatus.BOUND:
                    pod.phase = TaskStatus.RUNNING
                    # the simulated kubelet admits and starts the
                    # container in one tick, so the two stamps
                    # coincide here; a real kubelet would separate
                    # image pull / admission from container start
                    trace.stamp_phase(pod.annotations, "admitted")
                    trace.stamp_phase(pod.annotations, "running")
                    started.append(pod)
                elif pod.phase is TaskStatus.RUNNING:
                    spec = pod.annotations.get(RUN_TICKS_ANNOTATION)
                    if spec is None:
                        continue
                    try:
                        run_ticks = int(spec)
                    except ValueError:
                        continue            # malformed: run forever
                    ran = progress.get(pod.uid, 0) + 1
                    if ran >= run_ticks:
                        pod.phase = TaskStatus.SUCCEEDED
                        pod.exit_code = 0
                        progress.pop(pod.uid, None)
                        completed.append(pod)
                    else:
                        progress[pod.uid] = ran
                elif pod.phase is TaskStatus.RELEASING:
                    progress.pop(pod.uid, None)
                    to_delete.append(key)
        for pod in started:
            self._notify("pod", pod)
        for pod in completed:
            self._notify("pod", pod)
        for key in to_delete:
            self.delete_pod(key)

    def complete_pod(self, key: str, succeeded: bool = True,
                     exit_code=None):
        with self._lock:
            pod = self.pods.get(key)
            if pod:
                pod.phase = (TaskStatus.SUCCEEDED if succeeded
                             else TaskStatus.FAILED)
                pod.exit_code = (exit_code if exit_code is not None
                                 else (0 if succeeded else 1))
        if pod:
            self._notify("pod", pod)

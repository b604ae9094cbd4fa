"""Volumebinding plugin — PV/PVC zone-affine binding.

Reference parity: pkg/scheduler/capabilities/volumebinding (forked k8s
volume binder with assume-cache, PASSIVE assume-cache and scorer, plus
dynamic provisioning).  Standalone model:

- persistent volumes live in the cluster's "pv" store:
    cluster.put_object("pv", {"capacity_gi": 100,
                              "zone": "us-central2-b",
                              "claimed_by": ""}, key="pv-1")
- pods claim via annotation  volume.volcano-tpu.io/claims: "pvc-a,pvc-b"
  and pvc specs via the "pvc" store:
    {"request_gi": 10, "bound_pv": "",
     "storage_class": "standard"}     # storage_class => provisionable

Predicate: every claimed PVC must be bound (then its PV's zone must
match the node) or bindable to an unclaimed PV in the node's zone — or
carry a storage class, in which case a volume is DYNAMICALLY
PROVISIONED in the chosen node's zone at commit time
(WaitForFirstConsumer semantics, capabilities/volumebinding/binder.go).
Score: prefer nodes whose zone already holds the PVs (data gravity);
provisionable claims score neutral (no gravity yet).

Assume caches: the ACTIVE cache records this scheduler's own in-session
reservations the moment a claiming task is placed; the PASSIVE cache
(capabilities/volumebinding/passive_assume_cache.go — multi-scheduler
safety) folds pvc/pv bind events observed over the cluster watch DURING
the session, so a volume bound by the agent scheduler or a second
batch scheduler mid-cycle can't be double-assumed here.  Bindings and
provisioned volumes commit through put_object at session close
(PreBind analogue), so they persist across the wire boundary.
"""

from __future__ import annotations

import logging
import threading
from typing import Dict, List, Optional

from volcano_tpu_torch.api.fit_error import unschedulable
from volcano_tpu_torch.api.job_info import TaskInfo
from volcano_tpu_torch.api.node_info import NodeInfo
from volcano_tpu_torch.framework.plugins import Plugin, register_plugin

log = logging.getLogger(__name__)

CLAIMS_ANNOTATION = "volume.volcano-tpu.io/claims"
ZONE_LABEL = "topology.kubernetes.io/zone"
MAX_SCORE = 100.0
PROVISION = "<provision>"     # sentinel PV name for dynamic claims


@register_plugin("volumebinding")
class VolumeBindingPlugin(Plugin):
    name = "volumebinding"

    def on_session_open(self, ssn):
        from volcano_tpu_torch import features
        if not features.enabled("VolumeBinding"):
            return   # feature-gated off (features.py)
        self.ssn = ssn
        cluster = ssn.cache.cluster
        self._init_state(cluster)
        cluster.watch(self._passive_observe)
        # always register: a pod claiming an unknown PVC must be gated
        # even when the cluster has no PVCs at all
        ssn.add_predicate_fn(self.name, self._predicate)
        ssn.add_predicate_prepare_fn(self.name, self._prepare_predicate)
        ssn.add_node_order_fn(self.name, self._score)
        ssn.add_node_order_prepare_fn(self.name, self._prepare_score)
        from volcano_tpu_torch.framework.session import EventHandler
        ssn.add_event_handler(EventHandler(
            allocate_fn=self._on_allocate,
            deallocate_fn=self._on_deallocate))

    def _init_state(self, cluster) -> None:
        """Session-scoped state (also the seam tests use to exercise
        commit paths without a full session)."""
        self.cluster = cluster
        self.pvs: Dict[str, dict] = {
            k: dict(v) for k, v in
            (getattr(cluster, "pvs", {}) or {}).items()}
        self.pvcs: Dict[str, dict] = {
            k: dict(v) for k, v in
            (getattr(cluster, "pvcs", {}) or {}).items()}
        # ACTIVE assume-cache: pv -> pvc assumed this session (populated
        # at ALLOCATION time so two pods can't pass the predicate
        # against the same free PV in one cycle)
        self.assumed: Dict[str, str] = {}
        # task uid -> [(pvc, pv-or-PROVISION sentinel)]
        self._task_pvs: Dict[str, list] = {}
        # PASSIVE assume-cache: pv/pvc binds observed on the watch
        # stream mid-session (another scheduler's work).  Watch events
        # arrive on the RemoteCluster watch thread, concurrent with the
        # scheduling thread iterating these dicts — hence the lock.
        self._cache_lock = threading.Lock()

    # -- passive assume cache ------------------------------------------

    def _passive_observe(self, kind: str, obj) -> None:
        """Fold externally-observed pvc/pv binds into the session view
        (passive_assume_cache.go: learn bindings you didn't make)."""
        if kind not in ("pvc", "pv") or not isinstance(obj, dict):
            return
        key, payload = obj.get("key"), obj.get("obj")
        if not key or not isinstance(payload, dict):
            return
        with self._cache_lock:
            if kind == "pv":
                claimed = payload.get("claimed_by")
                if claimed and self.assumed.get(key) is None:
                    self.assumed[key] = claimed
                self.pvs[key] = dict(payload)
            else:
                self.pvcs[key] = dict(payload)
                bound = payload.get("bound_pv")
                if bound:
                    self.assumed.setdefault(bound, key)

    # -- binding logic -------------------------------------------------

    @staticmethod
    def _claims(task: TaskInfo) -> List[str]:
        raw = task.pod.annotations.get(CLAIMS_ANNOTATION, "")
        return [c.strip() for c in raw.split(",") if c.strip()]

    def _bindable_pv(self, pvc_name: str, zone: str,
                     exclude: Optional[set] = None) -> Optional[str]:
        """An existing PV for the claim, or the PROVISION sentinel for
        a dynamic (storage-classed) claim, or None."""
        with self._cache_lock:
            return self._bindable_pv_locked(pvc_name, zone, exclude)

    def _bindable_pv_locked(self, pvc_name: str, zone: str,
                            exclude: Optional[set] = None
                            ) -> Optional[str]:
        pvc = self.pvcs.get(pvc_name)
        if pvc is None:
            return None
        if pvc.get("bound_pv"):
            pv = self.pvs.get(pvc["bound_pv"])
            return pvc["bound_pv"] if pv and pv.get("zone") == zone \
                else None
        for name, pv in sorted(self.pvs.items()):
            if pv.get("claimed_by") or name in self.assumed:
                continue
            if exclude and name in exclude:
                continue
            if pv.get("zone") != zone:
                continue
            if pv.get("capacity_gi", 0) >= pvc.get("request_gi", 0):
                return name
        if pvc.get("storage_class"):
            # dynamic provisioning: volume will be created in the
            # selected node's zone at commit (WaitForFirstConsumer)
            return PROVISION
        return None

    def _try_assume(self, pvc_name: str, zone: str,
                    exclude: set) -> Optional[str]:
        """Scan + assume atomically, so a passive-cache write between
        our scan and our assume can't be clobbered."""
        with self._cache_lock:
            if pvc_name not in self.pvcs or \
                    self.pvcs[pvc_name].get("bound_pv"):
                return None
            pv = self._bindable_pv_locked(pvc_name, zone, exclude)
            if pv is not None and pv is not PROVISION:
                self.assumed[pv] = pvc_name
            return pv

    def _predicate(self, task: TaskInfo, node: NodeInfo):
        claims = self._claims(task)
        if not claims:
            return None
        zone = node.labels.get(ZONE_LABEL, "")
        # PVs picked by earlier PVCs of THIS task are off the table for
        # its later PVCs (intra-task reservation)
        taken_here: set = set()
        for pvc_name in claims:
            if pvc_name not in self.pvcs:
                return unschedulable(
                    f"unknown PVC {pvc_name!r}", "volumebinding",
                    resolvable=False)
            pv = self._bindable_pv(pvc_name, zone, exclude=taken_here)
            if pv is None:
                return unschedulable(
                    f"no bindable volume for PVC {pvc_name!r} in zone "
                    f"{zone or '<none>'}", "volumebinding")
            if pv is not PROVISION:
                taken_here.add(pv)
        return None

    def _prepare_predicate(self, task: TaskInfo):
        """Batched _predicate (PreFilter): the claim list is parsed
        from annotations once per sweep, and the claimless common
        case skips everything (equivalence pinned in test_sweep.py)."""
        claims = self._claims(task)
        if not claims:
            return lambda node: None
        return lambda node: self._predicate(task, node)

    def _score(self, task: TaskInfo, node: NodeInfo) -> float:
        claims = self._claims(task)
        if not claims:
            return 0.0
        zone = node.labels.get(ZONE_LABEL, "")
        ok = 0
        for c in claims:
            pv = self._bindable_pv(c, zone)
            if pv is not None and pv is not PROVISION:
                ok += 1   # existing data gravity only
        return MAX_SCORE * ok / len(claims)

    def _prepare_score(self, task: TaskInfo):
        """Batched _score (PreScore), claimless fast path."""
        if not self._claims(task):
            return lambda node: 0.0
        return lambda node: self._score(task, node)

    def _on_allocate(self, event):
        """Assume PVs the moment a claiming task is placed, so later
        predicate calls in the same cycle see them as taken."""
        task = event.task
        claims = self._claims(task)
        if not claims or not task.node_name:
            return
        node = self.ssn.nodes.get(task.node_name)
        if node is None:
            return
        zone = node.labels.get(ZONE_LABEL, "")
        reserved = []
        for pvc_name in claims:
            pv = self._try_assume(pvc_name, zone,
                                  exclude={p for _, p, _z in reserved
                                           if p is not PROVISION})
            if pv is None:
                if pvc_name not in self.pvcs or \
                        self.pvcs[pvc_name].get("bound_pv"):
                    continue   # already bound: nothing to reserve
                # never leave a claim partially unbound: release this
                # task's reservations and let resync handle it
                log.warning(
                    "volumebinding: PVC %s lost its PV on %s at "
                    "allocate time; releasing task reservations",
                    pvc_name, task.node_name)
                with self._cache_lock:
                    for prev_pvc, prev_pv, _z in reserved:
                        if prev_pv is not PROVISION and \
                                self.assumed.get(prev_pv) == prev_pvc:
                            del self.assumed[prev_pv]
                return
            reserved.append((pvc_name, pv, zone))
        if reserved:
            self._task_pvs[task.uid] = reserved

    def _on_deallocate(self, event):
        reserved = self._task_pvs.pop(event.task.uid, [])
        with self._cache_lock:
            for pvc_name, pv, _zone in reserved:
                if pv is not PROVISION and \
                        self.assumed.get(pv) == pvc_name:
                    del self.assumed[pv]

    def on_session_close(self, ssn):
        cluster = getattr(self, "cluster", None)
        if cluster is None:
            return
        try:
            self._commit(ssn, cluster)
        finally:
            cluster.unwatch(self._passive_observe)

    def _commit(self, ssn, cluster):
        if not self._task_pvs:
            return
        # commit bindings whose tasks actually went to bind
        from volcano_tpu_torch.api.types import TaskStatus
        committed_uids = {
            t.uid for job in ssn.jobs.values()
            for t in job.tasks.values()
            if t.status in (TaskStatus.BINDING, TaskStatus.BOUND)}
        for uid, reserved in self._task_pvs.items():
            if uid not in committed_uids:
                continue
            for pvc_name, pv_name, zone in reserved:
                live_pvc = getattr(cluster, "pvcs", {}).get(pvc_name)
                if live_pvc is None or live_pvc.get("bound_pv"):
                    continue
                if pv_name is PROVISION:
                    pv_name = self._provision(cluster, live_pvc,
                                              pvc_name, zone)
                else:
                    live_pv = getattr(cluster, "pvs", {}).get(pv_name)
                    claimed = (live_pv or {}).get("claimed_by")
                    if live_pv is None or (claimed and
                                           claimed != pvc_name):
                        # reserved PV was deleted or bound by another
                        # scheduler mid-session (we never steal it);
                        # the pod is already committed to this zone, so
                        # rebind to another live in-zone PV — or
                        # provision — rather than strand the claim
                        pv_name = self._rebind_live(cluster, live_pvc,
                                                    pvc_name, zone)
                        if pv_name is None:
                            log.warning(
                                "volumebinding: PVC %s lost its PV and "
                                "zone %s has no replacement; claim left "
                                "unbound", pvc_name, zone)
                            continue
                    else:
                        live_pv = dict(live_pv)
                        live_pv["claimed_by"] = pvc_name
                        cluster.put_object("pv", live_pv, key=pv_name)
                new_pvc = dict(live_pvc)
                new_pvc["bound_pv"] = pv_name
                cluster.put_object("pvc", new_pvc, key=pvc_name)

    @staticmethod
    def _provision(cluster, live_pvc: dict, pvc_name: str,
                   zone: str) -> str:
        """Dynamically provision a volume in the consumer's zone, sized
        to the request (WaitForFirstConsumer)."""
        pv_name = f"pv-{pvc_name}-dyn"
        suffix = 0
        while pv_name in getattr(cluster, "pvs", {}):
            suffix += 1
            pv_name = f"pv-{pvc_name}-dyn{suffix}"
        cluster.put_object("pv", {
            "capacity_gi": live_pvc.get("request_gi", 0),
            "zone": zone,
            "claimed_by": pvc_name,
            "storage_class": live_pvc.get("storage_class"),
            "provisioned": True,
        }, key=pv_name)
        return pv_name

    def _rebind_live(self, cluster, live_pvc: dict, pvc_name: str,
                     zone: str) -> Optional[str]:
        """Claim a replacement PV from LIVE cluster state for a claim
        whose session reservation evaporated; provision as last
        resort."""
        need = live_pvc.get("request_gi", 0)
        for name, pv in sorted(getattr(cluster, "pvs", {}).items()):
            if pv.get("claimed_by") or pv.get("zone") != zone:
                continue
            if pv.get("capacity_gi", 0) < need:
                continue
            with self._cache_lock:
                assumed_for = self.assumed.get(name)
                fresh = self.pvs.get(name, pv)
            if assumed_for and assumed_for != pvc_name:
                continue   # reserved for another claim in this session
            if fresh.get("claimed_by") and \
                    fresh.get("claimed_by") != pvc_name:
                continue   # passive cache saw an external claim
            taken = dict(pv)
            taken["claimed_by"] = pvc_name
            cluster.put_object("pv", taken, key=name)
            return name
        if live_pvc.get("storage_class"):
            return self._provision(cluster, live_pvc, pvc_name, zone)
        return None

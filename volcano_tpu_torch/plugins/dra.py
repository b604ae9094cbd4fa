"""DRA plugin — dynamic resource allocation (claims over device pools).

Reference parity: volcano's DRA plumbing (SURVEY §2.1: claim tracking
in cache cache.go:1590, per-queue DRA device accounting
framework/session_dra_queue_status.go, upstream dynamicresources
filter wrapped in predicates.go:154-162, PreBind claim-status write
cache.go:1407).  Standalone model:

- nodes advertise structured device pools (ResourceSlice analogue):
    cluster.resource_slices[node_name] = [
        {"name": "dev0", "class": "tpu-v5e-accel"}, ...]
- claims (ResourceClaim analogue) live on the cluster:
    cluster.resource_claims[name] = {
        "class": "tpu-v5e-accel", "count": 1, "namespace": "default",
        "allocated_node": "", "allocated_devices": []}
- pods reference claims via annotation
    dra.volcano-tpu.io/claims: "claim-a,claim-b"
- queues may cap devices per class (per-queue DRA capacity):
    queue annotation dra.volcano-tpu.io/quota.<class>: "8"

Predicate: allocated claims pin their node; unallocated claims need
enough free matching devices (in-session assume-cache, released on
deallocate).  Claim allocations commit at session close for tasks that
went to bind (PreBind analogue).

Gated surface (reference predicates.go:154-162 feature gates):
- DRADeviceTaints: slice devices may carry
  "taints": [{"key","value"}]; a claim's "tolerations" must cover them
- DRAPrioritizedList: "class_priorities": [cls...] picks the first
  class with enough devices (firstAvailable); the winner is recorded
  as allocated_class
- DRAAdminAccess (default off): "admin_access": true claims from a
  namespace in cluster.admin_namespaces attach to devices regardless
  of ownership and never consume capacity or quota
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional

from volcano_tpu_torch.api.fit_error import unschedulable
from volcano_tpu_torch.api.job_info import TaskInfo
from volcano_tpu_torch.api.node_info import NodeInfo
from volcano_tpu_torch.framework.plugins import Plugin, register_plugin

CLAIMS_ANNOTATION = "dra.volcano-tpu.io/claims"
QUOTA_PREFIX = "dra.volcano-tpu.io/quota."
MAX_SCORE = 100.0


@register_plugin("dra")
class DRAPlugin(Plugin):
    name = "dra"

    def on_session_open(self, ssn):
        self.ssn = ssn
        cluster = ssn.cache.cluster
        self.slices: Dict[str, List[dict]] = dict(
            getattr(cluster, "resource_slices", {}) or {})
        self.claims: Dict[str, dict] = dict(
            getattr(cluster, "resource_claims", {}) or {})
        # device name -> claim holding it (committed + assumed);
        # capacity_free allocations (admin access honored at commit
        # time) never own capacity — keyed on the recorded decision,
        # not the current gate state, so gate flips can't orphan or
        # double-book devices
        self.device_owner: Dict[str, str] = {}
        for cname, claim in self.claims.items():
            if claim.get("capacity_free"):
                continue
            for dev in claim.get("allocated_devices", []):
                self.device_owner[dev] = cname
        # in-session assumptions: task uid -> [(claim, node, devices)]
        self._task_assumes: Dict[str, list] = {}
        # per-queue allocated device counts per class (committed state)
        self.queue_devices: Dict[str, Dict[str, int]] = defaultdict(
            lambda: defaultdict(int))
        for job in ssn.jobs.values():
            for t in job.tasks.values():
                if not t.occupies_resources():
                    continue
                for cname in self._task_claims(t):
                    claim = self.claims.get(cname)
                    if claim and claim.get("allocated_node") and \
                            not claim.get("capacity_free"):
                        cls = claim.get("allocated_class") or \
                            claim.get("class")
                        self.queue_devices[job.queue][cls] += \
                            len(claim.get("allocated_devices", []))

        ssn.add_predicate_fn(self.name, self._predicate)
        ssn.add_node_order_fn(self.name, self._score)
        from volcano_tpu_torch.framework.session import EventHandler
        ssn.add_event_handler(EventHandler(
            allocate_fn=self._on_allocate,
            deallocate_fn=self._on_deallocate))

    @staticmethod
    def _task_claims(task: TaskInfo) -> List[str]:
        raw = task.pod.annotations.get(CLAIMS_ANNOTATION, "")
        return [c.strip() for c in raw.split(",") if c.strip()]

    @staticmethod
    def _claim_classes(claim: dict) -> List[str]:
        """Device classes in preference order (DRAPrioritizedList /
        firstAvailable): 'class_priorities' wins over 'class'."""
        from volcano_tpu_torch import features
        if features.enabled("DRAPrioritizedList") and \
                claim.get("class_priorities"):
            return list(claim["class_priorities"])
        return [claim["class"]] if claim.get("class") else []

    @staticmethod
    def _tolerated(device: dict, claim: dict) -> bool:
        """DRADeviceTaints: every device taint must be tolerated by the
        claim (key match; value match when the toleration pins one)."""
        from volcano_tpu_torch import features
        taints = device.get("taints") or []
        if not taints:
            return True
        if not features.enabled("DRADeviceTaints"):
            return True   # gate off = pre-feature semantics: ignored
        tolerations = claim.get("tolerations") or []
        for taint in taints:
            ok = any(t.get("key") == taint.get("key")
                     and ("value" not in t
                          or t["value"] == taint.get("value"))
                     for t in tolerations)
            if not ok:
                return False
        return True

    def _is_admin(self, claim: dict) -> bool:
        """DRAAdminAccess: monitoring-style claims attach to devices
        without consuming capacity.  Requires the gate AND the claim's
        namespace to be flagged admin (reference: namespace label
        resource.k8s.io/admin-access)."""
        from volcano_tpu_torch import features
        if not claim.get("admin_access") or \
                not features.enabled("DRAAdminAccess"):
            return False
        cluster = self.ssn.cache.cluster
        return claim.get("namespace", "default") in \
            getattr(cluster, "admin_namespaces", set())

    def _free_devices(self, node_name: str, device_class: str,
                      claim: Optional[dict] = None,
                      ignore_owners: bool = False) -> List[str]:
        return [d["name"] for d in self.slices.get(node_name, [])
                if d.get("class") == device_class
                and (ignore_owners or d["name"] not in self.device_owner)
                and (claim is None or self._tolerated(d, claim))]

    def _pick_class(self, claim: dict, node_name: str,
                    need: int, taken: Dict[str, int],
                    ignore_owners: bool = False, quota_ok=None):
        """First class (preference order) with enough usable devices on
        the node (and, when quota_ok is given, queue-quota headroom)
        -> (class, device list) or (None, None).  The same picker runs
        in predicate and allocate so they can never disagree on the
        winning class."""
        for cls in self._claim_classes(claim):
            if quota_ok is not None and not quota_ok(cls):
                continue
            free = self._free_devices(node_name, cls, claim,
                                      ignore_owners=ignore_owners)
            if len(free) - taken.get(cls, 0) >= need:
                return cls, free
        return None, None

    def _queue_quota_ok(self, task: TaskInfo, claim: dict,
                        device_class: str, extra: int = 0) -> bool:
        """extra: devices already taken by earlier claims of the same
        task in the current predicate pass."""
        job = self.ssn.jobs.get(task.job)
        queue = self.ssn.queues.get(job.queue) if job else None
        if queue is None:
            return True
        raw = queue.queue.annotations.get(
            f"{QUOTA_PREFIX}{device_class}")
        if raw is None:
            return True
        try:
            quota = int(raw)
        except ValueError:
            return True
        used = self.queue_devices[job.queue][device_class]
        return used + extra + claim.get("count", 1) <= quota

    # -- callbacks -----------------------------------------------------

    def _predicate(self, task: TaskInfo, node: NodeInfo):
        # claims of one task are checked against a shared view: devices
        # and quota consumed by earlier claims of THIS task count
        taken_here: Dict[str, int] = defaultdict(int)   # class -> devices
        for cname in self._task_claims(task):
            claim = self.claims.get(cname)
            if claim is None:
                return unschedulable(f"unknown resource claim {cname!r}",
                                     "dra", resolvable=False)
            allocated_node = claim.get("allocated_node")
            if allocated_node:
                if allocated_node != node.name:
                    return unschedulable(
                        f"claim {cname!r} is allocated on "
                        f"{allocated_node!r}", "dra", resolvable=False)
                continue
            need = claim.get("count", 1)
            admin = self._is_admin(claim)
            if admin:
                # admin access: devices need only EXIST (ownership is
                # irrelevant, capacity untouched); taints still apply
                cls, _ = self._pick_class(claim, node.name, need, {},
                                          ignore_owners=True)
                if cls is None:
                    return unschedulable(
                        f"no matching devices for admin claim "
                        f"{cname!r}", "dra")
                continue
            found, _ = self._pick_class(
                claim, node.name, need, taken_here,
                quota_ok=lambda cls, c=claim, t=task:
                    self._queue_quota_ok(t, c, cls,
                                         extra=taken_here[cls]))
            if found is None:
                return unschedulable(
                    f"not enough free/quota devices in any of "
                    f"{self._claim_classes(claim)} for claim {cname!r}",
                    "dra")
            taken_here[found] += need
        return None

    def _score(self, task: TaskInfo, node: NodeInfo) -> float:
        claims = self._task_claims(task)
        if not claims:
            return 0.0
        total = 0.0
        for cname in claims:
            claim = self.claims.get(cname)
            if claim is None:
                continue
            if claim.get("allocated_node") == node.name:
                total += 1.0
            elif any(self._free_devices(node.name, cls, claim)
                     for cls in self._claim_classes(claim)):
                total += 0.5
        return MAX_SCORE * total / len(claims)

    def _on_allocate(self, event):
        task = event.task
        claims = self._task_claims(task)
        if not claims or not task.node_name:
            return
        assumed = []
        job = self.ssn.jobs.get(task.job)

        def rollback():
            for prev_cname, _n, devs, prev_cls, prev_admin in assumed:
                if prev_admin:
                    continue
                for dev in devs:
                    self.device_owner.pop(dev, None)
                if job is not None:
                    self.queue_devices[job.queue][prev_cls] -= len(devs)

        for cname in claims:
            claim = self.claims.get(cname)
            if claim is None or claim.get("allocated_node"):
                continue
            need = claim.get("count", 1)
            admin = self._is_admin(claim)
            cls, free = self._pick_class(
                claim, task.node_name, need, {}, ignore_owners=admin,
                quota_ok=None if admin else
                lambda c, cl=claim, t=task: self._queue_quota_ok(t, cl, c))
            if cls is None:
                # never assume a partial claim: roll back this task's
                # earlier assumptions and leave it to resync
                import logging
                logging.getLogger(__name__).warning(
                    "dra: claim %s short of devices on %s at allocate "
                    "time; releasing task assumptions", cname,
                    task.node_name)
                rollback()
                return
            devices = free[:need]
            if not admin:
                for dev in devices:
                    self.device_owner[dev] = cname
                if job is not None:
                    self.queue_devices[job.queue][cls] += len(devices)
            assumed.append((cname, task.node_name, devices, cls, admin))
        if assumed:
            self._task_assumes[task.uid] = assumed

    def _on_deallocate(self, event):
        job = self.ssn.jobs.get(event.task.job)
        for cname, _node, devices, cls, admin in self._task_assumes.pop(
                event.task.uid, []):
            if admin:
                continue
            for dev in devices:
                self.device_owner.pop(dev, None)
            if job is not None:
                self.queue_devices[job.queue][cls] -= len(devices)

    def on_session_close(self, ssn):
        if not getattr(self, "_task_assumes", None):
            return
        from volcano_tpu_torch.api.types import TaskStatus
        committed = {
            t.uid for job in ssn.jobs.values()
            for t in job.tasks.values()
            if t.status in (TaskStatus.BINDING, TaskStatus.BOUND)}
        cluster = ssn.cache.cluster
        live = getattr(cluster, "resource_claims", {})
        for uid, assumes in self._task_assumes.items():
            if uid not in committed:
                continue
            for cname, node_name, devices, cls, admin in assumes:
                claim = live.get(cname)
                if claim is not None and not claim.get("allocated_node"):
                    claim["allocated_node"] = node_name
                    claim["allocated_devices"] = list(devices)
                    claim["allocated_class"] = cls
                    # record whether this allocation consumed capacity:
                    # the NEXT session must rebuild ownership from what
                    # actually happened, not from the (flip-able) gate
                    claim["capacity_free"] = admin

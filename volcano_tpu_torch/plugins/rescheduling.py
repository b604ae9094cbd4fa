"""Rescheduling plugin — strategy-driven periodic rebalancing.

Reference parity: plugins/rescheduling/rescheduling.go:110 (strategy
registry feeding VictimTasks; the shuffle action executes evictions)
+ low_node_utilization.go (per-resource thresholds, nodeFit, priority
threshold).  Three strategies ship:

  lowNodeUtilization — victims from nodes above the per-resource
    target thresholds while nodes below the low thresholds exist to
    absorb them (the reference's LNU strategy, thresholds as
    fractions per dimension instead of descheduler percentages).

  gpuFragmentation — GPU defragmentation: sub-host packs strand
    partially-used HGX hosts, and a multi-host NVLink-domain gang
    needs WHOLE hosts (api/devices/gpu/device_info.py).  Donor hosts
    (fewest used GPUs) hand their sub-host pods to receiver hosts
    (most used GPUs, enough idle), freeing whole hosts for gangs.

  bandwidthPressure — chronic offline-tier bandwidth violators on
    DCN-saturated hosts (node/pod annotations folded from the agents'
    BandwidthReports, api/netusage.py) are victimized so the enforced
    online guarantee holds where shaping alone did not.

Arguments (all under the plugin's `arguments` map):
  bandwidthPressure.chronicViolations: violating-sync floor for a
      bandwidth victim                                (default 3)
  rescheduling.interval: seconds between passes         (default 300)
  rescheduling.strategies: comma list                   (default
      "lowNodeUtilization")
  rescheduling.maxVictims: victim cap per pass          (default 8)
  rescheduling.thresholdPriority: never victimize tasks at or above
      this priority                                     (default 2e9)
  lowNodeUtilization.thresholds: {dim: frac} below which a node is
      LOW on every dim                                  (default
      {"cpu": .2, "memory": .2})
  lowNodeUtilization.targetThresholds: {dim: frac} above which a node
      is HIGH on any dim                                (default
      {"cpu": .8, "memory": .8})
  lowNodeUtilization.nodeFit: victims must fit a low node (default
      True)
  legacy flat keys rescheduling.lowThreshold/highThreshold are still
  honored as uniform thresholds.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List

from volcano_tpu_torch.api.job_info import TaskInfo
from volcano_tpu_torch.api.resource import MIN_RESOURCE, GPU
from volcano_tpu_torch.framework.plugins import Plugin, register_plugin

# strategy name -> fn(plugin, ssn) -> victims (reference VictimFn map,
# rescheduling.go:62); registration is module-level so operators can
# add strategies the way they add plugins
STRATEGIES: Dict[str, Callable] = {}


def register_strategy(name: str):
    def deco(fn):
        STRATEGIES[name] = fn
        return fn
    return deco


def _utilization(node, dim: str) -> float:
    cap = node.allocatable.get(dim)
    return node.used.get(dim) / cap if cap > MIN_RESOURCE else 0.0


def _movable(plugin, task_on_node, node) -> "TaskInfo | None":
    """The session-task for a node-task, if it may be victimized."""
    if not task_on_node.occupies_resources() \
            or not task_on_node.preemptable:
        return None
    if task_on_node.priority >= plugin.threshold_priority:
        return None
    job = plugin.ssn.jobs.get(task_on_node.job)
    victim = job.tasks.get(task_on_node.uid) if job else None
    return victim or task_on_node


@register_strategy("lowNodeUtilization")
def _lnu_victims(plugin, ssn) -> List[TaskInfo]:
    nodes = [n for n in ssn.nodes.values() if n.ready]
    lows = [n for n in nodes
            if all(_utilization(n, d) < t
                   for d, t in plugin.low_thresholds.items())]
    highs = [n for n in nodes
             if any(_utilization(n, d) > t
                    for d, t in plugin.target_thresholds.items())]
    if not lows or not highs:
        return []
    victims: List[TaskInfo] = []
    # drain the hottest nodes first (reference sorts by usage)
    highs.sort(key=lambda n: -max(_utilization(n, d)
                                  for d in plugin.target_thresholds))
    absorb = [n.future_idle() for n in lows]
    for node in highs:
        for t in sorted(node.tasks.values(),
                        key=lambda t: t.resreq.milli_cpu):
            victim = _movable(plugin, t, node)
            if victim is None:
                continue
            if plugin.node_fit:
                # a victim nothing can absorb just churns: charge the
                # move against a low node's projected headroom
                slot = next((i for i, idle in enumerate(absorb)
                             if victim.resreq.less_equal(idle)), None)
                if slot is None:
                    continue
                absorb[slot] = absorb[slot].clone().sub_unchecked(
                    victim.resreq)
            victims.append(victim)
            if len(victims) >= plugin.max_victims:
                return victims
            break                       # one per high node per pass
    return victims


@register_strategy("gpuFragmentation")
def _gpu_defrag_victims(plugin, ssn) -> List[TaskInfo]:
    """Consolidate sub-host GPU packs to free whole hosts.

    A host is FRAGMENTED when some but not all of its GPUs are used.
    Moving the least-loaded fragmented hosts' packs onto the most-
    loaded fragmented hosts (that can absorb them GPU-for-GPU)
    converts fragmented pairs into one packed host + one free host —
    and free whole hosts are the currency multi-host NVLink-domain
    gangs spend (device_info.py: whole hosts on multi-host domains)."""
    frag = []
    for n in ssn.nodes.values():
        if not n.ready:
            continue
        cap, used = n.allocatable.get(GPU), n.used.get(GPU)
        if cap > MIN_RESOURCE and MIN_RESOURCE < used < cap - MIN_RESOURCE:
            frag.append(n)
    if len(frag) < 2:
        return []
    # donors drain from the emptiest end, receivers fill the fullest
    frag.sort(key=lambda n: n.used.get(GPU))
    victims: List[TaskInfo] = []
    receiver_idle = {n.name: n.future_idle() for n in frag}
    donors, receivers = frag[:len(frag) // 2], frag[len(frag) // 2:]
    for donor in donors:
        for t in sorted(donor.tasks.values(),
                        key=lambda t: t.resreq.get(GPU)):
            if t.resreq.get(GPU) <= MIN_RESOURCE:
                continue                # cpu-only pod: not fragmenting
            victim = _movable(plugin, t, donor)
            if victim is None:
                continue
            # the FULL resreq (cpu/memory too, not just GPUs) must
            # fit the receiver, or the evicted pack just re-lands on
            # the donor and the next pass evicts it again
            home = next((r for r in reversed(receivers)
                         if victim.resreq.less_equal(
                             receiver_idle[r.name])), None)
            if home is None:
                continue                # nothing can absorb this pack
            receiver_idle[home.name] = receiver_idle[home.name] \
                .clone().sub_unchecked(victim.resreq)
            victims.append(victim)
            if len(victims) >= plugin.max_victims:
                return victims
    return victims


@register_strategy("bandwidthPressure")
def _bandwidth_victims(plugin, ssn) -> List[TaskInfo]:
    """Chronic offline-tier bandwidth violators on saturated hosts
    become migration victims — the react step of the agent's
    enforce→measure→react loop (api/netusage.py).

    A host is saturated when the agent's measured DCN total crossed
    the pressure line (node annotation folded from its
    BandwidthReport); a victim is an offline (BE) pod whose
    cumulative violating-sync count reached the chronic threshold
    AND is still violating — a pod that already backed under its
    watermark gets to stay.  Hottest hosts drain first; per-pod caps
    (the enforcer) keep shaping everyone else meanwhile."""
    from volcano_tpu_torch.api.netusage import (
        NODE_MEASURED_OFFLINE_ANNOTATION, NODE_SATURATED_ANNOTATION,
        POD_VIOLATING_ANNOTATION, POD_VIOLATIONS_ANNOTATION)
    from volcano_tpu_torch.api.types import QOS_BEST_EFFORT, QOS_LEVEL_ANNOTATION

    def measured_offline(n) -> float:
        node = getattr(n, "node", None)
        try:
            return float(node.annotations.get(
                NODE_MEASURED_OFFLINE_ANNOTATION, 0)) if node else 0.0
        except (TypeError, ValueError):
            return 0.0

    saturated = [n for n in ssn.nodes.values()
                 if n.ready and n.node is not None
                 and n.node.annotations.get(
                     NODE_SATURATED_ANNOTATION) == "true"]
    if not saturated:
        return []
    saturated.sort(key=measured_offline, reverse=True)
    victims: List[TaskInfo] = []
    for node in saturated:
        def violation_count(t) -> int:
            try:
                return int(t.pod.annotations.get(
                    POD_VIOLATIONS_ANNOTATION, 0))
            except (TypeError, ValueError):
                return 0
        # worst offenders first: the biggest cumulative violator buys
        # the most relief per eviction
        for t in sorted(node.tasks.values(), key=violation_count,
                        reverse=True):
            pod = t.pod
            if pod.annotations.get(QOS_LEVEL_ANNOTATION) != \
                    QOS_BEST_EFFORT:
                continue        # only the offline tier is migratable
            if pod.annotations.get(POD_VIOLATING_ANNOTATION) != "true":
                continue
            if violation_count(t) < plugin.bw_chronic_violations:
                continue
            victim = _movable(plugin, t, node)
            if victim is None:
                continue
            victims.append(victim)
            if len(victims) >= plugin.max_victims:
                return victims
            break               # one victim per saturated host per pass
    return victims


@register_plugin("rescheduling")
class ReschedulingPlugin(Plugin):
    name = "rescheduling"

    def __init__(self, arguments=None):
        super().__init__(arguments)
        args = self.arguments
        self.interval = float(args.get("rescheduling.interval", 300))
        self.max_victims = int(args.get("rescheduling.maxVictims", 8))
        self.threshold_priority = float(args.get(
            "rescheduling.thresholdPriority", 2_000_000_000))
        names = args.get("rescheduling.strategies",
                         "lowNodeUtilization")
        if isinstance(names, str):
            names = [s.strip() for s in names.split(",") if s.strip()]
        unknown = [n for n in names if n not in STRATEGIES]
        if unknown:
            # a typo must not silently disable rebalancing
            import logging
            logging.getLogger(__name__).warning(
                "rescheduling: unknown strategies %s (registered: %s)",
                unknown, sorted(STRATEGIES))
        self.strategies = [STRATEGIES[n] for n in names
                           if n in STRATEGIES]
        # legacy flat thresholds double as uniform per-dim defaults
        low = float(args.get("rescheduling.lowThreshold", 0.2))
        high = float(args.get("rescheduling.highThreshold", 0.8))
        self.low_thresholds = dict(args.get(
            "lowNodeUtilization.thresholds",
            {"cpu": low, "memory": low}))
        self.target_thresholds = dict(args.get(
            "lowNodeUtilization.targetThresholds",
            {"cpu": high, "memory": high}))
        self.node_fit = bool(args.get("lowNodeUtilization.nodeFit",
                                      True))
        # bandwidthPressure: violating-sync count past which an
        # offline pod counts as a CHRONIC violator (one hysteresis
        # episode is FIRE_SYNCS syncs; default demands a sustained
        # offender, not a pod that tripped the watermark once)
        self.bw_chronic_violations = int(args.get(
            "bandwidthPressure.chronicViolations", 3))

    def on_session_open(self, ssn):
        self.ssn = ssn
        ssn.add_victim_tasks_fn(self.name, self._victims)

    def _victims(self) -> List[TaskInfo]:
        # interval limiter survives sessions on the cache's per-
        # scheduler scratch (plugin instances are per-session; a module
        # global would couple unrelated schedulers in one process)
        state = self.ssn.cache.plugin_state.setdefault(
            self.name, {"ts": 0.0})
        now = time.time()
        if now - state["ts"] < self.interval:
            return []
        state["ts"] = now      # the PASS is rate-limited, not the hit:
        # a zero-victim scan still costs O(nodes x tasks) and must not
        # re-run every session on a persistently imbalanced cluster
        victims: List[TaskInfo] = []
        seen = set()
        for strategy in self.strategies:
            for v in strategy(self, self.ssn):
                if v.uid not in seen:
                    seen.add(v.uid)
                    victims.append(v)
            if len(victims) >= self.max_victims:
                victims = victims[:self.max_victims]
                break
        return victims

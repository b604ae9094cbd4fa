"""Scheduler configuration: actions string + plugin tiers.

Reference parity: pkg/scheduler/conf/scheduler_conf.go +
pkg/scheduler/util.go:38-53 (DefaultSchedulerConf, UnmarshalSchedulerConf).

Config sources: a Python dict, or YAML text of the same shape as the
reference's ConfigMap:

    actions: "enqueue, allocate, backfill"
    tiers:
    - plugins:
      - name: priority
      - name: gang
      - name: conformance
    - plugins:
      - name: overcommit
      - name: drf
      - name: predicates
      - name: proportion
      - name: nodeorder
      - name: binpack
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class PluginOption:
    name: str
    # Per-callback enable flags (reference: enableJobOrder etc.); None
    # means plugin default.
    enabled: Dict[str, bool] = field(default_factory=dict)
    arguments: Dict[str, object] = field(default_factory=dict)

    def is_enabled(self, point: str, default: bool = True) -> bool:
        return self.enabled.get(point, default)


@dataclass
class Tier:
    plugins: List[PluginOption] = field(default_factory=list)


@dataclass
class SchedulerConf:
    actions: List[str] = field(default_factory=list)
    tiers: List[Tier] = field(default_factory=list)
    configurations: Dict[str, Dict[str, object]] = field(default_factory=dict)
    # ^ per-action arguments (reference conf.Configuration)

    def plugin_option(self, name: str) -> Optional[PluginOption]:
        for tier in self.tiers:
            for p in tier.plugins:
                if p.name == name:
                    return p
        return None

    def plugin_names(self) -> List[str]:
        return [p.name for t in self.tiers for p in t.plugins]


DEFAULT_SCHEDULER_CONF = {
    # elastic runs after allocate (fixed-size placement first) and
    # before backfill/gangpreempt: a free no-op when no job declares
    # an elastic range (actions/elastic.py)
    "actions": "enqueue, allocate, elastic, backfill",
    "tiers": [
        # failover: quarantined-slice filter + requeued-gang priority —
        # a cheap no-op until the failover controller quarantines a
        # slice (controllers/failover.py); elastic: shrink-before-
        # preempt veto + migration steering (plugins/elastic.py)
        {"plugins": [{"name": "priority"}, {"name": "gang"},
                     {"name": "failover"}, {"name": "elastic"},
                     {"name": "conformance"}]},
        # tier 2 mirrors the reference default's predicates wrap
        # (predicates.go:37 bundles nodeaffinity, podaffinity, taints,
        # ports, volume + spread): here those are separate plugins, so
        # the default enables the full set — each is a cheap no-op for
        # pods that don't use its feature
        {"plugins": [{"name": "overcommit"}, {"name": "drf"},
                     {"name": "predicates"},
                     {"name": "interpodaffinity"},
                     {"name": "pod-topology-spread"},
                     {"name": "volumebinding"},
                     {"name": "deviceshare"},
                     {"name": "proportion"},
                     {"name": "nodeorder"}, {"name": "binpack"}]},
    ],
}


def load_conf(source=None) -> SchedulerConf:
    """Build a SchedulerConf from a dict or YAML text (None => default)."""
    if source is None:
        data = DEFAULT_SCHEDULER_CONF
    elif isinstance(source, str):
        import yaml  # pyyaml ships with the baked-in ML stack
        data = yaml.safe_load(source)
    else:
        data = source

    actions = [a.strip() for a in str(data.get("actions", "")).split(",")
               if a.strip()]
    tiers: List[Tier] = []
    for tier_data in data.get("tiers", []):
        opts = []
        for p in tier_data.get("plugins", []):
            known = {"name", "arguments"}
            # "enableJobOrder: false" -> enabled["jobOrder"] = False,
            # matching the camelCase point names Session dispatches with.
            enabled = {}
            for k, v in p.items():
                if k in known or not isinstance(v, bool):
                    continue
                point = k[len("enable"):] if k.startswith("enable") else k
                enabled[point[0].lower() + point[1:]] = v
            opts.append(PluginOption(name=p["name"],
                                     enabled=enabled,
                                     arguments=dict(p.get("arguments", {}))))
        tiers.append(Tier(plugins=opts))
    configurations = {c["name"]: dict(c.get("arguments", {}))
                      for c in data.get("configurations", [])} \
        if isinstance(data.get("configurations"), list) else \
        dict(data.get("configurations", {}))
    return SchedulerConf(actions=actions, tiers=tiers,
                         configurations=configurations)

"""PDB plugin — respect PodDisruptionBudgets in evictions.

Reference parity: plugins/pdb/pdb.go:135-137.  Budgets are declared as
pod annotations (standalone analogue of the PDB CRD):
  volcano-tpu.io/disruption-group: <name>
  volcano-tpu.io/min-available:    <int>  (per group)
"""

from __future__ import annotations

from collections import defaultdict
from typing import List

from volcano_tpu_torch.api.job_info import TaskInfo
from volcano_tpu_torch.framework.plugins import Plugin, register_plugin

GROUP_ANNOTATION = "volcano-tpu.io/disruption-group"
MIN_AVAILABLE_ANNOTATION = "volcano-tpu.io/min-available"


@register_plugin("pdb")
class PDBPlugin(Plugin):
    name = "pdb"

    def on_session_open(self, ssn):
        from volcano_tpu_torch import features
        if not features.enabled("PodDisruptionBudgetsSupport"):
            return   # feature-gated off (features.py)
        self.ssn = ssn
        self._groups = None   # per-session membership memo
        ssn.add_preemptable_fn(self.name, self._filter)
        ssn.add_reclaimable_fn(self.name, self._filter)
        ssn.add_unified_evictable_fn(self.name, self._filter)

    def _group_index(self):
        """group -> [TaskInfo] membership, built once per session (task
        refs stay live, so statuses read fresh at filter time).  The
        old per-_filter cluster-wide scan was O(cluster) inside every
        preempt/reclaim candidate check."""
        idx = getattr(self, "_groups", None)
        if idx is None:
            idx = defaultdict(list)
            minima = {}
            for job in self.ssn.jobs.values():
                for t in job.tasks.values():
                    group = t.pod.annotations.get(GROUP_ANNOTATION)
                    if not group:
                        continue
                    idx[group].append(t)
                    raw = t.pod.annotations.get(MIN_AVAILABLE_ANNOTATION)
                    if raw is not None:
                        try:
                            minima[group] = max(minima.get(group, 0),
                                                int(raw))
                        except ValueError:
                            pass
            self._groups = idx
            self._minima = minima
        return idx, self._minima

    def _filter(self, ctx, candidates: List[TaskInfo]) -> List[TaskInfo]:
        # fast path: no candidate belongs to a disruption group
        if not any(t.pod.annotations.get(GROUP_ANNOTATION)
                   for t in candidates):
            return list(candidates)
        index, minima = self._group_index()
        # current healthy members, counted ONLY for groups in play
        # (statuses are read live — in-session evictions are seen)
        groups_in_play = {t.pod.annotations.get(GROUP_ANNOTATION)
                          for t in candidates} - {None, ""}
        healthy = defaultdict(int)
        for group in groups_in_play:
            for t in index.get(group, ()):
                if t.occupies_resources():
                    healthy[group] += 1

        victims = []
        planned = defaultdict(int)
        for t in candidates:
            group = t.pod.annotations.get(GROUP_ANNOTATION)
            if not group or group not in minima:
                victims.append(t)
                continue
            if healthy[group] - planned[group] - 1 >= minima[group]:
                victims.append(t)
                planned[group] += 1
        return victims

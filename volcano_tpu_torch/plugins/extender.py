"""Extender plugin — out-of-process policy hooks.

Reference parity: plugins/extender/extender.go:191-469 (HTTP webhook
protocol for external predicate/priority/eviction logic).  Rebuilt
transport-agnostic: the extender is any object implementing the hook
methods; an HTTPExtender adapter speaks JSON over HTTP for external
processes.  Arguments:
  extender.urlPrefix: http://...   (enables the HTTP adapter)
  or register a python object via register_extender() (tests, in-proc).
"""

from __future__ import annotations

import json
import logging
from typing import Dict, List, Optional

from volcano_tpu_torch.api.fit_error import unschedulable
from volcano_tpu_torch.api.job_info import JobInfo, TaskInfo
from volcano_tpu_torch.api.node_info import NodeInfo
from volcano_tpu_torch.framework.plugins import Plugin, register_plugin
from volcano_tpu_torch.framework.session import ABSTAIN, REJECT

log = logging.getLogger(__name__)

_EXTENDERS: Dict[str, object] = {}


def register_extender(name: str, extender: object):
    """In-process extender registration (tests / embedded policies)."""
    _EXTENDERS[name] = extender


class HTTPExtender:
    """JSON-over-HTTP adapter matching the reference wire protocol
    (predicate/prioritize/preemptable verbs under urlPrefix)."""

    def __init__(self, url_prefix: str, timeout: float = 1.0):
        self.url_prefix = url_prefix.rstrip("/")
        self.timeout = timeout

    def _post(self, verb: str, payload: dict) -> Optional[dict]:
        import urllib.request
        req = urllib.request.Request(
            f"{self.url_prefix}/{verb}",
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                return json.loads(resp.read())
        except Exception as e:  # noqa: BLE001
            log.warning("extender %s/%s failed: %s",
                        self.url_prefix, verb, e)
            return None

    def predicate(self, task: TaskInfo, node: NodeInfo):
        out = self._post("predicate", {
            "task": task.key, "node": node.name})
        if out is None or out.get("allowed", True):
            return None
        return out.get("reason", "denied by extender")

    def prioritize(self, task: TaskInfo, nodes: List[NodeInfo]):
        out = self._post("prioritize", {
            "task": task.key, "nodes": [n.name for n in nodes]})
        return (out or {}).get("scores", {})


@register_plugin("extender")
class ExtenderPlugin(Plugin):
    name = "extender"

    def __init__(self, arguments=None):
        super().__init__(arguments)
        url = self.arguments.get("extender.urlPrefix")
        self.extenders: List[object] = list(_EXTENDERS.values())
        if url:
            self.extenders.append(HTTPExtender(
                str(url),
                float(self.arguments.get("extender.httpTimeout", 1.0))))

    def on_session_open(self, ssn):
        if not self.extenders:
            return
        # external verdicts may key on task identity or external state:
        # opt out of the per-spec predicate cache
        ssn.task_dependent_predicates.add(self.name)
        ssn.add_predicate_fn(self.name, self._predicate)
        ssn.add_batch_node_order_fn(self.name, self._batch_order)
        ssn.add_job_enqueueable_fn(self.name, self._enqueueable)
        ssn.add_preemptable_fn(self.name, self._preemptable)

    def _predicate(self, task: TaskInfo, node: NodeInfo):
        for ext in self.extenders:
            fn = getattr(ext, "predicate", None)
            if fn is None:
                continue
            reason = fn(task, node)
            if reason:
                return unschedulable(str(reason), "extender")
        return None

    def _batch_order(self, task: TaskInfo, nodes: List[NodeInfo]):
        scores: Dict[str, float] = {}
        for ext in self.extenders:
            fn = getattr(ext, "prioritize", None)
            if fn is None:
                continue
            for name, s in (fn(task, nodes) or {}).items():
                scores[name] = scores.get(name, 0.0) + float(s)
        return scores

    def _enqueueable(self, job: JobInfo) -> int:
        for ext in self.extenders:
            fn = getattr(ext, "job_enqueueable", None)
            if fn is not None and fn(job) is False:
                return REJECT
        return ABSTAIN

    def _preemptable(self, ctx, candidates: List[TaskInfo]):
        allowed = None
        for ext in self.extenders:
            fn = getattr(ext, "preemptable", None)
            if fn is None:
                continue
            result = fn(ctx, candidates)
            if result is not None:
                uids = {t.uid for t in result}
                allowed = uids if allowed is None else allowed & uids
        if allowed is None:
            return None
        return [t for t in candidates if t.uid in allowed]

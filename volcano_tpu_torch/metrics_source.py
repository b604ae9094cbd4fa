"""External usage metrics sources for the node agent / usage plugin.

Reference parity: pkg/scheduler/metrics/source
(metrics_client_{prometheus,elasticsearch}.go) — pulls real node
utilization from a metrics backend.  Here the Prometheus client reads
exposition-format text over HTTP and feeds the agent's UsageProvider
protocol; metric names are configurable:

    node_cpu_usage_fraction{node="sa-w0"} 0.42
    node_memory_usage_fraction{node="sa-w0"} 0.61
"""

from __future__ import annotations

import logging
import re
import urllib.request
from typing import Dict, Tuple

from volcano_tpu_torch.agent.agent import NodeUsage, UsageProvider

log = logging.getLogger(__name__)

# 'name{labels} value [timestamp]' — federation endpoints append the
# millisecond timestamp
_SAMPLE = re.compile(
    r'^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)\{(?P<labels>[^}]*)\}\s+'
    r'(?P<value>[-+0-9.eEna]+)(?:\s+\d+)?\s*$')
_LABEL = re.compile(r'(\w+)="([^"]*)"')


def parse_exposition(text: str) -> Dict[Tuple[str, str], float]:
    """{(metric, node): value} for node-labeled samples."""
    out: Dict[Tuple[str, str], float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE.match(line)
        if not m:
            continue
        labels = dict(_LABEL.findall(m.group("labels")))
        node = labels.get("node") or labels.get("instance")
        if not node:
            continue
        try:
            out[(m.group("name"), node)] = float(m.group("value"))
        except ValueError:
            continue
    return out


class ElasticsearchUsageSource(UsageProvider):
    """Queries an Elasticsearch metricbeat-style index for per-node
    usage (reference: metrics_client_elasticsearch.go — avg of
    system.cpu/memory pct over a trailing window, one search per
    refresh).

    Issues one `_search` POST with a terms-by-hostname aggregation and
    avg sub-aggregations, so a cluster of N nodes costs one round trip:

        POST {url}/{index}/_search
        {"size": 0, "query": {"range": {"@timestamp": {"gte": "now-Xs"}}},
         "aggs": {"nodes": {"terms": {"field": "host.hostname", ...},
                  "aggs": {"cpu": {"avg": {"field": <cpu_field>}},
                           "mem": {"avg": {"field": <mem_field>}}}}}}
    """

    def __init__(self, url: str, index: str = "metricbeat-*",
                 cpu_field: str = "system.cpu.total.norm.pct",
                 mem_field: str = "system.memory.actual.used.pct",
                 hostname_field: str = "host.hostname",
                 window_s: float = 300.0,
                 timeout: float = 5.0,
                 stale_after: float = 120.0):
        self.url = url.rstrip("/")
        self.index = index
        self.cpu_field = cpu_field
        self.mem_field = mem_field
        self.hostname_field = hostname_field
        self.window_s = window_s
        self.timeout = timeout
        self.stale_after = stale_after
        self._usage: Dict[str, NodeUsage] = {}
        self._last_success = 0.0

    def _query(self) -> bytes:
        import json
        return json.dumps({
            "size": 0,
            "query": {"range": {"@timestamp": {
                "gte": f"now-{int(self.window_s)}s"}}},
            "aggs": {"nodes": {
                "terms": {"field": self.hostname_field, "size": 10000},
                "aggs": {"cpu": {"avg": {"field": self.cpu_field}},
                         "mem": {"avg": {"field": self.mem_field}}}}},
        }).encode()

    def refresh(self) -> bool:
        import json
        import time
        req = urllib.request.Request(
            f"{self.url}/{self.index}/_search", data=self._query(),
            headers={"Content-Type": "application/json"}, method="POST")
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                body = json.loads(resp.read().decode())
        except Exception as e:  # noqa: BLE001 - degrade, don't crash
            log.warning("es usage query to %s failed: %s", self.url, e)
            return False
        usage: Dict[str, NodeUsage] = {}
        buckets = (body.get("aggregations", {})
                   .get("nodes", {}).get("buckets", []))
        for b in buckets:
            name = b.get("key")
            if not name:
                continue
            cpu = (b.get("cpu") or {}).get("value")
            mem = (b.get("mem") or {}).get("value")
            usage[name] = NodeUsage(
                cpu_fraction=float(cpu) if cpu is not None else 0.0,
                memory_fraction=float(mem) if mem is not None else 0.0)
        self._usage = usage
        self._last_success = time.time()
        return True

    def usage(self, node_name: str) -> NodeUsage:
        import time
        if time.time() - self._last_success > self.stale_after:
            # same TTL contract as the Prometheus source: a dead
            # backend must read as "unknown", never as stale pressure
            return NodeUsage()
        return self._usage.get(node_name, NodeUsage())


class PrometheusUsageSource(UsageProvider):
    """Scrapes a Prometheus-format endpoint for per-node usage."""

    def __init__(self, url: str,
                 cpu_metric: str = "node_cpu_usage_fraction",
                 mem_metric: str = "node_memory_usage_fraction",
                 timeout: float = 2.0,
                 stale_after: float = 60.0):
        self.url = url
        self.cpu_metric = cpu_metric
        self.mem_metric = mem_metric
        self.timeout = timeout
        self.stale_after = stale_after
        self._samples: Dict[Tuple[str, str], float] = {}
        self._last_success = 0.0

    def refresh(self) -> bool:
        import time
        try:
            with urllib.request.urlopen(self.url,
                                        timeout=self.timeout) as resp:
                self._samples = parse_exposition(resp.read().decode())
            self._last_success = time.time()
            return True
        except Exception as e:  # noqa: BLE001 - degrade, don't crash
            log.warning("usage scrape of %s failed: %s", self.url, e)
            return False

    def usage(self, node_name: str) -> NodeUsage:
        import time
        if time.time() - self._last_success > self.stale_after:
            # bound the damage of a dead endpoint: past the TTL report
            # "unknown" (zeros) rather than acting on stale pressure
            return NodeUsage()
        return NodeUsage(
            cpu_fraction=self._samples.get(
                (self.cpu_metric, node_name), 0.0),
            memory_fraction=self._samples.get(
                (self.mem_metric, node_name), 0.0),
        )

"""Registry of object kinds the cluster store holds.

One table shared by FakeCluster (in-memory store), the state server
(HTTP apiserver analogue) and RemoteCluster (client mirror), so the
three never drift on what kinds exist, which attribute holds them, and
how an object keys itself.  Reference analogue: the CRD scheme
registration in staging/src/volcano.sh/apis (one Group/Version/Kind
table driving clientsets, informers and the apiserver alike).

Dict-kinds (services, config maps, secrets, PVCs, PVs, datasources)
hold plain dicts whose key the writer supplies; typed kinds derive the
key from the object.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional


class KindSpec(NamedTuple):
    attr: str                                # store attribute on Cluster
    key_of: Optional[Callable[[object], str]]  # None => caller supplies


def _key(obj) -> str:
    return obj.key


def _name(obj) -> str:
    return obj.name


KINDS: Dict[str, KindSpec] = {
    "pod": KindSpec("pods", _key),
    "node": KindSpec("nodes", _name),
    "podgroup": KindSpec("podgroups", _key),
    "queue": KindSpec("queues", _name),
    "hypernode": KindSpec("hypernodes", _name),
    "priority_class": KindSpec("priority_classes", _name),
    "vcjob": KindSpec("vcjobs", _key),
    "jobflow": KindSpec("jobflows", _key),
    "jobtemplate": KindSpec("jobtemplates", _key),
    "cronjob": KindSpec("cronjobs", _key),
    "hyperjob": KindSpec("hyperjobs", _key),
    "nodeshard": KindSpec("nodeshards", _name),
    "numatopology": KindSpec("numatopologies", _name),
    # per-node DCN bandwidth accounting report (api/netusage.py):
    # posted by the node agent, folded into node annotations by the
    # store so scheduler mirrors see saturation without decoding it
    "bandwidthreport": KindSpec("bandwidthreports", _name),
    # per-host chip-health verdict (api/slicehealth.py): posted by the
    # node agent's hysteresis, folded into node annotations by the
    # store; the failover controller declares slice failures from it
    "slicehealthreport": KindSpec("slicehealthreports", _name),
    # per-node workload step-progress report (api/goodput.py): posted
    # by the node agent, folded into PODGROUP annotations by the store
    # so scheduler mirrors learn per-job step rates / goodput from
    # ordinary podgroup events
    "goodputreport": KindSpec("goodputreports", _name),
    # per-node serving traffic report (api/serving.py): posted by the
    # node agent, folded into PODGROUP annotations by the store so the
    # serving autoscaler reads QPS/p99 from ordinary podgroup events
    "servingreport": KindSpec("servingreports", _name),
    # plain-dict kinds (plugin/operator supplied payloads)
    # namespace -> annotations dict (podgroup mutate webhook reads the
    # per-namespace default-queue annotation)
    "namespace": KindSpec("namespaces", None),
    # federation region registry (api/federation.py): region name ->
    # record dict {url, price, locality, heartbeat...}, held by the
    # GLOBAL store and reconciled by the federation router
    "region": KindSpec("regions", None),
    # stitched cross-plane episode trace (federation/stitch.py):
    # episode ID -> the latest stitched span-tree doc, written by the
    # leaseholder router into the GLOBAL store so `GET /fleet_trace`
    # and a promoted standby both read the same durable artifact
    "fleet_trace": KindSpec("fleet_traces", None),
    # router circuit-breaker snapshots (federation/retry.py): region
    # name -> {state, failures, opens, retry_in_s, last_trip_ts},
    # written on trip/close so a promoted standby adopts learned
    # region health instead of re-probing from closed
    "router_breaker": KindSpec("router_breakers", None),
    # fleet SLO snapshot (federation/slo.py): "global" -> burn-rate /
    # attainment doc the router recomputes each pass (vtpctl slo)
    "slo": KindSpec("slos", None),
    "service": KindSpec("services", None),
    "config_map": KindSpec("config_maps", None),
    "secret": KindSpec("secrets", None),
    "pvc": KindSpec("pvcs", None),
    "pv": KindSpec("pvs", None),
    "datasource": KindSpec("datasources", None),
}


def key_for(kind: str, obj, key: Optional[str] = None) -> str:
    spec = KINDS[kind]
    if key is not None:
        return key
    if spec.key_of is None:
        raise ValueError(f"kind {kind!r} needs an explicit key")
    return spec.key_of(obj)

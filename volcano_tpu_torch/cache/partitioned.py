"""PartitionedCluster: keyspace-partitioned write plane over N
quorum-replicated leader groups.

server/replication.py gives the state server quorum replication: one
elected leader per replica group absorbs every write.  At fleet scale
that single leader group is the write bottleneck — every node
heartbeat, pod phase flush and gang bind funnels through one process.
This module splits the keyspace across N independent leader groups,
each running that machinery UNCHANGED:

  * nodes — and the pods bound to them — are partitioned by the same
    deterministic topology-subtree plan the scheduler shards use
    (volcano_tpu_torch/shardmap.py), so a gang's bind batch lands on the
    leader group that owns its subtree;
  * group 0 is additionally the META group: queues, podgroups,
    hypernodes, priority classes, vcjobs, commands, leases, and every
    PENDING (nodeless) pod live there;
  * a bind RELOCATES the pod from the meta group to the node's group:
    the /bind_batch item carries the encoded pod, the owning server
    admits-then-binds it atomically under its bind mutex (so its chip
    accounting sees node and occupant together), and the client then
    deletes the pending copy from the meta group.  A crash between
    those two steps leaves a benign duplicate whose meta copy is
    Pending and nodeless; the bound copy (merged LAST, see
    __getattr__) wins every read, and the next bind retry's
    state-compare deletes the leftover.

Capacity arbitration is therefore PER GROUP and exactly as strong as
before: two scheduler shards racing for chips on one node are racing
on ONE leader group's atomic check-and-bind, whichever shard's batch
arrives second collects the per-item 409.

Reads merge the N mirrors (meta first, node groups override), so the
scheduler cache, controllers and tools see one cluster.  The merge
builds fresh dicts per access — the partitioned plane trades read-
view construction cost for N-way write throughput, which is the
right trade for the write-bound fleets it exists for.

Endpoint syntax (CLI --cluster-url): semicolon-separated groups, each
a comma-separated replica list routed by RemoteCluster's own
leader-follower logic:

    http://a1,http://a2,http://a3;http://b1,http://b2;http://c1
"""

from __future__ import annotations

import logging
import threading
from typing import Dict, List, Optional

from volcano_tpu_torch import shardmap
from volcano_tpu_torch.api import codec
from volcano_tpu_torch.api.types import TaskStatus
from volcano_tpu_torch.cache.cluster import Cluster, ClusterSnapshot
from volcano_tpu_torch.cache.kinds import KINDS
from volcano_tpu_torch.cache.remote_cluster import RemoteCluster, RemoteError

log = logging.getLogger(__name__)

# kinds that always live in the meta group regardless of content
_META_GROUP = 0


def split_endpoint_groups(spec: str) -> List[str]:
    """'a1,a2;b1;c1,c2' -> ['a1,a2', 'b1', 'c1,c2'] (whitespace ok)."""
    return [part.strip() for part in spec.split(";") if part.strip()]


class PartitionedCluster(Cluster):
    def __init__(self, groups, start_watch: bool = True,
                 timeout: float = 10.0, token: str = "",
                 ca_cert: str = "", insecure: bool = False,
                 tolerate_unreachable: bool = False):
        """groups: endpoint spec string ('g0;g1;g2', each group a
        comma-separated replica list), or a prebuilt list of
        RemoteCluster instances (tests)."""
        if isinstance(groups, str):
            groups = split_endpoint_groups(groups)
        built: List[RemoteCluster] = []
        for g in groups:
            if isinstance(g, RemoteCluster):
                built.append(g)
            else:
                built.append(RemoteCluster(
                    g, start_watch=start_watch, timeout=timeout,
                    token=token, ca_cert=ca_cert, insecure=insecure,
                    tolerate_unreachable=tolerate_unreachable))
        if not built:
            raise ValueError("PartitionedCluster needs >= 1 group")
        self.groups = built
        self._route_lock = threading.Lock()

    # -- routing -------------------------------------------------------

    def _group_of_node(self, node_name: str) -> int:
        """The group whose mirror holds the node (authoritative: the
        object IS where it lives), else the deterministic plan's owner
        for a node we are about to create."""
        for i, g in enumerate(self.groups):
            if node_name in g.nodes:
                return i
        subtrees: Dict[str, str] = {}
        for g in self.groups:
            for n in g.nodes.values():
                subtrees[n.name] = shardmap.subtree_of(
                    getattr(n, "labels", None))
        if node_name not in subtrees:
            return _META_GROUP
        return shardmap.owner_index(
            subtrees, len(self.groups)).get(node_name, _META_GROUP)

    def _route_new_node(self, node) -> int:
        """Owner group for a node being created: recompute the plan
        over the union of every mirror's nodes plus this one, so all
        writers agree without a coordination round."""
        subtrees: Dict[str, str] = {}
        for g in self.groups:
            for n in g.nodes.values():
                subtrees[n.name] = shardmap.subtree_of(
                    getattr(n, "labels", None))
        subtrees[node.name] = shardmap.subtree_of(
            getattr(node, "labels", None))
        return shardmap.owner_index(
            subtrees, len(self.groups)).get(node.name, _META_GROUP)

    def _group_of_pod(self, key: str) -> Optional[int]:
        # node groups first: during a relocation overlap the BOUND
        # copy, not the stale pending one, must answer routing
        for i in range(len(self.groups) - 1, -1, -1):
            if key in self.groups[i].pods:
                return i
        return None

    def _group_of_key(self, kind: str, key: str) -> int:
        attr = KINDS[kind].attr
        for i in range(len(self.groups) - 1, -1, -1):
            if key in getattr(self.groups[i], attr):
                return i
        return _META_GROUP

    @property
    def meta(self) -> RemoteCluster:
        return self.groups[_META_GROUP]

    def _request(self, method: str, path: str, payload=None, **kw):
        """Observability traffic (trace.publish duck-types on
        `_request`) rides the meta group; keyspace-routed writes never
        come through here — bind_pods targets each group directly."""
        return self.meta._request(method, path, payload, **kw)

    def shard_layout(self) -> List[dict]:
        """Ownership table for tools: one row per group with its node
        count and subtree count (vtpctl shards)."""
        rows = []
        for i, g in enumerate(self.groups):
            subtrees = {shardmap.subtree_of(getattr(n, "labels", None))
                        for n in g.nodes.values()}
            rows.append({"group": i, "endpoints": g.endpoints,
                         "nodes": len(g.nodes),
                         "subtrees": len(subtrees),
                         "meta": i == _META_GROUP})
        return rows

    # -- merged read surface -------------------------------------------

    def __getattr__(self, name: str):
        # merged store views (pods, nodes, podgroups, ...): meta group
        # first so a node group's copy of a relocating pod overrides
        # the meta leftover.  __getattr__ only fires when the instance
        # lacks the attribute, so real attributes stay cheap.
        for spec in KINDS.values():
            if spec.attr == name:
                merged: dict = {}
                for g in self.groups:
                    merged.update(getattr(g, name))
                return merged
        if name == "commands":
            return list(self.meta.commands)
        if name == "events":
            return list(self.meta.events)
        raise AttributeError(name)

    def list_all(self) -> ClusterSnapshot:
        return ClusterSnapshot(
            pods=list(self.pods.values()),
            nodes=list(self.nodes.values()),
            podgroups=list(self.podgroups.values()),
            queues=list(self.queues.values()),
            hypernodes=list(self.hypernodes.values()),
            priority_classes=list(self.priority_classes.values()),
            vcjobs=list(self.vcjobs.values()),
        )

    def watch(self, fn) -> None:
        for g in self.groups:
            g.watch(fn)

    def unwatch(self, fn) -> None:
        for g in self.groups:
            g.unwatch(fn)

    def resync(self) -> None:
        for g in self.groups:
            g.resync()

    def close(self) -> None:
        for g in self.groups:
            g.close()

    # -- generic object store ------------------------------------------

    def put_object(self, kind: str, obj, key: Optional[str] = None):
        if kind == "node":
            gi = self._group_of_node(obj.name) \
                if obj.name in self.nodes else self._route_new_node(obj)
            return self.groups[gi].put_object(kind, obj, key=key)
        if kind == "pod":
            node = getattr(obj, "node_name", None)
            pod_key = key or getattr(obj, "key", None)
            if pod_key is not None:
                held = self._group_of_pod(pod_key)
                if held is not None:
                    # status flushes follow the object, wherever the
                    # bind relocation put it
                    return self.groups[held].put_object(kind, obj,
                                                        key=key)
            gi = self._group_of_node(node) if node else _META_GROUP
            return self.groups[gi].put_object(kind, obj, key=key)
        return self.meta.put_object(kind, obj, key=key)

    def delete_object(self, kind: str, key: str) -> None:
        self.groups[self._group_of_key(kind, key)].delete_object(
            kind, key)

    # -- scheduler write path ------------------------------------------

    def bind_pod(self, namespace: str, name: str, node_name: str,
                 ts_alloc: Optional[float] = None) -> None:
        err = self.bind_pods(
            [(namespace, name, node_name, ts_alloc)])[0]
        if err is not None:
            raise ValueError(err)

    def bind_pods(self, binds) -> List[Optional[str]]:
        """Split the gang's binds by owning leader group — one
        idempotency-keyed /bind_batch per group per cycle — carrying
        the encoded pod on items whose pod lives elsewhere (the
        relocation payload).  Per-item verdicts keep flush_binds'
        bookkeeping identical to the single-group plane."""
        binds = [tuple(b) + (None,) * (4 - len(b)) for b in binds]
        if not binds:
            return []
        errors: List[Optional[str]] = [None] * len(binds)
        by_group: Dict[int, List[int]] = {}
        for pos, (_ns, _name, node, _ts) in enumerate(binds):
            by_group.setdefault(self._group_of_node(node),
                                []).append(pos)
        for gi, positions in sorted(by_group.items()):
            group = self.groups[gi]
            items = []
            relocations: Dict[int, int] = {}     # position -> src group
            for pos in positions:
                ns, name, node, ts = binds[pos]
                pod_key = f"{ns}/{name}"
                item = {"namespace": ns, "name": name,
                        "node_name": node}
                if ts is not None:
                    item["ts_alloc"] = ts
                src = self._group_of_pod(pod_key)
                if src is not None and src != gi:
                    pod = self.groups[src].pods.get(pod_key)
                    if pod is not None:
                        item["pod"] = codec.encode(pod)
                        relocations[pos] = src
                items.append(item)
            try:
                resp = group._request("POST", "/bind_batch",
                                      {"binds": items},
                                      idempotency_key=True)
                results = resp["results"]
                if len(results) != len(items):
                    raise RemoteError(
                        500, f"bind_batch result count {len(results)} "
                             f"!= {len(items)}")
            except Exception as e:  # noqa: BLE001 — per-group failure
                msg = str(e) or type(e).__name__
                for pos in positions:
                    errors[pos] = msg
                continue
            for pos, r in zip(positions, results):
                ns, name, node, _ts = binds[pos]
                pod_key = f"{ns}/{name}"
                if not r.get("ok"):
                    errors[pos] = r.get("error", "bind failed")
                    continue
                # echo into the owning group's mirror (relocated pods
                # aren't there until the watch round-trip otherwise)
                with group._mlock:
                    pod = group.pods.get(pod_key)
                    if pod is None:
                        src = relocations.get(pos)
                        src_pod = self.groups[src].pods.get(pod_key) \
                            if src is not None else None
                        if src_pod is not None:
                            pod = codec.decode(codec.encode(src_pod))
                            group.pods[pod_key] = pod
                    if pod is not None:
                        pod.node_name = node
                        pod.phase = TaskStatus.BOUND
                src = relocations.get(pos)
                if src is not None:
                    # retire the meta-group pending copy; best-effort,
                    # the bound copy already wins every merged read
                    try:
                        self.groups[src].delete_object("pod", pod_key)
                    except Exception:  # noqa: BLE001
                        log.debug("pending-copy cleanup for %s failed",
                                  pod_key, exc_info=True)
        return errors

    def _pod_group(self, namespace: str, name: str) -> RemoteCluster:
        gi = self._group_of_pod(f"{namespace}/{name}")
        return self.groups[gi if gi is not None else _META_GROUP]

    def evict_pod(self, namespace: str, name: str,
                  reason: str = "") -> None:
        self._pod_group(namespace, name).evict_pod(namespace, name,
                                                   reason)

    def nominate_pod(self, namespace: str, name: str,
                     node_name: str) -> None:
        self._pod_group(namespace, name).nominate_pod(namespace, name,
                                                      node_name)

    def update_podgroup_status(self, pg) -> None:
        self.meta.update_podgroup_status(pg)

    def record_event(self, obj_key: str, reason: str,
                     message: str) -> None:
        self.meta.record_event(obj_key, reason, message)

    # -- typed conveniences (FakeCluster surface) ----------------------

    def add_node(self, node):
        return self.put_object("node", node)

    def remove_node(self, name: str):
        self.delete_object("node", name)

    def add_pod(self, pod) -> None:
        self.put_object("pod", pod)

    def delete_pod(self, key: str) -> None:
        self.delete_object("pod", key)

    def add_podgroup(self, pg) -> None:
        self.put_object("podgroup", pg)

    def delete_podgroup(self, key: str) -> None:
        self.delete_object("podgroup", key)

    def add_queue(self, queue):
        return self.put_object("queue", queue)

    def add_hypernode(self, hn) -> None:
        self.put_object("hypernode", hn)

    def delete_hypernode(self, name: str) -> None:
        self.delete_object("hypernode", name)

    def add_numatopology(self, topo) -> None:
        self.put_object("numatopology", topo)

    def add_priority_class(self, pc) -> None:
        self.put_object("priority_class", pc)

    def add_vcjob(self, job):
        return self.put_object("vcjob", job)

    def update_vcjob(self, job) -> None:
        self.put_object("vcjob", job, key=job.key)

    def delete_vcjob(self, key: str) -> None:
        self.delete_object("vcjob", key)

    # -- command bus / lease / simulation ------------------------------

    def add_command(self, target_key: str, action: str) -> None:
        self.meta.add_command(target_key, action)

    def drain_commands(self, target_key: str):
        return self.meta.drain_commands(target_key)

    def lease(self, name: str, holder: str, ttl: float = 15.0,
              release: bool = False,
              deadline: Optional[float] = None) -> dict:
        return self.meta.lease(name, holder, ttl, release=release,
                               deadline=deadline)

    def tick(self) -> None:
        # every group's simulated kubelet advances: bound pods start
        # running on the group that owns their node
        for g in self.groups:
            g.tick()

    def complete_pod(self, key: str, succeeded: bool = True,
                     exit_code=None) -> None:
        gi = self._group_of_pod(key)
        self.groups[gi if gi is not None else _META_GROUP].complete_pod(
            key, succeeded=succeeded, exit_code=exit_code)

"""HyperNode auto-discovery controller.

Reference parity: pkg/controllers/hypernode (pluggable discovery.Manager
with label/UFM providers, discovery/manager.go:47).  Two discoverers:

- ``LabelDiscoverer`` (default) reads GPU Feature Discovery node labels
  — the label provider analogue: tier 1 = one HyperNode per NVLink
  domain (`nvidia.com/gpu.clique`; on an HGX host the domain is the
  host), tier 2 = one per InfiniBand fabric/zone
  (`volcano-tpu.io/ib-fabric` / `topology.kubernetes.io/zone`).
- ``FabricDiscoverer`` queries a fabric-inventory HTTP API — the UFM
  provider analogue (discovery/ufm/ufm.go): NVLink domains from link
  records (connected components over nvlink links) and IB fabrics from
  the hosts' IB attachment records.

GPU-less / unlinked nodes stay outside the tree (the session's virtual
root still covers them).
"""

from __future__ import annotations

import json
import logging
import time
import urllib.request
from collections import defaultdict
from typing import Dict, List, Optional

from volcano_tpu_torch.api.hypernode import HyperNode
from volcano_tpu_torch.api.node_info import Node
from volcano_tpu_torch.api.types import GPU_CLIQUE_LABEL
from volcano_tpu_torch.controllers.framework import Controller, register_controller

log = logging.getLogger(__name__)

IB_FABRIC_LABEL = "volcano-tpu.io/ib-fabric"
ZONE_LABEL = "topology.kubernetes.io/zone"
FABRIC_LINKS_PATH = "/fabric/v1/links"


class LabelDiscoverer:
    """Builds the desired HyperNode set from node labels."""

    def discover(self, nodes: List[Node]) -> List[HyperNode]:
        slices: Dict[str, List[str]] = defaultdict(list)
        slice_pod: Dict[str, str] = {}
        for node in nodes:
            slice_name = node.labels.get(GPU_CLIQUE_LABEL)
            if not slice_name:
                continue
            slices[slice_name].append(node.name)
            pod = node.labels.get(IB_FABRIC_LABEL) or \
                node.labels.get(ZONE_LABEL)
            if pod:
                slice_pod[slice_name] = pod

        out: List[HyperNode] = []
        pods: Dict[str, List[str]] = defaultdict(list)
        for slice_name, members in sorted(slices.items()):
            out.append(HyperNode.of_nodes(slice_name, 1, sorted(members),
                                          tier_name="nvlink-domain"))
            pod = slice_pod.get(slice_name)
            if pod:
                pods[pod].append(slice_name)
        for pod, children in sorted(pods.items()):
            out.append(HyperNode.of_children(pod, 2, sorted(children),
                                             tier_name="ib-fabric"))
        return out


class FabricDiscoverer:
    """Builds the desired HyperNode set from a fabric-inventory API.

    ``GET <endpoint>/fabric/v1/links`` must return a JSON list of link
    records (the NVLink analogue of UFM's ``/ufmRest/resources/ports``):

      {"kind": "nvlink", "a": "host-0", "b": "host-1", "fabric": "nvl-a"}
      {"kind": "ib", "host": "host-0", "fabric": "ib-1"}

    Hosts joined (transitively) by nvlink links form one tier-1 NVLink
    domain — the connected-component grouping UFM applies to leaf
    switches (ufm.go LeafSwitchesGroup); the domain is named by its
    records' ``fabric`` field when consistent, else by its
    lexicographically smallest host.  ``ib`` records group domains
    under tier-2 IB fabrics (a domain joins the fabric the majority of
    its hosts attach to).

    Results are cached for ``refresh_s``; on fetch failure the last
    good topology is served (degrade, don't flap — same posture as the
    usage sources).  ``token`` is sent as a bearer credential (the
    secret-ref analogue of UFM basic auth).
    """

    def __init__(self, endpoint: str, token: str = "",
                 refresh_s: float = 30.0, timeout_s: float = 10.0):
        self.endpoint = endpoint.rstrip("/")
        self.token = token
        self.refresh_s = refresh_s
        self.timeout_s = timeout_s
        self._next_fetch = 0.0
        self._ever_fetched = False
        self._cached: List[HyperNode] = []

    # -- fetching ------------------------------------------------------

    def _fetch_links(self) -> Optional[List[dict]]:
        url = self.endpoint + FABRIC_LINKS_PATH
        req = urllib.request.Request(url)
        if self.token:
            req.add_header("Authorization", f"Bearer {self.token}")
        try:
            with urllib.request.urlopen(req,
                                        timeout=self.timeout_s) as resp:
                records = json.load(resp)
        except Exception as e:  # noqa: BLE001 - degrade, don't crash
            log.warning("fabric inventory fetch from %s failed: %s",
                        url, e)
            return None
        if not isinstance(records, list):
            log.warning("fabric inventory %s returned non-list payload",
                        url)
            return None
        return records

    # -- topology building --------------------------------------------

    @staticmethod
    def build(records: List[dict]) -> List[HyperNode]:
        # union-find over nvlink links
        parent: Dict[str, str] = {}

        def find(x: str) -> str:
            parent.setdefault(x, x)
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        def union(a: str, b: str):
            ra, rb = find(a), find(b)
            if ra != rb:
                parent[rb] = ra

        fabric_votes: Dict[str, List[str]] = defaultdict(list)
        host_pod: Dict[str, str] = {}
        for rec in records:
            if not isinstance(rec, dict):
                continue
            kind = rec.get("kind")
            if kind == "nvlink":
                a, b = rec.get("a"), rec.get("b")
                if not a or not b:
                    continue
                union(a, b)
                fab = rec.get("fabric")
                if fab:
                    fabric_votes[find(a)].append(fab)
            elif kind == "ib":
                host, pod = rec.get("host"), rec.get("fabric")
                if host and pod:
                    host_pod[host] = pod
                    # a host reported only via its IB uplink (a
                    # single-host domain has no nvlink links) must still be
                    # in the topology: seed a union-find singleton (the
                    # reference UFM provider groups every inventoried
                    # node, discovery/ufm/)
                    find(host)

        comps: Dict[str, List[str]] = defaultdict(list)
        for host in parent:
            comps[find(host)].append(host)

        # fabric names may repeat across disjoint components (or
        # collide with pod names); every emitted HyperNode name must be
        # unique or the controller's desired-set dict would silently
        # drop one (and its hosts) from the topology
        used: set = set()

        def unique(candidate: str, fallback_suffix: str) -> str:
            name = candidate
            if name in used:
                name = f"{candidate}-{fallback_suffix}"
            n = 2
            while name in used:
                name = f"{candidate}-{fallback_suffix}-{n}"
                n += 1
            if name != candidate:
                log.warning("fabric topology name %r already taken; "
                            "emitting %r", candidate, name)
            used.add(name)
            return name

        out: List[HyperNode] = []
        pods: Dict[str, List[str]] = defaultdict(list)
        for members in sorted(comps.values(), key=lambda m: min(m)):
            members.sort()
            root = find(members[0])
            # votes were keyed by the root AT RECORD TIME; re-key now
            names = {f for r, votes in fabric_votes.items()
                     if find(r) == root for f in votes}
            candidate = names.pop() if len(names) == 1 else \
                f"fabric-{members[0]}"
            slice_name = unique(candidate, members[0])
            out.append(HyperNode.of_nodes(slice_name, 1, members,
                                          tier_name="nvlink-domain"))
            pod_votes: Dict[str, int] = defaultdict(int)
            for m in members:
                pod = host_pod.get(m)
                if pod:
                    pod_votes[pod] += 1
            if pod_votes:
                best = max(sorted(pod_votes), key=pod_votes.get)
                pods[best].append(slice_name)
        out.sort(key=lambda hn: hn.name)
        for pod, children in sorted(pods.items()):
            out.append(HyperNode.of_children(unique(pod, "ib"), 2,
                                             sorted(children),
                                             tier_name="ib-fabric"))
        return out

    def discover(self, nodes: List[Node]) -> List[HyperNode]:
        del nodes  # fabric topology is authoritative, not label-derived
        now = time.monotonic()
        if now >= self._next_fetch:
            records = self._fetch_links()
            if records is not None:
                self._cached = self.build(records)
                self._ever_fetched = True
                self._next_fetch = now + self.refresh_s
            else:
                # quick retry while degraded, but never hammer
                self._next_fetch = now + min(5.0, self.refresh_s)
        if not self._ever_fetched:
            # never had data: abort this sync rather than hand the
            # controller an empty set it would GC real hypernodes by
            raise RuntimeError(
                f"fabric inventory {self.endpoint} has not answered yet")
        return self._cached


def make_discoverer(spec: str):
    """``label`` (default) or ``fabric:ENDPOINT[#TOKEN]`` — the
    configmap-driven provider selection analogue
    (hypernode/configmap_handler.go)."""
    if not spec or spec == "label":
        return LabelDiscoverer()
    if spec.startswith("fabric:"):
        rest = spec[len("fabric:"):]
        endpoint, _, token = rest.partition("#")
        if not endpoint:
            raise ValueError(
                f"hypernode discoverer {spec!r} has no endpoint")
        return FabricDiscoverer(endpoint, token=token)
    raise ValueError(f"unknown hypernode discoverer {spec!r}")


@register_controller("hypernode")
class HyperNodeController(Controller):
    name = "hypernode"

    def __init__(self, discoverer=None):
        self.discoverer = discoverer or LabelDiscoverer()

    def sync(self) -> None:
        snap = self.cluster.list_all()
        desired = {hn.name: hn for hn in self.discoverer.discover(snap.nodes)}
        existing = {hn.name: hn for hn in snap.hypernodes}

        for name, hn in desired.items():
            cur = existing.get(name)
            if cur is None or _differs(cur, hn):
                self.cluster.add_hypernode(hn)
                log.debug("hypernode %s reconciled (tier %d, %d members)",
                          name, hn.tier, len(hn.members))
        # only GC hypernodes this controller owns (tier names we emit)
        for name, hn in existing.items():
            if name not in desired and hn.tier_name in ("nvlink-domain",
                                                        "ib-fabric"):
                self.cluster.delete_hypernode(name)

    def on_event(self, kind: str, obj):
        if kind in ("node", "node_deleted"):
            self.sync()


def _differs(a: HyperNode, b: HyperNode) -> bool:
    members_a = sorted((m.kind, m.exact) for m in a.members)
    members_b = sorted((m.kind, m.exact) for m in b.members)
    return a.tier != b.tier or members_a != members_b

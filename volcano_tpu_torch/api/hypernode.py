"""HyperNode CRD + topology tree (network topology model).

Reference parity: staging/.../topology/v1alpha1/hypernode_types.go:60-100
(tier + members with exact/regex selectors) and
pkg/scheduler/api/hyper_node_info.go:86 (HyperNodesInfo tree, LCA,
realNodesSet).

GPU semantics: a **tier-1 hypernode is one NVLink domain** — hosts
whose GPUs reach each other through NVSwitch in one hop; tier 2+
hypernodes group domains reachable over the InfiniBand fabric (fabric,
superpod, cluster).  Lower tier ⇒ closer.  The hypernode controller
auto-discovers this tree from GPU Feature Discovery node labels (see
volcano_tpu_torch.controllers.hypernode).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Set

# Name of the synthetic root that unifies the hypernode forest
# (reference framework/session.go builds a virtual root at max tier + 1).
VIRTUAL_ROOT = "<root>"


@dataclass
class HyperNodeMember:
    """Member selector: either a node or a child hypernode."""

    kind: str = "Node"           # Node | HyperNode
    exact: str = ""              # exactMatch name
    regex: str = ""              # regexMatch pattern
    labels: Dict[str, str] = field(default_factory=dict)  # labelMatch

    def matches(self, name: str, labels: Optional[Dict[str, str]] = None) -> bool:
        if self.exact:
            return name == self.exact
        if self.regex:
            return re.fullmatch(self.regex, name) is not None
        if self.labels and labels is not None:
            return all(labels.get(k) == v for k, v in self.labels.items())
        return False


@dataclass
class HyperNode:
    """HyperNode CRD object."""

    name: str
    tier: int = 1
    tier_name: str = ""
    members: List[HyperNodeMember] = field(default_factory=list)
    labels: Dict[str, str] = field(default_factory=dict)

    @classmethod
    def of_nodes(cls, name: str, tier: int, nodes: Iterable[str],
                 **kwargs) -> "HyperNode":
        return cls(name=name, tier=tier,
                   members=[HyperNodeMember(kind="Node", exact=n)
                            for n in nodes], **kwargs)

    @classmethod
    def of_children(cls, name: str, tier: int, children: Iterable[str],
                    **kwargs) -> "HyperNode":
        return cls(name=name, tier=tier,
                   members=[HyperNodeMember(kind="HyperNode", exact=c)
                            for c in children], **kwargs)


class HyperNodeInfo:
    """One node of the topology tree."""

    def __init__(self, hypernode: HyperNode):
        self.hypernode = hypernode
        self.name = hypernode.name
        self.tier = hypernode.tier
        self.parent: Optional[str] = None
        self.children: Set[str] = set()
        self.nodes: Set[str] = set()      # real node names beneath (closure)
        self.direct_nodes: Set[str] = set()  # real nodes listed as members

    def __repr__(self):
        return (f"HyperNodeInfo({self.name}, tier={self.tier}, "
                f"nodes={len(self.nodes)})")


class HyperNodesInfo:
    """The assembled topology forest with a virtual root.

    Built from HyperNode CRs + the set of real node names; maintains the
    descendant real-node set per hypernode and answers LCA queries used
    for NVLink/IB distance scoring.
    """

    def __init__(self, hypernodes: Iterable[HyperNode],
                 real_nodes: Iterable[str] = (),
                 node_labels: Optional[Dict[str, Dict[str, str]]] = None):
        self.members: Dict[str, HyperNodeInfo] = {}
        self.node_to_leaf: Dict[str, str] = {}   # real node -> tier-1 hypernode
        self._lca_tier_cache: Dict[tuple, int] = {}
        self._tier_row_cache: Dict[Optional[str], tuple] = {}
        real = list(real_nodes)
        node_labels = node_labels or {}

        hns = list(hypernodes)
        for hn in hns:
            self.members[hn.name] = HyperNodeInfo(hn)

        # Resolve membership: wire children and direct node members.
        # A child keeps its first parent; an edge that would close a
        # cycle (malformed CRs whose selectors match each other) is
        # dropped rather than hanging later tree walks.  Exact-match
        # members resolve by dict lookup — only regex/label selectors
        # pay a scan (the wiring is on the per-session snapshot path).
        real_set = set(real)
        for hn in hns:
            info = self.members[hn.name]
            for m in hn.members:
                if m.kind == "HyperNode":
                    if m.exact:
                        candidates = ([m.exact]
                                      if m.exact in self.members
                                      and m.exact != hn.name else [])
                    else:
                        candidates = [c for c in self.members
                                      if c != hn.name and m.matches(c)]
                    for cand in candidates:
                        if self.members[cand].parent is not None:
                            continue
                        if cand in self.ancestors(hn.name):
                            continue  # would create a cycle
                        info.children.add(cand)
                        self.members[cand].parent = hn.name
                else:
                    if m.exact:
                        if m.exact in real_set:
                            info.direct_nodes.add(m.exact)
                    else:
                        for node in real:
                            if m.matches(node, node_labels.get(node)):
                                info.direct_nodes.add(node)
            info.nodes |= info.direct_nodes

        # Virtual root above all parentless hypernodes.
        max_tier = max((h.tier for h in hns), default=0)
        root = HyperNode(name=VIRTUAL_ROOT, tier=max_tier + 1)
        root_info = HyperNodeInfo(root)
        self.members[VIRTUAL_ROOT] = root_info
        for name, info in self.members.items():
            if name != VIRTUAL_ROOT and info.parent is None:
                info.parent = VIRTUAL_ROOT
                root_info.children.add(name)

        # Propagate real-node sets bottom-up and index each real node to
        # its lowest-tier DIRECT owner (a hypernode may list nodes as
        # members while also having hypernode children).
        self._propagate_nodes(VIRTUAL_ROOT)
        for name, info in self.members.items():
            if name == VIRTUAL_ROOT:
                continue
            for n in info.direct_nodes:
                cur = self.node_to_leaf.get(n)
                if cur is None or info.tier < self.members[cur].tier:
                    self.node_to_leaf[n] = name

        # Any real node not covered by the tree hangs off the root.
        uncovered = set(real) - set(self.node_to_leaf)
        root_info.nodes |= uncovered

    def _propagate_nodes(self, name: str, _seen: Optional[Set[str]] = None) -> Set[str]:
        seen = _seen if _seen is not None else set()
        if name in seen:
            return set()
        seen.add(name)
        info = self.members[name]
        for child in info.children:
            info.nodes |= self._propagate_nodes(child, seen)
        return info.nodes

    # -- queries -------------------------------------------------------

    @property
    def tiers(self) -> List[int]:
        """Ascending tiers present (excluding the virtual root's)."""
        return sorted({i.tier for n, i in self.members.items()
                       if n != VIRTUAL_ROOT})

    def real_nodes(self, name: str) -> Set[str]:
        info = self.members.get(name)
        return set(info.nodes) if info else set()

    def at_tier(self, tier: int) -> List[HyperNodeInfo]:
        return [i for n, i in self.members.items()
                if i.tier == tier and n != VIRTUAL_ROOT]

    def up_to_tier(self, tier: int) -> List[HyperNodeInfo]:
        return [i for n, i in self.members.items()
                if i.tier <= tier and n != VIRTUAL_ROOT]

    def leaf_of_node(self, node_name: str) -> Optional[str]:
        return self.node_to_leaf.get(node_name)

    def leaves(self) -> List[Optional[str]]:
        """Distinct tier-1 leaf hypernodes, plus None for nodes outside
        any hypernode (the per-leaf scoring key space)."""
        out: List[Optional[str]] = sorted(set(self.node_to_leaf.values()))
        out.append(None)
        return out

    def ancestors(self, name: str) -> List[str]:
        """Path from *name* (inclusive) up to the virtual root.

        Cycle-guarded: a malformed parent chain terminates the walk
        instead of looping forever.
        """
        path: List[str] = []
        seen: Set[str] = set()
        cur: Optional[str] = name
        while cur is not None and cur not in seen:
            seen.add(cur)
            path.append(cur)
            cur = self.members[cur].parent if cur in self.members else None
        return path

    def lca(self, a: str, b: str) -> Optional[str]:
        """Lowest common ancestor of two hypernodes."""
        if a not in self.members or b not in self.members:
            return None
        set_a = set(self.ancestors(a))
        for cur in self.ancestors(b):
            if cur in set_a:
                return cur
        return None

    def lca_tier_of_leaves(self, la: Optional[str],
                           lb: Optional[str]) -> int:
        """Memoized LCA tier between two leaf hypernodes (None = outside
        the tree, scoring the virtual-root tier)."""
        root_tier = self.members[VIRTUAL_ROOT].tier
        if la is None or lb is None:
            return root_tier
        if la == lb:
            return self.members[la].tier
        key = (la, lb) if la < lb else (lb, la)
        cached = self._lca_tier_cache.get(key)
        if cached is None:
            lca = self.lca(la, lb)
            cached = self.members[lca].tier if lca else root_tier
            # vtplint: disable=snapshot-write (idempotent memo: the tier is pure in the immutable member tree, so a racing GIL-atomic store publishes an equal value; a lost update only recomputes)
            self._lca_tier_cache[key] = cached
        return cached

    def _leaf_buckets(self) -> Dict[str, List[str]]:
        """hypernode -> leaf hypernodes under it (leaves inclusive),
        built once per topology object."""
        buckets = getattr(self, "_leaf_bucket_cache", None)
        if buckets is None:
            buckets = {}
            for leaf in set(self.node_to_leaf.values()):
                for anc in self.ancestors(leaf):
                    buckets.setdefault(anc, []).append(leaf)
            # vtplint: disable=snapshot-write (idempotent memo: pure in the immutable member tree; a lost GIL-atomic update only recomputes)
            self._leaf_bucket_cache = buckets
        return buckets

    def leaf_tier_row(self, leaf: Optional[str],
                      leaf_names: List[Optional[str]]) -> tuple:
        """Tuple of LCA tiers between *leaf* and every leaf in
        ``leaves()`` order.

        Built by one root-to-leaf descendant-bucket walk — each
        ancestor overwrites its leaf bucket with its (tighter) tier —
        which is O(leaves) total instead of O(leaves) pairwise LCA
        walks, and memoized on the topology object, which incremental
        snapshots reuse while the CR set is unchanged (profiled: the
        dominant ssn.allocate cost of an 8k-gang batched commit at
        100k hosts was rebuilding these rows pairwise per session)."""
        row = self._tier_row_cache.get(leaf)
        if row is None:
            root_tier = self.members[VIRTUAL_ROOT].tier
            vals = [root_tier] * len(leaf_names)
            if leaf is not None and leaf in self.members:
                idx = {name: i for i, name in enumerate(leaf_names)}
                buckets = self._leaf_buckets()
                for anc in reversed(self.ancestors(leaf)):
                    tier = self.members[anc].tier
                    for other in buckets.get(anc, ()):
                        i = idx.get(other)
                        if i is not None:
                            vals[i] = tier
            row = tuple(vals)
            # vtplint: disable=snapshot-write (idempotent memo: pure in the immutable member tree; a racing GIL-atomic store publishes an equal tuple and a lost update only recomputes)
            self._tier_row_cache[leaf] = row
        return row

    def lca_tier_of_nodes(self, node_a: str, node_b: str) -> int:
        """Tier of the LCA of the leaf hypernodes containing two real
        nodes — the NVLink/IB 'distance' between them.  Nodes in the
        same tier-1 hypernode (same NVLink domain) score tier 1; anything
        unresolvable scores the virtual-root tier."""
        return self.lca_tier_of_leaves(self.node_to_leaf.get(node_a),
                                       self.node_to_leaf.get(node_b))

    def hypernodes_covering(self, nodes: Set[str]) -> List[str]:
        """All hypernodes whose real-node set covers *nodes*, sorted by
        (tier, size) — i.e. tightest domains first."""
        out = [(i.tier, len(i.nodes), n) for n, i in self.members.items()
               if n != VIRTUAL_ROOT and nodes <= i.nodes]
        return [n for _, _, n in sorted(out)]

    def clone(self) -> "HyperNodesInfo":
        import copy
        return copy.deepcopy(self)

    def __repr__(self):
        return (f"HyperNodesInfo({len(self.members) - 1} hypernodes, "
                f"tiers={self.tiers})")

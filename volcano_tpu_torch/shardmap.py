"""Topology-subtree partition plan shared by both sharded planes.

One deterministic function of (node name -> subtree key, N) drives
every consumer of the partition:

  * scheduler shards restrict their candidate nodes to the subtrees
    they own (actions/allocate.py `shard-mode: subtree`);
  * the keyspace-partitioned client routes node/pod writes to the
    leader group owning the subtree (cache/partitioned.py);
  * bench / chaos planes seed each leader group's store with exactly
    its owned nodes, and vtpctl renders the ownership table.

Because all of them recompute the plan from the same inputs, there is
no shard-map object to replicate or to go stale: two processes with
the same node set and the same shard count agree on ownership without
coordination.  The partition key is the node's topology subtree (its
NVLink domain / tier-1 hypernode), never a bare hash of the node name —
a gang placed NVLink-compact lands inside one subtree, so keeping whole
subtrees on one shard keeps gang placement (and its write batch)
single-owner in the common case (Tesserae-style ownership; cross-
subtree gangs go through optimistic arbitration instead).

Assignment is greedy least-loaded over subtrees sorted by name: stable
under iteration order, balanced to within one subtree's host count.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence

from volcano_tpu_torch.api.types import GPU_CLIQUE_LABEL

# nodes outside any NVLink domain (CPU-only hosts) share one pseudo-subtree
FLAT_SUBTREE = "_flat"


def subtree_of(labels: Optional[Dict[str, str]]) -> str:
    """Partition key for one node: its NVLink domain label (= tier-1
    hypernode in label discovery), or the flat pseudo-subtree."""
    if labels:
        slice_name = labels.get(GPU_CLIQUE_LABEL)
        if slice_name:
            return slice_name
    return FLAT_SUBTREE


def subtree_map(nodes: Iterable) -> Dict[str, str]:
    """node name -> subtree key for any iterable of Node/NodeInfo-like
    objects (anything with .name and .labels)."""
    return {n.name: subtree_of(getattr(n, "labels", None)) for n in nodes}


def plan_partition(node_subtrees: Dict[str, str], n_shards: int
                   ) -> List[Dict[str, object]]:
    """Deterministic subtree -> shard assignment.

    Returns one row per shard: {"shard": i, "subtrees": [names...],
    "nodes": [node names...], "hosts": count}.  Subtrees are assigned
    whole (never split) to the least-loaded shard in sorted-name
    order, so any two processes that agree on the node set and N
    agree on the whole plan.
    """
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1 (got {n_shards})")
    by_subtree: Dict[str, List[str]] = {}
    for name in sorted(node_subtrees):
        by_subtree.setdefault(node_subtrees[name], []).append(name)
    shards: List[Dict[str, object]] = [
        {"shard": i, "subtrees": [], "nodes": [], "hosts": 0}
        for i in range(n_shards)]
    for subtree in sorted(by_subtree):
        hosts = by_subtree[subtree]
        # least-loaded, ties to the lowest index: deterministic
        target = min(shards, key=lambda s: (s["hosts"], s["shard"]))
        target["subtrees"].append(subtree)
        target["nodes"].extend(hosts)
        target["hosts"] += len(hosts)
    return shards


def owned_nodes(node_subtrees: Dict[str, str], n_shards: int,
                shard_index: int) -> set:
    """The node-name set shard *shard_index* owns under the plan."""
    if not 0 <= shard_index < n_shards:
        raise ValueError(
            f"shard_index {shard_index} out of range for {n_shards}")
    return set(plan_partition(node_subtrees, n_shards)
               [shard_index]["nodes"])


def owner_index(node_subtrees: Dict[str, str], n_shards: int
                ) -> Dict[str, int]:
    """node name -> owning shard index (the write-routing table)."""
    out: Dict[str, int] = {}
    for row in plan_partition(node_subtrees, n_shards):
        for name in row["nodes"]:
            out[name] = row["shard"]
    return out


def home_shard(job_key: str, n_shards: int) -> int:
    """Which scheduler shard drives a job's placement.  Stable string
    hash (not hash(): randomized per process) so every shard agrees
    which one of them owns a pending gang; the others leave it alone
    and only the server's check-and-bind arbitrates the optimistic
    spill cases."""
    acc = 0
    for ch in job_key:
        acc = (acc * 131 + ord(ch)) & 0x7FFFFFFF
    return acc % max(1, n_shards)


def split_by_owner(items: Sequence, node_of, node_subtrees: Dict[str, str],
                   n_shards: int) -> Dict[int, list]:
    """Group *items* by the shard owning node_of(item) (unknown nodes
    go to shard 0, the meta group)."""
    owners = owner_index(node_subtrees, n_shards)
    out: Dict[int, list] = {}
    for item in items:
        out.setdefault(owners.get(node_of(item), 0), []).append(item)
    return out

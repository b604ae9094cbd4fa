"""Scheduler cache layer (reference: pkg/scheduler/cache)."""

from volcano_tpu_torch.cache.cluster import Cluster, ClusterSnapshot
from volcano_tpu_torch.cache.fake_cluster import FakeCluster
from volcano_tpu_torch.cache.cache import SchedulerCache, Snapshot

__all__ = ["Cluster", "ClusterSnapshot", "FakeCluster", "SchedulerCache",
           "Snapshot"]

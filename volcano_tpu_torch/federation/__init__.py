"""Federation tier: one global queue over N regional planes.

See api/federation.py for the annotation contract, federation/mirror.py
for the async WAL object mirror, federation/router.py for the global
admission/migration reconciler, federation/ha.py + federation/retry.py
for the leased router replica set (term-fenced failover, shared
cross-region RPC policy), and docs/design/federation.md for the full
protocol (router, mirror-vs-quorum contract, cutover, HA).
"""

from volcano_tpu_torch.federation.ha import RouterElector
from volcano_tpu_torch.federation.mirror import MirrorStaleError, RegionMirror
from volcano_tpu_torch.federation.retry import (FedRPC, FedRPCError,
                                          RegionBreaker,
                                          RegionTrippedError,
                                          RouterFencedError)
from volcano_tpu_torch.federation.router import FederationRouter

__all__ = ["MirrorStaleError", "RegionMirror", "FederationRouter",
           "RouterElector", "FedRPC", "FedRPCError", "RegionBreaker",
           "RegionTrippedError", "RouterFencedError"]

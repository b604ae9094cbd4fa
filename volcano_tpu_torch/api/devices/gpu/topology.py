"""NVLink-domain topology math for GPU hosts.

The counterpart of the reference's ICI slice model, for NVIDIA GPUs:
GPUs sit on hosts, and the hosts of one *NVLink domain* (one HGX board,
or a rack of hosts joined by an NVLink Switch System) reach every GPU
of the domain through NVSwitch in one hop.  Domains reach each other
only over the InfiniBand fabric.  A domain is provisioned as one node
pool where every host carries a fixed number of GPUs.  Placement
quality is hop distance: 0 on one host, 1 inside a domain, 2 across
the IB tier.

Node labels follow GPU Feature Discovery (`nvidia.com/gpu.product`,
`nvidia.com/gpu.clique`), e.g. a DGX H100 NVLink Switch System domain
of 32 hosts x 8 NVIDIA-H100-80GB-HBM3.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

H100_SXM = "NVIDIA-H100-80GB-HBM3"

# hop distances between two GPUs' hosts
SAME_HOST, SAME_DOMAIN, ACROSS_FABRIC = 0, 1, 2


def parse_topology(s: str) -> Tuple[int, ...]:
    """Parse a domain shape "<hosts>x<gpus a host>" ("32x8") into
    (hosts, gpus a host); () if it is not one."""
    if not s:
        return ()
    try:
        dims = tuple(int(p) for p in s.lower().split("x"))
    except ValueError:
        return ()
    return dims if len(dims) == 2 and all(d > 0 for d in dims) else ()


def hop_distance(a: Tuple[str, int], b: Tuple[str, int]) -> int:
    """Hop distance between two hosts given as (NVLink domain, host
    index in it): 0 on one host, 1 inside a domain (NVSwitch links
    every pair of GPUs in one hop), 2 across the IB fabric."""
    if a[0] != b[0] or not a[0]:
        return ACROSS_FABRIC
    return SAME_HOST if a[1] == b[1] else SAME_DOMAIN


@dataclass(frozen=True)
class DomainTopology:
    """Static identity of one provisioned NVLink domain."""

    name: str
    product: str = H100_SXM
    hosts: int = 1
    gpus_per_host: int = 8

    @property
    def is_multi_host(self) -> bool:
        return self.hosts > 1

    @property
    def shape(self) -> str:
        return f"{self.hosts}x{self.gpus_per_host}"


# Well-known domain shapes by common name (public NVIDIA systems).
WELL_KNOWN = {
    # one HGX H100 board: 8 H100 SXM on NVSwitch in one host
    "hgx-h100-8": DomainTopology("", H100_SXM, 1, 8),
    # DGX H100 SuperPOD with the NVLink Switch System: 32 DGX H100
    # hosts x 8 GPUs in one NVLink domain (256 GPUs)
    "dgx-h100-256": DomainTopology("", H100_SXM, 32, 8),
}


def domain_for(name: str, kind: str) -> DomainTopology:
    base = WELL_KNOWN[kind]
    return DomainTopology(name, base.product, base.hosts,
                          base.gpus_per_host)

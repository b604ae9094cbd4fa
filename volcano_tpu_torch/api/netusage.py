"""Bandwidth accounting wire types — measure what the enforcer shapes.

The agent's tc/net_cls enforcement (agent/enforcer.py) SHAPES per-pod
DCN traffic; these types carry what the agent MEASURES back through
the control plane, closing the enforce→measure→react loop the
reference closes with pinned eBPF watermark maps
(pkg/networkqos/utils/ebpf/map.go:64-79).

One BandwidthReport per node per agent sync (posted only when it
materially changes): per-pod EWMA rates keyed by the enforcer's
net_cls classids, the node-level online/offline totals, and the
violation tally.  The state server folds the node-level summary into
node annotations (cache/fake_cluster.py put_object hook) so every
watch mirror — the scheduler's included — sees saturation without
decoding reports; the full per-pod detail stays on the report object
for vtpctl / GET /bandwidth consumers.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

# -- measured-side annotations (the published half of the loop) --------
# Pod-level (written by the agent's netaccounting handler, persisted
# through the agent's pod-annotation sync):
POD_TX_ANNOTATION = "networkqos.volcano-tpu.io/tx-mbps"
POD_RX_ANNOTATION = "networkqos.volcano-tpu.io/rx-mbps"
POD_VIOLATING_ANNOTATION = "networkqos.volcano-tpu.io/violating"
POD_VIOLATIONS_ANNOTATION = "networkqos.volcano-tpu.io/violations"
# Declared online watermark: an online pod carrying this annotation
# asserts it should stay under N mbps (offline pods' watermark is the
# enforced per-pod cap, networkqos.volcano-tpu.io/pod-limit-mbps).
POD_WATERMARK_ANNOTATION = "networkqos.volcano-tpu.io/watermark-mbps"
# Node-level (folded from BandwidthReport by the STORE, not the agent,
# so wire mirrors see them via node watch events):
NODE_MEASURED_OFFLINE_ANNOTATION = \
    "networkqos.volcano-tpu.io/measured-offline-mbps"
NODE_MEASURED_ONLINE_ANNOTATION = \
    "networkqos.volcano-tpu.io/measured-online-mbps"
NODE_SATURATED_ANNOTATION = "networkqos.volcano-tpu.io/saturated"
NODE_VIOLATING_PODS_ANNOTATION = \
    "networkqos.volcano-tpu.io/violating-pods"

# Measured total / DCN budget fraction past which the agent marks the
# node saturated (nodeorder penalizes placements, bandwidthPressure
# considers victims there).
SATURATION_FRACTION = 0.85


@dataclass
class PodBandwidthUsage:
    """One pod's measured DCN usage, as the agent collector saw it."""

    pod_key: str = ""            # ns/name
    uid: str = ""
    classid: int = 0             # HTB minor the enforcer tagged (0 = online)
    tier: str = "online"         # "online" | "offline"
    tx_mbps: float = 0.0         # windowed EWMA egress rate
    rx_mbps: float = 0.0
    watermark_mbps: float = 0.0  # declared/enforced cap (0 = none)
    violating: bool = False      # currently past hysteresis threshold
    violations: int = 0          # cumulative over-watermark syncs


@dataclass
class BandwidthReport:
    """Per-node usage summary the agent posts to the state server."""

    node: str = ""
    usages: List[PodBandwidthUsage] = field(default_factory=list)
    offline_tx_mbps: float = 0.0   # sum over offline-tier pods
    online_tx_mbps: float = 0.0    # sum over online-tier pods
    total_mbps: float = 0.0        # node DCN budget the split ran on
    violations: int = 0            # pods currently violating
    saturated: bool = False        # measured total past the pressure line

    @property
    def name(self) -> str:         # kinds.py keys bandwidthreport by name
        return self.node

"""The default agent handler pipeline — eleven registered handlers.

Reference parity: pkg/agent/events/handlers/* (one package per
concern, self-registered via registry.go).  Each handler here carries
the logic the r4 agent kept inline in its sync loop; registration
order is dispatch order, which matters only where stated:

    UsageReporter, GpuHealth, Oversubscription   (EVENT_USAGE)
    CpuQoS, MemoryQoS, NetworkQoS                (EVENT_PODS)
    NetAccounting                                (EVENT_PODS, AFTER
        NetworkQoS: this sync's per-pod caps are the offline
        watermarks it verifies measured rates against)
    Goodput                                      (EVENT_PODS: workload
        step progress -> GoodputReport, docs/design/goodput.md)
    NumaExporter                                 (EVENT_PODS)
    Enforcement                                  (EVENT_PODS, LAST:
        applies the decision set the QoS handlers built and
        reconciles enforcement for departed pods)
    Eviction                                     (EVENT_PRESSURE)

MemoryQoS is the memoryqosv2 knob set (VERDICT r4 missing #2;
reference pkg/agent/events/handlers/memoryqosv2/ + docs/design/
agent-cgroup-v2-adaptation.md): online pods get memory.min (hard
guarantee = request) and memory.low (soft protection above it); BE
pods keep the memory.high cap.  Cpu and memory handlers never see
each other — both fill the per-sync PodQoSDecision set that the
Enforcement handler applies once per pod.
"""

from __future__ import annotations

import logging

from volcano_tpu_torch.agent.framework import (
    EVENT_PODS,
    EVENT_PRESSURE,
    EVENT_USAGE,
    Event,
    Handler,
    register_handler,
)
from volcano_tpu_torch.api.resource import GPU
from volcano_tpu_torch.api.types import (
    QOS_HIGHLY_LATENCY_SENSITIVE,
    QOS_LATENCY_CRITICAL,
    QOS_LATENCY_SENSITIVE,
)

log = logging.getLogger(__name__)

# cpu qos-level ladder -> cgroup-v2 cpu.weight (extension/qos.go:
# LC/HLS=2, LS=1; BE takes weight 1 + cpu.idle instead)
CLASS_WEIGHT = {QOS_LATENCY_CRITICAL: 400,
                QOS_HIGHLY_LATENCY_SENSITIVE: 400,
                QOS_LATENCY_SENSITIVE: 100}

# agent.py owns the annotation-name constants (they are its public
# API); handlers import them inside handle() to avoid an import cycle
# (agent.py imports this module to trigger registration).


@register_handler
class UsageReporterHandler(Handler):
    """Publish cpu/memory usage fractions as node annotations
    (consumed by the usage plugin)."""

    name = "usagereporter"
    events = (EVENT_USAGE,)

    def handle(self, event: Event) -> None:
        from volcano_tpu_torch.agent.agent import (
            CPU_USAGE_ANNOTATION, MEM_USAGE_ANNOTATION)
        event.node.annotations[CPU_USAGE_ANNOTATION] = \
            f"{event.usage.cpu_fraction:.3f}"
        event.node.annotations[MEM_USAGE_ANNOTATION] = \
            f"{event.usage.memory_fraction:.3f}"


@register_handler
class GpuHealthHandler(Handler):
    """GPU health -> verdict -> label/cordon + SliceHealthReport.
    A host with sick GPUs must not take new work: an NCCL gang over an
    NVLink domain is only as healthy as its worst host.  The report is
    keyed by the host's NVLink domain (GPU_CLIQUE_LABEL).

    HYSTERESIS both directions (the r6 handler cordoned on ONE bad
    telemetry sample and uncordoned on one good one — a flapping
    exporter bounced the host in and out of rotation every sync; same
    pattern as the netaccounting watermark hysteresis below):
    FAIL_SYNCS consecutive bad samples escalate Healthy -> Suspect ->
    Failed (cordon fires only on Failed), RECOVER_SYNCS consecutive
    good samples walk Failed back to Healthy (uncordon).  Every
    verdict/chip-count change posts a SliceHealthReport wire object —
    the store folds the verdict into node annotations and the
    failover controller declares slice failures from it
    (api/slicehealth.py)."""

    name = "gpuhealth"
    events = (EVENT_USAGE,)

    FAIL_SYNCS = 3
    RECOVER_SYNCS = 3

    def __init__(self, agent):
        super().__init__(agent)
        self._bad = 0
        self._good = 0
        self._first_bad_ts = 0.0
        from volcano_tpu_torch.api.slicehealth import VERDICT_HEALTHY
        self._verdict = VERDICT_HEALTHY
        self._last_report = None       # change-elision signature

    def handle(self, event: Event) -> None:
        import time as _time

        from volcano_tpu_torch.agent.agent import (
            AGENT_CORDONED_ANNOTATION, GPU_CHIPS_ANNOTATION,
            GPU_HEALTHY_LABEL)
        from volcano_tpu_torch.api.slicehealth import (
            VERDICT_FAILED, VERDICT_HEALTHY, VERDICT_SUSPECT)
        node, usage = event.node, event.usage
        declared = self.agent.allocatable(node).get(GPU)
        if usage.gpu_chips_detected == 0:
            # no GPU telemetry from this provider (e.g. a usage-only
            # Prometheus source): never cordon on absence of data
            return
        node.annotations[GPU_CHIPS_ANNOTATION] = \
            f"{usage.gpu_chips_healthy}/{usage.gpu_chips_detected}"
        healthy = (usage.gpu_chips_healthy >= declared > 0) or \
            (declared == 0 and usage.gpu_chips_detected ==
             usage.gpu_chips_healthy)

        if healthy:
            self._bad = 0
            self._good += 1
            if self._verdict != VERDICT_HEALTHY and \
                    self._good >= self.RECOVER_SYNCS:
                self._verdict = VERDICT_HEALTHY
                self._first_bad_ts = 0.0
                self.agent.cluster.record_event(
                    self.agent.node_name, "GPURecovered",
                    f"{usage.gpu_chips_healthy}/"
                    f"{usage.gpu_chips_detected} GPUs healthy for "
                    f"{self._good} syncs")
        else:
            self._good = 0
            self._bad += 1
            if self._bad == 1:
                self._first_bad_ts = _time.time()
            if self._verdict == VERDICT_HEALTHY:
                self._verdict = VERDICT_SUSPECT
            if self._verdict == VERDICT_SUSPECT and \
                    self._bad >= self.FAIL_SYNCS:
                self._verdict = VERDICT_FAILED
                self.agent.cluster.record_event(
                    self.agent.node_name, "GPUUnhealthy",
                    f"{usage.gpu_chips_healthy}/"
                    f"{usage.gpu_chips_detected} GPUs healthy "
                    f"(declared {declared:g}) for {self._bad} "
                    f"consecutive syncs")

        # label + cordon follow the VERDICT, not the sample: a Suspect
        # host keeps taking work until the failure is confirmed, and a
        # Failed host stays out until recovery is confirmed
        node.labels[GPU_HEALTHY_LABEL] = \
            "false" if self._verdict == VERDICT_FAILED else "true"
        if self._verdict == VERDICT_FAILED:
            node.unschedulable = True
            node.annotations[AGENT_CORDONED_ANNOTATION] = "true"
        elif self._verdict == VERDICT_HEALTHY and node.unschedulable \
                and node.annotations.get(AGENT_CORDONED_ANNOTATION) \
                == "true":
            # only undo OUR cordon — never an admin's maintenance one
            node.unschedulable = False
            node.annotations.pop(AGENT_CORDONED_ANNOTATION, None)

        self._post_report(node, usage)

    def _post_report(self, node, usage) -> None:
        from volcano_tpu_torch.api.slicehealth import SliceHealthReport
        from volcano_tpu_torch.api.types import GPU_CLIQUE_LABEL
        report = SliceHealthReport(
            node=self.agent.node_name,
            slice=node.labels.get(GPU_CLIQUE_LABEL, ""),
            verdict=self._verdict,
            chips_detected=usage.gpu_chips_detected,
            chips_healthy=usage.gpu_chips_healthy,
            consecutive_bad=self._bad,
            consecutive_good=self._good,
            first_bad_ts=round(self._first_bad_ts, 3))
        sig = (report.verdict, report.chips_detected,
               report.chips_healthy)
        if sig == self._last_report:
            return                    # unchanged verdict: no wire churn
        try:
            self.agent.cluster.put_object("slicehealthreport", report)
            self._last_report = sig
        except Exception as e:  # noqa: BLE001 — reporting must never
            log.warning("slice health report post failed: %s", e)  # kill sync


@register_handler
class OversubscriptionHandler(Handler):
    """Publish reclaimable millicores in 10% steps
    (pkg/agent/oversubscription/policy/policy.go:40-61)."""

    name = "oversubscription"
    events = (EVENT_USAGE,)

    def handle(self, event: Event) -> None:
        from volcano_tpu_torch.agent.agent import OVERSUB_ANNOTATION
        if not getattr(event.usage, "cpu_sampled", True):
            # no cpu telemetry this cycle: publishing from the 0.0
            # default would read as a fully idle node and hand the
            # scheduler 60% of it as phantom reclaimable capacity
            event.node.annotations[OVERSUB_ANNOTATION] = "0"
            return
        alloc = self.agent.allocatable(event.node)
        idle_frac = max(0.0, 1.0 - event.usage.cpu_fraction)
        stepped = int(idle_frac * 10) / 10.0   # 10% quantization
        reclaimable = alloc.milli_cpu * stepped * \
            self.agent.oversub_factor
        event.node.annotations[OVERSUB_ANNOTATION] = \
            str(int(reclaimable))


@register_handler
class CpuQoSHandler(Handler):
    """cpuburst + cputhrottle + cpuqos (reference handlers of the
    same names): BE pods burst into measured idle, throttle to
    request under pressure; guaranteed pods keep fixed headroom; and
    every pod gets its qos-LEVEL scheduling class — the reference
    writes a kernel cpu.qos_level int (LC/HLS=2, LS=1, BE=-1,
    extension/qos.go), mapped here to the portable cgroup-v2 pair:
    cpu.weight (LC/HLS 400, LS 100, BE 1) and cpu.idle (SCHED_IDLE
    for BE — offline work yields the CPU entirely under contention
    instead of merely weighing less)."""

    name = "cpuqos"
    events = (EVENT_PODS,)

    def handle(self, event: Event) -> None:
        from volcano_tpu_torch.agent.agent import (
            CPU_BURST_ANNOTATION, CPU_THROTTLE_ANNOTATION,
            PREEMPTABLE_QOS_ANNOTATION, QOS_BEST_EFFORT)
        agent = self.agent
        usage = event.usage
        idle_frac = max(0.0, 1.0 - usage.cpu_fraction)
        node_idle_m = agent.allocatable(event.node).milli_cpu * \
            idle_frac
        throttled = usage.cpu_fraction > agent.eviction_threshold * 0.9
        for pod in event.pods:
            qos = pod.annotations.get(PREEMPTABLE_QOS_ANNOTATION)
            request_m = pod.resource_requests().milli_cpu
            d = agent.decision_for(event, pod)
            if qos == QOS_BEST_EFFORT:
                # requests are often 0 for true best-effort — size the
                # burst from allocatable idle, not requests; pressure
                # zeroes it, matching the throttle flag
                burst = 0 if throttled else int(node_idle_m)
                pod.annotations[CPU_BURST_ANNOTATION] = str(burst)
                pod.annotations[CPU_THROTTLE_ANNOTATION] = (
                    "true" if throttled else "false")
                d.burst_millis, d.throttled = burst, throttled
                d.cpu_weight, d.cpu_idle = 1, True
            else:
                burst = int(request_m * 0.2)
                pod.annotations[CPU_BURST_ANNOTATION] = str(burst)
                pod.annotations.pop(CPU_THROTTLE_ANNOTATION, None)
                d.burst_millis, d.throttled = burst, False
                # unannotated pods are LS (extension/qos.go default);
                # an UNRECOGNIZED level also lands on LS weight but
                # loudly — a typo'd "lc" silently demoting a
                # latency-critical pod 400 -> 100 would be invisible
                if qos and qos not in CLASS_WEIGHT:
                    log.warning("pod %s: unknown qos-level %r; "
                                "treating as LS", pod.key, qos)
                d.cpu_weight = CLASS_WEIGHT.get(qos, 100)
                d.cpu_idle = False
            d.request_millis = int(request_m)


@register_handler
class MemoryQoSHandler(Handler):
    """memoryqosv2 (reference pkg/agent/events/handlers/memoryqosv2/,
    cgroup-v2 adaptation design doc): per-QoS-class memory knobs.

      online (non-BE) pods: memory.min = request (kernel-guaranteed,
        never reclaimed) and memory.low = 1.25x request (reclaim-
        protected while the node has slack) — the guarantee the r4
        agent lacked;
      BE pods: memory.high = request (soft cap; the kernel throttles
        allocation above it instead of OOM-killing the node)."""

    name = "memoryqosv2"
    events = (EVENT_PODS,)
    LOW_FACTOR = 1.25

    def handle(self, event: Event) -> None:
        from volcano_tpu_torch.agent.agent import (
            PREEMPTABLE_QOS_ANNOTATION, QOS_BEST_EFFORT)
        for pod in event.pods:
            mem = int(pod.resource_requests().memory)
            if not mem:
                continue
            d = self.agent.decision_for(event, pod)
            if pod.annotations.get(PREEMPTABLE_QOS_ANNOTATION) == \
                    QOS_BEST_EFFORT:
                d.memory_high_bytes = mem
            else:
                d.memory_min_bytes = mem
                d.memory_low_bytes = int(mem * self.LOW_FACTOR)


@register_handler
class NetworkQoSHandler(Handler):
    """Online/offline DCN egress split (reference pkg/networkqos):
    publish the split + per-BE-pod caps and program the enforcer's
    network half."""

    name = "networkqos"
    events = (EVENT_PODS,)

    def handle(self, event: Event) -> None:
        from volcano_tpu_torch.agent.agent import (
            DCN_BANDWIDTH_ANNOTATION, DCN_OFFLINE_LIMIT_ANNOTATION,
            DCN_ONLINE_GUARANTEE_ANNOTATION, DCN_POD_LIMIT_ANNOTATION,
            DEFAULT_DCN_MBPS, PREEMPTABLE_QOS_ANNOTATION,
            QOS_BEST_EFFORT)
        agent, node, usage = self.agent, event.node, event.usage
        try:
            total_mbps = float(node.annotations.get(
                DCN_BANDWIDTH_ANNOTATION, DEFAULT_DCN_MBPS))
        except (TypeError, ValueError):
            # a malformed operator annotation must never kill the
            # sync cycle (eviction still runs after this handler)
            log.warning("node %s: invalid %s annotation; using "
                        "default", agent.node_name,
                        DCN_BANDWIDTH_ANNOTATION)
            total_mbps = float(DEFAULT_DCN_MBPS)
        be_pods, other_pods = [], []
        for p in event.pods:
            (be_pods if p.annotations.get(PREEMPTABLE_QOS_ANNOTATION)
             == QOS_BEST_EFFORT else other_pods).append(p)
        # offline (BE) traffic capped at a link fraction, shrinking
        # to a floor under online pressure
        offline_share = 0.4 if usage.cpu_fraction < 0.8 else 0.1
        offline_mbps = int(total_mbps * offline_share)
        node.annotations[DCN_OFFLINE_LIMIT_ANNOTATION] = \
            str(offline_mbps)
        node.annotations[DCN_ONLINE_GUARANTEE_ANNOTATION] = \
            str(int(total_mbps - offline_mbps))
        pod_limits = {}
        if be_pods:
            # floor at 1: TcEnforcer clamps the kernel class to 1mbit
            # anyway, and a literal 0 would read as "no watermark" to
            # the netaccounting verifier — exactly the crowded-host
            # case where violations matter most
            per_pod = max(1, offline_mbps // len(be_pods))
            for pod in be_pods:
                pod.annotations[DCN_POD_LIMIT_ANNOTATION] = str(per_pod)
                pod_limits[pod.uid] = per_pod
        for pod in other_pods:
            # a pod promoted out of BE must not keep a stale cap
            pod.annotations.pop(DCN_POD_LIMIT_ANNOTATION, None)
        agent.enforcer.apply_network(int(total_mbps - offline_mbps),
                                     offline_mbps, pod_limits)


@register_handler
class NetAccountingHandler(Handler):
    """Verification half of the DCN split (reference: eBPF watermark
    maps, utils/ebpf/map.go:64-79): the NetworkQoS handler SHAPES
    traffic; this one MEASURES it and closes the loop.

    Runs right after networkqos (same sync's per-pod caps are the
    offline watermarks) off the NetAccountingCollector's per-classid
    EWMA rates:

      * publishes per-pod tx/rx mbps annotations + metrics;
      * compares each pod's rate against its watermark — offline (BE)
        pods' enforced cap, online pods' declared watermark-mbps
        annotation — with HYSTERESIS: FIRE_SYNCS consecutive
        over-watermark windows raise the violation (one burst never
        flaps), CLEAR_SYNCS consecutive windows under CLEAR_MARGIN x
        watermark lower it; the band between holds state;
      * emits BandwidthViolation / BandwidthViolationCleared events on
        the transitions and keeps a cumulative violating-sync count on
        the pod (the chronic signal bandwidthPressure reschedules on);
      * posts a BandwidthReport to the store when it materially
        changes — the server folds the node summary into node
        annotations for every watch mirror.
    """

    name = "netaccounting"
    events = (EVENT_PODS,)

    FIRE_SYNCS = 3
    CLEAR_SYNCS = 3
    CLEAR_MARGIN = 0.9
    # published rates move only when the EWMA leaves a dead-band
    # around the last published value (max of 1 mbps / 5%): raw EWMAs
    # jitter every window, and publishing the jitter would defeat the
    # agent's pod-annotation change-elision AND the report signature —
    # O(pods) PUTs per sync fanning out to every watch mirror.
    # Violation detection always uses the RAW rate.
    PUBLISH_DEADBAND_MBPS = 1.0
    PUBLISH_DEADBAND_FRAC = 0.05

    def __init__(self, agent):
        super().__init__(agent)
        # uid -> {"over", "under", "violating", "violations"}
        self._state = {}
        self._published = {}           # uid -> (tx, rx) as published
        self._last_report = None       # change-elision signature

    def _publish_rates(self, uid, tx, rx):
        pub = self._published.get(uid)
        if pub is not None:
            def inside(new, old):
                return abs(new - old) <= max(self.PUBLISH_DEADBAND_MBPS,
                                             self.PUBLISH_DEADBAND_FRAC
                                             * old)
            if inside(tx, pub[0]) and inside(rx, pub[1]):
                return pub             # steady: keep published values
        pub = (round(tx, 1), round(rx, 1))
        self._published[uid] = pub
        return pub

    def _collector(self):
        col = getattr(self.agent, "net_collector", None)
        if col is not None:
            return col
        from volcano_tpu_torch.agent.collect import NetAccountingCollector
        for c in getattr(self.agent.provider, "collectors", ()):
            if isinstance(c, NetAccountingCollector):
                return c
        return None

    def _watermark(self, pod, offline: bool) -> float:
        from volcano_tpu_torch.agent.agent import DCN_POD_LIMIT_ANNOTATION
        from volcano_tpu_torch.api.netusage import POD_WATERMARK_ANNOTATION
        key = DCN_POD_LIMIT_ANNOTATION if offline \
            else POD_WATERMARK_ANNOTATION
        try:
            return float(pod.annotations.get(key, 0) or 0)
        except (TypeError, ValueError):
            return 0.0

    def handle(self, event: Event) -> None:
        from volcano_tpu_torch import metrics
        from volcano_tpu_torch.agent.agent import (
            DCN_BANDWIDTH_ANNOTATION, DEFAULT_DCN_MBPS,
            PREEMPTABLE_QOS_ANNOTATION, QOS_BEST_EFFORT)
        from volcano_tpu_torch.api.netusage import (
            SATURATION_FRACTION, BandwidthReport, PodBandwidthUsage,
            POD_RX_ANNOTATION, POD_TX_ANNOTATION,
            POD_VIOLATING_ANNOTATION, POD_VIOLATIONS_ANNOTATION)
        collector = self._collector()
        if collector is None:
            return                    # accounting not deployed: no-op
        agent, node = self.agent, event.node
        # drive the sample ourselves: an explicitly-wired collector
        # needs no provider, and one that also sits in the composite
        # provider already walked this sync (MIN_INTERVAL_S no-op)
        try:
            collector.collect(agent.node_name)
        except Exception as e:  # noqa: BLE001 — degrade, keep sync
            log.warning("net accounting sample failed: %s", e)
        rates = collector.rates()
        try:
            total_mbps = float(node.annotations.get(
                DCN_BANDWIDTH_ANNOTATION, DEFAULT_DCN_MBPS))
        except (TypeError, ValueError):
            total_mbps = float(DEFAULT_DCN_MBPS)

        usages, rows = [], []
        offline_tx = online_tx = 0.0
        violating_pods = 0
        current_uids = set()
        for pod in event.pods:
            rate = rates.get(pod.uid)
            if rate is None:
                continue              # no cgroup counters for this pod
            current_uids.add(pod.uid)
            offline = pod.annotations.get(
                PREEMPTABLE_QOS_ANNOTATION) == QOS_BEST_EFFORT
            tier = "offline" if offline else "online"
            tx_pub, rx_pub = self._publish_rates(
                pod.uid, rate.tx_mbps, rate.rx_mbps)
            if offline:
                offline_tx += tx_pub
            else:
                online_tx += tx_pub
            watermark = self._watermark(pod, offline)
            st = self._state.setdefault(pod.uid, {
                "over": 0, "under": 0, "violating": False,
                "violations": 0})
            if watermark > 0 and rate.tx_mbps > watermark:
                st["over"] += 1
                st["under"] = 0
                if not st["violating"] and st["over"] >= self.FIRE_SYNCS:
                    st["violating"] = True
                    agent.cluster.record_event(
                        pod.key, "BandwidthViolation",
                        f"{tier} pod at {rate.tx_mbps:.1f} mbps > "
                        f"watermark {watermark:g} mbps for "
                        f"{st['over']} syncs")
                    metrics.inc("bandwidth_violations_total",
                                pod=pod.key, node=agent.node_name)
            elif watermark <= 0 or \
                    rate.tx_mbps <= watermark * self.CLEAR_MARGIN:
                st["under"] += 1
                st["over"] = 0
                if st["violating"] and st["under"] >= self.CLEAR_SYNCS:
                    st["violating"] = False
                    agent.cluster.record_event(
                        pod.key, "BandwidthViolationCleared",
                        f"{tier} pod back under watermark "
                        f"{watermark:g} mbps")
            else:
                # hysteresis band (CLEAR_MARGIN..1.0 of watermark):
                # neither direction makes progress
                st["over"] = st["under"] = 0
            if st["violating"]:
                st["violations"] += 1     # chronic = large cumulative
                violating_pods += 1
                pod.annotations[POD_VIOLATING_ANNOTATION] = "true"
            else:
                pod.annotations.pop(POD_VIOLATING_ANNOTATION, None)
            if st["violations"]:
                pod.annotations[POD_VIOLATIONS_ANNOTATION] = \
                    str(st["violations"])
            pod.annotations[POD_TX_ANNOTATION] = f"{tx_pub:.1f}"
            pod.annotations[POD_RX_ANNOTATION] = f"{rx_pub:.1f}"
            usages.append(PodBandwidthUsage(
                pod_key=pod.key, uid=pod.uid, classid=rate.classid,
                tier=tier, tx_mbps=tx_pub, rx_mbps=rx_pub,
                watermark_mbps=watermark,
                violating=st["violating"],
                violations=st["violations"]))
            rows.append(("pod_dcn_tx_mbps",
                         {"pod": pod.key, "node": agent.node_name,
                          "tier": tier}, tx_pub))
            rows.append(("pod_dcn_rx_mbps",
                         {"pod": pod.key, "node": agent.node_name,
                          "tier": tier}, rx_pub))
        for uid in set(self._state) - current_uids:
            del self._state[uid]      # departed pods drop hysteresis
            self._published.pop(uid, None)

        saturated = (offline_tx + online_tx) >= \
            SATURATION_FRACTION * total_mbps
        rows.append(("node_dcn_measured_mbps",
                     {"node": agent.node_name, "tier": "offline"},
                     round(offline_tx, 3)))
        rows.append(("node_dcn_measured_mbps",
                     {"node": agent.node_name, "tier": "online"},
                     round(online_tx, 3)))
        rows.append(("bandwidth_violating_pods",
                     {"node": agent.node_name}, violating_pods))
        metrics.swap_gauge_families(
            {"pod_dcn_tx_mbps", "pod_dcn_rx_mbps",
             "node_dcn_measured_mbps", "bandwidth_violating_pods"},
            rows, node=agent.node_name)

        report = BandwidthReport(
            node=agent.node_name, usages=usages,
            offline_tx_mbps=round(offline_tx, 1),
            online_tx_mbps=round(online_tx, 1),
            total_mbps=total_mbps, violations=violating_pods,
            saturated=saturated)
        sig = (report.offline_tx_mbps, report.online_tx_mbps,
               report.violations, report.saturated,
               tuple((u.pod_key, u.tx_mbps, u.violating)
                     for u in report.usages))
        if sig == self._last_report:
            return                    # unchanged: no wire churn
        try:
            agent.cluster.put_object("bandwidthreport", report)
            self._last_report = sig
        except Exception as e:  # noqa: BLE001 — reporting must never
            log.warning("bandwidth report post failed: %s", e)  # kill sync


@register_handler
class GoodputHandler(Handler):
    """Workload-progress half of the goodput observatory (docs/design/
    goodput.md): the GoodputCollector turns per-pod progress files
    into step rates and a productive-vs-allocated time ledger; this
    handler pairs that state with the node's pods, publishes per-pod
    step/rate annotations, and posts one GoodputReport per sync —
    the store folds the per-job summary into PODGROUP annotations the
    scheduler's throughput-vector estimator learns from.

    Posting discipline: the report carries the CUMULATIVE per-pod
    ledger; the store folds the diff against this node's previous
    report, so a re-post after a lost ack (server folded, response
    died) is idempotent and a dead server loses nothing — the next
    acked cumulative covers the gap.  Elision: nothing posted while
    no pod has progress state; an unchanged signature is still posted
    once the unreported allocated time passes POST_DEBT_S (stalled
    pods must keep debiting goodput at the store)."""

    name = "goodput"
    events = (EVENT_PODS,)

    POST_DEBT_S = 5.0
    # published rates move only outside a dead-band (same rationale
    # as netaccounting: raw EWMAs jitter; publishing the jitter
    # defeats pod-annotation change-elision)
    PUBLISH_DEADBAND_FRAC = 0.05

    def __init__(self, agent):
        super().__init__(agent)
        self._published = {}           # uid -> published rate
        self._last_report = None       # change-elision signature
        self._posted_alloc = 0.0       # total allocated_s last posted

    def _collector(self):
        col = getattr(self.agent, "goodput_collector", None)
        if col is not None:
            return col
        from volcano_tpu_torch.agent.collect import GoodputCollector
        for c in getattr(self.agent.provider, "collectors", ()):
            if isinstance(c, GoodputCollector):
                return c
        return None

    def _publish_rate(self, uid: str, rate: float) -> float:
        pub = self._published.get(uid)
        if pub is not None and abs(rate - pub) <= \
                max(0.01, self.PUBLISH_DEADBAND_FRAC * pub):
            return pub
        pub = round(rate, 3)
        self._published[uid] = pub
        return pub

    @staticmethod
    def _job_key(pod) -> str:
        from volcano_tpu_torch.api.types import GROUP_NAME_ANNOTATION
        group = pod.annotations.get(GROUP_NAME_ANNOTATION) or pod.owner
        if not group:
            return ""
        return group if "/" in group else f"{pod.namespace}/{group}"

    def handle(self, event: Event) -> None:
        import time as _time

        from volcano_tpu_torch.api.goodput import (
            POD_STEP_ANNOTATION, POD_STEP_RATE_ANNOTATION,
            GoodputReport, PodGoodput, generation_of)
        collector = self._collector()
        if collector is None:
            return                    # goodput not deployed: no-op
        agent = self.agent
        try:
            collector.collect(agent.node_name)
        except Exception as e:  # noqa: BLE001 — degrade, keep sync
            log.warning("goodput sample failed: %s", e)
        rates = collector.rates()
        generation = generation_of(event.node.labels)
        usages = []
        current_uids = set()
        for pod in event.pods:
            st = rates.get(pod.uid)
            if st is None:
                continue              # no progress file for this pod
            current_uids.add(pod.uid)
            rate_pub = self._publish_rate(pod.uid, st.steps_per_s)
            pod.annotations[POD_STEP_ANNOTATION] = str(st.step)
            pod.annotations[POD_STEP_RATE_ANNOTATION] = \
                f"{rate_pub:.3f}"
            usages.append(PodGoodput(
                pod_key=pod.key, uid=pod.uid,
                job=self._job_key(pod), generation=generation,
                epoch=st.epoch or 0, step=st.step,
                steps_per_s=rate_pub,
                examples_per_s=round(st.examples_per_s, 3),
                goodput=round(st.goodput, 4),
                allocated_s=round(st.allocated_s, 3),
                productive_s=round(st.productive_s, 3),
                stalled=st.stalled))
        for uid in set(self._published) - current_uids:
            del self._published[uid]
        if not usages:
            return
        sig = tuple((u.uid, u.step, u.epoch, u.steps_per_s)
                    for u in usages)
        total_alloc = sum(u.allocated_s for u in usages)
        if sig == self._last_report and \
                total_alloc - self._posted_alloc < self.POST_DEBT_S:
            return                    # steady and little unreported
        report = GoodputReport(node=agent.node_name,
                               ts=round(_time.time(), 3),
                               usages=usages)
        try:
            agent.cluster.put_object("goodputreport", report)
        except Exception as e:  # noqa: BLE001 — reporting must never
            log.warning("goodput report post failed: %s", e)  # kill sync
            return
        self._last_report = sig
        self._posted_alloc = total_alloc


@register_handler
class ServingHandler(Handler):
    """Traffic half of the serving plane (api/serving.py): the
    ServingCollector turns per-replica stats files into EWMA QPS and
    latency quantiles; this handler pairs that state with the node's
    pods, publishes per-pod QPS/p99 annotations, and posts one
    ServingReport per sync — the store folds the per-group summary
    into PODGROUP annotations the serving autoscaler
    (controllers/serving.py) scales from.

    Same posting discipline as GoodputHandler: cumulative per-replica
    ledgers on the wire (idempotent store fold), change-elision on a
    (uid, requests, epoch, qps) signature, and a debt re-post once
    POST_DEBT_S of unreported requests accumulate — a group whose
    traffic went flat must still refresh its updated-ts so the
    autoscaler can tell quiet from dead."""

    name = "serving"
    events = (EVENT_PODS,)

    POST_DEBT_S = 5.0
    PUBLISH_DEADBAND_FRAC = 0.05

    def __init__(self, agent):
        super().__init__(agent)
        self._published = {}           # uid -> published qps
        self._last_report = None       # change-elision signature
        self._last_post_ts = 0.0

    def _collector(self):
        col = getattr(self.agent, "serving_collector", None)
        if col is not None:
            return col
        from volcano_tpu_torch.agent.collect import ServingCollector
        for c in getattr(self.agent.provider, "collectors", ()):
            if isinstance(c, ServingCollector):
                return c
        return None

    def _publish_rate(self, uid: str, rate: float) -> float:
        pub = self._published.get(uid)
        if pub is not None and abs(rate - pub) <= \
                max(0.01, self.PUBLISH_DEADBAND_FRAC * pub):
            return pub
        pub = round(rate, 3)
        self._published[uid] = pub
        return pub

    @staticmethod
    def _job_key(pod) -> str:
        from volcano_tpu_torch.api.types import GROUP_NAME_ANNOTATION
        group = pod.annotations.get(GROUP_NAME_ANNOTATION) or pod.owner
        if not group:
            return ""
        return group if "/" in group else f"{pod.namespace}/{group}"

    def handle(self, event: Event) -> None:
        import time as _time

        from volcano_tpu_torch.api.serving import (
            POD_P99_MS_ANNOTATION, POD_QPS_ANNOTATION, ReplicaServing,
            ServingReport)
        collector = self._collector()
        if collector is None:
            return                    # serving not deployed: no-op
        agent = self.agent
        try:
            collector.collect(agent.node_name)
        except Exception as e:  # noqa: BLE001 — degrade, keep sync
            log.warning("serving sample failed: %s", e)
        rates = collector.rates()
        usages = []
        current_uids = set()
        for pod in event.pods:
            st = rates.get(pod.uid)
            if st is None:
                continue              # no stats file for this pod
            current_uids.add(pod.uid)
            qps_pub = self._publish_rate(pod.uid, st.qps)
            pod.annotations[POD_QPS_ANNOTATION] = f"{qps_pub:.3f}"
            pod.annotations[POD_P99_MS_ANNOTATION] = \
                f"{st.p99_ms:.3f}"
            usages.append(ReplicaServing(
                pod_key=pod.key, uid=pod.uid,
                job=self._job_key(pod), epoch=st.epoch or 0,
                qps=qps_pub, p50_ms=round(st.p50_ms, 3),
                p99_ms=round(st.p99_ms, 3),
                requests=st.requests, slo_ok=st.slo_ok))
        for uid in set(self._published) - current_uids:
            del self._published[uid]
        if not usages:
            return
        sig = tuple((u.uid, u.requests, u.epoch, u.qps)
                    for u in usages)
        now = _time.time()
        if sig == self._last_report and \
                now - self._last_post_ts < self.POST_DEBT_S:
            return                    # steady and recently refreshed
        report = ServingReport(node=agent.node_name,
                               ts=round(now, 3), usages=usages)
        try:
            agent.cluster.put_object("servingreport", report)
        except Exception as e:  # noqa: BLE001 — reporting must never
            log.warning("serving report post failed: %s", e)  # kill sync
            return
        self._last_report = sig
        self._last_post_ts = now


@register_handler
class NumaExporterHandler(Handler):
    """Exporter half of the Numatopology contract: republish per-cell
    FREE amounts so the scheduler's single-NUMA gate sees placements
    from earlier cycles."""

    name = "numaexporter"
    events = (EVENT_PODS,)

    def handle(self, event: Event) -> None:
        agent = self.agent
        topo = getattr(agent.cluster, "numatopologies", {}).get(
            agent.node_name)
        if topo is None:
            return
        reqs = []
        for pod in event.pods:
            r = pod.resource_requests()
            reqs.append((r.milli_cpu, r.get(GPU)))
        before = {res: dict(cells)
                  for res, cells in topo.numa_res.items()}
        topo.recompute_free(reqs)
        if topo.numa_res != before:
            agent.cluster.put_object("numatopology", topo)


@register_handler
class EnforcementHandler(Handler):
    """LAST of the EVENT_PODS handlers: apply the decision set the
    QoS handlers built (one apply per pod, all knob families merged)
    and revert enforcement for pods that left the node — decision,
    OS mutation, and revert stay one observable loop."""

    name = "enforcement"
    events = (EVENT_PODS,)

    def handle(self, event: Event) -> None:
        agent = self.agent
        for d in event.decisions.values():
            agent.enforcer.apply_pod_qos(d)
        current_uids = {p.uid for p in event.pods}
        for uid in agent._enforced_uids - current_uids:
            agent.enforcer.remove_pod(uid)
        agent._enforced_uids = current_uids


@register_handler
class EvictionHandler(Handler):
    """Pressure eviction of best-effort pods (reference eviction
    handler)."""

    name = "eviction"
    events = (EVENT_PRESSURE,)

    def handle(self, event: Event) -> None:
        from volcano_tpu_torch.agent.agent import (
            PREEMPTABLE_QOS_ANNOTATION, QOS_BEST_EFFORT)
        for pod in event.pods:
            if pod.annotations.get(PREEMPTABLE_QOS_ANNOTATION) == \
                    QOS_BEST_EFFORT:
                log.info("agent %s: evicting BE pod %s under pressure",
                         self.agent.node_name, pod.key)
                self.agent.cluster.evict_pod(
                    pod.namespace, pod.name, "node resource pressure")

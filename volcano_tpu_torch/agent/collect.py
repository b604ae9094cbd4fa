"""Pluggable metric collection for the node agent.

Reference parity: pkg/metriccollect (841 LoC of local collectors
behind a plugin interface, VERDICT r4 missing #1's second half).  A
Collector contributes named samples for one node; the
CompositeUsageProvider merges every registered collector's output
into the NodeUsage the agent's probes consume — so a deployment
mixes sources (local /proc for cpu/memory, the GPU driver's device
nodes for GPU health, Prometheus for fleet-level overrides) by listing collector
names, not by writing a new provider.

Sample keys (a collector contributes any subset):
    cpu_fraction, memory_fraction        (0..1)
    gpu_chips_detected, gpu_chips_healthy (counts)
Later collectors in the list override earlier ones per key.
"""

from __future__ import annotations

import abc
import glob
import logging
import os
from typing import Callable, Dict, List, Optional

from volcano_tpu_torch.agent.agent import NodeUsage, UsageProvider
from volcano_tpu_torch.agent.enforcer import CgroupV2Enforcer

log = logging.getLogger(__name__)

_COLLECTORS: Dict[str, Callable[..., "Collector"]] = {}


def register_collector(name: str):
    """Class decorator: makes the collector buildable by name via
    build_provider('local,gpu')."""
    def deco(cls):
        _COLLECTORS[name] = cls
        cls.name = name
        return cls
    return deco


def registered_collectors() -> Dict[str, Callable[..., "Collector"]]:
    return dict(_COLLECTORS)


class Collector(abc.ABC):
    """One metric source (reference: a metriccollect local plugin)."""

    name: str = ""

    @abc.abstractmethod
    def collect(self, node_name: str) -> Dict[str, float]:
        """Named samples for this node; {} when the source has no
        data (absence must never be reported as zeros — a usage-only
        source reporting gpu_chips_detected=0 would cordon the
        node)."""


class CompositeUsageProvider(UsageProvider):
    """UsageProvider over an ordered collector list.  A collector
    that raises degrades to {} with a warning — one broken source
    must not take down the whole agent sync."""

    def __init__(self, collectors: List[Collector]):
        self.collectors = list(collectors)

    def refresh(self) -> bool:
        """Fan out to collectors with a refresh seam (the network-
        backed adapters) — called off the agent loop by the daemon's
        refresh thread, same contract as the metrics_source
        providers.  Local collectors sample at collect() time and
        have nothing to do here."""
        ok = True
        for c in self.collectors:
            fn = getattr(c, "refresh", None)
            if callable(fn):
                try:
                    ok = bool(fn()) and ok
                except Exception as e:  # noqa: BLE001
                    log.warning("collector %s refresh failed: %s",
                                c.name, e)
                    ok = False
        return ok

    def usage(self, node_name: str) -> NodeUsage:
        merged: Dict[str, float] = {}
        for c in self.collectors:
            try:
                merged.update(c.collect(node_name) or {})
            except Exception as e:  # noqa: BLE001
                log.warning("collector %s failed: %s", c.name, e)
        return NodeUsage(
            cpu_fraction=float(merged.get("cpu_fraction", 0.0)),
            memory_fraction=float(merged.get("memory_fraction", 0.0)),
            gpu_chips_detected=int(merged.get("gpu_chips_detected", 0)),
            gpu_chips_healthy=int(merged.get("gpu_chips_healthy", 0)),
            cpu_sampled="cpu_fraction" in merged,
        )


@register_collector("local")
class LocalProcCollector(Collector):
    """cpu/memory from the kernel: /proc/stat deltas between calls
    (first call has no delta -> no cpu sample) and /proc/meminfo
    MemAvailable.  Paths injectable for tests; the parse is the real
    one either way."""

    def __init__(self, stat_path: str = "/proc/stat",
                 meminfo_path: str = "/proc/meminfo"):
        self.stat_path = stat_path
        self.meminfo_path = meminfo_path
        # per-node delta windows: one provider instance may serve
        # several simulated agents (sync_node_agents loops them over
        # a shared provider); a single window would be torn to a
        # zero-jiffy delta by every agent after the first
        self._last: Dict[str, tuple] = {}    # node -> (busy, total)

    def _read_stat(self) -> Optional[tuple]:
        try:
            with open(self.stat_path, encoding="ascii") as f:
                for line in f:
                    if line.startswith("cpu "):
                        fields = [int(x) for x in line.split()[1:]]
                        idle = fields[3] + (fields[4] if len(fields) > 4
                                            else 0)   # idle + iowait
                        total = sum(fields)
                        return (total - idle, total)
        except (OSError, ValueError, IndexError):
            return None
        return None

    def collect(self, node_name: str) -> Dict[str, float]:
        out: Dict[str, float] = {}
        cur = self._read_stat()
        last = self._last.get(node_name)
        if cur is not None and last is not None:
            dbusy = cur[0] - last[0]
            dtotal = cur[1] - last[1]
            if dtotal > 0:
                out["cpu_fraction"] = max(0.0, min(1.0, dbusy / dtotal))
        if cur is not None:
            self._last[node_name] = cur
        try:
            info = {}
            with open(self.meminfo_path, encoding="ascii") as f:
                for line in f:
                    parts = line.split()
                    if len(parts) >= 2 and parts[0].rstrip(":") in (
                            "MemTotal", "MemAvailable"):
                        info[parts[0].rstrip(":")] = int(parts[1])
            if info.get("MemTotal"):
                out["memory_fraction"] = max(0.0, min(1.0, 1.0 - (
                    info.get("MemAvailable", 0) / info["MemTotal"])))
        except (OSError, ValueError):
            # vtplint: disable=except-pass (proc-file sampling: a missing/garbled /proc/meminfo just omits the optional gauge this round)
            pass
        return out


class PodNetRate:
    """One pod's accounting state kept by NetAccountingCollector.
    Windows are per direction (util.RateWindow): a one-sided failed
    read (exporter mid-rewrite) must not advance the other counter's
    window, or the returning counter's next delta would span two
    windows over one window's dt and read ~2x hot."""

    __slots__ = ("uid", "classid", "_tx", "_rx")

    def __init__(self, uid: str, alpha: float = 0.5):
        from volcano_tpu_torch.util import RateWindow
        self.uid = uid
        self.classid = 0
        # bytes -> mbps; a reading below the last is an exporter
        # restart, so the absolute value is the delta ("absolute")
        self._tx = RateWindow(alpha=alpha, reset="absolute",
                              scale=8.0 / 1e6)
        self._rx = RateWindow(alpha=alpha, reset="absolute",
                              scale=8.0 / 1e6)

    @property
    def tx_mbps(self) -> float:      # windowed EWMA egress rate
        return self._tx.rate

    @property
    def rx_mbps(self) -> float:
        return self._rx.rate

    @property
    def tx_bytes(self) -> int:       # last raw counter reading
        return int(self._tx.last or 0)

    @property
    def rx_bytes(self) -> int:
        return int(self._rx.last or 0)


@register_collector("netaccounting")
class NetAccountingCollector(Collector):
    """Per-pod DCN byte accounting keyed by the enforcer's net_cls
    classids — the measurement half of the online/offline split
    (reference: pinned eBPF watermark maps, utils/ebpf/map.go:64-79;
    divergence note in docs/design/network-accounting.md).

    Reads, for every vtp-prefixed pod dir under the enforcer's cgroup
    root, the net_cls.classid tag the CgroupV2Enforcer wrote plus the
    per-cgroup byte counters an eBPF/conntrack exporter pins next to
    it (net_stat.tx_bytes / net_stat.rx_bytes — same file convention
    the tests' fake cgroup fs writes), and maintains a windowed EWMA
    mbps rate per pod.  Counter semantics:

      * monotonically increasing within one exporter lifetime;
      * a reading BELOW the last one is a counter reset (exporter or
        kernel restart): the new absolute value is taken as the delta
        (the bytes since the reset — the only defensible reading);
      * a vanished pod dir drops its state (classids recycle).

    collect() runs once per agent sync (the agent samples its provider
    exactly once), so the EWMA window is sync-period-spaced; rates()
    hands the per-pod table to the netaccounting handler.
    """

    # the enforcer's ownership mark IS the accounting key (shared
    # constant, so the measure half can never drift from the shape
    # half)
    POD_DIR_PREFIX = CgroupV2Enforcer.POD_DIR_PREFIX
    TX_FILE = "net_stat.tx_bytes"
    RX_FILE = "net_stat.rx_bytes"
    ALPHA = 0.5                      # EWMA weight of the newest window

    # a second collect() inside this window is a no-op returning the
    # cached totals: the netaccounting handler calls collect() every
    # sync so an explicitly-wired collector needs no provider, and
    # when the collector ALSO sits in the composite provider (sampled
    # at sync start) the handler's call microseconds later must not
    # tear the EWMA windows with a near-zero dt
    MIN_INTERVAL_S = 0.05

    def __init__(self, root: str = "/sys/fs/cgroup/volcano",
                 alpha: float = ALPHA, now=None):
        import time
        self.root = root
        self.alpha = float(alpha)
        self._now = now if now is not None else time.monotonic
        self._rates: Dict[str, PodNetRate] = {}
        self._last_walk: Optional[float] = None
        self._totals: Dict[str, float] = {}

    @staticmethod
    def _read_int(path: str) -> Optional[int]:
        try:
            with open(path, encoding="ascii") as f:
                return int(f.read().strip() or "0", 0)
        except (OSError, ValueError):
            return None

    def _sample_one(self, rate: PodNetRate, d: str, ts: float) -> None:
        tx = self._read_int(os.path.join(d, self.TX_FILE))
        rx = self._read_int(os.path.join(d, self.RX_FILE))
        cid = self._read_int(os.path.join(d, "net_cls.classid"))
        if cid is not None:
            rate.classid = cid & 0xFFFF
        # counter-delta/EWMA/reset semantics live in util.RateWindow
        # (shared with the GoodputCollector's step counters)
        rate._tx.fold(tx, ts)
        rate._rx.fold(rx, ts)

    def collect(self, node_name: str) -> Dict[str, float]:
        """Walk the pod cgroups once; returns node-level totals (the
        per-pod table is served by rates()).  The totals are extra
        keys NodeUsage ignores — harmless in the merged sample, and
        visible to custom providers that want them."""
        ts = self._now()
        if self._last_walk is not None and \
                ts - self._last_walk < self.MIN_INTERVAL_S:
            return dict(self._totals)
        self._last_walk = ts
        seen = set()
        try:
            entries = os.listdir(self.root)
        except OSError:
            return {}
        for e in entries:
            if not e.startswith(self.POD_DIR_PREFIX):
                continue
            d = os.path.join(self.root, e)
            if not os.path.isdir(d):
                continue
            uid = e[len(self.POD_DIR_PREFIX):]
            seen.add(uid)
            rate = self._rates.get(uid)
            if rate is None:
                rate = self._rates[uid] = PodNetRate(uid, self.alpha)
            self._sample_one(rate, d, ts)
        for uid in set(self._rates) - seen:   # departed: drop state
            del self._rates[uid]
        self._totals = {
            "dcn_tx_mbps": sum(r.tx_mbps
                               for r in self._rates.values()),
            "dcn_rx_mbps": sum(r.rx_mbps
                               for r in self._rates.values())}
        return dict(self._totals)

    def rates(self) -> Dict[str, PodNetRate]:
        """uid -> PodNetRate as of the last collect() (the handler's
        read surface; no re-walk)."""
        return dict(self._rates)


class PodProgressRate:
    """One pod's training-progress accounting state kept by
    GoodputCollector: step/example EWMA rates (util.RateWindow with
    the "restart" reset policy — a resumed worker's checkpoint-floor
    step count must never read as a negative or inflated delta) plus
    the productive-vs-allocated time ledger goodput is computed from.
    """

    __slots__ = ("uid", "epoch", "step", "examples", "restarts",
                 "allocated_s", "productive_s", "stalled",
                 "_steps", "_examples", "_last_rec_ts",
                 "_last_walk_ts")

    def __init__(self, uid: str, alpha: float = 0.5):
        from volcano_tpu_torch.util import RateWindow
        self.uid = uid
        self.epoch: Optional[int] = None
        self.step = 0
        self.examples = 0.0
        self.restarts = 0            # observed epoch bumps
        # cumulative ledger over this pod's lifetime on this node; the
        # handler ships the CUMULATIVE values and the store folds the
        # per-pod diff against the node's previous report, so a
        # re-posted report after a lost ack never double-counts
        self.allocated_s = 0.0       # cumulative pod-residency seconds
        self.productive_s = 0.0      # subset with step progress
        self.stalled = False         # last window saw no step
        self._steps = RateWindow(alpha=alpha, reset="restart")
        self._examples = RateWindow(alpha=alpha, reset="restart")
        self._last_rec_ts: Optional[float] = None
        self._last_walk_ts: Optional[float] = None

    @property
    def steps_per_s(self) -> float:
        return self._steps.rate

    @property
    def examples_per_s(self) -> float:
        return self._examples.rate

    @property
    def goodput(self) -> float:
        """Cumulative productive/allocated fraction (0 when no time
        has been accounted yet)."""
        return (self.productive_s / self.allocated_s
                if self.allocated_s > 0 else 0.0)


@register_collector("goodput")
class GoodputCollector(Collector):
    """Per-pod training-progress accounting off the workload progress
    files (api/goodput.py contract: workers write one JSON record per
    step to VTP_PROGRESS_FILE under a shared root, named by pod uid —
    the same uid-keyed convention the enforcer uses for cgroup dirs).

    Per walk, for every vtp-<uid>.json under the root:

      * step/example counters fold into EWMA rates via the SHARED
        RateWindow machinery (util.py) with the "restart" policy: a
        counter below the last reading (worker resumed from a
        checkpoint floor) restarts the window with no delta;
      * an EPOCH change (the control plane bumped the restart/resize
        epoch) force-restarts the windows even when the resumed step
        count happens to be higher — the out-of-band signal beats the
        counter heuristic;
      * the time ledger: every inter-walk dt while the file exists is
        ALLOCATED time (the chip belongs to the pod); it is PRODUCTIVE
        only when the step counter advanced, credited no more than
        the worker's own inter-record wall time — so queue-adjacent
        ramps (compile, checkpoint restore) and wedged workers debit
        goodput = productive / allocated;
      * a vanished file drops its state (the pod left the node — the
        drain window itself is accounted by the control-plane side,
        which sees the gang hold no chips); a file not rewritten for
        STALE_FILE_S is treated the same (dead pods' leftovers in a
        shared per-job dir must not grow the walk forever).
    """

    FILE_PREFIX = "vtp-"
    FILE_SUFFIX = ".json"
    ALPHA = 0.5
    # second collect() inside this window is a no-op returning cached
    # totals (same double-sample guard as NetAccountingCollector)
    MIN_INTERVAL_S = 0.05
    # a record not rewritten for this long is treated as absent:
    # progress dirs are per-job and often shared (NFS) across nodes,
    # so no agent can safely unlink another pod's file — bounding by
    # write-freshness instead keeps the per-sync parse set and the
    # in-memory state proportional to LIVE pods across job churn.
    # Generous on purpose: a wedged-but-alive worker keeps debiting
    # goodput (reported stalled) for this long before it reads as dead.
    STALE_FILE_S = 3600.0

    def __init__(self, root: str = "/var/run/volcano/progress",
                 alpha: float = ALPHA, now=None):
        import time
        self.root = root
        self.alpha = float(alpha)
        self._now = now if now is not None else time.monotonic
        self._rates: Dict[str, PodProgressRate] = {}
        self._last_walk: Optional[float] = None
        self._totals: Dict[str, float] = {}

    @staticmethod
    def _read_record(path: str) -> Optional[dict]:
        import json
        try:
            with open(path, encoding="utf-8") as f:
                doc = json.load(f)
        except (OSError, ValueError):
            return None       # mid-rewrite/corrupt: window spans on
        return doc if isinstance(doc, dict) else None

    def _sample_one(self, st: PodProgressRate, path: str,
                    ts: float) -> None:
        rec = self._read_record(path)
        if rec is None:
            return
        try:
            step = int(rec.get("step", 0))
            epoch = int(rec.get("epoch", 0))
            rec_ts = float(rec.get("ts", 0.0) or 0.0)
            examples = float(rec.get("examples", 0.0) or 0.0)
        except (TypeError, ValueError):
            return
        prev_step: Optional[int] = st.step
        prev_rec_ts = st._last_rec_ts
        if epoch != st.epoch:
            if st.epoch is not None:
                st.restarts += 1
            st.epoch = epoch
            st._steps.restart()
            st._examples.restart()
            prev_step = None        # no productive credit across it
        st._steps.fold(step, ts)
        st._examples.fold(examples, ts)
        st.step = step
        st.examples = examples
        if st._last_walk_ts is not None:
            dt = max(0.0, ts - st._last_walk_ts)
            st.allocated_s += dt
            advanced = prev_step is not None and step > prev_step
            st.stalled = not advanced
            if advanced:
                credit = dt
                if rec_ts and prev_rec_ts:
                    credit = min(dt, max(0.0, rec_ts - prev_rec_ts))
                st.productive_s += credit
        st._last_rec_ts = rec_ts
        st._last_walk_ts = ts

    def collect(self, node_name: str) -> Dict[str, float]:
        """Walk the progress files once; returns node totals (extra
        keys NodeUsage ignores); per-pod detail via rates()."""
        ts = self._now()
        if self._last_walk is not None and \
                ts - self._last_walk < self.MIN_INTERVAL_S:
            return dict(self._totals)
        self._last_walk = ts
        seen = set()
        try:
            entries = os.listdir(self.root)
        except OSError:
            return {}
        import time as _time
        wall = _time.time()
        for e in entries:
            if not (e.startswith(self.FILE_PREFIX)
                    and e.endswith(self.FILE_SUFFIX)):
                continue
            uid = e[len(self.FILE_PREFIX):-len(self.FILE_SUFFIX)]
            if not uid:
                continue
            path = os.path.join(self.root, e)
            try:
                if wall - os.stat(path).st_mtime > self.STALE_FILE_S:
                    continue        # dead pod's leftover: not ours to
            except OSError:         # unlink, but not ours to track
                continue
            seen.add(uid)
            st = self._rates.get(uid)
            if st is None:
                st = self._rates[uid] = PodProgressRate(uid, self.alpha)
            self._sample_one(st, path, ts)
        for uid in set(self._rates) - seen:   # departed: drop state
            del self._rates[uid]
        self._totals = {
            "goodput_steps_per_s": sum(r.steps_per_s
                                       for r in self._rates.values())}
        return dict(self._totals)

    def rates(self) -> Dict[str, PodProgressRate]:
        """uid -> PodProgressRate as of the last collect() (the
        GoodputHandler's read surface; no re-walk)."""
        return dict(self._rates)


class PodServingRate:
    """One serving replica's traffic accounting state kept by
    ServingCollector: the cumulative request counter folds into an
    EWMA QPS (util.RateWindow, "restart" policy — a restarted replica
    re-opens its counter at 0 and must not read as a negative delta),
    latency quantiles carry through from the replica's own window."""

    __slots__ = ("uid", "epoch", "requests", "slo_ok", "p50_ms",
                 "p99_ms", "restarts", "_requests")

    def __init__(self, uid: str, alpha: float = 0.5):
        from volcano_tpu_torch.util import RateWindow
        self.uid = uid
        self.epoch: Optional[int] = None
        # cumulative ledgers over this replica's lifetime on this
        # node; shipped cumulative, store folds the diff (the
        # GoodputReport idempotency argument)
        self.requests = 0
        self.slo_ok = 0
        self.p50_ms = 0.0
        self.p99_ms = 0.0
        self.restarts = 0            # observed epoch bumps
        self._requests = RateWindow(alpha=alpha, reset="restart")

    @property
    def qps(self) -> float:
        return self._requests.rate


@register_collector("serving")
class ServingCollector(Collector):
    """Per-replica serving-traffic accounting off the workload stats
    files (api/serving.py contract: serving workers write one JSON
    record per beat to VTP_SERVING_STATS_FILE under a shared root,
    named vtps-<pod uid>.json — the goodput progress-file convention).

    Per walk, for every vtps-<uid>.json under the root: the
    cumulative request counter folds into an EWMA QPS on the SHARED
    RateWindow machinery ("restart" policy), an epoch change
    force-restarts the window (out-of-band restart signal beats the
    counter heuristic), quantiles and ledgers carry through for the
    ServingHandler to post.  Vanished/stale files drop their state
    (same lifetime rule as GoodputCollector)."""

    FILE_PREFIX = "vtps-"
    FILE_SUFFIX = ".json"
    ALPHA = 0.5
    MIN_INTERVAL_S = 0.05
    STALE_FILE_S = 3600.0

    def __init__(self, root: str = "/var/run/volcano/serving",
                 alpha: float = ALPHA, now=None):
        import time
        self.root = root
        self.alpha = float(alpha)
        self._now = now if now is not None else time.monotonic
        self._rates: Dict[str, PodServingRate] = {}
        self._last_walk: Optional[float] = None
        self._totals: Dict[str, float] = {}

    @staticmethod
    def _read_record(path: str) -> Optional[dict]:
        import json
        try:
            with open(path, encoding="utf-8") as f:
                doc = json.load(f)
        except (OSError, ValueError):
            return None       # mid-rewrite/corrupt: window spans on
        return doc if isinstance(doc, dict) else None

    def _sample_one(self, st: PodServingRate, path: str,
                    ts: float) -> None:
        rec = self._read_record(path)
        if rec is None:
            return
        try:
            requests = int(rec.get("requests", 0))
            slo_ok = int(rec.get("slo_ok", 0))
            epoch = int(rec.get("epoch", 0))
            p50 = float(rec.get("p50_ms", 0.0) or 0.0)
            p99 = float(rec.get("p99_ms", 0.0) or 0.0)
        except (TypeError, ValueError):
            return
        if epoch != st.epoch:
            if st.epoch is not None:
                st.restarts += 1
            st.epoch = epoch
            st._requests.restart()
        st._requests.fold(requests, ts)
        st.requests = requests
        st.slo_ok = slo_ok
        st.p50_ms = p50
        st.p99_ms = p99

    def collect(self, node_name: str) -> Dict[str, float]:
        """Walk the stats files once; returns node totals (extra keys
        NodeUsage ignores); per-replica detail via rates()."""
        ts = self._now()
        if self._last_walk is not None and \
                ts - self._last_walk < self.MIN_INTERVAL_S:
            return dict(self._totals)
        self._last_walk = ts
        seen = set()
        try:
            entries = os.listdir(self.root)
        except OSError:
            return {}
        import time as _time
        wall = _time.time()
        for e in entries:
            if not (e.startswith(self.FILE_PREFIX)
                    and e.endswith(self.FILE_SUFFIX)):
                continue
            uid = e[len(self.FILE_PREFIX):-len(self.FILE_SUFFIX)]
            if not uid:
                continue
            path = os.path.join(self.root, e)
            try:
                if wall - os.stat(path).st_mtime > self.STALE_FILE_S:
                    continue        # dead replica's leftover
            except OSError:
                continue
            seen.add(uid)
            st = self._rates.get(uid)
            if st is None:
                st = self._rates[uid] = PodServingRate(uid, self.alpha)
            self._sample_one(st, path, ts)
        for uid in set(self._rates) - seen:   # departed: drop state
            del self._rates[uid]
        self._totals = {
            "serving_qps": sum(r.qps for r in self._rates.values())}
        return dict(self._totals)

    def rates(self) -> Dict[str, PodServingRate]:
        """uid -> PodServingRate as of the last collect() (the
        ServingHandler's read surface; no re-walk)."""
        return dict(self._rates)


@register_collector("gpu")
class GpuChipCollector(Collector):
    """GPU inventory from the NVIDIA driver's device nodes, one
    /dev/nvidia<N> a GPU (/dev/nvidiactl and /dev/nvidia-uvm do not
    match the glob).  A GPU whose device node vanished is
    detected-but-unhealthy from the scheduler's point of view only
    when a declared count says GPUs SHOULD exist; this collector
    reports what it can see and lets the GpuHealth handler compare
    against node.allocatable."""

    def __init__(self, device_glob: str = "/dev/nvidia[0-9]*",
                 declared: Optional[int] = None):
        self.device_glob = device_glob
        self.declared = declared

    def collect(self, node_name: str) -> Dict[str, float]:
        chips = len(glob.glob(self.device_glob))
        if chips == 0 and self.declared is None:
            return {}    # no devices, nothing declared: no telemetry
        declared = self.declared if self.declared is not None else chips
        return {"gpu_chips_detected": max(chips, declared),
                "gpu_chips_healthy": chips}


class MetricsSourceCollector(Collector):
    """Adapter over a metrics_source provider — fleet metrics
    backends plug into the same collector list as local sources.
    refresh() is the off-loop network fetch; collect() only reads the
    cached samples."""

    def __init__(self, source):
        self.source = source

    def refresh(self) -> bool:
        return self.source.refresh()

    def collect(self, node_name: str) -> Dict[str, float]:
        u = self.source.usage(node_name)
        return {"cpu_fraction": u.cpu_fraction,
                "memory_fraction": u.memory_fraction}


@register_collector("prometheus")
class PrometheusCollector(MetricsSourceCollector):
    def __init__(self, url: str, **kwargs):
        from volcano_tpu_torch.metrics_source import PrometheusUsageSource
        super().__init__(PrometheusUsageSource(url, **kwargs))


@register_collector("elasticsearch")
class ElasticsearchCollector(MetricsSourceCollector):
    def __init__(self, url: str, **kwargs):
        from volcano_tpu_torch.metrics_source import ElasticsearchUsageSource
        super().__init__(ElasticsearchUsageSource(url, **kwargs))


def build_provider(spec: str) -> UsageProvider:
    """'local,gpu' or 'prometheus:http://host:9090,local' -> a
    CompositeUsageProvider over the named collectors (CLI seam, the
    metriccollect analogue of build_enforcer)."""
    collectors: List[Collector] = []
    for item in (s for s in spec.split(",") if s):
        name, _, arg = item.partition(":")
        cls = _COLLECTORS.get(name)
        if cls is None:
            raise ValueError(
                f"unknown collector {name!r} (have "
                f"{sorted(_COLLECTORS)})")
        collectors.append(cls(arg) if arg else cls())
    return CompositeUsageProvider(collectors)

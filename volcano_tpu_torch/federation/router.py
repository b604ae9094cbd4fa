"""FederationRouter: one global queue over N regional planes.

The router is deliberately THIN (Singularity's global scheduler,
arxiv 2202.07848): it owns placement of whole GANGS into regions and
nothing below that — each region keeps its existing scheduler,
controllers and server plane unchanged, and the global store is an
ordinary durable state server holding only the global job queue plus
the region registry (the `region` dict-kind).

One reconcile pass:

  liveness   a region is alive while its mirror keeps proving itself
             fresh (the mirror tails the region's WAL — a successful
             poll IS a heartbeat); silent past REGION_TTL_S the region
             is declared lost and every gang admitted there requeues
             GLOBALLY.  Nothing acked is lost with a region: the
             global store is the source of truth, and the router folds
             checkpoint/resume metadata onto the global record as it
             lands, so the re-placed gang resumes from the last folded
             step.

  admission  unadmitted global jobs are scored into the READY region
             maximizing

                 locality x learned-goodput(generation) / price

             gated on the region actually fitting the gang (idle
             GPUs from the mirror).  The admission key is
             DETERMINISTIC over (job key, attempt): a router that
             crashed between the regional create and the
             admitted-region stamp re-derives the same key on restart
             and finds its own half-finished admission instead of
             double-placing the gang.

  goodput    per-(region, generation) EWMA of observed steps/sec/GPU
             learned from the mirrors' LAST_STEP deltas — the
             "goodput-per-generation" term of the score, so a region
             whose h200 fleet measurably outruns another's h100 fleet
             attracts the next gang even at equal price.

  arbitrage  a gang pending in its region past ARBITRAGE_PENDING_S
             while another ready region could run it NOW is
             re-admitted there (delete the pending copy, bump the
             attempt, place again) — burst capacity is bought where
             it exists.

  migration  a RUNNING gang moves via the elastic evacuate drain
             (api/elastic.py RESIZE_EVACUATE): the router stamps the
             decision on the SOURCE podgroup, the regional elastic
             controller checkpoints + drains and parks the gang under
             the `evacuated` hold, and the router cuts over — create
             the destination copy carrying the resume metadata, THEN
             delete the source.  The cutover refuses to act through a
             stale destination mirror (MirrorStaleError): acting on
             state older than MIRROR_MAX_AGE_S could double-place.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Dict, Optional

from volcano_tpu_torch import metrics, trace
from volcano_tpu_torch.api import elastic as eapi
from volcano_tpu_torch.api import federation as fedapi
from volcano_tpu_torch.api.goodput import generation_of
from volcano_tpu_torch.api.resource import GPU
from volcano_tpu_torch.api.types import (GROUP_NAME_ANNOTATION, JobPhase,
                                   PodGroupPhase)
from volcano_tpu_torch.api.vcjob import VCJob
from volcano_tpu_torch.federation.ha import RouterElector
from volcano_tpu_torch.federation.mirror import MirrorStaleError, RegionMirror
from volcano_tpu_torch.federation import slo as slomod
from volcano_tpu_torch.federation.retry import (FED_RPC_DEADLINE_S, STATE_CODES,
                                          FedRPC, FedRPCError,
                                          RouterFencedError)
from volcano_tpu_torch.federation.stitch import EpisodeStitcher

log = logging.getLogger(__name__)

# goodput EWMA smoothing for the learned steps/sec/GPU signal
GOODPUT_ALPHA = 0.3
# score boost for a region named in the job's data-locality list
LOCALITY_BOOST = 2.0
# serving-aware placement: a SERVING gang's goodput term scales with
# the destination region's measured QPS headroom (folded from the
# serving autoscaler's podgroup stats through the mirror), floored so
# a saturated region is dispreferred, not blacklisted — it may still
# be the only one fitting the gang
SERVING_HEADROOM_FLOOR = 0.25
# resume/progress annotations folded regional -> global every pass,
# so a region loss never loses acked training progress
_FOLD_KEYS = ()     # filled below (import-cycle-free)


def _fold_keys():
    global _FOLD_KEYS
    if not _FOLD_KEYS:
        from volcano_tpu_torch.api.slicehealth import (
            CHECKPOINT_DIR_ANNOTATION, LAST_STEP_ANNOTATION,
            RESUME_STEP_ANNOTATION)
        _FOLD_KEYS = (LAST_STEP_ANNOTATION, RESUME_STEP_ANNOTATION,
                      CHECKPOINT_DIR_ANNOTATION,
                      eapi.ELASTIC_GENERATION_ANNOTATION,
                      eapi.ELASTIC_SLICES_ANNOTATION)
    return _FOLD_KEYS


def job_chips(job: VCJob) -> float:
    """The gang's demand in nvidia.com/gpu (replicas x per-pod
    request)."""
    total = 0.0
    for spec in job.tasks:
        pod = spec.template_pod()
        total += spec.replicas * float(
            pod.resource_requests().get(GPU) or 0)
    return total


class RegionHandle:
    """One attached region: registry record + write client + mirror.

    ``attached_ts`` anchors the mirror WARMUP grace: a router that
    just attached this handle (fresh process after a failover, or a
    region that just registered) has a mirror that hasn't completed
    its first poll, and heartbeat_ts in the registry is whatever the
    PREVIOUS leaseholder last wrote — both stale by construction, not
    by region death.  Liveness verdicts are deferred until the handle
    is older than the region ttl."""

    __slots__ = ("name", "record", "client", "mirror", "attached_ts")

    def __init__(self, name: str, record: dict, client, mirror,
                 attached_ts: float = 0.0):
        self.name = name
        self.record = record
        self.client = client
        self.mirror = mirror
        self.attached_ts = attached_ts


class FederationRouter:
    """Reconciles the global queue against the regional planes.

    *client_factory(record)* builds the region WRITE handle (defaults
    to a RemoteCluster against record["url"]); *mirror_factory(record)*
    builds the read mirror (defaults to RegionMirror tailing
    record["mirror_url"]).  Tests inject in-process fakes for both.
    """

    def __init__(self, global_cluster, now: Callable[[], float] = time.time,
                 client_factory=None, mirror_factory=None,
                 ttl: float = fedapi.REGION_TTL_S,
                 arbitrage_after: float = fedapi.ARBITRAGE_PENDING_S,
                 start_mirrors: bool = True, holder: str = "",
                 elect: bool = False,
                 lease_ttl: float = fedapi.ROUTER_LEASE_TTL_S,
                 mirror_poll_s: Optional[float] = None):
        self.cluster = global_cluster
        self.now = now
        self.ttl = ttl
        self.arbitrage_after = arbitrage_after
        self._start_mirrors = start_mirrors
        self._mirror_poll_s = mirror_poll_s
        self._client_factory = client_factory or self._default_client
        self._mirror_factory = mirror_factory or self._default_mirror
        self.handles: Dict[str, RegionHandle] = {}
        # learned goodput: (region, generation) -> EWMA steps/sec/chip
        self._goodput: Dict[tuple, float] = {}
        # per-job last observed (step, ts) for rate derivation
        self._progress: Dict[str, tuple] = {}
        # in-flight evacuation start ts (timing only; the durable
        # episode state is the evacuating-to annotation)
        self._evac_started: Dict[str, float] = {}
        # measured serving QPS headroom per region, [0, 1]
        self._serving_headroom: Dict[str, float] = {}
        # the ONE cross-region RPC policy: per-region breaker +
        # deterministic backoff + fence classification; breaker
        # trips/closes persist to the global store so a promoted
        # standby adopts learned region health
        self.rpc = FedRPC()
        self.rpc.on_transition = self._breaker_transition
        # observability plane: cross-region episode stitching + fleet
        # metric rollups + SLO burn-rate tracking (leaseholder-only)
        self.stitcher = EpisodeStitcher(global_cluster)
        self.slo = slomod.SLOTracker(now=now)
        # injectable for in-process tests (default: urllib scrape of
        # the region record's metrics_url)
        self._rollup_fetch = slomod.fetch_metrics_text
        # leased replica-set mode: contend for the router lease; only
        # the holder mutates.  elect=False keeps the legacy embedded
        # single-router behavior (in-process tests, one-router bench).
        self.elector: Optional[RouterElector] = RouterElector(
            global_cluster, holder, ttl=lease_ttl) if elect else None

    # -- region attachment ---------------------------------------------

    @staticmethod
    def _default_client(rec: dict):
        from volcano_tpu_torch.cache.remote_cluster import RemoteCluster
        # bounded per-call budget: a dead region costs a slice of one
        # reconcile pass (then its breaker takes over), not the wire
        # client's default 30s deadline
        return RemoteCluster(rec["url"], token=rec.get("token", ""),
                             tolerate_unreachable=True,
                             retry_deadline=FED_RPC_DEADLINE_S)

    def _default_mirror(self, rec: dict):
        m = RegionMirror(rec["name"],
                         rec.get("mirror_url") or rec["url"],
                         token=rec.get("token", ""))
        if self._start_mirrors:
            if self._mirror_poll_s is not None:
                m.start(poll_s=self._mirror_poll_s)
            else:
                m.start()
        return m

    def attach_region(self, record: dict, client=None, mirror=None) -> None:
        """Register a region (tests pass explicit client/mirror)."""
        name = record["name"]
        h = RegionHandle(name, record,
                         client or self._client_factory(record),
                         mirror or self._mirror_factory(record),
                         attached_ts=self.now())
        self.handles[name] = h
        self.cluster.put_object("region", dict(record), key=name)

    def close(self) -> None:
        for h in self.handles.values():
            stop = getattr(h.mirror, "stop", None)
            if stop:
                stop()
        if self.elector is not None:
            self.elector.release()

    # -- reconcile ------------------------------------------------------

    def sync(self) -> None:
        now = self.now()
        leading = True
        if self.elector is not None:
            leading = self.elector.renew()
            metrics.set_gauge("federation_router_is_leader",
                              1.0 if leading else 0.0)
            metrics.set_gauge("federation_router_term",
                              float(self.elector.term))
        # standby (or lease-less) routers OBSERVE ONLY: keep handles
        # attached, mirrors warm and goodput learning so adoption is
        # instant — but never write.  With no leaseholder anywhere,
        # regions run autonomously and the global queue accumulates.
        self._refresh_regions(now, mutate=leading)
        self._observe_goodput(now)
        if leading:
            if self.elector is not None and \
                    self.elector.take_promotion():
                self._adopt(now)
            try:
                self._fold_and_requeue(now)
                self._reap_migrated_residuals(now)
                self._evacuations(now)
                self._arbitrage(now)
                self._admit(now)
            except RouterFencedError as e:
                # a regional plane refused our term as stale: a newer
                # router exists.  Stop mutating mid-pass and
                # re-contend — never retry a fenced write.
                log.warning("%s", e)
                if self.elector is not None:
                    self.elector.step_down()
            else:
                try:
                    self._observability(now)
                except Exception:  # noqa: BLE001 — telemetry never
                    # blocks placement
                    log.exception("observability pass failed")
        self._gauges()

    # -- adoption (first pass after winning a term) ---------------------

    def _adopt(self, now: float) -> None:
        """Make the new term safe, then resume in-flight work.  Fence
        first: advancing every region's floor to our term atomically
        refuses the deposed router's stragglers.  The reconstruction
        itself is the ordinary reconcile pass — the deterministic
        admission key re-finds half-landed creates, the evacuating-to
        annotation re-drives half-done cutovers (create-then-delete,
        idempotent), and _find_admitted_copy guarantees a gang never
        lands twice.  Only the process-local evacuation TIMING needs
        re-seeding here."""
        term = self.elector.term
        for h in list(self.handles.values()):
            self._fence_region(h, term)
        # adopt the deposed holder's learned region health: breakers
        # resume from the persisted state machine position instead of
        # re-probing a known-sick region from closed
        for region, snap in dict(getattr(
                self.cluster, "router_breakers", {})).items():
            if region in self.handles:
                self.rpc.restore(region, snap)
        for job in self._global_jobs():
            if job.annotations.get(
                    fedapi.FED_EVACUATING_TO_ANNOTATION) and \
                    job.key not in self._evac_started:
                self._evac_started[job.key] = now
        metrics.inc("federation_router_adoptions_total")
        self.cluster.record_event(
            "federation-router", "RouterPromoted",
            f"{self.elector.holder} adopted term {term} "
            f"({len(self.handles)} regions fenced)")

    def _fence_region(self, h: RegionHandle, term: int) -> None:
        """Stamp our (name, term) on every future write to this
        region and push its fence floor up-front.  The push is
        best-effort: check_fence self-advances on a HIGHER term, so
        even if it fails here, our first stamped write raises the
        floor — and the old router is refused from that moment."""
        set_fence = getattr(h.client, "set_fence", None)
        if set_fence is not None:
            set_fence(fedapi.ROUTER_LEASE_NAME, term)
        adv = getattr(h.client, "advance_fence", None)
        if adv is None:
            return
        try:
            self.rpc.call(h.name, "advance_fence",
                          lambda: adv(fedapi.ROUTER_LEASE_NAME, term))
        except FedRPCError as e:
            log.warning("fence advance on %s deferred to first "
                        "write: %s", h.name, e)

    # -- breaker persistence (trip/close seam) --------------------------

    def _breaker_transition(self, region: str, breaker,
                            event: str) -> None:
        """Snapshot the breaker into the global store on every trip
        and close, so a promoted standby adopts learned region health
        instead of hot-probing a region its predecessor already knew
        was sick.  Leaseholder-only: a standby's breakers are local
        observations, not fleet truth."""
        if self.elector is not None and not self.elector.is_leader:
            return
        snap = self.rpc.snapshot(region)
        snap["event"] = event
        snap["updated_ts"] = self.now()
        self.cluster.put_object("router_breaker", snap, key=region)

    # -- observability: stitching + rollups + SLO burn ------------------

    def _publish_fragment(self, frag: dict) -> None:
        """Router-plane episode fragments feed the in-process
        stitcher AND the global trace ring (wire mode) — either path
        alone lets a promoted standby reconstruct the stitch."""
        self.stitcher.add_fragment(frag)
        trace.publish(self.cluster, frag)

    def _observability(self, now: float) -> None:
        """Leaseholder-only telemetry pass: stitch every in-flight
        episode's cross-plane fragments into the durable fleet trace,
        fold each ready region's metric exposition into the bounded
        federation_rollup_* families, and advance the multi-window
        SLO burn-rate gauges."""
        self.stitcher.collect(self.handles, now)
        region_samples: Dict[str, list] = {}
        for h in self.handles.values():
            rec = self.cluster.regions.get(h.name, h.record)
            url = rec.get("metrics_url") or ""
            if not url or not fedapi.region_ready(rec, now, self.ttl):
                continue
            try:
                text = self._rollup_fetch(url, rec.get("token", ""))
            except Exception:  # noqa: BLE001 — a dark scrape skips
                # the region this pass; breakers govern writes, not
                # reads
                metrics.inc("federation_rollup_scrape_failures_total",
                            region=h.name)
                continue
            region_samples[h.name] = slomod.parse_samples(text)
        for name, samples in region_samples.items():
            for fam, labels, value in slomod.rollup(name, samples):
                metrics.set_gauge(fam, value, **labels)
        self.slo.ingest(region_samples, now)
        doc = self.slo.export(now)
        self.cluster.put_object("slo", doc, key="global")

    def _refresh_regions(self, now: float, mutate: bool = True) -> None:
        """Fold mirror liveness + capacity into the registry records
        (persisted to the global store so `vtpctl regions` renders the
        fleet from one place)."""
        for name, rec in list(self.cluster.regions.items()):
            if name not in self.handles:
                # registry entry with no handle yet (submitted via
                # vtpctl / another router instance): attach lazily
                h = self.handles[name] = RegionHandle(
                    name, dict(rec), self._client_factory(rec),
                    self._mirror_factory(rec), attached_ts=now)
                if self.elector is not None and self.elector.is_leader:
                    # regions joining under a live term get fenced on
                    # arrival, not at the next promotion
                    self._fence_region(h, self.elector.term)
        for name in [n for n in self.handles
                     if n not in self.cluster.regions]:
            h = self.handles.pop(name)
            stop = getattr(h.mirror, "stop", None)
            if stop:
                stop()
        for h in self.handles.values():
            rec = dict(self.cluster.regions.get(h.name, h.record))
            age = h.mirror.age_s()
            changed = False
            # observed mirror lag, capped so a never-polled mirror
            # reads as "very stale", not infinity
            stale = round(min(age, 10.0 * max(self.ttl, 1.0)), 3)
            metrics.set_gauge("federation_mirror_staleness_seconds",
                              stale, region=h.name)
            if rec.get("mirror_staleness_s") != stale:
                rec["mirror_staleness_s"] = stale
                changed = True
            if age <= self.ttl:
                # a fresh mirror poll IS the heartbeat: the region's
                # server answered with (or confirmed) its WAL horizon
                rec["heartbeat_ts"] = now
                if rec.get("state") == fedapi.REGION_STATE_LOST:
                    rec["state"] = fedapi.REGION_STATE_READY
                    log.info("region %s recovered", h.name)
                cap, idle = self._mirror_chips(h)
                if (cap, idle) != (rec.get("capacity_chips"),
                                   rec.get("idle_chips")):
                    rec["capacity_chips"], rec["idle_chips"] = cap, idle
                changed = True
            elif now - h.attached_ts > self.ttl and \
                    not fedapi.region_alive(rec, now, self.ttl) and \
                    rec.get("state") != fedapi.REGION_STATE_LOST:
                # warmup grace: only a handle OLDER than ttl whose
                # mirror still can't reach the region is a loss — a
                # freshly promoted router must not declare regions
                # dead off heartbeats its dead predecessor stopped
                # writing
                rec["state"] = fedapi.REGION_STATE_LOST
                changed = True
                log.warning("region %s lost (mirror %.1fs stale)",
                            h.name, age)
                if mutate:
                    self.cluster.record_event(
                        f"region/{h.name}", "RegionLost",
                        f"no heartbeat for {age:.1f}s; requeueing its "
                        f"gangs globally")
            # fold the breaker state into the registry record so
            # `vtpctl routers` renders write-path health fleet-wide
            breaker = self.rpc.state(h.name)
            if rec.get("router_breaker") != breaker:
                rec["router_breaker"] = breaker
                changed = True
            if changed:
                h.record = rec
                if mutate:
                    self.cluster.put_object("region", rec, key=h.name)
                metrics.set_gauge("federation_region_capacity_chips",
                                  float(rec.get("capacity_chips", 0)),
                                  region=h.name)
                metrics.set_gauge("federation_region_idle_chips",
                                  float(rec.get("idle_chips", 0)),
                                  region=h.name)

    def _mirror_chips(self, h: RegionHandle) -> tuple:
        """(capacity, idle) GPUs from the region mirror's view."""
        c = h.mirror.cluster
        cap = sum(float((n.allocatable or {}).get(GPU) or 0)
                  for n in c.nodes.values())
        used = 0.0
        for p in c.pods.values():
            if p.node_name and not p.is_terminated():
                used += float(p.resource_requests().get(GPU) or 0)
        return cap, max(0.0, cap - used)

    def _region_generation(self, h: RegionHandle) -> str:
        """The region's dominant GPU generation (bounded enum)."""
        counts: Dict[str, float] = {}
        for n in h.mirror.cluster.nodes.values():
            chips = float((n.allocatable or {}).get(GPU) or 0)
            if chips > 0:
                gen = generation_of(n.labels)
                counts[gen] = counts.get(gen, 0.0) + chips
        if not counts:
            return "other"
        return max(counts, key=counts.get)

    # -- learned goodput ------------------------------------------------

    def _observe_goodput(self, now: float) -> None:
        """Fold LAST_STEP deltas from each mirror into the
        per-(region, generation) steps/sec/chip EWMA."""
        from volcano_tpu_torch.api.slicehealth import LAST_STEP_ANNOTATION
        live = set()
        for h in self.handles.values():
            gen = self._region_generation(h)
            for job in h.mirror.cluster.vcjobs.values():
                raw = job.annotations.get(LAST_STEP_ANNOTATION)
                if raw is None or job.phase is not JobPhase.RUNNING:
                    continue
                try:
                    step = int(raw)
                except (TypeError, ValueError):
                    continue
                jk = f"{h.name}:{job.key}"
                live.add(jk)
                prev = self._progress.get(jk)
                self._progress[jk] = (step, now)
                if prev is None:
                    continue
                pstep, pts = prev
                dt = now - pts
                if dt <= 0 or step <= pstep:
                    continue
                chips = job_chips(job)
                if chips <= 0:
                    continue
                rate = (step - pstep) / dt / chips
                key = (h.name, gen)
                old = self._goodput.get(key)
                self._goodput[key] = rate if old is None else \
                    old + GOODPUT_ALPHA * (rate - old)
                metrics.set_gauge(
                    "federation_region_goodput_steps_per_chip",
                    self._goodput[key], region=h.name)
        for jk in [k for k in self._progress if k not in live]:
            del self._progress[jk]
        for h in self.handles.values():
            self._serving_headroom[h.name] = \
                self._region_serving_headroom(h)
            metrics.set_gauge("federation_region_serving_headroom",
                              self._serving_headroom[h.name],
                              region=h.name)

    def _region_serving_headroom(self, h: RegionHandle) -> float:
        """Measured serving QPS headroom in [0, 1]: how much of the
        region's declared serving capacity (target QPS/replica x
        reporting replicas, from the autoscaler's folded podgroup
        stats) is still unused.  1.0 when the region hosts no serving
        replica groups — training-only regions stay neutral."""
        from volcano_tpu_torch.api import serving as sapi
        qps = target = 0.0
        for pg in h.mirror.cluster.podgroups.values():
            if not sapi.is_serving(pg):
                continue
            qps += sapi.ann_float(pg, sapi.PG_QPS_ANNOTATION)
            per = sapi.target_qps_per_replica(pg)
            reps = sapi.ann_float(pg, sapi.PG_REPLICAS_ANNOTATION)
            target += per * max(1.0, reps)
        if target <= 0:
            return 1.0
        return max(0.0, min(1.0, (target - qps) / target))

    def _goodput_factor(self, h: RegionHandle,
                        job: Optional[VCJob] = None) -> float:
        """This region's learned rate relative to the fleet mean —
        1.0 until anything has been learned (cold start is neutral).
        For a SERVING gang the term additionally scales with the
        region's measured QPS headroom: a region whose serving fleet
        is already at its target QPS makes a poor home for one more
        replica group, whatever its training goodput says."""
        if not self._goodput:
            base = 1.0
        else:
            gen = self._region_generation(h)
            mine = self._goodput.get((h.name, gen))
            if mine is None:
                base = 1.0
            else:
                mean = sum(self._goodput.values()) / len(self._goodput)
                base = mine / mean if mean > 0 else 1.0
        if job is not None:
            from volcano_tpu_torch.api import serving as sapi
            if sapi.is_serving(job):
                head = self._serving_headroom.get(h.name, 1.0)
                base *= SERVING_HEADROOM_FLOOR + \
                    (1.0 - SERVING_HEADROOM_FLOOR) * head
        return base

    # -- admission ------------------------------------------------------

    def _global_jobs(self):
        return [j for j in self.cluster.vcjobs.values()
                if fedapi.home_key(j) is None]

    def _score(self, h: RegionHandle, job: VCJob, need: float
               ) -> float:
        rec = self.cluster.regions.get(h.name, h.record)
        if not fedapi.region_ready(rec, self.now(), self.ttl):
            return 0.0
        if not self.rpc.available(h.name):
            # breaker open: we can SEE the region (mirror) but cannot
            # WRITE to it — placing there would strand the admission
            return 0.0
        idle = float(rec.get("idle_chips", 0) or 0)
        cap = float(rec.get("capacity_chips", 0) or 0)
        if need > 0 and cap < need:
            return 0.0              # can never fit, even empty
        # fractional fit: a region that can take the gang NOW beats
        # one that must first drain something
        fit = 1.0 if need <= 0 or idle >= need else \
            0.25 * (idle / need)
        price = max(1e-9, float(rec.get("price", 1.0) or 1.0))
        locality = LOCALITY_BOOST if h.name in \
            fedapi.data_locality(job) else 1.0
        return locality * self._goodput_factor(h, job) * fit / price

    def _pick_region(self, job: VCJob, exclude=() ) -> Optional[str]:
        need = job_chips(job)
        best, best_score = None, 0.0
        for name in sorted(self.handles):
            if name in exclude:
                continue
            score = self._score(self.handles[name], job, need)
            if score > best_score:
                best, best_score = name, score
        return best

    def _attempt(self, job: VCJob) -> int:
        try:
            return int(job.annotations.get(
                fedapi.FED_ATTEMPT_ANNOTATION, 0) or 0)
        except (TypeError, ValueError):
            return 0

    def _find_admitted_copy(self, key: str) -> Optional[str]:
        """Scan every region for a copy carrying *key* — the restart
        recovery path: the create landed, the global stamp did not."""
        for h in self.handles.values():
            for view in (h.mirror.cluster, h.client):
                jobs = getattr(view, "vcjobs", {})
                for rjob in list(jobs.values()):
                    if rjob.annotations.get(
                            fedapi.FED_ADMISSION_KEY_ANNOTATION) == key:
                        return h.name
        return None

    def _regional_copy(self, job: VCJob, region: str, key: str,
                       extra: Optional[dict] = None) -> VCJob:
        copy = job.clone()
        # fresh status: the copy starts life as a new regional job
        copy.phase = JobPhase.PENDING
        copy.version = 0
        copy.retry_count = 0
        copy.conditions = []
        copy.pending = copy.running = copy.succeeded = 0
        copy.failed = copy.terminating = copy.unknown = 0
        copy.finish_time = None
        ann = copy.annotations
        ann[fedapi.FED_HOME_ANNOTATION] = job.key
        ann[fedapi.FED_ORIGIN_REGION_ANNOTATION] = region
        ann[fedapi.FED_ADMISSION_KEY_ANNOTATION] = key
        for k in (fedapi.FED_ADMITTED_REGION_ANNOTATION,
                  fedapi.FED_ADMITTED_TS_ANNOTATION,
                  fedapi.FED_EVACUATE_ANNOTATION,
                  fedapi.FED_EVACUATING_TO_ANNOTATION):
            ann.pop(k, None)
        if extra:
            ann.update(extra)
        return copy

    def _stamp_admitted(self, job: VCJob, region: str, key: str,
                        now: float) -> None:
        job.annotations[fedapi.FED_ADMISSION_KEY_ANNOTATION] = key
        job.annotations[fedapi.FED_ADMITTED_REGION_ANNOTATION] = region
        job.annotations[fedapi.FED_ADMITTED_TS_ANNOTATION] = \
            f"{now:.3f}"
        job.annotations[fedapi.FED_REGIONAL_PHASE_ANNOTATION] = \
            JobPhase.PENDING.value
        self.cluster.update_vcjob(job)

    def _admit(self, now: float) -> None:
        from volcano_tpu_torch.api.types import FINISHED_JOB_PHASES
        for job in self._global_jobs():
            if job.phase in FINISHED_JOB_PHASES or \
                    fedapi.admitted_region(job) is not None:
                continue
            key = fedapi.admission_key(job.key, self._attempt(job))
            # restart recovery BEFORE placing: did a previous router
            # life already create this attempt's copy somewhere?
            prior = self._find_admitted_copy(key)
            if prior is not None:
                log.info("admission of %s (key %s) already landed in "
                         "%s; re-stamping", job.key, key, prior)
                self._stamp_admitted(job, prior, key, now)
                continue
            region = self._pick_region(job)
            if region is None:
                continue            # nothing ready/fitting: stay queued
            # mint (or re-derive) the causal episode ID BEFORE the
            # clone, so the regional copy — and through it the
            # podgroup and every pod — carries it on creation
            episode = fedapi.ensure_episode(job, now)
            h = self.handles[region]
            copy = self._regional_copy(job, region, key)
            try:
                self.rpc.call(region, "add_vcjob",
                              lambda: h.client.add_vcjob(copy))
            except FedRPCError as e:
                log.warning("admission of %s failed: %s", job.key, e)
                continue
            self._stamp_admitted(job, region, key, now)
            self.cluster.record_event(
                job.key, "FederationAdmitted",
                f"admitted to region {region} (key {key}, "
                f"episode {episode})")
            metrics.inc("federation_admissions_total", region=region)
            hop = fedapi.episode_hop(job)
            # hop 0's admit span starts at the episode mint (global
            # queue wait is part of the causal story); re-admissions
            # at later hops are point decisions
            start = fedapi.episode_ts(job, now) if hop == 0 else now
            self._publish_fragment(
                trace.fragment_doc(
                    f"router-admit {job.key}", "router", episode,
                    min(start, now), now, hop=hop, jobs=(job.key,),
                    labels={"region": region}))

    # -- phase folding + region-loss requeue ---------------------------

    def _copy_of(self, h: RegionHandle, key: str):
        """The regional copy as the MIRROR sees it (falling back to
        the write client's view while the mirror warms up)."""
        job = h.mirror.cluster.vcjobs.get(key)
        if job is None:
            job = getattr(h.client, "vcjobs", {}).get(key)
        return job

    def _fold_and_requeue(self, now: float) -> None:
        from volcano_tpu_torch.api.types import FINISHED_JOB_PHASES
        for job in self._global_jobs():
            region = fedapi.admitted_region(job)
            if region is None or job.phase in FINISHED_JOB_PHASES:
                continue
            h = self.handles.get(region)
            rec = self.cluster.regions.get(region,
                                           h.record if h else None)
            # requeue rides the EXPLICIT lost transition made by
            # _refresh_regions (which owns the mirror-warmup grace) —
            # raw heartbeat staleness alone is ambiguous right after
            # a router failover
            if h is None or rec is None or \
                    rec.get("state") == fedapi.REGION_STATE_LOST:
                self._requeue(job, region, "region lost")
                continue
            copy = self._copy_of(h, job.key)
            if copy is None:
                continue            # not visible yet (mirror lag)
            changed = False
            phase = copy.phase.value
            if job.annotations.get(
                    fedapi.FED_REGIONAL_PHASE_ANNOTATION) != phase:
                job.annotations[
                    fedapi.FED_REGIONAL_PHASE_ANNOTATION] = phase
                changed = True
            # fold acked progress up: these annotations ARE the
            # migration/loss continuity story — once folded, a whole-
            # region loss resumes from this step, not from zero
            for k in _fold_keys():
                v = copy.annotations.get(k)
                if v is not None and job.annotations.get(k) != v:
                    job.annotations[k] = v
                    changed = True
            if copy.phase in FINISHED_JOB_PHASES:
                job.phase = copy.phase
                job.finish_time = copy.finish_time or now
                changed = True
            if changed:
                self.cluster.update_vcjob(job)

    def _requeue(self, job: VCJob, region: Optional[str],
                 why: str) -> None:
        ann = job.annotations
        ann.pop(fedapi.FED_ADMITTED_REGION_ANNOTATION, None)
        ann.pop(fedapi.FED_ADMITTED_TS_ANNOTATION, None)
        ann.pop(fedapi.FED_REGIONAL_PHASE_ANNOTATION, None)
        ann.pop(fedapi.FED_EVACUATING_TO_ANNOTATION, None)
        if region:
            ann[fedapi.FED_MIGRATED_FROM_ANNOTATION] = region
        ann[fedapi.FED_ATTEMPT_ANNOTATION] = \
            str(self._attempt(job) + 1)
        episode = fedapi.episode_of(job)
        hop = fedapi.episode_hop(job)
        if episode:
            # a requeue is a cross-region move: the next admission
            # lands at the next hop of the SAME episode
            hop += 1
            ann[fedapi.FED_EPISODE_HOP_ANNOTATION] = str(hop)
        self.cluster.update_vcjob(job)
        self.cluster.record_event(
            job.key, "FederationRequeued",
            f"requeued out of {region or '?'}: {why}")
        metrics.inc("federation_requeues_total",
                    region=region or "unknown")
        self._evac_started.pop(job.key, None)
        if episode:
            t = self.now()
            self._publish_fragment(
                trace.fragment_doc(
                    f"router-requeue {job.key}", "router", episode,
                    t, t, hop=hop, jobs=(job.key,),
                    labels={"from": region or "?", "why": why[:64]}))

    # -- pending-gang burst arbitrage ----------------------------------

    def _arbitrage(self, now: float) -> None:
        for job in self._global_jobs():
            region = fedapi.admitted_region(job)
            if region is None or job.annotations.get(
                    fedapi.FED_EVACUATING_TO_ANNOTATION):
                continue
            try:
                admitted_ts = float(job.annotations.get(
                    fedapi.FED_ADMITTED_TS_ANNOTATION, 0) or 0)
            except (TypeError, ValueError):
                continue
            if now - admitted_ts < self.arbitrage_after:
                continue
            h = self.handles.get(region)
            copy = self._copy_of(h, job.key) if h else None
            if copy is None or copy.phase is not JobPhase.PENDING:
                continue
            pg = h.mirror.cluster.podgroups.get(job.key)
            if pg is not None and pg.phase is PodGroupPhase.RUNNING:
                continue
            need = job_chips(job)
            cur_score = self._score(h, job, need)
            better = None
            for name in sorted(self.handles):
                if name == region:
                    continue
                cand = self.handles[name]
                rec = self.cluster.regions.get(name, cand.record)
                if float(rec.get("idle_chips", 0) or 0) < need:
                    continue        # arbitrage only to a region with
                                    # the chips idle RIGHT NOW
                if self._score(cand, job, need) > cur_score:
                    better = name
                    break
            if better is None:
                continue
            try:
                # vtplint: disable=episode-propagation (the hop bump and requeue fragment ride _requeue below, which stamps the episode)
                self.rpc.call(region, "delete_vcjob",
                              lambda: h.client.delete_vcjob(job.key))
            except FedRPCError as e:
                log.warning("arbitrage delete of %s failed: %s",
                            job.key, e)
                continue
            n = fedapi.migration_count(job) + 1
            job.annotations[fedapi.FED_MIGRATIONS_ANNOTATION] = str(n)
            self._requeue(job, region,
                          f"pending {now - admitted_ts:.0f}s while "
                          f"{better} has idle capacity")
            metrics.inc("federation_migrations_total", kind="pending")

    # -- cross-region migration of RUNNING gangs ------------------------

    def _wants_evacuation(self, job: VCJob, region: str) -> bool:
        if job.annotations.get(fedapi.FED_EVACUATE_ANNOTATION):
            return True
        rec = self.cluster.regions.get(region)
        return bool(rec) and \
            rec.get("state") == fedapi.REGION_STATE_DRAINING

    def _evacuations(self, now: float) -> None:
        for job in self._global_jobs():
            region = fedapi.admitted_region(job)
            if region is None or region not in self.handles:
                continue
            dest = job.annotations.get(
                fedapi.FED_EVACUATING_TO_ANNOTATION)
            if dest:
                self._drive_cutover(job, region, dest, now)
            elif self._wants_evacuation(job, region):
                self._start_evacuation(job, region, now)

    def _start_evacuation(self, job: VCJob, src: str,
                          now: float) -> None:
        h = self.handles[src]
        copy = self._copy_of(h, job.key)
        if copy is None or copy.phase is not JobPhase.RUNNING:
            # not running: arbitrage/requeue is the cheaper move —
            # nothing checkpointed to carry
            return
        want = job.annotations.get(fedapi.FED_EVACUATE_ANNOTATION, "")
        if want and want != "auto" and want != src and \
                want in self.handles and fedapi.region_ready(
                    self.cluster.regions.get(want, {}), now, self.ttl):
            dest = want
        else:
            dest = self._pick_region(job, exclude=(src,))
        if dest is None:
            return                  # nowhere to go yet; retry later
        pg = getattr(h.client, "podgroups", {}).get(job.key)
        if pg is None:
            pg = h.mirror.cluster.podgroups.get(job.key)
        if pg is None:
            return
        ann = pg.annotations
        ann[eapi.ELASTIC_EVACUATE_ANNOTATION] = dest
        ann[eapi.ELASTIC_DESIRED_SLICES_ANNOTATION] = \
            str(eapi.current_slices(pg))
        ann[eapi.ELASTIC_RESIZE_REASON_ANNOTATION] = \
            eapi.RESIZE_EVACUATE
        ann[eapi.ELASTIC_DECIDED_TS_ANNOTATION] = f"{now:.3f}"
        episode = fedapi.episode_of(job)
        if episode:
            # stamp the episode onto the SOURCE podgroup: the
            # regional elastic controller's drain fragment then joins
            # this causal timeline (jobs admitted before the episode
            # scheme get it retro-stamped here)
            ann[fedapi.FED_EPISODE_ANNOTATION] = episode
            ann[fedapi.FED_EPISODE_HOP_ANNOTATION] = \
                str(fedapi.episode_hop(job))
        try:
            self.rpc.call(src, "update_podgroup_status",
                          lambda: h.client.update_podgroup_status(pg))
        except FedRPCError as e:
            log.warning("evacuate stamp on %s failed: %s", job.key, e)
            return
        job.annotations[fedapi.FED_EVACUATING_TO_ANNOTATION] = dest
        self.cluster.update_vcjob(job)
        self._evac_started[job.key] = now
        self.cluster.record_event(
            job.key, "FederationEvacuating",
            f"draining out of {src} toward {dest}")

    def _reap_migrated_residuals(self, now: float) -> None:
        """Sweep migration husks out of SOURCE regions, once per pass
        until they stay gone.  The cutover's source delete races the
        regional job controller: an in-flight status flush is an
        upsert that resurrects the just-deleted copy, and the drain's
        RestartJob re-materializes pods that outlive the job as
        orphans (which the podgroup normalizer would re-adopt and the
        scheduler would then place — ghost pods eating real chips).
        Detection reads the mirror; deletes go through the write
        client and repeat next pass if anything reappears."""
        for job in self._global_jobs():
            src = job.annotations.get(
                fedapi.FED_MIGRATED_FROM_ANNOTATION)
            region = fedapi.admitted_region(job)
            if not src or src == region:
                continue
            h = self.handles.get(src)
            if h is None or not fedapi.region_alive(
                    self.cluster.regions.get(src, {}), now, self.ttl):
                continue            # dead source: nothing to reap yet
            c = h.mirror.cluster
            name = job.key.rsplit("/", 1)[-1]
            victims = [p.key for p in c.pods.values()
                       if p.annotations.get(
                           GROUP_NAME_ANNOTATION) == name]
            if c.vcjobs.get(job.key) is None and \
                    c.podgroups.get(job.key) is None and not victims:
                continue
            def _reap(c=c, h=h, key=job.key, victims=victims):
                if c.vcjobs.get(key) is not None:
                    h.client.delete_vcjob(key)
                if c.podgroups.get(key) is not None:
                    h.client.delete_podgroup(key)
                for pkey in victims:
                    h.client.delete_pod(pkey)
            try:
                self.rpc.call(src, "reap_residuals", _reap)
            except FedRPCError as e:
                log.warning("residual reap of %s failed (next pass "
                            "retries): %s", job.key, e)
                continue
            metrics.inc("federation_source_reaps_total", region=src)
            log.info("reaped migration residue of %s in %s "
                     "(%d pods, episode %s)", job.key, src,
                     len(victims), fedapi.episode_of(job) or "-")

    def _drive_cutover(self, job: VCJob, src: str, dest: str,
                       now: float) -> None:
        h = self.handles[src]
        dh = self.handles.get(dest)
        if dh is None or not fedapi.region_ready(
                self.cluster.regions.get(dest, {}), now, self.ttl):
            # destination fell over mid-drain: abort toward a re-pick
            job.annotations.pop(
                fedapi.FED_EVACUATING_TO_ANNOTATION, None)
            self.cluster.update_vcjob(job)
            return
        copy = self._copy_of(h, job.key)
        if copy is None:
            return
        pg = h.mirror.cluster.podgroups.get(job.key)
        if pg is None or pg.annotations.get(
                eapi.ELASTIC_EVACUATED_ANNOTATION) != "true":
            return                  # source drain still in flight
        # the cutover gate: BOTH mirrors must be within the staleness
        # bound — the source's for the resume metadata we carry, the
        # destination's to see what we'd collide with.  A stale mirror
        # refuses (MirrorStaleError) rather than guessing.
        try:
            h.mirror.read_checked()
            dh.mirror.read_checked()
        except MirrorStaleError as e:
            metrics.inc("federation_cutover_refusals_total",
                        region=e.region)
            self.cluster.record_event(
                job.key, "FederationCutoverRefused", str(e))
            return
        key = fedapi.admission_key(job.key, self._attempt(job) + 1)
        if dh.mirror.cluster.vcjobs.get(job.key) is None and \
                self._find_admitted_copy(key) is None:
            resume = {k: v for k in _fold_keys()
                      if (v := copy.annotations.get(k)) is not None}
            resume[fedapi.FED_MIGRATED_FROM_ANNOTATION] = src
            episode = fedapi.episode_of(job)
            if episode:
                # both cutover sides carry the SAME episode; the
                # destination copy lands at the next hop
                resume[fedapi.FED_EPISODE_ANNOTATION] = episode
                resume[fedapi.FED_EPISODE_HOP_ANNOTATION] = \
                    str(fedapi.episode_hop(job) + 1)
            dcopy = self._regional_copy(job, dest, key, extra=resume)
            dcopy.annotations.pop(eapi.ELASTIC_EVACUATE_ANNOTATION,
                                  None)
            dcopy.annotations.pop(eapi.ELASTIC_EVACUATED_ANNOTATION,
                                  None)
            try:
                self.rpc.call(dest, "add_vcjob",
                              lambda: dh.client.add_vcjob(dcopy))
            except FedRPCError as e:
                log.warning("cutover create of %s failed: %s",
                            job.key, e)
                return
        # destination accepted: the source copy (and its held pods)
        # can go — ORDER MATTERS, delete only after the create landed
        try:
            self.rpc.call(src, "delete_vcjob",
                          lambda: h.client.delete_vcjob(job.key))
        except FedRPCError as e:
            log.warning("source delete of %s failed (residual reap "
                        "retries): %s", job.key, e)
        ann = job.annotations
        n = fedapi.migration_count(job) + 1
        ann[fedapi.FED_MIGRATIONS_ANNOTATION] = str(n)
        ann[fedapi.FED_MIGRATED_FROM_ANNOTATION] = src
        ann[fedapi.FED_ATTEMPT_ANNOTATION] = \
            str(self._attempt(job) + 1)
        ann[fedapi.FED_ADMITTED_REGION_ANNOTATION] = dest
        ann[fedapi.FED_ADMITTED_TS_ANNOTATION] = f"{now:.3f}"
        ann[fedapi.FED_ADMISSION_KEY_ANNOTATION] = key
        ann.pop(fedapi.FED_EVACUATE_ANNOTATION, None)
        ann.pop(fedapi.FED_EVACUATING_TO_ANNOTATION, None)
        episode = fedapi.episode_of(job)
        old_hop = fedapi.episode_hop(job)
        if episode:
            ann[fedapi.FED_EPISODE_HOP_ANNOTATION] = str(old_hop + 1)
        self.cluster.update_vcjob(job)
        started = self._evac_started.pop(job.key, None)
        if started is not None:
            metrics.observe("federation_cutover_seconds",
                            now - started)
        self.cluster.record_event(
            job.key, "FederationMigrated",
            f"cut over {src} -> {dest} (migration #{n})")
        metrics.inc("federation_migrations_total", kind="running")
        if episode:
            # the cutover span (decision -> source drained -> dest
            # created) belongs to the SOURCE hop's timeline; the
            # destination's own fragments start the next hop
            self._publish_fragment(
                trace.fragment_doc(
                    f"router-cutover {job.key}", "router", episode,
                    started if started is not None else now, now,
                    hop=old_hop, jobs=(job.key,),
                    labels={"from": src, "to": dest}))

    # -- census ---------------------------------------------------------

    def _gauges(self) -> None:
        states = {s: 0 for s in fedapi.REGION_STATES}
        now = self.now()
        for name, rec in self.cluster.regions.items():
            state = rec.get("state", fedapi.REGION_STATE_LOST)
            if state == fedapi.REGION_STATE_READY and \
                    not fedapi.region_alive(rec, now, self.ttl):
                state = fedapi.REGION_STATE_LOST
            if state not in states:
                state = fedapi.REGION_STATE_LOST
            states[state] += 1
        for state, n in states.items():
            metrics.set_gauge("federation_regions", n, state=state)
        pending = sum(1 for j in self._global_jobs()
                      if fedapi.admitted_region(j) is None
                      and j.phase is JobPhase.PENDING)
        metrics.set_gauge("federation_pending_jobs", pending)
        for region, b in self.rpc.breakers.items():
            metrics.set_gauge("federation_router_breaker_state",
                              STATE_CODES[b.state], region=region)
            snap = self.rpc.snapshot(region)
            for fam, field in (
                    ("federation_router_breaker_failures",
                     "failures"),
                    ("federation_router_breaker_opens", "opens"),
                    ("federation_router_breaker_half_opens",
                     "half_opens"),
                    ("federation_router_breaker_last_trip_ts",
                     "last_trip_ts"),
                    ("federation_router_breaker_retry_in_seconds",
                     "retry_in_s")):
                metrics.set_gauge(fam, float(snap[field]),
                                  region=region)


def main(argv=None) -> int:
    """`python -m volcano_tpu_torch.federation.router --store URL`"""
    import argparse

    from volcano_tpu_torch.cache.remote_cluster import RemoteCluster
    ap = argparse.ArgumentParser(
        description="federation router: one global queue over N "
                    "regional planes")
    ap.add_argument("--store", required=True,
                    help="global state server URL (may be a comma-"
                         "separated replica group)")
    ap.add_argument("--token", default="")
    ap.add_argument("--sync-s", type=float, default=2.0)
    ap.add_argument("--ttl-s", type=float, default=fedapi.REGION_TTL_S,
                    help="region loss TTL (bench planes compress it)")
    ap.add_argument("--arbitrage-s", type=float,
                    default=fedapi.ARBITRAGE_PENDING_S)
    ap.add_argument("--metrics-port", type=int, default=0)
    ap.add_argument("--holder", default="",
                    help="router lease identity (default: "
                         "router-<pid>); N processes with distinct "
                         "holders form the HA replica set")
    ap.add_argument("--lease-ttl-s", type=float,
                    default=fedapi.ROUTER_LEASE_TTL_S,
                    help="router lease TTL (bounds failover MTTR)")
    ap.add_argument("--no-elect", action="store_true",
                    help="legacy single-router mode: mutate without "
                         "holding the lease (NO fencing)")
    ap.add_argument("--mirror-poll-s", type=float, default=0.0,
                    help="mirror tail long-poll ceiling (bench planes "
                         "compress it below the region TTL)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    cluster = RemoteCluster(args.store, token=args.token,
                            tolerate_unreachable=True)
    if args.metrics_port:
        metrics.serve(args.metrics_port)
    import os
    router = FederationRouter(cluster, ttl=args.ttl_s,
                              arbitrage_after=args.arbitrage_s,
                              holder=args.holder or
                              f"router-{os.getpid()}",
                              elect=not args.no_elect,
                              lease_ttl=args.lease_ttl_s,
                              mirror_poll_s=args.mirror_poll_s or None)
    try:
        while True:
            try:
                router.sync()
            except Exception:       # noqa: BLE001 — keep reconciling
                log.exception("router sync failed")
            time.sleep(args.sync_s)
    except KeyboardInterrupt:
        return 0
    finally:
        router.close()
        cluster.close()


if __name__ == "__main__":
    raise SystemExit(main())

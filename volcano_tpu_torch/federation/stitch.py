"""Cross-plane episode trace stitching (leaseholder router only).

Every plane that touches a federated gang leaves a LOCAL fragment of
its causal episode: the router's admit/cutover spans, the regional
schedulers' session traces (root `episode` label), the controllers'
drain/recovery fragments, and the lifecycle phase stamps riding the
gang's pods.  None of them can see the whole story — the stitcher
can, because the router already holds a mirror and a client for every
region (the same machinery region heartbeats ride).

Per pass, for each in-flight episode it:

  1. pulls `/traces?episode=` fragments from each regional ring,
  2. synthesizes a per-hop `lifecycle` fragment from the phase
     stamps visible in the region's mirror (created -> enqueued ->
     allocated -> bound -> admitted -> running — mirror-fed, so a
     region whose ring rotated still contributes its placement),
  3. recovers the previously stitched tree from the global store (a
     promoted standby adopts the deposed holder's fragments instead
     of starting blind — stitches survive router failover),
  4. merges + orders fragments by (hop, start) and applies the
     PER-HOP CLOCK-SKEW CLAMP — trace.phase_segments' telescoping
     rule lifted to hops: a later hop may not begin before the
     stitched frontier, negative skew collapses to zero and the
     frontier only moves forward, so the segment sum always equals
     the stitched wall time,
  5. writes the stitched doc to the `fleet_trace` dict-kind in the
     GLOBAL store (durable; `GET /fleet_trace?episode=` serves it).

Episode IDs live in annotations and trace labels only — the single
metric here (`federation_stitched_traces_total`) is label-free.
"""

from __future__ import annotations

import logging
from collections import OrderedDict
from typing import Dict, List, Optional

from volcano_tpu_torch import metrics, trace
from volcano_tpu_torch.api import federation as fedapi

log = logging.getLogger(__name__)

# fragments kept per episode / episodes tracked / episodes stitched
# per pass (bounded memory; a pathological fleet degrades to stale
# stitches, never to an unbounded router)
MAX_FRAGMENTS = 64
MAX_EPISODES = 64
MAX_EPISODES_PER_PASS = 8
PULL_LIMIT = 32


def _frag_key(plane: str, root: dict) -> str:
    """Stable fragment identity across passes AND across routers
    (embedded as the `fkey` label so a recovered stitched tree dedups
    against a re-pull of the same ring doc)."""
    return (f"{plane}|{root.get('name', '?')}"
            f"|{root.get('start', 0.0):.2f}")


def _shift(span: dict, delta: float) -> dict:
    out = dict(span)
    out["start"] = span.get("start", 0.0) + delta
    kids = span.get("children")
    if kids:
        out["children"] = [_shift(c, delta) for c in kids]
    return out


def _fragment(plane: str, hop: int, root: dict, jobs=()) -> dict:
    return {"plane": plane, "hop": int(hop), "root": root,
            "key": root.get("labels", {}).get("fkey")
            or _frag_key(plane, root), "jobs": list(jobs)}


def stitch(episode: str, fragments: List[dict],
           t0: Optional[float] = None, jobs=()) -> Optional[dict]:
    """One cross-plane span tree from this episode's fragments.

    Pure function: fragments are {"plane", "hop", "root", ...} with
    COMPLETE roots (incomplete ones are dropped — the global store's
    is_complete_span gate must always pass).  Returns None when
    nothing stitchable remains."""
    frags = [f for f in fragments if trace.is_complete_span(f["root"])]
    if not frags:
        return None
    frags.sort(key=lambda f: (f["hop"],
                              f["root"].get("start", 0.0)))
    base = min(f["root"].get("start", 0.0) for f in frags)
    if t0 is not None:
        base = min(base, t0)
    # per-hop clamp: each hop group shifts forward (never back) so it
    # cannot begin before the stitched frontier — the telescoping
    # rule of trace.phase_segments applied across plane clocks
    segments: Dict[str, float] = {}
    children = []
    planes = set()
    frontier = base
    hops = sorted({f["hop"] for f in frags})
    for hop in hops:
        group = [f for f in frags if f["hop"] == hop]
        gstart = min(f["root"].get("start", 0.0) for f in group)
        gend = max(f["root"].get("start", 0.0)
                   + f["root"].get("dur", 0.0) for f in group)
        shift = max(0.0, frontier - gstart) \
            if gstart < frontier else 0.0
        gstart += shift
        gend += shift
        segments[f"hop{hop}-wait"] = max(0.0, gstart - frontier)
        frontier = max(frontier, gstart)
        segments[f"hop{hop}-active"] = max(0.0, gend - frontier)
        frontier = max(frontier, gend)
        for f in group:
            planes.add(f["plane"])
            root = _shift(f["root"], shift)
            lbl = dict(root.get("labels", {}))
            # the fragment's resolved plane is authoritative — a ring
            # doc's own label says "controllers", but the stitched
            # tree must carry the per-region rename so the Perfetto
            # track matches the doc's planes list
            lbl["plane"] = f["plane"]
            lbl["hop"] = str(hop)
            lbl["episode"] = episode
            lbl["fkey"] = f["key"]
            if shift:
                # the clamp is visible, not silent: how far this
                # plane's clock was pushed to honour causality
                lbl["skew_clamp_s"] = f"{shift:.3f}"
            root["labels"] = lbl
            children.append(root)
    wall = frontier - base
    root = {"name": f"episode {episode}", "kind": "fleet",
            "labels": {"episode": episode}, "start": base,
            "dur": wall, "children": children}
    return {"seq": 0, "kept_because": "stitched", "episode": episode,
            "jobs": sorted(set(jobs)), "pending": {},
            "planes": sorted(planes), "hops": hops,
            "segments": {k: round(v, 6) for k, v in segments.items()},
            "wall_s": round(wall, 6), "root": root}


class EpisodeStitcher:
    """The collector: owns local router fragments, the per-region
    pulls, lifecycle synthesis from mirrors, and the durable stitched
    doc in the global store."""

    def __init__(self, cluster, now=None):
        self.cluster = cluster          # GLOBAL store client
        self._local: "OrderedDict[str, OrderedDict[str, dict]]" = \
            OrderedDict()
        self._published: Dict[str, tuple] = {}

    # -- router-side fragments -----------------------------------------

    def add_fragment(self, doc: dict) -> None:
        """A router-plane fragment (admit / requeue / cutover span)
        in ring-doc shape, as built by trace.fragment_doc."""
        episode = doc.get("episode")
        root = doc.get("root")
        if not episode or not trace.is_complete_span(root):
            return
        frags = self._local.setdefault(episode, OrderedDict())
        lbl = root.get("labels", {})
        frag = _fragment(lbl.get("plane", "router"),
                         int(lbl.get("hop", 0) or 0), root,
                         jobs=doc.get("jobs", ()))
        frags[frag["key"]] = frag
        while len(frags) > MAX_FRAGMENTS:
            frags.popitem(last=False)
        self._local.move_to_end(episode)
        while len(self._local) > MAX_EPISODES:
            self._local.popitem(last=False)

    # -- regional pulls ------------------------------------------------

    def _pull_ring(self, name: str, handle, episode: str,
                   default_hop: int) -> List[dict]:
        """This region's /traces fragments for one episode (wire mode
        only — in-process regional planes contribute via mirrors)."""
        request = getattr(handle.client, "_request", None)
        if request is None:
            return []
        try:
            resp = request(
                "GET", f"/traces?episode={episode}&limit={PULL_LIMIT}",
                deadline=2.0)
        except Exception:  # noqa: BLE001 — a dark ring skips a pass
            return []
        out = []
        for doc in (resp or {}).get("traces", ()):
            root = doc.get("root")
            if not trace.is_complete_span(root):
                continue
            lbl = root.get("labels", {})
            plane = lbl.get("plane") or f"region-{name}"
            if plane == "controllers":
                plane = f"controllers-{name}"
            try:
                hop = int(lbl.get("hop", default_hop) or default_hop)
            except (TypeError, ValueError):
                hop = default_hop
            out.append(_fragment(plane, hop, root,
                                 jobs=doc.get("jobs", ())))
        return out

    def _lifecycle(self, name: str, handle, episode: str
                   ) -> List[dict]:
        """Synthesized per-hop lifecycle fragment from the phase
        stamps visible in the region's mirror — the mirror-fed leg of
        the stitch (covers destination placement + resume even when
        the regional ring rotated the session away)."""
        try:
            rc = handle.mirror.read_checked(max_age_s=float("inf"))
        except Exception:  # noqa: BLE001 — no mirror, no lifecycle
            return []
        out = []
        for pg in list(getattr(rc, "podgroups", {}).values()):
            if fedapi.episode_of(pg) != episode:
                continue
            hop = fedapi.episode_hop(pg)
            stamps: Dict[str, float] = {}
            for phase in trace.PHASES:
                ts = trace.phase_ts(pg.annotations, phase)
                if ts is not None:
                    stamps[phase] = ts
            ns, _, pgname = pg.key.partition("/")
            for pod in list(getattr(rc, "pods", {}).values()):
                if fedapi.episode_of(pod) != episode or \
                        pod.namespace != ns:
                    continue
                for phase in trace.PHASES:
                    ts = trace.phase_ts(pod.annotations, phase)
                    if ts is None:
                        continue
                    cur = stamps.get(phase)
                    stamps[phase] = ts if cur is None \
                        else min(cur, ts)
            if not stamps:
                continue
            start = min(stamps.values())
            end = max(stamps.values())
            children = []
            prev = start
            for phase in trace.PHASES:
                ts = stamps.get(phase)
                if ts is None:
                    continue
                # the telescoping rule, verbatim from phase_segments
                children.append((phase, prev, max(prev, ts)))
                prev = max(prev, ts)
            doc = trace.fragment_doc(
                f"lifecycle {pg.key}", f"region-{name}", episode,
                start, end, hop=hop, jobs=(pg.key,),
                children=children)
            out.append(_fragment(f"region-{name}", hop, doc["root"],
                                 jobs=(pg.key,)))
        return out

    def _recover(self, episode: str) -> List[dict]:
        """Fragments of the previously stitched tree in the global
        store — the failover-adoption leg (a promoted standby merges
        the deposed holder's work instead of re-deriving what it can
        and losing what it cannot)."""
        prior = getattr(self.cluster, "fleet_traces", {}).get(episode)
        if not isinstance(prior, dict):
            return []
        out = []
        for child in prior.get("root", {}).get("children", ()):
            lbl = child.get("labels", {})
            try:
                hop = int(lbl.get("hop", 0) or 0)
            except (TypeError, ValueError):
                hop = 0
            out.append(_fragment(lbl.get("plane", "?"), hop, child,
                                 jobs=prior.get("jobs", ())))
        return out

    # -- the pass ------------------------------------------------------

    def collect(self, handles: dict, now: float) -> int:
        """One leaseholder pass: stitch every in-flight episode whose
        fragments changed.  Returns the number of stitched writes."""
        jobs = [j for j in
                list(getattr(self.cluster, "vcjobs", {}).values())
                if fedapi.episode_of(j)]
        # newest episodes first; bounded work per pass
        jobs.sort(key=lambda j: -(float(j.annotations.get(
            fedapi.FED_EPISODE_TS_ANNOTATION, 0) or 0)))
        wrote = 0
        for job in jobs[:MAX_EPISODES_PER_PASS]:
            episode = fedapi.episode_of(job)
            try:
                if self._stitch_one(job, episode, handles, now):
                    wrote += 1
            except Exception:  # noqa: BLE001 — advisory telemetry
                log.exception("stitch failed for episode %s", episode)
        return wrote

    def _stitch_one(self, job, episode: str, handles: dict,
                    now: float) -> bool:
        merged: Dict[str, dict] = {}

        def fold(frags):
            for f in frags:
                cur = merged.get(f["key"])
                if cur is None or \
                        f["root"].get("dur", 0.0) >= \
                        cur["root"].get("dur", 0.0):
                    merged[f["key"]] = f

        fold(self._recover(episode))
        fold(self._local.get(episode, {}).values())
        default_hop = fedapi.episode_hop(job)
        for name, h in handles.items():
            fold(self._pull_ring(name, h, episode, default_hop))
            fold(self._lifecycle(name, h, episode))
        try:
            t0 = float(job.annotations.get(
                fedapi.FED_EPISODE_TS_ANNOTATION, 0) or 0) or None
        except (TypeError, ValueError):
            t0 = None
        job_keys = {job.key}
        for f in merged.values():
            job_keys.update(f.get("jobs") or ())
        doc = stitch(episode, list(merged.values()), t0=t0,
                     jobs=job_keys)
        if doc is None:
            return False
        fp = (len(merged), doc["wall_s"])
        if self._published.get(episode) == fp:
            return False
        self.cluster.put_object("fleet_trace", doc, key=episode)
        self._published[episode] = fp
        while len(self._published) > MAX_EPISODES:
            self._published.pop(next(iter(self._published)))
        metrics.inc("federation_stitched_traces_total")
        return True

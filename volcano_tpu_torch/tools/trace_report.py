"""Chrome-trace / Perfetto exporter for the scheduling flight recorder.

Turns captured session traces (volcano_tpu_torch/trace.py span trees) into
the Chrome trace event format — load the output at chrome://tracing or
https://ui.perfetto.dev to scrub through a scheduler cycle visually.

Input sources (first match wins):
  --url URL      fetch GET /traces from a live state server
                 (optionally --token / --job / --limit); with
                 --episode, fetch the stitched cross-plane tree from
                 GET /fleet_trace?episode= instead
  --in FILE      a JSON file holding any of:
                   * a GET /traces payload   ({"traces": [...]})
                   * a GET /fleet_trace payload ({"episode": ...,
                     "trace": {...}}) or a bare stitched doc
                     (kept_because == "stitched")
                   * a SIGUSR2 dumper file   ({"trace": {"recent_traces"
                     : [...]}})
                   * a bare list of trace docs, or a single trace doc

A stitched fleet trace renders as one Perfetto process (pid) PER
PLANE — router / region-* / controllers-* — with one thread per hop
and a flow arrow at every cross-region hop boundary; an incomplete
stitched tree fails loudly instead of rendering a partial (and
misleadingly fast) episode.

Usage:
  python -m volcano_tpu_torch.tools.trace_report --url http://127.0.0.1:8700 \
      --job default/train --out timeline.json
  python -m volcano_tpu_torch.tools.trace_report --url http://127.0.0.1:8700 \
      --episode ep-0123456789abcdef --out fleet.json
  python -m volcano_tpu_torch.tools.trace_report --in /tmp/volcano-tpu-dump.json \
      --out timeline.json
"""
import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, REPO)


def is_stitched(doc) -> bool:
    return isinstance(doc, dict) and \
        doc.get("kept_because") == "stitched"


def load_traces(path: str) -> list:
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    if isinstance(doc, list):
        return doc
    if isinstance(doc, dict):
        if is_stitched(doc):
            return [doc]
        if "traces" in doc:
            return doc["traces"]
        if "trace" in doc and isinstance(doc["trace"], dict):
            # GET /fleet_trace payload wraps ONE stitched doc; the
            # SIGUSR2 dumper wraps a recent_traces list
            if is_stitched(doc["trace"]):
                return [doc["trace"]]
            return doc["trace"].get("recent_traces", [])
        if "root" in doc:
            return [doc]
    raise SystemExit(f"unrecognized trace JSON shape in {path}")


def _get(url: str, token: str, path: str) -> dict:
    import urllib.request
    req = urllib.request.Request(url.rstrip("/") + path)
    if token:
        req.add_header("Authorization", f"Bearer {token}")
    with urllib.request.urlopen(req, timeout=10) as resp:
        return json.loads(resp.read())


def fetch_traces(url: str, token: str, job: str, limit: int) -> list:
    from urllib.parse import quote
    return _get(url, token,
                f"/traces?job={quote(job, safe='')}"
                f"&limit={limit}").get("traces", [])


def fetch_fleet_trace(url: str, token: str, episode: str) -> dict:
    doc = _get(url, token, f"/fleet_trace?episode={episode}")
    trace = doc.get("trace")
    if not is_stitched(trace):
        raise SystemExit(
            f"no stitched trace for episode {episode} (the "
            f"leaseholder router stitches once per pass)")
    return trace


def fleet_chrome_trace(doc: dict) -> dict:
    """Chrome-trace JSON for ONE stitched fleet episode: a Perfetto
    process per plane, a thread per hop, and a flow arrow from the
    end of each hop to the start of the next — the cross-region
    handoff made scrubbable.  Refuses an incomplete tree: a partial
    stitch rendered silently reads as a fast episode."""
    from volcano_tpu_torch import trace as trace_mod
    root = doc.get("root") or {}
    frags = list(root.get("children") or ())
    incomplete = [f.get("name", "?") for f in [root] + frags
                  if not trace_mod.is_complete_span(f)]
    if incomplete:
        raise SystemExit(
            "incomplete stitched tree — refusing to render a partial "
            "episode (missing/zero-span fragments: "
            + ", ".join(incomplete) + ")")
    if not frags:
        raise SystemExit("stitched tree holds no fragments")

    planes = sorted({(f.get("labels") or {}).get("plane", "?")
                     for f in frags})
    pid_of = {plane: i + 1 for i, plane in enumerate(planes)}
    events = []
    for plane, pid in pid_of.items():
        events.append({"name": "process_name", "ph": "M", "pid": pid,
                       "tid": 0, "args": {"name": f"plane {plane}"}})

    def walk(span: dict, pid: int, tid: int) -> None:
        args = {k: v for k, v in (span.get("labels") or {}).items()
                if v}
        events.append({
            "name": span.get("name", "?"),
            "cat": span.get("kind", "span"), "ph": "X",
            "ts": round(span.get("start", 0.0) * 1e6, 1),
            "dur": round(span.get("dur", 0.0) * 1e6, 1),
            "pid": pid, "tid": tid, "args": args,
        })
        for child in span.get("children", ()):
            walk(child, pid, tid)

    by_hop = {}
    named = set()
    for f in frags:
        lbl = f.get("labels") or {}
        plane = lbl.get("plane", "?")
        try:
            hop = int(lbl.get("hop", 0) or 0)
        except (TypeError, ValueError):
            hop = 0
        pid = pid_of[plane]
        walk(f, pid, hop + 1)
        if (pid, hop) not in named:
            named.add((pid, hop))
            events.append({"name": "thread_name", "ph": "M",
                           "pid": pid, "tid": hop + 1,
                           "args": {"name": f"hop {hop}"}})
        by_hop.setdefault(hop, []).append((f, pid))

    def span_end(f: dict) -> float:
        return f.get("start", 0.0) + f.get("dur", 0.0)

    hops = sorted(by_hop)
    for arrow_id, (a, b) in enumerate(zip(hops, hops[1:]), start=1):
        src, spid = max(by_hop[a], key=lambda t: span_end(t[0]))
        dst, dpid = min(by_hop[b],
                        key=lambda t: t[0].get("start", 0.0))
        events.append({"name": f"hop {a}->{b}", "cat": "hop",
                       "ph": "s", "id": arrow_id, "pid": spid,
                       "tid": a + 1,
                       "ts": round(span_end(src) * 1e6, 1)})
        events.append({"name": f"hop {a}->{b}", "cat": "hop",
                       "ph": "f", "bp": "e", "id": arrow_id,
                       "pid": dpid, "tid": b + 1,
                       "ts": round(dst.get("start", 0.0) * 1e6, 1)})
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="export scheduler session traces as a Chrome-trace"
                    " timeline")
    parser.add_argument("--in", dest="infile", default="",
                        help="trace JSON file (GET /traces payload, "
                             "dumper output, or trace doc list)")
    parser.add_argument("--url", default="",
                        help="live state-server URL to fetch from")
    parser.add_argument("--token", default="")
    parser.add_argument("--job", default="",
                        help="filter to traces touching this job key")
    parser.add_argument("--episode", default="",
                        help="with --url: fetch this episode's "
                             "stitched fleet trace (/fleet_trace)")
    parser.add_argument("--limit", type=int, default=32)
    parser.add_argument("--out", default="timeline.json")
    args = parser.parse_args(argv)

    from volcano_tpu_torch import trace as trace_mod
    if args.url and args.episode:
        traces = [fetch_fleet_trace(args.url, args.token,
                                    args.episode)]
    elif args.url:
        traces = fetch_traces(args.url, args.token, args.job,
                              args.limit)
    elif args.infile:
        traces = load_traces(args.infile)
        if args.job:
            traces = [t for t in traces
                      if trace_mod.matches_job(t, args.job)]
        traces = traces[-args.limit:]
    else:
        parser.error("need --url or --in")
    if not traces:
        print("no traces matched", file=sys.stderr)
        return 1
    if len(traces) == 1 and is_stitched(traces[0]):
        doc = fleet_chrome_trace(traces[0])
        kind = f"stitched fleet trace ({traces[0].get('episode')})"
    else:
        doc = trace_mod.to_chrome_trace(traces)
        kind = f"{len(traces)} session trace(s)"
    with open(args.out, "w", encoding="utf-8") as f:
        json.dump(doc, f)
    print(f"{kind}, {len(doc['traceEvents'])} events -> {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

#!/usr/bin/env python
"""race_bench — measure + certify the parallel predicate sweep pilot.

A 1k-host scenario (HGX H100 hosts) where the per-spec ``build_entry``
sweep runs (a) through the legacy serial dispatch path and (b) through
the batched leaf-shard fan-out (actions/sweep.py) at several worker
counts, under the ARMED freeze auditor (analysis/freezeaudit.py).

Two phases, mirroring how Go separates ``go test -bench`` from
``go test -race`` (the sanitizer taxes every access; nobody quotes
benchmark numbers taken under it):

  measure    auditor DISARMED.  The serial row is the shipped
             fallback path (tiered Session dispatch per node with
             per-plugin trace timing); the parallel rows run the
             same plugins' prepared (PreFilter/PreScore) forms over
             leaf-group shards on a thread pool.  Under CPython's
             GIL the speedup comes from the batched form the fan-out
             architecture demands (task-side hoisting, no per-node
             dispatch), NOT from hardware parallelism —
             ``host_cpus`` is recorded so a multi-core replay can
             separate the two effects.
  certify    auditor ARMED (freeze barriers + fan-out regions).  The
             same sweeps re-run at every worker count plus full
             scheduler cycles; zero race/freeze violations required,
             and every parallel entry is asserted BIT-IDENTICAL to
             the serial entry (fits, scores, heap metadata), or this
             tool exits 1.

Usage:
    python -m volcano_tpu_torch.tools.race_bench [--hosts 1024] [--out FILE]
    # FILE defaults to race_bench.json in the temp dir
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

WORKER_STEPS = (1, 2, 4, 8)


def build_scenario(hosts: int):
    from volcano_tpu_torch.scheduler import Scheduler
    from volcano_tpu_torch.simulator import make_gpu_cluster
    from volcano_tpu_torch.uthelper import gang_job
    # one HGX H100 host (8 GPUs) an NVLink domain, all in one IB
    # fabric; a pod takes a host's GPUs whole
    cluster = make_gpu_cluster(
        [(f"s{i:04d}", "hgx-h100-8") for i in range(max(1, hosts))])
    pg, pods = gang_job("bench", replicas=64,
                        requests={"cpu": 4, "nvidia.com/gpu": 8})
    cluster.add_podgroup(pg)
    for p in pods:
        cluster.add_pod(p)
    return Scheduler(cluster, schedule_period=0)


def bench_entry(ssn, nodes, task, workers: int, reps: int = 9,
                backend: str = "thread"):
    """Best-of-reps build_entry wall time at the given worker count
    (0 = the serial fallback path; backend selects the thread pool or
    the mirror-worker process pool for workers > 0)."""
    from volcano_tpu_torch.actions.sweep import SpecCache
    conf = ssn.conf.configurations.setdefault("allocate", {})
    conf["parallelPredicates"] = backend if workers else False
    conf["parallelPredicates.workers"] = workers or 1
    best, entry = float("inf"), None
    for _ in range(reps):
        cache = SpecCache(ssn, nodes, record_errors=False)
        t0 = time.perf_counter()
        entry = cache.build_entry(task)
        best = min(best, time.perf_counter() - t0)
    return best, entry


def entries_identical(a, b) -> bool:
    return (a["fits"].keys() == b["fits"].keys()
            and a["scores"] == b["scores"]
            and a["meta"] == b["meta"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="race_bench",
                                 description=__doc__)
    ap.add_argument("--hosts", type=int, default=1024)
    ap.add_argument("--reps", type=int, default=9)
    ap.add_argument("--backends", default="thread",
                    help="comma list of pool backends to row "
                         "(thread, process)")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    backends = [b.strip() for b in args.backends.split(",")
                if b.strip()]

    from volcano_tpu_torch.analysis import freezeaudit, racecheck
    from volcano_tpu_torch.api.types import TaskStatus
    from volcano_tpu_torch.framework.framework import (close_session,
                                                 open_session)

    # -- phase 1: measure (auditor disarmed) --------------------------
    sched = build_scenario(args.hosts)
    ssn = open_session(sched.cache, sched.conf)
    task = next(t for j in ssn.jobs.values()
                for t in j.tasks_in_status(TaskStatus.PENDING))
    nodes = list(ssn.nodes.values())
    print(f"scenario: {len(nodes)} hosts, spec {task.task_spec!r}",
          flush=True)

    serial_s, serial_entry = bench_entry(ssn, nodes, task, 0,
                                         args.reps)
    rows = []
    for backend in backends:
        for w in WORKER_STEPS:
            t, entry = bench_entry(ssn, nodes, task, w, args.reps,
                                   backend=backend)
            identical = entries_identical(entry, serial_entry)
            rows.append({"backend": backend, "workers": w,
                         "ms": round(t * 1000, 2),
                         "speedup_vs_serial": round(serial_s / t, 2),
                         "entry_identical_to_serial": identical})
            print(f"  {backend} w={w}: {t*1000:.2f} ms "
                  f"({serial_s/t:.2f}x, identical={identical})",
                  flush=True)
    close_session(ssn)

    # -- phase 2: certify (auditor armed) -----------------------------
    freezeaudit.install()
    freezeaudit.reset()
    ssn = open_session(sched.cache, sched.conf)
    ctask = next(t for j in ssn.jobs.values()
                 for t in j.tasks_in_status(TaskStatus.PENDING))
    cnodes = list(ssn.nodes.values())
    _, armed_serial = bench_entry(ssn, cnodes, ctask, 0, reps=1)
    armed_identical = True
    for backend in backends:
        for w in WORKER_STEPS:
            _, entry = bench_entry(ssn, cnodes, ctask, w, reps=2,
                                   backend=backend)
            armed_identical &= entries_identical(entry, armed_serial)
    close_session(ssn)
    # ...and three full scheduler cycles with the parallel sweep on,
    # so the freeze window sees real Statement commits
    conf = sched.conf.configurations.setdefault("allocate", {})
    conf["parallelPredicates"] = True
    conf["parallelPredicates.workers"] = 8
    for _ in range(3):
        sched.run_once()
        sched.cluster.tick()
    audit = freezeaudit.report()
    freezeaudit.uninstall()
    print(f"certify: sessions={audit['sessions_frozen']} "
          f"fanouts={audit['fanout_regions']} "
          f"violations={len(audit['violations'])} "
          f"identical={armed_identical}", flush=True)

    # the static half: reader census + the reasoned waiver inventory
    static = racecheck.build_program(["volcano_tpu_torch"])
    findings = static.analyze()
    active = [f for f in findings if f.suppressed is None]
    waivers = [{"rule": f.rule, "site": f"{f.path}:{f.line}",
                "reason": f.suppressed}
               for f in findings if f.suppressed is not None]

    doc = {
        "metric": "race_certified_parallel_predicate_sweep",
        "scenario": {
            "hosts": len(nodes), "gang_replicas": 64,
            "spec": task.task_spec,
            "plugins": sorted(ssn.plugins),
        },
        "host_cpus": os.cpu_count(),
        "serial_build_entry_ms": round(serial_s * 1000, 2),
        "parallel": rows,
        "speedup_at_8_workers": next(
            r["speedup_vs_serial"] for r in rows
            if r["workers"] == 8 and r["backend"] == backends[0]),
        "note": ("single-CPU host: the measured speedup is the "
                 "batched prepared-sweep form the fan-out "
                 "architecture enables (task-side hoisting, no "
                 "per-node dispatch), serialized by the GIL; rerun "
                 "on a multi-core host to add hardware parallelism "
                 "on top"),
        "freeze_audit": {
            "sessions_frozen": audit["sessions_frozen"],
            "objects_frozen": audit["objects_frozen"],
            "fanout_regions": audit["fanout_regions"],
            # the TSan-lite half's coverage: the owner-confined
            # stores recorded accesses, so "zero unsync-pairs" below
            # is a certified claim, not a vacuous one
            "tracked_stores": audit["tracked_stores"],
            "entries_identical_under_audit": armed_identical,
            "violations": audit["violations"],
        },
        "static_pass": {
            "snapshot_readers": len(static.readers()),
            "active_findings": len(active),
            "waivers": waivers,
        },
        "ok": (not audit["violations"] and not active
               and armed_identical
               and all(r["entry_identical_to_serial"] for r in rows)),
    }
    if "process" in backends:
        from volcano_tpu_torch.actions import procpool
        procpool.shutdown()
    out = args.out or os.path.join(tempfile.gettempdir(),
                                   "race_bench.json")
    with open(out, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=1, default=str)
    print(f"wrote {out}: ok={doc['ok']} "
          f"speedup@8={doc['speedup_at_8_workers']}x", flush=True)
    return 0 if doc["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())

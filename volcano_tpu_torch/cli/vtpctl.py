"""vtpctl — the framework CLI.

Reference parity: cmd/cli/vcctl.go:36-41 (job run/list/view/suspend/
resume/delete; queue create/list/get/delete; pod list) plus the
slurm-style shortcuts (vsub/vjobs/vqueues/vcancel analogues exposed as
subcommands).  Standalone mode drives a pickled FakeCluster state file
(--state), so the full control plane is scriptable without a cluster:

    python -m volcano_tpu_torch.cli.vtpctl --state c.pkl init --slices nvl-a=hgx-h100-8
    python -m volcano_tpu_torch.cli.vtpctl --state c.pkl job run -N train \
        --replicas 4 --gpu 8 --plugins torch,svc
    python -m volcano_tpu_torch.cli.vtpctl --state c.pkl tick
    python -m volcano_tpu_torch.cli.vtpctl --state c.pkl job list
"""

from __future__ import annotations

import argparse
import json
import pickle
import sys
from typing import List, Optional

from volcano_tpu_torch.api.pod import Container, Pod
from volcano_tpu_torch.api.queue import Queue
from volcano_tpu_torch.api.resource import GPU
from volcano_tpu_torch.api.types import GROUP_NAME_ANNOTATION
from volcano_tpu_torch.api.vcjob import TaskSpec, VCJob
from volcano_tpu_torch.framework.job_updater import SCHEDULING_REASON_ANNOTATION


def _load(path: str):
    try:
        # either format: legacy pickle or the snapshot JSON the
        # server's graceful save writes now
        from volcano_tpu_torch.server.durability import load_cluster_file
        cluster = load_cluster_file(path)
    except FileNotFoundError:
        from volcano_tpu_torch.cache.fake_cluster import FakeCluster
        cluster = FakeCluster()
    if cluster.admission is None:
        from volcano_tpu_torch.webhooks import default_admission
        cluster.admission = default_admission()
    return cluster


def _save(cluster, path: str):
    with open(path, "wb") as f:
        pickle.dump(cluster, f)


def _table(rows: List[List[str]], headers: List[str]) -> str:
    rows = [headers] + [[str(c) for c in r] for r in rows]
    widths = [max(len(r[i]) for r in rows) for i in range(len(headers))]
    return "\n".join(
        "  ".join(c.ljust(w) for c, w in zip(r, widths)) for r in rows)


# -- subcommand handlers ----------------------------------------------

def cmd_init(cluster, args):
    from volcano_tpu_torch.simulator import domain_nodes
    from volcano_tpu_torch.api.devices.gpu.topology import domain_for
    for spec in args.slices or []:
        name, kind = spec.split("=", 1)
        for node in domain_nodes(domain_for(name, kind),
                                 ib_fabric=args.ib_fabric):
            cluster.add_node(node)
    from volcano_tpu_torch.controllers.hypernode import HyperNodeController
    ctrl = HyperNodeController()
    ctrl.initialize(cluster)
    ctrl.sync()
    print(f"cluster: {len(cluster.nodes)} nodes, "
          f"{len(cluster.hypernodes)} hypernodes")


def cmd_job_run(cluster, args):
    requests = {"cpu": args.cpu}
    if args.gpu:
        requests[GPU] = args.gpu
    job = VCJob(
        name=args.name,
        namespace=args.namespace,
        min_available=args.min_available or args.replicas,
        queue=args.queue,
        tasks=[TaskSpec(name=args.task_name, replicas=args.replicas,
                        template=Pod(name="t", containers=[
                            Container(image=args.image,
                                      requests=requests)]))],
        plugins={p: [] for p in (args.plugins.split(",")
                                 if args.plugins else [])},
    )
    job = cluster.add_vcjob(job)
    print(f"job {job.key} submitted (queue={job.queue}, "
          f"minAvailable={job.min_available})")


def cmd_job_create(cluster, args):
    from volcano_tpu_torch.cli.manifest import ManifestError, load_jobs
    try:
        jobs = load_jobs(args.filename)
    except (ManifestError, OSError) as e:
        sys.exit(f"error: {e}")
    for job in jobs:
        job = cluster.add_vcjob(job)
        print(f"job {job.key} created (queue={job.queue}, "
              f"minAvailable={job.min_available}, "
              f"tasks={[t.name for t in job.tasks]})")


def cmd_job_list(cluster, args):
    rows = []
    for job in cluster.vcjobs.values():
        if args.namespace and job.namespace != args.namespace:
            continue
        rows.append([job.namespace, job.name, job.phase.value,
                     f"{job.running}/{job.total_replicas()}",
                     job.queue, f"{job.retry_count}"])
    print(_table(rows, ["NAMESPACE", "NAME", "PHASE", "RUNNING",
                        "QUEUE", "RETRIES"]))


def cmd_job_view(cluster, args):
    job = cluster.vcjobs.get(f"{args.namespace}/{args.name}")
    if job is None:
        sys.exit(f"job {args.namespace}/{args.name} not found")
    out = {
        "name": job.name, "namespace": job.namespace,
        "phase": job.phase.value, "queue": job.queue,
        "minAvailable": job.min_available,
        "status": {"pending": job.pending, "running": job.running,
                   "succeeded": job.succeeded, "failed": job.failed},
        "tasks": [{"name": t.name, "replicas": t.replicas}
                  for t in job.tasks],
        "message": job.state_message,
        "pods": [{"name": p.name, "phase": p.phase.value,
                  "node": p.node_name,
                  # per-pod scheduling reason (scheduling-reason.md):
                  # which task blocks the gang, and why
                  **({"schedulingReason":
                          p.annotations[SCHEDULING_REASON_ANNOTATION],
                      "message": p.status_message}
                     if SCHEDULING_REASON_ANNOTATION in p.annotations
                     and not p.node_name else {})}
                 for p in cluster.pods.values() if p.owner == job.uid],
    }
    print(json.dumps(out, indent=2))


def cmd_job_delete(cluster, args):
    key = f"{args.namespace}/{args.name}"
    if key not in cluster.vcjobs:
        sys.exit(f"job {key} not found")
    cluster.delete_vcjob(key)
    print(f"job {key} deleted")


def cmd_job_command(cluster, args, action):
    key = f"{args.namespace}/{args.name}"
    if key not in cluster.vcjobs:
        sys.exit(f"job {key} not found")
    cluster.add_command(key, action)
    print(f"job {key}: {action} requested")


def cmd_jobtemplate_create(cluster, args):
    from volcano_tpu_torch.api.jobflow import JobTemplate
    from volcano_tpu_torch.cli.manifest import ManifestError, load_jobs
    try:
        jobs = load_jobs(args.filename)
    except (ManifestError, OSError) as e:
        sys.exit(f"error: {e}")
    for job in jobs:
        tmpl = JobTemplate(name=job.name, namespace=job.namespace,
                           job=job)
        cluster.put_object("jobtemplate", tmpl)
        print(f"jobtemplate {tmpl.key} created")


def cmd_jobtemplate_list(cluster, args):
    rows = [[t.namespace, t.name,
             ",".join(ts.name for ts in (t.job.tasks if t.job else []))]
            for t in getattr(cluster, "jobtemplates", {}).values()]
    print(_table(rows, ["NAMESPACE", "NAME", "TASKS"]))


def cmd_jobflow_create(cluster, args):
    from volcano_tpu_torch.api.jobflow import Flow, FlowDependsOn, JobFlow
    flows = []
    for spec in args.flows:
        # "name" or "name:dep1+dep2"
        if ":" in spec:
            name, deps = spec.split(":", 1)
            flows.append(Flow(name=name, depends_on=FlowDependsOn(
                targets=deps.split("+"))))
        else:
            flows.append(Flow(name=spec))
    flow = JobFlow(name=args.name, namespace=args.namespace, flows=flows,
                   job_retain_policy=args.retain_policy)
    cluster.put_object("jobflow", flow)
    print(f"jobflow {flow.key} created ({len(flows)} steps)")


def cmd_jobflow_list(cluster, args):
    rows = []
    for flow in getattr(cluster, "jobflows", {}).values():
        rows.append([flow.namespace, flow.name, flow.phase.value,
                     f"{len(flow.deployed_jobs)}/{len(flow.flows)}"])
    print(_table(rows, ["NAMESPACE", "NAME", "PHASE", "DEPLOYED"]))


def _find_flow(cluster, args):
    flow = getattr(cluster, "jobflows", {}).get(
        f"{args.namespace}/{args.name}")
    if flow is None:
        sys.exit(f"jobflow {args.namespace}/{args.name} not found")
    return flow


def cmd_jobflow_get(cluster, args):
    flow = _find_flow(cluster, args)
    print(_table([[flow.namespace, flow.name, flow.phase.value,
                   f"{len(flow.deployed_jobs)}/{len(flow.flows)}"]],
                 ["NAMESPACE", "NAME", "PHASE", "DEPLOYED"]))


def cmd_jobflow_describe(cluster, args):
    """Full flow detail (reference cli/jobflow/describe.go YAML dump)."""
    flow = _find_flow(cluster, args)
    print(f"name: {flow.name}")
    print(f"namespace: {flow.namespace}")
    print(f"phase: {flow.phase.value}")
    print("flows:")
    for f in flow.flows:
        deps = "+".join(f.depends_on.targets) if f.depends_on and \
            f.depends_on.targets else "-"
        # deployed_jobs holds job keys "<ns>/<flow>-<step>"
        job_key = f"{flow.namespace}/{flow.job_name(f.name)}"
        state = "deployed" if job_key in flow.deployed_jobs \
            else "pending"
        print(f"  - name: {f.name}\n    dependsOn: {deps}\n"
              f"    state: {state}")


def cmd_jobflow_delete(cluster, args):
    from volcano_tpu_torch.cache.fake_cluster import FakeCluster
    from volcano_tpu_torch.controllers.jobflow import reap_deleted_flow
    flow = _find_flow(cluster, args)
    cluster.delete_object("jobflow", flow.key)
    if isinstance(cluster, FakeCluster):
        # no controller process is watching a pickled cluster; apply
        # the retain policy inline, including the job controller's
        # full delete path (wire mode leaves both to the watching
        # controller processes)
        reap_deleted_flow(cluster, flow, run_job_cleanup=True)
    print(f"jobflow {flow.key} deleted")


def _find_tmpl(cluster, args):
    tmpl = getattr(cluster, "jobtemplates", {}).get(
        f"{args.namespace}/{args.name}")
    if tmpl is None:
        sys.exit(f"jobtemplate {args.namespace}/{args.name} not found")
    return tmpl


def cmd_jobtemplate_get(cluster, args):
    tmpl = _find_tmpl(cluster, args)
    tasks = tmpl.job.tasks if tmpl.job else []
    print(_table([[tmpl.namespace, tmpl.name,
                   ",".join(t.name for t in tasks)]],
                 ["NAMESPACE", "NAME", "TASKS"]))


def cmd_jobtemplate_describe(cluster, args):
    tmpl = _find_tmpl(cluster, args)
    print(f"name: {tmpl.name}\nnamespace: {tmpl.namespace}")
    if tmpl.job:
        print(f"minAvailable: {tmpl.job.min_available}")
        print("tasks:")
        for t in tmpl.job.tasks:
            print(f"  - name: {t.name}\n    replicas: {t.replicas}")


def cmd_jobtemplate_delete(cluster, args):
    tmpl = _find_tmpl(cluster, args)
    cluster.delete_object("jobtemplate", tmpl.key)
    print(f"jobtemplate {tmpl.key} deleted")


def cmd_queue_create(cluster, args):
    from volcano_tpu_torch.api.resource import Resource
    queue = Queue(name=args.name, weight=args.weight, parent=args.parent)
    if args.capability:
        queue.capability = Resource.from_resource_list(
            json.loads(args.capability))
    admission = getattr(cluster, "admission", None)
    if admission is not None:
        queue = admission.admit_queue(queue, cluster)
        cluster.add_queue(queue)
    else:
        # wire mode: the server runs the admission chain on create
        cluster.put_object("queue", queue)
    print(f"queue {queue.name} created (weight={queue.weight})")


def cmd_queue_operate(cluster, args):
    from volcano_tpu_torch.controllers.queue import QueueController
    if args.name not in cluster.queues:
        sys.exit(f"queue {args.name} not found")
    ctrl = QueueController()
    ctrl.initialize(cluster)
    if args.action == "close":
        ctrl.close_queue(args.name)   # drained queue flips Closed now
        print(f"queue {args.name}: "
              f"{cluster.queues[args.name].state.value}")
    elif args.action == "open":
        ctrl.open_queue(args.name)
        print(f"queue {args.name} opened")


def cmd_queue_list(cluster, args):
    rows = [[q.name, q.weight, q.state.value, q.parent or "-"]
            for q in cluster.queues.values()]
    print(_table(rows, ["NAME", "WEIGHT", "STATE", "PARENT"]))


def cmd_queue_get(cluster, args):
    """Detailed queue view (reference cli/queue/get.go)."""
    q = cluster.queues.get(args.name)
    if q is None:
        sys.exit(f"queue {args.name} not found")
    pgs = [pg for pg in cluster.podgroups.values()
           if pg.queue == q.name]
    by_phase = {}
    for pg in pgs:
        by_phase[pg.phase.value] = by_phase.get(pg.phase.value, 0) + 1
    print(f"name: {q.name}")
    print(f"weight: {q.weight}")
    print(f"state: {q.state.value}")
    print(f"parent: {q.parent or '-'}")
    print(f"reclaimable: {q.reclaimable}")
    if q.capability is not None:
        print(f"capability: {q.capability}")
    if q.guarantee is not None and not q.guarantee.is_empty():
        print(f"guarantee: {q.guarantee}")
    if pgs:
        detail = ", ".join(f"{k}={v}"
                           for k, v in sorted(by_phase.items()))
        print(f"podGroups: {len(pgs)} ({detail})")
    else:
        print("podGroups: 0")


def cmd_queue_delete(cluster, args):
    """Delete a queue; refuses while podgroups still reference it
    (reference cli/queue/delete.go requires the queue drained)."""
    if args.name not in cluster.queues:
        sys.exit(f"queue {args.name} not found")
    holders = {pg.key for pg in cluster.podgroups.values()
               if pg.queue == args.name}
    holders |= {j.key for j in getattr(cluster, "vcjobs", {}).values()
                if j.queue == args.name}
    if holders and not args.force:
        sample = sorted(holders)[0]
        sys.exit(f"queue {args.name} still has {len(holders)} "
                 f"podgroup(s)/job(s) (e.g. {sample}); drain it "
                 f"or pass --force")
    cluster.delete_object("queue", args.name)
    print(f"queue {args.name} deleted")


def cmd_pod_list(cluster, args):
    rows = []
    for pod in cluster.pods.values():
        if args.namespace and pod.namespace != args.namespace:
            continue
        reason = "-"
        if not pod.node_name:
            reason = pod.annotations.get(SCHEDULING_REASON_ANNOTATION,
                                         "-")
        rows.append([pod.namespace, pod.name, pod.phase.value,
                     pod.node_name or "-", reason])
    print(_table(rows, ["NAMESPACE", "NAME", "PHASE", "NODE",
                        "REASON"]))


def cmd_pod_describe(cluster, args):
    """kubectl-describe analogue: pod state + scheduling reason +
    the server-side audit history of this pod (bind/evict/phase
    transitions as the apiserver saw them)."""
    key = f"{args.namespace}/{args.name}"
    pod = cluster.pods.get(key)
    if pod is None:
        sys.exit(f"pod {key} not found")
    out = {
        "name": pod.name, "namespace": pod.namespace,
        "uid": pod.uid, "phase": pod.phase.value,
        "node": pod.node_name or None,
        "owner": pod.owner or None, "task": pod.task_spec or None,
        "requests": dict(pod.resource_requests().res),
        "annotations": dict(pod.annotations),
    }
    if pod.status_message:
        out["message"] = pod.status_message
    reason = pod.annotations.get(SCHEDULING_REASON_ANNOTATION)
    if reason:
        out["schedulingReason"] = reason
    history = _pod_audit_history(cluster, key)
    if history is not None:
        out["events"] = history
    print(json.dumps(out, indent=2))


def _pod_audit_history(cluster, key):
    """This pod's slice of the server audit trail (wire mode only:
    the standalone state file keeps no trail).  Goes through the
    cluster client's _request so TLS context / bearer auth apply;
    records are filtered SERVER-side via the key param."""
    request = getattr(cluster, "_request", None)
    if request is None:
        return None
    from urllib.parse import quote
    try:
        records, since, truncated = [], 0, False
        while True:
            payload = request(
                "GET", f"/audit?since={since}&key={quote(key)}")
            truncated = truncated or bool(payload.get("lost"))
            batch = payload.get("records", [])
            records.extend(batch)
            if payload["idx"] <= since:
                break
            since = payload["idx"]
        import datetime
        out = [{"ts": datetime.datetime.fromtimestamp(
                    rec["ts"]).isoformat(timespec="seconds"),
                "kind": rec["kind"],
                **({"node": rec["node"]} if rec.get("node") else {}),
                **({"phase": rec["phase"]} if rec.get("phase") else {})}
               for rec in records]
        if truncated:
            # ring eviction dropped early records: never present the
            # surviving tail as the pod's complete history
            return {"historyTruncated": True, "records": out}
        return out
    except Exception:  # noqa: BLE001 — audit is best-effort extra
        return None


def cmd_node_list(cluster, args):
    from volcano_tpu_torch.agent.agent import (
        CPU_USAGE_ANNOTATION,
        GPU_HEALTHY_LABEL,
    )
    from volcano_tpu_torch.api.resource import Resource
    from volcano_tpu_torch.api.types import occupied
    rows = []
    for node in cluster.nodes.values():
        alloc = Resource.from_resource_list(node.allocatable)
        used = Resource()
        npods = 0
        for pod in cluster.pods.values():
            # occupied() includes RELEASING: evicted-but-not-yet-gone
            # pods still hold capacity from the scheduler's view
            if pod.node_name == node.name and occupied(pod.phase):
                used.add(pod.resource_requests())
                npods += 1
        rows.append([
            node.name,
            "cordoned" if node.unschedulable else "ready",
            f"{used.milli_cpu / 1000:g}/{alloc.milli_cpu / 1000:g}",
            f"{used.get(GPU):g}/{alloc.get(GPU):g}",
            npods,
            node.annotations.get(CPU_USAGE_ANNOTATION, "-"),
            node.labels.get(GPU_HEALTHY_LABEL, "-"),
        ])
    print(_table(rows, ["NAME", "STATUS", "CPU", "GPUS", "PODS",
                        "USAGE", "GPU-OK"]))


def cmd_node_view(cluster, args):
    node = cluster.nodes.get(args.name)
    if node is None:
        sys.exit(f"node {args.name} not found")
    print(f"Name:          {node.name}")
    print(f"Unschedulable: {node.unschedulable}")
    print(f"Allocatable:   {dict(node.allocatable)}")
    if node.labels:
        print("Labels:")
        for k in sorted(node.labels):
            print(f"  {k}={node.labels[k]}")
    if node.annotations:
        print("Annotations:")
        for k in sorted(node.annotations):
            print(f"  {k}={node.annotations[k]}")
    topo = getattr(cluster, "numatopologies", {}).get(node.name)
    if topo is not None:
        print("NUMA topology:")
        for res, per_cell in sorted(topo.numa_res.items()):
            cells = ", ".join(f"cell{c}={per_cell[c]:g}"
                              for c in sorted(per_cell))
            print(f"  {res}: {cells} (free)")
        for k, v in sorted(topo.policies.items()):
            print(f"  {k}={v}")
    pods = [p for p in cluster.pods.values()
            if p.node_name == node.name]
    if pods:
        print("Pods:")
        for p in sorted(pods, key=lambda p: p.key):
            print(f"  {p.key} ({p.phase.value})")


def cmd_slices(cluster, args):
    """Per-NVLink-domain rollup: hosts, cordons, worst health verdict (from
    the folded SliceHealthReport annotations / the report store) and
    the failover controller's quarantine TTL."""
    import datetime

    from volcano_tpu_torch.api.slicehealth import (
        NODE_HEALTH_ANNOTATION, NODE_QUARANTINED_UNTIL_ANNOTATION,
        VERDICT_FAILED, VERDICT_HEALTHY, VERDICT_SUSPECT)
    from volcano_tpu_torch.api.types import (GPU_CLIQUE_LABEL,
                                             GPU_DOMAIN_SHAPE_LABEL)
    rank = {VERDICT_HEALTHY: 0, VERDICT_SUSPECT: 1, VERDICT_FAILED: 2}
    reports = getattr(cluster, "slicehealthreports", {})
    slices = {}
    for node in cluster.nodes.values():
        name = node.labels.get(GPU_CLIQUE_LABEL)
        if name:
            slices.setdefault(name, []).append(node)
    rows = []
    for name in sorted(slices):
        nodes = slices[name]
        health = VERDICT_HEALTHY
        until = 0.0
        for n in nodes:
            rep = reports.get(n.name)
            verdict = rep.verdict if rep is not None else \
                n.annotations.get(NODE_HEALTH_ANNOTATION,
                                  VERDICT_HEALTHY)
            if rank.get(verdict, 0) > rank.get(health, 0):
                health = verdict
            try:
                until = max(until, float(n.annotations.get(
                    NODE_QUARANTINED_UNTIL_ANNOTATION, 0) or 0))
            except (TypeError, ValueError):
                pass
        rows.append([
            name,
            nodes[0].labels.get(GPU_DOMAIN_SHAPE_LABEL, "-"),
            len(nodes),
            sum(1 for n in nodes if n.unschedulable),
            health,
            datetime.datetime.fromtimestamp(until).isoformat(
                timespec="seconds") if until else "-",
        ])
    print(_table(rows, ["NAME", "TOPOLOGY", "HOSTS", "CORDONED",
                        "HEALTH", "QUARANTINED-UNTIL"]))


def cmd_failover(cluster, args):
    """Failover view: unhealthy/quarantined slices, drained gangs
    awaiting re-placement, and the resume metadata stamped on
    podgroups (generation, resume step, checkpoint dir)."""
    from volcano_tpu_torch.api.slicehealth import (
        CHECKPOINT_DIR_ANNOTATION, FAILOVER_GENERATION_ANNOTATION,
        REQUEUED_ANNOTATION, RESUME_STEP_ANNOTATION, VERDICT_HEALTHY)
    reports = getattr(cluster, "slicehealthreports", {})
    sick = [[r.node, r.slice or "-", r.verdict,
             f"{r.chips_healthy}/{r.chips_detected}",
             r.consecutive_bad]
            for r in sorted(reports.values(), key=lambda r: r.node)
            if r.verdict != VERDICT_HEALTHY]
    print(_table(sick, ["NODE", "SLICE", "VERDICT", "GPUS",
                        "BAD-SYNCS"]))
    rows = []
    for pg in cluster.podgroups.values():
        ann = pg.annotations
        if FAILOVER_GENERATION_ANNOTATION not in ann and \
                REQUEUED_ANNOTATION not in ann:
            continue
        rows.append([
            pg.key,
            ann.get(FAILOVER_GENERATION_ANNOTATION, "0"),
            "yes" if ann.get(REQUEUED_ANNOTATION) == "true" else "-",
            ann.get(RESUME_STEP_ANNOTATION, "-"),
            ann.get(CHECKPOINT_DIR_ANNOTATION, "-"),
            pg.phase.value,
        ])
    if rows:
        print()
        print(_table(rows, ["PODGROUP", "GENERATION", "REQUEUED",
                            "RESUME-STEP", "CHECKPOINT-DIR", "PHASE"]))
    events = [e for e in getattr(cluster, "events", [])
              if e[1] in ("SliceFailed", "SliceRecovered",
                          "FailoverDrain", "FailoverComplete",
                          "GPUUnhealthy", "GPURecovered")]
    if events:
        print()
        print(_table([[k, r, m] for k, r, m in events[-20:]],
                     ["OBJECT", "REASON", "MESSAGE"]))


def cmd_elastic(cluster, args):
    """Elastic-gang view: per job current/min/max NVLink domains, generation,
    any in-flight decision, and the resize history the controller
    appends; --migrate stamps a policy-initiated live migration (the
    Singularity move: drain -> re-place on OTHER domains -> resume)."""
    import datetime

    from volcano_tpu_torch.api import elastic as eapi
    from volcano_tpu_torch.api.types import GPU_CLIQUE_LABEL

    if args.migrate:
        ns, _, name = args.migrate.rpartition("/")
        ns = ns or "default"
        key = f"{ns}/{name}"
        pg = cluster.podgroups.get(key)
        if pg is None or not eapi.is_elastic(pg):
            sys.exit(f"{key} is not an elastic podgroup")
        current = sorted({
            cluster.nodes[p.node_name].labels.get(GPU_CLIQUE_LABEL, "")
            for p in _job_pods(cluster, ns, name)
            if p.node_name and p.node_name in cluster.nodes})
        current = [s for s in current if s]
        pg.annotations[eapi.ELASTIC_DESIRED_SLICES_ANNOTATION] = \
            str(eapi.current_slices(pg))
        pg.annotations[eapi.ELASTIC_RESIZE_REASON_ANNOTATION] = \
            eapi.RESIZE_MIGRATE
        if current:
            pg.annotations[eapi.ELASTIC_AVOID_SLICES_ANNOTATION] = \
                ",".join(current)
        cluster.update_podgroup_status(pg)
        print(f"migration requested: {key} off "
              f"{','.join(current) or '(unplaced)'}")
        return

    rows, history_rows = [], []
    for pg in sorted(cluster.podgroups.values(), key=lambda g: g.key):
        if not eapi.is_elastic(pg):
            continue
        rng = eapi.elastic_range(pg) or ("?", "?")
        desired = eapi.desired_slices(pg)
        reason = pg.annotations.get(
            eapi.ELASTIC_RESIZE_REASON_ANNOTATION, "")
        resizing = f"->{desired} ({reason})" if desired is not None \
            else "-"
        try:
            last = float(pg.annotations.get(
                eapi.ELASTIC_LAST_RESIZE_TS_ANNOTATION, 0) or 0)
        except (TypeError, ValueError):
            last = 0.0
        rows.append([
            pg.key, eapi.current_slices(pg), rng[0], rng[1],
            pg.annotations.get(eapi.ELASTIC_GENERATION_ANNOTATION,
                               "0"),
            resizing,
            datetime.datetime.fromtimestamp(last).isoformat(
                timespec="seconds") if last else "-",
            pg.phase.value,
        ])
        for rec in eapi.resize_history(pg):
            history_rows.append([
                pg.key, rec.get("gen", "?"), rec.get("kind", "?"),
                f"{rec.get('from', '?')} -> {rec.get('to', '?')}",
                datetime.datetime.fromtimestamp(
                    rec.get("ts", 0)).isoformat(timespec="seconds")
                if rec.get("ts") else "-",
            ])
    print(_table(rows, ["PODGROUP", "SLICES", "MIN", "MAX", "GEN",
                        "RESIZING", "LAST-RESIZE", "PHASE"]))
    if history_rows:
        print()
        print(_table(history_rows,
                     ["PODGROUP", "GEN", "KIND", "SLICES", "AT"]))


def cmd_goodput(cluster, args):
    """One job's measured throughput: the store-folded podgroup
    summary (step, steps/s, goodput = productive/allocated
    pod-seconds) plus the per-pod progress the node agents last
    reported (GoodputReport store) and the elastic resize history —
    the operator's answer to "is this gang actually training, and how
    fast"."""
    import datetime

    from volcano_tpu_torch.api import elastic as eapi
    from volcano_tpu_torch.api import goodput as gapi
    key = f"{args.namespace}/{args.name}"
    pg = cluster.podgroups.get(key)
    if pg is None:
        sys.exit(f"podgroup {key} not found")
    ann = pg.annotations
    print(f"job: {key}")
    print(f"phase: {pg.phase.value}  (queue={pg.queue})")
    if gapi.PG_STEP_RATE_ANNOTATION not in ann:
        print("no goodput data published (no worker progress "
              "reported yet — does the job declare "
              f"{gapi.PROGRESS_DIR_ANNOTATION}?)")
        return
    alloc = gapi.ann_float(ann, gapi.PG_ALLOCATED_S_ANNOTATION)
    prod = gapi.ann_float(ann, gapi.PG_PRODUCTIVE_S_ANNOTATION)
    updated = gapi.ann_float(ann, gapi.PG_UPDATED_TS_ANNOTATION)
    print(f"step: {int(gapi.ann_float(ann, gapi.PG_STEP_ANNOTATION))}"
          f"  steps/s: "
          f"{gapi.ann_float(ann, gapi.PG_STEP_RATE_ANNOTATION):g}"
          f"  examples/s: "
          f"{gapi.ann_float(ann, gapi.PG_EXAMPLES_RATE_ANNOTATION):g}")
    print(f"goodput: "
          f"{ann.get(gapi.PG_GOODPUT_ANNOTATION, '-')}"
          f"  (productive {prod:.1f}s / allocated {alloc:.1f}s "
          f"pod-seconds)")
    print(f"generation: "
          f"{ann.get(gapi.PG_GENERATION_ANNOTATION, '-')}"
          f"  epoch: {int(gapi.ann_float(ann, gapi.PG_EPOCH_ANNOTATION))}"
          f"  updated: "
          + (datetime.datetime.fromtimestamp(updated).isoformat(
              timespec='seconds') if updated else "-"))
    rows = []
    for name in sorted(getattr(cluster, "goodputreports", {})):
        rep = cluster.goodputreports[name]
        for u in rep.usages:
            if u.job != key:
                continue
            rows.append([
                rep.node, u.pod_key, u.step, f"{u.steps_per_s:g}",
                f"{u.goodput:g}",
                "STALLED" if u.stalled else "stepping", u.epoch])
    if rows:
        print()
        print(_table(rows, ["NODE", "POD", "STEP", "STEPS/S",
                            "GOODPUT", "STATE", "EPOCH"]))
    hist = eapi.resize_history(pg)
    if hist:
        print()
        print(_table(
            [[rec.get("gen", "?"), rec.get("kind", "?"),
              f"{rec.get('from', '?')} -> {rec.get('to', '?')}"]
             for rec in hist],
            ["GEN", "KIND", "SLICES"]))


def cmd_serve(cluster, args):
    """Serving-group view: replicas current/min/max, the store-folded
    traffic summary (QPS, p99 vs the declared SLO, cumulative SLO
    attainment), the autoscaler's last decision and its age, and the
    per-replica rates the node agents last reported (ServingReport
    store) — the operator's answer to "is this group inside its SLO,
    and what did the autoscaler last do about it".  With no name:
    one row per serving group."""
    import datetime
    import time as _time

    from volcano_tpu_torch.api import elastic as eapi
    from volcano_tpu_torch.api import serving as sapi

    def _summary(pg):
        ann = pg.annotations
        qps = sapi.ann_float(ann, sapi.PG_QPS_ANNOTATION)
        p99 = sapi.ann_float(ann, sapi.PG_P99_MS_ANNOTATION)
        reqs = sapi.ann_float(ann, sapi.PG_REQUESTS_ANNOTATION)
        ok = sapi.ann_float(ann, sapi.PG_SLO_OK_ANNOTATION)
        att = ok / reqs if reqs > 0 else None
        return qps, p99, reqs, ok, att

    if not args.name:
        rows = []
        for pg in sorted(cluster.podgroups.values(),
                         key=lambda g: g.key):
            if not sapi.is_serving(pg):
                continue
            rng = sapi.replica_range(pg) or ("?", "?")
            qps, p99, _reqs, _ok, att = _summary(pg)
            slo = sapi.slo_p99_ms(pg)
            rows.append([
                pg.key, eapi.current_slices(pg), rng[0], rng[1],
                f"{qps:g}", f"{p99:g}",
                f"{slo:g}" if slo is not None else "-",
                f"{att:.4f}" if att is not None else "-",
                pg.annotations.get(
                    sapi.PG_LAST_DECISION_ANNOTATION, "-"),
            ])
        print(_table(rows, ["PODGROUP", "REPLICAS", "MIN", "MAX",
                            "QPS", "P99-MS", "SLO-MS", "ATTAIN",
                            "LAST-DECISION"]))
        return

    key = f"{args.namespace}/{args.name}"
    pg = cluster.podgroups.get(key)
    if pg is None:
        sys.exit(f"podgroup {key} not found")
    if not sapi.is_serving(pg):
        sys.exit(f"{key} is not serving-class (no "
                 f"{sapi.SLO_P99_MS_ANNOTATION})")
    ann = pg.annotations
    rng = sapi.replica_range(pg) or ("?", "?")
    qps, p99, reqs, ok, att = _summary(pg)
    slo = sapi.slo_p99_ms(pg)
    tgt = sapi.target_qps_per_replica(pg)
    print(f"group: {key}")
    print(f"phase: {pg.phase.value}  (queue={pg.queue})")
    print(f"replicas: {eapi.current_slices(pg)}"
          f"  (min {rng[0]} / max {rng[1]})"
          + (f"  target-qps/replica: {tgt:g}" if tgt else ""))
    if sapi.PG_QPS_ANNOTATION not in ann:
        print("no serving data published (no replica stats reported "
              "yet — does the job declare "
              f"{sapi.STATS_DIR_ANNOTATION}?)")
        return
    over = ""
    if slo is not None and p99 > slo:
        over = "  OVER SLO"
    print(f"qps: {qps:g}  p99: {p99:g}ms"
          + (f"  (slo {slo:g}ms{over})" if slo is not None else ""))
    print(f"requests: {int(reqs)}  slo-ok: {int(ok)}"
          + (f"  attainment: {att:.4f}" if att is not None else ""))
    updated = sapi.ann_float(ann, sapi.PG_UPDATED_TS_ANNOTATION)
    print(f"reporting-replicas: "
          f"{int(sapi.ann_float(ann, sapi.PG_REPLICAS_ANNOTATION))}"
          f"  epoch: "
          f"{int(sapi.ann_float(ann, sapi.PG_EPOCH_ANNOTATION))}"
          f"  updated: "
          + (datetime.datetime.fromtimestamp(updated).isoformat(
              timespec="seconds") if updated else "-"))
    decision = ann.get(sapi.PG_LAST_DECISION_ANNOTATION)
    if decision:
        ts = sapi.ann_float(ann, sapi.PG_LAST_DECISION_TS_ANNOTATION)
        age = f" ({_time.time() - ts:.0f}s ago)" if ts else ""
        print(f"last-decision: {decision}{age}")
    pool = sapi.pool_slices(pg)
    if pool:
        print(f"pool-slices: {','.join(pool)}")
    desired = eapi.desired_slices(pg)
    if desired is not None:
        print(f"resizing: ->{desired} "
              f"({ann.get(eapi.ELASTIC_RESIZE_REASON_ANNOTATION, '?')})")
    rows = []
    for name in sorted(getattr(cluster, "servingreports", {})):
        rep = cluster.servingreports[name]
        for u in rep.usages:
            if u.job != key:
                continue
            rows.append([
                rep.node, u.pod_key, f"{u.qps:g}", f"{u.p50_ms:g}",
                f"{u.p99_ms:g}", u.requests, u.slo_ok, u.epoch])
    if rows:
        print()
        print(_table(rows, ["NODE", "POD", "QPS", "P50-MS", "P99-MS",
                            "REQUESTS", "SLO-OK", "EPOCH"]))
    hist = eapi.resize_history(pg)
    if hist:
        print()
        print(_table(
            [[rec.get("gen", "?"), rec.get("kind", "?"),
              f"{rec.get('from', '?')} -> {rec.get('to', '?')}"]
             for rec in hist],
            ["GEN", "KIND", "REPLICAS"]))


def cmd_fleet(cluster, args):
    """Fleet observatory rollup: per-job measured throughput (from
    the folded podgroup annotations), then the cluster gauges the
    scheduler exports — NVLink-domain fragmentation per generation
    (largest placeable idle block vs total idle GPUs,
    volcano_tpu_torch/goodput.py)
    and pending-gang counts per queue — computed here from the same
    store objects so the view works against a state file or mirror
    with no scheduler attached."""
    from volcano_tpu_torch import goodput as gp
    from volcano_tpu_torch import trace
    from volcano_tpu_torch.api import elastic as eapi
    from volcano_tpu_torch.api import goodput as gapi
    from volcano_tpu_torch.api.types import PodGroupPhase
    import time as _time

    rows = []
    pending_by_queue = {}
    now = _time.time()
    for pg in sorted(cluster.podgroups.values(), key=lambda g: g.key):
        if pg.phase in (PodGroupPhase.PENDING, PodGroupPhase.INQUEUE):
            born = trace.phase_ts(pg.annotations, "created")
            cur = pending_by_queue.setdefault(
                pg.queue, {"gangs": 0, "age_s": 0.0})
            cur["gangs"] += 1
            if born is not None:
                cur["age_s"] = max(cur["age_s"], now - born)
        ann = pg.annotations
        if gapi.PG_STEP_RATE_ANNOTATION not in ann:
            continue
        rows.append([
            pg.key, pg.phase.value,
            ann.get(gapi.PG_GENERATION_ANNOTATION, "-"),
            eapi.current_slices(pg) if eapi.is_elastic(pg) else "-",
            int(gapi.ann_float(ann, gapi.PG_STEP_ANNOTATION)),
            f"{gapi.ann_float(ann, gapi.PG_STEP_RATE_ANNOTATION):g}",
            ann.get(gapi.PG_GOODPUT_ANNOTATION, "-"),
        ])
    print(_table(rows, ["JOB", "PHASE", "GEN", "SLICES", "STEP",
                        "STEPS/S", "GOODPUT"]))
    frag = gp.fragmentation(gp._slice_stats_from_cluster(
        cluster.nodes.values(), cluster.pods.values()))
    if frag:
        print()
        print(_table(
            [[gen, doc["idle_chips"], doc["largest_block_chips"],
              doc["index"]] for gen, doc in sorted(frag.items())],
            ["GENERATION", "IDLE-GPUS", "LARGEST-BLOCK", "FRAG-INDEX"]))
    if pending_by_queue:
        print()
        print(_table(
            [[q, doc["gangs"], f"{doc['age_s']:.1f}"]
             for q, doc in sorted(pending_by_queue.items())],
            ["QUEUE", "PENDING-GANGS", "OLDEST-AGE-S"]))


def cmd_bandwidth(cluster, args):
    """Per-pod DCN usage as the agents measured it (BandwidthReport
    store, api/netusage.py): node summary line + per-pod rates,
    watermarks and violation tallies.  Works against a state file or
    a live server (the mirror carries the bandwidthreport kind)."""
    reports = getattr(cluster, "bandwidthreports", {})
    rows, summary = [], []
    for name in sorted(reports):
        rep = reports[name]
        if args.node and name != args.node:
            continue
        for u in rep.usages:
            rows.append([
                rep.node, u.pod_key, u.tier,
                f"1:{u.classid}" if u.classid else "-",
                f"{u.tx_mbps:g}", f"{u.rx_mbps:g}",
                f"{u.watermark_mbps:g}" if u.watermark_mbps else "-",
                ("VIOLATING" if u.violating else
                 (str(u.violations) if u.violations else "-")),
            ])
        summary.append([
            rep.node, f"{rep.online_tx_mbps:g}",
            f"{rep.offline_tx_mbps:g}", f"{rep.total_mbps:g}",
            rep.violations, "yes" if rep.saturated else "no"])
    print(_table(rows, ["NODE", "POD", "TIER", "CLASS", "TX-MBPS",
                        "RX-MBPS", "WATERMARK", "VIOLATIONS"]))
    if summary:
        print()
        print(_table(summary, ["NODE", "ONLINE-MBPS", "OFFLINE-MBPS",
                               "BUDGET", "VIOLATING", "SATURATED"]))


def _job_pods(cluster, namespace: str, name: str):
    """Pods belonging to job <namespace>/<name>: matched by the
    group-name annotation the job controller stamps (bare or ns/name
    form — the same key SchedulerCache uses) or by vcjob-uid
    ownership.  Never by name prefix: jobs "train" and "train-2"
    must not claim each other's pods."""
    job = getattr(cluster, "vcjobs", {}).get(f"{namespace}/{name}")
    wanted = (name, f"{namespace}/{name}")
    return [p for p in cluster.pods.values()
            if p.namespace == namespace
            and (p.annotations.get(GROUP_NAME_ANNOTATION) in wanted
                 or (job is not None and p.owner == job.uid))]


def cmd_explain(cluster, args):
    """Why is this job pending?  One place that answers without log
    grepping: the aggregated unschedulable reasons the scheduler
    publishes on the podgroup (trace.py: normalized reason ->
    distinct-node count, with a free-text sample each), the per-pod
    scheduling reasons, and the podgroup's Unschedulable condition."""
    from volcano_tpu_torch import trace
    key = f"{args.namespace}/{args.name}"
    pg = cluster.podgroups.get(key)
    if pg is None:
        sys.exit(f"podgroup {key} not found")
    print(f"job: {key}")
    print(f"phase: {pg.phase.value}  "
          f"(minMember={pg.min_member}, queue={pg.queue})")
    doc = trace.parse_annotation(
        pg.annotations.get(trace.PENDING_REASONS_ANNOTATION, ""))
    if doc and doc.get("reasons"):
        detail = doc.get("detail", {})
        rows = [[reason, count, detail.get(reason, "")[:72]]
                for reason, count in sorted(
                    doc["reasons"].items(),
                    key=lambda kv: (-kv[1], kv[0]))]
        print(f"top unschedulable reason: {doc.get('top')}")
        print(_table(rows, ["REASON", "NODES", "SAMPLE"]))
    else:
        print("no aggregated unschedulable reasons published "
              "(job not gang-blocked, or no scheduling cycle yet)")
    for c in pg.conditions:
        if c.type == "Unschedulable" and c.status == "True":
            print(f"condition: {c.reason}: {c.message}")
    pods = [p for p in _job_pods(cluster, args.namespace, args.name)
            if SCHEDULING_REASON_ANNOTATION in p.annotations]
    if pods:
        print()
        print(_table(
            [[p.name,
              p.annotations.get(SCHEDULING_REASON_ANNOTATION, "-"),
              (p.status_message or "")[:72]]
             for p in sorted(pods, key=lambda p: p.key)[:16]],
            ["POD", "VERDICT", "MESSAGE"]))


def _phase_waterfall(cluster, pg, pods) -> None:
    """Per-pod lifecycle-phase segments from the wire annotations —
    the trace fallback that needs no live scheduler (works against a
    state file too)."""
    from volcano_tpu_torch import trace
    rows = []
    for p in sorted(pods, key=lambda p: p.key):
        segs = trace.phase_segments(
            p.annotations, pg.annotations if pg is not None else None)
        if not segs:
            continue
        rows.append([p.name] +
                    [f"{segs.get(seg, 0.0) * 1e3:.1f}"
                     for seg, _f, _t in trace.SEGMENTS] +
                    [f"{sum(segs.values()) * 1e3:.1f}"])
    if rows:
        print(_table(rows, ["POD"] + [s.upper() + "-MS" for s, _f, _t
                                      in trace.SEGMENTS] + ["E2E-MS"]))
    else:
        print("no lifecycle stamps found (pods not yet created?)")


def cmd_trace(cluster, args):
    """Render the scheduling flight recorder for one job: session
    span waterfalls from the state server's trace ring (server mode),
    falling back to the per-pod lifecycle-phase waterfall derived
    from the stamped annotations (any mode)."""
    from urllib.parse import quote

    from volcano_tpu_torch import trace
    key = f"{args.namespace}/{args.name}"
    pg = cluster.podgroups.get(key)
    pods = _job_pods(cluster, args.namespace, args.name)
    request = getattr(cluster, "_request", None)
    traces = []
    if request is not None:
        try:
            payload = request(
                "GET", f"/traces?job={quote(key, safe='')}"
                       f"&limit={args.last}")
            traces = payload.get("traces", [])
        except Exception as e:  # noqa: BLE001 — fall back to phases
            print(f"(trace ring unavailable: {e})", file=sys.stderr)
    if traces:
        for t in traces[-args.last:]:
            print(f"-- session seq={t.get('seq')} "
                  f"kept={t.get('kept_because')} --")
            for line in trace.render_waterfall(t.get("root", {})):
                print(line)
            pending = t.get("pending", {}).get(key)
            if pending and pending.get("reasons"):
                print(f"   pending: {pending['reasons']}")
            print()
    print("lifecycle phases (from wire annotations):")
    _phase_waterfall(cluster, pg, pods)


def cmd_shards(cluster, args):
    """Shard topology of both planes in one view: which subtrees (and
    how many hosts) each scheduler shard owns under the deterministic
    partition, the latest measured cycle time per scheduler shard
    (trace ring, root label `shard`), and per-leader-group write QPS
    (/durability rv deltas sampled twice).  Works against a single
    server or a semicolon-partitioned endpoint list."""
    import time as _time

    from volcano_tpu_torch import shardmap

    count = args.shard_count
    if count is None:
        count = len(getattr(cluster, "groups", ())) or 1
    subtrees = shardmap.subtree_map(cluster.nodes.values())
    plan = shardmap.plan_partition(subtrees, max(1, count))
    print(_table(
        [[r["shard"], len(r["subtrees"]), r["hosts"],
          ", ".join(r["subtrees"][:4])
          + (" ..." if len(r["subtrees"]) > 4 else "")]
         for r in plan],
        ["SHARD", "SUBTREES", "HOSTS", "OWNS"]))

    request = getattr(cluster, "_request", None)
    if request is None:
        return
    # per-scheduler-shard cycle time: latest kept trace per root
    # `shard` label; every sharded scheduler stamps it (scheduler.py)
    try:
        traces = request("GET", "/traces?limit=64").get("traces", [])
    except Exception as e:  # noqa: BLE001 — observability only
        print(f"(trace ring unavailable: {e})", file=sys.stderr)
        traces = []
    latest = {}
    for t in traces:
        root = t.get("root") or {}
        shard = (root.get("labels") or {}).get("shard") or "unsharded"
        latest[shard] = (root.get("dur", 0.0),
                         (root.get("labels") or {}).get("cycle"))
    if latest:
        print()
        print(_table(
            [[shard, f"{dur * 1e3:.1f}ms", cycle]
             for shard, (dur, cycle) in sorted(latest.items())],
            ["SCHED-SHARD", "CYCLE-TIME", "CYCLE"]))

    # per-leader-group write QPS: rv is the server's monotonic write
    # counter, so two /durability samples give writes/second
    groups = list(getattr(cluster, "groups", ())) or [cluster]
    samples = []
    for g in groups:
        try:
            samples.append(g._request("GET", "/durability").get("rv", 0))
        except Exception:  # noqa: BLE001
            samples.append(None)
    t0 = _time.time()
    _time.sleep(max(0.05, args.interval))
    rows = []
    for i, g in enumerate(groups):
        label = "meta+nodes" if len(groups) > 1 and i == 0 else "nodes"
        if len(groups) == 1:
            label = "all"
        try:
            rv = g._request("GET", "/durability").get("rv", 0)
        except Exception as e:  # noqa: BLE001
            rows.append([i, label, f"unreachable: {e}", "-"])
            continue
        before = samples[i]
        qps = "-" if before is None else \
            f"{(rv - before) / max(1e-9, _time.time() - t0):.1f}"
        rows.append([i, label, rv, qps])
    print()
    print(_table(rows, ["GROUP", "KEYSPACE", "RV", "WRITE-QPS"]))


def cmd_regions(cluster, args):
    """Federation region registry (the `region` dict-kind on the
    GLOBAL store): one row per regional plane with its advertised
    price/locality and the router-folded liveness + capacity.  --add /
    --remove edit the registry; the router attaches/detaches on its
    next pass."""
    import time as _time

    from volcano_tpu_torch.api import federation as fedapi

    if args.add:
        name, _, url = args.add.partition("=")
        if not url:
            sys.exit("--add wants NAME=URL")
        rec = fedapi.region_record(
            name, url, price=args.price, locality=args.locality,
            mirror_url=args.mirror_url, metrics_url=args.metrics_url)
        cluster.put_object("region", rec, key=name)
        print(f"region {name} registered at {url}")
        return
    if args.remove:
        cluster.delete_object("region", args.remove)
        print(f"region {args.remove} removed")
        return
    rows = []
    now = _time.time()
    for name, rec in sorted(cluster.regions.items()):
        try:
            age = now - float(rec.get("heartbeat_ts", 0) or 0)
        except (TypeError, ValueError):
            age = float("inf")
        stale = rec.get("mirror_staleness_s")
        rows.append([
            name, rec.get("state", "?"), rec.get("url", ""),
            f"{float(rec.get('price', 1.0) or 1.0):g}",
            rec.get("locality", "") or "-",
            f"{float(rec.get('capacity_chips', 0) or 0):g}",
            f"{float(rec.get('idle_chips', 0) or 0):g}",
            f"{age:.0f}s" if age < 1e6 else "never",
            "-" if stale is None else f"{float(stale):.1f}s",
        ])
    print(_table(rows, ["REGION", "STATE", "URL", "PRICE", "LOCALITY",
                        "CAP-GPUS", "IDLE-GPUS", "HEARTBEAT",
                        "STALENESS"]))


def cmd_routers(cluster, args):
    """Router replica-set status from the GLOBAL store: who holds the
    term-fenced `federation-router` lease (and at what term), plus —
    per region — the leaseholder's circuit-breaker verdict folded
    into the registry record and, when the regional plane is
    reachable, its fence floor and refused-write count (the deposed-
    router evidence trail)."""
    from volcano_tpu_torch.api import federation as fedapi

    lease = {}
    try:
        lease = (cluster.leases() or {}).get(
            fedapi.ROUTER_LEASE_NAME) or {}
    except (AttributeError, OSError, ValueError):
        pass                    # state-file mode: no lease surface
    expires = float(lease.get("expires_in", 0) or 0)
    if lease and expires > 0:
        print(f"leaseholder: {lease.get('holder')}  "
              f"term {lease.get('term', 0)}  "
              f"(expires in {expires:.1f}s)")
    else:
        print("leaseholder: NONE (lease vacant — regions run "
              "autonomously, global admission queues)")
    rows = []
    for name, rec in sorted(cluster.regions.items()):
        fence = refused = "-"
        url = rec.get("url", "")
        if url:
            try:
                from volcano_tpu_torch.cache.remote_cluster import \
                    RemoteCluster
                rc = RemoteCluster(url, retry_deadline=2.0)
                try:
                    f = (rc.fences() or {}).get(
                        fedapi.ROUTER_LEASE_NAME) or {}
                    fence = str(f.get("term", 0))
                    refused = str(f.get("refused", 0))
                finally:
                    rc.close()
            except (OSError, ValueError):
                fence = refused = "unreachable"
        rows.append([
            name, rec.get("state", "?"),
            rec.get("router_breaker", "-"),
            fence, refused,
        ])
    print(_table(rows, ["REGION", "STATE", "BREAKER", "FENCE-TERM",
                        "FENCED-WRITES"]))


def cmd_timeline(cluster, args):
    """The federated causal timeline of ONE job: resolve its episode
    ID from the global job's annotations, fetch the stitched cross-
    plane span tree (`fleet_trace` dict-kind, written by the
    leaseholder router's stitcher), and render it as a waterfall plus
    the per-hop wait/active segment breakdown."""
    from volcano_tpu_torch import trace
    from volcano_tpu_torch.api import federation as fedapi

    episode = args.episode
    if not episode:
        key = f"{args.namespace}/{args.name}"
        job = cluster.vcjobs.get(key)
        if job is None:
            sys.exit(f"no global job {key}")
        episode = fedapi.episode_of(job)
        if not episode:
            sys.exit(f"{key} carries no episode annotation (pre-"
                     f"episode job, or not yet admitted by a router)")
    doc = None
    request = getattr(cluster, "_request", None)
    if request is not None:
        try:
            payload = request("GET", f"/fleet_trace?episode={episode}")
            doc = payload.get("trace")
        except Exception as e:  # noqa: BLE001 — fall back to mirror
            print(f"(/fleet_trace unavailable: {e})", file=sys.stderr)
    if doc is None:
        doc = getattr(cluster, "fleet_traces", {}).get(episode)
    if not doc:
        sys.exit(f"no stitched trace for episode {episode} yet "
                 f"(the leaseholder router stitches once per pass)")
    print(f"episode {episode}  wall {doc.get('wall_s', 0.0):.3f}s  "
          f"planes {', '.join(doc.get('planes', []))}  "
          f"hops {doc.get('hops', [])}")
    if doc.get("jobs"):
        print(f"jobs: {', '.join(doc['jobs'])}")
    print()
    for line in trace.render_waterfall(doc.get("root", {})):
        print(line)
    segments = doc.get("segments") or {}
    if segments:
        print()
        print(_table(
            [[seg, f"{v * 1e3:.1f}ms"]
             for seg, v in sorted(segments.items())],
            ["SEGMENT", "DURATION"]))


def cmd_slo(cluster, args):
    """Fleet SLO burn rates from the durable doc the leaseholder
    router writes each observability pass (`slo` dict-kind, key
    `global`): per SLO x window the burn rate (budget spend speed;
    sustained > 1.0 means the SLO will be missed), the good-poll
    fraction and the sample count."""
    doc = getattr(cluster, "slos", {}).get("global")
    if not doc:
        sys.exit("no SLO doc on the global store yet (the leaseholder "
                 "router writes it once regions expose /metrics)")
    import time as _time
    age = _time.time() - float(doc.get("ts", 0) or 0)
    if 0 <= age < 1e6:
        print(f"as of {age:.0f}s ago")
    rows = []
    for slo, rec in sorted((doc.get("slos") or {}).items()):
        for window, w in sorted((rec.get("windows") or {}).items()):
            good = w.get("good_frac")
            rows.append([
                slo, f"{rec.get('target', 0):g}",
                f"{rec.get('budget', 0):g}", window,
                f"{w.get('burn', 0.0):.2f}",
                "-" if good is None else f"{good:.3f}",
                w.get("polls", 0),
            ])
    print(_table(rows, ["SLO", "TARGET", "BUDGET", "WINDOW", "BURN",
                        "GOOD-FRAC", "POLLS"]))


def cmd_federate(cluster, args):
    """Federated fleet view from the GLOBAL store alone: every global
    job with its admitted region, router-folded regional phase and
    migration provenance.  --migrate stamps the cross-region evacuate
    trigger; --drain/--undrain cordon a whole region (the router
    evacuates its running gangs — follow-the-sun)."""
    from volcano_tpu_torch.api import federation as fedapi

    if args.drain or args.undrain:
        name = args.drain or args.undrain
        rec = dict(cluster.regions.get(name) or {})
        if not rec:
            sys.exit(f"unknown region {name}")
        rec["state"] = fedapi.REGION_STATE_DRAINING if args.drain \
            else fedapi.REGION_STATE_READY
        cluster.put_object("region", rec, key=name)
        print(f"region {name} -> {rec['state']}")
        return
    if args.migrate:
        ns, _, name = args.migrate.rpartition("/")
        key = f"{ns or 'default'}/{name}"
        job = cluster.vcjobs.get(key)
        if job is None:
            sys.exit(f"unknown global job {key}")
        job.annotations[fedapi.FED_EVACUATE_ANNOTATION] = \
            args.to or "auto"
        cluster.update_vcjob(job)
        print(f"migration requested: {key} -> {args.to or 'auto'}")
        return
    rows = []
    for job in sorted(cluster.vcjobs.values(), key=lambda j: j.key):
        if fedapi.home_key(job) is not None:
            continue            # a regional copy, not a global record
        region = fedapi.admitted_region(job) or "-"
        evac = job.annotations.get(
            fedapi.FED_EVACUATING_TO_ANNOTATION) or \
            job.annotations.get(fedapi.FED_EVACUATE_ANNOTATION)
        rows.append([
            job.key, job.phase.value, region,
            job.annotations.get(
                fedapi.FED_REGIONAL_PHASE_ANNOTATION, "-"),
            fedapi.migration_count(job),
            job.annotations.get(fedapi.FED_MIGRATED_FROM_ANNOTATION,
                                "-"),
            f"->{evac}" if evac else "-",
            ",".join(fedapi.data_locality(job)) or "-",
        ])
    print(_table(rows, ["JOB", "PHASE", "REGION", "REGIONAL-PHASE",
                        "MOVES", "FROM", "EVACUATING", "LOCALITY"]))


def cmd_server(cluster, args):
    """Durability + lease status of the live state server (GET
    /durability, GET /leases): whether writes are journaled, how much
    WAL a crash would replay, when the last snapshot landed, and who
    holds the control-plane leases.  Server mode only — a state file
    has no server to ask."""
    if not getattr(args, "server", ""):
        print("server status needs --server URL", file=sys.stderr)
        return
    dur = cluster._request("GET", "/durability")
    rows = [["epoch", dur.get("epoch", "-")],
            ["rv", dur.get("rv")],
            ["visible-rv", dur.get("visible_rv")],
            ["durable", "yes" if dur.get("enabled") else
             "NO (kill -9 loses state)"]]
    if dur.get("readonly"):
        # the degraded state an operator must see first: writes are
        # 503ing until the heal loop clears the poison
        rows.insert(0, ["READ-ONLY", dur["readonly"]])
    if dur.get("enabled"):
        age = dur.get("snapshot_age_s")
        rows += [
            ["data-dir", dur.get("dir", "-")],
            ["wal-records", dur.get("wal_records")],
            ["wal-bytes", dur.get("wal_bytes")],
            ["synced-rv", dur.get("synced_rv")],
            ["snapshot-rv", dur.get("snapshot_rv")],
            ["snapshot-age", f"{age:.1f}s" if age is not None else
             "never"],
            ["last-fsync", f"{dur.get('last_fsync_s', 0) * 1e3:.2f}ms"],
            ["boot-replay", f"{dur.get('replay_records')} records in "
             f"{dur.get('replay_seconds')}s"],
        ]
    rep = dur.get("replication")
    if rep:
        # the divergence an operator must see BEFORE it pages them:
        # who leads at what term, how far each replica trails, and
        # whether the commit quorum is holding
        rows += [
            ["repl-role", f"{rep.get('role')} (term {rep.get('term')},"
             f" id {rep.get('replica_id')})"],
            ["repl-leader", rep.get("leader") or "-"],
            ["repl-applied", f"rv {rep.get('applied_rv')} / seq "
             f"{rep.get('applied_seq')}"],
            ["repl-lag", f"{rep.get('lag_s', 0):.3f}s"],
            ["repl-quorum", f"commit={rep.get('commit_quorum')} "
             + ("ok" if rep.get("quorum_ok", True) else
                "LOST (writes 503)")],
            ["repl-promotions", rep.get("promotions")],
        ]
        if rep.get("role") == "leader":
            rows.append(["last-shipped", f"rv {rep.get('last_shipped_rv')}"])
            for fid, f in sorted((rep.get("followers") or {}).items()):
                rows.append(
                    [f"follower/{fid}",
                     f"applied rv {f.get('applied_rv')} "
                     f"(acked {f.get('ack_age_s', 0):.1f}s ago)"])
    print(_table([[k, str(v)] for k, v in rows], ["FIELD", "VALUE"]))
    leases = cluster._request("GET", "/leases")
    if leases:
        print()
        print(_table(
            [[n, l["holder"], str(l.get("term", 0)),
              f"{l['expires_in']:.1f}s"]
             for n, l in sorted(leases.items())],
            ["LEASE", "HOLDER", "TERM", "EXPIRES-IN"]))


def cmd_tick(cluster, args):
    """Run controllers + one scheduling cycle + kubelet tick.

    Against a live server (--server) the running control plane owns
    scheduling and reconciliation — ticking locally with a stale,
    watch-less mirror would push wrong status back — so only the
    kubelet simulation is advanced there."""
    if getattr(args, "server", ""):
        for _ in range(args.cycles):
            cluster.tick()
        cluster.resync()
        bound = sum(1 for p in cluster.pods.values() if p.node_name)
        print(f"ticked {args.cycles} time(s): {bound} pods placed")
        return
    from volcano_tpu_torch.controllers import ControllerManager
    from volcano_tpu_torch.scheduler import Scheduler
    mgr = ControllerManager(cluster, enabled=[
        "job", "podgroup", "queue", "hypernode", "garbagecollector",
        "jobflow", "jobtemplate", "cronjob"])
    sched = Scheduler(cluster, schedule_period=0)
    for _ in range(args.cycles):
        mgr.sync_all()
        sched.run_once()
        cluster.tick()
    mgr.stop()
    bound = sum(1 for p in cluster.pods.values() if p.node_name)
    print(f"ran {args.cycles} cycle(s): {bound} pods placed")


def _add_job_run_args(p) -> None:
    """Shared by `job run` and its slurm-style alias `vsub`."""
    p.add_argument("-N", "--name", required=True)
    p.add_argument("-n", "--namespace", default="default")
    p.add_argument("--replicas", type=int, default=1)
    p.add_argument("--min-available", type=int, default=None)
    p.add_argument("--task-name", default="worker")
    p.add_argument("--queue", default="default")
    p.add_argument("--image", default="busybox")
    p.add_argument("--cpu", default="1")
    p.add_argument("--gpu", type=int, default=0,
                   help="nvidia.com/gpu a pod requests")
    p.add_argument("--plugins", default="")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="vtpctl",
        description="volcano-tpu batch scheduling CLI")
    parser.add_argument("--state", default="vtpctl-cluster.pkl",
                        help="cluster state file (standalone mode)")
    parser.add_argument("--server", default="",
                        help="state-server URL (kubectl mode: talk to "
                             "the live control plane instead of a "
                             "state file)")
    parser.add_argument("--token", default="",
                        help="cluster bearer token (required for ALL "
                             "state-server routes when configured)")
    parser.add_argument("--token-file", default="")
    parser.add_argument("--ca-cert", default="",
                        help="CA bundle to verify an https server")
    parser.add_argument("--insecure", action="store_true",
                        help="skip server cert verification")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("init", help="provision simulated NVLink domains")
    p.add_argument("--slices", nargs="*",
                   help="name=kind, kind hgx-h100-8 or dgx-h100-256, "
                        "e.g. nvl-a=hgx-h100-8")
    p.add_argument("--ib-fabric", default="ib-0",
                   help="the InfiniBand fabric the domains join")
    p.set_defaults(fn=cmd_init)

    job = sub.add_parser("job", help="job operations").add_subparsers(
        dest="job_cmd", required=True)
    p = job.add_parser("run")
    _add_job_run_args(p)
    p.set_defaults(fn=cmd_job_run)
    p = job.add_parser("create", help="create job(s) from a YAML manifest")
    p.add_argument("-f", "--filename", required=True)
    p.set_defaults(fn=cmd_job_create)
    p = job.add_parser("list")
    p.add_argument("-n", "--namespace", default=None)
    p.set_defaults(fn=cmd_job_list)
    p = job.add_parser("view")
    p.add_argument("-N", "--name", required=True)
    p.add_argument("-n", "--namespace", default="default")
    p.set_defaults(fn=cmd_job_view)
    p = job.add_parser("delete")
    p.add_argument("-N", "--name", required=True)
    p.add_argument("-n", "--namespace", default="default")
    p.set_defaults(fn=cmd_job_delete)
    for verb, action in (("suspend", "AbortJob"), ("resume", "ResumeJob"),
                         ("restart", "RestartJob"),
                         ("complete", "CompleteJob")):
        p = job.add_parser(verb)
        p.add_argument("-N", "--name", required=True)
        p.add_argument("-n", "--namespace", default="default")
        p.set_defaults(fn=lambda c, a, _act=action: cmd_job_command(c, a, _act))

    jobtemplate = sub.add_parser(
        "jobtemplate", help="jobtemplate operations").add_subparsers(
        dest="jobtemplate_cmd", required=True)
    p = jobtemplate.add_parser("create")
    p.add_argument("-f", "--filename", required=True,
                   help="Job manifest(s) stored as templates")
    p.set_defaults(fn=cmd_jobtemplate_create)
    p = jobtemplate.add_parser("list")
    p.set_defaults(fn=cmd_jobtemplate_list)
    for verb, fn in (("get", cmd_jobtemplate_get),
                     ("describe", cmd_jobtemplate_describe),
                     ("delete", cmd_jobtemplate_delete)):
        p = jobtemplate.add_parser(verb)
        p.add_argument("-N", "--name", required=True)
        p.add_argument("-n", "--namespace", default="default")
        p.set_defaults(fn=fn)

    jobflow = sub.add_parser("jobflow",
                             help="jobflow operations").add_subparsers(
        dest="jobflow_cmd", required=True)
    p = jobflow.add_parser("create")
    p.add_argument("-N", "--name", required=True)
    p.add_argument("-n", "--namespace", default="default")
    p.add_argument("--flows", nargs="+", required=True,
                   help='steps as "template" or "template:dep1+dep2"')
    p.add_argument("--retain-policy", choices=["retain", "delete"],
                   default="retain",
                   help="what happens to stamped jobs when the flow "
                        "succeeds or is deleted (jobRetainPolicy)")
    p.set_defaults(fn=cmd_jobflow_create)
    p = jobflow.add_parser("list")
    p.set_defaults(fn=cmd_jobflow_list)
    for verb, fn in (("get", cmd_jobflow_get),
                     ("describe", cmd_jobflow_describe),
                     ("delete", cmd_jobflow_delete)):
        p = jobflow.add_parser(verb)
        p.add_argument("-N", "--name", required=True)
        p.add_argument("-n", "--namespace", default="default")
        p.set_defaults(fn=fn)

    queue = sub.add_parser("queue", help="queue operations").add_subparsers(
        dest="queue_cmd", required=True)
    p = queue.add_parser("create")
    p.add_argument("-N", "--name", required=True)
    p.add_argument("--weight", type=int, default=1)
    p.add_argument("--parent", default="")
    p.add_argument("--capability", default="",
                   help='JSON resource list, e.g. \'{"cpu": 10}\'')
    p.set_defaults(fn=cmd_queue_create)
    p = queue.add_parser("list")
    p.set_defaults(fn=cmd_queue_list)
    p = queue.add_parser("operate", help="open/close a queue")
    p.add_argument("-N", "--name", required=True)
    p.add_argument("--action", choices=["open", "close"], required=True)
    p.set_defaults(fn=cmd_queue_operate)
    p = queue.add_parser("get", help="detailed queue view")
    p.add_argument("-N", "--name", required=True)
    p.set_defaults(fn=cmd_queue_get)
    p = queue.add_parser("delete")
    p.add_argument("-N", "--name", required=True)
    p.add_argument("--force", action="store_true",
                   help="delete even with podgroups still enqueued")
    p.set_defaults(fn=cmd_queue_delete)

    pod = sub.add_parser("pod", help="pod operations").add_subparsers(
        dest="pod_cmd", required=True)
    p = pod.add_parser("list")
    p.add_argument("-n", "--namespace", default=None)
    p.set_defaults(fn=cmd_pod_list)
    p = pod.add_parser("describe", help="pod state + scheduling "
                       "reason + server audit history")
    p.add_argument("-N", "--name", required=True)
    p.add_argument("-n", "--namespace", default="default")
    p.set_defaults(fn=cmd_pod_describe)

    node = sub.add_parser("node", help="node operations").add_subparsers(
        dest="node_cmd", required=True)
    p = node.add_parser("list")
    p.set_defaults(fn=cmd_node_list)
    p = node.add_parser("view")
    p.add_argument("-N", "--name", required=True)
    p.set_defaults(fn=cmd_node_view)

    p = sub.add_parser("bandwidth", help="per-pod DCN usage as the "
                       "agents measured it (rates, watermarks, "
                       "violations)")
    p.add_argument("--node", default="",
                   help="limit to one node's report")
    p.set_defaults(fn=cmd_bandwidth)

    p = sub.add_parser("slices", help="per-slice host/health rollup "
                       "(HEALTH + QUARANTINED-UNTIL from the folded "
                       "SliceHealthReports)")
    p.set_defaults(fn=cmd_slices)

    p = sub.add_parser("failover", help="slice-failover view: sick "
                       "hosts, drained gangs, resume metadata")
    p.set_defaults(fn=cmd_failover)

    p = sub.add_parser("elastic", help="elastic gangs: current/min/"
                       "max slices, in-flight resizes, history — or "
                       "trigger a live migration off a gang's "
                       "current slices")
    p.add_argument("--migrate", default="",
                   help="<ns>/<name> (or name): drain this elastic "
                        "gang and re-place it on DIFFERENT slices at "
                        "the same world size")
    p.set_defaults(fn=cmd_elastic)

    p = sub.add_parser("goodput", help="one job's measured "
                       "throughput: step rate, goodput = productive/"
                       "allocated, per-pod progress, resize history")
    p.add_argument("name", help="job / podgroup name")
    p.add_argument("-n", "--namespace", default="default")
    p.set_defaults(fn=cmd_goodput)

    p = sub.add_parser("serve", help="serving groups: replicas "
                       "cur/min/max, folded QPS and p99 vs SLO, "
                       "last autoscaler decision + age, per-replica "
                       "agent rates")
    p.add_argument("name", nargs="?", default="",
                   help="serving group name (omit to list all)")
    p.add_argument("-n", "--namespace", default="default")
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("fleet", help="fleet observatory rollup: "
                       "per-job measured steps/s + goodput, ICI "
                       "fragmentation per generation, pending gangs "
                       "per queue")
    p.set_defaults(fn=cmd_fleet)

    p = sub.add_parser("explain", help="why is this job pending: "
                       "aggregated unschedulable reasons (normalized "
                       "reason -> node count) + per-pod verdicts")
    p.add_argument("name", help="job / podgroup name")
    p.add_argument("-n", "--namespace", default="default")
    p.set_defaults(fn=cmd_explain)

    p = sub.add_parser("trace", help="scheduling flight recorder: "
                       "session span waterfalls (server mode) + the "
                       "per-pod lifecycle phase breakdown")
    p.add_argument("name", help="job / podgroup name")
    p.add_argument("-n", "--namespace", default="default")
    p.add_argument("--last", type=int, default=3,
                   help="how many kept session traces to render")
    p.set_defaults(fn=cmd_trace)

    p = sub.add_parser("server", help="state-server durability, "
                       "replication + lease status (WAL/snapshot/"
                       "replay, role/term/lag; needs --server)")
    p.set_defaults(fn=cmd_server)

    p = sub.add_parser("shards", help="shard topology: subtree "
                       "ownership per scheduler shard, per-shard "
                       "cycle time, per-leader-group write QPS")
    p.add_argument("--shard-count", type=int, default=None,
                   help="scheduler shards to plan for (default: the "
                        "number of leader groups in --server)")
    p.add_argument("--interval", type=float, default=1.0,
                   help="seconds between the two write-QPS samples")
    p.set_defaults(fn=cmd_shards)

    p = sub.add_parser("timeline", help="federated causal timeline: "
                       "the stitched cross-plane span tree of one "
                       "episode (router admit -> regional placement "
                       "-> cutover -> resume), waterfall + per-hop "
                       "segments")
    p.add_argument("name", nargs="?", default="",
                   help="global job name (resolves its episode)")
    p.add_argument("-n", "--namespace", default="default")
    p.add_argument("--episode", default="",
                   help="episode ID directly (skips job lookup)")
    p.set_defaults(fn=cmd_timeline)

    p = sub.add_parser("slo", help="fleet SLO burn rates: per SLO x "
                       "window budget-spend speed from the router's "
                       "durable burn doc")
    p.set_defaults(fn=cmd_slo)

    p = sub.add_parser("regions", help="federation region registry: "
                       "liveness, price, capacity, mirror staleness "
                       "per regional plane")
    p.add_argument("--add", default="",
                   help="register a region: NAME=URL")
    p.add_argument("--price", type=float, default=1.0)
    p.add_argument("--locality", default="")
    p.add_argument("--mirror-url", default="")
    p.add_argument("--metrics-url", default="",
                   help="region /metrics base URL (enables the "
                        "router's rollup + SLO scrape)")
    p.add_argument("--remove", default="",
                   help="deregister a region by name")
    p.set_defaults(fn=cmd_regions)

    p = sub.add_parser("routers", help="router replica set: lease "
                       "term + holder, per-region breaker state and "
                       "fence floors")
    p.set_defaults(fn=cmd_routers)

    p = sub.add_parser("federate", help="federated fleet view; "
                       "cross-region migration and region drain")
    p.add_argument("--migrate", default="",
                   help="global job ([ns/]name) to move cross-region")
    p.add_argument("--to", default="",
                   help="destination region for --migrate "
                        "(default: auto-pick)")
    p.add_argument("--drain", default="",
                   help="cordon a region: evacuate its running gangs")
    p.add_argument("--undrain", default="",
                   help="reopen a drained region")
    p.set_defaults(fn=cmd_federate)

    p = sub.add_parser("tick",
                       help="advance the standalone control plane")
    p.add_argument("--cycles", type=int, default=1)
    p.set_defaults(fn=cmd_tick)

    # slurm-style shortcuts (reference standalone binaries vsub/vjobs/
    # vqueues/vcancel/vsuspend/vresume, Makefile:281)
    p = sub.add_parser("vjobs", help="alias of: job list")
    p.add_argument("-n", "--namespace", default=None)
    p.set_defaults(fn=cmd_job_list)
    p = sub.add_parser("vqueues", help="alias of: queue list")
    p.set_defaults(fn=cmd_queue_list)
    p = sub.add_parser("vsub", help="alias of: job run")
    _add_job_run_args(p)
    p.set_defaults(fn=cmd_job_run)
    p = sub.add_parser("vcancel", help="alias of: job delete")
    p.add_argument("-N", "--name", required=True)
    p.add_argument("-n", "--namespace", default="default")
    p.set_defaults(fn=cmd_job_delete)
    for verb, action in (("vsuspend", "AbortJob"),
                         ("vresume", "ResumeJob")):
        p = sub.add_parser(verb, help=f"alias of: job {verb[1:]}")
        p.add_argument("-N", "--name", required=True)
        p.add_argument("-n", "--namespace", default="default")
        p.set_defaults(fn=lambda c, a, _act=action: cmd_job_command(
            c, a, _act))

    return parser


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.server:
        # kubectl mode: reads come from the watch-bootstrapped mirror,
        # writes hit the live server; no state file is touched
        from volcano_tpu_torch.cache.remote_cluster import RemoteCluster
        from volcano_tpu_torch.server.tlsutil import load_token
        # `vtpctl server` is the incident command: it reads only
        # /durability + /leases, and a READ-ONLY (degraded) server
        # 503s the /snapshot bootstrap — the status view must not
        # block behind the mirror it never uses
        tolerant = getattr(args, "fn", None) is cmd_server
        if ";" in args.server:
            # keyspace-partitioned plane: semicolon-separated leader
            # groups — reads merge every group's mirror
            from volcano_tpu_torch.cache.partitioned import PartitionedCluster
            cluster = PartitionedCluster(
                args.server, start_watch=False,
                token=load_token(args.token, args.token_file),
                ca_cert=args.ca_cert, insecure=args.insecure,
                tolerate_unreachable=tolerant)
        else:
            cluster = RemoteCluster(
                args.server, start_watch=False,
                tolerate_unreachable=tolerant,
                token=load_token(args.token, args.token_file),
                ca_cert=args.ca_cert, insecure=args.insecure)
    else:
        cluster = _load(args.state)
    from volcano_tpu_torch.webhooks import AdmissionError
    try:
        args.fn(cluster, args)
    except AdmissionError as e:
        print(f"admission denied: {e}", file=sys.stderr)
        return 1
    except BrokenPipeError:
        # output piped into head etc.; state still saved below
        pass
    if args.server:
        cluster.close()
    else:
        _save(cluster, args.state)
    return 0


# global connection flags (defined on the root parser) and their
# value arity — the alias mains hoist these in front of the verb so
# `vjobs --server URL` works the way a standalone binary should
_GLOBAL_FLAGS = {"--state": 1, "--server": 1, "--token": 1,
                 "--token-file": 1, "--ca-cert": 1, "--insecure": 0}


def _alias_main(verb: str):
    """Standalone slurm-style binary (reference builds vsub/vcancel/
    vsuspend/vresume/vjobs/vqueues as separate binaries, Makefile:281):
    each console script is the vtpctl verb with argv passed through."""
    def _main() -> int:
        args = list(sys.argv[1:])
        pre, post, i = [], [], 0
        while i < len(args):
            name = args[i].split("=", 1)[0]
            if name in _GLOBAL_FLAGS:
                pre.append(args[i])
                if _GLOBAL_FLAGS[name] and "=" not in args[i] \
                        and i + 1 < len(args):
                    i += 1
                    pre.append(args[i])
            else:
                post.append(args[i])
            i += 1
        return main([*pre, verb, *post])
    _main.__name__ = verb
    return _main


vsub_main = _alias_main("vsub")
vcancel_main = _alias_main("vcancel")
vsuspend_main = _alias_main("vsuspend")
vresume_main = _alias_main("vresume")
vjobs_main = _alias_main("vjobs")
vqueues_main = _alias_main("vqueues")


if __name__ == "__main__":
    sys.exit(main())

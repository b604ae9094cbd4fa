"""YAML job manifests — the vcjob schema, for GPU jobs.

Reference parity: example/job.yaml + `vcctl job run -f`.  The schema
mirrors batch/v1alpha1 with GPU-first fields:

    apiVersion: batch.volcano-tpu.io/v1alpha1
    kind: Job
    metadata: {name: train, namespace: default}
    spec:
      minAvailable: 4
      queue: research
      schedulerName: volcano-tpu
      plugins: {torch: [], svc: [], env: []}
      policies:
        - event: PodFailed
          action: RestartJob
      networkTopology: {mode: hard, highestTierAllowed: 1}
      tasks:
        - name: worker
          replicas: 4
          minAvailable: 4
          subGroup: rep0                 # optional subgroup gang
          policies: []
          template:
            spec:
              containers:
                - name: main
                  image: my-trainer
                  command: ["python", "train.py"]
                  resources:
                    requests: {cpu: 8, memory: 16Gi, nvidia.com/gpu: 4}
              nodeSelector: {}
              tolerations: []
"""

from __future__ import annotations

from typing import List

import yaml

from volcano_tpu_torch.api.pod import Container, Pod, Toleration
from volcano_tpu_torch.api.podgroup import NetworkTopologySpec
from volcano_tpu_torch.api.types import JobAction, JobEvent, NetworkTopologyMode
from volcano_tpu_torch.api.vcjob import DependsOn, LifecyclePolicy, TaskSpec, VCJob


class ManifestError(ValueError):
    pass


def _policies(raw: List[dict]) -> List[LifecyclePolicy]:
    out = []
    for p in raw or []:
        try:
            event = JobEvent(p["event"]) if "event" in p else None
            events = [JobEvent(e) for e in p.get("events", [])]
            action = JobAction(p["action"])
        except (KeyError, ValueError) as e:
            raise ManifestError(f"invalid policy {p!r}: {e}") from e
        out.append(LifecyclePolicy(
            action=action, event=event, events=events,
            exit_code=p.get("exitCode"),
            timeout_seconds=p.get("timeout")))
    return out


def _pod_template(raw: dict) -> Pod:
    spec = (raw or {}).get("spec", raw or {})
    containers = []
    for c in spec.get("containers", [{}]):
        resources = c.get("resources", {})
        env = {}
        for e in c.get("env", []):
            if "name" not in e:
                raise ManifestError(f"env entry missing name: {e!r}")
            if "valueFrom" in e:
                raise ManifestError(
                    f"env valueFrom is not supported in the standalone "
                    f"runtime (entry {e['name']!r}); use a literal value")
            env[e["name"]] = str(e.get("value", ""))
        containers.append(Container(
            name=c.get("name", "main"),
            image=c.get("image", ""),
            command=c.get("command"),
            requests=dict(resources.get("requests", {})),
            limits=dict(resources.get("limits", {})),
            env=env,
            ports=[p.get("containerPort", p) if isinstance(p, dict) else p
                   for p in c.get("ports", [])],
        ))
    tolerations = [Toleration(
        key=t.get("key", ""), operator=t.get("operator", "Equal"),
        value=t.get("value", ""), effect=t.get("effect", ""))
        for t in spec.get("tolerations", [])]
    return Pod(name="template", containers=containers,
               node_selector=dict(spec.get("nodeSelector", {})),
               tolerations=tolerations,
               priority_class=spec.get("priorityClassName", ""))


def _task_topology(nt, default_tier=None):
    """Parse a networkTopology block (job- or task-level).

    Job level defaults highestTierAllowed to 1 (webhook-mutate parity);
    task level defaults to None = unbounded (prefer-lowest-tier)."""
    if not nt:
        return None
    try:
        raw_tier = nt.get("highestTierAllowed", default_tier)
        return NetworkTopologySpec(
            mode=NetworkTopologyMode(nt.get("mode", "hard")),
            highest_tier_allowed=None if raw_tier is None else int(raw_tier))
    except (TypeError, ValueError) as e:
        raise ManifestError(f"invalid networkTopology {nt!r}") from e


def job_from_manifest(data: dict) -> VCJob:
    if data.get("kind") != "Job":
        raise ManifestError(f"kind must be Job, got {data.get('kind')!r}")
    meta = data.get("metadata", {})
    spec = data.get("spec", {})
    if "name" not in meta:
        raise ManifestError("metadata.name is required")

    tasks = []
    for t in spec.get("tasks", []):
        if "name" not in t:
            raise ManifestError("every task needs a name")
        depends = t.get("dependsOn")
        tasks.append(TaskSpec(
            name=t["name"],
            replicas=int(t.get("replicas", 1)),
            min_available=(int(t["minAvailable"])
                           if "minAvailable" in t else None),
            template=_pod_template(t.get("template", {})),
            policies=_policies(t.get("policies", [])),
            depends_on=DependsOn(
                name=list(depends.get("name", [])),
                iteration=depends.get("iteration", "any"))
            if depends else None,
            subgroup=t.get("subGroup", ""),
            network_topology=_task_topology(t.get("networkTopology")),
        ))

    if not tasks:
        raise ManifestError("spec.tasks must declare at least one task")
    if sum(t.replicas for t in tasks) <= 0:
        raise ManifestError("total task replicas must be > 0")

    nt = spec.get("networkTopology")
    network_topology = _task_topology(nt, default_tier=1)

    plugins = spec.get("plugins", {})
    if not isinstance(plugins, dict):
        raise ManifestError("spec.plugins must be a mapping")
    for pname, pargs in plugins.items():
        if pargs is not None and not isinstance(pargs, list):
            raise ManifestError(
                f"plugin {pname!r} arguments must be a list, got "
                f"{type(pargs).__name__}")

    # reference default: minAvailable = total replicas (full gang) —
    # never 0, which would disable gang scheduling entirely
    total_replicas = sum(t.replicas for t in tasks)
    return VCJob(
        name=meta["name"],
        namespace=meta.get("namespace", "default"),
        scheduler_name=spec.get("schedulerName", "volcano-tpu"),
        min_available=int(spec.get("minAvailable", total_replicas)),
        min_success=(int(spec["minSuccess"])
                     if "minSuccess" in spec else None),
        tasks=tasks,
        policies=_policies(spec.get("policies", [])),
        plugins={k: list(v or []) for k, v in plugins.items()},
        queue=spec.get("queue", "default"),
        max_retry=int(spec.get("maxRetry", 3)),
        ttl_seconds_after_finished=spec.get("ttlSecondsAfterFinished"),
        priority_class=spec.get("priorityClassName", ""),
        network_topology=network_topology,
    )


def load_jobs(path: str) -> List[VCJob]:
    """Load one or more Job manifests from a YAML file (--- separated)."""
    with open(path) as f:
        try:
            docs = [d for d in yaml.safe_load_all(f) if d]
        except yaml.YAMLError as e:
            raise ManifestError(f"invalid YAML in {path}: {e}") from e
    if not docs:
        raise ManifestError(f"no manifests in {path}")
    for d in docs:
        if not isinstance(d, dict):
            raise ManifestError(
                f"manifest documents must be mappings, got {type(d).__name__}")
    return [job_from_manifest(d) for d in docs]

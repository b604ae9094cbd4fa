"""Shared helpers for job plugins."""

from __future__ import annotations

from typing import List


def pod_name(job, task_name: str, index: int) -> str:
    return f"{job.name}-{task_name}-{index}"


def task_hostnames(job, task_name: str) -> List[str]:
    """Stable DNS-style hostnames for every replica of a task (the svc
    plugin's headless-service contract: <pod>.<job>.<ns>.svc)."""
    spec = job.task_by_name(task_name)
    if spec is None:
        return []
    return [f"{pod_name(job, task_name, i)}.{job.name}.{job.namespace}.svc"
            for i in range(spec.replicas)]


def all_hostnames(job) -> List[str]:
    out = []
    for spec in job.tasks:
        out.extend(task_hostnames(job, spec.name))
    return out


def set_env(pod, name: str, value: str):
    for c in pod.containers + pod.init_containers:
        c.env[name] = value

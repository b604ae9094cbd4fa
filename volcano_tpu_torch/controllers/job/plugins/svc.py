"""svc plugin — headless service + hosts config (reference: plugins/svc).

Creates the job's headless Service record and a hosts ConfigMap listing
every task replica's stable hostname, and injects VC_<TASK>_HOSTS /
VC_<TASK>_NUM env into each pod.
"""

from __future__ import annotations

from volcano_tpu_torch.api.types import JOB_NAME_LABEL
from volcano_tpu_torch.controllers.job.plugins import JobPlugin, register_job_plugin
from volcano_tpu_torch.controllers.job.plugins.util import set_env, task_hostnames


@register_job_plugin("svc")
class SvcPlugin(JobPlugin):
    name = "svc"

    def on_job_add(self, job, cluster):
        key = f"{job.namespace}/{job.name}"
        cluster.put_object("service", {
            "name": job.name, "namespace": job.namespace,
            "headless": True, "selector": {JOB_NAME_LABEL: job.name},
        }, key=key)
        hosts = {f"{spec.name}.host": "\n".join(task_hostnames(job, spec.name))
                 for spec in job.tasks}
        cluster.put_object("config_map", hosts, key=f"{key}-svc")

    def on_job_delete(self, job, cluster):
        key = f"{job.namespace}/{job.name}"
        cluster.delete_object("service", key)
        cluster.delete_object("config_map", f"{key}-svc")

    def on_pod_create(self, pod, job):
        for spec in job.tasks:
            env_name = spec.name.upper().replace("-", "_")
            set_env(pod, f"VC_{env_name}_HOSTS",
                    ",".join(task_hostnames(job, spec.name)))
            set_env(pod, f"VC_{env_name}_NUM", str(spec.replicas))
        pod.labels.setdefault(JOB_NAME_LABEL, job.name)

"""env plugin — task identity env vars (reference: plugins/env)."""

from __future__ import annotations

from volcano_tpu_torch.controllers.job.plugins import JobPlugin, register_job_plugin
from volcano_tpu_torch.controllers.job.plugins.util import set_env


@register_job_plugin("env")
class EnvPlugin(JobPlugin):
    name = "env"

    def on_pod_create(self, pod, job):
        set_env(pod, "VC_TASK_INDEX", str(pod.task_index))
        set_env(pod, "VK_TASK_INDEX", str(pod.task_index))  # legacy alias
        set_env(pod, "VC_TASK_NAME", pod.task_spec)
        set_env(pod, "VC_JOB_NAME", job.name)
        set_env(pod, "VC_JOB_NAMESPACE", job.namespace)

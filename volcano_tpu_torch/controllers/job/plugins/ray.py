"""ray plugin — head/worker bootstrap
(reference: plugins/distributed-framework/ray)."""

from __future__ import annotations

from volcano_tpu_torch.controllers.job.plugins import JobPlugin, register_job_plugin
from volcano_tpu_torch.controllers.job.plugins.util import set_env, task_hostnames

DEFAULT_PORT = 6379


@register_job_plugin("ray")
class RayPlugin(JobPlugin):
    name = "ray"

    def __init__(self, arguments=None):
        super().__init__(arguments)
        self.head = "head"
        self.port = DEFAULT_PORT
        for arg in self.arguments:
            if arg.startswith("--head="):
                self.head = arg.split("=", 1)[1]
            elif arg.startswith("--port="):
                self.port = int(arg.split("=", 1)[1])

    def on_pod_create(self, pod, job):
        heads = task_hostnames(job, self.head)
        if not heads:
            return
        set_env(pod, "RAY_HEAD_ADDRESS", f"{heads[0]}:{self.port}")
        if pod.task_spec == self.head:
            set_env(pod, "RAY_NODE_TYPE", "head")
        else:
            set_env(pod, "RAY_NODE_TYPE", "worker")

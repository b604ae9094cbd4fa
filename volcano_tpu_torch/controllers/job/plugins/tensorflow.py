"""tensorflow plugin — TF_CONFIG cluster spec
(reference: plugins/distributed-framework/tensorflow)."""

from __future__ import annotations

import json

from volcano_tpu_torch.controllers.job.plugins import JobPlugin, register_job_plugin
from volcano_tpu_torch.controllers.job.plugins.util import set_env, task_hostnames

DEFAULT_PORT = 2222


@register_job_plugin("tensorflow")
class TensorflowPlugin(JobPlugin):
    name = "tensorflow"

    ROLES = ("ps", "worker", "chief", "evaluator")

    def __init__(self, arguments=None):
        super().__init__(arguments)
        self.port = DEFAULT_PORT
        for arg in self.arguments:
            if arg.startswith("--port="):
                self.port = int(arg.split("=", 1)[1])

    def on_pod_create(self, pod, job):
        cluster = {}
        for spec in job.tasks:
            if spec.name in self.ROLES:
                cluster[spec.name] = [f"{h}:{self.port}"
                                      for h in task_hostnames(job, spec.name)]
        if not cluster:
            return
        tf_config = {
            "cluster": cluster,
            "task": {"type": pod.task_spec, "index": pod.task_index},
        }
        set_env(pod, "TF_CONFIG", json.dumps(tf_config, sort_keys=True))

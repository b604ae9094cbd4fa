"""pytorch plugin — DDP rendezvous env.

Reference parity: plugins/distributed-framework/pytorch/pytorch.go:
46-52,91,208 (MASTER_ADDR/MASTER_PORT/WORLD_SIZE/RANK; master task
defaults to "master", workers rank after masters).
"""

from __future__ import annotations

from volcano_tpu_torch.controllers.job.plugins import JobPlugin, register_job_plugin
from volcano_tpu_torch.controllers.job.plugins.util import set_env, task_hostnames

DEFAULT_PORT = 23456


@register_job_plugin("pytorch")
class PytorchPlugin(JobPlugin):
    name = "pytorch"

    def __init__(self, arguments=None):
        super().__init__(arguments)
        self.master = "master"
        self.worker = "worker"
        self.port = DEFAULT_PORT
        for arg in self.arguments:
            if arg.startswith("--master="):
                self.master = arg.split("=", 1)[1]
            elif arg.startswith("--worker="):
                self.worker = arg.split("=", 1)[1]
            elif arg.startswith("--port="):
                self.port = int(arg.split("=", 1)[1])

    def on_pod_create(self, pod, job):
        master_hosts = task_hostnames(job, self.master)
        if not master_hosts:
            return
        master_spec = job.task_by_name(self.master)
        n_masters = master_spec.replicas if master_spec else 1
        worker_spec = job.task_by_name(self.worker)
        n_workers = worker_spec.replicas if worker_spec else 0

        set_env(pod, "MASTER_ADDR", master_hosts[0])
        set_env(pod, "MASTER_PORT", str(self.port))
        set_env(pod, "WORLD_SIZE", str(n_masters + n_workers))
        if pod.task_spec == self.master:
            set_env(pod, "RANK", str(pod.task_index))
        elif pod.task_spec == self.worker:
            set_env(pod, "RANK", str(n_masters + pod.task_index))

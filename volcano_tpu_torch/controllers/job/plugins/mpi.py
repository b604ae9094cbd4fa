"""mpi plugin — hostfile + ssh wiring
(reference: plugins/distributed-framework/mpi)."""

from __future__ import annotations

from volcano_tpu_torch.controllers.job.plugins import (
    JobPlugin,
    get_job_plugin,
    register_job_plugin,
)
from volcano_tpu_torch.controllers.job.plugins.util import set_env, task_hostnames


@register_job_plugin("mpi")
class MPIPlugin(JobPlugin):
    name = "mpi"

    def __init__(self, arguments=None):
        super().__init__(arguments)
        self.master = "master"
        self.worker = "worker"
        self.port = 22
        for arg in self.arguments:
            if arg.startswith("--master="):
                self.master = arg.split("=", 1)[1]
            elif arg.startswith("--worker="):
                self.worker = arg.split("=", 1)[1]
            elif arg.startswith("--port="):
                self.port = int(arg.split("=", 1)[1])

    def on_job_add(self, job, cluster):
        # mpi requires the ssh keypair secret
        get_job_plugin("ssh").on_job_add(job, cluster)
        hosts = task_hostnames(job, self.worker)
        cluster.put_object("config_map", {
            "hostfile": "\n".join(f"{h} slots=1" for h in hosts),
        }, key=f"{job.namespace}/{job.name}-mpi-hostfile")

    def on_job_delete(self, job, cluster):
        # symmetric with on_job_add: the ssh secret we created goes too
        get_job_plugin("ssh").on_job_delete(job, cluster)
        cluster.delete_object("config_map",
                              f"{job.namespace}/{job.name}-mpi-hostfile")

    def on_pod_create(self, pod, job):
        set_env(pod, "MPI_HOST",
                ",".join(task_hostnames(job, self.worker)))
        set_env(pod, "MPI_HOSTFILE", "/etc/volcano/mpi/hostfile")
        if pod.task_spec == self.master:
            set_env(pod, "MPI_MASTER", "1")

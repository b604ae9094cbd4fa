"""Job plugins — inject rendezvous/bootstrap config into pods.

Reference parity: pkg/controllers/job/plugins (env, svc, ssh,
distributed-framework: pytorch/tensorflow/mpi/ray).  GPU addition: the
`torch` plugin (the counterpart of the reference's `jax` plugin) emits
TPU_WORKER_ID / TPU_WORKER_HOSTNAMES / COORDINATOR_ADDRESS so the
port's torch.distributed workers self-assemble with no ssh.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

JOB_PLUGIN_BUILDERS: Dict[str, Callable] = {}


class JobPlugin:
    """Hooks called by the job controller during materialization."""

    name = "plugin"

    def __init__(self, arguments: Optional[List[str]] = None):
        self.arguments = list(arguments or [])

    def on_pod_create(self, pod, job) -> None:  # noqa: B027
        """Mutate a pod template instance before creation."""

    def on_job_add(self, job, cluster) -> None:  # noqa: B027
        """Create side artifacts (services, secrets) when job starts."""

    def on_job_delete(self, job, cluster) -> None:  # noqa: B027
        """Clean up side artifacts."""


def register_job_plugin(name: str):
    def _do(cls):
        JOB_PLUGIN_BUILDERS[name] = cls
        return cls
    return _do


def get_job_plugin(name: str, arguments=None) -> Optional[JobPlugin]:
    _ensure()
    builder = JOB_PLUGIN_BUILDERS.get(name)
    return builder(arguments) if builder else None


def job_plugin_exists(name: str) -> bool:
    _ensure()
    return name in JOB_PLUGIN_BUILDERS


_loaded = False


def _ensure():
    global _loaded
    if _loaded:
        return
    _loaded = True
    import volcano_tpu_torch.controllers.job.plugins.env        # noqa: F401
    import volcano_tpu_torch.controllers.job.plugins.svc        # noqa: F401
    import volcano_tpu_torch.controllers.job.plugins.ssh        # noqa: F401
    import volcano_tpu_torch.controllers.job.plugins.torch_plugin  # noqa: F401
    import volcano_tpu_torch.controllers.job.plugins.pytorch    # noqa: F401
    import volcano_tpu_torch.controllers.job.plugins.tensorflow # noqa: F401
    import volcano_tpu_torch.controllers.job.plugins.mpi        # noqa: F401
    import volcano_tpu_torch.controllers.job.plugins.ray        # noqa: F401

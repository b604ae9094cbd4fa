"""torch plugin — torch.distributed process-grid bootstrap for GPUs.

The counterpart of the reference's `jax` plugin, for the port's
workers: every worker pod gets

    TPU_WORKER_ID        - its GLOBAL process index across all slices
    TPU_WORKER_HOSTNAMES - all worker hostnames, comma separated
    COORDINATOR_ADDRESS  - worker 0 host:port, the TCP rendezvous
    NUM_PROCESSES        - total worker replica count

plus the `nvidia.com/gpu` toleration GPU node pools are tainted with,
so no ssh, no hostfile and no MASTER_ADDR/RANK vars are needed — the
worker forms its nccl group from these (consumed by
volcano_tpu_torch.workloads.bootstrap; the names are the reference's,
which the port's worker reads unchanged).

Multi-slice: a job whose worker tasks carry subGroupPolicy
memberships (TaskSpec.subgroup — each subgroup is gang-placed into
its own NVLink domain by the scheduler's topology_alloc) is ONE
torch.distributed job spanning every domain; each pod additionally
gets

    TPU_SLICE_ID         - index of its subgroup (spec order)
    TPU_NUM_SLICES       - number of subgrouped worker tasks

so the workload builds a hybrid mesh (mesh.make_hybrid_mesh) with dp
over the IB fabric (its dcn axis) and fsdp/tp/sp inside the NVLink
domain.  This closes the loop on the scheduler's multi-domain
placement: the domains subGroupPolicy buys are the slices the dcn axis
spans (scheduling/v1beta1 types.go:173-223 subGroupPolicy analogue).
"""

from __future__ import annotations

from volcano_tpu_torch.api.pod import Toleration
from volcano_tpu_torch.api.resource import GPU
from volcano_tpu_torch.controllers.job.plugins import JobPlugin, register_job_plugin
from volcano_tpu_torch.controllers.job.plugins.util import set_env, task_hostnames

DEFAULT_PORT = 8476


@register_job_plugin("torch")
class TorchPlugin(JobPlugin):
    name = "torch"

    def __init__(self, arguments=None):
        super().__init__(arguments)
        self.port = DEFAULT_PORT
        self.worker_task = ""
        for arg in self.arguments:
            if arg.startswith("--port="):
                self.port = int(arg.split("=", 1)[1])
            elif arg.startswith("--worker-task="):
                self.worker_task = arg.split("=", 1)[1]

    def _worker_task_name(self, job) -> str:
        if self.worker_task:
            return self.worker_task
        for spec in job.tasks:
            if spec.name in ("worker", "workers"):
                return spec.name
        return job.tasks[0].name if job.tasks else ""

    def _worker_tasks(self, job):
        """The task groups that form the process grid, ordered so
        same-slice processes are CONTIGUOUS in the global rank space
        (group_by_slice's sequential fallback depends on that).  A
        slice is one scheduler-placed subgroup domain — multiple
        tasks may share a subgroup (controller.py dedups subgroups by
        name into one SubGroupPolicy each), so slice ids key on
        DISTINCT subgroup names in spec order, not on tasks.  Returns
        [(task, slice_id)]; single-slice jobs get the lone worker
        task with slice_id 0."""
        subgroups = []              # distinct, spec order
        for t in job.tasks:
            if t.subgroup and t.subgroup not in subgroups:
                subgroups.append(t.subgroup)
        if subgroups:
            # even ONE subgroup spanning several tasks is a process
            # grid over all of them (a single-slice gang): falling
            # back to the first task would strand the others with no
            # worker id and a too-small NUM_PROCESSES
            order = {sg: i for i, sg in enumerate(subgroups)}
            sliced = [t for t in job.tasks if t.subgroup]
            sliced.sort(key=lambda t: order[t.subgroup])  # stable
            return [(t, order[t.subgroup]) for t in sliced]
        name = self._worker_task_name(job)
        return [(t, 0) for t in job.tasks if t.name == name]

    def on_pod_create(self, pod, job):
        # failover resume contract (api/slicehealth.py -> workloads/
        # bootstrap.py): a job carrying a checkpoint dir passes it to
        # every worker; after a slice-failure drain the failover
        # controller stamps the resume step, so the rebuilt gang's
        # workers restore from their checkpoint instead of recomputing
        # step 0
        from volcano_tpu_torch.api.slicehealth import (
            CHECKPOINT_DIR_ANNOTATION, RESUME_STEP_ANNOTATION)
        ckpt_dir = job.annotations.get(CHECKPOINT_DIR_ANNOTATION)
        if ckpt_dir:
            set_env(pod, "VTP_CHECKPOINT_DIR", ckpt_dir)
        resume_step = job.annotations.get(RESUME_STEP_ANNOTATION)
        if resume_step:
            set_env(pod, "VTP_RESUME_STEP", resume_step)
        # goodput observatory (api/goodput.py): a job declaring a
        # progress dir gets a per-pod progress-file path plus the
        # restart/resize epoch (failover generation + elastic
        # generation — any drain bumps one of them) so the agent's
        # collector can tell a resumed step counter from a rollback
        from volcano_tpu_torch.api.goodput import (
            ENV_EPOCH, ENV_PROGRESS_FILE, PROGRESS_DIR_ANNOTATION,
            progress_file_for)
        from volcano_tpu_torch.api.slicehealth import (
            FAILOVER_GENERATION_ANNOTATION)
        from volcano_tpu_torch.api import elastic as _eapi

        def _int_ann(key: str) -> int:
            try:
                return int(job.annotations.get(key, 0) or 0)
            except (TypeError, ValueError):
                return 0

        progress_dir = job.annotations.get(PROGRESS_DIR_ANNOTATION)
        if progress_dir:
            set_env(pod, ENV_PROGRESS_FILE,
                    progress_file_for(progress_dir, pod.uid))
            set_env(pod, ENV_EPOCH, str(
                _int_ann(FAILOVER_GENERATION_ANNOTATION)
                + _int_ann(_eapi.ELASTIC_GENERATION_ANNOTATION)))
        # serving plane (api/serving.py): same contract, different
        # record — a serving-class job declaring a stats dir gets a
        # per-pod stats-file path plus the same restart/resize epoch
        from volcano_tpu_torch.api.serving import (
            ENV_STATS_FILE, STATS_DIR_ANNOTATION, stats_file_for)
        stats_dir = job.annotations.get(STATS_DIR_ANNOTATION)
        if stats_dir:
            set_env(pod, ENV_STATS_FILE,
                    stats_file_for(stats_dir, pod.uid))
            set_env(pod, ENV_EPOCH, str(
                _int_ann(FAILOVER_GENERATION_ANNOTATION)
                + _int_ann(_eapi.ELASTIC_GENERATION_ANNOTATION)))

        tasks = self._worker_tasks(job)
        num_slices = len({sid for _, sid in tasks})
        hostnames = []
        for t, _ in tasks:
            hostnames.extend(task_hostnames(job, t.name))
        if not hostnames:
            return
        set_env(pod, "TPU_WORKER_HOSTNAMES", ",".join(hostnames))
        set_env(pod, "COORDINATOR_ADDRESS",
                f"{hostnames[0]}:{self.port}")
        set_env(pod, "NUM_PROCESSES", str(len(hostnames)))
        # elastic jobs: the CURRENT slice count (resized by the
        # elastic controller) defines the dcn axis — rank blocks of
        # pods-per-slice map onto slices, so the workload's hybrid
        # mesh follows every resize without a subgroup per slice
        from volcano_tpu_torch.api import elastic as eapi
        elastic_slices = (eapi.current_slices(job)
                          if eapi.is_elastic(job) and not num_slices > 1
                          else 0)
        offset = 0
        for t, slice_id in tasks:
            if pod.task_spec == t.name:
                global_id = offset + pod.task_index
                set_env(pod, "TPU_WORKER_ID", str(global_id))
                if num_slices > 1:
                    set_env(pod, "TPU_SLICE_ID", str(slice_id))
                    set_env(pod, "TPU_NUM_SLICES", str(num_slices))
                elif elastic_slices > 1 and \
                        len(hostnames) % elastic_slices == 0:
                    per_slice = len(hostnames) // elastic_slices
                    set_env(pod, "TPU_SLICE_ID",
                            str(global_id // per_slice))
                    set_env(pod, "TPU_NUM_SLICES",
                            str(elastic_slices))
                if eapi.is_elastic(job):
                    self._set_global_batch(pod, job, t,
                                           len(hostnames))
                break
            offset += t.replicas

        # ride GPU node-pool taints without user boilerplate
        requests_gpu = any(
            float(c.requests.get(GPU, 0) or 0) > 0 for c in pod.containers)
        if requests_gpu and not any(t.key == GPU for t in pod.tolerations):
            pod.tolerations.append(
                Toleration(key=GPU, operator="Exists",
                           effect="NoSchedule"))

    @staticmethod
    def _set_global_batch(pod, job, task_spec, num_workers: int):
        """Pin WORKER_GLOBAL_BATCH across resizes: the same
        samples-per-step at ANY world size is what makes a
        dp-dimension shrink/grow loss-continuous.  An explicit
        annotation wins; the default is one sample per device at the
        FLOOR world (min-slices x pods-per-slice x GPUs-per-pod) —
        a constant derived only from resize-invariant quantities."""
        from volcano_tpu_torch.api import elastic as eapi
        explicit = job.annotations.get(
            eapi.ELASTIC_GLOBAL_BATCH_ANNOTATION)
        if explicit:
            set_env(pod, "WORKER_GLOBAL_BATCH", str(explicit))
            return
        rng = eapi.elastic_range(job)
        cur = eapi.current_slices(job)
        if rng is None or num_workers <= 0 or num_workers % cur:
            return
        per_pod = int(float(task_spec.template_pod()
                            .resource_requests().get(GPU) or 0))
        if per_pod <= 0:
            return
        pods_per_slice = num_workers // cur
        set_env(pod, "WORKER_GLOBAL_BATCH",
                str(rng[0] * pods_per_slice * per_pod))

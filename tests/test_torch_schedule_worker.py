"""The port's worker scheduled by the port's own control plane: a vcjob
on NVLink domains of H100 hosts, placed by the port's scheduler, its
pods' env injected by the `torch` job plugin, each pod launched as
`python -m volcano_tpu_torch.workloads.worker` on gloo
(WORKER_DEVICE=cpu).  The counterparts of
`test_torch_worker.py::test_scheduled_pods_launch_port_workers` and
its multislice case, which schedule through the reference.
"""

from test_torch_worker import PRINTED, SHARE, _launch_workers, \
    _one_process_loss
from volcano_tpu_torch.api.pod import Container, Pod
from volcano_tpu_torch.api.resource import GPU
from volcano_tpu_torch.api.types import JobPhase
from volcano_tpu_torch.api.vcjob import TaskSpec, VCJob
from volcano_tpu_torch.controllers import ControllerManager
from volcano_tpu_torch.scheduler import Scheduler
from volcano_tpu_torch.simulator import make_gpu_cluster
from volcano_tpu_torch.webhooks.admission import default_admission
from volcano_tpu_torch.workloads import bootstrap as tboot

# what the torch plugin injects and the port's bootstrap reads
CONTRACT = {tboot.ENV_WORKER_ID, tboot.ENV_HOSTNAMES, tboot.ENV_COORDINATOR,
            tboot.ENV_NUM_PROCESSES}


def _schedule(cluster, job):
    cluster.admission = default_admission()
    mgr = ControllerManager(cluster, enabled=["job", "queue"])
    sched = Scheduler(cluster, schedule_period=0)
    job = cluster.add_vcjob(job)
    for _ in range(3):
        mgr.sync_all()
        sched.run_once()
        cluster.tick()
    job = cluster.vcjobs[job.key]
    assert job.phase is JobPhase.RUNNING
    return job


def _pods(cluster, job, key):
    pods = sorted((p for p in cluster.pods.values() if p.owner == job.uid),
                  key=key)
    assert all(p.node_name for p in pods)
    assert all(CONTRACT <= set(p.containers[0].env) for p in pods)
    assert all(any(t.key == GPU for t in p.tolerations) for p in pods)
    return pods


def _task(name, replicas, subgroup=""):
    return TaskSpec(name=name, replicas=replicas, subgroup=subgroup,
                    template=Pod(name="t", containers=[
                        Container(requests={"cpu": 4, GPU: 8})]))


def test_port_scheduled_pods_launch_port_workers():
    """Two whole hosts of a DGX H100 NVLink domain; the ranks' loss is
    global and equals one process's step on the whole global batch."""
    cluster = make_gpu_cluster([("nvl", "dgx-h100-256")])
    job = _schedule(cluster, VCJob(name="mesh", min_available=2,
                                   tasks=[_task("worker", 2)],
                                   plugins={"torch": [], "svc": []}))
    workers = _pods(cluster, job, key=lambda p: p.task_index)
    assert len(workers) == 2
    assert {p.node_name.split("-w")[0] for p in workers} == {"nvl"}
    results = _launch_workers(workers)
    for rank, res in enumerate(results):
        assert res["process_id"] == rank
        assert res["num_processes"] == 2
        assert res["device_count"] == 2
        assert res["collective_sum"] == 2.0
        assert (res["slice_id"], res["num_slices"]) == (0, 1)
    assert results[0]["loss"] == results[1]["loss"]
    assert abs(results[0]["loss"] - _one_process_loss(2, 2)) <= \
        PRINTED + SHARE


def test_port_scheduled_multidomain_job_trains_across_fabrics():
    """Two subgroups on two HGX H100 hosts in two IB fabrics: each
    worker builds the hybrid mesh from TPU_SLICE_ID/TPU_NUM_SLICES and
    reduces its gradients across the dcn axis."""
    cluster = make_gpu_cluster([("na", "hgx-h100-8"), ("nb", "hgx-h100-8")],
                               ib_fabrics={"na": "ib-a", "nb": "ib-b"})
    job = _schedule(cluster, VCJob(
        name="multi", min_available=2,
        tasks=[_task("dom-a", 1, "dom-a"), _task("dom-b", 1, "dom-b")],
        plugins={"torch": [], "svc": []}))
    workers = _pods(cluster, job, key=lambda p: p.task_spec)
    assert {p.node_name for p in workers} == {"na-w0", "nb-w0"}
    results = _launch_workers(workers)
    for rank, res in enumerate(results):
        assert res["process_id"] == rank
        assert (res["slice_id"], res["num_slices"]) == (rank, 2)
        assert res["collective_sum"] == 2.0
    assert results[0]["loss"] == results[1]["loss"]
    assert abs(results[0]["loss"] - _one_process_loss(2, 2)) <= \
        PRINTED + SHARE

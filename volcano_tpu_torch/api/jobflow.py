"""JobFlow / JobTemplate CRD types (flow/v1alpha1 analogue).

Reference parity: staging/.../flow/v1alpha1/jobflow_types.go:34-51
(Flow{name, dependsOn{targets, probes}, patch}) and JobTemplate.
"""

from __future__ import annotations

import enum
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from volcano_tpu_torch.api.pod import new_uid
from volcano_tpu_torch.api.vcjob import VCJob


class JobFlowPhase(enum.Enum):
    PENDING = "Pending"
    RUNNING = "Running"
    SUCCEED = "Succeed"
    TERMINATING = "Terminating"
    FAILED = "Failed"


@dataclass
class FlowDependsOn:
    targets: List[str] = field(default_factory=list)
    # probes relax the default "target Completed" gate: a dependency is
    # satisfied once the target reaches the probed phase (reference
    # flow/v1alpha1 DependsOn.Probes — status-based analogue of its
    # HTTP/TCP pod probes).  e.g. [{"phase": "Running"}]
    probes: List[dict] = field(default_factory=list)


@dataclass
class Flow:
    """One step of the DAG: deploy job from template *name* once every
    target dependency has Completed."""

    name: str                     # job template name
    depends_on: Optional[FlowDependsOn] = None
    patch: Dict[str, object] = field(default_factory=dict)
    # ^ shallow spec overrides applied to the template (e.g. queue)


@dataclass
class JobTemplate:
    name: str
    namespace: str = "default"
    uid: str = field(default_factory=new_uid)
    job: Optional[VCJob] = None   # the vcjob spec to stamp out

    # status: names of live jobs stamped from this template
    # (reference JobTemplateStatus.JobDependsOnList)
    job_depends_on_list: List[str] = field(default_factory=list)

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}"


@dataclass
class JobFlow:
    name: str
    namespace: str = "default"
    uid: str = field(default_factory=new_uid)
    flows: List[Flow] = field(default_factory=list)
    job_retain_policy: str = "retain"   # retain | delete

    phase: JobFlowPhase = JobFlowPhase.PENDING
    deployed_jobs: List[str] = field(default_factory=list)
    creation_time: float = field(default_factory=time.time)

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}"

    def job_name(self, flow_name: str) -> str:
        return f"{self.name}-{flow_name}"

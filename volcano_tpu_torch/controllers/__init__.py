"""Controllers (reference: pkg/controllers).

Each controller reconciles one CRD family against the Cluster.  The
controller manager runs them on a shared loop (see
volcano_tpu_torch.controllers.framework).  Registered here: job,
queue, podgroup, hypernode, sharding and cronjob; the other
controllers of `volcano_tpu` (elastic, failover, hyperjob, jobflow,
serving, colocation, garbagecollector) are not ported yet.
"""

from volcano_tpu_torch.controllers.framework import (
    Controller, ControllerManager, register_controller, CONTROLLERS,
)

# import controller modules so their @register_controller side effects
# run (reference: controller registry blank imports)
import volcano_tpu_torch.controllers.hypernode         # noqa: E402,F401
import volcano_tpu_torch.controllers.job.controller    # noqa: E402,F401
import volcano_tpu_torch.controllers.podgroup          # noqa: E402,F401
import volcano_tpu_torch.controllers.queue             # noqa: E402,F401
import volcano_tpu_torch.controllers.cronjob           # noqa: E402,F401
import volcano_tpu_torch.controllers.sharding          # noqa: E402,F401

__all__ = ["Controller", "ControllerManager", "register_controller",
           "CONTROLLERS"]

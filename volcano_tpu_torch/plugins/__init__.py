"""Scheduling plugins (reference: pkg/scheduler/plugins, 24 registered).

Importing this package registers every plugin builder
(reference: plugins/factory.go).
"""

import volcano_tpu_torch.plugins.gang          # noqa: F401
import volcano_tpu_torch.plugins.priority      # noqa: F401
import volcano_tpu_torch.plugins.conformance   # noqa: F401
import volcano_tpu_torch.plugins.drf           # noqa: F401
import volcano_tpu_torch.plugins.proportion    # noqa: F401
import volcano_tpu_torch.plugins.overcommit    # noqa: F401
import volcano_tpu_torch.plugins.predicates    # noqa: F401
import volcano_tpu_torch.plugins.interpodaffinity  # noqa: F401
import volcano_tpu_torch.plugins.nodeorder     # noqa: F401
import volcano_tpu_torch.plugins.binpack       # noqa: F401
import volcano_tpu_torch.plugins.deviceshare   # noqa: F401
import volcano_tpu_torch.plugins.topology      # noqa: F401
import volcano_tpu_torch.plugins.capacity      # noqa: F401
import volcano_tpu_torch.plugins.sla           # noqa: F401
import volcano_tpu_torch.plugins.pdb           # noqa: F401
import volcano_tpu_torch.plugins.cdp           # noqa: F401
import volcano_tpu_torch.plugins.tdm           # noqa: F401
import volcano_tpu_torch.plugins.nodegroup     # noqa: F401
import volcano_tpu_torch.plugins.usage         # noqa: F401
import volcano_tpu_torch.plugins.resourcequota # noqa: F401
import volcano_tpu_torch.plugins.tasktopology  # noqa: F401
import volcano_tpu_torch.plugins.resource_strategy_fit  # noqa: F401
import volcano_tpu_torch.plugins.numaaware     # noqa: F401
import volcano_tpu_torch.plugins.extender      # noqa: F401
import volcano_tpu_torch.plugins.rescheduling  # noqa: F401
import volcano_tpu_torch.plugins.failover      # noqa: F401
import volcano_tpu_torch.plugins.elastic       # noqa: F401
import volcano_tpu_torch.plugins.datalocality  # noqa: F401
import volcano_tpu_torch.plugins.volumebinding # noqa: F401
import volcano_tpu_torch.plugins.dra           # noqa: F401
import volcano_tpu_torch.plugins.serving       # noqa: F401

"""Scheduling plugins (reference: pkg/scheduler/plugins).

Importing this package registers the plugin builders the default conf
names, plus the network-topology plugin (reference:
plugins/factory.go).  The other plugins of `volcano_tpu` are not
ported yet: a conf naming them gets the framework's handling of an
unknown plugin (a warning, and the plugin is skipped).
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
import volcano_tpu_torch.plugins.failover      # noqa: F401
import volcano_tpu_torch.plugins.elastic       # noqa: F401
import volcano_tpu_torch.plugins.volumebinding # noqa: F401

"""Worker-side progress publishing — the port's copy of
`volcano_tpu.workloads.progress`, reading the port's own goodput
constants (`volcano_tpu_torch.api.goodput`).

The ProgressReporter publishes one small JSON record per train step to
the path the job plugin injected as VTP_PROGRESS_FILE:

    {"step": 1042, "examples": 266752.0, "ts": 1754300000.123,
     "epoch": 3}

* atomically replaced (tmp + rename) so the node agent's collector
  never reads a torn record;
* `step` is the GLOBAL optimizer step — after a failover/elastic
  resume it continues from the checkpoint floor, which is why the
  record also carries `epoch` (VTP_EPOCH, the control plane's
  restart/resize generation);
* best-effort by design: a worker that cannot write progress keeps
  training — observability must never fail the workload;
* one writer per pod: of a pod's several processes (one a GPU,
  `bootstrap.local_layout`) only the first publishes, as the
  reference's one process a pod does.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

from volcano_tpu_torch.api.goodput import ENV_EPOCH, ENV_PROGRESS_FILE


class ProgressReporter:
    """Writes the per-pod progress record; None-safe factory so call
    sites can do `r = ProgressReporter.from_env(); r and r.report()`
    (None also for a pod's processes after its first).
    """

    __slots__ = ("path", "epoch", "_now")

    def __init__(self, path: str, epoch: int = 0, now=time.time):
        self.path = path
        self.epoch = int(epoch)
        self._now = now

    @classmethod
    def from_env(cls, environ=None) -> Optional["ProgressReporter"]:
        # here, not at import: the node agents and the chaos tools write
        # progress records on hosts without torch
        from volcano_tpu_torch.workloads.bootstrap import local_layout
        env = os.environ if environ is None else environ
        path = env.get(ENV_PROGRESS_FILE, "")
        if not path or local_layout(env)[0] != 0:
            return None
        try:
            epoch = int(env.get(ENV_EPOCH, 0) or 0)
        except (TypeError, ValueError):
            epoch = 0          # malformed env must not kill the worker
        return cls(path, epoch=epoch)

    def report(self, step: int, examples: float = 0.0) -> bool:
        """Publish one progress record; returns False when the path
        is unwritable (and keeps trying on later calls — a progress
        volume may mount after the worker starts)."""
        record = {"step": int(step), "examples": float(examples),
                  "ts": round(self._now(), 6), "epoch": self.epoch}
        tmp = f"{self.path}.tmp.{os.getpid()}"
        try:
            os.makedirs(os.path.dirname(self.path) or ".",
                        exist_ok=True)
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(record, f)
            os.replace(tmp, self.path)   # atomic: never a torn read
            return True
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                # vtplint: disable=except-pass (cleanup of a failed tmp write; the False below is the classification)
                pass           # the tmp write itself failed: nothing to remove
            return False

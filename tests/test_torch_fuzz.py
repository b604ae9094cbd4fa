"""The port's whole-scheduler churn fuzz (`volcano_tpu_torch.tools.churn`,
shared with `python -m volcano_tpu_torch.tools.fuzz_sweep`) against the
reference's (`tests/test_fuzz_scheduler.py`).

The reference test's four fixed seeds run through both packages'
`churn_episode` on mirrored clusters (each v5e slice an NVLink domain of
as many hosts of 4 GPUs, node names equal), the uid counters reset on
both sides so uid-ordered ties break alike.  Each side checks its
invariants after every cycle; the binds and the evictions of every cycle
must be equal.  Tolerance: exact.
"""

import itertools

import pytest

import test_fuzz_scheduler as ref_fuzz
import volcano_tpu.api.pod as rpod
import volcano_tpu_torch.api.pod as tpod
from volcano_tpu_torch.tools import churn

SEEDS = (7, 23, 404, 1719)     # test_fuzz_full_contention_pipeline's


def _episode(module, pod_module, seed, monkeypatch):
    """Run `module.churn_episode(seed)`; returns each cycle's new binds
    and evictions, read where the episode checks its invariants."""
    pod_module._uid_counter = itertools.count(1)
    cycles, seen = [], [0, 0]
    check = module.check_invariants

    def record(cluster):
        check(cluster)
        cycles.append((cluster.binds[seen[0]:],
                       cluster.evictions[seen[1]:]))
        seen[:] = [len(cluster.binds), len(cluster.evictions)]

    monkeypatch.setattr(module, "check_invariants", record)
    module.churn_episode(seed)
    return cycles


@pytest.mark.parametrize("seed", SEEDS)
def test_churn_episode_binds_and_evicts_as_reference(seed, monkeypatch):
    want = _episode(ref_fuzz, rpod, seed, monkeypatch)
    got = _episode(churn, tpod, seed, monkeypatch)
    assert len(got) == len(want) == 60
    assert sum(len(b) for b, _ in got) > 0
    for cycle, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"seed {seed} cycle {cycle}: {g} != {w}"

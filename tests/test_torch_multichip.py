"""The port's one-step parallelism matrix (`entry.dryrun_multichip`, the
counterpart of `__graft_entry__.dryrun_multichip`) on the CPU: one
spawned gloo group runs one training step of every family, with the
reference's two parity asserts (experts over slices against the flat
mesh within 5e-3, a stage per slice against flat pp2 within 2e-3)."""

import math

import pytest

from volcano_tpu_torch import entry

# the families the reference runs at each device count
FAMILIES = {
    8: ["dp2-fsdp2-tp2", "ring-sp2", "ring-sp4-long", "ulysses-sp4",
        "dcn2-fsdp2-tp2", "dcn2-sp2-ring", "moe-ep4", "moe-ep4-slices",
        "gpipe-pp4", "gpipe-pp2-slices"],
    4: ["dp1-fsdp1-tp4", "ring-sp4-long", "ulysses-sp4", "moe-ep2",
        "gpipe-pp4", "gpipe-pp2-slices"],
}


@pytest.mark.parametrize("n", [8, 4])
def test_dryrun_multichip_runs_every_family(n, capsys):
    """n gloo ranks: every family's loss is finite and positive (each
    rank checks its own), the parity asserts hold, and the reference's
    summary line is printed."""
    results = entry.dryrun_multichip(n, "cpu")
    assert list(results) == FAMILIES[n]
    assert all(math.isfinite(v) and v > 0 for v in results.values())
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line == f"dryrun_multichip({n}): " + " ".join(
        f"{k}:loss={v:.3f}" for k, v in results.items())

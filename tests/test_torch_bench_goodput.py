"""The port's bench `--goodput-smoke`: the goodput stream through a
real process control plane, as the reference's `bench.py
--goodput-smoke` test asserts it."""

from torch_procs import bench_ok, run_bench


def test_bench_goodput_smoke_mode():
    """Worker progress -> agent collector -> GoodputReport over the wire
    -> store fold -> podgroup annotations, through a REAL process
    control plane (state server + scheduler + controllers)."""
    out = bench_ok(*run_bench("--goodput-smoke", 300))
    assert out["ok"] is True, out
    assert out["fold_ok"] and out["steps_per_s"] > 0
    assert 0 < out["goodput"] <= 1
    # the node's generation comes from its GPU product label
    assert out["generation"] == "h100"

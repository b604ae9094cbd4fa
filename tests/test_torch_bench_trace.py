"""The port's bench `--trace-smoke`: the flight-recorder drill through
a real process control plane, as the reference's `bench.py
--trace-smoke` test asserts it."""

from torch_procs import bench_ok, run_bench


def test_bench_trace_smoke_mode():
    """A gang through the real process plane: lifecycle stamps,
    reconciliation (<5%) and trace flow."""
    out = bench_ok(*run_bench("--trace-smoke", 180))
    assert out["ok"] is True, out
    assert out["reconcile_err_max_pct"] < 5.0
    assert out["traces_captured"] > 0
    assert set(out["phase_p50_s"]) == {"queue", "schedule", "bind",
                                       "admit", "start"}

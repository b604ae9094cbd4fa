"""The port's bench `--sweep-smoke`: the process-pool sweep through a
real interpreter, as the reference's `bench.py --sweep-smoke` test
asserts it."""

from torch_procs import bench_ok, run_bench


def test_sweep_smoke_subprocess():
    """Process-pool sweep on a small cluster of NVLink domains:
    bit-identical entries and placements vs serial, real OS worker
    processes."""
    out = bench_ok(*run_bench("--sweep-smoke", 180))
    assert out["ok"] is True
    assert out["placements_identical"] is True
    assert out["entry_identical"] is True
    assert out["real_worker_processes"] is True
    assert out["synced_full_then_delta"] is True

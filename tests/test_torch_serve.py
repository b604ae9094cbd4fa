"""The port's serving replica (volcano_tpu_torch.workloads.serve)
against the JAX package's, on the CPU.

The stdlib parts are the port's own copy and must behave exactly as the
reference's.  One fault of the reference stands in the way: it seeds
`random.Random` with a tuple, which Python 3.11 and later refuse.  The
port seeds from the tuple's hash, as Python did before 3.11; the
comparisons here give the reference the same seeding through a stand-in
for its `random` module (ROADMAP queue C).
"""

import json
import random
import sys
import types

import pytest
import torch

from volcano_tpu.workloads import serve as jserve
from volcano_tpu_torch.workloads import serve as tserve

SEEDS = [0, 1, 7, 42]


def _hashed_random(key):
    if isinstance(key, tuple):
        key = hash(key) & 0xFFFFFFFFFFFFFFFF
    return random.Random(key)


@pytest.fixture
def reference_seeding(monkeypatch):
    monkeypatch.setattr(jserve, "random",
                        types.SimpleNamespace(Random=_hashed_random))


def test_reference_tuple_seed_fault_and_port_fix():
    traffic = jserve.DiurnalTraffic(5, 40, 10.0, seed=0)
    if sys.version_info >= (3, 11):
        with pytest.raises(TypeError):
            traffic.qps_at(1.0)
    port = tserve.DiurnalTraffic(5, 40, 10.0, seed=0)
    assert port.qps_at(1.0) == port.qps_at(1.0) > 0.0


@pytest.mark.parametrize("seed", SEEDS)
def test_diurnal_traffic_matches_reference(seed, reference_seeding):
    for jitter in (0.05, 0.0):
        kw = dict(base_qps=5, peak_qps=400, day_s=12.0, seed=seed,
                  jitter=jitter)
        ref, port = jserve.DiurnalTraffic(**kw), tserve.DiurnalTraffic(**kw)
        for i in range(60):
            t = i * 0.37
            assert port.qps_at(t) == ref.qps_at(t)
            assert port.arrivals(t, t + 0.2) == ref.arrivals(t, t + 0.2)
        assert port.arrivals(3.0, 3.0) == ref.arrivals(3.0, 3.0) == []
    assert tserve._poisson_arrivals(250.0, 1.0, 1.5, seed) == \
        jserve._poisson_arrivals(250.0, 1.0, 1.5, seed)


@pytest.mark.parametrize("seed", SEEDS)
def test_latency_window_matches_reference(seed):
    rng = random.Random(seed)
    for cap in (4, 64, 2048):
        ref, port = jserve.LatencyWindow(cap), tserve.LatencyWindow(cap)
        assert port.p99_ms == ref.p99_ms == 0.0
        for _ in range(200):
            x = rng.expovariate(0.1)
            ref.record(x)
            port.record(x)
        assert len(port) == len(ref)
        for q in (0.0, 0.5, 0.9, 0.99, 1.0):
            assert port.quantile(q) == ref.quantile(q)
        assert (port.p50_ms, port.p99_ms) == (ref.p50_ms, ref.p99_ms)


@pytest.mark.parametrize("seed", SEEDS)
def test_load_balancer_matches_reference(seed):
    rng = random.Random(seed)
    uids = [f"r{i}" for i in range(5)]
    ref, port = jserve.WeightedLoadBalancer(), tserve.WeightedLoadBalancer(
        alpha=0.4, floor_ms=1.0, max_skew=4.0)
    assert port.split(100.0, uids) == ref.split(100.0, uids)   # all cold
    for _ in range(40):
        uid = rng.choice(uids[:4])
        p99 = rng.choice([0.0, -1.0, "bad", rng.uniform(0.5, 90.0)])
        ref.observe(uid, p99)
        port.observe(uid, p99)
        assert port.latencies() == ref.latencies()
        total = rng.uniform(0, 500)
        assert port.split(total, uids) == ref.split(total, uids)
    ref.forget("r1")
    port.forget("r1")
    offered = {"a": 120.0, "b": 30.0, "c": 5.0}
    groups = {"a": uids[:3], "b": uids[3:], "c": []}
    assert port.route(offered, groups) == ref.route(offered, groups)
    assert port.split(10.0, []) == ref.split(10.0, []) == {}


@pytest.mark.parametrize("epoch", ["3", "", "junk"])
def test_stats_reporter_records_match_reference(tmp_path, epoch):
    env = {"VTP_SERVING_STATS_FILE": "", "VTP_EPOCH": epoch}
    assert tserve.ServingStatsReporter.from_env(env) is None
    records = []
    for name, mod in (("ref", jserve), ("port", tserve)):
        env["VTP_SERVING_STATS_FILE"] = str(tmp_path / name / "stats.json")
        rep = mod.ServingStatsReporter.from_env(env)
        rep._now = lambda: 1234.5678901
        assert rep.report(17, 15, 3.14159, 42.4242)
        records.append(json.loads((tmp_path / name / "stats.json")
                                  .read_text()))
    assert records[0] == records[1]
    blocked = tmp_path / "file"
    blocked.write_text("")
    rep = tserve.ServingStatsReporter(str(blocked / "stats.json"))
    assert rep.report(1, 1, 1.0, 1.0) is False   # best-effort, no raise


def test_batched_server_matches_reference():
    def clock():                          # 0, 1, 2, ... seconds a call
        ticks = iter(range(10_000))
        return lambda: float(next(ticks))

    sizes = {"ref": [], "port": []}
    servers = {name: mod.BatchedServer(sizes[name].append, max_batch=3,
                                       slo_ms=1500.0, now=clock())
               for name, mod in (("ref", jserve), ("port", tserve))}
    for name, srv in servers.items():
        for a in (0.0, 0.1, 0.5, 0.9, 1.0, 1.2, 4.0):
            srv.offer(a)
        assert srv.drain() == 7
    ref, port = servers["ref"], servers["port"]
    assert sizes["port"] == sizes["ref"] == [3, 3, 1]
    assert (port.requests, port.slo_ok) == (ref.requests, ref.slo_ok)
    assert port.serve_batch() == ref.serve_batch() == 0


def test_torch_forward_serves_through_batched_server():
    fwd = tserve.torch_forward(max_batch=4, device="cpu")
    logits = fwd(2)
    assert tuple(logits.shape) == (4, 16, 256)
    assert torch.isfinite(logits).all()
    assert torch.equal(fwd(4), logits)          # seeded params and tokens
    server = tserve.BatchedServer(fwd, max_batch=4, slo_ms=10_000.0)
    for i in range(10):
        server.offer(float(i))
    assert server.drain() == 10
    assert server.requests == 10 and len(server.latency) == 10


def test_run_returns_reference_keys(reference_seeding):
    short = {"SERVE_DURATION_S": "0.3", "SERVE_BEAT_S": "0.1"}
    ref = jserve.run(dict(short))
    port = tserve.run(dict(short))
    torch_run = tserve.run({**short, "SERVE_MODE": "torch",
                            "SERVE_DEVICE": "cpu"})
    assert set(port) == set(torch_run) == set(ref)
    assert torch_run["requests"] >= 0 and 0.0 <= torch_run["attainment"] <= 1


def test_bench_serve_smoke_mode():
    """`python -m volcano_tpu_torch.bench --serve-smoke` drives a traffic
    step -> replica stats -> REAL agents -> wire -> store fold ->
    autoscaler scale-up -> topology-aware burst preemption -> serving
    at 2 replicas, through a REAL process control plane."""
    from torch_procs import bench_ok, run_bench
    out = bench_ok(*run_bench("--serve-smoke", 300))
    assert out["ok"] is True, out
    assert out["no_premature_decision"] and out["victim_marker_seen"]
    assert out["replicas_final"] == 2
    assert out["pool_disjoint_from_victim"]

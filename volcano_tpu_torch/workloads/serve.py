"""Serving workload — batched-forward inference under a p99 SLO, on a GPU.

The port of `volcano_tpu.workloads.serve`.  `python -m
volcano_tpu_torch.workloads.serve` is a serving replica's entry point.
The traffic curve, the latency window, the stats reporter, the load
balancer, the batched server and `run` behave exactly as the
reference's (they are stdlib code, kept here as the port's own copy);
`torch_forward` takes the place of `jax_forward` and runs the flagship
model through PyTorch on the GPU (`SERVE_MODE=torch`, `SERVE_DEVICE`).

  1. arrivals land on a request queue (Poisson draws from the seeded
     diurnal curve, or a per-replica rate file that a front-end load
     balancer writes when it divides traffic across replicas);
  2. the BatchedServer drains the queue in batches of at most
     max_batch through one forward fn, and a request's latency is its
     queue wait plus its batch's forward time;
  3. every beat the ServingStatsReporter atomically publishes the
     CUMULATIVE request/SLO-ok ledgers plus windowed p50/p99 to the
     injected VTP_SERVING_STATS_FILE.

Stats publishing is best-effort by design: a replica that cannot write
stats keeps serving.
"""

from __future__ import annotations

import json
import math
import os
import random
import sys
import time
from collections import deque
from typing import Any, Callable, Deque, List, Optional


def _rng(key: tuple) -> random.Random:
    """A generator seeded from a tuple key.  The reference passes the
    tuple itself, which Python 3.11 and later refuse; before 3.11 the
    tuple's hash (as an unsigned 64-bit int) was the seed, so that is the
    seed here.  A tuple of ints and floats hashes the same in every
    process, so the curve still replays across processes."""
    return random.Random(hash(key) & 0xFFFFFFFFFFFFFFFF)


class DiurnalTraffic:
    """Seeded 24h traffic curve compressed into `day_s` bench seconds.

    The shape is the canonical consumer curve: trough in the early
    morning, peak in the late afternoon (a raised cosine between
    `base_qps` and `peak_qps`), plus deterministic per-beat jitter so
    two runs with one seed replay the same offered load.  `qps_at` is
    a pure function of (seed, t) — no internal state — so the bench
    and a replica can evaluate the same curve independently.
    """

    __slots__ = ("base_qps", "peak_qps", "day_s", "seed", "jitter",
                 "trough_frac")

    def __init__(self, base_qps: float, peak_qps: float, day_s: float,
                 seed: int = 0, jitter: float = 0.05,
                 trough_frac: float = 4.0 / 24.0):
        self.base_qps = float(base_qps)
        self.peak_qps = float(peak_qps)
        self.day_s = float(day_s)
        self.seed = int(seed)
        self.jitter = float(jitter)
        self.trough_frac = float(trough_frac)

    def qps_at(self, t: float) -> float:
        frac = (t % self.day_s) / self.day_s
        # raised cosine: 0 at the trough, 1 half a day later
        shape = 0.5 - 0.5 * math.cos(
            2.0 * math.pi * (frac - self.trough_frac))
        qps = self.base_qps + (self.peak_qps - self.base_qps) * shape
        if self.jitter > 0:
            rng = _rng((self.seed, round(t, 2)))
            qps *= 1.0 + rng.uniform(-self.jitter, self.jitter)
        return max(0.0, qps)

    def arrivals(self, t0: float, t1: float) -> List[float]:
        """Poisson arrival timestamps in [t0, t1), seeded on the
        window index so a replayed window draws the same arrivals."""
        dt = t1 - t0
        if dt <= 0:
            return []
        rate = self.qps_at(t0)
        rng = _rng((self.seed, int(t0 * 1000)))
        # Poisson count via Knuth (rate*dt is small per beat)
        lam = rate * dt
        n, acc = 0, rng.random()
        bound = math.exp(-lam)
        while acc > bound:
            n += 1
            acc *= rng.random()
        return sorted(t0 + rng.random() * dt for _ in range(n))


class LatencyWindow:
    """Bounded window of recent request latencies with quantile reads
    (sorting 2k floats per report beat is microseconds — no need for
    a streaming sketch at replica scale)."""

    __slots__ = ("_samples",)

    def __init__(self, cap: int = 2048):
        self._samples: Deque[float] = deque(maxlen=cap)

    def record(self, latency_ms: float) -> None:
        self._samples.append(float(latency_ms))

    def __len__(self) -> int:
        return len(self._samples)

    def quantile(self, q: float) -> float:
        if not self._samples:
            return 0.0
        s = sorted(self._samples)
        idx = min(int(q * len(s)), len(s) - 1)
        return s[idx]

    @property
    def p50_ms(self) -> float:
        return self.quantile(0.50)

    @property
    def p99_ms(self) -> float:
        return self.quantile(0.99)


class ServingStatsReporter:
    """Writes the per-replica serving stats record (api/serving.py
    field contract) — the ProgressReporter pattern, different record.
    None-safe factory: `r = ServingStatsReporter.from_env();
    r and r.report(...)`."""

    __slots__ = ("path", "epoch", "_now")

    def __init__(self, path: str, epoch: int = 0, now=time.time):
        self.path = path
        self.epoch = int(epoch)
        self._now = now

    @classmethod
    def from_env(cls, environ=None) -> Optional["ServingStatsReporter"]:
        from volcano_tpu_torch.api.goodput import ENV_EPOCH
        from volcano_tpu_torch.api.serving import ENV_STATS_FILE
        env = os.environ if environ is None else environ
        path = env.get(ENV_STATS_FILE, "")
        if not path:
            return None
        try:
            epoch = int(env.get(ENV_EPOCH, 0) or 0)
        except (TypeError, ValueError):
            epoch = 0          # malformed env must not kill the replica
        return cls(path, epoch=epoch)

    def report(self, requests: int, slo_ok: int, p50_ms: float,
               p99_ms: float) -> bool:
        record = {"requests": int(requests), "slo_ok": int(slo_ok),
                  "p50_ms": round(float(p50_ms), 3),
                  "p99_ms": round(float(p99_ms), 3),
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
                pass
            return False


class WeightedLoadBalancer:
    """Latency-weighted front-end traffic splitter (the bench's LB).

    Replaces the even split: a replica's share of the offered QPS is
    inversely proportional to its OBSERVED p99 (EWMA-smoothed from
    the stats it publishes), so a replica dragging on a contended or
    degraded slice sheds load to faster peers instead of dragging the
    group p99 — the standard least-latency front-end policy.  Two
    guard rails keep the feedback loop stable:

      cold start   a replica with no observation yet is priced at the
                   group's mean latency (or floor_ms when the whole
                   group is cold), so a fresh scale-up RAMPS rather
                   than starving or flooding;
      max_skew     no replica's weight falls below fastest/max_skew —
                   a momentarily slow replica keeps receiving enough
                   traffic to prove recovery (a zero share would
                   freeze its observed latency at the bad sample).

    One balancer fronts MULTIPLE serving groups (`route`): groups
    contend for the fleet's chips, never for each other's traffic —
    each group's offered QPS is split only across its own replicas.
    """

    __slots__ = ("alpha", "floor_ms", "max_skew", "_lat")

    def __init__(self, alpha: float = 0.4, floor_ms: float = 1.0,
                 max_skew: float = 4.0):
        self.alpha = float(alpha)
        self.floor_ms = float(floor_ms)
        self.max_skew = max(1.0, float(max_skew))
        self._lat: dict = {}          # replica uid -> EWMA p99_ms

    def observe(self, uid: str, p99_ms: float) -> None:
        try:
            p99 = float(p99_ms)
        except (TypeError, ValueError):
            return
        if p99 <= 0.0:
            return                    # replica has served nothing yet
        prev = self._lat.get(uid)
        self._lat[uid] = p99 if prev is None else \
            prev + self.alpha * (p99 - prev)

    def forget(self, uid: str) -> None:
        self._lat.pop(uid, None)

    def latencies(self) -> dict:
        return dict(self._lat)

    def split(self, total_qps: float, uids: List[str]) -> dict:
        """{uid: qps} — conserves total_qps across the group."""
        if not uids:
            return {}
        known = [self._lat[u] for u in uids if u in self._lat]
        cold = (sum(known) / len(known)) if known else self.floor_ms
        lat = {u: max(self.floor_ms, self._lat.get(u, cold))
               for u in uids}
        w = {u: 1.0 / l for u, l in lat.items()}
        lo = max(w.values()) / self.max_skew
        w = {u: max(v, lo) for u, v in w.items()}
        norm = sum(w.values())
        return {u: float(total_qps) * v / norm for u, v in w.items()}

    def route(self, offered: dict, groups: dict) -> dict:
        """Split each group's offered QPS across that group's
        replicas: `offered` is {group: qps}, `groups` is
        {group: [uids]}; returns one {uid: qps} map for the beat."""
        out = {}
        for g, total in offered.items():
            out.update(self.split(total, groups.get(g, [])))
        return out


def synthetic_forward(base_ms: float = 2.0,
                      per_item_ms: float = 0.4) -> Callable[[int], None]:
    """Deterministic forward cost model: one batched call costs
    base + n*per_item, so batching amortizes the fixed cost the way a
    real accelerator launch does.  Keeps the bench's latency
    distribution controlled (no JIT warmup spikes in the p99)."""
    def fwd(n: int) -> None:
        time.sleep((base_ms + per_item_ms * n) / 1000.0)
    return fwd


def torch_forward(max_batch: int = 8, cfg=None, seq_len: int = 16,
                  device=None) -> Callable[[int], Any]:
    """Real batched forward through the flagship model, padded to
    max_batch so every batch size runs one shape.  The defaults
    reproduce `jax_forward`'s tiny f32 config; pass
    `model.flagship_config()` for full width.  Params and tokens come
    from seeded generators on the device; each call returns the logits
    after the device has finished (the counterpart of
    `block_until_ready`)."""
    import torch

    from volcano_tpu_torch.workloads import model as model_lib
    from volcano_tpu_torch.workloads.device import resolve_device

    dev = resolve_device(device)
    if cfg is None:
        cfg = model_lib.ModelConfig(
            vocab_size=256, d_model=64, n_layers=2, n_heads=4, d_ff=128,
            max_seq=32, dtype=torch.float32, use_flash_attention=False)
    params = model_lib.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    tokens = torch.randint(
        0, cfg.vocab_size, (max_batch, seq_len), device=dev,
        generator=torch.Generator(device=dev).manual_seed(1))

    def fwd(n: int):
        with torch.inference_mode():
            logits = model_lib.forward(params, tokens, cfg)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return logits

    fwd(max_batch)                    # warm up (allocator, kernel build)
    return fwd


class BatchedServer:
    """The batched-forward serving core.

    Requests queue with their arrival timestamp; `drain` serves the
    queue in batches of at most `max_batch` through `forward_fn`, and
    a request's latency is queue wait PLUS its batch's forward time —
    so overload shows up as wait, exactly where a real server hurts.
    Ledgers are cumulative (the wire contract); quantiles windowed.
    """

    __slots__ = ("forward_fn", "max_batch", "slo_ms", "queue",
                 "requests", "slo_ok", "latency", "_now")

    def __init__(self, forward_fn: Callable[[int], None],
                 max_batch: int = 8, slo_ms: float = 50.0,
                 now=time.monotonic):
        self.forward_fn = forward_fn
        self.max_batch = int(max_batch)
        self.slo_ms = float(slo_ms)
        self.queue: Deque[float] = deque()
        self.requests = 0
        self.slo_ok = 0
        self.latency = LatencyWindow()
        self._now = now

    def offer(self, arrival_ts: float) -> None:
        self.queue.append(arrival_ts)

    def serve_batch(self) -> int:
        """Serve ONE batch off the queue head; returns batch size."""
        if not self.queue:
            return 0
        batch = [self.queue.popleft()
                 for _ in range(min(self.max_batch, len(self.queue)))]
        self.forward_fn(len(batch))
        done = self._now()
        for arrival in batch:
            lat_ms = max(0.0, (done - arrival) * 1000.0)
            self.latency.record(lat_ms)
            self.requests += 1
            if lat_ms <= self.slo_ms:
                self.slo_ok += 1
        return len(batch)

    def drain(self) -> int:
        served = 0
        while self.queue:
            served += self.serve_batch()
        return served


def run(environ=None) -> dict:
    """Replica entrypoint: serve the (compressed) diurnal curve for
    SERVE_DURATION_S seconds, publishing stats every SERVE_BEAT_S.

    Traffic source, in precedence order:
      SERVE_TRAFFIC_FILE  JSON {"qps": <per-replica offered rate>}
                          rewritten by the bench's load balancer
                          as replicas scale — the worker polls
                          it every beat;
      SERVE_*_QPS env     self-driven seeded diurnal curve (for
                          single-replica / standalone runs).
    """
    env = os.environ if environ is None else environ
    duration_s = float(env.get("SERVE_DURATION_S", "5"))
    beat_s = float(env.get("SERVE_BEAT_S", "0.2"))
    slo_ms = float(env.get("SERVE_SLO_MS", "50"))
    max_batch = int(env.get("SERVE_MAX_BATCH", "8"))
    batch_window_s = float(env.get("SERVE_BATCH_WINDOW_S", "0.005"))
    traffic_file = env.get("SERVE_TRAFFIC_FILE", "")
    mode = env.get("SERVE_MODE", "synthetic")

    if mode == "torch":
        forward = torch_forward(max_batch=max_batch,
                                device=env.get("SERVE_DEVICE", "cuda"))
    else:
        forward = synthetic_forward(
            base_ms=float(env.get("SERVE_BASE_MS", "2.0")),
            per_item_ms=float(env.get("SERVE_PER_ITEM_MS", "0.4")))

    traffic = DiurnalTraffic(
        base_qps=float(env.get("SERVE_BASE_QPS", "5")),
        peak_qps=float(env.get("SERVE_PEAK_QPS", "40")),
        day_s=float(env.get("SERVE_DAY_S", str(duration_s))),
        seed=int(env.get("SERVE_SEED", "0")))

    server = BatchedServer(forward, max_batch=max_batch, slo_ms=slo_ms)
    reporter = ServingStatsReporter.from_env(environ)

    def _file_qps() -> Optional[float]:
        if not traffic_file:
            return None
        try:
            with open(traffic_file, encoding="utf-8") as f:
                return float(json.load(f).get("qps", 0.0))
        except (OSError, ValueError, TypeError):
            return None     # torn/missing file: fall back this beat

    start = time.monotonic()
    next_beat = start
    while time.monotonic() - start < duration_s:
        t0 = next_beat
        next_beat = t0 + beat_s
        qps = _file_qps()
        if qps is None:         # self-driven: evaluate the curve here
            arrivals = traffic.arrivals(t0 - start, t0 - start + beat_s)
            arrivals = [start + a for a in arrivals]
        else:                   # LB-driven: flat rate this beat
            arrivals = _poisson_arrivals(qps, t0, t0 + beat_s,
                                         traffic.seed)
        # serve arrivals in order: sleep until each lands, serve a
        # batch when it fills OR when the next arrival is further out
        # than the batching window (a request never idles waiting for
        # batch-mates longer than batch_window_s); once forward time
        # outruns the inter-arrival gap the sleeps vanish and wait
        # time grows — the honest overload signal
        for arrival in arrivals:
            while server.queue and \
                    arrival - time.monotonic() > batch_window_s:
                server.serve_batch()
            pause = arrival - time.monotonic()
            if pause > 0:
                time.sleep(pause)
            server.offer(arrival)
            if len(server.queue) >= max_batch:
                server.serve_batch()
        server.drain()
        if reporter is not None:
            reporter.report(server.requests, server.slo_ok,
                            server.latency.p50_ms,
                            server.latency.p99_ms)
        pause = next_beat - time.monotonic()
        if pause > 0:
            time.sleep(pause)
    return {
        "requests": server.requests,
        "slo_ok": server.slo_ok,
        "attainment": round(server.slo_ok / server.requests, 4)
        if server.requests else 1.0,
        "p50_ms": round(server.latency.p50_ms, 3),
        "p99_ms": round(server.latency.p99_ms, 3),
    }


def _poisson_arrivals(qps: float, t0: float, t1: float,
                      seed: int) -> List[float]:
    """Arrivals for a flat rate over [t0, t1) — the traffic-file path
    where the load balancer already evaluated the curve."""
    return DiurnalTraffic(qps, qps, max(t1 - t0, 1e-6), seed=seed,
                          jitter=0.0).arrivals(t0, t1)


def main() -> int:
    out = run()
    print(json.dumps(out), flush=True)
    return 0 if out["requests"] >= 0 else 1


if __name__ == "__main__":
    sys.exit(main())

"""The port's bench harness (`volcano_tpu_torch/bench.py`) against the
reference's (`bench.py`): its modes, the train child's FLOP accounting,
the scale knee and the sweep smoke's bit-identity rows, the elastic
child's dp-resize dryrun on gloo ranks against the reference's on 8 JAX
CPU devices, and device children that refuse to run without a card."""

import ast
import contextlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import bench as ref_bench
from volcano_tpu.workloads import model as jm
from volcano_tpu.workloads import train as jt
from volcano_tpu_torch import bench
from volcano_tpu_torch.workloads import model as tm
from volcano_tpu_torch.workloads import train as tt

REPO = Path(__file__).resolve().parents[1]
ELASTIC_TIMEOUT_S = 600
CHILD_TIMEOUT_S = 120


def _modes(path):
    """The `--<mode>` flags the module's `__main__` block dispatches on."""
    tree = ast.parse(path.read_text())
    main = next(n for n in tree.body if isinstance(n, ast.If)
                and "__main__" in ast.unparse(n.test))
    return {n.value for n in ast.walk(main) if isinstance(n, ast.Constant)
            and isinstance(n.value, str) and n.value.startswith("--")
            and n.value != "--init"}


def test_every_reference_mode_is_a_port_mode():
    ref = _modes(REPO / "bench.py")
    assert len(ref) == 29, sorted(ref)
    assert _modes(REPO / "volcano_tpu_torch" / "bench.py") == ref


# -- (i) the train child's FLOP accounting --------------------------------

# the reference's sweep (bench.py `_train_child`): tag, d_model, d_ff,
# n_heads, batch, remat, bf16 first moment, FLASH_BLOCK_BWD
REF_SWEEP = [
    ("d2048-L8-b8", 2048, 8192, 16, 8, False, False, None),
    ("d2048-L8-b8-bwd256", 2048, 8192, 16, 8, False, False, "256"),
    ("d2048-L8-b8-mu16", 2048, 8192, 16, 8, False, True, None),
    ("d2048-L8-b16-remat", 2048, 8192, 16, 16, True, False, None),
    ("d2048-L8-b16-remat-bwd256", 2048, 8192, 16, 16, True, False, "256"),
    ("d1024-L8-b8", 1024, 4096, 8, 8, False, False, None),
]
SEQ = 2048


def _port_param_count(cfg, monkeypatch):
    """The port model's parameter count at cfg, its tensors on the meta
    device (no memory): torch.randn is replaced by an empty meta
    tensor of the asked shape."""
    monkeypatch.setattr(torch, "randn",
                        lambda shape, **_: torch.empty(shape, device="meta"))
    params = tm.init_params(cfg, torch.Generator(), "meta")
    monkeypatch.undo()
    return sum(x.numel() for x in tt.leaves(params))


@pytest.mark.parametrize("point", range(len(REF_SWEEP)),
                         ids=[p[0] for p in REF_SWEEP])
def test_train_flops_and_params_match_reference(point, monkeypatch):
    monkeypatch.delenv("BENCH_TRAIN_BATCH", raising=False)
    tag, d, f, h, b, remat, mu16, bwd = REF_SWEEP[point]
    got_tag, cfg, got_b, mu_dtype, env = bench.sweep_points(SEQ)[point]
    assert (got_tag, got_b, cfg.remat) == (tag, b, remat)
    assert (cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.n_layers) == (d, f, h, 8)
    assert cfg.use_flash_attention and cfg.dtype == torch.bfloat16
    assert cfg.vocab_size == 32000 and cfg.max_seq == SEQ
    assert (mu_dtype == torch.bfloat16) == mu16
    assert env.get("FLASH_BLOCK_BWD") == bwd
    # the reference's count and formula (bench.py `_train_one_config`)
    rcfg = jm.ModelConfig(vocab_size=32000, d_model=d, n_layers=8,
                          n_heads=h, d_ff=f, max_seq=SEQ,
                          dtype=jax.numpy.bfloat16,
                          use_flash_attention=True, remat=remat)
    shapes = jax.eval_shape(lambda: jm.init_params(jax.random.key(0), rcfg))
    total = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
    attn_fwd = rcfg.n_layers * 4.0 * b * rcfg.n_heads * SEQ * SEQ * \
        rcfg.head_dim / 2
    want = 6.0 * (total - rcfg.vocab_size * rcfg.d_model) * b * SEQ + \
        3.0 * attn_fwd
    n_params = _port_param_count(cfg, monkeypatch)
    assert n_params == total
    assert round(n_params / 1e6, 1) == round(total / 1e6, 1)
    assert bench.train_flops(cfg, n_params, b, SEQ) == want


def test_one_point_at_bench_train_batch(monkeypatch):
    monkeypatch.setenv("BENCH_TRAIN_BATCH", "4")
    (tag, cfg, b, mu_dtype, env), = bench.sweep_points(SEQ)
    assert (tag, b, cfg.d_model, mu_dtype, env) == \
        ("d2048-L8-b4", 4, 2048, None, {})


# -- (ii) the scale knee and the sweep smoke's bit-identity rows ----------

@pytest.mark.parametrize("with_40k", [False, True])
def test_scale_knee_matches_reference(with_40k):
    rows = [{"gang1024_cycle_s": 0.512}, {"gang2048_cycle_s": 1.75},
            {"gang4096_cycle_s": "n/a"}]
    if with_40k:
        rows.append({"gang8192_cycle_s": 9.3})
    assert bench._scale_knee(*rows) == ref_bench._scale_knee(*rows)


def test_sweep_smoke_rows_match_reference():
    keys = ("placements_identical", "entry_identical",
            "real_worker_processes", "synced_full_then_delta",
            "placements")
    ref = ref_bench.bench_sweep_smoke()
    port = bench.bench_sweep_smoke()
    assert {k: port[k] for k in keys} == {k: ref[k] for k in keys}
    assert port["placements_identical"] and port["entry_identical"]


# -- (iii) the elastic child: gloo ranks against JAX's 8 CPU devices ------

def _reference_elastic_run(monkeypatch):
    """The reference's `_elastic_child` on 8 JAX CPU devices, recording
    its initial params, its batch and every step's loss."""
    seen = {"losses": []}
    init_sharded, synthetic_batch = jt.init_sharded, jt.synthetic_batch
    make_train_step = jt.make_train_step

    def rec_init(key, cfg, mesh, opt):
        out = init_sharded(key, cfg, mesh, opt)
        seen.setdefault("params", jax.tree.map(np.asarray, out[0]))
        return out

    def rec_batch(key, cfg, b, t, mesh=None):
        out = synthetic_batch(key, cfg, b, t, mesh)
        seen.setdefault("tokens", np.asarray(out["tokens"]))
        return out

    def rec_step(cfg, mesh, opt):
        step = make_train_step(cfg, mesh, opt)

        def run(params, state, batch):
            params, state, m = step(params, state, batch)
            seen["losses"].append(float(m["loss"]))
            return params, state, m
        return run

    monkeypatch.setattr(jt, "init_sharded", rec_init)
    monkeypatch.setattr(jt, "synthetic_batch", rec_batch)
    monkeypatch.setattr(jt, "make_train_step", rec_step)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ref_bench._elastic_child()
    monkeypatch.undo()
    seen["line"] = json.loads(buf.getvalue().strip().splitlines()[-1])
    return seen


def test_elastic_child_matches_reference(monkeypatch, tmp_path):
    assert len(jax.devices()) >= 8
    ref = _reference_elastic_run(monkeypatch)
    assert ref["line"]["resume_step"] == 3 and ref["line"]["loss_continuous"]
    flat = {k: v for k, v in ref["params"].items() if k != "blocks"}
    for i, blk in enumerate(ref["params"]["blocks"]):
        flat.update((f"blocks.{i}.{k}", v) for k, v in blk.items())
    init = tmp_path / "init.npz"
    np.savez(init, tokens=ref["tokens"], **flat)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-m", "volcano_tpu_torch.bench", "--elastic-child",
         "--init", str(init)], capture_output=True, text=True,
        timeout=ELASTIC_TIMEOUT_S, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["resume_step"] == 3 and out["resume_step_never_rewinds"]
    assert out["loss_continuous"] is True
    assert out["max_rel_loss_diff"] < 1e-3
    assert {k: out[k] for k in ("world_before_devices", "world_after_devices",
                                "dp_before", "dp_after", "global_batch",
                                "tolerance")} == \
        {k: ref["line"][k] for k in ("world_before_devices",
                                     "world_after_devices", "dp_before",
                                     "dp_after", "global_batch", "tolerance")}
    # the reference's losses: 5 steps at dp 2, then steps 4-5 at dp 1
    want = ref["losses"]
    got = out["losses_before"] + out["losses_after"]
    assert len(got) == len(want) == 7
    rel = [abs(g - w) / abs(w) for g, w in zip(got, want)]
    assert max(rel) < 1e-3, (got, want)


# -- (iv) the device children refuse to run without a card ----------------

@pytest.mark.skipif(torch.cuda.is_available(), reason="needs no card")
@pytest.mark.parametrize("flag", ["--probe-child", "--flash-child",
                                  "--train-child"])
def test_device_child_refuses_without_a_card(flag):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-m", "volcano_tpu_torch.bench", flag],
        capture_output=True, text=True, timeout=CHILD_TIMEOUT_S, env=env,
        cwd=REPO)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert not [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs no card")
def test_failed_probe_leaves_the_device_rows_to_its_error():
    probe, flash, train = bench.run_gpu_benchmarks()
    assert probe["gpu_available"] is False and probe["retried"]
    for row in (flash, train):
        assert row["gpu_available"] is False
        assert "liveness probe failed twice" in row["error"]
        assert "last_known_good" not in row
    assert "no CUDA device" in probe["error"]

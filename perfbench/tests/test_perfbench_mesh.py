"""The four-card training cell at a tiny size on the CPU: four ranks in
four processes over gloo, through the port's mesh step.  A sound run is
correct and counts every rank's tokens; the run driven with its timed
path broken underneath (in each rank) fails, for each fault the cell can
have; a rank that fails or never returns ends the run, inside the
deadline, with no result.  The chip's look for cards is skipped."""

import json
import multiprocessing
import subprocess
import sys
import time

import pytest
import torch

from perfbench import cells, compare, harness
from perfbench.drivers import train_mesh
from perfbench.tests import tiny

WORKLOAD = "dsllm7b.train-4k-fsdp4"
BENCH = tiny.with_pending(WORKLOAD)
SEED = 2 ** 31 + 91


def cell(**mix):
    real = cells.cell(WORKLOAD, BENCH)
    m = dict(real.mix, rank_batch=2, seq_len=256, pool_batches=8,
             deadline_s=120)
    m.update(mix)
    return cells.Cell(WORKLOAD, 4, tiny.config(), m, real.limits,
                      real.per_layer, real.end_to_end)


def run(c, target=None, monkeypatch=None):
    if target is not None:
        # the ranks find the target by its name in this module
        monkeypatch.setattr(train_mesh, "rank_main", target)
    return train_mesh.run(c, SEED, 0.5, False, "cpu", time.perf_counter())


def test_a_sound_run_is_correct():
    c = cell()
    out = run(c)
    assert out.correct, out.checks
    assert out.attempted >= 2 and out.failed == 0
    assert out.counters["tokens"] == out.attempted * 4 * 2 * 256
    assert out.end_to_end["train_tokens_per_s"] == pytest.approx(
        out.counters["tokens"] / out.counters["window_s"])
    assert 0 < out.end_to_end["setup_s"]
    assert not multiprocessing.active_children()


def test_a_traced_run_hands_rank_0s_trace_over():
    c = cell()
    out = train_mesh.run(c, SEED, 0.5, True, "cpu", time.perf_counter())
    assert out.correct, out.checks
    assert isinstance(out.trace, train_mesh.MeshTrace)
    assert len(out.trace.others_busy) == 3
    assert out.trace.window_s > 0
    assert out.trace.spans(train_mesh.STEP_SPAN)
    assert not list(train_mesh.out_dir().glob(f"{WORKLOAD}.rank*"))
    # the traced line carries the cell's per-layer metrics by their names
    ctx = harness.Context(c, out.counters, out.trace, 989e12, 3.35e12)
    line = harness.result(out, c, {"platform": "cpu"}, ctx)
    assert "train_mfu" in line["metrics"]     # no device ops here
    assert set(line["metrics"]) <= {m["name"] for m in c.per_layer}
    assert not multiprocessing.active_children()


# -- faults, planted in each rank's program --------------------------------

def _patch_step(wrap):
    from volcano_tpu_torch.workloads import train
    real = train.make_train_step

    def make(cfg, opt, mesh=None):
        return wrap(real(cfg, opt, mesh))
    train.make_train_step = make


def frozen_rank(rank, job):
    def wrap(step):
        def frozen(params, state, batch):
            return params, state, {"loss": torch.ones(()),
                                   "grad_norm": torch.zeros(())}
        return frozen
    _patch_step(wrap)
    train_mesh.rank_main(rank, job)


def half_batch_rank(rank, job):
    def wrap(step):
        def half(params, state, batch):
            rows = batch["tokens"].shape[0] // 2
            return step(params, state, {"tokens": batch["tokens"][:rows]})
        return half
    _patch_step(wrap)
    train_mesh.rank_main(rank, job)


def no_exchange_rank(rank, job):
    from volcano_tpu_torch.workloads import train
    train._reduce_grads = lambda grads, placements, mesh: None
    train_mesh.rank_main(rank, job)


def test_a_step_that_leaves_its_state_unchanged(monkeypatch):
    out = run(cell(), frozen_rank, monkeypatch)
    assert not out.correct
    assert out.checks["grad1_gap"]["value"] == pytest.approx(1.0)
    assert out.checks["change_gap"]["value"] == pytest.approx(1.0)


def test_half_the_batch_left_out(monkeypatch):
    out = run(cell(), half_batch_rank, monkeypatch)
    assert not out.correct, out.checks


def test_the_exchange_between_cards_left_out(monkeypatch):
    out = run(cell(), no_exchange_rank, monkeypatch)
    assert not out.correct, out.checks


def test_the_half_batch_reference_fails_the_limits():
    # calibrate's fault: the reference over half of the global batch
    c = cell()
    devices = train_mesh.cards(c, "cpu")
    batches = train_mesh.proof_batches(c, SEED, devices[0])
    ref = train_mesh.reference(c, SEED, batches, "f32", devices)
    half = train_mesh.reference(c, SEED, batches[:, :4], "f32", devices)
    ok, checks = compare.judge(compare.train_numbers(half, ref), c.limits)
    assert not ok, checks


# -- a rank that fails or hangs ----------------------------------------------

def failing_rank(rank, job):
    if rank == 1:
        raise RuntimeError("a planted failure")
    train_mesh.rank_main(rank, job)


def hanging_rank(rank, job):
    if rank == 2:
        time.sleep(3600)
    train_mesh.rank_main(rank, job)


def test_a_failing_rank_ends_the_run_at_once():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1"):
        train_mesh.launch(cell(deadline_s=300), SEED, 0.5, False, "cpu",
                          target=failing_rank)
    assert time.monotonic() - t0 < 120
    assert not multiprocessing.active_children()


def test_a_rank_that_never_returns_is_killed_at_the_deadline():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        train_mesh.launch(cell(deadline_s=15), SEED, 0.5, False, "cpu",
                          target=hanging_rank)
    assert 15 <= time.monotonic() - t0 < 15 + 0.5 + 30
    assert not multiprocessing.active_children()


HANG = """
import time
from perfbench.drivers import train_mesh
from perfbench.tests import test_perfbench_mesh as t
train_mesh.rank_main = t.hanging_rank
out = train_mesh.run(t.cell(deadline_s=15), t.SEED, 0.5, False, "cpu",
                     time.perf_counter())
print(RESULT, flush=True)
"""


def test_the_run_exits_non_zero_inside_the_deadline():
    t0 = time.monotonic()
    proc = subprocess.run([sys.executable, "-c", "RESULT = 'result'\n" + HANG],
                          cwd=cells.ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert "result" not in proc.stdout
    assert "TimeoutError" in proc.stderr
    assert time.monotonic() - t0 < 15 + 0.5 + 60


def test_the_mix_and_its_limits():
    c = cells.cell(WORKLOAD, BENCH)
    assert c.chips == c.mix["ranks"] == 4
    assert c.driver == "train_mesh"
    assert set(c.limits) == {"loss_gap", "grad1_gap", "change_gap"}
    # the run's end-to-end keys are the cell's metrics
    assert {m["name"] for m in c.end_to_end} == {"train_tokens_per_s",
                                                 "setup_s"}
    # the window's flag and the trace are read by the harness's names
    assert json.loads(json.dumps(c.mix))["remat"] is True


@pytest.mark.parametrize("rows", [8, 2])
def test_the_replicated_reference_is_the_one_device_reference(rows):
    from perfbench.drivers import train as dtrain
    c = cell()
    batches = train_mesh.proof_batches(c, SEED, "cpu")[:, :rows]
    four = train_mesh.reference(c, SEED, batches, "f32",
                                train_mesh.cards(c, "cpu"))
    one = dtrain.reference(c, SEED, batches, "f32", "cpu")
    got = compare.train_numbers(four, one)
    assert got["loss_gap"] < 1e-6
    assert got["grad1_gap"] < 1e-5
    assert got["change_gap"] < 1e-5

"""`correct` at a tiny size on the CPU: a sound run passes; the run
driven with its timed path broken underneath fails, for each fault the
cell can have; and the control (the reference in fp8 put in the
program's place) fails the cell's limits.  The chip's look for a card is
skipped: the drivers are called on the CPU."""

import time

import pytest
import torch

from perfbench import compare, inputs
from perfbench.drivers import serve as dserve
from perfbench.drivers import train as dtrain
from perfbench.tests import tiny

TRAIN = ("dsllm7b-8l.train-4k",)
SERVE = "dsllm7b.serve-2k"
SEED = 2 ** 31 + 77


def run(cell):
    driver = dtrain if cell.driver == "train" else dserve
    return driver.run(cell, SEED, 0.5, False, "cpu", time.perf_counter())


@pytest.mark.parametrize("workload", TRAIN + (SERVE,))
def test_a_sound_run_is_correct(workload):
    out = run(tiny.cell(workload))
    assert out.correct, out.checks
    assert out.attempted > 0 and out.failed == 0


def _patched_step(monkeypatch, wrap):
    from volcano_tpu_torch.workloads import train
    real = train.make_train_step

    def make(cfg, opt, mesh=None):
        return wrap(real(cfg, opt, mesh))
    monkeypatch.setattr(train, "make_train_step", make)


@pytest.mark.parametrize("workload", TRAIN)
def test_a_step_that_leaves_its_state_unchanged(workload, monkeypatch):
    def wrap(step):
        def frozen(params, state, batch):
            return params, state, {"loss": torch.ones(()),
                                   "grad_norm": torch.zeros(())}
        return frozen
    _patched_step(monkeypatch, wrap)
    out = run(tiny.cell(workload))
    assert not out.correct
    assert out.checks["grad1_gap"]["value"] == pytest.approx(1.0)
    assert out.checks["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("workload", TRAIN)
def test_half_the_batch_left_out(workload, monkeypatch):
    def wrap(step):
        def half(params, state, batch):
            rows = batch["tokens"].shape[0] // 2
            return step(params, state, {"tokens": batch["tokens"][:rows]})
        return half
    _patched_step(monkeypatch, wrap)
    out = run(tiny.cell(workload))
    assert not out.correct, out.checks


def test_an_answer_altered_where_it_is_produced(monkeypatch):
    from volcano_tpu_torch.workloads import model
    real = model.forward

    def swapped(params, tokens, cfg, mesh=None):
        logits = real(params, tokens, cfg, mesh)
        return logits[[1, 0] + list(range(2, logits.shape[0]))]
    monkeypatch.setattr(model, "forward", swapped)
    out = run(tiny.cell(SERVE))
    assert not out.correct, out.checks


def test_a_token_altered_where_it_is_produced(monkeypatch):
    from volcano_tpu_torch.workloads import model
    real = model.forward

    def altered(params, tokens, cfg, mesh=None):
        tokens = tokens.clone()
        tokens[:, -1] = (tokens[:, -1] + 1) % cfg.vocab_size
        return real(params, tokens, cfg, mesh)
    monkeypatch.setattr(model, "forward", altered)
    out = run(tiny.cell(SERVE))
    assert not out.correct, out.checks


@pytest.mark.parametrize("workload", TRAIN)
def test_the_control_fails_the_train_limits(workload):
    cell = tiny.cell(workload, "bfloat16")
    pool = inputs.token_pool(SEED, inputs.TOKENS,
                             (cell.mix["proof_steps"], 2, 256),
                             cell.sizes.vocab, "cpu")
    ctl = dtrain.reference(cell, SEED, pool, "fp8", "cpu")
    ref = dtrain.reference(cell, SEED, pool, "f32", "cpu")
    ok, checks = compare.judge(compare.train_numbers(ctl, ref), cell.limits)
    assert not ok, checks


def test_the_control_fails_the_serve_limits():
    cell = tiny.cell(SERVE, "bfloat16")
    pool = inputs.token_pool(SEED, inputs.REQUESTS, (8, 256),
                             cell.sizes.vocab, "cpu")
    keep = dserve.sample(SEED, 8, cell.mix, 256)
    ref = dserve.reference_answers(cell, SEED, pool, keep, "f32", "cpu")
    ctl = dserve.reference_answers(cell, SEED, pool, keep, "fp8", "cpu")
    ok, checks = compare.judge(dserve.numbers(ctl, ref), cell.limits)
    assert not ok, checks

"""The plain reference against `volcano_tpu_torch` at tiny sizes on the
CPU, in f32: the forward's logits, and three AdamW steps (losses, the
first gradient, the change of every leaf)."""

import pytest
import torch

from perfbench import cells, compare, inputs
from perfbench.drivers import common
from perfbench.drivers import train as dtrain
from perfbench.reference import decoder
from perfbench.tests import tiny


def test_forward_logits_match_the_port():
    from volcano_tpu_torch.workloads import model
    s = cells.sizes(tiny.config())
    tokens = inputs.token_pool(3, inputs.TOKENS, (2, 256), s.vocab, "cpu")
    params = inputs.make_params(s, 3, "cpu")
    got = model.forward(params, tokens, common.model_config(s))
    pos = torch.arange(256).expand(2, 256)
    want = decoder.logits_at(params, tokens, pos, s, decoder.Precision())
    assert compare.rel_err(got, want) < 1e-5


def test_the_proof_steps_match_the_port():
    cell = tiny.cell("dsllm7b-8l.train-4k")
    pool = inputs.token_pool(5, inputs.TOKENS, (cell.mix["proof_steps"], 2,
                                                256), cell.sizes.vocab, "cpu")
    prog = dtrain.program_readings(cell, 5, "cpu")
    ref = dtrain.reference(cell, 5, pool, "f32", "cpu")
    got = compare.train_numbers(prog, ref)
    assert got["loss_gap"] < 1e-6
    assert got["grad1_gap"] < 1e-4
    assert got["change_gap"] < 1e-4
    # step 1 has lr 0: the change is the later step's alone, and it is
    # there on every leaf
    assert min(ref["change"].values()) > 0


def test_schedule_is_the_ports():
    from volcano_tpu_torch.workloads import train
    opt = cells.cell("dsllm7b-8l.train-4k").mix["optimizer"]
    port = train.make_optimizer(lr=opt["lr"], weight_decay=opt["weight_decay"],
                                warmup_steps=opt["warmup_steps"]).schedule
    for count in (0, 1, 2, 99, 100, 101, 5000, 9999, 10000, 20000):
        assert decoder.lr_at(count, opt) == pytest.approx(port(count),
                                                          rel=1e-12)


def test_the_fixed_settings_are_the_ports():
    from volcano_tpu_torch.workloads import train
    assert (decoder.B1, decoder.B2, decoder.EPS) == (train.B1, train.B2,
                                                     train.EPS)
    assert decoder.MAX_GRAD_NORM == train.MAX_GRAD_NORM


def test_fp8_rounds_to_three_mantissa_bits():
    x = torch.tensor([1.0, 1.0625, 1.125, 448.0])
    got = decoder._RoundFp8.apply(x)
    assert got.tolist() == [1.0, 1.0, 1.125, 448.0]

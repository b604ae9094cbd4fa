"""`perfbench.calibrate` asks the cell's driver for its readings, and the
dense drivers give the program's, the control's and the fault's."""

import dataclasses
import sys
import types

from perfbench import calibrate, cells
from perfbench.drivers import serve as dserve
from perfbench.drivers import train as dtrain
from perfbench.tests import tiny

SEED = 2 ** 31 + 5


def test_each_cell_gets_its_drivers_module():
    assert calibrate.driver(cells.cell("dsllm7b-8l.train-4k")) is dtrain
    assert calibrate.driver(cells.cell("dsllm7b.serve-2k")) is dserve
    from perfbench.drivers import train_mesh
    name = "dsllm7b.train-4k-fsdp4"
    assert calibrate.driver(cells.cell(name, tiny.with_pending(name))) is \
        train_mesh


def test_readings_are_the_drivers(monkeypatch):
    calls = []
    stub = types.ModuleType("perfbench.drivers.stub_moe")
    stub.readings = lambda *args: calls.append(args) or [("program", {})]
    monkeypatch.setitem(sys.modules, "perfbench.drivers.stub_moe", stub)
    real = cells.cell("dsllm7b-8l.train-4k")
    cell = dataclasses.replace(real, mix=dict(real.mix, driver="stub_moe"))
    got = calibrate.readings(cell, 7, True, False, True, "cpu", 10.0)
    assert got == [("program", {})]
    assert calls == [(cell, 7, True, False, True, "cpu", 10.0)]


def test_the_train_drivers_readings():
    cell = tiny.cell("dsllm7b-8l.train-4k")
    got = dict(calibrate.readings(cell, SEED, True, True, True, "cpu", 0.0))
    assert set(got) == {"program", "control", "fault_half_batch"}
    assert all(v <= cell.limits[k] for k, v in got["program"].items())
    for side in ("control", "fault_half_batch"):
        assert any(v > cell.limits[k] for k, v in got[side].items()), side


def test_the_serve_drivers_readings():
    cell = tiny.cell("dsllm7b.serve-2k")
    got = dict(calibrate.readings(cell, SEED, True, True, True, "cpu", 1.0))
    # a served cell has no half-batch fault
    assert set(got) == {"program", "control"}
    assert got["program"]["logit_err"] <= cell.limits["logit_err"]

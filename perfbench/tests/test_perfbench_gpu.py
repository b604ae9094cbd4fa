"""On the card: each cell runs a short window end to end and is
correct, and the control fails its limits at the cell's own size.

    python3 -m pytest perfbench/tests -m gpu

Skips where there is no CUDA device (decided inside each test)."""

import json
import subprocess
import sys

import pytest
import torch

from perfbench import calibrate, cells, compare

pytestmark = pytest.mark.gpu


def need_cards(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    chips = cells.cell(workload).chips
    if torch.cuda.device_count() < chips:
        pytest.skip(f"{workload} needs {chips} CUDA devices")


@pytest.mark.parametrize("workload", [w["name"] for w in
                                      cells.benchmark()["workloads"]])
def test_cell_runs_and_is_correct(workload):
    need_cards(workload)
    proc = subprocess.run(
        [sys.executable, "-m", "perfbench.run", "--workload", workload,
         "--seed", "2147483999", "--seconds", "3", "--trace", "0"],
        cwd=cells.ROOT, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"


@pytest.mark.parametrize("workload", [w["name"] for w in
                                      cells.benchmark()["workloads"]])
def test_control_fails_at_the_cells_size(workload):
    need_cards(workload)
    cell = cells.cell(workload)
    device = torch.device("cuda", 0)
    got = calibrate.readings(cell, 3, True, False, False, device, 10.0)
    (what, numbers), = got
    assert what == "control"
    ok, checks = compare.judge(numbers, cell.limits)
    assert not ok, checks

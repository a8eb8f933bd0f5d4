"""The control: the plain reference computed in float8 (e4m3, one scale a
tensor) in the program's place, the step below the configurations'
bfloat16.  On the card, at a cell's own size, it has to come out not
correct against the cell's limit; at a small size on the CPU it reads
far above the program.  The readings the limits were set from were taken
on the card over many seeds with ``perfbench/calibrate.py --control``."""
import time

import pytest
import torch

from perfbench.harness.report import measure
from perfbench.harness.cell import load_cell
from perfbench.tests._tiny import tiny_cell, workloads


@pytest.mark.parametrize("workload", workloads())
def test_control_reads_far_above_the_program_on_the_cpu(workload):
    out = measure(tiny_cell(workload), 2**31 + 5, 1.0, False, torch.device("cpu"),
                  time.perf_counter(), control=True)
    assert out["correct"]
    prog = {k: v["value"] for k, v in out["checks"].items() if k in out["control"]}
    # at least one number three times the program's and over the limit
    assert any(out["control"][k] > max(3 * prog[k], out["checks"][k]["limit"])
               for k in prog), (prog, out["control"])


@pytest.mark.cuda
@pytest.mark.parametrize("workload", workloads())
def test_control_fails_the_cell_limit_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs the NVIDIA card: the control runs at the cell's own size")
    cell = load_cell(workload)
    out = measure(cell, 2**31 + 11, 5.0, False, torch.device("cuda:0"), time.perf_counter(),
                  control=True)
    assert out["correct"], out["checks"]
    limits = cell.config["check"]["limits"]
    assert any(v > limits[k] for k, v in out["control"].items()), out["control"]

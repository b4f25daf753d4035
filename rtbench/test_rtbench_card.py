"""Card tests of the benchmark, at each cell's own size:

    python3 -m pytest rtbench/test_rtbench_card.py -m gpu

They skip (inside each test) where torch sees no CUDA device.  On the
card the port launches its kernels; one run() of the cell, judged
against the reference under the cell's limits, must be correct, and the
bfloat16 control (the reference in the program's place) must fail a
limit."""

import pytest
import torch

from rtbench import cells, check, run
from rtbench.control import readings

SEED = 2_718_281_828
CELLS = ("disc-poly128", "disc-mono128")


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_port_matches_reference_on_the_card(workload):
    _card()
    out = run.drive(workload, SEED, 0, False, device="cuda",
                    log=lambda msg: None)
    assert out["correct"], out["checks"]


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_bfloat16_control_fails_on_the_card(workload):
    _card()
    cell, _ = cells.load(workload)
    rows = readings(workload, [SEED], False, True, device="cuda",
                    emit=lambda line: None)
    found = {k: v for k, v in rows[0].items() if k.endswith("_gap")}
    assert not check.judge(found, cell["limits"])[0]

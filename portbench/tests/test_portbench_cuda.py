"""On the card, at the cells' own sizes: the port's answers within the limits
and the bfloat16 control beyond them, on one seed each (the readings the
limits were set from come from ``calibrate.py`` over a dozen seeds).

    python -m pytest --noconftest -m cuda portbench/tests/test_portbench_cuda.py
"""
import pytest
import torch

from portbench import calibrate


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["div2k_ssim.step", "criteo_auc.epoch"])
def test_control_fails_and_port_passes_at_cell_size(card, workload):
    row, = calibrate.readings(workload, [4_242_424_242], [4_242_424_242], 2.0)
    for name, limit in row["limits"].items():
        assert row["program"][name] <= limit < row["control"][name], (name, row)

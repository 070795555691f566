"""A run with the program broken underneath the harness reads ``correct:
false``: a state left unchanged, half of each batch left out, an answer
altered where it is produced, and, across ranks, the exchange left out."""
import multiprocessing

import pytest

from portbench import run
from portbench.tests import faults

ONE_CARD = ["div2k_ssim.step", "criteo_auc.epoch"]


@pytest.mark.parametrize("workload", ONE_CARD)
def test_sound_run_is_correct(workload):
    assert faults.run_cell(workload)["correct"] is True


@pytest.mark.parametrize("workload", ONE_CARD)
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "answer_altered"])
def test_fault_is_not_correct(workload, fault):
    line = faults.run_cell(workload, fault)
    assert line["correct"] is False and line["failed"] > 0, (line["attempted"], line["checks"])


@pytest.mark.parametrize("fault", ["none", "no_exchange"])
def test_four_ranks_without_the_exchange_are_not_correct(fault):
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    addr = f"127.0.0.1:{run._free_port()}"
    procs = [ctx.Process(target=faults.rank_main, args=("criteo_auc.epoch_4chip", fault, r, addr, queue))
             for r in range(4)]
    for p in procs:
        p.start()
    line = queue.get(timeout=240)
    for p in procs:
        p.join(timeout=60)
        assert not p.is_alive()
    assert "error" not in line, line
    assert line["correct"] is (fault == "none"), line["checks"]

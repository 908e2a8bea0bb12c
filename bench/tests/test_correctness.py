"""The correctness check of each cell, at the tiny sizes, with the
cell's own limits: a sound run comes out correct; the control (the
configuration run in the next lower precision) and each fault that the
cell can have, planted in the program under the timed path, come out not
correct."""
import time

import pytest
import torch

from bench.tests import tiny

CPU = torch.device("cpu")
CASES = [(name, fault) for name in tiny.names()
         for fault in [None, "control"] + sorted(
             tiny.cell(name).module.FAULTS)]


def _run(cell, seed):
    return cell.module.run(cell, seed=seed, seconds=0.2, trace=False,
                           device=CPU, clock0=time.perf_counter())


@pytest.mark.parametrize("name,fault", CASES)
def test_check(name, fault):
    cell = tiny.cell(name)
    seed = 2 ** 31 + 11
    if fault is None:
        out = _run(cell, seed)
        assert out.correct, out.checks
        assert out.failed == 0 and out.attempted > 0
    elif fault == "control":
        out = cell.module.run(cell, seed=seed, seconds=0.2, trace=False,
                              device=CPU, clock0=time.perf_counter(),
                              variant="control")
        assert not out.correct, out.checks
    else:
        with cell.module.FAULTS[fault]():
            out = _run(cell, seed)
        assert not out.correct, out.checks

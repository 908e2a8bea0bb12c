"""Tests on the card (marked ``cuda``; they skip without one): the
profiler sees the card's work, and the tiny cells' checks hold there."""
import time

import pytest
import torch

from bench.harness import trace
from bench.tests import tiny

pytestmark = pytest.mark.cuda


def test_trace_sees_device_time(card):
    a = torch.randn(2048, 2048, device=card)
    torch.cuda.synchronize()
    with trace.profiler() as prof:
        for _ in range(4):
            a = a @ a.T / 2048
        torch.cuda.synchronize()
    t = trace.Trace.from_profiler(prof)
    assert t.device_ops >= 4 and 0 < t.busy_s <= t.window_s


@pytest.mark.parametrize("name", tiny.names())
def test_tiny_cell_on_the_card(card, name):
    cell = tiny.cell(name)
    out = cell.module.run(cell, seed=2 ** 31 + 3, seconds=0.5, trace=True,
                          device=card, clock0=time.perf_counter())
    assert out.correct, out.checks
    assert out.trace.busy_s > 0

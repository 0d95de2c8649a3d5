"""Checks that need the card: the profiler's trace shows device work and
the harness reads it.  Marked ``gpu``; they skip here without one."""

from __future__ import annotations

import pytest
import torch

from gnnbench import trace


@pytest.mark.gpu
def test_the_trace_sees_the_kernels(card):
    x = torch.randn(2048, 2048, device=card)

    def step(n):
        for _ in range(n):
            torch.matmul(x, x)

    t = trace.record(step, 4, card)
    assert t.launches >= 4
    assert 0 < t.busy_s <= t.window_s
    assert t.kernel_seconds(r"gemm|Kernel") > 0
    assert t.device_ops()[0][1] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["t-tiny-grid", "t-tiny-scale"])
def test_the_tf32_control_is_not_correct(card, tiny_root, workload):
    from gnnbench import calibrate, harness

    cell = harness.find_cell(workload, tiny_root)
    for seed in (2 ** 31 + 61, 2 ** 31 + 67, 2 ** 31 + 71):
        got = calibrate.readings(cell, seed, card, "control-tf32")
        assert got["verdict"] is False

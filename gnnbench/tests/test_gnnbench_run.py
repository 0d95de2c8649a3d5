"""Whole runs of the test cells on the CPU: the result line, the sound
program judged correct, and the control and each planted fault judged not
correct; a run without a card, or without the program, prints no result."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from gnnbench import calibrate, faults, harness, judge, run
from gnnbench.inputs import params as P
from gnnbench.reference import sparse
from gnnbench.tests import tinyroot

CPU = torch.device("cpu")
CELLS = ["t-tiny-grid", "t-tiny-edges", "t-tiny-scale"]


def _run(root, capsys, workload, seed, trace=0):
    rc = run.main(["--workload", workload, "--seed", str(seed),
                   "--seconds", "0.5", "--trace", str(trace)], device=CPU,
                  root=root)
    out, err = capsys.readouterr()
    assert rc == 0
    return json.loads(out.strip().splitlines()[-1]), err


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_a_sound_run_is_correct(tiny_root, capsys, workload, trace):
    result, err = _run(tiny_root, capsys, workload, 2 ** 31 + 17, trace)
    assert result["correct"] is True
    assert result["failed"] == 0 and result["attempted"] > 0
    assert list(result)[-1] == "compared"
    assert set(result["compared"]) == {"draws_apart", *tinyroot.LIMITS}
    assert result["compared"]["draws_apart"]["value"] == 0
    # A metric split by its cells' end-to-end metric shares its reader.
    names = {"model_steps_per_s", "model_steps_per_s.scale", "setup_s"} \
        if not trace else {"layout_build_s", "step_mfu", "step_mfu.scale"}
    assert names <= set(result["metrics"])
    # The compared numbers are the last lines on standard error.
    assert err.strip().splitlines()[-1].startswith("eval_gap ")


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", faults.FAULTS)
def test_a_planted_fault_is_not_correct(tiny_root, capsys, workload, fault):
    with faults.planted(fault):
        result, _ = _run(tiny_root, capsys, workload, 2 ** 31 + 29)
    assert result["correct"] is False


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_not_correct(tiny_root, workload):
    """The fp8 control; TF32 is a card's, and its test is in
    test_gnnbench_card.py."""
    cell = harness.find_cell(workload, tiny_root)
    for seed in (2 ** 31 + 41, 2 ** 31 + 43, 2 ** 31 + 47):
        got = calibrate.readings(cell, seed, CPU, "control-fp8")
        assert got["verdict"] is False
        # A precision gap, not a gradient flushed to zero.
        assert got["grad_gap"] < 0.5


def test_draws_out_of_step_are_reported_apart(tiny_root, capsys,
                                              monkeypatch):
    # The reference pads the identity graphs' keep draws as the program
    # no longer does.
    monkeypatch.setattr(sparse, "IDENTITY_PAD", 128)
    monkeypatch.setattr(sparse.draw_order, "__defaults__", (128,))
    result, err = _run(tiny_root, capsys, "t-tiny-scale", 2 ** 31 + 53)
    assert result["correct"] is False
    assert result["compared"]["draws_apart"] == {"value": 1.0, "limit": 0.0}
    assert "out of step" in err
    assert judge.draws_message({"draws_apart": 0.0}) is None


def test_device_idle_is_read_against_the_untraced_step():
    class Trace:
        device, busy_s, steps = [1], 0.3, 10

    class Ctx:
        trace, step_s = Trace(), 0.04

    reader = harness.load_module(
        harness.reader_path(os.path.join(tinyroot.BENCH, "metrics"),
                            "device_idle_pct.scale"), "idle")
    assert reader.read(Ctx()) == pytest.approx(25.0)
    Ctx.trace = None
    assert reader.read(Ctx()) is None


def test_the_same_seed_makes_the_same_inputs(tiny_root):
    cell = harness.find_cell("t-tiny-grid", tiny_root)
    a = cell.driver.build(cell.config, cell.traffic, 2 ** 33 + 1, CPU)
    b = cell.driver.build(cell.config, cell.traffic, 2 ** 33 + 1, CPU)
    for k in a.raw:
        assert (a.raw[k] == b.raw[k]).all()
    for (_, x), (_, y) in zip(P.leaves(a.state.params),
                              P.leaves(b.state.params)):
        assert torch.equal(x, y)


def test_no_card_no_result(tiny_root, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = run.main(["--workload", "t-tiny-grid", "--seed", "1",
                   "--seconds", "1", "--trace", "0"], root=tiny_root)
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_without_the_program_no_result(tmp_path):
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    shutil.copytree(here, tmp_path / "gnnbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(os.path.dirname(here), "BENCHMARK.json"),
                tmp_path / "BENCHMARK.json")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "gnnbench/run.py", "--workload",
         "gdataset-protocol-grid", "--seed", "5", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        env=env, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_the_window_checks_for_jax(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", object())
    assert run.forbidden_modules() == ["jax"]
    monkeypatch.delitem(sys.modules, "jax")
    monkeypatch.setitem(sys.modules, "dream_gnn_tpu_torch", sys)
    assert "dream_gnn_tpu" not in run.forbidden_modules()

"""The harness is driven by files: a configuration, a traffic mix, a
metric and a cell added as new files and entries are found by name,
without an edit to any file the benchmark has."""

from __future__ import annotations

import json
import os
import shutil

import torch

from gnnbench import harness, run

CPU = torch.device("cpu")


def test_a_cell_added_as_files_is_found_and_run(tmp_path, tiny_root, capsys):
    root = str(tmp_path / "checkout")
    shutil.copytree(tiny_root, root)
    before = {}
    for base, _, files in os.walk(os.path.join(root, "gnnbench")):
        for f in files:
            path = os.path.join(base, f)
            with open(path, "rb") as fh:
                before[path] = fh.read()
    here = os.path.join(root, "gnnbench")
    # A new configuration: the tiny one with one more GCMC layer.
    with open(os.path.join(here, "tests", "data", "tiny-gdataset.json")) as f:
        cfg = json.load(f)
    cfg.update(name="tiny-deeper", layers=3)
    os.makedirs(os.path.join(here, "configs"), exist_ok=True)
    with open(os.path.join(here, "configs", "tiny-deeper.json"), "w") as f:
        json.dump(cfg, f)
    # A new traffic mix: a smaller stack.
    with open(os.path.join(here, "traffic", "tiny-one-seed.json"), "w") as f:
        json.dump(dict(decode_mode="grid", n_seeds=1, clock_every=1,
                       compare_steps=3, trace_steps=1, reference_block=5), f)
    with open(os.path.join(here, "limits", "t-deeper.json"), "w") as f:
        json.dump(dict(loss_gap=1e-4, grad_gap=1e-3, change_gap=1e-2,
                       eval_gap=1e-3), f)
    # A new per-layer metric with a reader of its own.
    with open(os.path.join(here, "metrics", "models_in_stack.py"), "w") as f:
        f.write("def read(ctx):\n    return ctx.n_models\n")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append(dict(name="tiny-deeper", source="test",
                                 file="gnnbench/configs/tiny-deeper.json",
                                 reduced=[], why="test"))
    bench["workloads"].append(dict(name="t-deeper", config="tiny-deeper",
                                   traffic="tiny-one-seed", chips=1,
                                   why="test"))
    bench["per_layer"].append(dict(
        name="models_in_stack", unit="models", better="higher",
        source="program_counter", layer="Loop", moves="model_steps_per_s"))
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)

    cell = harness.find_cell("t-deeper", root, trace=True)
    assert cell.config["layers"] == 3 and cell.traffic["n_seeds"] == 1
    assert run.main(["--workload", "t-deeper", "--seed", "2200000003",
                     "--seconds", "0.5", "--trace", "1"], device=CPU,
                    root=root) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["correct"] is True
    assert result["metrics"]["models_in_stack"]["value"] == 10
    for path, data in before.items():
        with open(path, "rb") as fh:
            assert fh.read() == data, f"{path} was edited"

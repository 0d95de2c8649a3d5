"""A checkout-shaped temporary tree for the CPU tests: this benchmark's
files and a ``BENCHMARK.json`` whose cells run the test configurations at
test sizes."""

from __future__ import annotations

import json
import os
import shutil

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)

# traffic name -> (configuration, traffic parameters)
CELLS = {
    "tiny-grid": ("tiny-gdataset", dict(
        decode_mode="grid", n_seeds=2, clock_every=2, compare_steps=3,
        trace_steps=2, reference_block=3)),
    "tiny-edges": ("tiny-gdataset", dict(
        decode_mode="edges", n_seeds=2, clock_every=2, compare_steps=3,
        trace_steps=2, reference_block=3)),
    "tiny-scale": ("tiny-scale", dict(
        clock_every=2, compare_steps=3, trace_steps=2)),
}
# Set from the test cells' readings on the CPU: sound runs over 20 seeds read
# at most 3.0e-6, 9.0e-7, 2.4e-4 and 1.5e-3, the fp8 control over the three
# seeds of its test at least 3.8e-4, 0.017, 0.016 and 3.4e-3.
LIMITS = dict(loss_gap=1e-4, grad_gap=1e-3, change_gap=1e-2, eval_gap=0.012)


def make(tmp: str) -> str:
    """Copies the benchmark into ``tmp`` with the test cells; returns the
    tree's root."""
    root = os.path.join(tmp, "checkout")
    shutil.copytree(BENCH, os.path.join(root, "gnnbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(BENCH, os.pardir, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"] = [
        dict(name=c, source="test", file=f"gnnbench/tests/data/{c}.json",
             reduced=[], why="test sizes")
        for c in sorted({c for c, _ in CELLS.values()})]
    bench["workloads"] = [
        dict(name=f"t-{name}", config=c, traffic=name, chips=1, why="test")
        for name, (c, _) in CELLS.items()]
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.pop("workloads", None)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    for name, (_, traffic) in CELLS.items():
        with open(os.path.join(root, "gnnbench", "traffic",
                               f"{name}.json"), "w") as f:
            json.dump(traffic, f)
        with open(os.path.join(root, "gnnbench", "limits",
                               f"t-{name}.json"), "w") as f:
            json.dump(LIMITS, f)
    return root

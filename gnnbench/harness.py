"""The benchmark's harness: finds a cell's files by name, drives the
program through set-up, the measured window and an optional traced
sub-window, runs the plain reference, and reads the metrics.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by the names in ``BENCHMARK.json``:
- ``configs/<config>.json`` (the path in ``BENCHMARK.json``), whose
  ``driver`` names ``drivers/<driver>.py``;
- ``traffic/<traffic>.json``;
- ``limits/<workload>.json``: the limits of the compared numbers;
- ``metrics/<metric>.py``: a reader ``read(ctx)`` that returns a number or
  None when the cell gives it nothing to read; ``<metric>.<part>`` may
  share the reader of ``<metric>``.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import subprocess
import time
from typing import Optional

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Cell:
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    metrics: list          # the BENCHMARK.json metric entries of this cell
    driver: object
    root: str


def find_cell(name: str, root: str = ROOT, trace: bool = False) -> Cell:
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    here = os.path.join(root, "gnnbench")
    work = next((w for w in bench["workloads"] if w["name"] == name), None)
    if work is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == work["config"])
    config = load_json(os.path.join(root, conf["file"]))
    traffic = load_json(os.path.join(here, "traffic",
                                     f"{work['traffic']}.json"))
    limits = load_json(os.path.join(here, "limits", f"{name}.json"))
    driver = load_module(os.path.join(here, "drivers",
                                      f"{config['driver']}.py"),
                         f"gnnbench.drivers.{config['driver']}")
    kind = "per_layer" if trace else "end_to_end"
    metrics = [m for m in bench[kind]
               if name in m.get("workloads", [name])]
    return Cell(work, config, traffic, limits, metrics, driver, root)


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class Window:
    steps: int
    seconds: float
    eval_s: list
    failed: int
    intervals: list        # seconds of each whole interval, its eval in it


def measure(run, seconds: float, device) -> Window:
    """Steps for ``seconds`` in runs of ``clock_every`` steps, with an eval
    after every ``run.interval`` steps from the window's first; counts
    whole steps, and every model's step whose loss is not finite as
    failed."""
    every = run.traffic["clock_every"]
    sync(device)
    t0 = time.perf_counter()
    end = t0 + seconds
    steps = since = 0
    eval_s, losses, marks = [], [], [t0]
    while True:
        k = min(every, run.interval - since)
        losses.append(run.step(k))
        steps += k
        since += k
        if since == run.interval:
            sync(device)
            te = time.perf_counter()
            run.evaluate()
            sync(device)
            marks.append(time.perf_counter())
            eval_s.append(marks[-1] - te)
            since = 0
        if time.perf_counter() >= end:
            break
    sync(device)
    window_s = time.perf_counter() - t0
    failed = int(sum(int((~torch.isfinite(x)).sum()) for x in losses))
    return Window(steps, window_s, eval_s, failed,
                  [b - a for a, b in zip(marks, marks[1:])])


def power_limit() -> Optional[str]:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


@dataclasses.dataclass
class Context:
    """What a metric's reader may read."""

    cell: Cell
    n_models: int
    setup_s: float
    layout_build_s: float
    window: Window
    peak_bytes: int
    counts: dict
    trace: object = None          # trace.Trace of the traced sub-window

    @property
    def step_s(self) -> float:
        """Seconds a step in the window, its evals left out."""
        return (self.window.seconds - sum(self.window.eval_s)) \
            / self.window.steps


def reader_path(here: str, name: str) -> str:
    """``metrics/<name>.py``; a metric split by the cells' end-to-end
    metric (``eval_ms.scale``) shares the reader of the name before its
    first dot where it has none of its own."""
    own = os.path.join(here, f"{name}.py")
    if os.path.exists(own) or "." not in name:
        return own
    return os.path.join(here, f"{name.split('.')[0]}.py")


def read_metrics(ctx: Context) -> dict:
    here = os.path.join(ctx.cell.root, "gnnbench", "metrics")
    out = {}
    for m in ctx.cell.metrics:
        reader = load_module(reader_path(here, m["name"]),
                             f"gnnbench.metrics.{m['name']}")
        value = reader.read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def check_numbers(numbers: dict, limits: dict) -> dict:
    """Each number that the run is judged by, beside its limit."""
    from gnnbench import judge

    return {k: {"value": float(numbers[k]), "limit": float(v)}
            for k, v in judge.judged(limits).items()}

"""Benchmark of dream_gnn_tpu_torch, the PyTorch and CUDA port, on one card.

    python3 gnnbench/run.py --workload NAME --seed N --seconds S --trace 0|1

Each run is a new process: it makes the cell's inputs from the seed, builds
the program's state with the program's own builders, warms up with the
first training steps and one eval of each side (the steps that are then
compared with the plain reference), measures for ``--seconds``, optionally
profiles a short sub-window, frees the program, runs the reference, and
prints one JSON line.  ``--trace 0`` reports the cell's end-to-end metrics,
``--trace 1`` its per-layer metrics with the device's busy time and a
breakdown.  The numbers compared with the reference, each beside its limit,
are the last lines on standard error and the last key of the JSON line.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Every build and kernel cache inside the checkout, at fixed paths.
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build",
                                                  "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "dream_gnn_tpu")


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (compared whole: the port's name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def main(argv=None, *, device=None, root: str = ROOT) -> int:
    """Runs one cell.  ``device`` is for tests: a CPU run that skips the
    look for a card."""
    args = parse(argv)
    import torch

    from gnnbench import harness, judge
    from gnnbench import trace as tracing

    cell = harness.find_cell(args.workload, root, trace=bool(args.trace))
    chips = int(cell.workload["chips"])
    if device is None:
        found = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        if found < chips:
            print(f"gnnbench: the cell needs {chips} CUDA device(s); {found} "
                  f"available", file=sys.stderr)
            return 2
        device = torch.device("cuda:0")
    torch.set_num_threads(4)

    from dream_gnn_tpu_torch.utils.device import set_numerics
    set_numerics()

    t_ready = time.perf_counter()
    run = cell.driver.build(cell.config, cell.traffic, args.seed, device)
    harness.sync(device)
    t_built = time.perf_counter()
    prog = run.warm_up()
    harness.sync(device)
    setup_s = time.perf_counter() - T_START
    parts = getattr(run, "setup_parts", {})
    setup_parts = (f"imports {t_ready - T_START:.3f} s, inputs and state "
                   f"{t_built - t_ready:.3f} s ("
                   + ", ".join(f"{k} {v:.3f} s" for k, v in parts.items())
                   + f"), warm-up {T_START + setup_s - t_built:.3f} s")

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    window = harness.measure(run, args.seconds, device)
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    trace = None
    if args.trace:
        trace = tracing.record(run.step, cell.traffic["trace_steps"], device)
    ctx = harness.Context(cell=cell, n_models=run.n_models, setup_s=setup_s,
                          layout_build_s=run.layout_build_s, window=window,
                          peak_bytes=peak, counts=run.counts(), trace=trace)
    run.release()

    t_ref = time.perf_counter()
    ref = run.reference()
    ref_s = time.perf_counter() - t_ref
    numbers = judge.compare(prog, ref)
    compared = harness.check_numbers(numbers, cell.limits)
    correct = judge.verdict(numbers, cell.limits) and window.failed == 0

    found = forbidden_modules()
    if found:
        print(f"gnnbench: modules of JAX or of the JAX package are loaded: "
              f"{', '.join(found)}", file=sys.stderr)
        return 3

    result = {
        "correct": bool(correct),
        "attempted": window.steps * run.n_models,
        "failed": window.failed,
        "metrics": harness.read_metrics(ctx),
        "device": {
            "platform": "gpu" if device.type == "cuda" else "cpu",
            "kind": (torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu"),
            "count": chips,
            "memory_peak_bytes": int(peak),
        },
    }
    limit = harness.power_limit() if device.type == "cuda" else None
    if limit:
        result["device"]["power"] = limit
    if trace is not None:
        result["device"]["busy_s"] = trace.busy_s
        result["device"]["window_s"] = trace.window_s
        result["breakdown"] = {"device_ops": trace.device_ops(),
                               "idle_gaps": trace.idle_gaps()}
    result["compared"] = compared
    print(f"gnnbench: {args.workload} seed {args.seed}: {window.steps} steps "
          f"of {run.n_models} models in {window.seconds:.3f} s, "
          f"{len(window.eval_s)} evals; set-up {setup_s:.3f} s "
          f"({setup_parts}); reference {ref_s:.3f} s; "
          f"{judge.quiet_leaves(ref)} quiet leaves left out of the change; "
          f"{limit or 'no card'}", file=sys.stderr)
    print("gnnbench: seconds of each interval: "
          + " ".join(f"{x:.4f}" for x in window.intervals), file=sys.stderr)
    message = judge.draws_message(numbers)
    if message:
        print(f"gnnbench: {message}", file=sys.stderr)
    for k, v in compared.items():
        print(f"{k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Readings that set a cell's limits, on the chip at the cell's size: the
compared numbers of sound runs of the program over many seeds, of each
control (the reference in the nearest precision below one that the
configuration states, in the program's place: ``tf32`` or ``fp8``, see
``drivers/stacked.py``), of the program itself with TF32 switched on
(``--tf32-program``), and of the program with each planted fault.

    python3 gnnbench/calibrate.py --workload NAME --run KIND S1 S2 ...
        [--run KIND S ...]

KIND is ``program`` (sound runs), ``control-tf32``, ``control-fp8``,
``tf32-program``, or a planted fault (``unchanged``, ``half_batch``,
``altered``).  Prints one JSON line per seed: {"seed", "kind", every
number...}, each number whether the cell's limits hold it or not.  The
benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from gnnbench.drivers.stacked import CONTROLS  # noqa: E402
from gnnbench.faults import FAULTS  # noqa: E402

KINDS = ("program", *(f"control-{c}" for c in CONTROLS), "tf32-program",
         *FAULTS)


def readings(cell, seed: int, device, kind: str) -> dict:
    """The compared numbers of one seed: ``program`` (sound),
    ``control-<name>``, ``tf32-program``, or the name of a planted fault."""
    import contextlib

    from gnnbench import faults, judge
    from gnnbench.drivers.stacked import precision

    t0 = time.perf_counter()
    run = cell.driver.build(cell.config, cell.traffic, seed, device)
    if kind.startswith("control-"):
        ref = run.reference()
        prog = run.reference(kind[len("control-"):])
    else:
        if kind == "program":
            plant = contextlib.nullcontext()
        elif kind == "tf32-program":
            plant = precision(True)
        else:
            plant = faults.planted(kind)
        with plant:
            prog = run.warm_up()
        run.release()
        ref = run.reference()
    out = dict(seed=seed, kind=kind, **judge.compare(prog, ref))
    out["verdict"] = judge.verdict(out, cell.limits)
    out["seconds"] = time.perf_counter() - t0
    return out


def main(argv=None, device=None, root: str = ROOT) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--run", nargs="+", action="append", required=True,
                   metavar="KIND SEED", help="a kind, then its seeds")
    args = p.parse_args(argv)
    for kind, *seeds in args.run:
        if kind not in KINDS or not seeds:
            p.error(f"--run {kind}: a kind of {KINDS}, then seeds")
    import torch

    from dream_gnn_tpu_torch.utils.device import set_numerics

    from gnnbench import harness

    cell = harness.find_cell(args.workload, root)
    device = device or torch.device("cuda:0")
    set_numerics()
    for kind, *seeds in args.run:
        for seed in seeds:
            print(json.dumps(readings(cell, int(seed), device, kind)),
                  flush=True)
            if device.type == "cuda":
                torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

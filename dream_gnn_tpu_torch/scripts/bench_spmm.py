"""The blocked and grouped SpMM kernels against the segment sum, at the
scale configuration (100k x 100k nodes, 10M edges, d = 128).

    python -m dream_gnn_tpu_torch.scripts.bench_spmm [--small] [--device -1]

Port of ``scripts/bench_spmm.py`` of the JAX package.  The graph is drawn
from ``default_rng(0)`` as there (weights U[0.5, 1.5)); ``--small`` is 4096
nodes and 200k edges.  It prints the relative error of the blocked
(kernels/spmm_blocked.py) and the grouped (kernels/spmm_gather.py) SpMM in
fp32 against ``spmm_coo`` (kernels/spmm.py, a weighted ``index_add``), then
the time of each, as the mean of 10 calls after a warm-up (CUDA events on
the card): the forward in bf16 and in fp32 and the forward plus backward of
``sum(spmm(x) ** 2)``.  The lines are named as the JAX script's, with
"cuda" for its "pallas"; the JAX script has no fp32 line for the grouped
SpMM, which this one adds.  ``--device -1`` runs the plain versions on the
CPU.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

D = 128
REPS = 10
SIZES = {"full": (100_000, 10_000_000), "small": (4096, 200_000)}


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--small", action="store_true")
    p.add_argument("--device", type=int, default=0,
                   help="CUDA device index; -1 runs on the CPU")
    return p


def draw_graph(n: int, n_edges: int):
    """(src, dst, val, x) of the JAX script, from ``default_rng(0)``."""
    rng = np.random.default_rng(0)
    src = rng.integers(0, n, n_edges)
    dst = rng.integers(0, n, n_edges)
    val = rng.random(n_edges).astype(np.float32) + 0.5
    x = rng.normal(size=(n, D)).astype(np.float32)
    return src, dst, val, x


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    """Runs the benchmark; returns its numbers: the two relative errors,
    the layout build times and the ms of each timed line."""
    from dream_gnn_tpu_torch.graph.blocked import blocked_pair_from_arrays
    from dream_gnn_tpu_torch.graph.coo import coo_from_arrays
    from dream_gnn_tpu_torch.graph.grouped import grouped_pair_from_arrays
    from dream_gnn_tpu_torch.kernels.spmm import spmm_coo
    from dream_gnn_tpu_torch.kernels.spmm_blocked import spmm_blocked
    from dream_gnn_tpu_torch.kernels.spmm_gather import spmm_gather
    from dream_gnn_tpu_torch.utils.profiling import StepTimer
    from dream_gnn_tpu_torch.utils.device import resolve_device, set_numerics

    args = build_parser().parse_args(argv)
    device = resolve_device("cpu" if args.device < 0
                            else f"cuda:{args.device}")
    set_numerics()
    n, n_edges = SIZES["small" if args.small else "full"]
    src, dst, val, x_np = draw_graph(n, n_edges)
    res = {}

    def build(name, fn):
        t0 = time.perf_counter()
        out = fn()
        _sync(device)
        res[f"{name} build s"] = time.perf_counter() - t0
        print(f"{name} layout build: {res[f'{name} build s']:.3f} s on "
              f"{device}", flush=True)
        return out

    pair = build("blocked", lambda: blocked_pair_from_arrays(
        src, dst, val, n, n, device=device))
    g = coo_from_arrays(src, dst, val, n, n, device=device)
    x = torch.from_numpy(x_np).to(device)
    timer = StepTimer(device)

    def rel_err(name, spmm, layout):
        with torch.no_grad():
            o1 = spmm_coo(g, x)
            o2 = spmm(layout, x, torch.float32)
        res[f"rel err {name}"] = float(
            (o1 - o2).abs().max() / (1e-6 + o1.abs().max()))
        print(f"rel err {name} vs segment_sum: "
              f"{res[f'rel err {name}']:.2e}", flush=True)

    def timed(name, fn):
        fn()
        timer.start()
        for _ in range(REPS):
            fn()
        ms = timer.stop(REPS)
        res[name] = ms
        print(f"{name:34s} {ms:9.4f} ms  ({n_edges / ms * 1e3:.3e} edges/s)",
              flush=True)

    def fwd(spmm, *args):
        def run():
            with torch.no_grad():
                spmm(*args)
        return run

    def fwd_bwd(spmm, layout):
        def run():
            y = x.clone().requires_grad_(True)
            (spmm(layout, y) ** 2).sum().backward()
        return run

    def coo(layout, y, dtype=None):
        return spmm_coo(layout, y)

    rel_err("blocked", spmm_blocked, pair)
    timed("segment_sum fwd", fwd(coo, g, x))
    timed("blocked cuda fwd (bf16)", fwd(spmm_blocked, pair, x))
    timed("blocked cuda fwd (fp32)",
          fwd(spmm_blocked, pair, x, torch.float32))
    timed("segment_sum fwd+bwd", fwd_bwd(coo, g))
    timed("blocked cuda fwd+bwd", fwd_bwd(spmm_blocked, pair))

    gpair = build("grouped", lambda: grouped_pair_from_arrays(
        src, dst, val, n, n, device=device))
    rel_err("gather", spmm_gather, gpair)
    timed("gather cuda fwd (bf16)", fwd(spmm_gather, gpair, x))
    timed("gather cuda fwd (fp32)", fwd(spmm_gather, gpair, x,
                                        torch.float32))
    timed("gather cuda fwd+bwd", fwd_bwd(spmm_gather, gpair))
    return res


if __name__ == "__main__":
    main()

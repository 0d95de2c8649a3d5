"""Edges/s scaling of the edge-partitioned SpMM over 1, 2, 4 and 8 shards.

    python -m dream_gnn_tpu_torch.scripts.bench_scaling [--small]
    python -m dream_gnn_tpu_torch.scripts.bench_scaling --cpu-mesh [--small]

Port of ``scripts/bench_scaling.py`` of the JAX package.  It times
``spmm_sharded`` (sharding/edge_partition.py: each rank aggregates the
messages of its destination rows' edges, with ``index_add``, no kernel)
over the first S ranks, S = 1, 2, 4, 8 and the world size (those of them
that the ranks allow), on the JAX script's graph: 100k x 100k nodes, 10M
edges from ``default_rng(0)`` with values in [0.5, 1.5), x of width 128
(``--small``: 4096 nodes, 200k edges).  Each S is 10 chained forward
passes, x scaled a little between them, as the JAX script's scan, timed on
rank 0's host clock between barriers that end with the device
synchronised; it prints ms, edges/s and the efficiency edges/s / (S x the
one-shard edges/s).

The ranks come from ``torchrun``'s environment, else 8 of them are
spawned: NCCL with one rank a card where there are that many cards, else
gloo, the ranks on ``cuda:{rank % cards}``.  The printed
transport says which: ranks that share one card measure how they share
it and the host's staging, not a fabric.  ``--cpu-mesh`` runs 8 gloo ranks
on the CPU, the JAX script's check of the code path (no time there is a
device number).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

SIZES = {"full": (100_000, 10_000_000), "small": (4096, 200_000)}
D = 128
SHARDS = (1, 2, 4, 8)
STEPS = 10
NPROC = 8


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--small", action="store_true")
    p.add_argument("--cpu-mesh", action="store_true",
                   help="8 gloo ranks on the CPU")
    return p


def _problem(small: bool):
    """(graph, x) of the JAX script, as numpy."""
    n, e = SIZES["small" if small else "full"]
    rng = np.random.default_rng(0)
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    val = (rng.random(e) + 0.5).astype(np.float32)
    x = rng.normal(size=(n, D)).astype(np.float32)
    return n, e, src, dst, val, x


def _rank(device, args) -> list:
    """One rank: every shard count it takes part in; returns rank 0's
    rows (shards, ms, edges/s, efficiency)."""
    import torch.distributed as dist

    from dream_gnn_tpu_torch.graph.coo import coo_from_arrays
    from dream_gnn_tpu_torch.sharding.collectives import sum_ranks
    from dream_gnn_tpu_torch.sharding.edge_partition import (
        put_sharded_coo, shard_coo_by_dst, spmm_sharded)
    from dream_gnn_tpu_torch.sharding.mesh import make_mesh
    from dream_gnn_tpu_torch.sharding.multihost import describe

    if device.type == "cpu":
        torch.set_num_threads(1)
    world, rank = dist.get_world_size(), dist.get_rank()
    n, e, src, dst, val, x_np = _problem(args.small)
    g = coo_from_arrays(src, dst, val, n, n, device="cpu")
    x0 = torch.from_numpy(x_np).to(device)
    if rank == 0:
        print(f"{describe()}; graph {n}x{n}, {e} edges, d = {D}",
              flush=True)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dist.barrier()

    rows, base = [], None
    for s in sorted({s for s in (*SHARDS, world) if s <= world}):
        mesh = make_mesh(dp=s, mp=1)        # every rank: new_group
        if not mesh.contains_me:
            dist.barrier()
            dist.barrier()
            continue
        group = mesh.group("dp")
        sg = put_sharded_coo(mesh, "dp", shard_coo_by_dst(g, s), device)

        def run(x):
            total = None
            for _ in range(STEPS):
                out = spmm_sharded(mesh, "dp", sg, x, x_sharded=False)
                total = sum_ranks(out.sum(), group)
                x = x * 1.000001
            return total

        with torch.no_grad():
            run(x0)                          # warm-up
            sync()
            t0 = time.perf_counter()
            total = run(x0)
            sync()
        ms = (time.perf_counter() - t0) / STEPS * 1e3
        if not bool(torch.isfinite(total)):
            raise AssertionError(f"shards={s}: sum {float(total)}")
        eps = e / ms * 1e3
        base = eps if base is None else base
        rows.append((s, ms, eps, eps / (base * s) * 100.0))
        if rank == 0:
            print(f"shards={s:2d}  {ms:8.2f} ms  {eps:.3e} edges/s  "
                  f"efficiency={rows[-1][3]:5.1f}%", flush=True)
    return rows


def main(argv=None) -> list:
    """Runs the benchmark; returns rank 0's rows (shards, ms, edges/s,
    efficiency in %)."""
    from dream_gnn_tpu_torch.sharding import multihost

    args = build_parser().parse_args(sys.argv[1:] if argv is None else argv)
    cpu = args.cpu_mesh
    if not cpu and not torch.cuda.is_available():
        raise RuntimeError("bench_scaling times the card and finds none; "
                           "--cpu-mesh checks the code path on the CPU")
    world = int(os.environ.get("WORLD_SIZE", NPROC))
    cards = 0 if cpu else torch.cuda.device_count()
    backend = "nccl" if cards >= world else "gloo"
    if "WORLD_SIZE" in os.environ:
        return _rank(multihost.initialize(backend, cpu=cpu), args)
    return multihost.spawn(_rank, NPROC, backend, (args,), cpu=cpu)


if __name__ == "__main__":
    main()

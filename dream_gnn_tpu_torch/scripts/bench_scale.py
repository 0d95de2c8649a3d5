"""Scaling benchmark: a training step of the sparse model on a large
synthetic bipartite graph (100k x 100k nodes, 10M edges).

    python -m dream_gnn_tpu_torch.scripts.bench_scale [--grouped]
        [--small | --tiny] [--device -1]
    python -m dream_gnn_tpu_torch.scripts.bench_scale
        (--sharded | --sharded-grouped | --ring | --cpu-mesh)
        [--nproc S] [--backend nccl|gloo] [--small | --tiny] [--device -1]

Port of ``scripts/bench_scale.py`` of the JAX package (:22-173).  The
encoder graph is the padded-COO layout (graph/bipartite_coo.py, aggregated
by ``index_add``: no kernel) or, with ``--grouped``, the grouped layout
(graph/grouped.py) over the grouped SpMM kernel (kernels/spmm_gather.py).
The problem is the JAX script's: the graph from ``default_rng(0)`` (rating
1 at 0.3), the node features, decoder candidates and labels from
``default_rng(1)``; D = 128, three GCMC layers 384/128, FGCN 256/128 over
identity ``CooGraph``s, the plain edge decoder on every candidate, bf16,
``beta = 0`` and no augmentation.  ``--small`` is 4096 nodes and 200k
edges, ``--tiny`` 1024 nodes and 8,000 edges.

The multi-device modes shard the encoder graph by destination row over S
ranks (sharding/scale_graph.py): ``--sharded`` in padded-COO blocks,
``--sharded-grouped`` in grouped blocks over the SpMM kernel with an
all-gather halo, ``--ring`` the same with a ring halo.  The ranks come from
``torchrun``'s environment, else ``--nproc S`` of them are spawned (default:
one a card).  ``--backend`` is NCCL (one rank a card; the default on cards)
or gloo (the CPU's, and ranks sharing a card; sharding/collectives.py);
ranks use ``cuda:{rank % cards}``.  ``--cpu-mesh`` is the
JAX script's correctness check: 8 gloo ranks on the CPU (with no layout
flag, ``--sharded-grouped``), one step, a finite loss, ``cpu-mesh check
OK``.  The decoder and everything outside the GCMC route run on every rank
(train/step.py).

Output, as the JAX script's: the loss after the first 20 steps, then
ms/step, the best of 3 x 20 steps (CUDA events on the card), and message
edges per second by the JAX formula; also the layout build time and the
peak device memory (per rank in the multi-device modes, with the backend,
world size and card count).  ``--steps`` and ``--repeats`` change the 20
and the 3.  ``--device -1`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

FEAT_DIM = 128
STEPS = 20
REPEATS = 3
SIZES = {"full": (100_000, 10_000_000, 1_000_000),
         "small": (4096, 200_000, 100_000),
         "tiny": (1024, 8_000, 10_000)}      # nodes, edges, candidates
CPU_MESH_RANKS = 8


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--grouped", action="store_true",
                   help="the grouped encoder layout (the grouped SpMM kernel)")
    size = p.add_mutually_exclusive_group()
    size.add_argument("--small", action="store_true")
    size.add_argument("--tiny", action="store_true")
    p.add_argument("--device", type=int, default=0,
                   help="CUDA device index; -1 runs on the CPU")
    layout = p.add_mutually_exclusive_group()
    layout.add_argument("--sharded", action="store_true",
                        help="the encoder dst-sharded over the ranks in "
                             "padded-COO blocks")
    layout.add_argument("--sharded-grouped", action="store_true",
                        help="dst-sharded grouped blocks, all-gather halo")
    layout.add_argument("--ring", action="store_true",
                        help="dst-sharded grouped blocks, ring halo")
    p.add_argument("--cpu-mesh", action="store_true",
                   help=f"{CPU_MESH_RANKS} gloo ranks on the CPU, one step")
    p.add_argument("--nproc", type=int, default=None,
                   help="ranks to spawn outside torchrun (default: the "
                        "cards)")
    p.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                   help="nccl (default on cards) or gloo (the CPU's)")
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--repeats", type=int, default=None)
    return p


def _edges(n: int, n_edges: int):
    """The JAX script's ``default_rng(0)`` edges, rating 1 at 0.3."""
    rng0 = np.random.default_rng(0)
    dr = rng0.integers(0, n, n_edges)
    di = rng0.integers(0, n, n_edges)
    vals = (rng0.random(n_edges) < 0.3).astype(np.float32)
    return np.stack([dr, di]), vals


def build_graph(n: int, n_edges: int, grouped: bool, device):
    """The JAX script's encoder graph in the padded-COO or the grouped
    layout."""
    from dream_gnn_tpu_torch.graph.bipartite_coo import synthetic_bipartite_coo
    from dream_gnn_tpu_torch.graph.grouped import build_enc_graph_grouped

    if not grouped:
        return synthetic_bipartite_coo(n, n, n_edges, seed=0, device=device)
    return build_enc_graph_grouped(*_edges(n, n_edges), n, n, device=device)


def build_sharded_graph(n: int, n_edges: int, layout: str, mesh, device):
    """This rank's blocks of the JAX script's encoder graph over the mesh's
    ``dp`` axis, in the ``sharded``, ``sharded_grouped`` or ``ring``
    layout."""
    from dream_gnn_tpu_torch.sharding.scale_graph import (
        build_enc_graph_sharded, build_enc_graph_sharded_grouped)

    if layout == "sharded":
        return build_enc_graph_sharded(*_edges(n, n_edges), n, n, mesh, "dp",
                                       device=device)
    return build_enc_graph_sharded_grouped(*_edges(n, n_edges), n, n, mesh,
                                           "dp", ring=layout == "ring",
                                           device=device)


def model_config():
    from dream_gnn_tpu_torch.config import ModelConfig

    return ModelConfig(
        layers=3, gcn_agg_units=384, gcn_out_units=128,
        src_in_units=FEAT_DIM, dst_in_units=FEAT_DIM, fdim_drug=FEAT_DIM,
        fdim_disease=FEAT_DIM, nhid1=256, nhid2=128,
        compute_dtype="bfloat16")


def build_inputs(graph, n: int, n_cand: int, device):
    """(ModelInputs, labels) of the JAX script: features and candidates
    from ``default_rng(1)``, identity similarity graphs."""
    from dream_gnn_tpu_torch.graph.coo import coo_from_arrays
    from dream_gnn_tpu_torch.model.dream_gnn import ModelInputs

    rng = np.random.default_rng(1)

    def t(x):
        return torch.from_numpy(x).to(device)

    drug_feat = t(rng.normal(size=(n, FEAT_DIM)).astype(np.float32))
    dis_feat = t(rng.normal(size=(n, FEAT_DIM)).astype(np.float32))
    dec_src = t(rng.integers(0, n, n_cand).astype(np.int32))
    dec_dst = t(rng.integers(0, n, n_cand).astype(np.int32))
    labels = t((rng.random(n_cand) < 0.3).astype(np.float32))
    eye = coo_from_arrays(np.arange(n), np.arange(n),
                          np.ones(n, np.float32), n, n, device=device)
    inputs = ModelInputs(
        enc_graph=graph, dec_src=dec_src, dec_dst=dec_dst, drug_graph=eye,
        drug_sim_feat=drug_feat, drug_feat=drug_feat, dis_graph=eye,
        dis_sim_feat=dis_feat, dis_feat=dis_feat)
    return inputs, labels


def _layout(args) -> str | None:
    """The multi-device layout the flags ask for, or None."""
    for name in ("sharded", "sharded_grouped", "ring"):
        if getattr(args, name):
            return name
    return "sharded_grouped" if args.cpu_mesh else None


def _run(args, device, graph_fn, rank0: bool = True, group=None) -> dict:
    """Build the graph with ``graph_fn(n, n_edges)``, then time the steps;
    prints on ``rank0``.  Returns the numbers."""
    from dream_gnn_tpu_torch.config import AugmentConfig, TrainConfig
    from dream_gnn_tpu_torch.model.dream_gnn import init_params, named_leaves
    from dream_gnn_tpu_torch.sharding.collectives import replica_spread
    from dream_gnn_tpu_torch.train.step import (init_state, make_one_step,
                                                run_steps)
    from dream_gnn_tpu_torch.utils.profiling import StepTimer

    def say(msg):
        if rank0:
            print(msg, flush=True)

    steps = args.steps or STEPS
    repeats = REPEATS if args.repeats is None else args.repeats
    n, n_edges, n_cand = SIZES["tiny" if args.tiny else
                               "small" if args.small else "full"]
    say(f"building {n}x{n} graph, {n_edges} edges (grouped={args.grouped}, "
        f"layout={_layout(args)}) on {device}...")
    timer = StepTimer(device)
    t0 = time.perf_counter()
    graph = graph_fn(n, n_edges)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    build_s = time.perf_counter() - t0
    say(f"layout build {build_s:.3f} s")
    inputs, labels = build_inputs(graph, n, n_cand, device)
    weight = torch.ones_like(labels)

    model = model_config()
    cfg = TrainConfig(model=model, beta=0.0,   # N x N grams infeasible
                      augment=AugmentConfig(methods=()))
    gen = torch.Generator(device=device).manual_seed(0)
    state = init_state(init_params(gen, model), gen, cfg)
    one_step = make_one_step(model, cfg)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    t0 = time.perf_counter()
    losses = run_steps(one_step, state, steps, inputs, labels, weight)
    loss = float(losses[-1])
    say(f"first {steps} steps: {time.perf_counter() - t0:.1f}s "
        f"loss={loss:.4f}")
    if args.cpu_mesh:
        # The JAX script's check: a finite loss after one step, no timing.
        if not np.isfinite(loss):
            raise AssertionError(f"cpu-mesh: loss {loss}")
        say("cpu-mesh check OK")
        return dict(loss=loss)
    times = []
    for _ in range(repeats):
        timer.start()
        run_steps(one_step, state, steps, inputs, labels, weight)
        times.append(timer.stop(steps))
    ms = min(times)
    # Message edges per step: L layers x (all relation edges, both
    # directions) x fwd+bwd, plus the decoder candidates x 2.
    msg_edges = 2.0 * (model.layers * 2.0 * n_edges + n_cand)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else None)
    if device.type != "cuda":
        memory = "not measured on the CPU"
    elif group is None:
        memory = f"{peak / 2 ** 30:.2f} GiB"
    if group is not None:
        ranks = [None] * torch.distributed.get_world_size(group)
        torch.distributed.all_gather_object(ranks, (peak, build_s),
                                            group=group)
        peak, build_s = [p for p, _ in ranks], max(b for _, b in ranks)
        if device.type == "cuda":
            memory = ", ".join(f"{p / 2 ** 30:.2f} GiB" for p in peak) \
                + " (rank 0, 1, ...)"
    say(f"{ms:.2f} ms/step  -> {msg_edges / ms * 1e3:.3e} edges/s")
    say(f"peak device memory {memory}")
    res = dict(loss=loss, ms_per_step=ms, edges_per_s=msg_edges / ms * 1e3,
               layout_build_s=build_s, peak_memory_bytes=peak)
    if group is not None:
        names, leaves = zip(*named_leaves(state.params))
        res["replica_spread"] = dict(zip(names,
                                         replica_spread(leaves, group)))
        differ = sum(v != 0.0 for v in res["replica_spread"].values())
        say(f"replicated parameters: {differ} of {len(names)} differ "
            f"between the ranks")
    return res


def _sharded_rank(device, args) -> dict:
    """One rank of a multi-device run."""
    import torch.distributed as dist

    from dream_gnn_tpu_torch.kernels import spmm_gather
    from dream_gnn_tpu_torch.sharding.mesh import make_mesh
    from dream_gnn_tpu_torch.sharding.multihost import describe
    from dream_gnn_tpu_torch.utils.device import set_numerics

    set_numerics()
    if args.cpu_mesh:
        torch.set_num_threads(1)
    mesh = make_mesh(dp=dist.get_world_size())
    rank0 = dist.get_rank() == 0
    layout = _layout(args)
    if rank0:
        print(f"sharded over {mesh.shape['dp']} rank(s) (layout={layout}); "
              f"{describe()}", flush=True)
    res = _run(args, device,
               lambda n, e: build_sharded_graph(n, e, layout, mesh, device),
               rank0, mesh.group("dp"))
    # Every rank's kernel launches over the whole run.
    launches = [None] * mesh.shape["dp"]
    dist.all_gather_object(launches, dict(spmm_gather.LAUNCHES))
    return dict(res, backend=dist.get_backend(), world_size=mesh.shape["dp"],
                launches=launches)


def main(argv=None) -> dict:
    """Runs the benchmark; returns its numbers (``loss``, ``ms_per_step``,
    ``edges_per_s``, ``layout_build_s``, ``peak_memory_bytes``; in the
    multi-device modes rank 0's, with every rank's peak memory, the longest
    layout build, ``backend``, ``world_size`` and every rank's grouped SpMM
    ``launches``; after ``--cpu-mesh`` the loss only)."""
    import os

    from dream_gnn_tpu_torch.sharding import multihost
    from dream_gnn_tpu_torch.utils.device import resolve_device, set_numerics

    args = build_parser().parse_args(sys.argv[1:] if argv is None else argv)
    if _layout(args) is None:
        device = resolve_device("cpu" if args.device < 0
                                else f"cuda:{args.device}")
        set_numerics()
        return _run(args, device,
                    lambda n, e: build_graph(n, e, args.grouped, device))
    if args.grouped:
        raise ValueError("--grouped is the one-device layout; the sharded "
                         "ones are --sharded-grouped and --ring")
    cpu = args.cpu_mesh or args.device < 0
    backend = args.backend or ("gloo" if cpu else "nccl")
    if cpu and backend != "gloo":
        raise ValueError("ranks on the CPU take the gloo backend")
    if "WORLD_SIZE" in os.environ:
        return _sharded_rank(multihost.initialize(backend, cpu=cpu), args)
    nproc = args.nproc or (CPU_MESH_RANKS if args.cpu_mesh
                           else torch.cuda.device_count())
    return multihost.spawn(_sharded_rank, nproc, backend, (args,), cpu=cpu)


if __name__ == "__main__":
    main()

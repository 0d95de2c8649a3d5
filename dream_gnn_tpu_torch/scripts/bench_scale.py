"""Scaling benchmark: a training step of the sparse model on a large
synthetic bipartite graph (100k x 100k nodes, 10M edges).

    python -m dream_gnn_tpu_torch.scripts.bench_scale [--grouped]
        [--small | --tiny] [--device -1]

Port of ``scripts/bench_scale.py`` of the JAX package (:22-173), on one
device.  The encoder graph is the padded-COO layout (graph/bipartite_coo.py,
aggregated by ``index_add``: no kernel) or, with ``--grouped``, the grouped
layout (graph/grouped.py) over the grouped SpMM kernel
(kernels/spmm_gather.py).  The problem is the JAX script's: the graph from
``default_rng(0)`` (rating 1 at 0.3), the node features, decoder candidates
and labels from ``default_rng(1)``; D = 128, three GCMC layers 384/128,
FGCN 256/128 over identity ``CooGraph``s, the plain edge decoder, bf16,
``beta = 0`` and no augmentation.  ``--small`` is 4096 nodes and 200k
edges, ``--tiny`` 1024 nodes and 8,000 edges.

Output, as the JAX script's: the loss after the first 20 steps, then
ms/step, the best of 3 x 20 steps (CUDA events on the card), and message
edges per second by the JAX formula; also the layout build time and the
peak device memory.  ``--device -1`` runs on the CPU.  The multi-device
modes (``--sharded``, ``--sharded-grouped``, ``--ring``, ``--cpu-mesh``)
are not ported yet (ROADMAP.md queue A, item 10) and raise.
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
UNPORTED = ("--sharded", "--sharded-grouped", "--ring", "--cpu-mesh")


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--grouped", action="store_true",
                   help="the grouped encoder layout (the grouped SpMM kernel)")
    size = p.add_mutually_exclusive_group()
    size.add_argument("--small", action="store_true")
    size.add_argument("--tiny", action="store_true")
    p.add_argument("--device", type=int, default=0,
                   help="CUDA device index; -1 runs on the CPU")
    return p


def build_graph(n: int, n_edges: int, grouped: bool, device):
    """The JAX script's encoder graph: ``default_rng(0)`` edges, rating 1
    with probability 0.3, in the padded-COO or the grouped layout."""
    from dream_gnn_tpu_torch.graph.bipartite_coo import synthetic_bipartite_coo
    from dream_gnn_tpu_torch.graph.grouped import build_enc_graph_grouped

    if not grouped:
        return synthetic_bipartite_coo(n, n, n_edges, seed=0, device=device)
    rng0 = np.random.default_rng(0)
    dr = rng0.integers(0, n, n_edges)
    di = rng0.integers(0, n, n_edges)
    vals = (rng0.random(n_edges) < 0.3).astype(np.float32)
    return build_enc_graph_grouped(np.stack([dr, di]), vals, n, n,
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


def main(argv=None) -> dict:
    """Runs the benchmark; returns its numbers (``loss``, ``ms_per_step``,
    ``edges_per_s``, ``layout_build_s``, ``peak_memory_bytes``)."""
    from dream_gnn_tpu_torch.config import AugmentConfig, TrainConfig
    from dream_gnn_tpu_torch.model.dream_gnn import init_params
    from dream_gnn_tpu_torch.utils.profiling import StepTimer
    from dream_gnn_tpu_torch.train.step import (init_state, make_one_step,
                                                run_steps)
    from dream_gnn_tpu_torch.utils.device import resolve_device, set_numerics

    argv = sys.argv[1:] if argv is None else list(argv)
    for flag in UNPORTED:
        if flag in argv:
            raise NotImplementedError(
                f"{flag}: the multi-device scale layouts are not ported yet "
                f"(ROADMAP.md queue A, item 10)")
    args = build_parser().parse_args(argv)
    device = resolve_device("cpu" if args.device < 0
                            else f"cuda:{args.device}")
    set_numerics()
    n, n_edges, n_cand = SIZES["tiny" if args.tiny else
                               "small" if args.small else "full"]
    print(f"building {n}x{n} graph, {n_edges} edges (grouped={args.grouped})"
          f" on {device}...", flush=True)
    timer = StepTimer(device)
    t0 = time.perf_counter()
    graph = build_graph(n, n_edges, args.grouped, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    build_s = time.perf_counter() - t0
    print(f"layout build {build_s:.3f} s", flush=True)
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
    losses = run_steps(one_step, state, STEPS, inputs, labels, weight)
    loss = float(losses[-1])
    print(f"first {STEPS} steps: {time.perf_counter() - t0:.1f}s "
          f"loss={loss:.4f}", flush=True)
    times = []
    for _ in range(REPEATS):
        timer.start()
        run_steps(one_step, state, STEPS, inputs, labels, weight)
        times.append(timer.stop(STEPS))
    ms = min(times)
    # Message edges per step: L layers x (all relation edges, both
    # directions) x fwd+bwd, plus the decoder candidates x 2.
    msg_edges = 2.0 * (model.layers * 2.0 * n_edges + n_cand)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else None)
    print(f"{ms:.2f} ms/step  -> {msg_edges / ms * 1e3:.3e} edges/s",
          flush=True)
    print("peak device memory "
          + ("not measured on the CPU" if peak is None
             else f"{peak / 2 ** 30:.2f} GiB"), flush=True)
    return dict(loss=loss, ms_per_step=ms, edges_per_s=msg_edges / ms * 1e3,
                layout_build_s=build_s, peak_memory_bytes=peak)


if __name__ == "__main__":
    main()

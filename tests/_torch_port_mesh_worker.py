"""The rank side of the dp x mp mesh's CPU tests
(tests/test_torch_port_decoder_spmd.py, tests/test_torch_port_mesh_step.py).

``run`` is what every gloo rank of one spawn executes
(``sharding.multihost.spawn``): it builds the (dp, mp) mesh of the spawn's
ranks and the (1, 1) mesh of rank 0, runs the named cases in order and
writes its results, numpy arrays by name, to ``rank{r}.pt`` under the
spawn's directory.  The inputs are made here from numpy seeds, or read
from ``inputs.pt`` there (JAX-initialised weights as numpy arrays, written
by the test).  This module imports no JAX: the ranks load PyTorch only.

A case that compares the mesh with one rank runs the one-rank version on
rank 0 over the (1, 1) mesh, in the same spawn, and ``mesh_vs_one`` also
runs it without a mesh.
"""

from __future__ import annotations

import dataclasses
import os
from unittest import mock

import numpy as np
import torch
import torch.distributed as dist

from dream_gnn_tpu_torch.config import (AugmentConfig, ModelConfig,
                                        TrainConfig, wide_model_config)
from dream_gnn_tpu_torch.convert import params_from_jax
from dream_gnn_tpu_torch.data.loader import DreamDataset
from dream_gnn_tpu_torch.data.synthetic import synthetic_raw_data
from dream_gnn_tpu_torch.kernels.edge_decoder import \
    decoder_apply_fused_batched
from dream_gnn_tpu_torch.kernels.grid_decoder import (
    decoder_apply_grid_fused_batched, node_projections)
from dream_gnn_tpu_torch.model.dream_gnn import (map_params, named_leaves,
                                                 param_leaves)
from dream_gnn_tpu_torch.sharding.collectives import (RowBlock,
                                                       replica_spread)
from dream_gnn_tpu_torch.sharding.decoder_spmd import (
    fused_grid_decoder_spmd2d, shard_edges)
from dream_gnn_tpu_torch.sharding.foldstack import stack_folds
from dream_gnn_tpu_torch.sharding.mesh import make_mesh
from dream_gnn_tpu_torch.sharding.partition import (
    make_multichip_train_fns, make_multichip_train_step, shard_stacked,
    shard_state)
from dream_gnn_tpu_torch.train.loop import derive_model_cfg
from dream_gnn_tpu_torch.train.stacked import (init_params_stacked,
                                               init_state_stacked,
                                               make_one_step_stacked,
                                               stack_seed, stacked_loss)
from dream_gnn_tpu_torch.train.step import run_steps as _run_steps
from dream_gnn_tpu_torch.utils import draws

# The JAX tests' problems: test_sharding.py, test_decoder_spmd.py and
# test_wide_config.py.
DATA = dict(n_drug=24, n_dis=16, n_pos=48, seed=1)
WIDE_DATA = dict(n_drug=30, n_dis=24, n_pos=60, seed=13)
MODEL = dict(layers=2, gcn_agg_units=24, gcn_out_units=8, nhid1=16, nhid2=8)
WIDE = dict(gcn_agg_units=96, gcn_out_units=32, nhid1=48, nhid2=32)
DECODER = dict(f=3, nd=10, nv=9, d=12, e=37, h1=16, h2=8)
ALL_METHODS = ("edge_dropout", "add_random_edges", "graph_noise",
               "feature_noise", "feature_masking", "mix_up")
FOLDS = [0, 1, 2, 3]
STEPS = 3


def _np(x):
    return x.detach().cpu().numpy()


def fold_rows(mesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's block of the folds of a whole (F, ...) stack over
    ``dp``, zero-padded to ceil(F / dp) folds; the backward gathers the
    blocks' gradients into the whole stack's."""
    return RowBlock(x.shape[0], mesh.group("dp")).shard_rows(x)


def fold_gather(mesh, x: torch.Tensor, n_folds: int) -> torch.Tensor:
    """The whole (F, ...) stack from every rank's block of folds."""
    return RowBlock(n_folds, mesh.group("dp")).gather(x)


def _edge_args(mesh, src, dst):
    """This rank's folds of the (F, E) edge lists."""
    return fold_rows(mesh, src), fold_rows(mesh, dst)


def _shard(mesh, src, dst, drug, dis):
    """This rank's ``EdgeShard`` of its folds' edge lists."""
    return shard_edges(mesh, *_edge_args(mesh, src, dst), drug.shape[-2],
                       dis.shape[-2])


def dataset(device, data=DATA):
    return DreamDataset(synthetic_raw_data(**data), k=3, device=device)


def model_cfg(ds, train_cfg=None, **kw):
    """The JAX tests' small model over ``ds`` (``kw`` on top)."""
    cfg = train_cfg or TrainConfig()
    return dataclasses.replace(derive_model_cfg(cfg, ds), **dict(MODEL, **kw))


# ---------------------------------------------------------------------------
# The three decoder wrappers against the JAX package's.

def _leaves(tree, dev):
    return map_params(lambda t: t.to(dev).requires_grad_(True),
                      params_from_jax(tree, dev))


def case_wrappers(ctx):
    """The three wrappers' logits and the gradients of sum(sin(logits))
    (dropout 0, f32; tests/test_decoder_spmd.py of the JAX package): the
    fold-batched grid and per-edge decoders over the mesh's folds and mp
    blocks, and one fold's grid over the 2-D mesh."""
    mesh, dev, inp = ctx["mesh"], ctx["device"], ctx["inputs"]
    drug = torch.tensor(inp["drug_feat"], device=dev)
    dis = torch.tensor(inp["dis_feat"], device=dev)
    src = torch.tensor(inp["src"], device=dev)
    dst = torch.tensor(inp["dst"], device=dev)
    n_folds = drug.shape[0]
    out = {}
    kw = dict(dropout_rate=0.0, train=False, dtype=torch.float32, mesh=mesh)
    for tag in ("grid", "edges"):
        params = _leaves(inp["decoder"], dev)
        blk = map_params(lambda t: fold_rows(mesh, t), params)
        if tag == "grid":
            logits = decoder_apply_grid_fused_batched(
                blk, fold_rows(mesh, drug), fold_rows(mesh, dis), **kw)
        else:
            logits = decoder_apply_fused_batched(
                blk, *_edge_args(mesh, src, dst), fold_rows(mesh, drug),
                fold_rows(mesh, dis), shard=_shard(mesh, src, dst, drug, dis),
                **kw)
        logits = fold_gather(mesh, logits, n_folds)
        torch.sum(torch.sin(logits)).backward()
        out[f"{tag}_logits"] = _np(logits)
        out.update({f"{tag}_grad/{k}": _np(p.grad)
                    for k, p in named_leaves(params)})
    # One fold (fold 0) over the 2-D mesh: drug rows over dp, diseases
    # over mp.
    dec = _leaves({k: v[0] for k, v in inp["decoder"].items()}, dev)
    pd, pv = node_projections(dec, drug[0], dis[0], torch.float32)
    logits = fused_grid_decoder_spmd2d(
        mesh, "dp", "mp", pd, pv, dec["b1"], dec["w2"], dec["b2"],
        dec["w3"][:, 0], torch.zeros(1, dtype=torch.int32, device=dev), 0.0,
        False, torch.float32) + dec["b3"][0]
    torch.sum(torch.sin(logits)).backward()
    out["spmd2d_logits"] = _np(logits)
    out.update({f"spmd2d_grad/{k}": _np(p.grad)
                for k, p in named_leaves(dec)})
    return out


def case_wrappers_dropout(ctx):
    """The three wrappers with dropout 0.5 in training, against the same
    decoders without a mesh (the kernels' plain versions on the whole
    stack) with the same seeds: the logits and the gradients of
    sum(sin(logits)) on the mesh, then on rank 0 without one."""
    dev, inp = ctx["device"], ctx["inputs"]
    drug = torch.tensor(inp["drug_feat"], device=dev)
    dis = torch.tensor(inp["dis_feat"], device=dev)
    src = torch.tensor(inp["src"], device=dev)
    dst = torch.tensor(inp["dst"], device=dev)
    n_folds = drug.shape[0]

    def run(mesh):
        out = {}
        kw = dict(dropout_rate=0.5, train=True, dtype=torch.float32)
        for tag in ("grid", "edges"):
            params = _leaves(inp["decoder"], dev)
            gen = torch.Generator(dev).manual_seed(11)
            edges = {}
            if mesh is None:
                args = (params, drug, dis) if tag == "grid" \
                    else (params, src, dst, drug, dis)
            else:
                blk = map_params(lambda t: fold_rows(mesh, t), params)
                args = (blk, fold_rows(mesh, drug), fold_rows(mesh, dis))
                if tag == "edges":
                    args = (blk, *_edge_args(mesh, src, dst), *args[1:])
                    edges["shard"] = _shard(mesh, src, dst, drug, dis)
            fn = decoder_apply_grid_fused_batched if tag == "grid" \
                else decoder_apply_fused_batched
            # The seeds of the whole (padded) stack, so the folds' seeds
            # agree between the mesh and one rank.
            n_pad = -(-n_folds // 2) * 2
            block = draws.fold_block(n_pad, 0, n_folds) if mesh is None \
                else mesh.fold_draws(args[0]["b1"].shape[0])
            with block:
                logits = fn(*args, generator=gen, mesh=mesh, **kw, **edges)
            if mesh is not None:
                logits = fold_gather(mesh, logits, n_folds)
            torch.sum(torch.sin(logits)).backward()
            out[f"{tag}_logits"] = _np(logits)
            out.update({f"{tag}_grad/{k}": _np(p.grad)
                        for k, p in named_leaves(params)})
        dec = _leaves({k: v[0] for k, v in inp["decoder"].items()}, dev)
        pd, pv = node_projections(dec, drug[0], dis[0], torch.float32)
        seed = torch.tensor([918273], dtype=torch.int32, device=dev)
        w = (dec["b1"], dec["w2"], dec["b2"], dec["w3"][:, 0], seed, 0.5,
             True, torch.float32)
        if mesh is None:
            from dream_gnn_tpu_torch.kernels.grid_decoder import \
                fused_grid_decoder
            logits = fused_grid_decoder(pd, pv, *w)
        else:
            logits = fused_grid_decoder_spmd2d(mesh, "dp", "mp", pd, pv, *w)
        torch.sum(torch.sin(logits + dec["b3"][0])).backward()
        out["spmd2d_logits"] = _np(logits)
        out.update({f"spmd2d_grad/{k}": _np(p.grad)
                    for k, p in named_leaves(dec)})
        return out

    out = {f"drop/S/{k}": v for k, v in run(ctx["mesh"]).items()}
    if dist.get_rank() == 0:
        out.update({f"drop/1/{k}": v for k, v in run(None).items()})
    return out


# ---------------------------------------------------------------------------
# The mesh step.

def _stack(ds, folds, side="train"):
    return stack_folds(ds, folds, pad_multiple=64, side=side)


def case_step_runs(ctx):
    """test_multichip_step_runs (JAX tests/test_sharding.py:41): dp folds,
    two steps of ``make_multichip_train_step``; the (dp,) losses."""
    mesh, dev = ctx["mesh"], ctx["device"]
    dp = mesh.shape["dp"]
    ds = dataset(dev)
    cfg = TrainConfig()
    stacked = shard_stacked(mesh, _stack(ds, list(range(dp))))
    init_state, step = make_multichip_train_step(mesh, model_cfg(ds), cfg)
    state = init_state(0, dp, dev)
    return {"runs_losses": np.stack([_np(step(state, stacked))
                                     for _ in range(2)])}


def case_single_device(ctx):
    """test_sharded_matches_single_device (:57): one step of the mesh's
    folds 0 and 1 from JAX's weights, dropout 0 and no augmentation, with
    the plain decoder (the JAX test's) and with the fused one."""
    mesh, dev = ctx["mesh"], ctx["device"]
    ds = dataset(dev)
    cfg = TrainConfig(augment=AugmentConfig(methods=()))
    out = {}
    for backend in ("xla", "pallas"):
        mcfg = model_cfg(ds, cfg, dropout=0.0, attention_dropout=0.0,
                         decoder_backend=backend)
        stacked = shard_stacked(mesh, _stack(ds, [0, 1]))
        state = shard_state(mesh, init_state_stacked(
            params_from_jax(ctx["inputs"]["params"], dev),
            torch.Generator(dev).manual_seed(0), cfg))
        _, step = make_multichip_train_step(mesh, mcfg, cfg)
        out[f"single_{backend}"] = _np(step(state, stacked))
    return out


def case_interval(ctx):
    """test_multichip_interval_matches_unsharded (:114): four steps and
    both evaluations of four folds (the default augmentation and dropout)
    over the mesh, and over rank 0 alone."""
    dev = ctx["device"]
    ds = dataset(dev)
    cfg = TrainConfig()
    mcfg = model_cfg(ds, decoder_backend="pallas")

    def run(mesh):
        init_state, _, run_interval = make_multichip_train_fns(mesh, mcfg,
                                                               cfg)
        state = init_state(5, FOLDS, dev)
        tr, te = (shard_stacked(mesh, _stack(ds, FOLDS, side))
                  for side in ("train", "test"))
        return {"metrics": _np(run_interval(state, tr, te, 4))}
    return _ranks_and_one(ctx, "interval", run)


def case_wide(ctx):
    """test_wide_config_multichip_fold_parallel (tests/test_wide_config.py
    :26): one step of the wide model's structure (five layers, scaled-down
    widths) over four folds."""
    mesh, dev = ctx["mesh"], ctx["device"]
    ds = dataset(dev, WIDE_DATA)
    cfg = TrainConfig(model=wide_model_config(**WIDE,
                                              compute_dtype="float32"))
    mcfg = dataclasses.replace(derive_model_cfg(cfg, ds), layers=5, **WIDE)
    stacked = shard_stacked(mesh, _stack(ds, FOLDS))
    init_state, step = make_multichip_train_step(mesh, mcfg, cfg)
    state = init_state(0, len(FOLDS), dev)
    return {"wide_losses": _np(step(state, stacked))}


def _ranks_and_one(ctx, tag, fn):
    """``fn(mesh)`` over the spawn's mesh, then over rank 0's (1, 1) mesh;
    results keyed ``tag/S/...`` and ``tag/1/...`` (the latter on rank 0
    only)."""
    out = {f"{tag}/S/{k}": v for k, v in fn(ctx["mesh"]).items()}
    if dist.get_rank() == 0:
        out.update({f"{tag}/1/{k}": v for k, v in fn(ctx["mesh1"]).items()})
    return out


def _recorded(log: list):
    """Every draw of utils/draws.py appended to ``log`` as (fold axis,
    the rank's block of the draw)."""
    plain = draws._draw

    def record(fn, shape, fold_dim):
        x = plain(fn, shape, fold_dim)
        log.append((fold_dim, _np(x.float())))
        return x
    return mock.patch.object(draws, "_draw", record)


def mesh_vs_one(ctx, mesh, mode: str, dtype: str, steps: int = STEPS):
    """Four folds with dropout and all six augment methods over ``mesh``,
    or with ``mesh`` None through the stacked step without one
    (train/stacked.py, no code of sharding/partition.py or
    decoder_spmd.py): every draw of the first step's loss (the
    augmentation, the encoder's dropout, the decoder seeds), its losses and
    gradients, the losses of
    ``steps`` steps, the parameters after them, and on a mesh each
    parameter's largest difference within the rank's mp group."""
    dev = ctx["device"]
    ds = dataset(dev)
    cfg = TrainConfig(augment=AugmentConfig(methods=ALL_METHODS))
    mcfg = model_cfg(ds, cfg, decode_mode=mode, decoder_backend="pallas",
                     compute_dtype=dtype)
    tr = _stack(ds, FOLDS)
    if mesh is None:
        state = init_state_stacked(
            init_params_stacked(mcfg, [0], FOLDS, dev),
            torch.Generator(dev).manual_seed(stack_seed([0], FOLDS)), cfg)
        one_step = make_one_step_stacked(mcfg, cfg)

        def run_steps(state, tr, n):
            return _run_steps(one_step, state, n, tr.inputs, tr.labels,
                              tr.edge_weight)[-1]
    else:
        init_state, run_steps, _ = make_multichip_train_fns(mesh, mcfg, cfg)
        state = init_state(0, FOLDS, dev)
        tr = shard_stacked(mesh, tr, mode)
    gen = torch.Generator(dev)
    gen.set_state(state.generator.get_state())
    log = []
    with _recorded(log):
        losses = stacked_loss(state.params, tr.inputs, mcfg, cfg, gen,
                              tr.labels, tr.edge_weight, mesh)
    losses.sum().backward()
    out = {"loss0": _np(losses), "n_draws": np.asarray(len(log))}
    out.update({f"draw{i}": x for i, (_, x) in enumerate(log)})
    out.update({f"fold_dim{i}": np.asarray(d) for i, (d, _) in enumerate(log)})
    names = [k for k, _ in named_leaves(state.params)]
    for k, p in named_leaves(state.params):
        out[f"grad/{k}"] = _np(p.grad)
        p.grad = None
    out["step_losses"] = np.stack([_np(run_steps(state, tr, 1))
                                   for _ in range(steps)])
    leaves = param_leaves(state.params)
    out.update({f"param/{k}": _np(p) for k, p in zip(names, leaves)})
    if mesh is not None:
        out["mp_spread"] = np.asarray(replica_spread(leaves,
                                                     mesh.group("mp")))
    return out


def case_mesh_vs_one(ctx):
    """``mesh_vs_one`` in grid mode (bf16) and edges mode (fp32) over the
    spawn's mesh, over rank 0's (1, 1) mesh, and on rank 0 without a mesh
    (keyed ``vs_{mode}/0/...``)."""
    out = {}
    for mode, dtype in (("grid", "bfloat16"), ("edges", "float32")):
        def run(mesh):
            return mesh_vs_one(ctx, mesh, mode, dtype)
        out.update(_ranks_and_one(ctx, f"vs_{mode}", run))
        if dist.get_rank() == 0:
            out.update({f"vs_{mode}/0/{k}": v for k, v in run(None).items()})
    return out


def case_ring_compose(ctx):
    """The ring encoder over dp composed with the 2-D grid decoder over
    (dp, mp) (JAX tests/test_ring_mp_compose.py:64): the loss of the grid
    BCE on fold 0's train cells and its gradients, JAX's weights, dropout
    0."""
    from dream_gnn_tpu_torch.model.dream_gnn import ModelInputs, _encode
    from dream_gnn_tpu_torch.sharding.scale_graph import \
        build_enc_graph_sharded_grouped
    from dream_gnn_tpu_torch.train.loop import fold_inputs
    from dream_gnn_tpu_torch.train.losses import bce_with_logits

    mesh, dev = ctx["mesh"], ctx["device"]
    ds = dataset(dev)
    mcfg = model_cfg(ds, dropout=0.0, attention_dropout=0.0,
                     decode_mode="grid")
    inputs, *_ = fold_inputs(ds, 0)
    split = ds.splits[0]
    graph = build_enc_graph_sharded_grouped(
        split.train_pairs, split.train_values, ds.n_drug, ds.n_dis, mesh,
        "dp", ring=True, device=dev)
    ring = dataclasses.replace(inputs, enc_graph=graph)
    assert isinstance(ring, ModelInputs)
    params = _leaves(ctx["inputs"]["params_ring"], dev)
    drug_f, dis_f, *_ = _encode(params, ring, mcfg, train=True,
                                generator=torch.Generator(dev).manual_seed(7),
                                edge_masks=None)
    dec = params["decoder"]
    pd, pv = node_projections(dec, drug_f, dis_f, torch.float32)
    pred = fused_grid_decoder_spmd2d(
        mesh, "dp", "mp", pd, pv, dec["b1"], dec["w2"], dec["b2"],
        dec["w3"][:, 0], torch.zeros(1, dtype=torch.int32, device=dev), 0.0,
        False, torch.float32) + dec["b3"][0]
    enc = inputs.enc_graph
    loss = bce_with_logits(pred.reshape(-1), enc.a1.reshape(-1),
                           weight=enc.mask.reshape(-1))
    loss.backward()
    return {"ring_loss": _np(loss),
            **{f"ring_grad/{k}": _np(p.grad)
               for k, p in named_leaves(params)}}


def case_global_mesh(ctx):
    """``multihost.global_mesh`` over the spawn's ranks and
    ``local_shard_slice``: this rank's coordinates and slice."""
    from dream_gnn_tpu_torch.sharding.multihost import (global_mesh,
                                                        local_shard_slice)

    mesh = global_mesh(mp=2)
    sl = local_shard_slice(10)
    return {"global_mesh": np.asarray([mesh.shape["dp"], mesh.shape["mp"],
                                       mesh.index("dp"), mesh.index("mp"),
                                       sl.start, sl.stop])}


CASES = {"global_mesh": case_global_mesh, "wrappers": case_wrappers, "wrappers_dropout": case_wrappers_dropout,
         "step_runs": case_step_runs, "single_device": case_single_device,
         "interval": case_interval, "wide": case_wide,
         "mesh_vs_one": case_mesh_vs_one, "ring_compose": case_ring_compose}


def run(device, out_dir: str, cases, dp: int, mp: int) -> None:
    torch.set_num_threads(1)
    inputs_file = os.path.join(out_dir, "inputs.pt")
    ctx = dict(mesh=make_mesh(dp=dp, mp=mp), mesh1=make_mesh(dp=1, mp=1),
               device=device,
               inputs=(torch.load(inputs_file, weights_only=False)
                       if os.path.exists(inputs_file) else {}))
    res = {}
    for name in cases:
        res.update(CASES[name](ctx))
    torch.save(res, os.path.join(out_dir, f"rank{dist.get_rank()}.pt"))

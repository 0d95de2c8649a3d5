"""The rank side of the sharded scale path's CPU tests
(tests/test_torch_port_sharded_*.py).

``run`` is what every gloo rank of one spawn executes
(``sharding.multihost.spawn``): it runs the named cases in order and writes
its results, numpy arrays by name, to ``rank{r}.pt`` under the spawn's
directory.  The inputs are made here from numpy seeds, or read from
``inputs.pt`` there (JAX-initialised weights as numpy arrays, written by
the test), so the test process can rebuild the same problem for the JAX
package.  This module imports no JAX: the ranks load PyTorch only.

A case that compares S ranks with one runs the one-rank version on rank 0
over a mesh of that rank alone (``make_mesh(dp=1)``), in the same spawn.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from dream_gnn_tpu_torch.config import AugmentConfig, TrainConfig
from dream_gnn_tpu_torch.convert import params_from_jax
from dream_gnn_tpu_torch.data.loader import DreamDataset
from dream_gnn_tpu_torch.data.synthetic import synthetic_raw_data
from dream_gnn_tpu_torch.graph.coo import coo_from_arrays
from dream_gnn_tpu_torch.graph.grouped import build_enc_graph_grouped
from dream_gnn_tpu_torch.model.dream_gnn import (forward, init_params,
                                                 param_leaves)
from dream_gnn_tpu_torch.sharding.collectives import (RowBlock,
                                                       all_gather_raw,
                                                       sum_ranks)
from dream_gnn_tpu_torch.sharding.edge_partition import (put_sharded_coo,
                                                         shard_coo_by_dst,
                                                         spmm_sharded)
from dream_gnn_tpu_torch.sharding.mesh import make_mesh
from dream_gnn_tpu_torch.sharding.scale_decoder_spmd import (
    build_scale_decoder_layout_sharded, decoder_apply_scale_spmd)
from dream_gnn_tpu_torch.sharding.scale_graph import (
    build_enc_graph_sharded, build_enc_graph_sharded_grouped)
from dream_gnn_tpu_torch.train.loop import derive_model_cfg, fold_inputs
from dream_gnn_tpu_torch.train.step import (evaluate, init_state,
                                            make_one_step)

# The JAX tests' problems: test_edge_partition.py, test_sharded_scale.py
# and test_scale_decoder_spmd.py.
SPMM_SHAPES = ((64, 48, 16), (37, 29, 4))        # n_dst, n_src, d
ENCODER_DATA = dict(n_drug=30, n_dis=22, n_pos=60, seed=5)
ENCODER_MODEL = dict(layers=3, gcn_agg_units=48, gcn_out_units=16, nhid1=24,
                     nhid2=16)
DECODER = dict(n_drug=200, n_dis=160, e=1021, d=16, seed=7)
PRF_SALTS = ((11, 12345), (777, 2 ** 30 + 5))    # (fwd, rev) per rating
PRF_RATE = 0.3
STEPS = 2


def spmm_case(shape, seed: int):
    """(a (n_dst, n_src), x (n_src, d)) of one SpMM case."""
    n_dst, n_src, d = shape
    rng = np.random.default_rng(seed)
    a = ((rng.random((n_dst, n_src)) < 0.15)
         * rng.random((n_dst, n_src))).astype(np.float32)
    return a, rng.normal(size=(n_src, d)).astype(np.float32)


def coo_masks(shapes, seed: int = 3):
    """Injected keep masks of a sharded COO graph: per rating (fwd, rev),
    each (S, E_shard) from ``shapes``."""
    rng = np.random.default_rng(seed)
    return [tuple((rng.random(s) < 0.8).astype(np.float32) for s in pair)
            for pair in shapes]


def decoder_problem():
    """The JAX decoder test's candidates, features and labels."""
    p = DECODER
    rng = np.random.default_rng(p["seed"])
    drug_feat = rng.normal(size=(p["n_drug"], p["d"])).astype(np.float32)
    dis_feat = rng.normal(size=(p["n_dis"], p["d"])).astype(np.float32)
    src = rng.integers(0, p["n_drug"], p["e"])
    dst = rng.integers(0, p["n_dis"], p["e"])
    labels = (rng.random(p["e"]) < 0.3).astype(np.float32)
    return drug_feat, dis_feat, src, dst, labels


def encoder_dataset(device):
    return DreamDataset(synthetic_raw_data(**ENCODER_DATA), k=3, device=device)


def encoder_cfg(ds, **kw):
    cfg = TrainConfig()
    return dataclasses.replace(derive_model_cfg(cfg, ds),
                               **dict(ENCODER_MODEL, **kw))


def _np(x):
    return x.detach().cpu().numpy()


def _full(x, rb: RowBlock):
    """The (n, ...) array of every rank's block (no gradient)."""
    return all_gather_raw(x.detach().contiguous(), rb.group)[:rb.n]


def _grads(params):
    return [_np(p.grad) for p in param_leaves(params)]


def _fresh(params):
    leaves = param_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
        p.grad = None
    return params


# ---------------------------------------------------------------------------
# Cases held against the JAX package.

def case_spmm(ctx):
    mesh, dev, group = ctx["mesh"], ctx["device"], ctx["group"]
    out = {}
    for k, shape in enumerate(SPMM_SHAPES):
        a, x_np = spmm_case(shape, k)
        n_dst, n_src, _ = shape
        dst, src = np.nonzero(a)
        g = coo_from_arrays(src, dst, a[dst, src], n_src, n_dst, device="cpu")
        sg = put_sharded_coo(mesh, "dp", shard_coo_by_dst(g, mesh.shape["dp"]),
                             dev)
        rows_out = RowBlock(n_dst, group)
        rows_in = RowBlock(n_src, group)
        for mode, sharded in (("rep", False), ("halo", True)):
            x = torch.tensor(x_np, device=dev, requires_grad=True)
            xin = rows_in.shard_rows(x) if sharded else x
            y = spmm_sharded(mesh, "dp", sg, xin, x_sharded=sharded)
            (y ** 2).sum().backward()
            out[f"spmm{k}_{mode}"] = _np(_full(y, rows_out))
            out[f"spmm{k}_{mode}_grad"] = _np(x.grad)
    return out


def _encoder_inputs(ctx, graph_fn):
    ds = encoder_dataset(ctx["device"])
    inputs, _, labels, _ = fold_inputs(ds, 0)
    s = ds.splits[0]
    graph = graph_fn(s.train_pairs, s.train_values, ds.n_drug, ds.n_dis)
    return ds, dataclasses.replace(inputs, enc_graph=graph), labels


def _jax_params(ctx):
    return params_from_jax(ctx["inputs"]["params"], ctx["device"])


def case_encoder_coo(ctx):
    """BipartiteSharded: the forward without masks, with injected masks,
    and the gradients of mean(pred ** 2)."""
    mesh, dev = ctx["mesh"], ctx["device"]
    ds, inputs, _ = _encoder_inputs(ctx, lambda *a: build_enc_graph_sharded(
        *a, mesh, "dp", pad_multiple=8, device=dev))
    cfg = encoder_cfg(ds)
    params = _fresh(_jax_params(ctx))
    g = inputs.enc_graph
    e_shard = [(g.fwd[r].src.shape[0], g.rev[r].src.shape[0])
               for r in range(g.num_ratings)]
    masks = coo_masks([((mesh.shape["dp"], ef), (mesh.shape["dp"], er))
                       for ef, er in e_shard])
    me = mesh.index("dp")
    edge_masks = {"fwd": tuple(torch.tensor(m[0][me], device=dev)
                               for m in masks),
                  "rev": tuple(torch.tensor(m[1][me], device=dev)
                               for m in masks)}
    out = {"e_shard": np.asarray(e_shard)}
    with torch.no_grad():
        for tag, em in (("plain", None), ("masked", edge_masks)):
            res = forward(params, inputs, cfg, train=False, edge_masks=em)
            for i, x in enumerate(res):
                out[f"coo_{tag}_{i}"] = _np(x)
    pred, *_ = forward(params, inputs, cfg, train=False)
    torch.mean(pred ** 2).backward()
    for i, gr in enumerate(_grads(params)):
        out[f"coo_grad_{i}"] = gr
    return out


def case_encoder_grouped(ctx, ring=False, layers=None):
    """BipartiteShardedGrouped (or its ring): the forward without edge
    dropout and with PRF masks of ``PRF_SALTS``, the unsharded grouped
    layout's forward with those masks, and each relation's keep mask by
    edge id."""
    from dream_gnn_tpu_torch.augment.masks import prf_mask_graph

    mesh, dev = ctx["mesh"], ctx["device"]
    ds, inputs, _ = _encoder_inputs(
        ctx, lambda *a: build_enc_graph_sharded_grouped(
            *a, mesh, "dp", ring=ring, device=dev))
    kw = {} if layers is None else dict(layers=layers)
    cfg = encoder_cfg(ds, **kw)
    params = _jax_params(ctx) if layers is None \
        else params_from_jax(ctx["inputs"]["params_ring"], dev)
    tag = "ring" if ring else "grouped"
    salts = torch.tensor(PRF_SALTS, dtype=torch.int64)
    edge_masks = {"fwd_salts": salts[:, 0], "rev_salts": salts[:, 1],
                  "rate": PRF_RATE, "kind": "grouped_prf"}
    s = ds.splits[0]
    unsharded = dataclasses.replace(inputs, enc_graph=build_enc_graph_grouped(
        s.train_pairs, s.train_values, ds.n_drug, ds.n_dis, device=dev))
    out = {}
    with torch.no_grad():
        for em_tag, em, inp in (("plain", None, inputs),
                                ("prf", edge_masks, inputs),
                                ("prf_unsharded", edge_masks, unsharded)):
            res = forward(params, inp, cfg, train=False, edge_masks=em)
            for i, x in enumerate(res):
                out[f"{tag}_{em_tag}_{i}"] = _np(x)
    masked = prf_mask_graph(inputs.enc_graph, edge_masks)
    group = ctx["group"]
    for side in ("fwd", "rev"):
        for r, rel in enumerate(getattr(masked, side)):
            pairs = rel if isinstance(rel, tuple) else (rel,)
            ids = torch.cat([p.fwd.edge_id.long() for p in pairs])
            keep = torch.cat([p.fwd.val for p in pairs])
            n = int(sum_ranks(torch.tensor(float(ids.shape[0])), group))
            # Every rank's (id, keep), gathered by padding to n each.
            pad = n - ids.shape[0]
            ids = torch.cat([ids, ids.new_full((pad,), -1)])
            keep = torch.cat([keep, keep.new_zeros(pad)])
            ids, keep = all_gather_raw(ids, group), all_gather_raw(keep, group)
            full = np.zeros(n, np.float32)
            live = ids >= 0
            full[_np(ids[live])] = _np(keep[live])
            out[f"{tag}_keep_{side}{r}"] = full
    return out


def case_ring(ctx):
    return case_encoder_grouped(ctx, ring=True, layers=1)


def case_decoder(ctx):
    """The candidate-sharded decoder's eval forward (dropout 0, fp32),
    gathered; the slot labels' sums; the gathered logits' rows."""
    mesh, dev = ctx["mesh"], ctx["device"]
    drug_feat, dis_feat, src, dst, labels = decoder_problem()
    p = DECODER
    slay = build_scale_decoder_layout_sharded(src, dst, p["n_drug"],
                                              p["n_dis"], mesh.shape["dp"],
                                              mesh=mesh, axis="dp",
                                              device=dev)
    params = params_from_jax(ctx["inputs"]["decoder"], dev)
    with torch.no_grad():
        got = decoder_apply_scale_spmd(
            params, slay, torch.tensor(drug_feat, device=dev),
            torch.tensor(dis_feat, device=dev), mesh, "dp", dropout_rate=0.0,
            train=False, dtype=torch.float32)
    lab, w = slay.slot_labels(labels)
    group = slay.group
    return {"dec_logits": _np(slay.gather(got)),
            "dec_flat": _np(all_gather_raw(got, group)),
            "dec_global_slot": slay.global_slot(),
            "dec_n_pos": np.asarray(slay.n_pos),
            "dec_w_sum": _np(sum_ranks(w.sum(), group)),
            "dec_lab_sum": _np(sum_ranks((lab * w).sum(), group)),
            "dec_live": _np(all_gather_raw((w > 0).sum()[None], group))}


# ---------------------------------------------------------------------------
# Cases held against one rank (and, in the slow tier, against JAX).

def _ranks_and_one(ctx, tag, fn):
    """``fn(mesh)`` over every rank, then over rank 0 alone; results keyed
    ``tag/S/...`` and ``tag/1/...`` (the latter on rank 0 only)."""
    out = {f"{tag}/S/{k}": v for k, v in fn(ctx["mesh"]).items()}
    if dist.get_rank() == 0:
        out.update({f"{tag}/1/{k}": v for k, v in fn(ctx["mesh1"]).items()})
    return out


def case_decoder_grads(ctx):
    """The sharded decoder with dropout 0.5 (fp32, an explicit seed): the
    loss sum(w * (logit - label) ** 2) over every rank's slots and the
    gradients of the tables and the weights."""
    dev = ctx["device"]
    drug_feat, dis_feat, src, dst, labels = decoder_problem()
    p = DECODER
    dec = params_from_jax(ctx["inputs"]["decoder"], dev)

    def run(mesh):
        from dream_gnn_tpu_torch.kernels.grid_decoder import node_projections
        from dream_gnn_tpu_torch.sharding.scale_decoder_spmd import \
            scale_decoder_spmd
        slay = build_scale_decoder_layout_sharded(
            src, dst, p["n_drug"], p["n_dis"], mesh.shape["dp"], mesh=mesh,
            axis="dp", device=dev)
        pd, pv = node_projections(dec, torch.tensor(drug_feat, device=dev),
                                  torch.tensor(dis_feat, device=dev),
                                  torch.float32)
        leaves = [t.detach().clone().requires_grad_(True) for t in
                  (pd, pv, dec["b1"], dec["w2"], dec["b2"], dec["w3"][:, 0],
                   dec["b3"])]
        out = scale_decoder_spmd(mesh, "dp", slay, *leaves,
                                 torch.tensor([918273], dtype=torch.int32,
                                              device=dev),
                                 rate=0.5, train=True, dtype=torch.float32)
        lab, w = slay.slot_labels(labels)
        loss = sum_ranks((w * (out - lab) ** 2).sum(), slay.group)
        loss.backward()
        return {"loss": _np(loss), **{f"grad{i}": _np(t.grad)
                                      for i, t in enumerate(leaves)}}
    return _ranks_and_one(ctx, "decoder_grads", run)


def _composed(ctx, mesh, enc_build, model_kw, scale_decoder: bool,
              augment: AugmentConfig, steps: int, params=None):
    """The training step over a sharded encoder (and a candidate-sharded
    scale decoder): the loss and every gradient of one forward with PRF
    edge masks, then ``steps`` steps of ``make_one_step``, then the eval's
    AUROC and AUPR over every rank's candidates."""
    from dream_gnn_tpu_torch.train.losses import total_loss
    from dream_gnn_tpu_torch.train.step import decoder_targets

    dev = ctx["device"]
    ds = encoder_dataset(dev)
    inputs, _, labels, _ = fold_inputs(ds, 0)
    s = ds.splits[0]
    graph = enc_build(s.train_pairs, s.train_values, ds.n_drug, ds.n_dis,
                      mesh, "dp", device=dev)
    inputs = dataclasses.replace(inputs, enc_graph=graph)
    weight = ds.fold(0).train_w
    group = None
    if scale_decoder:
        slay = build_scale_decoder_layout_sharded(
            inputs.dec_src, inputs.dec_dst, ds.n_drug, ds.n_dis,
            mesh.shape["dp"], mesh=mesh, axis="dp", device=dev)
        inputs = dataclasses.replace(inputs, dec_layout=slay)
        labels, weight = slay.slot_labels(labels)
        group = slay.group
    train_cfg = TrainConfig(augment=augment)
    cfg = encoder_cfg(ds, **model_kw)
    if params is None:
        params = init_params(torch.Generator(dev).manual_seed(0), cfg)
    params = _fresh(params)
    out = {}
    gen = torch.Generator(dev).manual_seed(5)
    edge_masks = None
    if "edge_dropout" in augment.methods:
        salts = torch.tensor(PRF_SALTS, dtype=torch.int64, device=dev)
        edge_masks = {"fwd_salts": salts[:, 0], "rev_salts": salts[:, 1],
                      "rate": PRF_RATE, "kind": "grouped_prf"}
    pred, *rest = forward(params, inputs, cfg, train=True, generator=gen,
                          edge_masks=edge_masks)
    pred, lab, w = decoder_targets(pred, inputs, cfg, labels, weight)
    loss, _ = total_loss(pred, lab, *rest, beta=train_cfg.beta,
                         smoothing=train_cfg.label_smoothing, weight=w,
                         group=group)
    loss.backward()
    out["loss"] = _np(loss)
    for i, g in enumerate(_grads(params)):
        out[f"grad{i}"] = g
    state = init_state(params, torch.Generator(dev).manual_seed(9),
                       train_cfg)
    one_step = make_one_step(cfg, train_cfg)
    out["step_losses"] = np.asarray(
        [float(one_step(state, inputs, labels, weight)) for _ in range(steps)])
    for i, p in enumerate(param_leaves(state.params)):
        out[f"param{i}"] = _np(p)
    out["metrics"] = np.asarray([float(m) for m in evaluate(
        state.params, inputs, cfg, labels, weight)])
    return out


def case_full_model(ctx):
    """The composed sharded step: the sharded-grouped encoder and the
    candidate-sharded scale decoder, bf16, PRF edge dropout and decoder
    dropout 0.3."""
    return _ranks_and_one(ctx, "full_model", lambda mesh: _composed(
        ctx, mesh, build_enc_graph_sharded_grouped,
        dict(layers=2, decoder_backend="pallas", compute_dtype="bfloat16"),
        True, AugmentConfig(), STEPS))


def case_ring_step(ctx):
    """The ring layout's training step with the default augmentation."""
    def build(*a, **kw):
        return build_enc_graph_sharded_grouped(*a, ring=True, **kw)
    return _ranks_and_one(ctx, "ring_step", lambda mesh: _composed(
        ctx, mesh, build, dict(layers=1), False, AugmentConfig(), 1))


def case_full_model_jax(ctx):
    """The JAX full-model test's forward: the sharded COO encoder and the
    candidate-sharded scale decoder, dropout 0, JAX's weights; the loss
    sum(w * (pred - label) ** 2) and its gradients."""
    dev, mesh = ctx["device"], ctx["mesh"]
    ds = encoder_dataset(dev)
    inputs, _, labels, _ = fold_inputs(ds, 0)
    s = ds.splits[0]
    graph = build_enc_graph_sharded(s.train_pairs, s.train_values, ds.n_drug,
                                    ds.n_dis, mesh, "dp", pad_multiple=8,
                                    device=dev)
    slay = build_scale_decoder_layout_sharded(
        inputs.dec_src, inputs.dec_dst, ds.n_drug, ds.n_dis, mesh.shape["dp"],
        mesh=mesh, axis="dp", device=dev)
    inputs = dataclasses.replace(inputs, enc_graph=graph, dec_layout=slay)
    cfg = encoder_cfg(ds, layers=2, dropout=0.0, attention_dropout=0.0,
                      decoder_backend="pallas")
    params = _fresh(params_from_jax(ctx["inputs"]["params_full"], dev))
    lab, w = slay.slot_labels(labels)
    pred, *_ = forward(params, inputs, cfg, train=True,
                       generator=torch.Generator(dev).manual_seed(3))
    loss = sum_ranks((w * (pred - lab) ** 2).sum(), slay.group)
    loss.backward()
    return {"full_jax_loss": _np(loss),
            **{f"full_jax_grad{i}": g for i, g in enumerate(_grads(params))}}


def case_ring_nodrop(ctx):
    """The ring layout's step loss with no augmentation and no dropout,
    JAX's weights (test_ring_no_dropout_loss_matches_coo)."""
    def build(*a, **kw):
        return build_enc_graph_sharded_grouped(*a, ring=True, **kw)
    out = _composed(ctx, ctx["mesh"], build,
                    dict(layers=1, dropout=0.0, attention_dropout=0.0), False,
                    AugmentConfig(methods=()), 1,
                    params=params_from_jax(ctx["inputs"]["params_ring"],
                                           ctx["device"]))
    return {"ring_nodrop_loss": out["step_losses"]}


# ---------------------------------------------------------------------------
# Cases of the card tests (tests/test_torch_port_gpu.py).

def _err(a, b) -> float:
    return float((a.detach() - b).abs().max())


def case_collectives(ctx):
    """Each collective forward and backward on the rank's device, held to
    what it must give; every result must stay on the device."""
    from dream_gnn_tpu_torch.sharding.collectives import (all_gather_rows,
                                                           replicated_in,
                                                           ring_shift)

    group, dev = ctx["group"], ctx["device"]
    n_ranks, me = dist.get_world_size(group), dist.get_rank(group)
    tri = n_ranks * (n_ranks + 1) / 2       # sum over ranks r of r + 1
    base = torch.arange(6.0, device=dev).reshape(3, 2)
    out, on_device = {}, []

    x = (base + 10 * me).requires_grad_()
    y = all_gather_rows(x, group)
    y.backward(torch.full_like(y, me + 1.0))
    out["all_gather_fwd"] = _err(y, torch.cat([base + 10 * r
                                               for r in range(n_ranks)]))
    out["all_gather_bwd"] = _err(x.grad, torch.full_like(x, tri))
    on_device += [y, x.grad]

    x = torch.full((4,), float(me), device=dev, requires_grad=True)
    y = ring_shift(x, group)
    y.backward(torch.full_like(y, me + 1.0))
    out["ring_fwd"] = _err(y, torch.full_like(y, (me + 1) % n_ranks))
    out["ring_bwd"] = _err(x.grad, torch.full_like(x, (me - 1) % n_ranks + 1))
    on_device += [y, x.grad]

    x = torch.ones(5, device=dev, requires_grad=True)
    y = replicated_in(x, group)
    y.backward(torch.full_like(y, me + 1.0))
    out["replicated_fwd"] = _err(y, torch.ones(5, device=dev))
    out["replicated_bwd"] = _err(x.grad, torch.full_like(x, tri))
    on_device += [y, x.grad]

    x = torch.full((3,), me + 1.0, device=dev, requires_grad=True)
    y = sum_ranks(x, group)
    y.backward(torch.full_like(y, 2.0))
    out["sum_fwd"] = _err(y, torch.full_like(y, tri))
    out["sum_bwd"] = _err(x.grad, torch.full_like(x, 2.0))
    on_device += [y, x.grad]

    rows = RowBlock(5, group)
    full = torch.arange(10.0, device=dev).reshape(5, 2).requires_grad_()
    blk = rows.shard_rows(full)
    back = rows.gather(blk * (me + 1))
    back.backward(torch.ones_like(back))
    out["rows_fwd"] = _err(blk, rows.block(full.detach()))
    owner = torch.arange(5, device=dev) // rows.rows + 1.0
    out["rows_gather"] = _err(back, full.detach() * owner[:, None])
    out["rows_bwd"] = _err(full.grad, owner[:, None].expand(5, 2))
    on_device += [blk, back, full.grad]
    out["on_device"] = all(t.device == dev for t in on_device)
    return {f"coll/{k}": v for k, v in out.items()}


def case_spmm_grouped(ctx):
    """One sharded-grouped SpMM over a random relation, forward and the
    gradient of sum(out * w), on every rank and on one; and the unsharded
    grouped SpMM's."""
    from dream_gnn_tpu_torch.graph.grouped import grouped_pair_from_arrays
    from dream_gnn_tpu_torch.kernels.spmm_gather import spmm_gather
    from dream_gnn_tpu_torch.sharding.scale_graph import (
        _sharded_grouped_pair, spmm_gather_sharded)

    dev = ctx["device"]
    rng = np.random.default_rng(4)
    n_src, n_dst, n_e, d = 3000, 2500, 40_000, 128
    src = torch.tensor(rng.integers(0, n_src, n_e), device=dev)
    dst = torch.tensor(rng.integers(0, n_dst, n_e), device=dev)
    x0 = torch.tensor(rng.normal(size=(n_src, d)), dtype=torch.float32,
                      device=dev)
    w = torch.tensor(rng.normal(size=(n_dst, d)), dtype=torch.float32,
                     device=dev)

    def run(mesh):
        group = mesh.group("dp")
        pair = _sharded_grouped_pair(src, dst, n_src, n_dst,
                                     mesh.shape["dp"], mesh.index("dp"))
        x = x0.clone().requires_grad_()
        rows_in, rows_out = RowBlock(n_src, group), RowBlock(n_dst, group)
        y = spmm_gather_sharded(mesh, "dp", pair, rows_in.shard_rows(x),
                                n_dst, rows_out.rows)
        (y * rows_out.block(w)).sum().backward()
        return {"out": _np(_full(y, rows_out)), "grad": _np(x.grad)}

    out = _ranks_and_one(ctx, "spmm_grouped", run)
    x = x0.clone().requires_grad_()
    pair = grouped_pair_from_arrays(src, dst, torch.ones(n_e, device=dev),
                                    n_src, n_dst)
    y = spmm_gather(pair, x)
    (y * w).sum().backward()
    out["spmm_grouped/unsharded/out"] = _np(y)
    out["spmm_grouped/unsharded/grad"] = _np(x.grad)
    return out


CASES = {"spmm": case_spmm, "encoder_coo": case_encoder_coo,
         "encoder_grouped": case_encoder_grouped, "ring": case_ring,
         "decoder": case_decoder, "decoder_grads": case_decoder_grads,
         "full_model": case_full_model, "ring_step": case_ring_step,
         "full_model_jax": case_full_model_jax,
         "collectives": case_collectives, "spmm_grouped": case_spmm_grouped,
         "ring_nodrop": case_ring_nodrop}


def run(device, out_dir: str, cases) -> None:
    torch.set_num_threads(1)
    inputs_file = os.path.join(out_dir, "inputs.pt")
    mesh = make_mesh(dp=dist.get_world_size())
    mesh1 = make_mesh(dp=1)
    ctx = dict(mesh=mesh, mesh1=mesh1, device=device, group=mesh.group("dp"),
               inputs=(torch.load(inputs_file, weights_only=False)
                       if os.path.exists(inputs_file) else {}))
    res = {}
    for name in cases:
        res.update(CASES[name](ctx))
    torch.save(res, os.path.join(out_dir, f"rank{dist.get_rank()}.pt"))

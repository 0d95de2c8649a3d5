"""The port's sparse encoder layouts against the JAX package: the padded-COO
builders (``build_enc_graph_coo``, ``synthetic_bipartite_coo``) array for
array; the grouped and blocked layouts as CSRs (dense sums and per-row
edge ids); the full model's forward over ``BipartiteCoo`` and over
``BipartiteGrouped`` with the same JAX-initialised weights (carried across
by ``convert.params_from_jax``); a training forward and backward with edge
dropout, the COO keep masks injected into both packages and the grouped
PRF salts the same in both; a training step on each layout with the
default augmentation; and ``kernels/spmm.py:spmm`` on every layout the JAX
``spmm`` takes.

Data: the small synthetic preset (40 drugs x 30 diseases) of
tests/_torch_port_setup.py, fold 0's training pairs; two GCMC layers 48/16
(one for the gradients), edges decode mode with the plain decoder.  The
JAX grouped SpMM runs its Pallas kernel in interpret mode, the port's the
plain version (CPU tensors); both round the encoder's messages to bf16 at
the same points.

Tolerances, as tests/test_torch_port_scale.py: outputs rtol 1e-4 with atol
1e-5 scaled by their magnitude (the same arithmetic, summed in another
order); loss rtol 1e-5; gradients rtol 1e-3, atol 1e-4 scaled (each sums
over every candidate and passes back through both layers and the
attention).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dream_gnn_tpu.kernels.pallas_spmm_gather as psg
from dream_gnn_tpu.graph.bipartite_coo import \
    build_enc_graph_coo as j_build_coo
from dream_gnn_tpu.graph.bipartite_coo import \
    synthetic_bipartite_coo as j_synthetic_coo
from dream_gnn_tpu.graph.grouped import \
    build_enc_graph_grouped as j_build_grouped
from dream_gnn_tpu.model.dream_gnn import forward as j_forward
from dream_gnn_tpu.model.dream_gnn import init_params as j_init
from dream_gnn_tpu.train.losses import total_loss as j_total_loss
from dream_gnn_tpu.train.loop import fold_inputs as j_fold_inputs
from dream_gnn_tpu_torch.augment.masks import draw_augment
from dream_gnn_tpu_torch.config import TrainConfig as TTrain
from dream_gnn_tpu_torch.convert import params_from_jax
from dream_gnn_tpu_torch.graph.bipartite_coo import (BipartiteCoo,
                                                     build_enc_graph_coo,
                                                     synthetic_bipartite_coo)
from dream_gnn_tpu_torch.graph.blocked import blocked_from_arrays
from dream_gnn_tpu_torch.graph.grouped import (BipartiteGrouped,
                                               build_enc_graph_grouped,
                                               grouped_from_arrays)
from dream_gnn_tpu_torch.model.dream_gnn import forward as t_forward
from dream_gnn_tpu_torch.model.dream_gnn import param_leaves
from dream_gnn_tpu_torch.train.losses import total_loss as t_total_loss
from dream_gnn_tpu_torch.train.loop import fold_inputs as t_fold_inputs
from dream_gnn_tpu_torch.train.step import init_state, make_one_step
from tests._torch_port_setup import datasets, model_cfgs, numpy_tree

OUT_NAMES = ("pred", "drug_out", "drug_sim_out", "dis_out", "dis_sim_out")
MODEL = dict(decode_mode="edges", decoder_backend="xla", dropout=0.0,
             attention_dropout=0.0)


@pytest.fixture(autouse=True)
def _interpret():
    old = psg.INTERPRET
    psg.INTERPRET = True
    yield
    psg.INTERPRET = old


@pytest.fixture(scope="module")
def setup():
    jds, tds = datasets()
    jcfg, tcfg = model_cfgs(jds, tds, **MODEL)
    jparams = j_init(jax.random.key(7), jcfg)
    return jds, tds, jcfg, tcfg, jparams


def _close(a, b, rtol, atol, what):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, what
    scale = max(1e-3, float(np.abs(b).max()))
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol * scale,
                               err_msg=what)


def _assert_coo_equal(tg, jg):
    for f in ("ci_drug", "cj_drug", "ci_dis", "cj_dis"):
        np.testing.assert_array_equal(getattr(tg, f).numpy(),
                                      np.asarray(getattr(jg, f)), err_msg=f)
    assert (tg.n_drug, tg.n_dis, tg.num_ratings) == (jg.n_drug, jg.n_dis,
                                                     jg.num_ratings)
    assert tg.num_edges() == jg.num_edges()
    for side in ("fwd", "rev"):
        for r in range(jg.num_ratings):
            t, j = getattr(tg, side)[r], getattr(jg, side)[r]
            assert (t.n_src, t.n_dst, t.e_pad) == (j.n_src, j.n_dst, j.e_pad)
            for f in ("src", "dst", "val"):
                np.testing.assert_array_equal(
                    getattr(t, f).numpy(), np.asarray(getattr(j, f)),
                    err_msg=f"{side}[{r}].{f}")


def test_coo_builders_match_jax(setup):
    jds, tds, *_ = setup
    s = jds.splits[0]
    for kw in ({}, dict(symm=False, pad_multiple=64)):
        _assert_coo_equal(
            build_enc_graph_coo(s.train_pairs, s.train_values, 40, 30,
                                device="cpu", **kw),
            j_build_coo(s.train_pairs, s.train_values, 40, 30, **kw))
    _assert_coo_equal(
        synthetic_bipartite_coo(500, 400, 5000, seed=2, device="cpu"),
        j_synthetic_coo(500, 400, 5000, seed=2))


def _edges(seed=0, n_src=700, n_dst=600, n=3000):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_src, n)
    dst = rng.integers(0, n_dst, n)
    val = (rng.random(n) + 0.5).astype(np.float32)
    val[rng.random(n) < 0.1] = 0.0
    return src, dst, val, n_src, n_dst


def _dense(row_ptr, src, val, n_dst, n_src):
    a = np.zeros((n_dst, n_src), np.float32)
    rows = np.repeat(np.arange(n_dst), np.diff(row_ptr))
    np.add.at(a, (rows, src), val)
    return a


def _ids_by_row(rows, ids, n_dst):
    return [sorted(ids[rows == n].tolist()) for n in range(n_dst)]


@pytest.mark.parametrize("build", [grouped_from_arrays, blocked_from_arrays])
def test_layouts_are_the_csr_of_the_live_edges(build):
    """The layout sums as the dense matrix of its edges, drops zero-weight
    edges, and carries each edge's index among the live input edges in
    the row of its destination."""
    src, dst, val, n_src, n_dst = _edges()
    g = build(src, dst, val, n_src, n_dst, device="cpu")
    want = np.zeros((n_dst, n_src), np.float32)
    np.add.at(want, (dst, src), val)
    ptr = g.row_ptr.numpy()
    np.testing.assert_array_equal(
        _dense(ptr, g.src.numpy(), g.val.numpy(), n_dst, n_src), want)
    live = val != 0
    assert g.n_live == int(live.sum()) and bool((g.val != 0).all())
    rows = np.repeat(np.arange(n_dst), np.diff(ptr))
    assert _ids_by_row(rows, g.edge_id.numpy(), n_dst) \
        == _ids_by_row(dst[live], np.arange(g.n_live), n_dst)


def test_grouped_edge_ids_match_jax_per_row():
    """Per destination row, the port's grouped layout carries the same set
    of live-edge ids as the JAX layout's slots."""
    from dream_gnn_tpu.graph.grouped import grouped_from_arrays as j_grouped

    src, dst, val, n_src, n_dst = _edges(seed=1)
    jg = j_grouped(src, dst, val, n_src, n_dst)
    eid = np.asarray(jg.edge_id)
    rows = (np.asarray(jg.dst_tile)[:, None, None] * jg.tile_dst
            + np.asarray(jg.dst_local))
    live = eid < jg.n_live
    g = grouped_from_arrays(src, dst, val, n_src, n_dst, device="cpu")
    assert g.n_live == jg.n_live and g.occupancy == 1.0
    t_rows = np.repeat(np.arange(n_dst), np.diff(g.row_ptr.numpy()))
    assert _ids_by_row(t_rows, g.edge_id.numpy(), n_dst) \
        == _ids_by_row(rows[live], eid[live], n_dst)


def _graphs(jds, layout):
    s = jds.splits[0]
    args = (s.train_pairs, s.train_values, 40, 30)
    if layout == "coo":
        return j_build_coo(*args), build_enc_graph_coo(*args, device="cpu")
    return j_build_grouped(*args), build_enc_graph_grouped(*args,
                                                           device="cpu")


def _inputs(setup, layout):
    jds, tds, *_ = setup
    jg, tg = _graphs(jds, layout)
    jin, _, jlab, _ = j_fold_inputs(jds, 0)
    tin, _, tlab, _ = t_fold_inputs(tds, 0)
    return (dataclasses.replace(jin, enc_graph=jg), jlab,
            dataclasses.replace(tin, enc_graph=tg), tlab)


@pytest.mark.parametrize("layout", ["coo", "grouped"])
def test_eval_forward_matches_jax(setup, layout):
    _, _, jcfg, tcfg, jparams = setup
    jin, _, tin, _ = _inputs(setup, layout)
    jout = jax.jit(lambda p: j_forward(p, jin, jcfg, train=False))(jparams)
    with torch.no_grad():
        tout = t_forward(params_from_jax(numpy_tree(jparams), device="cpu"),
                         tin, tcfg, train=False)
    for name, a, b in zip(OUT_NAMES, tout, jout):
        _close(a, b, 1e-4, 1e-5, f"{layout} {name}")


def _masks(jg, layout):
    """The same edge-dropout masks for both packages: per-relation
    Bernoulli(0.7) keep masks over the padded COO edges, or the PRF salts
    of the grouped layout."""
    rng = np.random.default_rng(11)
    if layout == "coo":
        m = {side: [(rng.random(g.e_pad) < 0.7).astype(np.float32)
                    for g in getattr(jg, side)] for side in ("fwd", "rev")}
        return ({k: tuple(map(jnp.asarray, v)) for k, v in m.items()},
                {k: tuple(map(torch.tensor, v)) for k, v in m.items()})
    salts = rng.integers(0, 2 ** 31 - 1, (2, 2))
    base = {"rate": 0.3, "kind": "grouped_prf"}
    return (dict(base, fwd_salts=jnp.asarray(salts[0], jnp.uint32),
                 rev_salts=jnp.asarray(salts[1], jnp.uint32)),
            dict(base, fwd_salts=torch.tensor(salts[0]),
                 rev_salts=torch.tensor(salts[1])))


@pytest.mark.parametrize("layout", ["coo", "grouped"])
def test_training_grads_with_edge_dropout_match_jax(setup, layout):
    """A training forward (node and attention dropout at 0, so both are
    deterministic) with the same edge-dropout masks: the loss and every
    gradient.  One GCMC layer, which halves the JAX interpret-mode kernel
    calls; the eval forward holds both layers."""
    jds, tds, jcfg, tcfg, _ = setup
    jcfg, tcfg = (dataclasses.replace(c, layers=1) for c in (jcfg, tcfg))
    jparams = j_init(jax.random.key(7), jcfg)
    jin, jlab, tin, tlab = _inputs(setup, layout)
    jm, tm = _masks(jin.enc_graph, layout)
    jw = jds.fold(0).train_w

    def jloss(p):
        pred, *outs = j_forward(p, jin, jcfg, train=True,
                                key=jax.random.key(0), edge_masks=jm)
        return j_total_loss(pred, jlab, *outs, beta=0.0, weight=jw)[0]

    jl, jg = jax.jit(jax.value_and_grad(jloss))(jparams)
    tparams = params_from_jax(numpy_tree(jparams), device="cpu")
    for p in param_leaves(tparams):
        p.requires_grad_(True)
    pred, *outs = t_forward(tparams, tin, tcfg, train=True,
                            generator=torch.Generator().manual_seed(0),
                            edge_masks=tm)
    tl, _ = t_total_loss(pred, tlab, *outs, beta=0.0,
                         weight=tds.fold(0).train_w)
    tl.backward()
    _close(tl, jl, 1e-5, 1e-6, "loss")
    jleaves = param_leaves(params_from_jax(numpy_tree(jg), device="cpu"))
    for i, (t, j) in enumerate(zip(param_leaves(tparams), jleaves)):
        grad = t.grad if t.grad is not None else torch.zeros_like(t)
        _close(grad, j.numpy(), 1e-3, 1e-4, f"{layout} grad leaf {i}")


@pytest.mark.parametrize("layout", ["coo", "grouped"])
def test_train_step_with_default_augmentation(setup, layout):
    """Two training steps with the default augmentation (edge dropout and
    feature noise) on each layout: the draws have the layout's form, and
    the losses are finite and differ."""
    jds, tds, _, tcfg, jparams = setup
    _, _, tin, tlab = _inputs(setup, layout)
    cfg = TTrain(model=tcfg)
    draws = {field: d for _, field, d in draw_augment(
        torch.Generator().manual_seed(3), tin, cfg.augment)}
    masks = draws["edge_masks"]
    if isinstance(tin.enc_graph, BipartiteCoo):
        assert [m.shape for m in masks["fwd"]] \
            == [(g.e_pad,) for g in tin.enc_graph.fwd]
    else:
        assert isinstance(tin.enc_graph, BipartiteGrouped)
        assert masks["kind"] == "grouped_prf"
        assert masks["fwd_salts"].shape == (2,)
    state = init_state(params_from_jax(numpy_tree(jparams), device="cpu"),
                       torch.Generator().manual_seed(1), cfg)
    step = make_one_step(tcfg, cfg)
    w = tds.fold(0).train_w
    losses = [float(step(state, tin, tlab, w)) for _ in range(2)]
    assert np.isfinite(losses).all() and losses[0] != losses[1]


def test_spmm_dispatch_matches_jax():
    """``kernels/spmm.py:spmm`` takes every layout the JAX ``spmm`` takes
    (spmm.py:51-57): a ``CooGraph``, a ``NormAdj`` and a plain matrix,
    which is a dense (n_dst, n_src) adjacency."""
    from dream_gnn_tpu.graph.coo import coo_from_arrays as j_coo
    from dream_gnn_tpu.graph.knn import NormAdj as JNormAdj
    from dream_gnn_tpu.kernels.spmm import spmm as j_spmm
    from dream_gnn_tpu_torch.graph.coo import coo_from_arrays
    from dream_gnn_tpu_torch.graph.knn import NormAdj
    from dream_gnn_tpu_torch.kernels.spmm import spmm

    rng = np.random.default_rng(6)
    a = (rng.random((30, 40)) < 0.2) * rng.random((30, 40))
    a = a.astype(np.float32)
    x = rng.normal(size=(40, 8)).astype(np.float32)
    dst, src = np.nonzero(a)
    cases = [(a, torch.tensor(a)),
             (JNormAdj(a=jnp.asarray(a)), NormAdj(a=torch.tensor(a))),
             (j_coo(src, dst, a[dst, src], 40, 30),
              coo_from_arrays(src, dst, a[dst, src], 40, 30, device="cpu"))]
    for jg, tg in cases:
        _close(spmm(tg, torch.tensor(x)), j_spmm(jg, jnp.asarray(x)), 1e-5,
               1e-6, type(tg).__name__)

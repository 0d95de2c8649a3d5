"""The port's model against the JAX package with the same JAX-initialised
weights (carried over by params_from_jax): eval-mode forward (logits and
the four route outputs) and the gradients of a fixed loss.

The JAX grid decoder runs its Pallas kernel in interpret mode; the port
runs the plain version (CPU tensors).  Tolerances: forward in fp32, the
same arithmetic in another summation order: rtol 1e-4 with atol 1e-5
scaled by each array's magnitude.  bf16 (decoder operands): rtol 2e-2,
atol 1e-3 scaled, for neighbouring-ulp rounding of near-tie f32 values.
Gradients (fp32): rtol 1e-3, atol 1e-4 scaled — each is a sum over the
whole grid and passes back through three GCMC layers and the softmax.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import dream_gnn_tpu.kernels.pallas_decoder as pdm
from dream_gnn_tpu.model.dream_gnn import forward as j_forward
from dream_gnn_tpu.model.dream_gnn import init_params as j_init
from dream_gnn_tpu.train.losses import total_loss as j_total_loss
from dream_gnn_tpu.train.loop import fold_inputs as j_fold_inputs
from dream_gnn_tpu_torch.convert import params_from_jax
from dream_gnn_tpu_torch.model.dream_gnn import forward as t_forward
from dream_gnn_tpu_torch.model.dream_gnn import init_params as t_init
from dream_gnn_tpu_torch.model.dream_gnn import param_leaves
from dream_gnn_tpu_torch.train.losses import total_loss as t_total_loss
from dream_gnn_tpu_torch.train.loop import fold_inputs as t_fold_inputs
from tests._torch_port_setup import datasets, model_cfgs, numpy_tree

TOL = {"float32": (1e-4, 1e-5), "bfloat16": (2e-2, 1e-3)}
OUT_NAMES = ("pred", "drug_out", "drug_sim_out", "dis_out", "dis_sim_out")


@pytest.fixture(autouse=True)
def _interpret():
    old = pdm.INTERPRET
    pdm.INTERPRET = True
    yield
    pdm.INTERPRET = old


@pytest.fixture(scope="module")
def setup():
    jds, tds = datasets()
    jcfg, tcfg = model_cfgs(jds, tds)
    jparams = j_init(jax.random.key(7), jcfg)
    return jds, tds, jcfg, tcfg, jparams


def _close(a, b, rtol, atol, what):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, what
    scale = max(1e-3, float(np.abs(b).max()))
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol * scale,
                               err_msg=what)


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("split", ["train", "test"])
def test_eval_forward_matches_jax(setup, dtype, split):
    jds, tds, jcfg, tcfg, jparams = setup
    jcfg = dataclasses.replace(jcfg, compute_dtype=dtype)
    tcfg = dataclasses.replace(tcfg, compute_dtype=dtype)
    i = 0 if split == "train" else 1
    jout = j_forward(jparams, j_fold_inputs(jds, 2)[i], jcfg, train=False)
    tparams = params_from_jax(numpy_tree(jparams), device="cpu")
    with torch.no_grad():
        tout = t_forward(tparams, t_fold_inputs(tds, 2)[i], tcfg, train=False)
    rtol, atol = TOL[dtype]
    for name, a, b in zip(OUT_NAMES, tout, jout):
        _close(a, b, rtol, atol, name)


def test_loss_gradients_match_jax(setup):
    """Gradients of BCE + common loss (grid targets) w.r.t. every param."""
    jds, tds, jcfg, tcfg, jparams = setup
    jin, tin = j_fold_inputs(jds, 0)[0], t_fold_inputs(tds, 0)[0]

    def jloss(p):
        pred, *outs = j_forward(p, jin, jcfg, train=False)
        return j_total_loss(pred.reshape(-1), jin.enc_graph.a1.reshape(-1),
                            *outs, beta=0.001,
                            weight=jin.enc_graph.mask.reshape(-1))[0]

    jl, jg = jax.jit(jax.value_and_grad(jloss))(jparams)
    tparams = params_from_jax(numpy_tree(jparams), device="cpu")
    for p in param_leaves(tparams):
        p.requires_grad_(True)
    pred, *outs = t_forward(tparams, tin, tcfg, train=False)
    tl, _ = t_total_loss(pred.reshape(-1), tin.enc_graph.a1.reshape(-1),
                         *outs, beta=0.001,
                         weight=tin.enc_graph.mask.reshape(-1))
    tl.backward()
    _close(tl, jl, 1e-5, 1e-6, "loss")
    jleaves = param_leaves(params_from_jax(numpy_tree(jg), device="cpu"))
    for i, (t, j) in enumerate(zip(param_leaves(tparams), jleaves)):
        _close(t.grad, j.numpy(), 1e-3, 1e-4, f"grad leaf {i}")


def test_param_tree_matches_jax(setup):
    """Port init draws the same shapes under the same keys (values
    differ: jax.random and torch.Generator are different streams)."""
    _, _, jcfg, tcfg, jparams = setup
    tparams = t_init(torch.Generator().manual_seed(0), tcfg)
    jshapes = jax.tree.map(lambda x: tuple(x.shape), jparams)
    tshapes = jax.tree.map(lambda x: tuple(x.shape), tparams)
    assert jshapes == tshapes


def test_init_distributions_match_jax(setup):
    """Same uniform bounds: on every leaf of >= 256 draws, the largest
    |w| of the two packages agree within 10% (each sits just under the
    common bound)."""
    _, _, jcfg, tcfg, jparams = setup
    tparams = t_init(torch.Generator().manual_seed(0), tcfg)
    checked = 0
    for t, j in zip(param_leaves(tparams),
                    param_leaves(params_from_jax(numpy_tree(jparams),
                                                 device="cpu"))):
        if t.numel() < 256:
            continue
        jb, tb = float(j.abs().max()), float(t.abs().max())
        assert abs(tb - jb) <= 0.1 * jb, (tuple(t.shape), tb, jb)
        checked += 1
    assert checked >= 10


def test_edges_mode_and_xla_backend_not_ported(setup):
    _, tds, _, tcfg, _ = setup
    tin = t_fold_inputs(tds, 0)[0]
    params = t_init(torch.Generator().manual_seed(0), tcfg)
    for cfg in (dataclasses.replace(tcfg, decode_mode="edges"),
                dataclasses.replace(tcfg, decoder_backend="xla")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            t_forward(params, tin, cfg, train=False)


def test_stack_accumulation_rejected(setup):
    _, _, _, tcfg, _ = setup
    with pytest.raises(NotImplementedError, match="sum"):
        t_init(torch.Generator(), dataclasses.replace(
            tcfg, gcn_agg_accum="stack"))

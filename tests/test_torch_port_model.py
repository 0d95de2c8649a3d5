"""The port's model against the JAX package with the same JAX-initialised
weights (carried over by params_from_jax): eval-mode forward (logits and
the four route outputs) in both decode modes with both decoder backends,
the gradients of a fixed loss, and training steps in edges mode.

The JAX fused decoders run their Pallas kernels in interpret mode; the port
runs the plain versions (CPU tensors).  Tolerances: forward in fp32, the
same arithmetic in another summation order: rtol 1e-4 with atol 1e-5
scaled by each array's magnitude.  bf16 (decoder operands): rtol 2e-2,
atol 1e-3 scaled, for neighbouring-ulp rounding of near-tie f32 values.
Gradients (fp32): rtol 1e-3, atol 1e-4 scaled — each is a sum over the
whole grid and passes back through three GCMC layers and the softmax.
Steps (fp32, randomness off): as tests/test_torch_port_train.py, losses
rtol 1e-5, params 99.9% within 2e-5 and all within 2 * lr * steps.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dream_gnn_tpu.kernels.pallas_decoder as pdm
from dream_gnn_tpu.model.dream_gnn import forward as j_forward
from dream_gnn_tpu.config import AugmentConfig as JAug
from dream_gnn_tpu.config import TrainConfig as JTrain
from dream_gnn_tpu.model.dream_gnn import init_params as j_init
from dream_gnn_tpu.train.losses import total_loss as j_total_loss
from dream_gnn_tpu.train.loop import fold_inputs as j_fold_inputs
from dream_gnn_tpu.train.optim import make_optimizer as j_make_optimizer
from dream_gnn_tpu.train.step import make_one_step as j_make_one_step
from dream_gnn_tpu.train.step import make_train_fns as j_make_train_fns
from dream_gnn_tpu_torch.config import AugmentConfig as TAug
from dream_gnn_tpu_torch.config import ModelConfig as TModelConfig
from dream_gnn_tpu_torch.config import TrainConfig as TTrain
from dream_gnn_tpu_torch.convert import params_from_jax
from dream_gnn_tpu_torch.model.dream_gnn import forward as t_forward
from dream_gnn_tpu_torch.model.dream_gnn import init_params as t_init
from dream_gnn_tpu_torch.model.dream_gnn import param_leaves
from dream_gnn_tpu_torch.train.losses import total_loss as t_total_loss
from dream_gnn_tpu_torch.train.loop import fold_inputs as t_fold_inputs
from dream_gnn_tpu_torch.train.step import init_state, make_one_step
from tests._torch_port_setup import datasets, model_cfgs, numpy_tree

TOL = {"float32": (1e-4, 1e-5), "bfloat16": (2e-2, 1e-3)}
OUT_NAMES = ("pred", "drug_out", "drug_sim_out", "dis_out", "dis_sim_out")
# (decode_mode, decoder_backend) pairs besides the default grid + pallas.
OTHER_PATHS = [("edges", "pallas"), ("edges", "xla"), ("grid", "xla")]


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


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("mode,backend", OTHER_PATHS)
def test_eval_forward_matches_jax_other_paths(setup, mode, backend, dtype):
    """The edges decode mode with either backend, and the plain grid
    backend: eval forward on fold 2's train side against JAX."""
    jds, tds, jcfg, tcfg, jparams = setup
    kw = dict(compute_dtype=dtype, decode_mode=mode, decoder_backend=backend)
    jcfg, tcfg = (dataclasses.replace(c, **kw) for c in (jcfg, tcfg))
    jout = j_forward(jparams, j_fold_inputs(jds, 2)[0], jcfg, train=False)
    tparams = params_from_jax(numpy_tree(jparams), device="cpu")
    tin = t_fold_inputs(tds, 2)[0]
    with torch.no_grad():
        tout = t_forward(tparams, tin, tcfg, train=False)
    shape = tuple(tin.dec_src.shape) if mode == "edges" \
        else (tds.n_drug, tds.n_dis)
    assert tuple(tout[0].shape) == shape
    rtol, atol = TOL[dtype]
    for name, a, b in zip(OUT_NAMES, tout, jout):
        _close(a, b, rtol, atol, name)


def test_unknown_mode_or_backend_raises(setup):
    _, tds, _, tcfg, _ = setup
    tin = t_fold_inputs(tds, 0)[0]
    params = t_init(torch.Generator().manual_seed(0), tcfg)
    for kw in (dict(decode_mode="cells"), dict(decoder_backend="triton")):
        with pytest.raises(ValueError, match="decode_mode"):
            t_forward(params, tin, dataclasses.replace(tcfg, **kw),
                      train=False)


def test_model_config_defaults_run(setup):
    """ModelConfig()'s own defaults (edges mode, plain backend, fp32), as a
    library user builds them, run the forward: per-edge logits."""
    _, tds, _, tcfg, _ = setup
    defaults = TModelConfig()
    assert (defaults.decode_mode, defaults.decoder_backend) == ("edges", "xla")
    cfg = dataclasses.replace(
        defaults, src_in_units=tcfg.src_in_units,
        dst_in_units=tcfg.dst_in_units, fdim_drug=tcfg.fdim_drug,
        fdim_disease=tcfg.fdim_disease)
    tin = t_fold_inputs(tds, 0)[0]
    params = t_init(torch.Generator().manual_seed(0), cfg)
    with torch.no_grad():
        pred, *_ = t_forward(params, tin, cfg, train=False)
    assert pred.shape == tin.dec_src.shape
    assert bool(torch.isfinite(pred).all())


@pytest.mark.parametrize("n_steps,backend", [(1, "pallas"), (5, "pallas"),
                                             (5, "xla")])
def test_edges_steps_match_jax(setup, backend, n_steps):
    """n training steps in edges mode (fp32, randomness off) against JAX
    make_one_step: the loss weighted by the fold's train_w, on its edge
    labels."""
    jds, tds, _, _, _ = setup
    jtrain, ttrain = JTrain(augment=JAug(methods=())), \
        TTrain(augment=TAug(methods=()))
    jcfg, tcfg = model_cfgs(jds, tds, jtrain, ttrain, decode_mode="edges",
                            decoder_backend=backend, dropout=0.0,
                            attention_dropout=0.0, compute_dtype="float32")
    jparams = j_init(jax.random.key(11), jcfg)
    init_j, *_ = j_make_train_fns(jcfg, jtrain)
    jstate = init_j(jax.tree.map(jnp.asarray, jparams), jax.random.key(0))
    j_step = jax.jit(j_make_one_step(jcfg, jtrain, j_make_optimizer(
        jtrain.train_grad_clip, jtrain.weight_decay)))
    jin, _, jlab, _ = j_fold_inputs(jds, 1)
    jw = jds.fold(1).train_w
    jlosses = []
    for _ in range(n_steps):
        jstate, loss = j_step(jstate, jin, jlab, jw)
        jlosses.append(float(loss))

    tstate = init_state(params_from_jax(numpy_tree(jparams), device="cpu"),
                        torch.Generator().manual_seed(0), ttrain)
    t_step = make_one_step(tcfg, ttrain)
    tin, _, tlab, _ = t_fold_inputs(tds, 1)
    tw = tds.fold(1).train_w
    tlosses = [float(t_step(tstate, tin, tlab, tw)) for _ in range(n_steps)]
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    jleaves = param_leaves(params_from_jax(numpy_tree(jstate.params),
                                           device="cpu"))
    lr = ttrain.train_lr
    for i, (t, j) in enumerate(zip(param_leaves(tstate.params), jleaves)):
        diff = np.abs(t.detach().numpy() - j.numpy())
        assert np.mean(diff > 2e-5) <= 1e-3, f"param leaf {i}"
        assert diff.max() <= 2 * lr * n_steps, f"param leaf {i}"


def test_edges_step_needs_targets(setup):
    _, tds, _, tcfg, _ = setup
    cfg = dataclasses.replace(tcfg, decode_mode="edges")
    state = init_state(t_init(torch.Generator().manual_seed(0), cfg),
                       torch.Generator().manual_seed(0), TTrain())
    with pytest.raises(ValueError, match="labels"):
        make_one_step(cfg, TTrain())(state, t_fold_inputs(tds, 0)[0])


def test_stack_accumulation_rejected(setup):
    _, _, _, tcfg, _ = setup
    with pytest.raises(NotImplementedError, match="sum"):
        t_init(torch.Generator(), dataclasses.replace(
            tcfg, gcn_agg_accum="stack"))

"""The port's training pieces against the JAX package: N steps of
``one_step`` (fp32, dropout, attention dropout and augmentation off, so
both runs are deterministic), the augmentation with injected draws, the
device metrics on tied scores, and the plateau scheduler.

Tolerances.  Step parity: losses rtol 1e-5.  Params after five Adam
steps of lr 2e-3: at least 99.9% of every leaf's elements within atol
2e-5.  Adam scales each update to about lr whatever the gradient's size,
so a component whose gradient is rounding noise (its sign differs
between the frameworks) moves by up to 2*lr a step; the few such
elements are held to that bound, 2 * lr * steps.
Augmentation with the same draws: exact up to f32 rounding (1e-6).
Metrics: 1e-6 (same tie-grouped formulas in f32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dream_gnn_tpu.kernels.pallas_decoder as pdm
from dream_gnn_tpu.augment.masks import augment_inputs as j_augment
from dream_gnn_tpu.augment.masks import edge_dropout_masks as j_edge_masks
from dream_gnn_tpu.config import AugmentConfig as JAug
from dream_gnn_tpu.config import TrainConfig as JTrain
from dream_gnn_tpu.model.dream_gnn import init_params as j_init
from dream_gnn_tpu.train.loop import fold_inputs as j_fold_inputs
from dream_gnn_tpu.train.optim import PlateauScheduler as JPlateau
from dream_gnn_tpu.train.step import make_one_step as j_make_one_step
from dream_gnn_tpu.train.step import make_train_fns as j_make_train_fns
from dream_gnn_tpu.utils import metrics as jm
from dream_gnn_tpu_torch.augment.masks import apply_augment, draw_augment
from dream_gnn_tpu_torch.config import AugmentConfig as TAug
from dream_gnn_tpu_torch.config import TrainConfig as TTrain
from dream_gnn_tpu_torch.convert import params_from_jax
from dream_gnn_tpu_torch.model.dream_gnn import param_leaves
from dream_gnn_tpu_torch.train.loop import fold_inputs as t_fold_inputs
from dream_gnn_tpu_torch.train.optim import PlateauScheduler as TPlateau
from dream_gnn_tpu_torch.train.optim import clip_by_global_norm_
from dream_gnn_tpu_torch.train.step import init_state, make_one_step
from dream_gnn_tpu_torch.utils import metrics as tm
from tests._torch_port_setup import datasets, model_cfgs, numpy_tree

N_STEPS = 5


@pytest.fixture(autouse=True)
def _interpret():
    old = pdm.INTERPRET
    pdm.INTERPRET = True
    yield
    pdm.INTERPRET = old


@pytest.fixture(scope="module")
def data():
    return datasets()


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def test_one_step_matches_jax(data):
    jds, tds = data
    jtrain = JTrain(augment=JAug(methods=()))
    ttrain = TTrain(augment=TAug(methods=()))
    jcfg, tcfg = model_cfgs(jds, tds, jtrain, ttrain, dropout=0.0,
                            attention_dropout=0.0, compute_dtype="float32")
    jparams = j_init(jax.random.key(11), jcfg)

    init_j, *_ = j_make_train_fns(jcfg, jtrain)
    jstate = init_j(jparams, jax.random.key(0))
    from dream_gnn_tpu.train.optim import make_optimizer
    j_step = jax.jit(j_make_one_step(
        jcfg, jtrain, make_optimizer(jtrain.train_grad_clip,
                                     jtrain.weight_decay)))
    jin = j_fold_inputs(jds, 1)[0]
    jlab = jds.fold(1).train_labels
    jlosses = []
    for _ in range(N_STEPS):
        jstate, loss = j_step(jstate, jin, jlab)
        jlosses.append(float(loss))

    tstate = init_state(params_from_jax(numpy_tree(jparams), device="cpu"),
                        torch.Generator().manual_seed(0), ttrain)
    t_step = make_one_step(tcfg, ttrain)
    tin = t_fold_inputs(tds, 1)[0]
    tlosses = [float(t_step(tstate, tin)) for _ in range(N_STEPS)]

    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    assert tlosses[-1] < tlosses[0]
    jleaves = param_leaves(params_from_jax(numpy_tree(jstate.params),
                                           device="cpu"))
    lr = ttrain.train_lr
    for i, (t, j) in enumerate(zip(param_leaves(tstate.params), jleaves)):
        diff = np.abs(_np(t) - _np(j))
        assert np.mean(diff > 2e-5) <= 1e-3, f"param leaf {i}"
        assert diff.max() <= 2 * lr * N_STEPS, f"param leaf {i}"


def test_clip_matches_optax(rng):
    import optax
    grads = [rng.normal(size=(5, 3)).astype(np.float32),
             rng.normal(size=(4,)).astype(np.float32)]
    for max_norm in (0.5, 100.0):
        ref, _ = optax.clip_by_global_norm(max_norm).update(
            [jnp.asarray(g) for g in grads], None)
        ours = [torch.tensor(g) for g in grads]
        clip_by_global_norm_(ours, max_norm)
        for a, b in zip(ours, ref):
            np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-6)


def test_augment_with_injected_draws_matches_jax(data):
    """JAX augment_inputs with a key, against the port's apply_augment
    fed the very draws that key makes (masks.py:221-266 key order)."""
    jds, tds = data
    cfg_j, cfg_t = JAug(), TAug()
    jin, tin = j_fold_inputs(jds, 0)[0], t_fold_inputs(tds, 0)[0]
    key = jax.random.key(5)
    jout, jmasks = j_augment(key, jin, cfg_j)

    keys = jax.random.split(key, 24)
    enc = jin.enc_graph
    jem = j_edge_masks(keys[0], enc.n_drug, enc.n_dis, 2,
                       cfg_j.edge_dropout_rate)
    draws = [("edge_dropout", "edge_masks",
              {k: torch.tensor(np.asarray(v)) for k, v in jem.items()})]
    for i, field in enumerate(("drug_graph", "dis_graph",
                               "drug_feature_graph", "dis_feature_graph")):
        a = getattr(jin, field).a
        draws.append(("edge_dropout", field, torch.tensor(np.asarray(
            jax.random.bernoulli(keys[1 + i], 1.0 - cfg_j.edge_dropout_rate,
                                 a.shape)), dtype=torch.float32)))
    for i, field in enumerate(("drug_feat", "dis_feat", "drug_sim_feat",
                               "dis_sim_feat")):
        x = getattr(jin, field)
        draws.append(("feature_noise", field, torch.tensor(np.asarray(
            jax.random.normal(keys[5 + i], x.shape, x.dtype)))))
    tout, tmasks = apply_augment(tin, draws, cfg_t)

    for k in ("fwd", "rev"):
        np.testing.assert_array_equal(_np(tmasks[k]), np.asarray(jmasks[k]))
    for field in ("drug_graph", "dis_graph", "drug_feature_graph",
                  "dis_feature_graph"):
        np.testing.assert_allclose(_np(getattr(tout, field).a),
                                   np.asarray(getattr(jout, field).a),
                                   atol=1e-6, err_msg=field)
    for field in ("drug_feat", "dis_feat", "drug_sim_feat", "dis_sim_feat"):
        np.testing.assert_allclose(_np(getattr(tout, field)),
                                   np.asarray(getattr(jout, field)),
                                   atol=1e-6, err_msg=field)


def test_augment_draws_keep_rates(data):
    """Edge keep rate 1 - 0.1 within 5 sigma; noise is standard normal;
    fwd and rev masks are independent draws."""
    _, tds = data
    tin = t_fold_inputs(tds, 0)[0]
    draws = {field: d for _, field, d in draw_augment(
        torch.Generator().manual_seed(3), tin, TAug())}
    fwd, rev = draws["edge_masks"]["fwd"], draws["edge_masks"]["rev"]
    n = fwd.numel()
    assert fwd.shape == (2, tds.n_drug, tds.n_dis)
    assert abs(float(fwd.mean()) - 0.9) < 5 * np.sqrt(0.09 / n)
    assert not torch.equal(fwd, rev)
    noise = draws["drug_feat"]
    assert noise.shape == tin.drug_feat.shape
    assert abs(float(noise.mean())) < 0.02 and abs(float(noise.std()) - 1) \
        < 0.02


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_match_jax_on_ties(seed):
    rng = np.random.default_rng(seed)
    n = 500
    scores = np.round(rng.normal(size=n), 1).astype(np.float32)  # many ties
    labels = (rng.random(n) < 0.2).astype(np.float32)
    valid = (rng.random(n) < 0.7).astype(np.float32)
    s, y, v = (torch.tensor(x) for x in (scores, labels, valid))
    pairs = [(tm.auroc(y, s), jm.auroc(labels, scores)),
             (tm.aupr(y, s), jm.aupr(labels, scores)),
             (tm.auroc_masked(y, s, v), jm.auroc_masked(labels, scores, valid)),
             (tm.aupr_masked(y, s, v), jm.aupr_masked(labels, scores, valid))]
    for ours, ref in pairs:
        np.testing.assert_allclose(float(ours), float(ref), atol=1e-6)


def test_plateau_scheduler_matches_jax():
    seq = [0.1, 0.2, 0.2, 0.19, 0.2, 0.21, 0.21, 0.1, 0.1, 0.1, 0.3]
    j, t = JPlateau(0.01, patience=2), TPlateau(0.01, patience=2)
    assert [j.step(m) for m in seq] == [t.step(m) for m in seq]

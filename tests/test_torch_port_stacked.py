"""The port's fold-parallel protocol against the JAX package and against
the port's own sequential path: ``stack_folds``, ``forward_stacked``, the
stacked step with its per-fold clip and per-fold learning rate, the
stacked protocol's artifacts, ``--seed_parallel``, and the stacked draws,
in grid mode (edges mode: tests/test_torch_port_stacked_edges.py).

F = 3 folds throughout, with widths and node counts that are all other
than 3 (tests/_torch_port_setup.py), so a per-fold bias or lr that
broadcast over the wrong axis would not pass.

Tolerances.  stack_folds: exact.  forward_stacked in fp32: rtol 1e-4,
atol 1e-5 scaled by each array's magnitude (the same arithmetic in
another order); bf16 decoder operands: rtol 2e-2, atol 1e-3 scaled
(neighbouring-ulp rounding of near-tie f32 values), as
tests/test_torch_port_model.py.  Stacked steps (fp32, randomness off):
losses rtol 1e-5; params at least 99.9% of each leaf within atol 2e-5
and every element within 2 * max(lr) * steps, the bound of
tests/test_torch_port_train.py (an Adam step moves a component whose
gradient is rounding noise by up to lr).  Protocol artifacts: CSV
columns within 2e-4, as tests/test_foldparallel.py.  Clip and Adam
against optax: rtol 1e-6.
"""

import dataclasses
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import dream_gnn_tpu.kernels.pallas_decoder as pdm
from dream_gnn_tpu.config import AugmentConfig as JAug
from dream_gnn_tpu.config import TrainConfig as JTrain
from dream_gnn_tpu.data.loader import DreamDataset as JDataset
from dream_gnn_tpu.data.synthetic import synthetic_raw_data as j_raw
from dream_gnn_tpu.model.dream_gnn import forward_stacked as j_forward_stacked
from dream_gnn_tpu.model.dream_gnn import init_params as j_init
from dream_gnn_tpu.sharding.foldstack import stack_folds as j_stack_folds
from dream_gnn_tpu.train.optim import make_optimizer as j_make_optimizer
from dream_gnn_tpu.train.stacked import make_stacked_train_fns
from dream_gnn_tpu_torch.augment.masks import draw_augment
from dream_gnn_tpu_torch.config import AugmentConfig as TAug
from dream_gnn_tpu_torch.config import ModelConfig as TModel
from dream_gnn_tpu_torch.config import TrainConfig as TTrain
from dream_gnn_tpu_torch.convert import params_from_jax
from dream_gnn_tpu_torch.data.loader import DreamDataset as TDataset
from dream_gnn_tpu_torch.data.synthetic import synthetic_raw_data as t_raw
from dream_gnn_tpu_torch.kernels.edge_decoder import edge_order
from dream_gnn_tpu_torch.model.dream_gnn import forward, forward_stacked
from dream_gnn_tpu_torch.model.dream_gnn import param_leaves
from dream_gnn_tpu_torch.nn.dropout import dropout
from dream_gnn_tpu_torch.sharding.foldstack import stack_folds, tree_map
from dream_gnn_tpu_torch.train.loop import (fold_generator, fold_inputs,
                                            fold_seed, train_fold)
from dream_gnn_tpu_torch.train.losses import total_loss
from dream_gnn_tpu_torch.train.optim import (StackedAdam,
                                             clip_by_global_norm_per_fold_,
                                             global_norm_per_fold)
from dream_gnn_tpu_torch.train.stacked import (init_state_stacked,
                                               make_one_step_stacked,
                                               stack_seed, stacked_loss,
                                               train_seed_foldparallel,
                                               train_stacked_protocol)
from tests._torch_port_setup import (SMALL_MODEL, datasets, model_cfgs,
                                     numpy_tree)

FOLDS = [0, 1, 2]
F = len(FOLDS)
LRS = [2e-3, 1e-3, 4e-3]
OUT_NAMES = ("pred", "drug_out", "drug_sim_out", "dis_out", "dis_sim_out")
TOL = {"float32": (1e-4, 1e-5), "bfloat16": (2e-2, 1e-3)}
NO_RANDOMNESS = dict(dropout=0.0, attention_dropout=0.0,
                     compute_dtype="float32")


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


def _close(a, b, rtol, atol, what):
    a, b = _np(a), np.asarray(b)
    assert a.shape == b.shape, what
    scale = max(1e-3, float(np.abs(b).max()))
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol * scale,
                               err_msg=what)


def _j_stacked_params(jcfg):
    return jax.tree.map(lambda *xs: jnp.stack(xs),
                        *[j_init(jax.random.key(s), jcfg) for s in range(F)])


def _leaves_equal(port_tree, jax_tree, what):
    """Every tensor of a port dataclass tree equals the JAX array of the
    same field: shape, dtype and values.  ``dec_order`` and ``dec_shard``,
    the port's index preparation for its edge kernel without and with a
    mesh, have no JAX field."""
    if port_tree is None:
        assert jax_tree is None, what
        return
    if isinstance(port_tree, torch.Tensor):
        a, b = _np(port_tree), np.asarray(jax_tree)
        assert a.shape == b.shape and a.dtype == b.dtype, what
        np.testing.assert_array_equal(a, b, err_msg=what)
        return
    for f in dataclasses.fields(port_tree):
        if f.name not in ("dec_order", "dec_shard"):
            _leaves_equal(getattr(port_tree, f.name),
                          getattr(jax_tree, f.name), f"{what}.{f.name}")


@pytest.mark.parametrize("side", ["train", "test"])
@pytest.mark.parametrize("preset", ["Gdataset", "Cdataset", "lrssl"])
def test_stack_folds_equal_jax(preset, side):
    """Every stacked array of the three presets equals the JAX package's;
    the test side carries the test encoder graph, whose in-fold mask is
    smaller than the train side's, and its weight mass is the fold's test
    pair count."""
    jds = JDataset(j_raw(preset, seed=0), k=4)
    tds = TDataset(t_raw(preset, seed=0), k=4, device="cpu")
    ours = stack_folds(tds, FOLDS, side=side)
    ref = j_stack_folds(jds, FOLDS, side=side)
    assert ours.n_folds == F
    _leaves_equal(ours, ref, f"{preset}/{side}")
    order = edge_order(ours.inputs.dec_src, ours.inputs.dec_dst,
                       tds.n_drug, tds.n_dis)
    for name in ("perm", "split_edge", "split_drug"):
        assert torch.equal(getattr(ours.inputs.dec_order, name),
                           getattr(order, name)), name
    if side == "test":
        train = stack_folds(tds, FOLDS, side="train")
        for i, cv in enumerate(FOLDS):
            assert float(ours.inputs.enc_graph.mask[i].sum()) \
                < float(train.inputs.enc_graph.mask[i].sum())
            assert float(ours.edge_weight[i].sum()) \
                == tds.splits[cv].test_pairs.shape[1]


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("side", ["train", "test"])
def test_forward_stacked_matches_jax(data, dtype, side):
    """Eval-mode forward of a 3-fold stack: logits and the four route
    outputs against JAX forward_stacked (Pallas grid backend, interpret
    mode), and fold f against the port's single-fold forward."""
    jds, tds = data
    jcfg, tcfg = model_cfgs(jds, tds, compute_dtype=dtype)
    jparams = _j_stacked_params(jcfg)
    jout = j_forward_stacked(jparams, j_stack_folds(jds, FOLDS,
                                                    side=side).inputs,
                             jcfg, train=False)
    tparams = params_from_jax(numpy_tree(jparams), device="cpu")
    tin = stack_folds(tds, FOLDS, side=side).inputs
    with torch.no_grad():
        tout = forward_stacked(tparams, tin, tcfg, train=False)
    rtol, atol = TOL[dtype]
    for name, a, b in zip(OUT_NAMES, tout, jout):
        _close(a, b, rtol, atol, name)
    with torch.no_grad():
        for f, cv in enumerate(FOLDS):
            one = forward(tree_map(lambda t, f=f: t[f], tparams),
                          fold_inputs(tds, cv)[side == "test"], tcfg,
                          train=False)
            for name, a, b in zip(OUT_NAMES, tout, one):
                _close(a[f], b, 1e-5, 1e-6, f"fold {f} {name}")


def _steps_setup(data, **overrides):
    """fp32 configs with randomness off, JAX stacked params whose fold 1
    has its decoder output weights scaled up, and a clip between fold 1's
    initial gradient norm and the other folds' norms."""
    jds, tds = data
    jtrain, ttrain = JTrain(augment=JAug(methods=())), \
        TTrain(augment=TAug(methods=()))
    jcfg, tcfg = model_cfgs(jds, tds, jtrain, ttrain,
                            **dict(NO_RANDOMNESS, **overrides))
    jparams = _j_stacked_params(jcfg)
    jparams["decoder"]["w3"] = jparams["decoder"]["w3"].at[1].multiply(30.0)
    np_params = numpy_tree(jparams)

    tparams = params_from_jax(np_params, device="cpu")
    leaves = param_leaves(tparams)
    for p in leaves:
        p.requires_grad_(True)
    stack = stack_folds(tds, FOLDS)
    stacked_loss(tparams, stack.inputs, tcfg, ttrain, torch.Generator(),
                 stack.labels, stack.edge_weight).sum().backward()
    norms = _np(global_norm_per_fold([p.grad for p in leaves]))
    top = np.sort(norms)
    clip = float(np.sqrt(top[-1] * top[-2]))
    assert list(norms > clip) == [False, True, False]
    return (jds, tds, jcfg, tcfg, np_params,
            dataclasses.replace(jtrain, train_grad_clip=clip),
            dataclasses.replace(ttrain, train_grad_clip=clip))


@pytest.mark.parametrize("n_steps", [1, 5])
def test_stacked_steps_match_jax(data, n_steps):
    """n stacked steps against JAX make_one_step_stacked: per-fold
    learning rates, and fold 1 alone over the clip at the first step."""
    _check_stacked_steps(data, n_steps)


def _check_stacked_steps(data, n_steps, **overrides):
    jds, tds, jcfg, tcfg, np_params, jtrain, ttrain = _steps_setup(
        data, **overrides)

    init_j, run_steps_j, _ = make_stacked_train_fns(jcfg, jtrain)
    keys = jnp.stack([jax.random.fold_in(jax.random.key(0), cv)
                      for cv in FOLDS])
    # run_steps donates its state, so JAX gets buffers of its own.
    jstate = dataclasses.replace(init_j(keys),
                                 params=jax.tree.map(jnp.asarray, np_params),
                                 lr=jnp.asarray(LRS, jnp.float32))
    jtr = j_stack_folds(jds, FOLDS)
    jlosses = []
    for _ in range(n_steps):
        jstate, loss = run_steps_j(jstate, jtr, 1)
        jlosses.append(np.asarray(loss))

    state = init_state_stacked(params_from_jax(np_params, device="cpu"),
                               torch.Generator(), ttrain)
    state.opt.lr.copy_(torch.tensor(LRS))
    one_step = make_one_step_stacked(tcfg, ttrain)
    tr = stack_folds(tds, FOLDS)
    tlosses = [_np(one_step(state, tr.inputs, tr.labels, tr.edge_weight))
               for _ in range(n_steps)]
    np.testing.assert_allclose(np.stack(tlosses), np.stack(jlosses),
                               rtol=1e-5)

    jleaves = param_leaves(params_from_jax(numpy_tree(jstate.params),
                                           device="cpu"))
    bound = 2 * max(LRS) * n_steps
    for i, (t, j) in enumerate(zip(param_leaves(state.params), jleaves)):
        diff = np.abs(_np(t) - _np(j))
        assert np.mean(diff > 2e-5) <= 1e-3, f"param leaf {i}"
        assert diff.max() <= bound, f"param leaf {i}"


def test_clip_is_per_fold(rng):
    """One fold over the limit is scaled to it; the others are untouched,
    as optax's clip vmapped over folds."""
    grads = [rng.normal(size=(F, 5, 4)).astype(np.float32),
             rng.normal(size=(F, 7)).astype(np.float32)]
    for g in grads:
        g[1] *= 100.0
    norms = np.sqrt(sum((g.reshape(F, -1) ** 2).sum(1) for g in grads))
    max_norm = float(np.sqrt(norms[1] * max(norms[0], norms[2])))
    ref = jax.vmap(lambda *g: optax.clip_by_global_norm(max_norm).update(
        list(g), None)[0])(*[jnp.asarray(g) for g in grads])
    ours = [torch.tensor(g) for g in grads]
    got = clip_by_global_norm_per_fold_(ours, max_norm)
    np.testing.assert_allclose(_np(got), norms, rtol=1e-6)
    for a, b, g in zip(ours, ref, grads):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-6)
        np.testing.assert_array_equal(_np(a)[[0, 2]], g[[0, 2]])
        assert not np.allclose(_np(a)[1], g[1])


def test_stacked_adam_matches_optax_chain(rng):
    """Three updates of StackedAdam (weight decay, per-fold lr) against
    optax add_decayed_weights -> scale_by_adam vmapped over folds, then
    p - lr[f] * u (stacked.py:97-104 of the JAX package)."""
    shapes = [(F, 6, 3), (F, 4)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    tx = j_make_optimizer(0.0, 1e-2)
    jp = [jnp.asarray(p) for p in params]
    opt_state = jax.vmap(tx.init)(jp)
    lr = jnp.asarray(LRS, jnp.float32)
    tp = [torch.tensor(p) for p in params]
    adam = StackedAdam(tp, torch.tensor(LRS), weight_decay=1e-2)
    for _ in range(3):
        grads = [rng.normal(size=s).astype(np.float32) for s in shapes]
        upd, opt_state = jax.vmap(tx.update)([jnp.asarray(g) for g in grads],
                                             opt_state, jp)
        jp = [p - lr.reshape((-1,) + (1,) * (u.ndim - 1)) * u
              for p, u in zip(jp, upd)]
        adam.step([torch.tensor(g) for g in grads])
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)


def test_losses_are_per_fold(data, rng):
    """total_loss over a fold axis is each fold's own loss: the BCE mean
    over its own weight mass and its own Gram matrices; changing one
    fold's inputs moves that fold's loss only."""
    n, e, d = 7, 50, 5
    args = [torch.tensor(rng.normal(size=(F, e)).astype(np.float32)),
            torch.tensor((rng.random((F, e)) < 0.3).astype(np.float32))] + [
        torch.tensor(rng.normal(size=(F, n, d)).astype(np.float32))
        for _ in range(4)]
    w = torch.tensor((rng.random((F, e)) < 0.8).astype(np.float32))
    losses, bce = total_loss(*args, beta=0.1, weight=w)
    assert losses.shape == bce.shape == (F,)
    for f in range(F):
        one, one_bce = total_loss(*[a[f] for a in args], beta=0.1,
                                  weight=w[f])
        np.testing.assert_allclose(float(losses[f]), float(one), rtol=1e-6)
        np.testing.assert_allclose(float(bce[f]), float(one_bce), rtol=1e-6)
    w2 = w.clone()
    w2[0] = 1.0
    moved, _ = total_loss(*args, beta=0.1, weight=w2)
    assert float(moved[0]) != float(losses[0])
    assert torch.equal(moved[1:], losses[1:])


def _cfg(model_kw=(), **kw):
    model = TModel(**dict(SMALL_MODEL, **NO_RANDOMNESS, **dict(model_kw)))
    return TTrain(model=model, augment=TAug(methods=()), train_max_iter=11,
                  train_valid_interval=5, **kw)


def _csv(path):
    return np.genfromtxt(path, delimiter=",", names=True)


def _same_csvs(dir_a, dir_b, folds, what):
    for cv in folds:
        for stem in ("test_metric", "best_metric"):
            a = _csv(os.path.join(dir_a, f"{stem}{cv + 1}.csv"))
            b = _csv(os.path.join(dir_b, f"{stem}{cv + 1}.csv"))
            assert a.dtype.names == b.dtype.names
            for name in a.dtype.names:
                np.testing.assert_allclose(
                    np.atleast_1d(a[name]), np.atleast_1d(b[name]),
                    atol=2e-4, err_msg=f"{what} fold {cv} {stem} {name}")


def test_stacked_protocol_matches_sequential(data, tmp_path):
    """With randomness off, each fold of the stacked protocol is the
    sequential port run of that fold (same initial params, drawn from
    fold_generator(seed, cv)): CSV columns and best metrics within 2e-4,
    and the same files."""
    _check_protocol_matches_sequential(data, tmp_path, _cfg())


def _check_protocol_matches_sequential(data, tmp_path, cfg):
    _, tds = data
    seed = 123
    seq_dir, par_dir = tmp_path / "seq", tmp_path / "par"
    seq = [train_fold(tds, cv, cfg, fold_generator(seed, cv, "cpu"),
                      save_dir=str(seq_dir), save_id=cv + 1, verbose=False)
           for cv in FOLDS]
    par = train_seed_foldparallel(tds, cfg, seed, FOLDS,
                                  save_dir=str(par_dir), verbose=False)
    assert len(par) == F
    for s, p in zip(seq, par):
        assert p["best_auroc"] == pytest.approx(s["best_auroc"], abs=2e-4)
        assert p["best_aupr"] == pytest.approx(s["best_aupr"], abs=2e-4)
        assert p["best_iter"] == s["best_iter"]
    _same_csvs(seq_dir, par_dir, FOLDS, "stacked vs sequential")
    assert sorted(os.path.basename(f) for f in glob.glob(
        str(par_dir / "*.csv"))) == sorted(
        os.path.basename(f) for f in glob.glob(str(seq_dir / "*.csv")))


def test_seed_parallel_matches_per_seed(data, tmp_path):
    """Seeds 7 and 8 x folds 0, 1 as one 4-item stack give each seed's
    artifacts of a per-seed fold-parallel run (randomness off)."""
    _, tds = data
    cfg, folds = _cfg(), [0, 1]
    dirs = [str(tmp_path / f"sp{s}") for s in (7, 8)]
    per_seed = train_stacked_protocol(tds, cfg, [7, 8], folds,
                                      save_dirs=dirs, verbose=False)
    assert [len(r) for r in per_seed] == [2, 2]
    for s, d, res in zip((7, 8), dirs, per_seed):
        ref_dir = str(tmp_path / f"ref{s}")
        ref = train_seed_foldparallel(tds, cfg, s, folds, save_dir=ref_dir,
                                      verbose=False)
        for a, b in zip(res, ref):
            assert a["best_aupr"] == pytest.approx(b["best_aupr"], abs=2e-4)
        _same_csvs(d, ref_dir, folds, f"seed {s}")


def test_stacked_draws_per_fold(data):
    """Every augmentation draw and dropout mask of a stack is one (F, ...)
    tensor: each fold keeps at 1 - rate within 5 sigma, and no two folds
    share a mask."""
    _, tds = data
    tin = stack_folds(tds, FOLDS).inputs
    gen = torch.Generator().manual_seed(3)
    draws = {field: d for _, field, d in draw_augment(gen, tin, TAug())}
    fwd = draws["edge_masks"]["fwd"]
    assert fwd.shape == (F, 2, tds.n_drug, tds.n_dis)
    masks = {"fwd": fwd, "rev": draws["edge_masks"]["rev"],
             "drug_graph": draws["drug_graph"],
             "dropout": (dropout(gen, torch.ones(F, 40, 64), 0.3, True) > 0)
             .float()}
    for name, m in masks.items():
        rate = 0.3 if name == "dropout" else 0.1
        n = m[0].numel()
        for f in range(F):
            assert abs(float(m[f].mean()) - (1 - rate)) \
                < 5 * np.sqrt(rate * (1 - rate) / n), (name, f)
        for a in range(F):
            for b in range(a + 1, F):
                assert not torch.equal(m[a], m[b]), (name, a, b)
    noise = draws["drug_feat"]
    assert noise.shape == tin.drug_feat.shape
    assert not torch.equal(noise[0], noise[1])


def test_stack_seed():
    """A stack of one item draws from that item's sequential seed; other
    stacks get other seeds, all within torch's seed range."""
    assert stack_seed([77], [4]) == fold_seed(77, 4)
    seeds = {stack_seed(s, f) for s, f in (([77], [0, 1]), ([77], [1, 0]),
                                           ([77, 31415], list(range(10))),
                                           ([31415, 77], list(range(10))))}
    assert len(seeds) == 4
    assert all(0 <= s < 2 ** 63 for s in seeds)


def test_params_from_jax_converts_stacked_tree(data):
    """A JAX param tree with a leading fold axis converts leaf by leaf to
    the stacked port tree: the stack of the per-fold conversions."""
    jds, tds = data
    jcfg, _ = model_cfgs(jds, tds)
    per_fold = [j_init(jax.random.key(s), jcfg) for s in range(F)]
    stacked = params_from_jax(numpy_tree(jax.tree.map(
        lambda *xs: jnp.stack(xs), *per_fold)), device="cpu")
    ref = tree_map(lambda *xs: torch.stack(xs),
                   *[params_from_jax(numpy_tree(p), device="cpu")
                     for p in per_fold])
    a, b = param_leaves(stacked), param_leaves(ref)
    assert len(a) == len(b) > 20
    for x, y in zip(a, b):
        assert x.shape[0] == F and torch.equal(x, y)

"""The training step's six augment methods against the JAX package, and
the host metric.

- ``apply_augment`` fed the very draws that JAX ``augment_inputs`` makes
  (its key order, masks.py:230-293 of the JAX package), for each of the
  four methods added last, for all six, and for ordered pairs, on one
  fold and on a 3-fold stack (JAX vmapped over folds, as its stacked step
  runs it).  The pairs pin the composition in method order: graph noise
  on what edge dropout kept and the reverse, and the encoder masks, where
  an edge dropout after an edge addition throws the add masks away, as
  JAX does.
- The GCMC layer with edge-add masks against JAX ``gcmc_layer_apply``,
  with and without a fold axis.
- Training steps with all six methods and injected draws against the
  JAX step, on one fold and on a stack.
- The port's own draws from a ``torch.Generator``: the add rate per
  rating and per fold, graph noise on nonzero entries only, the feature
  keep rate, mix-up's permutations and coefficients, one host round trip
  for a step's mix-up coefficients.
- The CLI with the six methods in an order of its own, sequential and
  fold-parallel, grid and edges decode.
- ``roc_aupr_host`` against the JAX function (sklearn) on tied scores and
  on one-class labels.

Tolerances.  Augmented inputs with the same draws: atol 1e-6 (the same
f32 operations).  GCMC layer: rtol 1e-5, atol 1e-5 scaled by the output's
magnitude (the same products summed in another order).  Steps: losses
rtol 1e-5, params as tests/test_torch_port_train.py (99.9% within 2e-5,
every element within 2 * lr * steps).  Draw statistics: 5 sigma on
counts.  Host metric: 1e-12, nan where JAX gives nan.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dream_gnn_tpu.kernels.pallas_decoder as pdm
import dream_gnn_tpu_torch.train.stacked as t_stacked_mod
import dream_gnn_tpu_torch.train.step as t_step_mod
from dream_gnn_tpu.augment import masks as j_masks
from dream_gnn_tpu.config import AugmentConfig as JAug
from dream_gnn_tpu.config import TrainConfig as JTrain
from dream_gnn_tpu.graph.bipartite_coo import \
    synthetic_bipartite_coo as j_synthetic_coo
from dream_gnn_tpu.graph.coo import coo_from_arrays as j_coo
from dream_gnn_tpu.model.dream_gnn import init_params as j_init
from dream_gnn_tpu.nn.gcmc import gcmc_layer_apply as j_gcmc_apply
from dream_gnn_tpu.nn.gcmc import gcmc_layer_init as j_gcmc_init
from dream_gnn_tpu.sharding.foldstack import stack_folds as j_stack_folds
from dream_gnn_tpu.train.loop import fold_inputs as j_fold_inputs
from dream_gnn_tpu.train.optim import make_optimizer
from dream_gnn_tpu.train.stacked import make_stacked_train_fns
from dream_gnn_tpu.train.step import make_one_step as j_make_one_step
from dream_gnn_tpu.train.step import make_train_fns as j_make_train_fns
from dream_gnn_tpu.utils.metrics import roc_aupr_host as j_roc_aupr_host
from dream_gnn_tpu_torch.augment import masks as t_masks
from dream_gnn_tpu_torch.augment.masks import (apply_augment, draw_augment,
                                               edge_addition_masks)
from dream_gnn_tpu_torch.config import AugmentConfig as TAug
from dream_gnn_tpu_torch.config import TrainConfig as TTrain
from dream_gnn_tpu_torch.convert import params_from_jax
from dream_gnn_tpu_torch.data import synthetic
from dream_gnn_tpu_torch.graph.bipartite import BipartiteGraph
from dream_gnn_tpu_torch.graph.bipartite_coo import synthetic_bipartite_coo
from dream_gnn_tpu_torch.graph.coo import coo_from_arrays
from dream_gnn_tpu_torch.model.dream_gnn import param_leaves
from dream_gnn_tpu_torch.nn.gcmc import gcmc_layer_apply
from dream_gnn_tpu_torch.sharding.foldstack import stack_folds
from dream_gnn_tpu_torch.train import cli
from dream_gnn_tpu_torch.train.loop import fold_inputs as t_fold_inputs
from dream_gnn_tpu_torch.train.stacked import (init_state_stacked,
                                               make_one_step_stacked)
from dream_gnn_tpu_torch.train.step import init_state, make_one_step
from dream_gnn_tpu_torch.utils.metrics import roc_aupr_host
from tests._torch_port_setup import datasets, model_cfgs, numpy_tree

GRAPH_FIELDS = ("drug_graph", "dis_graph", "drug_feature_graph",
                "dis_feature_graph")
FEATURE_FIELDS = ("drug_feat", "dis_feat", "drug_sim_feat", "dis_sim_feat")
EMBED_FIELDS = ("drug_feat", "dis_feat")
SIX = ("edge_dropout", "add_random_edges", "feature_noise", "graph_noise",
       "feature_masking", "mix_up")
METHOD_SETS = [
    ("add_random_edges",), ("graph_noise",), ("feature_masking",),
    ("mix_up",), SIX, SIX[::-1],
    ("edge_dropout", "graph_noise"), ("graph_noise", "edge_dropout"),
    ("edge_dropout", "add_random_edges"), ("add_random_edges", "edge_dropout"),
    ("feature_noise", "feature_masking", "mix_up"),
    ("mix_up", "feature_masking", "feature_noise")]
FOLDS = [0, 1, 2]
F = len(FOLDS)
N_STEPS = 3
# A larger add rate than the default 0.03, so that the small preset's
# rating-1 relation gets added edges.
ADD_RATE = 0.5


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


def _jax_draws(key, jin, cfg):
    """The draws of JAX ``augment_inputs(key, jin, cfg)``, made from its
    keys in its order: ([(method, field)], [draw]) in the port's draw
    layout (masks.py:230-293 of the JAX package)."""
    keys = iter(jax.random.split(key, 24))
    names, values = [], []

    def put(method, field, value):
        names.append((method, field))
        values.append(value)

    graphs = [f for f in GRAPH_FIELDS if getattr(jin, f) is not None]
    for method in cfg.methods:
        if method == "edge_dropout":
            enc = jin.enc_graph
            put(method, "edge_masks", j_masks.edge_dropout_masks(
                next(keys), enc.n_drug, enc.n_dis, 2, cfg.edge_dropout_rate))
            for f in graphs:
                put(method, f, jax.random.bernoulli(
                    next(keys), 1.0 - cfg.edge_dropout_rate,
                    getattr(jin, f).a.shape).astype(jnp.float32))
        elif method == "feature_noise":
            for f in FEATURE_FIELDS:
                x = getattr(jin, f)
                put(method, f, jax.random.normal(next(keys), x.shape,
                                                 x.dtype))
        elif method == "graph_noise":
            for f in graphs:
                put(method, f, jax.random.normal(next(keys),
                                                 getattr(jin, f).a.shape))
        elif method == "feature_masking":
            for f in EMBED_FIELDS:
                put(method, f, jax.random.uniform(next(keys),
                                                  getattr(jin, f).shape))
        elif method == "mix_up":
            for f in EMBED_FIELDS:
                kp, kl = jax.random.split(next(keys))
                put(method, f, (jax.random.permutation(
                    kp, getattr(jin, f).shape[0]), jax.random.beta(
                        kl, cfg.mixup_alpha, cfg.mixup_alpha)))
        elif method == "add_random_edges":
            put(method, "edge_masks", j_masks.edge_addition_masks(
                next(keys), jin.enc_graph, 2, cfg.add_edge_rate))
    return names, values


def _torch(v):
    if isinstance(v, dict):
        return {k: _torch(x) for k, x in v.items()}
    if isinstance(v, tuple):
        return tuple(_torch(x) for x in v)
    return torch.tensor(np.asarray(v))


def _port_draws(key, jin, cfg, stacked: bool):
    """The JAX draws for the port's ``apply_augment``; on a stack, JAX's
    vmap over the folds' keys and inputs, as its stacked step makes them
    (stacked.py:85-89 of the JAX package)."""
    if stacked:
        names = _jax_draws(key[0], jax.tree.map(lambda x: x[0], jin), cfg)[0]
        values = jax.vmap(lambda k, i: _jax_draws(k, i, cfg)[1])(key, jin)
    else:
        names, values = _jax_draws(key, jin, cfg)
    return [(m, f, _torch(v)) for (m, f), v in zip(names, values)]


def _inputs(data, stacked: bool):
    jds, tds = data
    if stacked:
        return (j_stack_folds(jds, FOLDS).inputs,
                stack_folds(tds, FOLDS).inputs)
    return j_fold_inputs(jds, 0)[0], t_fold_inputs(tds, 0)[0]


def _assert_same(tout, tmasks, jout, jmasks, what):
    for f in GRAPH_FIELDS:
        np.testing.assert_allclose(_np(getattr(tout, f).a),
                                   np.asarray(getattr(jout, f).a),
                                   atol=1e-6, err_msg=f"{what} {f}")
    for f in FEATURE_FIELDS:
        np.testing.assert_allclose(_np(getattr(tout, f)),
                                   np.asarray(getattr(jout, f)),
                                   atol=1e-6, err_msg=f"{what} {f}")
    assert (tmasks is None) == (jmasks is None), what
    if jmasks is not None:
        assert set(tmasks) == set(jmasks), what
        for k in jmasks:
            np.testing.assert_array_equal(_np(tmasks[k]),
                                          np.asarray(jmasks[k]),
                                          err_msg=f"{what} {k}")


@pytest.mark.parametrize("stacked", [False, True], ids=["fold", "stack"])
@pytest.mark.parametrize("methods", METHOD_SETS, ids="-".join)
def test_augment_with_injected_draws_matches_jax(data, methods, stacked):
    cfg_j = JAug(methods=methods, add_edge_rate=ADD_RATE)
    cfg_t = TAug(methods=methods, add_edge_rate=ADD_RATE)
    jin, tin = _inputs(data, stacked)
    if stacked:
        keys = jax.random.split(jax.random.key(5), F)
        jout, jmasks = jax.vmap(lambda k, i: j_masks.augment_inputs(
            k, i, cfg_j))(keys, jin)
    else:
        keys = jax.random.key(5)
        jout, jmasks = j_masks.augment_inputs(keys, jin, cfg_j)
    draws = _port_draws(keys, jin, cfg_j, stacked)
    own = draw_augment(torch.Generator(), tin, cfg_t)
    assert [(m, f) for m, f, _ in own] == [(m, f) for m, f, _ in draws]
    tout, tmasks = apply_augment(tin, draws, cfg_t)
    _assert_same(tout, tmasks, jout, jmasks, "-".join(methods))

    if methods == ("add_random_edges", "edge_dropout"):
        # The later dropout set the masks: JAX trains without added edges.
        assert "fwd_add" not in tmasks
    if "add_random_edges" in methods[-1:] or methods == SIX:
        added = tmasks["fwd_add"][..., 1, :, :]
        assert float(added.sum()) > 0
        # Each fold's rate is its own: rating 0 adds more than rating 1.
        assert (tmasks["fwd_add"][..., 0, :, :].sum((-2, -1))
                > added.sum((-2, -1))).all()
    if methods == ("edge_dropout", "graph_noise"):
        dropped = draws[1][2] == 0
        assert bool((tout.drug_graph.a[dropped] == 0).all())


@pytest.mark.parametrize("stacked", [False, True], ids=["fold", "stack"])
def test_gcmc_layer_with_add_masks_matches_jax(data, stacked):
    """The dense GCMC layer with keep and add masks: A = max(A_r * keep,
    add) per rating and direction (gcmc.py:123-127 of the JAX package)."""
    jin, tin = _inputs(data, stacked)
    enc_j, enc_t = jin.enc_graph, tin.enc_graph
    nd, nv = enc_t.n_drug, enc_t.n_dis
    in_units = tin.drug_feat.shape[-1]
    nkeys = F if stacked else 1
    jparams = [j_gcmc_init(jax.random.key(s), in_units=in_units,
                           msg_units=24, out_units=12) for s in range(nkeys)]
    rng = np.random.default_rng(2)
    lead = (F,) if stacked else ()
    masks = {k: (rng.random((*lead, 2, nd, nv)) < rate).astype(np.float32)
             for k, rate in (("fwd", 0.7), ("rev", 0.7), ("fwd_add", 0.05),
                             ("rev_add", 0.05))}

    def j_layer(p, g, d, v, m):
        return j_gcmc_apply(p, g, d, v, dropout_rate=0.0, edge_masks=m)

    if stacked:
        jp = jax.tree.map(lambda *xs: jnp.stack(xs), *jparams)
        jout = jax.vmap(j_layer)(jp, enc_j, jin.drug_feat, jin.dis_feat,
                                 masks)
    else:
        jp = jparams[0]
        jout = j_layer(jp, enc_j, jin.drug_feat, jin.dis_feat, masks)
    tparams = params_from_jax(numpy_tree(jp), device="cpu")
    tmasks = {k: torch.from_numpy(v) for k, v in masks.items()}
    tout = gcmc_layer_apply(tparams, enc_t, tin.drug_feat, tin.dis_feat,
                            dropout_rate=0.0, edge_masks=tmasks)
    keep_only = gcmc_layer_apply(
        tparams, enc_t, tin.drug_feat, tin.dis_feat, dropout_rate=0.0,
        edge_masks={k: tmasks[k] for k in ("fwd", "rev")})
    for name, a, b, c in zip(("drug", "dis"), tout, jout, keep_only):
        b = np.asarray(b)
        scale = max(1e-3, float(np.abs(b).max()))
        np.testing.assert_allclose(_np(a), b, rtol=1e-5, atol=1e-5 * scale,
                                   err_msg=name)
        assert not torch.allclose(a, c), f"{name}: the add masks did nothing"


def _inject(monkeypatch, module, queue):
    """Make ``module``'s step apply the next injected draws of ``queue``
    in place of its own."""
    monkeypatch.setattr(module, "augment_inputs",
                        lambda gen, inputs, cfg, num_ratings=2:
                        apply_augment(inputs, queue.pop(0), cfg))


def _check_params(tparams, jparams, bound):
    jleaves = param_leaves(params_from_jax(numpy_tree(jparams),
                                           device="cpu"))
    for i, (t, j) in enumerate(zip(param_leaves(tparams), jleaves)):
        diff = np.abs(_np(t) - _np(j))
        assert np.mean(diff > 2e-5) <= 1e-3, f"param leaf {i}"
        assert diff.max() <= bound, f"param leaf {i}"


def _step_cfgs(data):
    jds, tds = data
    jtrain = JTrain(augment=JAug(methods=SIX, add_edge_rate=ADD_RATE))
    ttrain = TTrain(augment=TAug(methods=SIX, add_edge_rate=ADD_RATE))
    jcfg, tcfg = model_cfgs(jds, tds, jtrain, ttrain, dropout=0.0,
                            attention_dropout=0.0, compute_dtype="float32")
    return jtrain, ttrain, jcfg, tcfg


def test_six_method_steps_match_jax(data, monkeypatch):
    """N_STEPS sequential steps with the six methods: the port applies the
    draws JAX makes from each step's augment key (train/step.py:72 of
    the JAX package); dropout off, so the draws are the only randomness."""
    jds, tds = data
    jtrain, ttrain, jcfg, tcfg = _step_cfgs(data)
    jparams = j_init(jax.random.key(11), jcfg)
    init_j, *_ = j_make_train_fns(jcfg, jtrain)
    jstate = init_j(jparams, jax.random.key(0))
    j_step = jax.jit(j_make_one_step(
        jcfg, jtrain, make_optimizer(jtrain.train_grad_clip,
                                     jtrain.weight_decay)))
    jin, tin = j_fold_inputs(jds, 1)[0], t_fold_inputs(tds, 1)[0]
    jlab = jds.fold(1).train_labels
    tstate = init_state(params_from_jax(numpy_tree(jparams), device="cpu"),
                        torch.Generator().manual_seed(0), ttrain)
    queue = []
    _inject(monkeypatch, t_step_mod, queue)
    t_step = make_one_step(tcfg, ttrain)
    jlosses, tlosses = [], []
    for _ in range(N_STEPS):
        k_aug = jax.random.split(jstate.key, 3)[1]
        queue.append(_port_draws(k_aug, jin, jtrain.augment, False))
        jstate, loss = j_step(jstate, jin, jlab)
        jlosses.append(float(loss))
        tlosses.append(float(t_step(tstate, tin)))
    assert not queue
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    _check_params(tstate.params, jstate.params, 2 * ttrain.train_lr * N_STEPS)


def test_six_method_stacked_steps_match_jax(data, monkeypatch):
    """The same on a 3-fold stack: JAX's stacked step vmaps the augment
    over the folds' keys (stacked.py:80-89 of the JAX package)."""
    jds, tds = data
    jtrain, ttrain, jcfg, tcfg = _step_cfgs(data)
    np_params = numpy_tree(jax.tree.map(
        lambda *xs: jnp.stack(xs),
        *[j_init(jax.random.key(s), jcfg) for s in range(F)]))
    init_j, run_steps_j, _ = make_stacked_train_fns(jcfg, jtrain)
    keys = jnp.stack([jax.random.fold_in(jax.random.key(0), cv)
                      for cv in FOLDS])
    jstate = dataclasses.replace(init_j(keys),
                                 params=jax.tree.map(jnp.asarray, np_params))
    jtr = j_stack_folds(jds, FOLDS)
    state = init_state_stacked(params_from_jax(np_params, device="cpu"),
                               torch.Generator(), ttrain)
    queue = []
    _inject(monkeypatch, t_stacked_mod, queue)
    one_step = make_one_step_stacked(tcfg, ttrain)
    tr = stack_folds(tds, FOLDS)
    jlosses, tlosses = [], []
    for _ in range(N_STEPS):
        k_aug = jax.vmap(lambda k: jax.random.split(k, 3)[1])(jstate.key)
        queue.append(_port_draws(k_aug, jtr.inputs, jtrain.augment, True))
        jstate, loss = run_steps_j(jstate, jtr, 1)
        jlosses.append(np.asarray(loss).reshape(-1))
        tlosses.append(_np(one_step(state, tr.inputs, tr.labels,
                                    tr.edge_weight)))
    assert not queue
    np.testing.assert_allclose(np.stack(tlosses), np.stack(jlosses),
                               rtol=1e-5)
    _check_params(state.params, jstate.params,
                  2 * ttrain.train_lr * N_STEPS)


def _sigma_band(count, n, p):
    """|count - n p| within 5 sigma of a Binomial(n, p) count."""
    return abs(count - n * p) <= 5 * np.sqrt(n * p * (1 - p)) + 1e-9


def test_add_rate_is_per_rating_and_per_fold():
    """A stack of three folds of other densities: each fold and rating adds
    its own add_rate * E_r edges in expectation, within 5 sigma on the
    count, in each direction independently."""
    nd, nv, rate = 120, 90, 0.4
    rng = np.random.default_rng(0)
    density = np.array([0.02, 0.1, 0.3])
    a1 = (rng.random((F, nd, nv)) < density[:, None, None]).astype(np.float32)
    ones = torch.ones(F, nd, 1)
    graph = BipartiteGraph(a1=torch.from_numpy(a1),
                           mask=torch.ones(F, nd, nv), ci_drug=ones,
                           cj_drug=ones, ci_dis=torch.ones(F, nv, 1),
                           cj_dis=torch.ones(F, nv, 1))
    add = edge_addition_masks(torch.Generator().manual_seed(1), graph, 2,
                              rate)
    cells = nd * nv
    for f in range(F):
        for r, edges in enumerate((cells - a1[f].sum(), a1[f].sum())):
            p = min(rate * edges / cells, 1.0)
            for k in ("fwd_add", "rev_add"):
                assert add[k].shape == (F, 2, nd, nv)
                assert _sigma_band(float(add[k][f, r].sum()), cells, p), \
                    (f, r, k)
    assert not torch.equal(add["fwd_add"], add["rev_add"])


def test_graph_noise_touches_nonzero_entries_only(data):
    _, tds = data
    tin = stack_folds(tds, FOLDS).inputs
    cfg = TAug(methods=("graph_noise",))
    out, masks = t_masks.augment_inputs(torch.Generator().manual_seed(2),
                                        tin, cfg)
    assert masks is None
    for f in GRAPH_FIELDS:
        a, b = getattr(tin, f).a, getattr(out, f).a
        assert bool((b[a == 0] == 0).all()) and bool((b >= 0).all()), f
        assert not torch.equal(a[a != 0], b[a != 0]), f
        assert not torch.equal(b[0] - a[0], b[1] - a[1]), f


def test_feature_masking_keeps_0_9_unscaled(data):
    _, tds = data
    tin = stack_folds(tds, FOLDS).inputs
    cfg = TAug(methods=("feature_masking",))
    out, _ = t_masks.augment_inputs(torch.Generator().manual_seed(3), tin,
                                    cfg)
    for f in EMBED_FIELDS:
        x, y = getattr(tin, f), getattr(out, f)
        kept = y != 0
        assert torch.equal(y[kept], x[kept]), f
        for k in range(F):
            n = x[k].numel()
            assert _sigma_band(float((kept[k] | (x[k] == 0)).sum()), n,
                               0.9), (f, k)
        assert not torch.equal(kept[0], kept[1])
    assert torch.equal(out.drug_sim_feat, tin.drug_sim_feat)


def test_mixup_draws_per_fold_with_one_host_round_trip(data, monkeypatch):
    """Each fold and field draws its own permutation and coefficient; a
    step's coefficients come from one betaincinv call."""
    import scipy.special

    calls = []
    real = scipy.special.betaincinv
    monkeypatch.setattr(scipy.special, "betaincinv",
                        lambda *a: calls.append(1) or real(*a))
    _, tds = data
    tin = stack_folds(tds, FOLDS).inputs
    draws = draw_augment(torch.Generator().manual_seed(4), tin,
                         TAug(methods=("mix_up",)))
    assert len(calls) == 1
    assert [(m, f) for m, f, _ in draws] == [("mix_up", f)
                                             for f in EMBED_FIELDS]
    lams = []
    for _, field, (perm, lam) in draws:
        n = getattr(tin, field).shape[-2]
        assert perm.shape == (F, n) and lam.shape == (F,)
        assert torch.equal(perm.sort(-1).values,
                           torch.arange(n).expand(F, n))
        assert not torch.equal(perm[0], perm[1])
        assert bool(((lam >= 0) & (lam <= 1)).all())
        lams.append(lam)
    assert len(set(torch.cat(lams).tolist())) == 2 * F


def test_add_random_edges_needs_the_dense_encoder(data):
    """Both packages refuse an edge addition on a padded-COO encoder graph,
    with JAX's message (masks.py:285-287 of the JAX package)."""
    jds, tds = data
    jin, tin = j_fold_inputs(jds, 0)[0], t_fold_inputs(tds, 0)[0]
    jin = dataclasses.replace(jin, enc_graph=j_synthetic_coo(40, 30, 200))
    tin = dataclasses.replace(tin, enc_graph=synthetic_bipartite_coo(
        40, 30, 200, device="cpu"))
    msgs = []
    for fn, args in ((j_masks.augment_inputs, (jax.random.key(0), jin)),
                     (t_masks.augment_inputs, (torch.Generator(), tin))):
        with pytest.raises(NotImplementedError) as err:
            fn(*args, JAug(methods=("add_random_edges",)))
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1] == "add_random_edges: dense-mask encoder " \
        "graphs only"


def test_graph_noise_needs_dense_similarity_graphs(data):
    """Graph noise reads ``.a``: on a COO similarity graph both packages
    meet the same AttributeError."""
    jds, tds = data
    jin, tin = j_fold_inputs(jds, 0)[0], t_fold_inputs(tds, 0)[0]
    src, dst, val = np.arange(4), np.arange(4), np.ones(4)
    jin = dataclasses.replace(jin, drug_graph=j_coo(src, dst, val, 40, 40))
    tin = dataclasses.replace(tin, drug_graph=coo_from_arrays(
        src, dst, val, 40, 40, device="cpu"))
    with pytest.raises(AttributeError, match="'a'"):
        j_masks.augment_inputs(jax.random.key(0), jin,
                               JAug(methods=("graph_noise",)))
    with pytest.raises(AttributeError, match="'a'"):
        t_masks.augment_inputs(torch.Generator(), tin,
                               TAug(methods=("graph_noise",)))


@pytest.mark.parametrize("flags", [[], ["--fold_parallel"]],
                         ids=["sequential", "fold_parallel"])
@pytest.mark.parametrize("mode", ["grid", "edges"])
def test_cli_trains_with_the_six_methods(tmp_path, monkeypatch, flags, mode):
    monkeypatch.setitem(synthetic.PRESETS, "tiny", (40, 30, 60))
    summary = cli.main([
        "--device", "-1", "--data_name", "tiny", "--seeds", "7", "--folds",
        "0", "1", "--train_max_iter", "3", "--train_valid_interval", "2",
        "--layers", "2", "--gcn_agg_units", "48", "--gcn_out_units", "16",
        "--nhid1", "32", "--nhid2", "16", "--decode_mode", mode,
        "--aug_methods", "mix_up", "graph_noise", "add_random_edges",
        "feature_masking", "edge_dropout", "feature_noise",
        "--save_dir", str(tmp_path), *flags])
    assert np.isfinite(summary["mean_auroc"])
    assert (tmp_path / "seed_7" / "test_metric2.csv").exists()


def _host_cases():
    rng = np.random.default_rng(0)
    for n, decimals in ((500, 1), (300, 0), (64, 2)):
        yield (f"ties-{n}", (rng.random(n) < 0.2).astype(np.float32),
               np.round(rng.normal(size=n), decimals).astype(np.float32))
    s = np.round(rng.normal(size=50), 1).astype(np.float32)
    yield "no-positive", np.zeros(50, np.float32), s
    yield "no-negative", np.ones(50, np.float32), s
    yield "pm1-labels", np.where(rng.random(50) < 0.3, 1, -1), s


@pytest.mark.parametrize("name,y,s", list(_host_cases()),
                         ids=[c[0] for c in _host_cases()])
@pytest.mark.filterwarnings("ignore")
def test_roc_aupr_host_matches_jax(name, y, s):
    got, want = roc_aupr_host(y, s), j_roc_aupr_host(y, s)
    for a, b in zip(got, want):
        if np.isnan(b):
            assert np.isnan(a), name
        else:
            assert abs(a - b) <= 1e-12, name

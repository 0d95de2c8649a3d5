"""The sharded scale path's training step over S ranks against one rank,
and, in the slow tier, against the JAX package.

Every gradient must be summed exactly once: a collective that summed a
replicated gradient over the ranks would multiply it by S, one that missed
a partial gradient would leave (S - 1) / S of it out.  So the port over
S = 2 and S = 4 gloo ranks on the CPU is held against the same port on one
rank (rank 0 alone, ``make_mesh(dp=1)``, in the same spawn; one spawn per S
for the module, joined through a file under ``tmp_path``), from the same
generator state (tests/_torch_port_sharded_worker.py):
- each collective of sharding/collectives.py, forward and backward, exactly;
- one sharded-grouped SpMM, forward (bit for bit the unsharded SpMM's) and
  backward;
- the candidate-sharded scale decoder with dropout 0.5 (fp32, one explicit
  PRF seed): the loss over every rank's slots and the gradients of both
  tables and every weight;
- the composed model, the sharded-grouped encoder and the candidate-sharded
  scale decoder (bf16; PRF edge dropout, GCMC and decoder dropout 0.3): the
  loss and every parameter gradient of one forward, then two steps of
  ``make_one_step`` with the default augmentation (edge dropout and feature
  noise), their losses and the parameters after them, and ``evaluate``'s
  AUROC and AUPR over every rank's candidates;
- the ring layout's step (one GCMC layer, the plain decoder): the same.
Every rank must end with the same bits.

The slow tier holds the S = 2 run against the JAX package on its virtual
mesh, where JAX's references run its Pallas kernels in interpret mode: the
decoder's loss and gradients at the same seed (JAX's tolerances, rtol 1e-5
on the loss, 2e-4 on the gradients; test_scale_decoder_spmd.py:75-110), the
full model of test_scale_decoder_spmd.py:148-213 (the sharded COO encoder
and the sharded decoder, dropout 0; rtol 1e-4 on the loss, rtol 5e-4 and
atol 5e-5 on the gradients, JAX's) and the ring's step loss with no
augmentation and no dropout (test_sharded_scale.py:314-356; rtol 1e-4).

Tolerance of S ranks against one: the same arithmetic on the same device,
with the weight gradients of the sharded regions summed as S partial sums
(and the SpMM's row blocks multiplied as smaller matrices), so the sums run
in another order: the losses rtol 1e-5; the gradients and the parameters
after the steps within 1e-4 of each one's largest magnitude (the largest
error measured was 1.5e-5, on a parameter after two Adam steps); a sum
taken twice or missed would be off by a factor.
"""

import dataclasses

import numpy as np
import pytest
import torch

from dream_gnn_tpu_torch.sharding.multihost import spawn
import _torch_port_sharded_worker as W

CASES = ("collectives", "spmm_grouped", "decoder_grads", "full_model",
         "ring_step")
JAX_CASES = ("decoder_grads", "full_model_jax", "ring_nodrop")


def _spawn(tmp_path_factory, n_ranks, cases, inputs=None):
    d = tmp_path_factory.mktemp(f"sharded_step_{n_ranks}")
    if inputs is not None:
        torch.save(inputs, d / "inputs.pt")
    spawn(W.run, n_ranks, "gloo", (str(d), cases), cpu=True, workdir=str(d))
    return [torch.load(d / f"rank{r}.pt", weights_only=False)
            for r in range(n_ranks)]


def _decoder_params():
    """A decoder's weights (H1 = 128, the scale kernels' width) as numpy,
    from a seed."""
    from dream_gnn_tpu_torch.nn.decoder import decoder_init

    dec = decoder_init(torch.Generator().manual_seed(0),
                       in_units=W.DECODER["d"])
    return {k: v.numpy() for k, v in dec.items()}


@pytest.fixture(scope="module", params=[2, 4])
def ranks(request, tmp_path_factory):
    return _spawn(tmp_path_factory, request.param, CASES,
                  {"decoder": _decoder_params()})


def _hold(a, b, rtol, what):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, what
    scale = max(float(np.abs(b).max()), 1e-12)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * scale,
                               err_msg=what)


def _hold_case(res, tag):
    r0 = res[0]
    keys = [k for k in r0 if k.startswith(f"{tag}/S/")]
    assert keys
    for k in keys:
        one = r0[k.replace("/S/", "/1/")]
        name = k.split("/")[-1]
        _hold(r0[k], one, 1e-5 if "loss" in name else 1e-4, k)


def test_ranks_agree(ranks):
    for r in ranks[1:]:
        for k, v in r.items():
            np.testing.assert_array_equal(v, ranks[0][k], err_msg=k)


def test_collectives(ranks):
    """Each collective forward and backward, exactly what it must give."""
    r0 = ranks[0]
    keys = [k for k in r0 if k.startswith("coll/")]
    assert len(keys) == 12 and r0["coll/on_device"]
    for k in keys:
        if k != "coll/on_device":
            assert r0[k] == 0.0, k


def test_sharded_grouped_spmm_matches_one_rank(ranks):
    """The forward is the unsharded SpMM's bit for bit (each row sums its
    slots in the same order); the gradient sums S partial sums."""
    r0 = ranks[0]
    _hold_case(ranks, "spmm_grouped")
    np.testing.assert_array_equal(r0["spmm_grouped/S/out"],
                                  r0["spmm_grouped/unsharded/out"])
    _hold(r0["spmm_grouped/S/grad"], r0["spmm_grouped/unsharded/grad"], 1e-5,
          "grad")


def test_decoder_grads_match_one_rank(ranks):
    _hold_case(ranks, "decoder_grads")


def test_full_model_matches_one_rank(ranks):
    _hold_case(ranks, "full_model")
    r0 = ranks[0]
    assert len(r0["full_model/S/step_losses"]) == W.STEPS
    # The steps moved every parameter that has a gradient.
    assert sum(np.abs(r0[k]).sum() for k in r0
               if k.startswith("full_model/S/grad")) > 0


def test_ring_step_matches_one_rank(ranks):
    _hold_case(ranks, "ring_step")


# ---------------------------------------------------------------------------
# The slow tier: the same runs against the JAX package.

@pytest.fixture(scope="module")
def jax_ranks(tmp_path_factory):
    import jax

    from dream_gnn_tpu.model.dream_gnn import init_params as j_init

    cfgs = _jax_cfgs()
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    inputs = {"decoder": _decoder_params(),
              "params_full": np_tree(j_init(jax.random.key(0),
                                            cfgs["full"])),
              "params_ring": np_tree(j_init(jax.random.key(0),
                                            cfgs["ring"]))}
    return inputs, _spawn(tmp_path_factory, 2, JAX_CASES, inputs)[0]


def _jax_cfgs():
    from dream_gnn_tpu.config import TrainConfig
    from dream_gnn_tpu.data.loader import DreamDataset
    from dream_gnn_tpu.data.synthetic import synthetic_raw_data
    from dream_gnn_tpu.train.loop import derive_model_cfg

    ds = DreamDataset(synthetic_raw_data(**W.ENCODER_DATA), k=3)
    base = dataclasses.replace(derive_model_cfg(TrainConfig(), ds),
                               **W.ENCODER_MODEL)
    return {"ds": ds,
            "full": dataclasses.replace(base, layers=2, dropout=0.0,
                                        attention_dropout=0.0,
                                        decoder_backend="pallas"),
            "ring": dataclasses.replace(base, layers=1, dropout=0.0,
                                        attention_dropout=0.0)}


@pytest.fixture
def _interpret():
    import dream_gnn_tpu.kernels.pallas_scale_decoder as psd
    import dream_gnn_tpu.kernels.pallas_seq_scatter as psq
    import dream_gnn_tpu.kernels.pallas_spmm_gather as psg

    old = psd.INTERPRET, psg.INTERPRET, psq.INTERPRET
    psd.INTERPRET = psg.INTERPRET = psq.INTERPRET = True
    yield
    psd.INTERPRET, psg.INTERPRET, psq.INTERPRET = old


@pytest.mark.slow
def test_decoder_grads_match_jax(jax_ranks, _interpret):
    import jax
    import jax.numpy as jnp

    from dream_gnn_tpu.sharding.mesh import make_mesh
    from dream_gnn_tpu.sharding.scale_decoder_spmd import (
        build_scale_decoder_layout_sharded, scale_decoder_spmd)

    inputs, res = jax_ranks
    dec = {k: jnp.asarray(v) for k, v in inputs["decoder"].items()}
    drug_feat, dis_feat, src, dst, labels = W.decoder_problem()
    p = W.DECODER
    mesh = make_mesh(dp=2, mp=1, devices=jax.devices()[:2])
    slay = build_scale_decoder_layout_sharded(src, dst, p["n_drug"],
                                              p["n_dis"], 2, mesh=mesh,
                                              axis="dp")
    lab, w = slay.slot_labels(jnp.asarray(labels))
    d = p["d"]
    args = (jnp.dot(drug_feat, dec["w1"][:d]),
            jnp.dot(dis_feat, dec["w1"][d:]), dec["b1"], dec["w2"], dec["b2"], dec["w3"][:, 0], dec["b3"])

    def loss(*a):
        out = scale_decoder_spmd(mesh, "dp", slay, *a,
                                 jnp.asarray([918273], jnp.int32), rate=0.5,
                                 train=True, dtype=jnp.float32)
        return jnp.sum(w * (out - lab) ** 2)

    value, grads = jax.value_and_grad(loss, argnums=tuple(range(7)))(*args)
    np.testing.assert_allclose(res["decoder_grads/S/loss"], float(value),
                               rtol=1e-5)
    for i, g in enumerate(grads):
        np.testing.assert_allclose(res[f"decoder_grads/S/grad{i}"],
                                   np.asarray(g), rtol=2e-4, atol=2e-4,
                                   err_msg=f"grad {i}")


@pytest.mark.slow
def test_full_model_matches_jax(jax_ranks, _interpret):
    import jax
    import jax.numpy as jnp

    from dream_gnn_tpu.model.dream_gnn import forward
    from dream_gnn_tpu.sharding.mesh import make_mesh
    from dream_gnn_tpu.sharding.scale_decoder_spmd import \
        build_scale_decoder_layout_sharded
    from dream_gnn_tpu.sharding.scale_graph import build_enc_graph_sharded
    from dream_gnn_tpu.train.loop import fold_inputs

    inputs, res = jax_ranks
    cfgs = _jax_cfgs()
    ds, cfg = cfgs["ds"], cfgs["full"]
    params = jax.tree.map(jnp.asarray, inputs["params_full"])
    mesh = make_mesh(dp=2, mp=1, devices=jax.devices()[:2])
    fin, _, labels, _ = fold_inputs(ds, 0)
    s = ds.splits[0]
    graph = build_enc_graph_sharded(s.train_pairs, s.train_values, ds.n_drug,
                                    ds.n_dis, mesh, "dp", pad_multiple=8)
    slay = build_scale_decoder_layout_sharded(
        np.asarray(fin.dec_src), np.asarray(fin.dec_dst), ds.n_drug,
        ds.n_dis, 2, mesh=mesh, axis="dp")
    sl, sw = slay.slot_labels(labels)
    fin = dataclasses.replace(fin, enc_graph=graph, dec_layout=slay)

    def loss(p):
        pred, *_ = forward(p, fin, cfg, train=True, key=jax.random.key(3))
        return jnp.sum(sw * (pred - sl) ** 2)

    value, grads = jax.jit(jax.value_and_grad(loss))(params)
    np.testing.assert_allclose(res["full_jax_loss"], float(value), rtol=1e-4)
    for i, g in enumerate(jax.tree.leaves(grads)):
        np.testing.assert_allclose(res[f"full_jax_grad{i}"], np.asarray(g),
                                   rtol=5e-4, atol=5e-5, err_msg=f"grad {i}")


@pytest.mark.slow
def test_ring_step_matches_jax(jax_ranks, _interpret):
    import jax
    import jax.numpy as jnp

    from dream_gnn_tpu.config import AugmentConfig, TrainConfig
    from dream_gnn_tpu.sharding.mesh import make_mesh
    from dream_gnn_tpu.sharding.scale_graph import \
        build_enc_graph_sharded_grouped
    from dream_gnn_tpu.train.loop import fold_inputs
    from dream_gnn_tpu.train.optim import make_optimizer
    from dream_gnn_tpu.train.step import TrainState, make_one_step

    inputs, res = jax_ranks
    cfgs = _jax_cfgs()
    ds, cfg = cfgs["ds"], cfgs["ring"]
    params = jax.tree.map(jnp.asarray, inputs["params_ring"])
    mesh = make_mesh(dp=2, mp=1, devices=jax.devices()[:2])
    fin, _, labels, _ = fold_inputs(ds, 0)
    s = ds.splits[0]
    ring = build_enc_graph_sharded_grouped(s.train_pairs, s.train_values,
                                           ds.n_drug, ds.n_dis, mesh, "dp",
                                           ring=True)
    tcfg = TrainConfig(augment=AugmentConfig(methods=()))
    tx = make_optimizer(tcfg.train_grad_clip, tcfg.weight_decay)
    state = TrainState(params=params, opt_state=tx.init(params),
                       key=jax.random.key(1), lr=jnp.asarray(tcfg.train_lr))
    _, loss = jax.jit(make_one_step(cfg, tcfg, tx))(
        state, dataclasses.replace(fin, enc_graph=ring), labels,
        ds.fold(0).train_w)
    np.testing.assert_allclose(res["ring_nodrop_loss"][0], float(loss),
                               rtol=1e-4)

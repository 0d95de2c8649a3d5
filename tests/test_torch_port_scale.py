"""The scale path as a whole against the JAX package, at a small size: the
model (slabbed encoder, identity ``CooGraph`` FGCN, scale decoder through
``dec_layout``) with the same JAX-initialised weights, carried across by
``convert.params_from_jax``; the augmentation with injected draws; the
trainer entry point ``dream_gnn_tpu_torch.train.scale``; and the loop's
device repair.

The problem is ``train.scale.build_problem`` at 300 x 300 nodes, 3,000
encoder edges, 400 train and 400 test candidates, 16-wide features; the
model one GCMC layer 48/16, FGCN 24/16 and the 128/64 decoder.  The JAX
Pallas kernels run in interpret mode, the port's wrappers their plain
versions (CPU tensors).

One JAX value-and-grad of the training loss (fp32 decoder, dropout,
attention dropout and augmentation off, so both are deterministic) gives
the logits, the loss and every gradient: with dropout off its training
forward is the eval forward, against which the port's eval forward is held.
The encoder's messages are bf16 in both (the slab SpMM's default).
Tolerances, as tests/test_torch_port_model.py: logits rtol 1e-4 with atol
1e-5 scaled by their magnitude; loss rtol 1e-5; gradients rtol 1e-3, atol
1e-4 scaled (each sums over every candidate and passes back through the
encoder and the attention).  Augmentation with the same draws: masked
weights equal, features within 1e-6.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dream_gnn_tpu.kernels.pallas_scale_decoder as psd
import dream_gnn_tpu.kernels.pallas_seq_scatter as psq
import dream_gnn_tpu.kernels.pallas_spmm_slab as pss
from dream_gnn_tpu.augment.masks import augment_inputs as j_augment
from dream_gnn_tpu.augment.masks import prf_mask_pair as j_prf_mask_pair
from dream_gnn_tpu.config import AugmentConfig as JAug
from dream_gnn_tpu.config import ModelConfig as JModel
from dream_gnn_tpu.graph.coo import coo_from_arrays as j_coo
from dream_gnn_tpu.graph.slabbed import \
    build_enc_graph_slabbed as j_build_slabbed
from dream_gnn_tpu.model.dream_gnn import ModelInputs as JInputs
from dream_gnn_tpu.model.dream_gnn import forward as j_forward
from dream_gnn_tpu.model.dream_gnn import init_params as j_init
from dream_gnn_tpu.train.losses import total_loss as j_total_loss
from dream_gnn_tpu_torch.augment.masks import apply_augment, prf_mask_graph
from dream_gnn_tpu_torch.config import AugmentConfig as TAug
from dream_gnn_tpu_torch.config import ModelConfig as TModel
from dream_gnn_tpu_torch.config import TrainConfig as TTrain
from dream_gnn_tpu_torch.convert import params_from_jax
from dream_gnn_tpu_torch.model.dream_gnn import forward as t_forward
from dream_gnn_tpu_torch.model.dream_gnn import param_leaves
from dream_gnn_tpu_torch.train import scale
from dream_gnn_tpu_torch.train.loop import train_on_inputs
from dream_gnn_tpu_torch.train.losses import total_loss as t_total_loss
from dream_gnn_tpu_torch.train.step import decoder_targets
from tests._torch_port_setup import numpy_tree

N, N_ENC, N_CAND, D = 300, 3000, 400, 16
SMALL = dict(layers=1, gcn_agg_units=48, gcn_out_units=16, src_in_units=D,
             dst_in_units=D, fdim_drug=D, fdim_disease=D, nhid1=24,
             nhid2=16, decoder_backend="pallas", dropout=0.0,
             attention_dropout=0.0, compute_dtype="float32")


@pytest.fixture(autouse=True)
def _interpret():
    old = pss.INTERPRET, psd.INTERPRET, psq.INTERPRET
    pss.INTERPRET = psd.INTERPRET = psq.INTERPRET = True
    yield
    pss.INTERPRET, psd.INTERPRET, psq.INTERPRET = old


@pytest.fixture(scope="module")
def prob():
    return scale.build_problem(np.random.default_rng(5), n_drug=N, n_dis=N,
                               d=D, n_enc=N_ENC, n_cand=N_CAND)


def _jax_inputs(prob):
    """The JAX script's inputs (scripts/train_scale.py:121-152), train
    side, and its slot labels and weights."""
    es, ed, ey = prob["enc"]
    src, dst, y = prob["train"]
    lay = psd.build_scale_decoder_layout(src.astype(np.int32),
                                         dst.astype(np.int32), N, N)
    eye = j_coo(np.arange(N), np.arange(N), np.ones(N, np.float32), N, N)
    fd = jnp.asarray(prob["feat_drug"])
    fv = jnp.asarray(prob["feat_dis"])
    inputs = JInputs(
        enc_graph=j_build_slabbed(np.stack([es, ed]), ey, N, N),
        dec_src=jnp.asarray(src.astype(np.int32)),
        dec_dst=jnp.asarray(dst.astype(np.int32)), drug_graph=eye,
        drug_sim_feat=fd, drug_feat=fd, dis_graph=eye, dis_sim_feat=fv,
        dis_feat=fv, dec_layout=lay)
    return inputs, *lay.slot_labels(jnp.asarray(y))


def test_model_forward_loss_and_grads_match_jax(prob):
    jin, jlab, jw = _jax_inputs(prob)
    jcfg = JModel(**SMALL)
    jparams = j_init(jax.random.key(3), jcfg)
    inv = np.asarray(jin.dec_layout.inv_slot)

    def jloss(p):
        pred, *outs = j_forward(p, jin, jcfg, train=True,
                                key=jax.random.key(0))
        return j_total_loss(pred, jlab, *outs, beta=0.0, weight=jw)[0], pred

    (jl, jpred), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jparams)

    tin, _, tlab, _, tw, _, _ = scale.build_inputs(prob, N, N, "cpu")
    tcfg = TModel(**SMALL)
    tparams = params_from_jax(numpy_tree(jparams), device="cpu")
    with torch.no_grad():
        tpred, *_ = t_forward(tparams, tin, tcfg, train=False)
    tinv = tin.dec_layout.inv_slot.long()
    assert tpred.shape == (N_CAND,)
    _close(tpred[tinv], np.asarray(jpred)[inv], 1e-4, 1e-5, "logits")

    for p in param_leaves(tparams):
        p.requires_grad_(True)
    pred, *outs = t_forward(tparams, tin, tcfg, train=True,
                            generator=torch.Generator().manual_seed(0))
    tl, _ = t_total_loss(pred, tlab, *outs, beta=0.0, weight=tw)
    tl.backward()
    _close(tl, jl, 1e-5, 1e-6, "loss")
    jleaves = param_leaves(params_from_jax(numpy_tree(jg), device="cpu"))
    for i, (t, j) in enumerate(zip(param_leaves(tparams), jleaves)):
        # The FGCN fusion, unused without feature graphs, has no gradient
        # in the port and a zero one in JAX.
        grad = t.grad if t.grad is not None else torch.zeros_like(t)
        _close(grad, j.numpy(), 1e-3, 1e-4, f"grad leaf {i}")


def _close(a, b, rtol, atol, what):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, what
    scale_ = max(1e-3, float(np.abs(b).max()))
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol * scale_,
                               err_msg=what)


def test_augmentation_drops_the_jax_encoder_edges(prob):
    """JAX augment_inputs with a key, against the port's apply_augment fed
    the very draws that key makes (masks.py:221-266 key order): the PRF
    salts, the identity graphs' keep masks and the feature noise."""
    jin, _, _ = _jax_inputs(prob)
    tin, *_ = scale.build_inputs(prob, N, N, "cpu")
    key = jax.random.key(9)
    jout, jm = j_augment(key, jin, JAug())
    keys = jax.random.split(key, 24)
    draws = {"edge_masks": dict(jm, **{k: torch.tensor(np.asarray(
        jm[k]).astype(np.int64)) for k in ("fwd_salts", "rev_salts")})}
    for i, field in enumerate(("drug_graph", "dis_graph")):
        draws[field] = torch.tensor(np.asarray(jax.random.bernoulli(
            keys[1 + i], 0.9, (getattr(jin, field).val.shape[0],))),
            dtype=torch.float32)
    for i, field in enumerate(("drug_feat", "dis_feat", "drug_sim_feat",
                               "dis_sim_feat")):
        draws[field] = torch.tensor(np.asarray(jax.random.normal(
            keys[3 + i], getattr(jin, field).shape)))
    tout, tm = apply_augment(tin, draws, TAug())
    masked = prf_mask_graph(tout.enc_graph, tm)
    for side in ("fwd", "rev"):
        for r in range(2):
            jp = j_prf_mask_pair(getattr(jin.enc_graph, side)[r],
                                 jm[f"{side}_salts"][r], jm["rate"])
            tp = getattr(masked, side)[r]
            for jl, tl in ((jp.fwd, tp.fwd), (jp.bwd, tp.bwd)):
                n = tl.n_live
                want = np.zeros(n, np.float32)
                eid, val = (np.asarray(jl.edge_id).reshape(-1),
                            np.asarray(jl.val).reshape(-1))
                want[eid[eid < n]] = val[eid < n]
                got = np.zeros(n, np.float32)
                got[tl.edge_id.long().numpy()] = tl.val.numpy()
                np.testing.assert_array_equal(got, want)
    for field in ("drug_graph", "dis_graph"):
        np.testing.assert_array_equal(getattr(tout, field).val.numpy(),
                                      np.asarray(getattr(jout, field).val))
    for field in ("drug_feat", "dis_feat", "drug_sim_feat", "dis_sim_feat"):
        np.testing.assert_allclose(getattr(tout, field).numpy(),
                                   np.asarray(getattr(jout, field)),
                                   atol=1e-6, err_msg=field)


def test_loop_runs_on_a_slabbed_graph(prob):
    """train_on_inputs takes its device from the encoder's norms, which
    every layout has; grid targets on a slabbed graph raise."""
    tin, test_in, lab, lab_te, w, w_te, _ = scale.build_inputs(prob, N, N,
                                                               "cpu")
    cfg = TTrain(model=TModel(**SMALL), beta=0.0, train_max_iter=3,
                 train_valid_interval=1, checkpoint_every=0)
    res = train_on_inputs(cfg.model, cfg, tin, test_in, lab, lab_te, w, w_te,
                          torch.Generator().manual_seed(1), verbose=False)
    assert res["best_iter"] >= 1 and np.isfinite(res["best_auroc"])
    with pytest.raises(ValueError, match="dense encoder graph"):
        decoder_targets(torch.zeros(3), tin,
                        dataclasses.replace(cfg.model, decode_mode="grid"))


def test_scale_entry_point_writes_artifacts(tmp_path, capsys):
    rc = scale.main(["--device", "-1", "--n_nodes", "300", "--n_enc", "4000",
                     "--n_cand", "600", "--iters", "5", "--valid_interval",
                     "2", "--save_dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert rc in (0, 1) and ("LEARNING_OK" in out or "LEARNING_WEAK" in out)
    assert "checkpoint_every is not ported" in out
    rows = (tmp_path / "test_metric0.csv").read_text().split()
    assert len(rows) == 1 + 2                       # header + 2 intervals
    assert (tmp_path / "best_metric0.csv").exists()
    summary = json.loads((tmp_path / "summary.json").read_text())
    assert summary["iters"] == 4 and summary["nodes"] == [300, 300]
    for k in ("best_test_auroc", "best_test_aupr", "ms_per_step"):
        assert np.isfinite(summary[k])

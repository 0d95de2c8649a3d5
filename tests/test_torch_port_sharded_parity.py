"""The sharded scale path against the JAX package: the port over S = 2 and
S = 4 gloo ranks on the CPU, the JAX package's sharded functions on the
8-device virtual mesh of tests/conftest.py (``make_mesh(dp=S)``), on the
same inputs (numpy seeds; JAX-initialised weights carried across by
``convert.params_from_jax``).

Each S is one spawn of ranks for the whole module (``sharding.multihost.
spawn`` over a file under ``tmp_path``, so that parallel test workers never
race for a port), which runs every case of tests/_torch_port_sharded_worker.py
and writes each rank's results.  The cases (JAX tests in brackets):
- ``spmm_sharded`` forward and the gradient of sum(out ** 2), with
  ``x_sharded`` True and False (test_edge_partition.py:17-50);
- the ``BipartiteSharded`` encoder's forward, with and without injected
  keep masks, and the gradients of mean(pred ** 2)
  (test_sharded_scale.py:44-80);
- the ``BipartiteShardedGrouped`` forward (:107-140), and with PRF masks
  at fixed salts: the masks, by edge id, bit for bit those of the JAX
  grouped layout at the same salts (the port's sharded edge ids are the
  unsharded layout's, sharding/scale_graph.py), so the forward with them is
  the port's unsharded grouped forward with them (which
  tests/test_torch_port_sparse_model.py holds against JAX);
- the ring's forward at S = 4 (:234-266) and its masks;
- the candidate-sharded decoder's forward, ``slot_labels`` and
  ``global_slot`` (test_scale_decoder_spmd.py:50-73), and the empty last
  shard (:113).
Every rank's replicated results must be the same bits.

Tolerances.  The f32 SpMM: rtol 1e-5, atol 1e-5, JAX's own (the same sums in
another order).  Model outputs: rtol 1e-4 with atol 1e-5 scaled by the
output's magnitude, gradients rtol 1e-3, atol 1e-4 scaled, as
tests/test_torch_port_sparse_model.py holds the unsharded layouts (the same
arithmetic, f32 sums in another order, bf16-rounded messages in the grouped
layouts at the same points).  The decoder: JAX's rtol 1e-4, atol 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dream_gnn_tpu.kernels.pallas_spmm_gather as psg
from dream_gnn_tpu.augment.masks import prf_keep_mask as j_prf_keep_mask
from dream_gnn_tpu.config import TrainConfig as JTrain
from dream_gnn_tpu.data.loader import DreamDataset as JDataset
from dream_gnn_tpu.data.synthetic import synthetic_raw_data as j_raw
from dream_gnn_tpu.graph.coo import coo_from_dense
from dream_gnn_tpu.graph.grouped import build_enc_graph_grouped
from dream_gnn_tpu.model.dream_gnn import forward as j_forward
from dream_gnn_tpu.model.dream_gnn import init_params as j_init
from dream_gnn_tpu.nn.decoder import decoder_apply, decoder_init
from dream_gnn_tpu.sharding.edge_partition import (put_sharded_coo,
                                                   shard_coo_by_dst,
                                                   spmm_sharded)
from dream_gnn_tpu.sharding.mesh import make_mesh as j_make_mesh
from dream_gnn_tpu.sharding.scale_graph import (
    build_enc_graph_sharded, build_enc_graph_sharded_grouped)
from dream_gnn_tpu.train.loop import derive_model_cfg as j_derive
from dream_gnn_tpu.train.loop import fold_inputs as j_fold_inputs
from dream_gnn_tpu_torch.sharding.multihost import spawn
from dream_gnn_tpu_torch.sharding.scale_decoder_spmd import \
    build_scale_decoder_layout_sharded
import _torch_port_sharded_worker as W

CASES = {2: ("spmm", "encoder_coo", "encoder_grouped", "decoder"),
         4: ("spmm", "ring", "decoder")}
N_OUT = 5   # pred, drug_out, drug_sim_out, dis_out, dis_sim_out


@pytest.fixture(autouse=True)
def _interpret():
    old = psg.INTERPRET
    psg.INTERPRET = True
    yield
    psg.INTERPRET = old


@pytest.fixture(scope="module")
def jax_setup():
    ds = JDataset(j_raw(**W.ENCODER_DATA), k=3)
    cfg = dataclasses.replace(j_derive(JTrain(), ds), **W.ENCODER_MODEL)
    params = j_init(jax.random.key(0), cfg)
    cfg_ring = dataclasses.replace(cfg, layers=1)
    params_ring = j_init(jax.random.key(0), cfg_ring)
    dec = decoder_init(jax.random.key(0), in_units=W.DECODER["d"])
    return dict(ds=ds, cfg=cfg, params=params, cfg_ring=cfg_ring,
                params_ring=params_ring, decoder=dec)


def _spawn(tmp_path_factory, jax_setup, n_ranks):
    d = tmp_path_factory.mktemp(f"sharded_parity_{n_ranks}")
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    torch.save({k: np_tree(jax_setup[k])
                for k in ("params", "params_ring", "decoder")},
               d / "inputs.pt")
    spawn(W.run, n_ranks, "gloo", (str(d), CASES[n_ranks]), cpu=True,
          workdir=str(d))
    return [torch.load(d / f"rank{r}.pt", weights_only=False)
            for r in range(n_ranks)]


@pytest.fixture(scope="module")
def ranks2(tmp_path_factory, jax_setup):
    return _spawn(tmp_path_factory, jax_setup, 2)


@pytest.fixture(scope="module")
def ranks4(tmp_path_factory, jax_setup):
    return _spawn(tmp_path_factory, jax_setup, 4)


@pytest.fixture(params=[2, 4])
def ranks(request):
    return request.param, request.getfixturevalue(f"ranks{request.param}")


def _close(a, b, rtol, atol, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, what
    scale = max(1e-3, float(np.abs(b).max()))
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol * scale,
                               err_msg=what)


def test_ranks_agree(ranks):
    """Every result is replicated: every rank holds the same bits."""
    _, res = ranks
    for r in res[1:]:
        assert r.keys() == res[0].keys()
        for k, v in res[0].items():
            np.testing.assert_array_equal(r[k], v, err_msg=k)


@pytest.mark.parametrize("x_sharded", [False, True])
def test_spmm_sharded_matches_jax(ranks, x_sharded):
    s, res = ranks
    mesh = j_make_mesh(dp=s, mp=1, devices=jax.devices()[:s])
    mode = "halo" if x_sharded else "rep"
    for k, shape in enumerate(W.SPMM_SHAPES):
        a, x = W.spmm_case(shape, k)
        sg = put_sharded_coo(mesh, "dp", shard_coo_by_dst(coo_from_dense(a),
                                                          s))

        def f(x):
            return spmm_sharded(mesh, "dp", sg, x, x_sharded=x_sharded)

        want = np.asarray(jax.jit(f)(jnp.asarray(x)))[:shape[0]]
        grad = jax.jit(jax.grad(lambda x: jnp.sum(f(x) ** 2)))(
            jnp.asarray(x))
        np.testing.assert_allclose(res[0][f"spmm{k}_{mode}"], want,
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(res[0][f"spmm{k}_{mode}_grad"],
                                   np.asarray(grad), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(want, a @ x, rtol=1e-5, atol=1e-5)


def _j_inputs(jax_setup, graph):
    inputs, _, _, _ = j_fold_inputs(jax_setup["ds"], 0)
    return dataclasses.replace(inputs, enc_graph=graph)


def _split(jax_setup):
    return jax_setup["ds"].splits[0]


def test_sharded_encoder_matches_jax(ranks2, jax_setup):
    """BipartiteSharded at S = 2: the forward without and with injected keep
    masks, and the gradients of mean(pred ** 2)."""
    res = ranks2[0]
    ds, cfg, params = jax_setup["ds"], jax_setup["cfg"], jax_setup["params"]
    mesh = j_make_mesh(dp=2, mp=1, devices=jax.devices()[:2])
    s = _split(jax_setup)
    graph = build_enc_graph_sharded(s.train_pairs, s.train_values, ds.n_drug,
                                    ds.n_dis, mesh, "dp", pad_multiple=8)
    e_shard = [(graph.fwd[r].src.shape[1], graph.rev[r].src.shape[1])
               for r in range(graph.num_ratings)]
    np.testing.assert_array_equal(res["e_shard"], e_shard)
    masks = W.coo_masks([((2, ef), (2, er)) for ef, er in e_shard])
    edge_masks = {"fwd": tuple(jnp.asarray(m[0]) for m in masks),
                  "rev": tuple(jnp.asarray(m[1]) for m in masks)}
    inputs = _j_inputs(jax_setup, graph)
    fwd = jax.jit(lambda p, em: j_forward(p, inputs, cfg, train=False,
                                          edge_masks=em))
    for tag, em in (("plain", None), ("masked", edge_masks)):
        want = fwd(params, em)
        for i, w in enumerate(want):
            _close(res[f"coo_{tag}_{i}"], w, 1e-4, 1e-5, f"{tag} out {i}")

    def loss(p):
        pred, *_ = j_forward(p, inputs, cfg, train=False)
        return jnp.mean(pred ** 2)

    grads = jax.tree.leaves(jax.jit(jax.grad(loss))(params))
    for i, g in enumerate(grads):
        _close(res[f"coo_grad_{i}"], g, 1e-3, 1e-4, f"grad {i}")


def _j_salts():
    salts = np.asarray(W.PRF_SALTS, np.uint32)
    return {"fwd_salts": jnp.asarray(salts[:, 0]),
            "rev_salts": jnp.asarray(salts[:, 1]), "rate": W.PRF_RATE,
            "kind": "grouped_prf"}


def _hold_keep_masks(res, tag, jax_setup):
    """Each relation's keep mask by edge id, bit for bit the JAX grouped
    layout's at the same salts."""
    ds, s = jax_setup["ds"], _split(jax_setup)
    grouped = build_enc_graph_grouped(s.train_pairs, s.train_values,
                                      ds.n_drug, ds.n_dis)
    salts = _j_salts()
    for side in ("fwd", "rev"):
        for r, pair in enumerate(getattr(grouped, side)):
            lay = pair.fwd
            val = np.asarray(lay.val).reshape(-1)
            eid = np.asarray(lay.edge_id).reshape(-1)
            keep = np.asarray(j_prf_keep_mask(
                salts[f"{side}_salts"][r], jnp.asarray(eid), W.PRF_RATE))
            live = val != 0
            want = np.zeros(int(live.sum()), np.float32)
            want[eid[live]] = keep[live]
            np.testing.assert_array_equal(res[f"{tag}_keep_{side}{r}"], want,
                                          err_msg=f"{side}[{r}]")
            assert 0 < want.sum() < want.size
    return grouped


def _hold_prf_forward(res, tag):
    """With the PRF masks, the sharded forward equals the unsharded grouped
    layout's with the same masks (the same messages; f32 sums in another
    order)."""
    for i in range(N_OUT):
        _close(res[f"{tag}_prf_{i}"], res[f"{tag}_prf_unsharded_{i}"], 1e-5,
               1e-6, f"prf out {i}")
    # The masks reach pred and the GCMC outputs (not the FGCN route's).
    for i in (0, 1, 3):
        assert not np.array_equal(res[f"{tag}_prf_{i}"],
                                  res[f"{tag}_plain_{i}"])


def test_sharded_grouped_matches_jax(ranks2, jax_setup):
    """BipartiteShardedGrouped at S = 2: the forward against the JAX
    sharded-grouped layout's; with PRF masks, the masks against the JAX
    grouped layout's at the same salts."""
    res = ranks2[0]
    ds, cfg, params = jax_setup["ds"], jax_setup["cfg"], jax_setup["params"]
    mesh = j_make_mesh(dp=2, mp=1, devices=jax.devices()[:2])
    s = _split(jax_setup)
    shg = build_enc_graph_sharded_grouped(s.train_pairs, s.train_values,
                                          ds.n_drug, ds.n_dis, mesh, "dp")
    want = jax.jit(lambda p, i: j_forward(p, i, cfg, train=False))(
        params, _j_inputs(jax_setup, shg))
    for i, w in enumerate(want):
        _close(res[f"grouped_plain_{i}"], w, 1e-4, 1e-5, f"out {i}")
    _hold_keep_masks(res, "grouped", jax_setup)
    _hold_prf_forward(res, "grouped")


def test_ring_matches_jax(ranks4, jax_setup):
    """The ring at S = 4, one GCMC layer (the JAX ring tests' model): the
    forward against the JAX ring's on a 4-device mesh, the PRF masks
    against the JAX grouped layout's, the masked forward against the
    unsharded one."""
    res = ranks4[0]
    ds = jax_setup["ds"]
    mesh = j_make_mesh(dp=4, mp=1, devices=jax.devices()[:4])
    s = _split(jax_setup)
    ring = build_enc_graph_sharded_grouped(s.train_pairs, s.train_values,
                                           ds.n_drug, ds.n_dis, mesh, "dp",
                                           ring=True)
    cfg = jax_setup["cfg_ring"]
    want = jax.jit(lambda p, i: j_forward(p, i, cfg, train=False))(
        jax_setup["params_ring"], _j_inputs(jax_setup, ring))
    for i, w in enumerate(want):
        _close(res[f"ring_plain_{i}"], w, 1e-4, 1e-5, f"out {i}")
    _hold_keep_masks(res, "ring", jax_setup)
    _hold_prf_forward(res, "ring")


def test_sharded_decoder_matches_jax(ranks, jax_setup):
    """The candidate-sharded decoder's eval logits, unscrambled by
    ``global_slot``, against the JAX plain decoder; ``slot_labels`` cover
    every candidate once, padding slots weigh 0."""
    s, res = ranks
    r0 = res[0]
    drug_feat, dis_feat, src, dst, labels = W.decoder_problem()
    want = decoder_apply(jax_setup["decoder"], jnp.asarray(src),
                         jnp.asarray(dst), jnp.asarray(drug_feat),
                         jnp.asarray(dis_feat), dropout_rate=0.0, train=False)
    np.testing.assert_allclose(r0["dec_logits"], np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    # global_slot: candidate -> row of the (S * n_pos) vector of every
    # rank's logits in rank order; gather is that unscramble.
    n_pos = int(r0["dec_n_pos"])
    assert r0["dec_flat"].shape == (s * n_pos,)
    np.testing.assert_array_equal(r0["dec_flat"][r0["dec_global_slot"]],
                                  r0["dec_logits"])
    assert len(np.unique(r0["dec_global_slot"])) == W.DECODER["e"]
    assert float(r0["dec_w_sum"]) == W.DECODER["e"]
    assert float(r0["dec_lab_sum"]) == pytest.approx(float(labels.sum()))
    chunk = -(-W.DECODER["e"] // s)
    assert r0["dec_live"].tolist() == [chunk] * (s - 1) + [
        W.DECODER["e"] - (s - 1) * chunk]


def test_empty_last_shard_rejected():
    """e=5 over 4 shards ceil-chunks to 2,2,1,0: JAX's error, in its words,
    before any process group is asked for."""
    with pytest.raises(ValueError, match="last shard empty"):
        build_scale_decoder_layout_sharded(np.arange(5), np.arange(5), 10, 10,
                                           n_shards=4)

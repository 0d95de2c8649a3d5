"""The fold-parallel step on a dp x mp mesh
(dream_gnn_tpu_torch/sharding/partition.py) over 2 x 2 gloo ranks on the
CPU, against the JAX package and against one rank.

The ranks are spawned once for the module, through a file under
``tmp_path`` (tests/_torch_port_mesh_worker.py); rank 0 also runs each
comparison's one-rank version over its (1, 1) mesh in the same spawn.  The
JAX tests it ports (tests/test_sharding.py, tests/test_wide_config.py of
the JAX package):

- ``test_multichip_step_runs`` (:41): dp folds, two steps, finite (dp,)
  losses that change on the second step;
- ``test_sharded_matches_single_device`` (:57): one step of folds 0 and 1
  from JAX's weights, dropout 0 and no augmentation, against JAX's
  single-device loss of each fold (rtol 1e-4, JAX's), with the plain
  decoder and with the fused one (rows 7 and 8 on each rank's edge block);
- ``test_multichip_interval_matches_unsharded`` (:114): four steps and both
  evaluations of four folds, against the unsharded run, here one rank's
  (the same draws: rtol 5e-4, atol 5e-4, JAX's);
- ``test_wide_config_multichip_fold_parallel`` (test_wide_config.py:26).

Four ranks against one, with dropout 0.3 and all six augment methods, in
grid mode (bf16) and edges mode (fp32): every draw of the first step (the
augmentation, the encoder's dropout, the decoder seeds) bit for bit the
one-rank draw's block of folds; the first step's losses within rtol 1e-5
(measured: at most 8.3e-8); its gradients and the parameters after three
steps within 1e-5 of each leaf's largest (measured: 8.7e-7 and 4.0e-7 of
it; the mp blocks' decoder gradients are summed as partial sums, in
another order); every leaf the same bits on the ranks of an mp group, its
first-step gradient too (the fused decoders' step broadcasts nothing over
mp).  The
one-rank side, rank 0's (1, 1) mesh, is itself held bit for bit against
the stacked step without a mesh (train/stacked.py), which runs no code of
the mesh: its draws, losses, gradients and parameters after three steps.

The slow tier runs the step over an (8, 1) mesh, and the ring encoder
composed with the 2-D grid decoder (JAX tests/test_ring_mp_compose.py:64)
against JAX's dense reference, JAX's tolerances.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dream_gnn_tpu.config import ModelConfig as JModel
from dream_gnn_tpu.config import TrainConfig as JTrain
from dream_gnn_tpu.data.loader import DreamDataset as JDataset
from dream_gnn_tpu.data.synthetic import synthetic_raw_data as j_raw
from dream_gnn_tpu.model.dream_gnn import forward as j_forward
from dream_gnn_tpu.model.dream_gnn import init_params as j_init
from dream_gnn_tpu.train.loop import derive_model_cfg as j_derive
from dream_gnn_tpu.train.loop import fold_inputs as j_fold_inputs
from dream_gnn_tpu.train.losses import total_loss as j_total_loss
from dream_gnn_tpu_torch.sharding.multihost import spawn
import _torch_port_mesh_worker as W

DP, MP = 2, 2
CASES = ("global_mesh", "step_runs", "single_device", "interval", "wide",
         "mesh_vs_one")


def _jax_setup(**model_kw):
    ds = JDataset(j_raw(**W.DATA), k=3, pad_folds=False)
    cfg = JTrain(model=JModel(**W.MODEL))
    return ds, cfg, dataclasses.replace(j_derive(cfg, ds),
                                        **dict(W.MODEL, **model_kw))


def _spawn(tmp_path_factory, tag, n_ranks, dp, mp, cases, inputs):
    d = tmp_path_factory.mktemp(tag)
    torch.save(inputs, d / "inputs.pt")
    spawn(W.run, n_ranks, "gloo", (str(d), cases, dp, mp), cpu=True,
          workdir=str(d))
    return [torch.load(d / f"rank{r}.pt", weights_only=False)
            for r in range(n_ranks)]


@pytest.fixture(scope="module")
def single_device():
    """JAX's weights of folds 0 and 1 (the multichip step's init: one key
    per fold from the second half of key(0)'s split) and JAX's
    single-device loss of each fold at them, dropout 0, no augmentation."""
    ds, cfg, mcfg = _jax_setup(dropout=0.0, attention_dropout=0.0)
    p_keys, _ = jax.random.split(jax.random.key(0))
    params = jax.vmap(lambda k: j_init(k, mcfg))(jax.random.split(p_keys, 2))

    @jax.jit
    def loss(p, inputs, labels):
        pred, *routes = j_forward(p, inputs, mcfg, train=False)
        return j_total_loss(pred, labels, *routes, beta=cfg.beta,
                            smoothing=cfg.label_smoothing)[0]

    losses = []
    for i in range(2):
        tr_in, _, tr_lab, _ = j_fold_inputs(ds, i)
        losses.append(float(loss(jax.tree.map(lambda x: x[i], params), tr_in,
                                 tr_lab)))
    return jax.tree.map(np.asarray, params), np.asarray(losses)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, single_device):
    return _spawn(tmp_path_factory, "mesh_step", DP * MP, DP, MP, CASES,
                  {"params": single_device[0]})


def test_multihost_helpers(ranks):
    """``global_mesh(mp=2)`` over the 4 ranks is the 2 x 2 mesh, rank r at
    (r // 2, r % 2); ``local_shard_slice(10)`` gives rank r rows 3r to
    min(3r + 3, 10) (JAX tests/test_sharding.py:95)."""
    for r, res in enumerate(ranks):
        assert res["global_mesh"].tolist() == [2, 2, r // 2, r % 2, 3 * r,
                                               min(3 * r + 3, 10)]


def test_multichip_step_runs(ranks):
    losses = ranks[0]["runs_losses"]
    assert losses.shape == (2, DP)
    assert np.isfinite(losses).all()
    # A second step must change the loss (params actually update).
    assert not np.array_equal(losses[0], losses[1])


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_sharded_matches_single_device(ranks, single_device, backend):
    np.testing.assert_allclose(ranks[0][f"single_{backend}"],
                               single_device[1], rtol=1e-4, atol=1e-5)


def test_multichip_interval_matches_unsharded(ranks):
    r0 = ranks[0]
    got, want = r0["interval/S/metrics"], r0["interval/1/metrics"]
    assert got.shape == (len(W.FOLDS), 5) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=5e-4)


def test_wide_config_multichip_fold_parallel(ranks):
    losses = ranks[0]["wide_losses"]
    assert losses.shape == (len(W.FOLDS),)
    assert np.isfinite(losses).all()


def test_ranks_of_an_mp_group_agree(ranks):
    """The two ranks of each mp group hold the same folds: every result
    but their coordinates the same bits, the first step's gradients and
    the parameters after the steps included (the fused decoders' step
    makes them agree by computing them alike, with no broadcast)."""
    for lo in range(0, DP * MP, MP):
        for r in ranks[lo + 1:lo + MP]:
            for k, v in r.items():
                if k != "global_mesh":
                    np.testing.assert_array_equal(v, ranks[lo][k],
                                                  err_msg=k)


def _fold_block(rank: int, size: int) -> slice:
    lo = (rank // MP) * size
    return slice(lo, lo + size)


@pytest.mark.parametrize("mode", ["grid", "edges"])
def test_mesh_draws_one_rank_masks(ranks, mode):
    """Every draw of the first step is the one-rank draw's block of folds,
    bit for bit."""
    one = ranks[0]
    n = int(one[f"vs_{mode}/1/n_draws"])
    assert n > 30
    for r, res in enumerate(ranks):
        tag = f"vs_{mode}/S/"
        size = res[tag + "loss0"].shape[0]
        lo = _fold_block(r, size).start
        assert int(res[tag + "n_draws"]) == n
        for i in range(n):
            dim = int(res[f"{tag}fold_dim{i}"])
            want = np.take(one[f"vs_{mode}/1/draw{i}"],
                           range(lo, lo + size), axis=dim)
            np.testing.assert_array_equal(res[f"{tag}draw{i}"], want,
                                          err_msg=f"rank {r} draw {i}")


@pytest.mark.parametrize("mode", ["grid", "edges"])
def test_one_rank_mesh_is_the_stacked_step(ranks, mode):
    """Rank 0's (1, 1) mesh against the stacked step without a mesh
    (``make_one_step_stacked(mesh=None)``) on the same stack and generator
    state: every draw, the first step's losses and gradients, the losses of
    three steps and the parameters after them, bit for bit."""
    one, plain = f"vs_{mode}/1/", f"vs_{mode}/0/"
    r0 = ranks[0]
    keys = {k[len(plain):] for k in r0 if k.startswith(plain)}
    assert keys == {k[len(one):] for k in r0 if k.startswith(one)} \
        - {"mp_spread"}
    assert any(k.startswith("grad/") for k in keys)
    for k in sorted(keys):
        np.testing.assert_array_equal(r0[one + k], r0[plain + k], err_msg=k)


def _hold(a, b, rtol, what):
    scale = max(float(np.abs(b).max()), 1e-12)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * scale,
                               err_msg=what)


@pytest.mark.parametrize("mode", ["grid", "edges"])
def test_mesh_matches_one_rank(ranks, mode):
    one = ranks[0]
    for r, res in enumerate(ranks):
        tag = f"vs_{mode}/S/"
        sl = _fold_block(r, res[tag + "loss0"].shape[0])
        _hold(res[tag + "loss0"], one[f"vs_{mode}/1/loss0"][sl], 1e-5,
              "loss0")
        _hold(res[tag + "step_losses"], one[f"vs_{mode}/1/step_losses"],
              1e-5, "step_losses")
        keys = [k for k in res if k.startswith(tag + "grad/")
                or k.startswith(tag + "param/")]
        assert len(keys) == 2 * len(res[tag + "mp_spread"])
        for k in keys:
            _hold(res[k], one[k.replace("/S/", "/1/")][sl], 1e-5, k)
        assert (res[tag + "mp_spread"] == 0).all()


# ---------------------------------------------------------------------------
# The slow tier.

@pytest.mark.slow
def test_multichip_step_runs_8x1(tmp_path_factory):
    res = _spawn(tmp_path_factory, "mesh_step_8", 8, 8, 1, ("step_runs",),
                 {})
    losses = res[0]["runs_losses"]
    assert losses.shape == (2, 8) and np.isfinite(losses).all()
    assert not np.array_equal(losses[0], losses[1])


@pytest.mark.slow
def test_bench_scaling_cpu_mesh():
    """``bench_scaling --cpu-mesh --small``: 8 gloo ranks, the SpMM over 1,
    2, 4 and 8 shards, each with finite, positive rates."""
    from dream_gnn_tpu_torch.scripts import bench_scaling

    rows = bench_scaling.main(["--cpu-mesh", "--small"])
    assert [r[0] for r in rows] == [1, 2, 4, 8]
    assert rows[0][3] == 100.0
    assert all(np.isfinite(r[1:]).all() and r[2] > 0 for r in rows)


@pytest.mark.slow
def test_ring_encoder_with_mp_grid_decoder(tmp_path_factory):
    """The ring encoder over dp (2 ranks) composed with the 2-D grid
    decoder over (dp, mp) against JAX's single-device dense path: loss
    rtol 1e-5, gradients rtol 2e-4 and atol 1e-6 (JAX's)."""
    from dream_gnn_tpu.model.dream_gnn import _encode
    from dream_gnn_tpu.nn.decoder import decoder_apply_grid
    from dream_gnn_tpu.train.losses import bce_with_logits

    raw = j_raw(**W.DATA)
    ds = JDataset(raw, k=3)
    cfg = JTrain(model=JModel(**W.MODEL, dropout=0.0, attention_dropout=0.0,
                              decode_mode="grid"))
    mcfg = j_derive(cfg, ds)
    params = j_init(jax.random.key(0), mcfg)
    inputs, *_ = j_fold_inputs(ds, 0)
    enc = inputs.enc_graph
    key = jax.random.key(7)

    def reference_loss(p):
        drug_f, dis_f, *_ = _encode(
            p, inputs, mcfg, train=True,
            keys=jax.random.split(key, mcfg.layers + 4), edge_masks=None)
        pred = decoder_apply_grid(p["decoder"], drug_f, dis_f,
                                  dropout_rate=0.0, train=False,
                                  dtype=jnp.float32)
        return bce_with_logits(pred.reshape(-1), enc.a1.reshape(-1),
                               weight=enc.mask.reshape(-1))

    loss, grads = jax.value_and_grad(jax.jit(reference_loss))(params)
    res = _spawn(tmp_path_factory, "ring_compose", DP * MP, DP, MP,
                 ("ring_compose",),
                 {"params_ring": jax.tree.map(np.asarray, params)})
    from dream_gnn_tpu_torch.model.dream_gnn import named_leaves
    flat = dict(named_leaves(jax.tree.map(np.asarray, grads)))
    for r in res:
        np.testing.assert_allclose(r["ring_loss"], float(loss), rtol=1e-5)
        for k, g in flat.items():
            np.testing.assert_allclose(r[f"ring_grad/{k}"], g, rtol=2e-4,
                                       atol=1e-6, err_msg=k)

"""The port's ``--save_model`` checkpoint against the JAX package's.

``save_params`` writes the leaf layout of the JAX ``save_pytree``
(``leaf_{i}`` in ``jax.tree.flatten`` order) and ``load_params`` reads it,
and also a file that the JAX ``save_pytree`` wrote, skipping its pickled
``treedef``.  A JAX-initialised checkpoint loaded into the port gives the
JAX eval forward: fp32, plain decoders on both sides, rtol 1e-5 with atol
1e-5 scaled by each output's magnitude (the same weights; the sums run in
another order).  The loaded tensors equal those ``params_from_jax`` carries
across, bit for bit.
"""

import jax
import numpy as np
import pytest
import torch

from dream_gnn_tpu.model.dream_gnn import forward as j_forward
from dream_gnn_tpu.model.dream_gnn import init_params as j_init
from dream_gnn_tpu.train.checkpoint import save_pytree
from dream_gnn_tpu.train.loop import fold_inputs as j_fold_inputs
from dream_gnn_tpu_torch.convert import params_from_jax
from dream_gnn_tpu_torch.model.dream_gnn import forward as t_forward
from dream_gnn_tpu_torch.model.dream_gnn import init_params as t_init
from dream_gnn_tpu_torch.model.dream_gnn import param_leaves
from dream_gnn_tpu_torch.train.loop import fold_inputs as t_fold_inputs
from dream_gnn_tpu_torch.train.checkpoint import load_params, save_params
from tests._torch_port_setup import datasets, model_cfgs, numpy_tree

OUT_NAMES = ("pred", "drug_out", "drug_sim_out", "dis_out", "dis_sim_out")


@pytest.fixture(scope="module")
def setup():
    jds, tds = datasets()
    jcfg, tcfg = model_cfgs(jds, tds, compute_dtype="float32",
                            decoder_backend="xla")
    return jds, tds, jcfg, tcfg


def _template(tcfg, seed=0):
    return t_init(torch.Generator().manual_seed(seed), tcfg)


def test_jax_checkpoint_loads_into_the_port(setup, tmp_path):
    jds, tds, jcfg, tcfg = setup
    jparams = j_init(jax.random.key(11), jcfg)
    path = str(tmp_path / "best_model_fold1.npz")
    save_pytree(path, jparams)
    tparams = load_params(path, _template(tcfg))
    carried = params_from_jax(numpy_tree(jparams), device="cpu")
    for t, c in zip(param_leaves(tparams), param_leaves(carried)):
        assert t.dtype == torch.float32 and torch.equal(t, c)
    for i in (0, 1):
        jout = j_forward(jparams, j_fold_inputs(jds, 3)[i], jcfg, train=False)
        with torch.no_grad():
            tout = t_forward(tparams, t_fold_inputs(tds, 3)[i], tcfg,
                             train=False)
        for name, a, b in zip(OUT_NAMES, tout, jout):
            b = np.asarray(b)
            scale = max(1e-3, float(np.abs(b).max()))
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-5,
                                       atol=1e-5 * scale, err_msg=name)


def test_port_checkpoint_round_trips(setup, tmp_path):
    _, _, _, tcfg = setup
    params = _template(tcfg, seed=1)
    path = str(tmp_path / "params.npz")
    save_params(path, params)
    loaded = load_params(path, _template(tcfg, seed=2))
    assert jax.tree.structure(loaded) == jax.tree.structure(params)
    for a, b in zip(param_leaves(loaded), param_leaves(params)):
        assert torch.equal(a, b)
    # The file's leaves are the tree's in jax.tree.flatten order.
    with np.load(path) as f:
        for i, leaf in enumerate(jax.tree.leaves(params)):
            np.testing.assert_array_equal(f[f"leaf_{i}"], leaf.numpy())


@pytest.mark.parametrize("change", ["width", "layers"])
def test_load_params_rejects_another_tree(setup, tmp_path, change):
    """A checkpoint of other widths or depth is refused, not reshaped."""
    import dataclasses

    _, _, _, tcfg = setup
    path = str(tmp_path / "params.npz")
    save_params(path, _template(tcfg))
    other = (dataclasses.replace(tcfg, gcn_out_units=8) if change == "width"
             else dataclasses.replace(tcfg, layers=3))
    with pytest.raises(ValueError, match="load_params"):
        load_params(path, _template(other))

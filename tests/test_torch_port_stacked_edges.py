"""The port's fold-parallel protocol in edges decode mode: each fold of the
stack scores its own padded candidate edge list, and its loss and metrics
weigh the edges by ``StackedFolds.edge_weight`` on ``StackedFolds.labels``.
Held against JAX ``forward_stacked`` and ``make_one_step_stacked`` (the
batched Pallas edge kernel in interpret mode, or the vmapped plain
decoder) and against the port's own sequential edges run.

F = 3 folds with widths and node counts other than 3
(tests/_torch_port_setup.py).  Tolerances, as
tests/test_torch_port_stacked.py: forward in fp32 rtol 1e-4, atol 1e-5
scaled; bf16 rtol 2e-2, atol 1e-3 scaled; steps (fp32, randomness off)
losses rtol 1e-5, params 99.9% within 2e-5 and all within
2 * max(lr) * steps; protocol CSV columns within 2e-4.
"""

import pytest
import torch

import dream_gnn_tpu.kernels.pallas_decoder as pdm
from dream_gnn_tpu.model.dream_gnn import forward_stacked as j_forward_stacked
from dream_gnn_tpu.sharding.foldstack import stack_folds as j_stack_folds
from dream_gnn_tpu_torch.convert import params_from_jax
from dream_gnn_tpu_torch.model.dream_gnn import forward, forward_stacked
from dream_gnn_tpu_torch.sharding.foldstack import stack_folds, tree_map
from dream_gnn_tpu_torch.train.loop import fold_inputs
from tests._torch_port_setup import datasets, model_cfgs, numpy_tree
from tests.test_torch_port_stacked import (FOLDS, OUT_NAMES, TOL, _cfg,
                                           _check_protocol_matches_sequential,
                                           _check_stacked_steps, _close,
                                           _j_stacked_params)


@pytest.fixture(autouse=True)
def _interpret():
    old = pdm.INTERPRET
    pdm.INTERPRET = True
    yield
    pdm.INTERPRET = old


@pytest.fixture(scope="module")
def data():
    return datasets()


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_forward_stacked_edges_matches_jax(data, backend, dtype):
    """Eval-mode edges forward of a 3-fold stack against JAX forward_stacked,
    and fold f against the port's single-fold forward."""
    jds, tds = data
    jcfg, tcfg = model_cfgs(jds, tds, compute_dtype=dtype,
                            decode_mode="edges", decoder_backend=backend)
    jparams = _j_stacked_params(jcfg)
    jout = j_forward_stacked(jparams, j_stack_folds(jds, FOLDS).inputs, jcfg,
                             train=False)
    tparams = params_from_jax(numpy_tree(jparams), device="cpu")
    tin = stack_folds(tds, FOLDS).inputs
    with torch.no_grad():
        tout = forward_stacked(tparams, tin, tcfg, train=False)
    assert tout[0].shape == tin.dec_src.shape
    rtol, atol = TOL[dtype]
    for name, a, b in zip(OUT_NAMES, tout, jout):
        _close(a, b, rtol, atol, name)
    with torch.no_grad():
        for f, cv in enumerate(FOLDS):
            one = forward(tree_map(lambda t, f=f: t[f], tparams),
                          fold_inputs(tds, cv)[0], tcfg, train=False)
            for name, a, b in zip(OUT_NAMES, tout, one):
                _close(a[f], b, 1e-5, 1e-6, f"fold {f} {name}")


@pytest.mark.parametrize("n_steps,backend", [(1, "pallas"), (5, "pallas"),
                                             (5, "xla")])
def test_stacked_edges_steps_match_jax(data, n_steps, backend):
    """n stacked edges steps against JAX make_one_step_stacked: per-fold
    learning rates, fold 1 alone over the clip at the first step, each
    fold's loss weighted by its edge weights."""
    _check_stacked_steps(data, n_steps, decode_mode="edges",
                         decoder_backend=backend)


def test_stacked_edges_protocol_matches_sequential(data, tmp_path):
    """With randomness off, each fold of the stacked edges protocol is the
    sequential edges run of that fold: CSV columns and best metrics within
    2e-4, and the same files."""
    _check_protocol_matches_sequential(data, tmp_path, _cfg(dict(
        decode_mode="edges", decoder_backend="pallas")))

"""The plain reference against itself in float64 at test sizes, and the
metrics against a direct count."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from gnnbench.inputs import params as P
from gnnbench.inputs.planted import planted_problem
from gnnbench.inputs.synthetic import raw_arrays
from gnnbench.reference import common, dense, sparse

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
CPU = torch.device("cpu")


def _cfg(name):
    with open(os.path.join(DATA, f"{name}.json")) as f:
        return json.load(f)


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast(v, dtype) for v in tree]
    if torch.is_tensor(tree) and tree.is_floating_point():
        return tree.detach().to(dtype).clone()
    return tree


def _grads(loss_fn, params, dtype):
    P64 = _cast(params, dtype)
    leaves = [t.requires_grad_(True) for _, t in P.leaves(P64)]
    loss = loss_fn(P64)
    loss.sum().backward()
    return loss.detach(), [t.grad for t in leaves]


@pytest.mark.parametrize("mode", ["grid", "edges"])
def test_dense_step_in_float32_is_float64_to_rounding(mode):
    cfg = _cfg("tiny-gdataset")
    raw = raw_arrays(cfg["n_drug"], cfg["n_dis"], cfg["n_pos"],
                     cfg["embed_dim"], cfg["latent_dim"], seed=11)
    data = dense.Data(raw, cfg, n_seeds=1, device=CPU)
    spec = P.param_spec(cfg, data.nd, data.nv, cfg["embed_dim"])
    params = P.make_params(spec, data.n_models, 5, CPU)
    gen = torch.Generator().manual_seed(7)
    w = common.draw(gen, dense.draw_order(cfg, data.nd, data.nv,
                                         data.n_models), CPU)
    side = data.side("train", 0, data.n_models)
    out = {}
    for dt in (torch.float32, torch.float64):
        d, ww = _cast(side, dt), _cast(w, dt)
        out[dt] = _grads(lambda p: dense.loss(p, d, cfg, mode, ww,
                                              torch.float32), params, dt)
    (l32, g32), (l64, g64) = out[torch.float32], out[torch.float64]
    assert torch.allclose(l32.double(), l64, rtol=1e-5)
    for a, b in zip(g32, g64):
        scale = b.abs().max().item() or 1.0
        assert (a.double() - b).abs().max().item() <= 1e-4 * scale


def test_sparse_step_in_float32_is_float64_to_rounding():
    cfg = _cfg("tiny-scale")
    prob = planted_problem(cfg["n_drug"], cfg["n_dis"], cfg["rank"],
                           cfg["d"], cfg["n_enc"], cfg["n_cand"],
                           cfg["pos_rate"], seed=3, device=CPU)
    pb = sparse.Problem(prob, cfg["n_drug"], cfg["n_dis"], cfg)
    spec = P.param_spec(cfg, cfg["d"], cfg["d"], cfg["d"])
    params = P.make_params(spec, 1, 5, CPU)
    one = P.one_model(params)
    gen = torch.Generator().manual_seed(7)
    w = common.draw(gen, sparse.draw_order(cfg, cfg["n_drug"], cfg["n_dis"],
                                           cfg["d"], 512), CPU)
    out = {}
    for dt in (torch.float32, torch.float64):
        pb.feat_d, pb.feat_v = (prob["feat_drug"].to(dt),
                                prob["feat_dis"].to(dt))
        pb.ci_d, pb.ci_v = pb.ci_d.to(dt), pb.ci_v.to(dt)
        ww = _cast(w, dt)

        def loss(p):
            logits, labels, _ = sparse.forward(p, pb, "train", cfg, ww,
                                               torch.float32)
            return common.bce_with_logits(logits, labels.to(dt),
                                          torch.ones_like(logits))
        out[dt] = _grads(loss, {k: v for k, v in one.items()}, dt)
    (l32, g32), (l64, g64) = out[torch.float32], out[torch.float64]
    assert torch.allclose(l32.double(), l64, rtol=1e-5)
    for a, b in zip(g32, g64):
        if b is None:
            assert a is None
            continue
        scale = b.abs().max().item() or 1.0
        assert (a.double() - b).abs().max().item() <= 1e-4 * scale


def _direct_auroc(y, s):
    pos, neg = s[y == 1], s[y == 0]
    wins = (pos[:, None] > neg[None, :]).sum() \
        + 0.5 * (pos[:, None] == neg[None, :]).sum()
    return wins / (len(pos) * len(neg))


def test_metrics_against_a_direct_count():
    rng = np.random.default_rng(0)
    y = (rng.random(300) < 0.2).astype(np.float64)
    s = np.round(rng.normal(size=300) + y, 1)      # ties on purpose
    assert common.auroc(y, s) == pytest.approx(_direct_auroc(y, s))
    # AUPR on a case small enough to write out: ranks 1..4 are
    # (pos, neg, pos, neg): precision 1, 1/2, 2/3 at recall 1/2, 1/2, 1.
    y4 = np.array([1.0, 0.0, 1.0, 0.0])
    s4 = np.array([4.0, 3.0, 2.0, 1.0])
    want = 0.5 * (1 + 1) / 2 + 0.0 + 0.5 * (0.5 + 2 / 3) / 2
    assert common.aupr(y4, s4) == pytest.approx(want)


def test_cell_mask_keeps_the_rate_and_is_a_function_of_its_cell():
    seed = torch.tensor([[[12345]]])
    i = torch.arange(40).view(1, 40, 1)
    j = torch.arange(30).view(1, 1, 30)
    m = common.cell_mask(seed, 1, i, j, 64, 0.3)
    assert m.shape == (1, 40, 30, 64)
    assert abs((m > 0).float().mean().item() - 0.7) < 0.01
    again = common.cell_mask(seed, 1, i[:, 5:6], j[:, :, 7:8], 64, 0.3)
    assert torch.equal(again[0, 0, 0], m[0, 5, 7])

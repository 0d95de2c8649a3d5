"""Port data pipeline against the JAX package: synthetic presets, KFold
splits (without sklearn), encoder graphs, kNN graphs, features and
padded edge lists must be exactly equal."""

import jax  # noqa: F401
import numpy as np
import pytest
import torch
from sklearn.model_selection import KFold

from dream_gnn_tpu.data.loader import DreamDataset as JDataset
from dream_gnn_tpu.data.synthetic import synthetic_raw_data as j_raw
from dream_gnn_tpu_torch.data.loader import DreamDataset as TDataset
from dream_gnn_tpu_torch.data.splits import kfold_indices
from dream_gnn_tpu_torch.data.synthetic import synthetic_raw_data as t_raw
from dream_gnn_tpu_torch.graph.bipartite import build_enc_graph

PRESETS = ["Gdataset", "Cdataset", "lrssl"]


@pytest.fixture(scope="module", params=PRESETS)
def pair(request):
    j = JDataset(j_raw(request.param, seed=0), k=4)
    t = TDataset(t_raw(request.param, seed=0), k=4, device="cpu")
    return j, t


def _eq(a, b, what):
    a = np.asarray(a)
    b = b.cpu().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, what
    assert a.dtype == b.dtype, what
    np.testing.assert_array_equal(a, b, err_msg=what)


@pytest.mark.parametrize("n", [10, 1933, 2000, 183696])
def test_kfold_matches_sklearn(n):
    ours = list(kfold_indices(n, 10, 1024))
    ref = list(KFold(n_splits=10, shuffle=True, random_state=1024)
               .split(np.arange(n)))
    assert len(ours) == len(ref) == 10
    for (tr, te), (rtr, rte) in zip(ours, ref):
        np.testing.assert_array_equal(tr, rtr)
        np.testing.assert_array_equal(te, rte)


def test_raw_data_equal(pair):
    j, t = pair
    for field in ("association", "drug_sim", "dis_sim", "drug_embed",
                  "dis_embed"):
        _eq(getattr(j.raw, field), getattr(t.raw, field), field)


def test_splits_equal(pair):
    j, t = pair
    assert sorted(j.splits) == sorted(t.splits)
    for cv in j.splits:
        for field in ("train_pairs", "train_values", "test_pairs",
                      "test_values"):
            _eq(getattr(j.splits[cv], field), getattr(t.splits[cv], field),
                f"fold {cv} {field}")


def test_features_and_knn_graphs_equal(pair):
    j, t = pair
    for field in ("drug_feat", "dis_feat", "drug_sim_feat", "dis_sim_feat"):
        _eq(getattr(j, field), getattr(t, field), field)
    for field in ("drug_graph", "dis_graph", "drug_feature_graph",
                  "dis_feature_graph"):
        _eq(getattr(j, field).a, getattr(t, field).a, field)


@pytest.mark.parametrize("cv", [0, 9])
def test_fold_graphs_and_edge_lists_equal(pair, cv):
    j, t = pair
    jf, tf = j.fold(cv), t.fold(cv)
    for enc in ("train_enc", "test_enc"):
        for field in ("a1", "mask", "ci_drug", "cj_drug", "ci_dis",
                      "cj_dis"):
            _eq(getattr(getattr(jf, enc), field),
                getattr(getattr(tf, enc), field), f"{enc}.{field}")
    for field in ("train_src", "train_dst", "train_labels", "train_w",
                  "test_src", "test_dst", "test_labels", "test_w"):
        _eq(getattr(jf, field), getattr(tf, field), field)


def test_asymmetric_norms_equal(pair):
    from dream_gnn_tpu.graph.bipartite import build_enc_graph as j_build
    j, t = pair
    s = j.splits[3]
    jg = j_build(s.train_pairs, s.train_values, j.n_drug, j.n_dis, False)
    tg = build_enc_graph(s.train_pairs, s.train_values, t.n_drug, t.n_dis,
                         False, device="cpu")
    for field in ("a1", "mask", "ci_drug", "cj_drug", "ci_dis", "cj_dis"):
        _eq(getattr(jg, field), getattr(tg, field), field)


def test_random_embedding_mode_equal():
    raw_j, raw_t = j_raw(n_drug=20, n_dis=12, n_pos=30, seed=9), \
        t_raw(n_drug=20, n_dis=12, n_pos=30, seed=9)
    j = JDataset(raw_j, k=3, embedding_mode="random")
    t = TDataset(raw_t, k=3, embedding_mode="random", device="cpu")
    _eq(j.drug_feat, t.drug_feat, "drug_feat")
    _eq(j.drug_feature_graph.a, t.drug_feature_graph.a, "feature graph")


def test_mat_path_not_ported(tmp_path):
    """The port loads a ``.mat`` path, which it refused until its loader
    was ported (the name is the test's history): the same dataset as the
    JAX loader from the same file."""
    from dream_gnn_tpu.data.matio import save_mat

    path = str(tmp_path / "x.mat")
    save_mat(path, j_raw(n_drug=20, n_dis=12, n_pos=30, seed=9))
    j, t = JDataset.load(path, k=3), TDataset.load(path, k=3, device="cpu")
    _eq(j.raw.association, torch.as_tensor(t.raw.association), "didr")
    _eq(j.drug_feat, t.drug_feat, "drug features")
    _eq(j.dis_graph.a, t.dis_graph.a, "disease graph")
    _eq(j.drug_feature_graph.a, t.drug_feature_graph.a, "feature graph")


def test_cuda_request_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TDataset(t_raw(n_drug=20, n_dis=12, n_pos=30, seed=9), k=3)

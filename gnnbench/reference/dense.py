"""Plain reference of the DREAM-GNN training step on the dense encoder
graph of a reference-scale dataset, for a stack of independent models.

Everything the program derives from the raw arrays is worked out again
here: the L2-normalised embeddings, the kNN similarity and feature graphs,
the CV folds, each fold's encoder graph with its GCMC norms, and the
candidate lists.  Plain PyTorch in float32 (the caller turns TF32 off) and
NumPy; the decoder's products take bf16-rounded operands where the
configuration says so.

Model (DREAM-GNN ``model.py``, ``layers.py``):
- GCMC: per layer and rating r, ``A_r^T (X_drug W_r * drop(cj))`` into the
  diseases and ``A_r (X_dis W_r * drop(cj))`` into the drugs, times ``ci``,
  LeakyReLU(0.1), dropout, a shared Linear; ``W_r = att_r . basis``; the
  layer outputs accumulate as ``h1 + h2/2 + h3/3``;
- FGCN: a two-layer GCN per entity on the kNN similarity graph and on the
  kNN feature graph with shared weights, fused by ReLU(Linear) + dropout;
- one attention (Linear, tanh, Linear, softmax over the two routes,
  dropout on the weights) for drugs and diseases;
- the MLP decoder 2d -> 128 -> 64 -> 1 on every grid cell or candidate
  edge, its first Linear split over the concatenation;
- BCE over the fold's cells or edges plus beta times the routes' common
  loss; per-model clip to norm 1, then L2 decay and Adam.

The random draws.  The step's randomness comes from one generator seeded
by the harness; the reference makes the same calls on a generator with the
same seed, in the order the port documents (augment/masks.py
``draw_augment``, then the forward's dropout masks layer by layer, then one
decoder seed a model), each call for the whole stack.  The decoder's masks
are the stateless hash of ``common.cell_mask``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from gnnbench.reference import common
from gnnbench.reference.common import dropout, rnd

GRAPHS = ("drug_graph", "dis_graph", "drug_feature_graph",
          "dis_feature_graph")
FEATURES = ("drug_feat", "dis_feat", "drug_sim_feat", "dis_sim_feat")


# ---------------------------------------------------------------------------
# Data: everything the loader derives, worked out again.

def _l2(x: np.ndarray) -> np.ndarray:
    n = np.linalg.norm(x, axis=1, keepdims=True)
    n[n == 0] = 1.0
    return (x / n).astype(np.float32)


def knn_graph(sim: np.ndarray, k: int, symm: bool) -> np.ndarray:
    """Row-normalised (A + A^T + I) of the top-k neighbours of each row."""
    sim = np.asarray(sim, np.float64)
    n = sim.shape[0]
    k = min(k, n - 1)
    nb = np.argsort(-sim, axis=1, kind="stable")[:, :k]
    adj = np.zeros((n, n), np.float32)
    adj[np.repeat(np.arange(n), k), nb.reshape(-1)] = 1.0
    if symm:
        adj = adj + adj.T
    adj = adj + np.eye(n, dtype=np.float32)
    rows = adj.sum(axis=1)
    inv = np.where(rows != 0, 1.0 / np.where(rows != 0, rows, 1.0), 0.0)
    return (adj * inv.astype(np.float32)[:, None]).astype(np.float32)


def feature_graph(x: np.ndarray, k: int, symm: bool) -> np.ndarray:
    x = np.asarray(x, np.float64)
    n = np.linalg.norm(x, axis=1, keepdims=True)
    n[n == 0] = 1e-10
    x = x / n
    return knn_graph(x @ x.T, k, symm)


def kfold(n: int, n_splits: int, seed: int):
    """Test indices of each fold of a shuffled KFold (scikit-learn's)."""
    idx = np.arange(n)
    np.random.RandomState(seed).shuffle(idx)
    sizes = np.full(n_splits, n // n_splits)
    sizes[: n % n_splits] += 1
    bounds = np.r_[0, np.cumsum(sizes)]
    return [np.sort(idx[bounds[f]:bounds[f + 1]]) for f in range(n_splits)]


def inv_sqrt(deg: np.ndarray) -> np.ndarray:
    deg = deg.astype(np.float32)
    out = np.zeros_like(deg)
    out[deg > 0] = 1.0 / np.sqrt(deg[deg > 0])
    return out[:, None]


def fold_sides(assoc: np.ndarray, n_folds: int, seed: int):
    """Per fold, the (pairs (2, E), labels) of its train and test sides:
    positives then negatives, each split by KFold on its own."""
    pos = np.stack(np.nonzero(assoc))
    neg = np.stack(np.nonzero(1 - assoc))
    te_p, te_n = kfold(pos.shape[1], n_folds, seed), kfold(neg.shape[1],
                                                          n_folds, seed)
    out = []
    for f in range(n_folds):
        side = {}
        for name, keep in (("test", True), ("train", False)):
            mp = np.zeros(pos.shape[1], bool)
            mp[te_p[f]] = True
            mn = np.zeros(neg.shape[1], bool)
            mn[te_n[f]] = True
            if not keep:
                mp, mn = ~mp, ~mn
            pairs = np.concatenate([pos[:, mp], neg[:, mn]], axis=1)
            labels = np.r_[np.ones(mp.sum()), np.zeros(mn.sum())]
            side[name] = (pairs, labels.astype(np.float32))
        out.append(side)
    return out


def enc_graph(pairs: np.ndarray, labels: np.ndarray, nd: int, nv: int,
              symm: bool) -> dict:
    a1 = np.zeros((nd, nv), np.float32)
    mask = np.zeros((nd, nv), np.float32)
    mask[pairs[0], pairs[1]] = 1.0
    pos = labels > 0.5
    a1[pairs[0][pos], pairs[1][pos]] = 1.0
    ci_d, ci_v = inv_sqrt(mask.sum(1)), inv_sqrt(mask.sum(0))
    cj_d = ci_d if symm else np.ones_like(ci_d)
    cj_v = ci_v if symm else np.ones_like(ci_v)
    return dict(a1=a1, mask=mask, ci_d=ci_d, cj_d=cj_d, ci_v=ci_v, cj_v=cj_v)


class Data:
    """The raw arrays' derived tensors for a stack of ``n_seeds`` x
    ``n_folds`` models (model m trains on fold m % n_folds), on
    ``device``; ``side(name, lo, hi)`` gives the block [lo, hi) of models."""

    def __init__(self, raw: dict, cfg: dict, n_seeds: int, device):
        nd, nv = raw["association"].shape
        k, symm = cfg["num_neighbor"], cfg["gcn_agg_norm_symm"]
        self.nd, self.nv, self.device = nd, nv, device
        self.n_folds = cfg["n_folds"]
        self.n_models = n_seeds * self.n_folds
        t = lambda x: torch.as_tensor(np.asarray(x), device=device)  # noqa
        self.shared = dict(
            drug_feat=t(_l2(raw["drug_embed"])),
            dis_feat=t(_l2(raw["dis_embed"])),
            drug_sim_feat=t(np.asarray(raw["drug_sim"], np.float32)),
            dis_sim_feat=t(np.asarray(raw["dis_sim"], np.float32)),
            drug_graph=t(knn_graph(raw["drug_sim"], k, symm)),
            dis_graph=t(knn_graph(raw["dis_sim"], k, symm)),
            drug_feature_graph=t(feature_graph(raw["drug_embed"], k, symm)),
            dis_feature_graph=t(feature_graph(raw["dis_embed"], k, symm)))
        folds = fold_sides(raw["association"], self.n_folds, cfg["kfold_seed"])
        self.sides = {}
        for name in ("train", "test"):
            graphs = [enc_graph(*f[name], nd, nv, symm) for f in folds]
            enc = {key: t(np.stack([g[key] for g in graphs]))
                   for key in graphs[0]}
            e_max = max(f[name][0].shape[1] for f in folds)
            src = np.zeros((self.n_folds, e_max), np.int64)
            dst = np.zeros_like(src)
            lab = np.zeros((self.n_folds, e_max), np.float32)
            w = np.zeros_like(lab)
            for i, f in enumerate(folds):
                pairs, labels = f[name]
                e = pairs.shape[1]
                src[i, :e], dst[i, :e] = pairs
                lab[i, :e], w[i, :e] = labels, 1.0
            enc.update(src=t(src), dst=t(dst), labels=t(lab), weight=t(w))
            self.sides[name] = enc

    def side(self, name: str, lo: int, hi: int) -> dict:
        """Tensors of models [lo, hi) with a leading model axis."""
        folds = torch.arange(lo, hi, device=self.device) % self.n_folds
        out = {k: v[folds] for k, v in self.sides[name].items()}
        for k, v in self.shared.items():
            out[k] = v.expand(hi - lo, *v.shape)
        return out


# ---------------------------------------------------------------------------
# The step's random draws.

def draw_order(cfg: dict, nd: int, nv: int, n: int):
    """[(name, kind, shape)] of one training step's draws for ``n`` models,
    in the order they are made."""
    e = cfg["embed_dim"]
    aug = cfg["aug"]
    seq = []
    for method in aug["methods"]:
        if method == "edge_dropout":
            shape = (n, cfg["num_ratings"], nd, nv)
            seq += [("enc_fwd", "rand", shape), ("enc_rev", "rand", shape)]
            seq += [(f"drop_{g}", "rand", (n, m, m))
                    for g, m in zip(GRAPHS, (nd, nv, nd, nv))]
        elif method == "feature_noise":
            seq += [(f"noise_{f}", "randn", (n, m, w)) for f, m, w in zip(
                FEATURES, (nd, nv, nd, nv), (e, e, nd, nv))]
        else:
            raise NotImplementedError(f"augment method {method!r}")
    if cfg["dropout"] > 0:
        for i in range(cfg["layers"]):
            msg = cfg["gcn_agg_units"] // 3 if i == 0 else cfg["gcn_out_units"]
            for r in range(cfg["num_ratings"]):
                seq += [(f"cj_d{i}{r}", "rand", (n, nd, 1)),
                        (f"cj_v{i}{r}", "rand", (n, nv, 1))]
            seq += [(f"h_d{i}", "rand", (n, nd, msg)),
                    (f"h_v{i}", "rand", (n, nv, msg))]
        h1, h2 = cfg["nhid1"], cfg["nhid2"]
        seq += [("f_drug_sim", "rand", (n, nd, h1)),
                ("f_dis_sim", "rand", (n, nv, h1)),
                ("f_drug_feat", "rand", (n, nd, h1)),
                ("f_dis_feat", "rand", (n, nv, h1)),
                ("f_fuse_d", "rand", (n, nd, h2)),
                ("f_fuse_v", "rand", (n, nv, h2))]
    if cfg["attention_dropout"] > 0:
        seq += [("att_d", "rand", (n, nd, 2, 1)),
                ("att_v", "rand", (n, nv, 2, 1))]
    if cfg["dropout"] > 0:
        seq += [("dec_seed", "seed", (n,))]
    return seq


# ---------------------------------------------------------------------------
# The model.

def _leaky(x):
    return F.leaky_relu(x, negative_slope=0.1)


def _augment(d: dict, w: dict, cfg: dict) -> dict:
    """The step's augmented inputs of a block; ``w`` holds its draws."""
    d = dict(d)
    aug = cfg["aug"]
    keep = 1.0 - aug["edge_dropout_rate"]
    for method in aug["methods"]:
        if method == "edge_dropout":
            d["enc_fwd"] = (w["enc_fwd"] < keep).float()
            d["enc_rev"] = (w["enc_rev"] < keep).float()
            for g in GRAPHS:
                d[g] = d[g] * (w[f"drop_{g}"] < keep).float()
        elif method == "feature_noise":
            for f in FEATURES:
                scale = aug["feature_noise_scale"] if f in ("drug_feat",
                    "dis_feat") else aug["sim_noise_scale"]
                d[f] = d[f] + scale * w[f"noise_{f}"]
    return d


def _gcmc(p: dict, d: dict, xd, xv, i: int, cfg: dict, w):
    b, r_n = p["att"].shape[0], cfg["num_ratings"]
    basis = p["basis"]
    wr = torch.matmul(p["att"], basis.reshape(b, basis.shape[1], -1)) \
        .reshape(b, r_n, basis.shape[2], basis.shape[3])
    rate = cfg["dropout"]
    msg_dis = msg_drug = 0.0
    for r in range(r_n):
        cj_d, cj_v = d["cj_d"], d["cj_v"]
        if w is not None and rate > 0:
            cj_d = dropout(cj_d, w[f"cj_d{i}{r}"], rate)
            cj_v = dropout(cj_v, w[f"cj_v{i}{r}"], rate)
        a = d["a1"] if r == 1 else d["mask"] - d["a1"]
        a_f = a * d["enc_fwd"][:, r] if "enc_fwd" in d else a
        a_r = a * d["enc_rev"][:, r] if "enc_rev" in d else a
        msg_dis = msg_dis + a_f.mT @ ((xd @ wr[:, r]) * cj_d)
        msg_drug = msg_drug + a_r @ ((xv @ wr[:, r]) * cj_v)
    hd = _leaky(msg_drug * d["ci_d"])
    hv = _leaky(msg_dis * d["ci_v"])
    if w is not None and rate > 0:
        hd = dropout(hd, w[f"h_d{i}"], rate)
        hv = dropout(hv, w[f"h_v{i}"], rate)
    return (hd @ p["fc_w"] + p["fc_b"][:, None],
            hv @ p["fc_w"] + p["fc_b"][:, None])


def _gcn(p, x, adj, u, rate):
    h = torch.relu(adj @ (x @ p["w1"]) + p["b1"][:, None])
    if u is not None:
        h = dropout(h, u, rate)
    return adj @ (h @ p["w2"]) + p["b2"][:, None]


def _attention(p, z, u, rate):
    n = z.shape[1]
    h = torch.tanh(z.flatten(1, 2) @ p["w1"] + p["b1"][:, None])
    beta = torch.softmax((h @ p["w2"]).unflatten(1, (n, 2)), dim=-2)
    if u is not None:
        beta = dropout(beta, u, rate)
    return torch.sum(beta * z, dim=-2)


def encode(P: dict, d: dict, cfg: dict, w):
    """(drug_feats, dis_feats, drug_out, drug_sim_out, dis_out,
    dis_sim_out) of a block; ``w`` None for an eval forward."""
    xd, xv = d["drug_feat"], d["dis_feat"]
    drug_out = dis_out = None
    for i, p in enumerate(P["tgcn"]):
        od, ov = _gcmc(p, d, xd, xv, i, cfg, w)
        drug_out = od if i == 0 else drug_out + od / float(i + 1)
        dis_out = ov if i == 0 else dis_out + ov / float(i + 1)
        xd, xv = od, ov
    rate = cfg["dropout"]
    u = (lambda k: w[k] if w is not None and rate > 0 else None)  # noqa
    f = P["fgcn"]
    e1s = _gcn(f["drug_gcn"], d["drug_sim_feat"], d["drug_graph"],
               u("f_drug_sim"), rate)
    e2s = _gcn(f["dis_gcn"], d["dis_sim_feat"], d["dis_graph"],
               u("f_dis_sim"), rate)
    e1f = _gcn(f["drug_gcn"], d["drug_sim_feat"], d["drug_feature_graph"],
               u("f_drug_feat"), rate)
    e2f = _gcn(f["dis_gcn"], d["dis_sim_feat"], d["dis_feature_graph"],
               u("f_dis_feat"), rate)
    sim_d = torch.relu(torch.cat([e1s, e1f], -1) @ f["drug_fusion_w"]
                       + f["drug_fusion_b"][:, None])
    sim_v = torch.relu(torch.cat([e2s, e2f], -1) @ f["dis_fusion_w"]
                       + f["dis_fusion_b"][:, None])
    if u("f_fuse_d") is not None:
        sim_d = dropout(sim_d, u("f_fuse_d"), rate)
        sim_v = dropout(sim_v, u("f_fuse_v"), rate)
    ar = cfg["attention_dropout"]
    ua = (lambda k: w[k] if w is not None and ar > 0 else None)  # noqa
    fd = _attention(P["attention"], torch.stack([drug_out, sim_d], -2),
                    ua("att_d"), ar)
    fv = _attention(P["attention"], torch.stack([dis_out, sim_v], -2),
                    ua("att_v"), ar)
    return fd, fv, drug_out, sim_d, dis_out, sim_v


def _tables(P, fd, fv, dtype):
    w1 = P["decoder"]["w1"]
    d = fd.shape[-1]
    return (rnd(fd, dtype) @ rnd(w1[:, :d], dtype),
            rnd(fv, dtype) @ rnd(w1[:, d:], dtype))


def _mlp(P, a1, m1, m2, dtype):
    """The decoder's layers after a1 (b, ..., h1); masks None in eval."""
    p = P["decoder"]
    lead = a1.shape[1:-1]
    flat = lambda x: None if x is None else x.flatten(1, -2)  # noqa: E731
    out = common.DecoderMLP.apply(flat(a1), flat(m1), flat(m2), p["w2"],
                                  p["b2"], p["w3"][..., 0], dtype)
    return out.unflatten(1, lead)


def decode_grid(P, fd, fv, seeds, cfg, dtype):
    """(b, nd, nv) logits of every cell."""
    pd, pv = _tables(P, fd, fv, dtype)
    p = P["decoder"]
    a1 = (pd[:, :, None, :] + pv[:, None, :, :]) + p["b1"][:, None, None, :]
    m1 = m2 = None
    if seeds is not None:
        nd, nv = pd.shape[1], pv.shape[1]
        dev = pd.device
        i = torch.arange(nd, device=dev).view(1, nd, 1)
        j = torch.arange(nv, device=dev).view(1, 1, nv)
        s = seeds.view(-1, 1, 1)
        rate = cfg["dropout"]
        m1 = common.cell_mask(s, 1, i, j, a1.shape[-1], rate)
        m2 = common.cell_mask(s, 2, i, j, p["w2"].shape[-1], rate)
    return _mlp(P, a1, m1, m2, dtype) + p["b3"][:, :, None]


def decode_edges(P, fd, fv, src, dst, seeds, cfg, dtype):
    """(b, E) logits of the candidate edges (src, dst)."""
    pd, pv = _tables(P, fd, fv, dtype)
    p = P["decoder"]
    # The kernel rounds the tables before its gathers and sums rnd(da1)
    # into their gradients.
    pd = common.RoundValue.apply(pd, dtype)
    pv = common.RoundValue.apply(pv, dtype)
    rows = torch.take_along_dim(pd, src[..., None], dim=1) \
        + torch.take_along_dim(pv, dst[..., None], dim=1)
    a1 = common.RoundGrad.apply(rows, dtype) + p["b1"][:, None, :]
    m1 = m2 = None
    if seeds is not None:
        s = seeds.view(-1, 1)
        rate = cfg["dropout"]
        m1 = common.cell_mask(s, 1, src, dst, a1.shape[-1], rate)
        m2 = common.cell_mask(s, 2, src, dst, p["w2"].shape[-1], rate)
    return _mlp(P, a1, m1, m2, dtype) + p["b3"]


def forward(P, d, cfg, mode: str, w, dtype):
    """(logits, labels, weight, encoder outputs) of a block, flat per
    model."""
    if w is not None:
        d = _augment(d, w, cfg)
    fd, fv, *routes = encode(P, d, cfg, w)
    seeds = w["dec_seed"] if w is not None and cfg["dropout"] > 0 else None
    if mode == "grid":
        pred = decode_grid(P, fd, fv, seeds, cfg, dtype).flatten(1)
        return pred, d["a1"].flatten(1), d["mask"].flatten(1), routes
    pred = decode_edges(P, fd, fv, d["src"], d["dst"], seeds, cfg, dtype)
    return pred, d["labels"], d["weight"], routes


def loss(P, d, cfg, mode, w, dtype):
    pred, labels, weight, (drug_out, sim_d, dis_out, sim_v) = forward(
        P, d, cfg, mode, w, dtype)
    out = common.bce_with_logits(pred, labels, weight)
    if cfg["beta"]:
        out = out + cfg["beta"] * (common.common_loss(drug_out, sim_d)
                                   + common.common_loss(dis_out, sim_v))
    return out


# ---------------------------------------------------------------------------
# Three training steps and an evaluation, as the harness compares them.

def _block(tree, lo: int, hi: int):
    """Models [lo, hi) of a tree, as leaves that take gradients."""
    if isinstance(tree, dict):
        return {k: _block(v, lo, hi) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_block(v, lo, hi) for v in tree]
    return tree[lo:hi].detach().requires_grad_(True)


def _norms(tensors) -> torch.Tensor:
    """(L, n) norms of each model's slice of each (n, ...) leaf."""
    return torch.stack([torch.linalg.vector_norm(t.flatten(1), dim=1)
                        for t in tensors]).cpu()


def evaluate(P, data: Data, cfg: dict, mode: str, n: int, block: int,
             dtype) -> np.ndarray:
    """(n, 2 sides, 2) AUROC and AUPR of each model after an eval forward
    on the train side and on the test side (its own encoder graph)."""
    out = np.zeros((n, 2, 2))
    with torch.no_grad():
        for s, side in enumerate(("train", "test")):
            for lo in range(0, n, block):
                hi = min(n, lo + block)
                Pb = _block(P, lo, hi)
                pred, labels, weight, _ = forward(
                    Pb, data.side(side, lo, hi), cfg, mode, None, dtype)
                for m, (p, y, v) in enumerate(zip(pred.cpu().numpy(),
                                                  labels.cpu().numpy(),
                                                  weight.cpu().numpy())):
                    keep = v > 0
                    out[lo + m, s] = (common.auroc(y[keep], p[keep]),
                                      common.aupr(y[keep], p[keep]))
    return out


def run(raw: dict, cfg: dict, traffic: dict, spec, param_seed: int,
        draw_seed: int, device, *, steps: int = 3,
        dec_dtype=torch.bfloat16) -> dict:
    """The reference's readings over ``steps`` training steps of the
    stack from its initial weights: each step's (n,) losses, the (L, n)
    norms of the raw first gradient and of the first gradient as Adam takes
    it, the (L, n) norms of each leaf's change, and the evaluation."""
    from gnnbench.inputs.params import leaves, make_params

    mode = traffic["decode_mode"]
    n = traffic["n_seeds"] * cfg["n_folds"]
    block = traffic["reference_block"]
    data = Data(raw, cfg, traffic["n_seeds"], device)
    P = make_params(spec, n, param_seed, device)
    tensors = [t for _, t in leaves(P)]
    start = [t.clone() for t in tensors]
    opt = common.Adam(tensors, cfg["train_lr"], cfg["weight_decay"])
    gen = torch.Generator(device=device).manual_seed(draw_seed)
    order = draw_order(cfg, data.nd, data.nv, n)
    out = {"loss": []}
    for step in range(steps):
        w = common.draw(gen, order, device)
        grads = [torch.zeros_like(t) for t in tensors]
        losses = torch.zeros(n, dtype=torch.float64)
        for lo in range(0, n, block):
            hi = min(n, lo + block)
            Pb = _block(P, lo, hi)
            lb = loss(Pb, data.side("train", lo, hi), cfg, mode,
                      {k: v[lo:hi] for k, v in w.items()}, dec_dtype)
            lb.sum().backward()
            for g, (_, t) in zip(grads, leaves(Pb)):
                g[lo:hi] = t.grad
            losses[lo:hi] = lb.detach().cpu().double()
        del w
        out["loss"].append(losses)
        if step == 0:
            out["grad_raw"] = _norms(grads)
        if cfg["train_grad_clip"] > 0:
            common.clip_per_model_(grads, cfg["train_grad_clip"])
        seen = opt.step(grads)
        if step == 0:
            out["grad"] = _norms(seen)
    out["loss"] = torch.stack(out["loss"]).numpy()
    out["draws"] = gen.get_state().numpy()
    out["change"] = _norms([t - s for t, s in zip(tensors, start)])
    out["eval"] = evaluate(P, data, cfg, mode, n, block, dec_dtype)
    return out

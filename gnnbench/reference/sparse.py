"""Plain reference of the DREAM-GNN training step on the scale path: the
sparse relation-typed encoder graph, the FGCN on identity graphs and the
per-candidate decoder, for one model.

Worked out again from the raw problem (drug, disease and rating of every
encoder edge; the candidate lists; the features): each relation's edges,
the GCMC norms (1/sqrt of a node's degree over all relations), the edge
ids of the PRF edge dropout (an edge's index among its relation's edges,
in input order), and the candidates' order.  Plain PyTorch in float32
(the caller turns TF32 off); the configuration's bf16 points are:
- the encoder's aggregations take bf16 messages rnd(x) and sum them in
  float32, forward and backward (the JAX layer's default SpMM dtype);
- the decoder rounds its node tables before the gathers and its products'
  operands, and its backward takes the port's documented rounding points
  (kernels/scale_decoder.py): the weight gradients and the drugs' table
  gradient come from a1 as stored in bf16, the diseases' from a1
  recomputed in float32, each row of da1 rounded before its sum.

The draws follow the port's documented order, as in ``dense.py``: the PRF
salts (one int64 call), the identity graphs' keep masks and the feature
noise, then the forward's dropout masks and the decoder's seed.
"""

from __future__ import annotations

import numpy as np
import torch

from gnnbench.reference import common
from gnnbench.reference.common import dropout, rnd
from gnnbench.reference.dense import _leaky, _norms

FEATURES = ("drug_feat", "dis_feat", "drug_sim_feat", "dis_sim_feat")

# The identity similarity graphs' edge lists are padded to a multiple of
# this, and their keep draws are made at the padded length: the default
# ``pad_multiple`` of the port's graph/coo.py (``build_coo``).  A change of
# that padding moves the draws that follow, which ``judge.draws_apart``
# reports.
IDENTITY_PAD = 512


def prf_keep(edge_id: torch.Tensor, salt: int, rate: float) -> torch.Tensor:
    """Keep mask of the PRF edge dropout: u = fmix32(id ^ salt) / 2**32,
    keep iff u >= rate."""
    x = common.fmix32((edge_id & common.M32) ^ (int(salt) & common.M32))
    u = x.to(torch.float32) * (1.0 / 4294967296.0)
    return (u >= torch.tensor(rate, dtype=torch.float32,
                              device=u.device)).float()


class Aggregate(torch.autograd.Function):
    """out[dst] += rnd(x[src]) * w; the backward sums rnd(g[dst]) * w into
    the sources (bf16 messages, float32 sums)."""

    @staticmethod
    def forward(ctx, x, src, dst, w, n_dst, dtype):
        ctx.save_for_backward(src, dst, w)
        ctx.n_src, ctx.dtype = x.shape[0], dtype
        msg = rnd(rnd(x, dtype)[src] * w[:, None], dtype)
        out = x.new_zeros((n_dst, x.shape[1]))
        return out.index_add_(0, dst, msg)

    @staticmethod
    def backward(ctx, g):
        src, dst, w = ctx.saved_tensors
        msg = rnd(rnd(g, ctx.dtype)[dst] * w[:, None], ctx.dtype)
        dx = g.new_zeros((ctx.n_src, g.shape[1])).index_add_(0, src, msg)
        return dx, None, None, None, None, None


class ScaleMLP(torch.autograd.Function):
    """The decoder after its node tables, per candidate: a1 = rnd(Pd)[i] +
    rnd(Pv)[j] + b1, then as ``common.DecoderMLP``, out = rnd(h2d) .
    rnd(w3), with the backward described in the module doc."""

    @staticmethod
    def _parts(a1, m1, m2, w2, b2, dt):
        h1d = torch.relu(a1)
        if m1 is not None:
            h1d = h1d * m1
        a2 = rnd(h1d, dt) @ rnd(w2, dt) + b2
        h2d = torch.relu(a2)
        if m2 is not None:
            h2d = h2d * m2
        return h1d, a2, h2d

    @staticmethod
    def forward(ctx, pd, pv, drug, dis, m1, m2, b1, w2, b2, w3, dt):
        a1 = rnd(pd, dt)[drug] + rnd(pv, dt)[dis] + b1
        _, _, h2d = ScaleMLP._parts(a1, m1, m2, w2, b2, dt)
        ctx.save_for_backward(pd, pv, drug, dis, m1, m2, b1, w2, b2, w3)
        ctx.dt = dt
        return rnd(h2d, dt) @ rnd(w3, dt)

    @staticmethod
    def backward(ctx, g):
        pd, pv, drug, dis, m1, m2, b1, w2, b2, w3 = ctx.saved_tensors
        dt = ctx.dt
        a1 = rnd(pd, dt)[drug] + rnd(pv, dt)[dis] + b1
        grads = []
        for a in (rnd(a1, dt), a1):        # B1's stored a1, the mirror's
            h1d, a2, h2d = ScaleMLP._parts(a, m1, m2, w2, b2, dt)
            dh2 = w3 * g[:, None]
            if m2 is not None:
                dh2 = dh2 * m2
            da2 = torch.where(a2 > 0.0, dh2, torch.zeros_like(dh2))
            dh1 = rnd(da2, dt) @ rnd(w2, dt).T
            if m1 is not None:
                dh1 = dh1 * m1
            da1 = torch.where(a > 0.0, dh1, torch.zeros_like(dh1))
            grads.append((h1d, da2, h2d, da1))
        h1d, da2, h2d, da1 = grads[0]
        dpd = torch.zeros_like(pd).index_add_(0, drug, rnd(da1, dt))
        dpv = torch.zeros_like(pv).index_add_(0, dis, rnd(grads[1][3], dt))
        dw2 = rnd(h1d, dt).T @ rnd(da2, dt)
        dw3 = (h2d * g[:, None]).sum(0)
        return (dpd, dpv, None, None, None, None, da1.sum(0), dw2,
                da2.sum(0), dw3, None)


class Problem:
    """The raw problem's derived tensors on ``device``."""

    def __init__(self, prob: dict, n_drug: int, n_dis: int, cfg: dict):
        src, dst, y = prob["enc"]
        self.n_drug, self.n_dis = n_drug, n_dis
        self.relations = []
        for r in range(cfg["num_ratings"]):
            sel = (y.long() == r)
            s, t = src[sel], dst[sel]
            ids = torch.arange(s.shape[0], device=s.device)
            self.relations.append((s, t, ids))

        def norm(ids, n):
            deg = torch.bincount(ids, minlength=n).float()
            return torch.where(deg > 0, 1.0 / torch.sqrt(deg),
                               torch.zeros_like(deg))[:, None]
        self.ci_d, self.ci_v = norm(src, n_drug), norm(dst, n_dis)
        self.feat_d, self.feat_v = prob["feat_drug"], prob["feat_dis"]
        self.sides = {k: prob[k] for k in ("train", "test")}


def draw_order(cfg: dict, nd: int, nv: int, d: int,
               pad: int = IDENTITY_PAD):
    """[(name, kind, shape)] of one training step's draws, in order."""
    pad_n = lambda n: -(-n // pad) * pad  # noqa: E731
    seq = []
    for method in cfg["aug"]["methods"]:
        if method == "edge_dropout":
            seq += [("salts", "salt", (2, cfg["num_ratings"])),
                    ("drop_drug_graph", "rand", (pad_n(nd),)),
                    ("drop_dis_graph", "rand", (pad_n(nv),))]
        elif method == "feature_noise":
            seq += [(f"noise_{f}", "randn", (n, d))
                    for f, n in zip(FEATURES, (nd, nv, nd, nv))]
        else:
            raise NotImplementedError(f"augment method {method!r}")
    if cfg["dropout"] > 0:
        for i in range(cfg["layers"]):
            msg = cfg["gcn_agg_units"] // 3 if i == 0 else cfg["gcn_out_units"]
            for r in range(cfg["num_ratings"]):
                seq += [(f"cj_d{i}{r}", "rand", (nd, 1)),
                        (f"cj_v{i}{r}", "rand", (nv, 1))]
            seq += [(f"h_d{i}", "rand", (nd, msg)),
                    (f"h_v{i}", "rand", (nv, msg))]
        seq += [("f_drug_sim", "rand", (nd, cfg["nhid1"])),
                ("f_dis_sim", "rand", (nv, cfg["nhid1"]))]
    if cfg["attention_dropout"] > 0:
        seq += [("att_d", "rand", (nd, 2, 1)), ("att_v", "rand", (nv, 2, 1))]
    if cfg["dropout"] > 0:
        seq += [("dec_seed", "seed", (1,))]
    return seq


def _gcn(p, x, keep, u, rate):
    """The GCN on an identity graph whose entries are kept by ``keep``."""
    h = torch.relu(keep * (x @ p["w1"]) + p["b1"])
    if u is not None:
        h = dropout(h, u, rate)
    return keep * (h @ p["w2"]) + p["b2"]


def _attention(p, z, u, rate):
    n = z.shape[0]
    h = torch.tanh(z.flatten(0, 1) @ p["w1"] + p["b1"])
    beta = torch.softmax((h @ p["w2"]).unflatten(0, (n, 2)), dim=-2)
    if u is not None:
        beta = dropout(beta, u, rate)
    return torch.sum(beta * z, dim=-2)


def forward(P, pb: Problem, side: str, cfg: dict, w, dtype):
    """(logits, labels) of the candidates of ``side``; ``w`` None in
    eval; ``dtype`` is the type of every bf16 point."""
    aug = cfg["aug"]
    nd, nv = pb.n_drug, pb.n_dis
    xd, xv = pb.feat_d, pb.feat_v
    sd, sv = pb.feat_d, pb.feat_v
    keep_d = keep_v = None
    rate_e = aug["edge_dropout_rate"]
    edge_w = [[torch.ones_like(s, dtype=torch.float32)] * 2
              for s, _, _ in pb.relations]
    if w is not None:
        for method in aug["methods"]:
            if method == "edge_dropout":
                edge_w = [[prf_keep(ids, w["salts"][0, r], rate_e),
                           prf_keep(ids, w["salts"][1, r], rate_e)]
                          for r, (_, _, ids) in enumerate(pb.relations)]
                keep = 1.0 - rate_e
                keep_d = (w["drop_drug_graph"][:nd] < keep).float()[:, None]
                keep_v = (w["drop_dis_graph"][:nv] < keep).float()[:, None]
            elif method == "feature_noise":
                fs, ss = aug["feature_noise_scale"], aug["sim_noise_scale"]
                xd = xd + fs * w["noise_drug_feat"]
                xv = xv + fs * w["noise_dis_feat"]
                sd = sd + ss * w["noise_drug_sim_feat"]
                sv = sv + ss * w["noise_dis_sim_feat"]
    rate = cfg["dropout"]
    drop = w is not None and rate > 0
    drug_out = dis_out = None
    for i, p in enumerate(P["tgcn"]):
        wr = (p["att"] @ p["basis"].reshape(p["basis"].shape[0], -1)) \
            .reshape(cfg["num_ratings"], *p["basis"].shape[1:])
        msg_dis = msg_drug = 0.0
        for r, (s, t, _) in enumerate(pb.relations):
            cj_d, cj_v = pb.ci_d, pb.ci_v
            if drop:
                cj_d = dropout(cj_d, w[f"cj_d{i}{r}"], rate)
                cj_v = dropout(cj_v, w[f"cj_v{i}{r}"], rate)
            hd, hv = (xd @ wr[r]) * cj_d, (xv @ wr[r]) * cj_v
            msg_dis = msg_dis + Aggregate.apply(hd, s, t, edge_w[r][0], nv,
                                                dtype)
            msg_drug = msg_drug + Aggregate.apply(hv, t, s, edge_w[r][1],
                                                  nd, dtype)
        hd = _leaky(msg_drug * pb.ci_d)
        hv = _leaky(msg_dis * pb.ci_v)
        if drop:
            hd = dropout(hd, w[f"h_d{i}"], rate)
            hv = dropout(hv, w[f"h_v{i}"], rate)
        od, ov = hd @ p["fc_w"] + p["fc_b"], hv @ p["fc_w"] + p["fc_b"]
        drug_out = od if i == 0 else drug_out + od / float(i + 1)
        dis_out = ov if i == 0 else dis_out + ov / float(i + 1)
        xd, xv = od, ov
    f = P["fgcn"]
    one_d = keep_d if keep_d is not None else 1.0
    one_v = keep_v if keep_v is not None else 1.0
    sim_d = _gcn(f["drug_gcn"], sd, one_d, w["f_drug_sim"] if drop else None,
                 rate)
    sim_v = _gcn(f["dis_gcn"], sv, one_v, w["f_dis_sim"] if drop else None,
                 rate)
    ar = cfg["attention_dropout"]
    att = w is not None and ar > 0
    fd = _attention(P["attention"], torch.stack([drug_out, sim_d], -2),
                    w["att_d"] if att else None, ar)
    fv = _attention(P["attention"], torch.stack([dis_out, sim_v], -2),
                    w["att_v"] if att else None, ar)
    dec = P["decoder"]
    d = fd.shape[-1]
    pd = rnd(fd, dtype) @ rnd(dec["w1"][:d], dtype)
    pv = rnd(fv, dtype) @ rnd(dec["w1"][d:], dtype)
    drug, dis, labels = pb.sides[side]
    m1 = m2 = None
    if drop:
        eid = torch.arange(drug.shape[0], device=drug.device)
        m1, m2 = common.slot_masks(eid, int(w["dec_seed"][0]),
                                   dec["w2"].shape[0], dec["w2"].shape[1],
                                   rate)
    logits = ScaleMLP.apply(pd, pv, drug.long(), dis.long(), m1, m2,
                            dec["b1"], dec["w2"], dec["b2"], dec["w3"][:, 0],
                            dtype)
    return logits + dec["b3"], labels, (drug_out, sim_d, dis_out, sim_v)


def run(prob: dict, cfg: dict, traffic: dict, spec, param_seed: int,
        draw_seed: int, device, *, steps: int = 3,
        dec_dtype=torch.bfloat16) -> dict:
    """The reference's readings, shaped as ``dense.run``'s for n = 1."""
    from gnnbench.inputs.params import leaves, make_params, one_model

    nd, nv, d = cfg["n_drug"], cfg["n_dis"], cfg["d"]
    pb = Problem(prob, nd, nv, cfg)
    P = one_model(make_params(spec, 1, param_seed, device))
    tensors = [t.requires_grad_(True) for _, t in leaves(P)]
    start = [t.detach().clone() for t in tensors]
    opt = common.Adam(tensors, cfg["train_lr"], cfg["weight_decay"])
    gen = torch.Generator(device=device).manual_seed(draw_seed)
    order = draw_order(cfg, nd, nv, d)
    out = {"loss": []}
    for step in range(steps):
        w = common.draw(gen, order, device)
        for t in tensors:
            t.grad = None
        logits, labels, routes = forward(P, pb, "train", cfg, w, dec_dtype)
        loss = common.bce_with_logits(logits, labels,
                                      torch.ones_like(labels))
        if cfg["beta"]:
            loss = loss + cfg["beta"] * (
                common.common_loss(routes[0], routes[1])
                + common.common_loss(routes[2], routes[3]))
        loss.backward()
        del w, logits, routes
        out["loss"].append(torch.tensor([loss.item()], dtype=torch.float64))
        grads = [None if t.grad is None else t.grad[None] for t in tensors]
        if step == 0:
            out["grad_raw"] = _norms([torch.zeros_like(t)[None] if g is None
                                      else g for g, t in zip(grads, tensors)])
        if cfg["train_grad_clip"] > 0:
            common.clip_per_model_(grads, cfg["train_grad_clip"])
        with torch.no_grad():
            seen = opt.step([None if g is None else g[0] for g in grads])
        if step == 0:
            out["grad"] = _norms([g[None] for g in seen])
    out["loss"] = torch.stack(out["loss"]).numpy()
    out["draws"] = gen.get_state().numpy()
    out["change"] = _norms([(t.detach() - s)[None]
                            for t, s in zip(tensors, start)])
    ev = np.zeros((1, 2, 2))
    with torch.no_grad():
        for k, side in enumerate(("train", "test")):
            logits, labels, _ = forward(P, pb, side, cfg, None, dec_dtype)
            y, s = labels.cpu().numpy(), logits.cpu().numpy()
            ev[0, k] = common.auroc(y, s), common.aupr(y, s)
    out["eval"] = ev
    return out

"""Plain reference of GCMC alone on MovieLens-shaped ratings (DGL's
``examples/pytorch/gcmc``, the ml-10m run): its first training steps and its
evaluation, for one model.

Worked out again from the raw ratings (user, movie and level index of every
rating, and the train, valid and test index sets): each level's train
ratings are a relation in both directions, the norms are 1/sqrt of a
node's train ratings over all levels, the test side's encoder graph holds
the train and valid ratings, as DGL's data.py builds them.  The layer, per
level r and direction, sums W_r's rows (one-hot inputs) times the dropped
source norm over the relation's ratings by ``index_add_`` and times the
destination norm; the levels' sums are concatenated in level order, then
LeakyReLU(0.1), dropout and a Linear (``ifc`` for users, ``fc`` for
movies).  The decoder scores each rating with s_b = u_i^T P_b v_j and the
logits a s, in blocks of ratings, its backward worked out in the same
blocks; the loss is the mean softmax cross-entropy over the train ratings,
then the global-norm clip and Adam (L2 in the gradient, eps outside the
square root); the eval is the RMSE of the softmax's expected level value.
Float32 (the caller turns TF32 off).  ``dtype`` rounds the messages and the
decoder's node rows and basis to it where they are read, for the control
in a lower precision.

The draws follow the program's order: per level the users' then the
movies' norm dropout masks, then the users' and the movies' hidden dropout
masks (``draw_order``); the decoder draws nothing.

Plain PyTorch alone: nothing here imports the program or JAX.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

BLOCK = 1 << 18
LEVELS = tuple(0.5 * (k + 1) for k in range(10))


def rnd(x: torch.Tensor, dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype`` and back (the identity for float32)."""
    return x if dtype == torch.float32 else x.to(dtype).to(x.dtype)


def dropout(x, u, rate: float):
    keep = 1.0 - rate
    return torch.where(u < keep, x / keep, torch.zeros_like(x))


class Graph:
    """The relations and norms of one set of ratings."""

    def __init__(self, users, movies, levels, n_users: int, n_movies: int,
                 num_ratings: int):
        self.relations = [(users[levels == r], movies[levels == r])
                          for r in range(num_ratings)]

        def norm(ids, n):
            deg = torch.bincount(ids, minlength=n).float()
            return torch.where(deg > 0, 1.0 / torch.sqrt(deg),
                               torch.zeros_like(deg))[:, None]
        self.c_user, self.c_movie = norm(users, n_users), norm(movies,
                                                               n_movies)


class Data:
    """The raw ratings' derived tensors: the train graph, the train and
    valid graph, and each side's ratings."""

    def __init__(self, raw: dict, cfg: dict):
        u, m, lv = raw["users"], raw["movies"], raw["levels"]
        tr, va, te = raw["train"], raw["valid"], raw["test"]
        nu, nm, r = cfg["n_users"], cfg["n_movies"], cfg["num_ratings"]
        self.n_users, self.n_movies = nu, nm
        train = Graph(u[tr], m[tr], lv[tr], nu, nm, r)
        both = torch.cat([tr, va])
        self.sides = {
            "train": (train, u[tr], m[tr], lv[tr]),
            "valid": (train, u[va], m[va], lv[va]),
            "test": (Graph(u[both], m[both], lv[both], nu, nm, r), u[te],
                     m[te], lv[te]),
        }


def draw_order(cfg: dict):
    """[(name, shape)] of one training step's uniform draws, in order."""
    nu, nm = cfg["n_users"], cfg["n_movies"]
    seq = []
    for r in range(cfg["num_ratings"]):
        seq += [(f"cj_u{r}", (nu, 1)), (f"cj_m{r}", (nm, 1))]
    return seq + [("h_u", (nu, cfg["gcn_agg_units"])),
                  ("h_m", (nm, cfg["gcn_agg_units"]))]


def encode(p: dict, g: Graph, cfg: dict, w, dtype):
    """(user rows, movie rows) of the layer; ``w`` the draws, None in
    eval."""
    rate = cfg["dropout"]
    to_u, to_m = [], []
    for r, (src, dst) in enumerate(g.relations):
        cu, cm = g.c_user, g.c_movie
        if w is not None:
            cu = dropout(cu, w[f"cj_u{r}"], rate)
            cm = dropout(cm, w[f"cj_m{r}"], rate)
        hu = rnd(p["w_drug"][r] * cu, dtype)
        hm = rnd(p["w_dis"][r] * cm, dtype)
        to_m.append(hu.new_zeros((g.c_movie.shape[0], hu.shape[1]))
                    .index_add_(0, dst, hu[src]))
        to_u.append(hm.new_zeros((g.c_user.shape[0], hm.shape[1]))
                    .index_add_(0, src, hm[dst]))
    hu = F.leaky_relu(torch.cat(to_u, -1) * g.c_user, 0.1)
    hm = F.leaky_relu(torch.cat(to_m, -1) * g.c_movie, 0.1)
    if w is not None:
        hu = dropout(hu, w["h_u"], rate)
        hm = dropout(hm, w["h_m"], rate)
    return hu @ p["ifc_w"] + p["ifc_b"], hm @ p["fc_w"] + p["fc_b"]


class Bilinear(torch.autograd.Function):
    """logits (R, E) = a s, s_b = u_i^T P_b v_j over ratings (i, j), in
    blocks; the backward recomputes s block by block."""

    @staticmethod
    def _s(u, v, p, i, j, dtype):
        ui, vj = rnd(u, dtype)[i], rnd(v, dtype)[j]
        return torch.einsum("ek,bkl,el->eb", ui, rnd(p, dtype), vj), ui, vj

    @staticmethod
    def forward(ctx, u, v, p, a, i, j, dtype):
        out = u.new_empty((a.shape[0], i.shape[0]))
        for lo in range(0, i.shape[0], BLOCK):
            s, _, _ = Bilinear._s(u, v, p, i[lo:lo + BLOCK], j[lo:lo + BLOCK],
                                  dtype)
            out[:, lo:lo + BLOCK] = a @ s.T
        ctx.save_for_backward(u, v, p, a, i, j)
        ctx.dtype = dtype
        return out

    @staticmethod
    def backward(ctx, g):
        u, v, p, a, i, j = ctx.saved_tensors
        du, dv = torch.zeros_like(u), torch.zeros_like(v)
        dp, da = torch.zeros_like(p), torch.zeros_like(a)
        pr = rnd(p, ctx.dtype)
        for lo in range(0, i.shape[0], BLOCK):
            ib, jb, gb = i[lo:lo + BLOCK], j[lo:lo + BLOCK], g[:, lo:lo + BLOCK]
            s, ui, vj = Bilinear._s(u, v, p, ib, jb, ctx.dtype)
            da += gb @ s
            ds = gb.T @ a                                        # (e, B)
            du.index_add_(0, ib, torch.einsum("eb,bkl,el->ek", ds, pr, vj))
            dv.index_add_(0, jb, torch.einsum("eb,bkl,ek->el", ds, pr, ui))
            dp += torch.einsum("eb,ek,el->bkl", ds, ui, vj)
        return du, dv, dp, da, None, None, None


def forward(P: dict, data: Data, side: str, cfg: dict, w, dtype):
    """(logits (R, E), level indices (E,)) of the ratings of ``side``."""
    g, users, movies, levels = data.sides[side]
    u, v = encode(P["tgcn"][0], g, cfg, w, dtype)
    dec = P["decoder"]
    return Bilinear.apply(u, v, dec["P"], dec["a"], users, movies,
                          dtype), levels


def cross_entropy(logits, levels):
    return (torch.logsumexp(logits, 0)
            - torch.gather(logits, 0, levels[None])[0]).mean()


def rmse(logits, levels) -> float:
    values = torch.tensor(LEVELS[:logits.shape[0]], device=logits.device)
    pred = torch.softmax(logits, 0).T @ values
    return float(torch.sqrt(torch.mean((pred - values[levels]) ** 2)))


def leaves(tree):
    """The tensors of a tree, the dict keys sorted."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, list):
        return [x for t in tree for x in leaves(t)]
    return [tree]


def _norms(tensors) -> torch.Tensor:
    """(L, 1) norms, the harness's readings of one model."""
    return torch.stack([torch.linalg.vector_norm(t) for t in tensors])[
        :, None].double().cpu()


def run(raw: dict, cfg: dict, params: dict, draw_seed: int, device, *,
        steps: int = 3, dtype=torch.float32) -> dict:
    """The readings of ``steps`` training steps from ``params`` (one
    model's tree, copied) and the evaluation after them: each step's loss,
    the norms of the raw first gradient and of the first gradient as Adam
    takes it, of each leaf's change, and the (1, 2, 1) valid and test RMSE;
    the draws' generator state."""
    data = Data(raw, cfg)
    tensors = [t.detach().clone().requires_grad_(True)
               for t in leaves(params)]
    it = iter(tensors)

    def rebuild(tree):
        if isinstance(tree, dict):
            built = {k: rebuild(tree[k]) for k in sorted(tree)}
            return {k: built[k] for k in tree}
        if isinstance(tree, list):
            return [rebuild(t) for t in tree]
        return next(it)

    P = rebuild(params)
    start = [t.detach().clone() for t in tensors]
    mu = [torch.zeros_like(t) for t in tensors]
    nu = [torch.zeros_like(t) for t in tensors]
    lr, wd, clip = cfg["train_lr"], cfg["weight_decay"], cfg["train_grad_clip"]
    gen = torch.Generator(device=device).manual_seed(draw_seed)
    order = draw_order(cfg)
    out = {"loss": []}
    for step in range(steps):
        w = {name: torch.rand(shape, generator=gen, device=device)
             for name, shape in order}
        for t in tensors:
            t.grad = None
        logits, levels = forward(P, data, "train", cfg, w, dtype)
        loss = cross_entropy(logits, levels)
        loss.backward()
        del w, logits
        out["loss"].append(torch.tensor([loss.item()], dtype=torch.float64))
        grads = [t.grad for t in tensors]
        if step == 0:
            out["grad_raw"] = _norms(grads)
        if clip > 0:
            norm = torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(g) for g in grads]))
            scale = clip / torch.clamp_min(norm, clip)
            grads = [g * scale for g in grads]
        with torch.no_grad():
            seen = []
            for t, g, m, n in zip(tensors, grads, mu, nu):
                g = g + wd * t if wd else g
                seen.append(g)
                m.mul_(0.9).add_(g, alpha=0.1)
                n.mul_(0.999).addcmul_(g, g, value=0.001)
                den = torch.sqrt(n / (1.0 - 0.999 ** (step + 1))) + 1e-8
                t.sub_(lr * (m / (1.0 - 0.9 ** (step + 1))) / den)
        if step == 0:
            out["grad"] = _norms(seen)
    out["loss"] = torch.stack(out["loss"]).numpy()
    out["draws"] = gen.get_state().numpy()
    out["change"] = _norms([t.detach() - s for t, s in zip(tensors, start)])
    ev = torch.zeros((1, 2, 1), dtype=torch.float64)
    with torch.no_grad():
        for k, side in enumerate(("valid", "test")):
            logits, levels = forward(P, data, side, cfg, None, dtype)
            ev[0, k, 0] = rmse(logits, levels)
    out["eval"] = ev.numpy()
    return out

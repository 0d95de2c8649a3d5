"""Initial weights of a stack of DREAM-GNN models, made from the run's seed.

The tree has the keys and the (in, out) layout of the port's parameter
tree (``tgcn[i]``, ``fgcn``, ``attention``, ``decoder``), every leaf with a
leading axis of ``n`` models.  Each leaf is one uniform draw on the device
from one generator, in the initialisers' bounds of the reference model
(xavier for the GCMC weights, ``nn.Linear``'s U(+-1/sqrt(fan_in)) for the
attention, decoder and fusion layers, U(+-1/sqrt(out)) for the graph
convolutions).  The same seed on the same device gives the same bits, so
the plain reference makes its own copy by calling ``make_params`` again.
"""

from __future__ import annotations

import math

import torch


def _xavier(fan_in: int, fan_out: int) -> float:
    return math.sqrt(6.0 / (fan_in + fan_out))


def param_spec(cfg: dict, n_drug_in: int, n_dis_in: int, in_units: int):
    """[(path, shape, bound)] of one model, in a fixed order.  ``n_drug_in``
    and ``n_dis_in`` are the FGCN input widths, ``in_units`` the first GCMC
    layer's input width."""
    r, b = cfg["num_ratings"], cfg["basis_units"]
    out = cfg["gcn_out_units"]
    spec = []
    for i in range(cfg["layers"]):
        fin = in_units if i == 0 else out
        msg = cfg["gcn_agg_units"] // 3 if i == 0 else out
        spec += [
            (("tgcn", i, "att"), (r, b), _xavier(b, r)),
            # torch's xavier fans of a (b, in, msg) tensor: dims 1 and 0
            # times the trailing receptive field.
            (("tgcn", i, "basis"), (b, fin, msg), _xavier(fin * msg, b * msg)),
            (("tgcn", i, "fc_w"), (msg, out), _xavier(msg, out)),
            (("tgcn", i, "fc_b"), (out,), 1.0 / math.sqrt(msg)),
        ]
    h1, h2 = cfg["nhid1"], cfg["nhid2"]
    for side, fdim in (("drug_gcn", n_drug_in), ("dis_gcn", n_dis_in)):
        spec += [
            (("fgcn", side, "w1"), (fdim, h1), 1.0 / math.sqrt(h1)),
            (("fgcn", side, "b1"), (h1,), 1.0 / math.sqrt(h1)),
            (("fgcn", side, "w2"), (h1, h2), 1.0 / math.sqrt(h2)),
            (("fgcn", side, "b2"), (h2,), 1.0 / math.sqrt(h2)),
        ]
    fused = 1.0 / math.sqrt(2 * h2)
    for side in ("drug", "dis"):
        spec += [(("fgcn", f"{side}_fusion_w"), (2 * h2, h2), fused),
                 (("fgcn", f"{side}_fusion_b"), (h2,), fused)]
    a = cfg["attention_hidden"]
    spec += [
        (("attention", "w1"), (out, a), 1.0 / math.sqrt(out)),
        (("attention", "b1"), (a,), 1.0 / math.sqrt(out)),
        (("attention", "w2"), (a, 1), 1.0 / math.sqrt(a)),
    ]
    d1, d2 = cfg["decoder_hidden1"], cfg["decoder_hidden2"]
    spec += [
        (("decoder", "w1"), (2 * out, d1), 1.0 / math.sqrt(2 * out)),
        (("decoder", "b1"), (d1,), 1.0 / math.sqrt(2 * out)),
        (("decoder", "w2"), (d1, d2), 1.0 / math.sqrt(d1)),
        (("decoder", "b2"), (d2,), 1.0 / math.sqrt(d1)),
        (("decoder", "w3"), (d2, 1), 1.0 / math.sqrt(d2)),
        (("decoder", "b3"), (1,), 1.0 / math.sqrt(d2)),
    ]
    return spec


def _put(tree, path, value):
    node = tree
    for key, nxt in zip(path[:-1], path[1:]):
        if isinstance(key, int):
            while len(node) <= key:
                node.append({})
            node = node[key]
        else:
            node = node.setdefault(key, [] if isinstance(nxt, int) else {})
    node[path[-1]] = value


def make_params(spec, n: int, seed: int, device) -> dict:
    """The tree of ``n`` models' leaves, each (n, *shape) float32, drawn
    from one generator seeded with ``seed``: one call a leaf."""
    gen = torch.Generator(device=device).manual_seed(seed)
    tree: dict = {}
    for path, shape, bound in spec:
        u = torch.rand((n, *shape), generator=gen, device=device)
        _put(tree, path, u.mul_(2.0).sub_(1.0).mul_(bound))
    return tree


def one_model(tree):
    """The first model's leaves of a stacked tree, without the model
    axis."""
    if isinstance(tree, dict):
        return {k: one_model(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [one_model(v) for v in tree]
    return tree[0].clone()


def leaves(tree, path=()):
    """[(path, tensor)] of a tree with the dict keys sorted: the port's
    ``param_leaves`` order, which its optimizer state follows."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k], path + (k,))]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in leaves(v, path + (i,))]
    return [(path, tree)]

"""Per-step stochastic augmentation as masks and noise.

Port of ``dream_gnn_tpu/augment/masks.py``: the six methods of the
training step, ``edge_dropout``, ``add_random_edges``, ``feature_noise``,
``graph_noise``, ``feature_masking`` and ``mix_up``.  Every augmentation
is a random mask or noise drawn per step; shapes stay fixed and no graph
is rebuilt.  The randomness is drawn first (``draw_augment``) and applied
second (``apply_augment``), so that the application can be held against
the JAX package with the same draws.

Order.  The methods compose in ``cfg.methods`` order, as the JAX
``augment_inputs`` composes them (masks.py:207-297 there): each method
acts on what the methods before it made.  So ``graph_noise`` after
``edge_dropout`` noises only the kept entries, and ``edge_dropout`` after
``graph_noise`` drops noised ones.  The draws are therefore a list of
(method, field, draw) in method order, and the apply step walks it.  The
encoder's masks follow JAX exactly: ``edge_dropout`` *sets* them, and
``add_random_edges`` *adds* its masks to them (to all-ones keep masks when
there are none).  So an ``edge_dropout`` after ``add_random_edges`` throws
the add masks away, and the step trains without added edges.

Parity notes (SURVEY.md §7.3.2-3):
- augmentation runs unconditionally every iteration with default
  methods ('edge_dropout', 'feature_noise');
- edge dropout keeps the graph's original ci/cj norms (stale) and
  drops the encoder's forward and reverse etype edge sets
  independently, plus entries of all four similarity graphs;
- the reference keeps exactly ``int(E*(1-p))`` edges via randperm; here,
  as in the JAX package, iid Bernoulli(1-p) per edge;
- feature noise adds ``feature_noise_scale`` Gaussian noise to the
  embeddings and ``sim_noise_scale`` noise to the similarity rows;
- edge addition is a Bernoulli grid per rating whose rate adds about
  ``add_edge_rate`` times the rating's edges; graph noise, feature masking
  and mix-up act as the reference's (augmentation.py:127-337).

Layouts.  ``add_random_edges`` takes the dense encoder graph only, and
``graph_noise`` dense similarity graphs only, as in JAX.  Edge dropout
also takes the padded-COO, slabbed, grouped and both rank-sharded encoder
graphs.  The slabbed, grouped and sharded-grouped ones (graph/slabbed.py,
graph/grouped.py, sharding/scale_graph.py) drop edges by a stateless PRF
of (salt, physical edge id), ``prf_keep_mask``, so that a relation's
forward and transposed layouts drop the same edges: the draw is two salts
per rating (``edge_dropout_masks_grouped``), and the masks are applied to
the layouts' weights (``prf_mask_pair``).  The padded-COO encoder graph
(graph/bipartite_coo.py) draws one Bernoulli keep mask per relation and
direction over its padded edges (``edge_dropout_masks_coo``), which the
GCMC layer multiplies into ``val``; the sharded COO graph
(``BipartiteSharded``) likewise, one mask over each relation's live edges
gathered into this rank's block (``edge_dropout_masks_sharded``).
Identity ``CooGraph`` similarity graphs drop entries of ``val``.

Ranks.  Every rank of a sharded run seeds its generator alike and draws
every mask and salt for the whole graph, so all ranks hold the same draws,
and a run over any number of ranks draws what one rank would.

Inputs stacked over folds (sharding/foldstack.py) get stacked draws:
each draw is one call that makes the whole (F, ...) tensor, so no two
folds share a mask, a noise tensor, a permutation or a mix-up
coefficient, and the edge-add rate is each fold's own.

``feature_masking`` and ``mixup_features`` also serve the loader-side
feature augmentation of novel predictions (data/loader.py
``augment_features``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from dream_gnn_tpu_torch.config import AugmentConfig
from dream_gnn_tpu_torch.graph.bipartite import BipartiteGraph
from dream_gnn_tpu_torch.graph.bipartite_coo import BipartiteCoo
from dream_gnn_tpu_torch.graph.coo import CooGraph
from dream_gnn_tpu_torch.graph.grouped import BipartiteGrouped
from dream_gnn_tpu_torch.graph.knn import NormAdj
from dream_gnn_tpu_torch.graph.slabbed import BipartiteSlabbed
from dream_gnn_tpu_torch.kernels.grid_decoder import fmix32
from dream_gnn_tpu_torch.sharding.scale_graph import (BipartiteSharded,
                                                      BipartiteShardedGrouped)
from dream_gnn_tpu_torch.utils import draws as rng

# The encoder layouts whose edge dropout is the PRF of physical edge ids.
PRF_LAYOUTS = (BipartiteSlabbed, BipartiteGrouped, BipartiteShardedGrouped)
GRAPH_FIELDS = ("drug_graph", "dis_graph", "drug_feature_graph",
                "dis_feature_graph")
FEATURE_FIELDS = ("drug_feat", "dis_feat", "drug_sim_feat", "dis_sim_feat")
# The fields of feature_masking and mix_up (JAX masks.py:274-283).
EMBED_FIELDS = ("drug_feat", "dis_feat")
# The draw that carries the encoder's masks.
EDGE_MASKS = "edge_masks"


def _bernoulli(gen, p, shape, device) -> torch.Tensor:
    """A float32 Bernoulli(p) mask of ``shape``; ``p`` is a float or a
    tensor that broadcasts against ``shape``."""
    return (rng.rand(gen, shape, device) < p).to(torch.float32)


def edge_dropout_masks(gen, n_drug: int, n_dis: int, num_ratings: int,
                       rate: float, device,
                       folds: tuple = ()) -> Dict[str, torch.Tensor]:
    """Per-etype keep masks (*folds, R, n_drug, n_dis) for the encoder
    graph; forward and reverse relations drop independent edge sets
    (augmentation.py:35-62)."""
    shape = (*folds, num_ratings, n_drug, n_dis)
    return {"fwd": _bernoulli(gen, 1.0 - rate, shape, device),
            "rev": _bernoulli(gen, 1.0 - rate, shape, device)}


def edge_addition_masks(gen, graph: BipartiteGraph, num_ratings: int,
                        add_rate: float) -> Dict[str, torch.Tensor]:
    """Per-etype edge-add masks ``fwd_add`` and ``rev_add``, each
    (*folds, R, n_drug, n_dis) (JAX masks.py:49-71): per rating r and
    direction a Bernoulli(p_r) grid, p_r = clip(add_rate * sum(A_r) /
    (n_drug * n_dis), 0, 1), which adds about add_rate * E_r edges.  On a
    fold stack p_r is each fold's own, an (F, R) tensor on the device
    (never a host float, which would sync every step).  The GCMC layer
    takes max(A_r * keep, add), so a hit on an existing edge adds
    nothing."""
    cells = float(graph.n_drug * graph.n_dis)
    edges = torch.stack([graph.a0().sum((-2, -1)), graph.a1.sum((-2, -1))],
                        dim=-1)[..., :num_ratings]
    p = torch.clamp(add_rate * edges / cells, 0.0, 1.0)[..., None, None]
    shape = (*graph.a1.shape[:-2], num_ratings, graph.n_drug, graph.n_dis)
    return {"fwd_add": _bernoulli(gen, p, shape, p.device),
            "rev_add": _bernoulli(gen, p, shape, p.device)}


def edge_dropout_masks_coo(gen, graph: BipartiteCoo, rate: float):
    """Per-edge keep masks of a padded-COO encoder graph (masks.py:74-89):
    a tuple per direction of (E_pad,) Bernoulli(1 - rate) masks, one per
    relation, drawn rating by rating, forward before reverse."""
    fwd, rev = [], []
    for r in range(graph.num_ratings):
        for out, g in ((fwd, graph.fwd[r]), (rev, graph.rev[r])):
            out.append(_bernoulli(gen, 1.0 - rate, (g.e_pad,), g.val.device))
    return {"fwd": tuple(fwd), "rev": tuple(rev)}


def edge_dropout_masks_sharded(gen, graph: BipartiteSharded, rate: float):
    """Per-edge keep masks of this rank's blocks of a ``BipartiteSharded``
    graph (masks.py:142-158): a tuple per direction of (E_shard,) masks,
    one per relation.  Each is one Bernoulli(1 - rate) draw over the
    relation's live edges, rating by rating, forward before reverse,
    gathered by the block's edge ids; padding edges weigh 0 anyway."""
    fwd, rev = [], []
    for r in range(graph.num_ratings):
        for out, g in ((fwd, graph.fwd[r]), (rev, graph.rev[r])):
            keep = _bernoulli(gen, 1.0 - rate, (g.n_live,), g.val.device)
            out.append(keep[g.edge_id])
    return {"fwd": tuple(fwd), "rev": tuple(rev)}


def prf_keep_mask(salt, edge_id: torch.Tensor, rate: float) -> torch.Tensor:
    """Stateless per-edge keep mask, a function of (salt, edge_id) only,
    bit for bit the JAX ``prf_keep_mask`` (masks.py:92-110): x = edge_id ^
    salt through the murmur3 finaliser, u = float32(x) / 2**32, keep iff
    u >= rate.  uint32 values are held in int64."""
    x = fmix32((edge_id.to(torch.int64) & 0xFFFFFFFF)
               ^ (torch.as_tensor(salt, device=edge_id.device)
                  .to(torch.int64) & 0xFFFFFFFF))
    u = x.to(torch.float32) * (1.0 / 4294967296.0)
    return (u >= torch.tensor(rate, dtype=torch.float32,
                              device=u.device)).to(torch.float32)


def prf_mask_pair(pair, salt, rate: float):
    """A layout pair (``SlabbedCooPair`` or ``GroupedCooPair``: any whose
    layouts carry ``val`` and ``edge_id``) with both layouts' weights
    masked by the PRF keep mask of their physical edge ids
    (masks.py:113-127): the forward and the transposed layout drop the same
    edges, so the gradient stays exact."""
    def masked(g):
        return dataclasses.replace(g, val=g.val * prf_keep_mask(
            salt, g.edge_id, rate))
    return dataclasses.replace(pair, fwd=masked(pair.fwd),
                               bwd=masked(pair.bwd))


def edge_dropout_masks_grouped(gen, graph, rate: float):
    """Per-relation salts for the PRF edge dropout of a slabbed or grouped
    encoder graph (masks.py:130-139): forward and reverse relations drop
    independent sets; ``rate`` rides along to the apply site."""
    salts = torch.randint(0, 2 ** 31 - 1, (2, graph.num_ratings),
                          generator=gen, device=graph.ci_drug.device)
    return {"fwd_salts": salts[0], "rev_salts": salts[1], "rate": rate,
            "kind": "grouped_prf"}


def prf_mask_graph(graph, edge_masks):
    """The slabbed or grouped encoder graph with every relation's PRF edge
    dropout applied, for all relations at once: what the JAX layer does to
    each relation (gcmc.py:194-225 of the JAX package).  The port's only
    site of this dropout: model/dream_gnn.py:_encode masks the graph once
    for all layers, and nn/gcmc.py takes the masked graph."""
    if not isinstance(graph, PRF_LAYOUTS):
        raise ValueError(f"a {type(graph).__name__} takes no PRF edge "
                         f"dropout")
    if edge_masks.get("kind") != "grouped_prf":
        raise ValueError(f"the {type(graph).__name__} layout needs PRF edge "
                         f"masks")
    rate = edge_masks["rate"]

    def mask(p, salt):
        # A ring's relation is a tuple of sub-block pairs, all masked alike.
        if isinstance(p, tuple):
            return tuple(prf_mask_pair(q, salt, rate) for q in p)
        return prf_mask_pair(p, salt, rate)

    return dataclasses.replace(
        graph,
        fwd=tuple(mask(p, s) for p, s in zip(graph.fwd,
                                             edge_masks["fwd_salts"])),
        rev=tuple(mask(p, s) for p, s in zip(graph.rev,
                                             edge_masks["rev_salts"])))


def sparse_edge_dropout(adj, keep: torch.Tensor):
    """Drop entries of a similarity adjacency (dense or COO); kept entries
    retain their stale row-normalised values (augmentation.py:92-124)."""
    if isinstance(adj, CooGraph):
        return dataclasses.replace(adj, val=adj.val * keep)
    return NormAdj(a=adj.a * keep)


def feature_noise(x: torch.Tensor, noise: torch.Tensor,
                  scale: float) -> torch.Tensor:
    """Additive Gaussian noise (augmentation.py:208-241)."""
    return x + scale * noise


def graph_noise(adj: NormAdj, noise: torch.Tensor, scale: float) -> NormAdj:
    """Gaussian noise on the nonzero entries of a dense similarity graph,
    clamped at 0; zeros stay zeros (augmentation.py:244-273)."""
    a = adj.a
    return NormAdj(a=torch.where(a != 0, torch.clamp_min(a + scale * noise,
                                                         0.0), 0.0))


def mask_features(x: torch.Tensor, u: torch.Tensor,
                  rate: float) -> torch.Tensor:
    """Elementwise zero-masking without rescaling (augmentation.py:276-308):
    keep where the uniform draw ``u`` exceeds ``rate``."""
    return x * (u > rate)


def feature_masking(gen, x: torch.Tensor, rate: float) -> torch.Tensor:
    """``mask_features`` with one uniform draw per element from ``gen``
    (JAX masks.py:193)."""
    return mask_features(x, torch.rand(x.shape, generator=gen,
                                       device=x.device), rate)


def mix_rows(x: torch.Tensor, perm: torch.Tensor, lam) -> torch.Tensor:
    """Row mixup ``lam * x + (1 - lam) * x[perm]`` (augmentation.py:
    311-337).  x is (..., N, D), perm (..., N) and lam (...): on a fold
    stack each fold mixes its own rows with its own coefficient."""
    lam = torch.as_tensor(lam, device=x.device)[..., None, None]
    return lam * x + (1.0 - lam) * torch.take_along_dim(
        x, perm.long()[..., None], dim=-2)


def row_permutations(gen, shape, device) -> torch.Tensor:
    """Uniform random permutations of range(shape[-1]), one per leading
    index: the argsort of float64 uniform draws, since ``torch.randperm``
    makes one permutation a call."""
    return torch.argsort(rng.rand(gen, shape, device, torch.float64),
                         dim=-1)


def beta_sample(gen, alpha: float, device, shape=(),
                fold_dim: int = 0) -> torch.Tensor:
    """Beta(alpha, alpha) draws of ``shape`` as float32 on ``device``: the
    inverse CDF (scipy's ``betaincinv``) of uniform draws from ``gen``;
    torch's own Beta sampler takes no generator.  All the draws of a call
    make one round trip to the host.  ``fold_dim``: the fold axis of a
    stack's draws (utils/draws.py)."""
    from scipy.special import betaincinv

    u = rng.rand(gen, shape, device, torch.float64, fold_dim)
    return torch.as_tensor(betaincinv(alpha, alpha, u.cpu().numpy()),
                           dtype=torch.float32, device=device)


def mixup_features(gen, x: torch.Tensor, alpha: float) -> torch.Tensor:
    """Row mixup with a Beta(alpha, alpha) coefficient (JAX masks.py:199):
    a permutation of the rows, then the coefficient, both from ``gen``."""
    perm = row_permutations(gen, x.shape[:-1], x.device)
    return mix_rows(x, perm, beta_sample(gen, alpha, x.device))


def _similarity_graphs(inputs):
    """(field, graph) of each similarity graph the inputs hold."""
    return [(f, getattr(inputs, f)) for f in GRAPH_FIELDS
            if getattr(inputs, f) is not None]


def _encoder_dropout_masks(gen, enc, cfg: AugmentConfig, num_ratings: int):
    if isinstance(enc, BipartiteGraph):
        return edge_dropout_masks(gen, enc.n_drug, enc.n_dis, num_ratings,
                                  cfg.edge_dropout_rate, enc.a1.device,
                                  folds=tuple(enc.a1.shape[:-2]))
    if isinstance(enc, PRF_LAYOUTS):
        return edge_dropout_masks_grouped(gen, enc, cfg.edge_dropout_rate)
    if isinstance(enc, BipartiteCoo):
        return edge_dropout_masks_coo(gen, enc, cfg.edge_dropout_rate)
    if isinstance(enc, BipartiteSharded):
        return edge_dropout_masks_sharded(gen, enc, cfg.edge_dropout_rate)
    raise ValueError(f"edge dropout takes no {type(enc).__name__} encoder "
                     f"graph")


def draw_augment(gen, inputs, cfg: AugmentConfig, num_ratings: int = 2):
    """Draw one step's augmentation randomness from ``gen``.

    Returns a list of (method, field, draw) in ``cfg.methods`` order, the
    draws of one method in the JAX method's field order:
    - edge_dropout: the encoder's fwd/rev keep masks under 'edge_masks',
      then a keep mask per similarity graph under its field;
    - add_random_edges: the encoder's ``fwd_add``/``rev_add`` masks under
      'edge_masks';
    - feature_noise: a standard-normal tensor per feature field;
    - graph_noise: a standard-normal tensor per similarity graph;
    - feature_masking: a uniform tensor per embedding field;
    - mix_up: a (row permutation, coefficient) pair per embedding field.
    """
    draws = []
    for method in cfg.methods:
        if method == "edge_dropout":
            draws.append((method, EDGE_MASKS, _encoder_dropout_masks(
                gen, inputs.enc_graph, cfg, num_ratings)))
            for field, g in _similarity_graphs(inputs):
                w = g.val if isinstance(g, CooGraph) else g.a
                draws.append((method, field, _bernoulli(
                    gen, 1.0 - cfg.edge_dropout_rate, w.shape, w.device)))
        elif method == "add_random_edges":
            enc = inputs.enc_graph
            if not isinstance(enc, BipartiteGraph):
                raise NotImplementedError(
                    "add_random_edges: dense-mask encoder graphs only")
            draws.append((method, EDGE_MASKS, edge_addition_masks(
                gen, enc, num_ratings, cfg.add_edge_rate)))
        elif method == "feature_noise":
            for field in FEATURE_FIELDS:
                x = getattr(inputs, field)
                draws.append((method, field, rng.randn(
                    gen, x.shape, x.device, x.dtype)))
        elif method == "graph_noise":
            # ``.a``: dense graphs only; a CooGraph fails here as in JAX.
            for field, g in _similarity_graphs(inputs):
                draws.append((method, field, rng.randn(
                    gen, g.a.shape, g.a.device)))
        elif method == "feature_masking":
            for field in EMBED_FIELDS:
                x = getattr(inputs, field)
                draws.append((method, field, rng.rand(
                    gen, x.shape, x.device)))
        elif method == "mix_up":
            # Both fields' coefficients in one call: one host round trip.
            x = inputs.drug_feat
            lams = beta_sample(gen, cfg.mixup_alpha, x.device,
                               (len(EMBED_FIELDS), *x.shape[:-2]),
                               fold_dim=1)
            for field, lam in zip(EMBED_FIELDS, lams):
                x = getattr(inputs, field)
                draws.append((method, field, (row_permutations(
                    gen, x.shape[:-1], x.device), lam)))
        else:
            raise ValueError(f"unknown augmentation method {method!r}")
    return draws


def _apply_one(method: str, field: str, value, draw, cfg: AugmentConfig):
    if method == "edge_dropout":
        return sparse_edge_dropout(value, draw)
    if method == "feature_noise":
        return feature_noise(value, draw, cfg.feature_noise_scale
                             if field in EMBED_FIELDS
                             else cfg.sim_noise_scale)
    if method == "graph_noise":
        return graph_noise(value, draw, cfg.graph_noise_scale)
    if method == "feature_masking":
        return mask_features(value, draw, cfg.feature_mask_rate)
    if method == "mix_up":
        return mix_rows(value, *draw)
    raise ValueError(f"unknown augmentation method {method!r}")


def apply_augment(inputs, draws, cfg: AugmentConfig):
    """Apply drawn augmentation in the order of ``draws``, each method to
    what the methods before it made; returns (ModelInputs, edge_masks or
    None) as the JAX ``augment_inputs`` does (masks.py:207-297)."""
    upd = {}
    edge_masks = None
    for method, field, draw in draws:
        if field != EDGE_MASKS:
            value = upd.get(field, getattr(inputs, field))
            upd[field] = _apply_one(method, field, value, draw, cfg)
        elif method == "edge_dropout":
            edge_masks = draw
        else:
            # add_random_edges merges into the keep masks (all ones when
            # there are none), as JAX does (masks.py:284-293).
            edge_masks = dict(edge_masks or {
                "fwd": torch.ones_like(draw["fwd_add"]),
                "rev": torch.ones_like(draw["rev_add"])}, **draw)
    out = dataclasses.replace(inputs, **upd) if upd else inputs
    return out, edge_masks


def augment_inputs(gen, inputs, cfg: AugmentConfig, num_ratings: int = 2):
    """Draw and apply the configured augmentation for one step.
    Returns (augmented ModelInputs, encoder edge_masks or None)."""
    return apply_augment(inputs, draw_augment(gen, inputs, cfg, num_ratings),
                         cfg)

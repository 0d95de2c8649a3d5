"""Per-step stochastic augmentation as masks and noise.

Port of ``edge_dropout`` and ``feature_noise`` of
``dream_gnn_tpu/augment/masks.py``, for the dense, padded-COO, slabbed and
grouped encoder graphs: every
augmentation is a random mask or noise drawn per step; shapes stay
fixed and no graph is rebuilt.  The randomness is drawn first
(``draw_augment``) and applied second (``apply_augment``), so that the
application can be held against the JAX package with the same draws.

Parity notes (SURVEY.md §7.3.2-3):
- augmentation runs unconditionally every iteration with default
  methods ('edge_dropout', 'feature_noise');
- edge dropout keeps the graph's original ci/cj norms (stale) and
  drops the encoder's forward and reverse etype edge sets
  independently, plus entries of all four similarity graphs;
- the reference keeps exactly ``int(E*(1-p))`` edges via randperm; here,
  as in the JAX package, iid Bernoulli(1-p) per edge;
- feature noise adds ``feature_noise_scale`` Gaussian noise to the
  embeddings and ``sim_noise_scale`` noise to the similarity rows.

Inputs stacked over folds (sharding/foldstack.py) get stacked draws:
each draw is one call that makes the whole (F, ...) tensor, so no two
folds share a mask or a noise tensor.

The slabbed and grouped encoder graphs (graph/slabbed.py, graph/grouped.py)
drop edges by a stateless PRF of (salt, physical edge id),
``prf_keep_mask``, so that a relation's forward and transposed layouts drop
the same edges: the draw is two salts per rating
(``edge_dropout_masks_grouped``), and the masks are applied to the layouts'
weights (``prf_mask_pair``).  The padded-COO encoder graph
(graph/bipartite_coo.py) draws one Bernoulli keep mask per relation and
direction over its padded edges (``edge_dropout_masks_coo``), which the
GCMC layer multiplies into ``val``.  Identity ``CooGraph`` similarity
graphs drop entries of ``val``.

``feature_masking`` and ``mixup_features`` are here for the loader-side
feature augmentation of novel predictions (data/loader.py
``augment_features``); their dispatch inside the training step, and the
methods add_random_edges and graph_noise, are still to be ported
(ROADMAP.md queue A, item 4).
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

# The encoder layouts whose edge dropout is the PRF of physical edge ids.
PRF_LAYOUTS = (BipartiteSlabbed, BipartiteGrouped)
GRAPH_FIELDS = ("drug_graph", "dis_graph", "drug_feature_graph",
                "dis_feature_graph")
FEATURE_FIELDS = ("drug_feat", "dis_feat", "drug_sim_feat", "dis_sim_feat")


def _bernoulli(gen, p: float, shape, device) -> torch.Tensor:
    return (torch.rand(shape, generator=gen, device=device) < p).to(
        torch.float32)


def edge_dropout_masks(gen, n_drug: int, n_dis: int, num_ratings: int,
                       rate: float, device,
                       folds: tuple = ()) -> Dict[str, torch.Tensor]:
    """Per-etype keep masks (*folds, R, n_drug, n_dis) for the encoder
    graph; forward and reverse relations drop independent edge sets
    (augmentation.py:35-62)."""
    shape = (*folds, num_ratings, n_drug, n_dis)
    return {"fwd": _bernoulli(gen, 1.0 - rate, shape, device),
            "rev": _bernoulli(gen, 1.0 - rate, shape, device)}


def edge_dropout_masks_coo(gen, graph: BipartiteCoo, rate: float):
    """Per-edge keep masks of a padded-COO encoder graph (masks.py:74-89):
    a tuple per direction of (E_pad,) Bernoulli(1 - rate) masks, one per
    relation, drawn rating by rating, forward before reverse."""
    fwd, rev = [], []
    for r in range(graph.num_ratings):
        for out, g in ((fwd, graph.fwd[r]), (rev, graph.rev[r])):
            out.append(_bernoulli(gen, 1.0 - rate, (g.e_pad,), g.val.device))
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
    edges, so the gradient stays exact.  The mask is drawn once per edge id
    and gathered per layout."""
    keep = prf_keep_mask(salt, torch.arange(pair.fwd.n_live,
                                            device=pair.fwd.val.device), rate)
    return dataclasses.replace(
        pair,
        fwd=dataclasses.replace(pair.fwd, val=pair.fwd.val
                                * keep[pair.fwd.edge_id.long()]),
        bwd=dataclasses.replace(pair.bwd, val=pair.bwd.val
                                * keep[pair.bwd.edge_id.long()]))


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
    return dataclasses.replace(
        graph,
        fwd=tuple(prf_mask_pair(p, s, rate) for p, s in
                  zip(graph.fwd, edge_masks["fwd_salts"])),
        rev=tuple(prf_mask_pair(p, s, rate) for p, s in
                  zip(graph.rev, edge_masks["rev_salts"])))


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
    311-337)."""
    return lam * x + (1.0 - lam) * x[perm]


def beta_sample(gen, alpha: float, device) -> torch.Tensor:
    """One Beta(alpha, alpha) draw as a float32 scalar tensor on
    ``device``: the inverse CDF (scipy's ``betaincinv``) of one uniform
    draw from ``gen``; torch's own Beta sampler takes no generator."""
    from scipy.special import betaincinv

    u = float(torch.rand((), generator=gen, device=device,
                         dtype=torch.float64))
    return torch.tensor(betaincinv(alpha, alpha, u), dtype=torch.float32,
                        device=device)


def mixup_features(gen, x: torch.Tensor, alpha: float) -> torch.Tensor:
    """Row mixup with a Beta(alpha, alpha) coefficient (JAX masks.py:199):
    a permutation of the rows, then the coefficient, both from ``gen``."""
    perm = torch.randperm(x.shape[0], generator=gen, device=x.device)
    return mix_rows(x, perm, beta_sample(gen, alpha, x.device))


def draw_augment(gen, inputs, cfg: AugmentConfig, num_ratings: int = 2):
    """Draw one step's augmentation randomness from ``gen``.

    Returns a dict: 'edge_masks' (the encoder's fwd/rev keep masks),
    one keep mask per similarity graph under its field name, and one
    standard-normal noise tensor per feature field under its name.
    """
    draws = {}
    for method in cfg.methods:
        if method == "edge_dropout":
            enc = inputs.enc_graph
            if isinstance(enc, BipartiteGraph):
                draws["edge_masks"] = edge_dropout_masks(
                    gen, enc.n_drug, enc.n_dis, num_ratings,
                    cfg.edge_dropout_rate, enc.a1.device,
                    folds=tuple(enc.a1.shape[:-2]))
            elif isinstance(enc, PRF_LAYOUTS):
                draws["edge_masks"] = edge_dropout_masks_grouped(
                    gen, enc, cfg.edge_dropout_rate)
            elif isinstance(enc, BipartiteCoo):
                draws["edge_masks"] = edge_dropout_masks_coo(
                    gen, enc, cfg.edge_dropout_rate)
            else:
                raise NotImplementedError(
                    f"edge dropout on {type(enc).__name__} is not ported yet "
                    f"(ROADMAP.md queue A, item 10)")
            for field in GRAPH_FIELDS:
                g = getattr(inputs, field)
                if g is not None:
                    w = g.val if isinstance(g, CooGraph) else g.a
                    draws[field] = _bernoulli(gen, 1.0 - cfg.edge_dropout_rate,
                                              w.shape, w.device)
        elif method == "feature_noise":
            for field in FEATURE_FIELDS:
                x = getattr(inputs, field)
                draws[field] = torch.randn(x.shape, generator=gen,
                                           device=x.device, dtype=x.dtype)
        elif method in ("add_random_edges", "graph_noise", "feature_masking",
                        "mix_up"):
            raise NotImplementedError(
                f"augmentation {method!r} is not ported yet (ROADMAP.md "
                f"queue A, item 4: the other augment methods)")
        else:
            raise ValueError(f"unknown augmentation method {method!r}")
    return draws


def apply_augment(inputs, draws, cfg: AugmentConfig):
    """Apply drawn augmentation; returns (ModelInputs, edge_masks or None)
    as the JAX ``augment_inputs`` does (masks.py:207-297)."""
    upd = {}
    for field in GRAPH_FIELDS:
        if field in draws:
            upd[field] = sparse_edge_dropout(getattr(inputs, field),
                                             draws[field])
    for field in FEATURE_FIELDS:
        if field in draws:
            scale = (cfg.feature_noise_scale if field in ("drug_feat",
                                                          "dis_feat")
                     else cfg.sim_noise_scale)
            upd[field] = feature_noise(getattr(inputs, field), draws[field],
                                       scale)
    out = dataclasses.replace(inputs, **upd) if upd else inputs
    return out, draws.get("edge_masks")


def augment_inputs(gen, inputs, cfg: AugmentConfig, num_ratings: int = 2):
    """Draw and apply the configured augmentation for one step.
    Returns (augmented ModelInputs, encoder edge_masks or None)."""
    return apply_augment(inputs, draw_augment(gen, inputs, cfg, num_ratings),
                         cfg)

"""Per-step stochastic augmentation as masks and noise.

Port of the dense methods of ``dream_gnn_tpu/augment/masks.py``: every
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

The other four methods (add_random_edges, graph_noise, feature_masking,
mix_up) are still to be ported (ROADMAP.md queue A, item 4).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from dream_gnn_tpu_torch.config import AugmentConfig
from dream_gnn_tpu_torch.graph.bipartite import BipartiteGraph
from dream_gnn_tpu_torch.graph.knn import NormAdj

GRAPH_FIELDS = ("drug_graph", "dis_graph", "drug_feature_graph",
                "dis_feature_graph")
FEATURE_FIELDS = ("drug_feat", "dis_feat", "drug_sim_feat", "dis_sim_feat")


def _bernoulli(gen, p: float, shape, device) -> torch.Tensor:
    return (torch.rand(shape, generator=gen, device=device) < p).to(
        torch.float32)


def edge_dropout_masks(gen, n_drug: int, n_dis: int, num_ratings: int,
                       rate: float, device) -> Dict[str, torch.Tensor]:
    """Per-etype keep masks (R, n_drug, n_dis) for the encoder graph;
    forward and reverse relations drop independent edge sets
    (augmentation.py:35-62)."""
    shape = (num_ratings, n_drug, n_dis)
    return {"fwd": _bernoulli(gen, 1.0 - rate, shape, device),
            "rev": _bernoulli(gen, 1.0 - rate, shape, device)}


def sparse_edge_dropout(adj: NormAdj, keep: torch.Tensor) -> NormAdj:
    """Drop entries of a similarity adjacency; kept entries retain their
    stale row-normalised values (augmentation.py:92-124)."""
    return NormAdj(a=adj.a * keep)


def feature_noise(x: torch.Tensor, noise: torch.Tensor,
                  scale: float) -> torch.Tensor:
    """Additive Gaussian noise (augmentation.py:208-241)."""
    return x + scale * noise


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
            if not isinstance(enc, BipartiteGraph):
                raise NotImplementedError(
                    f"edge dropout on {type(enc).__name__} is not ported yet "
                    f"(ROADMAP.md queue A, items 7, 8 and 10)")
            draws["edge_masks"] = edge_dropout_masks(
                gen, enc.n_drug, enc.n_dis, num_ratings,
                cfg.edge_dropout_rate, enc.a1.device)
            for field in GRAPH_FIELDS:
                g = getattr(inputs, field)
                if g is not None:
                    draws[field] = _bernoulli(gen, 1.0 - cfg.edge_dropout_rate,
                                              g.a.shape, g.a.device)
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

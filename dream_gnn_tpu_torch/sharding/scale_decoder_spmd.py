"""The candidate-sharded scale decoder.

Port of ``dream_gnn_tpu/sharding/scale_decoder_spmd.py``: the candidate
list splits into S contiguous chunks of ``ceil(E / S)``, one a rank, and
every rank runs the scale decoder's kernels (kernels/scale_decoder.py: K2,
B1, the mirror, and the grouped SpMM for its two table scatters, as a
layout built with ``build_seq=False`` has) on its own chunk, against the
node projection tables and the MLP weights, which are replicated.  They
enter through ``replicated_in``, so the backward sums each rank's partial
table and weight gradients over the ranks: the collectives of the JAX
package's ``shard_map`` transpose (:12-19 there), written out.  The logits
stay sharded: each rank holds its chunk's, in its slot order.

Every rank's layout is padded to ``chunk`` slots (``rank_pad``; the last
chunk may hold fewer candidates), and its candidate ids are global (chunk
base + index; the padding's is E), so the PRF dropout draws the unsharded
decoder's masks bit for bit and ``slot_labels`` reads the global label
vector.  ``global_slot`` takes each candidate to its row in the
(S * n_pos) vector of every rank's logits in rank order, which ``gather``
all-gathers for an evaluation.

The layout of a rank is planned from the whole candidate list, the same way
on every rank; a layout built or applied without an initialised process
group raises.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dream_gnn_tpu_torch.kernels.grid_decoder import (dropout_seeds,
                                                      node_projections)
from dream_gnn_tpu_torch.kernels.scale_decoder import (
    ScaleDecoderLayout, build_scale_decoder_layout, scale_decoder)
from dream_gnn_tpu_torch.sharding.collectives import (all_gather_raw,
                                                       replicated_in,
                                                       require_group)
from dream_gnn_tpu_torch.utils.device import as_tensor


@dataclasses.dataclass(frozen=True)
class ShardedScaleDecoderLayout:
    """This rank's ``ScaleDecoderLayout`` of its candidate chunk.  ``mesh``
    and ``axis`` are kept from the build (None for a layout planned over
    the default group), so that the model can route a ``dec_layout`` of
    this type (model/dream_gnn.py)."""

    layout: ScaleDecoderLayout
    chunk: int
    n_edges_: int
    n_shards: int
    global_slot_: torch.Tensor       # (E,) candidate -> sharded logit row
    group: object
    mesh: object = None
    axis: str | None = None

    @property
    def n_pos(self) -> int:
        """Slots per rank."""
        return self.layout.n_pos

    @property
    def n_edges(self) -> int:
        return self.n_edges_

    def slot_labels(self, labels):
        """(labels, weights) of this rank's slots from the global
        per-candidate label vector; padding slots weigh 0."""
        return self.layout.slot_labels(labels)

    def global_slot(self) -> np.ndarray:
        """(E,) physical candidate -> row in the flattened (S * n_pos)
        sharded logit vector (eval-only unscramble)."""
        return self.global_slot_.cpu().numpy().astype(np.int32)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's per-slot vector (n_pos,) -> the (E,) per-candidate
        vector, on every rank; no gradient."""
        full = all_gather_raw(x.detach().contiguous(), self.group)
        return full[self.global_slot_.to(full.device)]


def _group(mesh, axis):
    if mesh is None:
        return require_group()
    require_group()
    return mesh.group(axis)


def build_scale_decoder_layout_sharded(
        dec_src, dec_dst, n_drug: int, n_dis: int, n_shards: int,
        mesh=None, axis: str | None = None,
        device=None) -> ShardedScaleDecoderLayout:
    """This rank's layout of ``n_shards`` contiguous candidate chunks, over
    ``mesh[axis]`` or, without a mesh, the default group
    (scale_decoder_spmd.py:120-202 of the JAX package)."""
    e = len(dec_src)
    if e < n_shards:
        raise ValueError(f"{e} candidates < {n_shards} shards")
    chunk = -(-e // n_shards)
    # Ceil-chunking can strand a shard with ZERO candidates even when
    # e >= n_shards (e=5, n_shards=4 -> chunks 2,2,1,0), and an empty
    # chunk crashes deep inside _stream_layout.  Reject it up front.
    if (n_shards - 1) * chunk >= e:
        raise ValueError(
            f"ceil-chunking {e} candidates over {n_shards} shards leaves "
            f"the last shard empty (chunk={chunk}); use fewer shards "
            f"(need e > (n_shards-1)*ceil(e/n_shards))")
    group = _group(mesh, axis)
    src = as_tensor(dec_src, torch.int64, device)
    dst = as_tensor(dec_dst, torch.int64, src.device)
    if torch.distributed.get_world_size(group) != n_shards:
        raise ValueError(f"{n_shards} shards over "
                         f"{torch.distributed.get_world_size(group)} ranks")
    shard = torch.distributed.get_rank(group)

    # Every chunk's forward slots, padded as its rank pads them: the
    # candidates' rows in the sharded logit vector.
    slots = []
    for s in range(n_shards):
        part = src[s * chunk:(s + 1) * chunk]
        padded = torch.cat([part, part.new_zeros(chunk - part.shape[0])])
        inv = torch.empty_like(padded)
        inv[torch.argsort(padded, stable=True)] = torch.arange(
            chunk, device=padded.device)
        slots.append(inv[:part.shape[0]] + s * chunk)

    lo, hi = shard * chunk, min(e, (shard + 1) * chunk)
    lay = build_scale_decoder_layout(src[lo:hi], dst[lo:hi], n_drug, n_dis,
                                     rank_pad=chunk, build_seq=False)

    def globalise(eid):
        # Chunk-local ids to global ones; the padding's (hi - lo) to e.
        eid = eid.long()
        return torch.where(eid < hi - lo, eid + lo, e).int()

    lay = dataclasses.replace(lay, fwd_eid=globalise(lay.fwd_eid),
                              mirror_eid=globalise(lay.mirror_eid))
    return ShardedScaleDecoderLayout(
        layout=lay, chunk=chunk, n_edges_=e, n_shards=n_shards,
        global_slot_=torch.cat(slots), group=group, mesh=mesh, axis=axis)


def scale_decoder_spmd(mesh, axis: str, slay: ShardedScaleDecoderLayout,
                       proj_drug, proj_dis, b1, w2, b2, w3, b3, seed, *,
                       rate: float, train: bool, dtype=torch.bfloat16):
    """This rank's (n_pos,) logits.  Tables and weights enter replicated,
    so the gradients through this equal the unsharded ``scale_decoder``'s
    (the same PRF dropout masks: global candidate ids ride in the
    layout)."""
    group = _group(mesh, axis)
    tensors = [replicated_in(t, group)
               for t in (proj_drug, proj_dis, b1, w2, b2, w3, b3)]
    return scale_decoder(*tensors, slay.layout, seed, rate, train, dtype)


def decoder_apply_scale_spmd(params, slay: ShardedScaleDecoderLayout,
                             drug_feat, dis_feat, mesh, axis: str, *,
                             dropout_rate: float, train: bool = False,
                             generator=None, dtype=torch.bfloat16):
    """Sharded counterpart of ``decoder_apply_scale``: node projections,
    replicated (every rank computes the same), then this rank's chunk
    through the kernels.  Returns this rank's (n_pos,) slot-order logits;
    pair them with ``slay.slot_labels``, or ``slay.gather`` them."""
    proj_drug, proj_dis = node_projections(params, drug_feat, dis_feat, dtype)
    seed = dropout_seeds(1, proj_drug.device, dropout_rate, train, generator)
    return scale_decoder_spmd(
        mesh, axis, slay, proj_drug, proj_dis, params["b1"], params["w2"],
        params["b2"], params["w3"][:, 0], params["b3"], seed,
        rate=dropout_rate, train=train, dtype=dtype)

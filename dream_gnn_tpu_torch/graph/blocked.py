"""The blocked encoder layout, in a GPU layout.

Port of ``dream_gnn_tpu/graph/blocked.py``, with its builder entry points,
their arguments and its constants.  The JAX package sorts each relation's
edges by (dst tile, src tile) and chops them into chunks of ``EDGE_CHUNK``
edges, so that the TPU kernel's one-hot MXU gathers and scatters read
VMEM-resident 512-row tiles (blocked.py:1-14).  That geometry has no
counterpart on the card: here each relation and direction is the
dst-sorted CSR of graph/csr.py, as for the grouped and slabbed layouts.
Zero-weight edges, among them a ``CooGraph``'s padding, are dropped, as
the JAX builder drops them (blocked.py:88-89).

``use_native`` (the JAX package's host C++ builder, graph/native.py and
native/blocked_builder.cc) is accepted and unused: the layout is built
with torch on the run's device.  ``TILE_SRC``, ``TILE_DST`` and
``EDGE_CHUNK`` are kept because callers import them.
"""

from __future__ import annotations

import dataclasses

from dream_gnn_tpu_torch.graph.coo import CooGraph
from dream_gnn_tpu_torch.graph.csr import CsrLayout, csr_fields

TILE_SRC = 512
TILE_DST = 512
EDGE_CHUNK = 2048


@dataclasses.dataclass(frozen=True)
class BlockedCoo(CsrLayout):
    """One direction of one relation: a dst-sorted CSR (graph/csr.py)."""


@dataclasses.dataclass(frozen=True)
class BlockedCooPair:
    """A relation's forward layout and its transpose (the backward's)."""

    fwd: BlockedCoo
    bwd: BlockedCoo


def blocked_from_arrays(src, dst, val, n_src: int, n_dst: int,
                        use_native: bool = True, device=None) -> BlockedCoo:
    """The dst-sorted CSR of edges (src, dst, val); zero-weight edges are
    dropped."""
    return BlockedCoo(**csr_fields(src, dst, val, n_src, n_dst, device))


def blocked_from_coo(g: CooGraph) -> BlockedCoo:
    """The layout of a ``CooGraph``, on its device."""
    return blocked_from_arrays(g.src, g.dst, g.val, g.n_src, g.n_dst)


def blocked_pair_from_arrays(src, dst, val, n_src: int, n_dst: int,
                             device=None) -> BlockedCooPair:
    return BlockedCooPair(
        fwd=blocked_from_arrays(src, dst, val, n_src, n_dst, device=device),
        bwd=blocked_from_arrays(dst, src, val, n_dst, n_src, device=device))


def blocked_pair_from_coo(g: CooGraph) -> BlockedCooPair:
    return blocked_pair_from_arrays(g.src, g.dst, g.val, g.n_src, g.n_dst)

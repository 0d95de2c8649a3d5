"""A rank grid over the default process group.

Port of ``dream_gnn_tpu/sharding/mesh.py``.  The JAX package's mesh lays
devices out on two axes, ``dp`` (folds or seeds, data parallel) and ``mp``
(the node or edge dimension of the scale path's layouts).  Here a rank is
a process of ``torch.distributed`` with one device, and a mesh lays the
first ``dp * mp`` ranks of the default group out as a (dp, mp) grid, rank
order row-major, with one process group per axis: the ranks along that axis
that share this rank's other coordinate.  The sharded scale path uses the
``dp`` axis (scripts/bench_scale.py:79 of the JAX package); the
fold-parallel step on a dp x mp grid uses both.
"""

from __future__ import annotations

import numpy as np
import torch.distributed as dist

from dream_gnn_tpu_torch.sharding.collectives import require_group
from dream_gnn_tpu_torch.utils import draws

AXES = ("dp", "mp")


class Mesh:
    """A (dp, mp) grid of global ranks and this rank's group along each
    axis (None on a rank outside the grid)."""

    def __init__(self, ranks: np.ndarray, groups: dict):
        self.ranks = ranks
        self.groups = groups
        self.shape = dict(zip(AXES, ranks.shape))

    @property
    def contains_me(self) -> bool:
        return dist.get_rank() < self.ranks.size

    def group(self, axis: str):
        """This rank's process group along ``axis``."""
        if not self.contains_me:
            raise ValueError(f"rank {dist.get_rank()} is outside the "
                             f"{self.shape} mesh")
        return self.groups[axis]

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        return dist.get_rank(self.group(axis))

    def fold_draws(self, n_local: int):
        """The context in which a rank holding ``n_local`` folds of a stack
        sharded over ``dp`` draws the whole stack's randomness and keeps
        its folds' (utils/draws.py)."""
        return draws.fold_block(self.shape["dp"] * n_local,
                                self.index("dp") * n_local, n_local)


def _axis_groups(ranks: np.ndarray, axis: int):
    """One group per line of ``ranks`` along ``axis``, created on every
    rank in the same order (``new_group`` is collective); returns this
    rank's."""
    me, world = dist.get_rank(), dist.get_world_size()
    mine = None
    lines = np.moveaxis(ranks, axis, -1).reshape(-1, ranks.shape[axis])
    for line in lines:
        members = [int(r) for r in line]
        group = dist.group.WORLD if members == list(range(world)) \
            else dist.new_group(members)
        if me in members:
            mine = group
    return mine


def make_mesh(dp: int | None = None, mp: int = 1) -> Mesh:
    """The (dp, mp) grid of the first dp * mp ranks; ``dp`` defaults to
    world size // mp.  Every rank of the default group must call it."""
    require_group()
    n = dist.get_world_size()
    if dp is None:
        dp = n // mp
    need = dp * mp
    if need > n:
        raise ValueError(f"mesh {dp}x{mp} needs {need} devices, have {n}")
    ranks = np.arange(need).reshape(dp, mp)
    return Mesh(ranks, {"dp": _axis_groups(ranks, 0),
                        "mp": _axis_groups(ranks, 1)})

"""The collectives of the sharded scale path, with their backward passes.

The JAX package runs its sharded layouts inside ``shard_map`` on one
controller, and the transpose of ``shard_map`` supplies the collectives of
the backward pass: an ``all_gather`` transposes to a ``reduce_scatter``
(scale_graph.py:14-16 there), a ``ppermute`` to the reverse permutation, and
the cotangent of an input that enters replicated is ``psum``-reduced
(scale_decoder_spmd.py:12-19).  ``torch.distributed`` runs one process per
rank, so here each pair is an autograd function:

- ``all_gather_rows``: forward the halo all-gather of row blocks, backward
  the reduce-scatter of the partial cotangents (edge_partition.py:113-114);
- ``ring_shift``: forward the ``ppermute`` of scale_graph.py:318 (rank i
  sends to (i - 1) % S), backward the reverse ring;
- ``replicated_in``: forward the identity, backward an all-reduce: a
  replicated table or weight entering a sharded region, whose cotangent
  each rank holds a part of (scale_decoder_spmd.py:216-218);
- ``sum_ranks``: forward an all-reduce, backward the identity: the global
  sums of the sharded decoder's loss;
- ``broadcast_first_``: no gradient; the step's replicated gradients made
  the group's first rank's bits on every rank (train/step.py);
- ``RowBlock.shard_rows`` and ``RowBlock.gather``: the boundary between a
  row-sharded region (each rank holds one block of ``ceil(n / S)`` rows of
  an ``(n, ...)`` array) and replicated compute (each rank holds all of it,
  the same on every rank).  ``shard_rows`` takes this rank's block, and its
  backward all-gathers the blocks' cotangents; ``gather`` all-gathers the
  blocks, and its backward takes this rank's block of the replicated
  cotangent.

Each gradient is summed exactly once: a partial cotangent crosses a
reduction (reduce-scatter or all-reduce) on its way out of the sharded
region, a replicated one never does.

Transport.  NCCL takes CUDA tensors, one rank a card.  Gloo is how ranks
that share one card talk: it takes CUDA tensors for its collectives
(all-gather, reduce-scatter, all-reduce), but not for its point-to-point
ops, which the PyTorch docs list as CPU-only and which on an H100 close
the connection (PERF.md §5).  So with gloo the ring's sends and receives of
CUDA tensors go through pinned host buffers, here and nowhere else.
``transport(group)`` names what a run uses.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

# torch 2.13 renames the two tensor collectives; older releases have only the
# old names.
_all_gather_tensor = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_reduce_scatter_tensor = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


def require_group(group=None):
    """``group``, or the default group; raises when no process group is
    initialised (a sharded layout has no single-process fallback)."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "the sharded scale path needs an initialised process group: call "
            "sharding.multihost.initialize (or spawn) first")
    return dist.group.WORLD if group is None else group


def _staged(x: torch.Tensor, group) -> bool:
    """Whether a point-to-point op stages ``x`` through the host."""
    return x.is_cuda and dist.get_backend(group) == "gloo"


def transport(group=None) -> str:
    """What the group's collectives carry: CUDA tensors over NCCL, host
    tensors over gloo, or CUDA tensors over gloo with the point-to-point
    ops staged through pinned host buffers."""
    backend = dist.get_backend(require_group(group))
    if backend == "gloo" and torch.cuda.is_available():
        return ("gloo (CUDA tensors; the ring's point-to-point ops staged "
                "through pinned host buffers)")
    return backend


def all_gather_raw(x: torch.Tensor, group) -> torch.Tensor:
    """(S * r, ...) from every rank's (r, ...) block, in rank order; no
    gradient."""
    s = dist.get_world_size(group)
    out = x.new_empty((s * x.shape[0], *x.shape[1:]))
    _all_gather_tensor(out, x.contiguous(), group=group)
    return out


def reduce_scatter_raw(x: torch.Tensor, group) -> torch.Tensor:
    """This rank's (r, ...) block of the sum over ranks of (S * r, ...);
    no gradient."""
    s = dist.get_world_size(group)
    out = x.new_empty((x.shape[0] // s, *x.shape[1:]))
    _reduce_scatter_tensor(out, x.contiguous(), group=group)
    return out


def all_reduce_raw(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ranks of ``x``, a new tensor; no gradient."""
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=group)
    return out


def _shift_raw(x: torch.Tensor, group, step: int) -> torch.Tensor:
    """Rank i's ``x`` to rank (i - step) % S; returns what rank
    (i + step) % S sent."""
    s = dist.get_world_size(group)
    if s == 1:
        return x.clone()
    me = dist.get_rank(group)
    staged = _staged(x, group)
    send = x.contiguous()
    if staged:
        send = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        send.copy_(x)
    recv = torch.empty(x.shape, dtype=x.dtype, pin_memory=True) if staged \
        else torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send,
                      dist.get_global_rank(group, (me - step) % s), group),
           dist.P2POp(dist.irecv, recv,
                      dist.get_global_rank(group, (me + step) % s), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv.to(x.device) if staged else recv


def broadcast_first_(tensors, group) -> None:
    """Every rank's ``tensors`` set in place to the group's first rank's:
    one broadcast of the flattened tensors.  Nothing at one rank."""
    if dist.get_world_size(group) == 1 or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.broadcast(flat, src=dist.get_global_rank(group, 0), group=group)
    for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(part.view_as(t))


def replica_spread(tensors, group) -> list:
    """For each tensor that every rank of ``group`` holds a copy of, the
    largest |x_r - x_0| over the ranks r and the elements (x_0 the group's
    first rank's copy), on every rank; 0.0 where all copies are the same
    bits (up to the sign of a zero).  One all-gather of the flattened
    tensors."""
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    every = all_gather_raw(flat, group).view(-1, flat.numel())
    spread = (every - every[:1]).abs().amax(0)
    return [float(x.max()) if x.numel() else 0.0
            for x in spread.split([t.numel() for t in tensors])]


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_gather_raw(x, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_raw(g, ctx.group), None


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """The halo exchange: every rank's (r, ...) block gathered into
    (S * r, ...), in rank order.  The gathered rows feed this rank's own
    computation only, so the backward sums the ranks' partial cotangents
    and hands each rank its block (a reduce-scatter)."""
    return _AllGatherRows.apply(x, group)


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _shift_raw(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return _shift_raw(g, ctx.group, -1), None


def ring_shift(x: torch.Tensor, group) -> torch.Tensor:
    """One ring step: rank i sends ``x`` to rank (i - 1) % S and returns
    the block of rank (i + 1) % S (the permutation (i, (i - 1) % S) of
    scale_graph.py:318); the backward sends each cotangent back the other
    way round.  At one rank it is the identity."""
    return _RingShift.apply(x, group)


class _ReplicatedIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_raw(g, ctx.group), None


def replicated_in(x: torch.Tensor, group) -> torch.Tensor:
    """A replicated tensor entering a sharded region: the identity, whose
    backward sums each rank's partial cotangent over the ranks."""
    return _ReplicatedIn.apply(x, group)


class _SumRanks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_raw(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def sum_ranks(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ranks of each rank's partial ``x`` (a local sum); the
    result is replicated, and each rank's cotangent of its own part is the
    result's."""
    return _SumRanks.apply(x, group)


class RowBlock:
    """This rank's block of the rows of an (n, ...) array sharded over the
    S ranks of ``group``: rows [shard * rows, (shard + 1) * rows) of the
    array padded to S * rows, rows = ceil(n / S), as the JAX package pads
    a row-sharded operand (edge_partition.py:102-104)."""

    def __init__(self, n: int, group):
        self.n = n
        self.group = group
        self.n_shards = dist.get_world_size(group)
        self.shard = dist.get_rank(group)
        self.rows = -(-n // self.n_shards)
        self.lo = self.shard * self.rows

    def block(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of a full (n, ...) tensor, zero-padded; a plain
        slice (norms, masks)."""
        hi = min(self.lo + self.rows, self.n)
        part = x[self.lo:hi] if self.lo < self.n else x[:0]
        if part.shape[0] == self.rows:
            return part
        pad = x.new_zeros((self.rows - part.shape[0], *x.shape[1:]))
        return torch.cat([part, pad])

    def shard_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Replicated (n, ...) -> this rank's block; the backward gathers
        the blocks' cotangents into the replicated one."""
        return _ShardRows.apply(x, self)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's block -> the replicated (n, ...) tensor; the
        backward takes this rank's block of the replicated cotangent."""
        return _GatherRows.apply(x, self)

    def dropout(self, gen, x: torch.Tensor, rate: float,
                train: bool) -> torch.Tensor:
        """Inverted dropout of this rank's block ``x``: the mask is drawn
        for all n rows, as the unsharded layer draws it from ``gen``, and
        this rank's block of it is kept, so every rank count draws the same
        masks."""
        if not train or rate <= 0.0:
            return x
        keep = 1.0 - rate
        mask = torch.rand((self.n, *x.shape[1:]), generator=gen,
                          device=x.device) < keep
        return torch.where(self.block(mask), x / keep, torch.zeros_like(x))


class _ShardRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rb):
        ctx.rb = rb
        return rb.block(x)

    @staticmethod
    def backward(ctx, g):
        rb = ctx.rb
        return all_gather_raw(g.contiguous(), rb.group)[:rb.n], None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rb):
        ctx.rb = rb
        return all_gather_raw(x, rb.group)[:rb.n]

    @staticmethod
    def backward(ctx, g):
        return ctx.rb.block(g), None

"""Fused per-edge MLP decoder: a hand-written CUDA kernel and its plain
PyTorch version, for one fold or a stack of F folds.

Replaces the Pallas TPU kernels ``_fwd_kernel`` / ``_bwd_kernel`` of
``dream_gnn_tpu/kernels/pallas_decoder.py`` (``fused_decoder``) and of
``dream_gnn_tpu/kernels/pallas_decoder_batched.py``
(``fused_decoder_batched``).  For every candidate edge e, with
i = src[e] and j = dst[e], of every fold, it computes

    a1 = rnd(Pd[i]) + rnd(Pv[j]) + b1;   h1d = relu(a1) * m1
    a2 = rnd(h1d) @ rnd(w2) + b2;        h2d = relu(a2) * m2
    out[e] = h2d . w3 + b3

where ``rnd`` rounds to bf16 when ``dtype`` is bf16, at the points of the
Pallas kernels: the node tables round before the gather
(pallas_decoder.py:107-108), and the backward sums rnd(da1) into dPd and
dPv (:164-167), rnd(g) * rnd(h2d) into dw3 (:149) and rnd(h1d)^T rnd(da2)
into dW2 (:155).  The grid decoder (kernels/grid_decoder.py) does not round
its tables, and ``nn.decoder.decoder_apply`` rounds only matrix operands,
so each of the three is held to its own counterpart.

Dropout masks are the grid decoder's stateless hash of
``(seed, layer, src[e], dst[e], unit)``: an edge draws the masks of grid
cell ``[src[e], dst[e]]``, whatever the tiling, and fold f of a batched
call draws those of a single-fold call with ``seed[f]``.  A pair listed
twice draws one mask for both; the loader's candidate pairs are unique.

The forward and the backward run their products on the tensor cores in
bf16 (``edge_fwd_mma_kernel``, ``edge_bwd_mma_kernel``) and on the CUDA
cores in fp32, where TF32 would round what the fp32 Pallas kernel does
not.  The backward is one pass that sums the edges' rnd(da1) rows into dPd
and dPv where it forms them, without atomics and without a per-edge
buffer: it walks each fold's edges by 32-disease column block, and within
one by drug (``EdgeOrder``), so that a block holds its column block's dPv
rows and writes a drug's dPd row when the drug's run ends.  Its partials,
(F, ceil(Nv / 32), Nd, 128) for dPd, a few (F, Nv, 128) for dPv and the
weight slabs, are summed here in a fixed order.  The ordering is index
preparation for a fixed edge list: ``edge_order`` builds it with torch
ops, and the trainer builds it once per fold (``ModelInputs.dec_order``).
Its sums follow that order, not list order: the node gradients match the
plain version's list-order ``scatter_add_`` up to f32 rounding.

Dispatch.  ``fused_decoder`` and ``fused_decoder_batched`` run the kernels
for CUDA tensors and the plain version only for CPU tensors; there is no
fallback from one to the other.  ``LAUNCHES`` counts kernel launches:
``fwd``/``bwd`` single-fold, ``fwd_b``/``bwd_b`` batched.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch

from dream_gnn_tpu_torch.kernels import cuda_build
from dream_gnn_tpu_torch.kernels.grid_decoder import (
    H1, H2, check_inputs, drop_args, dropout_seeds, hash_bits, keep_scale,
    keep_threshold, node_projections, occupancy, round_to, stream_ptr)
from dream_gnn_tpu_torch.utils.profiling import span

LAUNCHES = {"fwd": 0, "bwd": 0, "fwd_b": 0, "bwd_b": 0}

_lib = None


# ---------------------------------------------------------------------------
# Index preparation: the edges of a list ordered by column block and drug.

COL_BLOCK = 32      # diseases of a column block: the Pv rows a block stages
TILE = 128          # edges of a backward tile
BWD_SLOTS = 132     # backward blocks of a wave: one an SM (decoder_common.cuh)


def wave_split(max_split: int, per_split: int, slots: int = BWD_SLOTS,
               least: float = 15 / 16) -> int:
    """The smallest split (at most ``max_split``) whose ``per_split *
    split`` blocks fill their waves of ``slots`` to at least ``least``,
    else the split that fills best: csrc/decoder_common.cuh's
    ``wave_split``, there with ``least`` 15/16."""
    best, best_fill = 1, 0.0
    for s in range(1, max_split + 1):
        blocks = per_split * s
        fill = blocks / (-(-blocks // slots) * slots)
        if fill >= least:
            return s
        if fill > best_fill:
            best, best_fill = s, fill
    return best


def order_parts(ne: int, nv: int) -> int:
    """Parts of each column block in the ordering of one list of ``ne``
    edges over ``nv`` diseases: what one fold alone needs to fill a wave,
    at most a column block's mean tile count.  A launch of F folds takes
    the parts in groups (``bwd_split``)."""
    n_cb = -(-nv // COL_BLOCK)
    return wave_split(max(1, -(-ne // (TILE * n_cb))), n_cb)


def bwd_split(nf: int, nv: int, n_part: int) -> int:
    """Blocks of a backward launch per fold and column block, each taking
    a contiguous group of its ``n_part`` parts: whole waves of one block an
    SM, filled to 63/64 or more where the parts allow: a block holds a
    column block's share of a fold, milliseconds at 100 folds, so the
    empty slots of a last wave idle the card for that long.  One fold of
    Gdataset's 167,168 edges takes 13 (130 blocks), 10 folds 13, 100
    folds 3 (3,000 blocks)."""
    return wave_split(n_part, nf * -(-nv // COL_BLOCK), least=63 / 64)


@dataclasses.dataclass(frozen=True)
class EdgeOrder:
    """An edge list (..., E), with an optional leading fold axis, in the
    order of the per-edge backward: by column block dst // 32, then by src,
    stable, so that a pair listed twice keeps its list order.

    ``perm[..., p]`` is the id of the edge at position p.  Column block c
    spans positions ``split_edge[..., c, 0] : split_edge[..., c, -1]`` and
    falls into P parts at ``split_edge[..., c, :]`` (P + 1 points); part s
    holds the whole runs of the drugs ``split_drug[..., c, s] ..
    split_drug[..., c, s + 1] - 1``, so that a part starts only where a
    drug's run starts and every (column block, drug) pair lies in one part.
    ``split_drug[..., c, 0]`` is 0 and ``split_drug[..., c, P]`` the drug
    count.  int32 throughout."""

    perm: torch.Tensor          # (..., E)
    split_edge: torch.Tensor    # (..., n_cb, P + 1)
    split_drug: torch.Tensor    # (..., n_cb, P + 1)

    @property
    def col_off(self) -> torch.Tensor:
        """(..., n_cb + 1): the first position of each column block, and E."""
        return torch.cat([self.split_edge[..., 0],
                          self.split_edge[..., -1:, -1]], dim=-1)


def edge_order(src: torch.Tensor, dst: torch.Tensor, nd: int,
               nv: int) -> EdgeOrder:
    """The ``EdgeOrder`` of edges (src, dst), shaped (E,) or (F, E), over
    nd drugs and nv diseases, with torch ops on their device.  Part s of a
    column block of n edges starts at the run of the drug at its position
    s * n // P."""
    src, dst = src.long(), dst.long()
    lead, ne = src.shape[:-1], src.shape[-1]
    n_cb, n_part = -(-nv // COL_BLOCK), order_parts(ne, nv)
    key = (dst // COL_BLOCK) * nd + src
    perm = torch.argsort(key, dim=-1, stable=True)
    keys = torch.gather(key, -1, perm).contiguous()

    def first_at(values):       # (..., n_cb, k) -> positions of the keys
        flat = values.expand(*lead, *values.shape[-2:]).reshape(*lead, -1)
        return torch.searchsorted(keys, flat.contiguous()).view(
            *lead, *values.shape[-2:])

    cb = torch.arange(n_cb, device=src.device)[:, None]
    lo, hi = first_at(cb * nd)[..., 0], first_at((cb + 1) * nd)[..., 0]
    s = torch.arange(1, n_part, device=src.device)
    at = lo[..., None] + (hi - lo)[..., None] * s // n_part
    drug = torch.gather(keys, -1, at.clamp(max=ne - 1).reshape(
        *lead, -1)).view(at.shape) - cb * nd
    drug = torch.where((hi > lo)[..., None], drug, 0)
    split_drug = torch.cat([torch.zeros_like(lo)[..., None], drug,
                            torch.full_like(lo, nd)[..., None]], dim=-1)
    split_edge = first_at(cb * nd + split_drug)
    return EdgeOrder(perm.int(), split_edge.int(), split_drug.int())


# ---------------------------------------------------------------------------
# Plain PyTorch version, written once for an optional leading fold axis:
# tables (..., N, H1), weights (..., H1, H2), biases (..., H), edges
# (..., 2, E), the seed (..., 1).  Per-edge intermediates are (..., E, H).

def _rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[..., idx, :] for idx (..., E): (..., E, H)."""
    return torch.take_along_dim(table, idx[..., None], dim=-2)


def edge_dropout_mask(seed: torch.Tensor, layer: int, src: torch.Tensor,
                      dst: torch.Tensor, h: int, rate: float) -> torch.Tensor:
    """f32 mask (..., E, h) with values 0 or 1/(1-rate): the grid mask of
    cell [src[e], dst[e]] for every edge e.  ``seed`` is (..., 1)."""
    k = torch.arange(h, device=src.device, dtype=torch.int64)
    s = seed.reshape(*seed.shape[:-1], 1, 1).to(torch.int64)
    bits = hash_bits(s, layer, src[..., None], dst[..., None], k)
    return (bits >= keep_threshold(rate)).to(torch.float32) * keep_scale(rate)


def _plain_parts(pd, pv, b1, w2, b2, edges, seed, rate, train, dtype):
    """(src, dst, a1, h1d, m1, a2, h2d, m2) over the edge list, as
    pallas_decoder._row_forward."""
    src, dst = edges[..., 0, :].long(), edges[..., 1, :].long()
    h1, h2 = w2.shape[-2:]
    use_drop = train and rate > 0.0
    a1 = (_rows(round_to(pd, dtype), src) + _rows(round_to(pv, dtype), dst)) \
        + b1[..., None, :]
    h1a = torch.relu(a1)
    m1 = edge_dropout_mask(seed, 1, src, dst, h1, rate) if use_drop else None
    h1d = h1a * m1 if use_drop else h1a
    a2 = torch.matmul(round_to(h1d, dtype), round_to(w2, dtype)) \
        + b2[..., None, :]
    h2a = torch.relu(a2)
    m2 = edge_dropout_mask(seed, 2, src, dst, h2, rate) if use_drop else None
    h2d = h2a * m2 if use_drop else h2a
    return src, dst, a1, h1d, m1, a2, h2d, m2


def edge_decoder_plain(pd, pv, b1, w2, b2, w3, edges, seed, rate: float,
                       train: bool, dtype=torch.bfloat16) -> torch.Tensor:
    """Forward of the kernel in plain PyTorch, without b3: (..., E) f32."""
    *_, h2d, _ = _plain_parts(pd, pv, b1, w2, b2, edges, seed, rate, train,
                              dtype)
    return torch.sum(h2d * w3[..., None, :], dim=-1)


def edge_decoder_plain_bwd(pd, pv, b1, w2, b2, w3, edges, seed, rate: float,
                           train: bool, dtype, g):
    """Explicit backward, step for step as the Pallas ``_bwd_kernel``.
    Returns (dpd, dpv, db1, dw2, db2, dw3)."""
    use_drop = train and rate > 0.0
    src, dst, a1, h1d, m1, a2, h2d, m2 = _plain_parts(
        pd, pv, b1, w2, b2, edges, seed, rate, train, dtype)
    g = g[..., None]
    dw3 = torch.matmul(round_to(g, dtype).mT, round_to(h2d, dtype))[..., 0, :]
    dh2 = g * w3[..., None, :]
    if use_drop:
        dh2 = dh2 * m2
    da2 = torch.where(a2 > 0.0, dh2, torch.zeros_like(dh2))
    dw2 = torch.matmul(round_to(h1d, dtype).mT, round_to(da2, dtype))
    dh1 = torch.matmul(round_to(da2, dtype), round_to(w2, dtype).mT)
    if use_drop:
        dh1 = dh1 * m1
    da1 = torch.where(a1 > 0.0, dh1, torch.zeros_like(dh1))
    da1r = round_to(da1, dtype)
    dpd = torch.zeros_like(pd).scatter_add_(
        -2, src[..., None].expand_as(da1r), da1r)
    dpv = torch.zeros_like(pv).scatter_add_(
        -2, dst[..., None].expand_as(da1r), da1r)
    return dpd, dpv, da1.sum(-2), dw2, da2.sum(-2), dw3


def edge_decoder_batched_plain(pd, pv, b1, w2, b2, w3, edges, seed,
                               rate: float, train: bool,
                               dtype=torch.bfloat16) -> torch.Tensor:
    """Forward of the batched kernel in plain PyTorch: the single-fold
    version over a leading fold axis, fold f with ``seed[f]``."""
    return edge_decoder_plain(pd, pv, b1, w2, b2, w3, edges, seed[:, None],
                              rate, train, dtype)


def edge_decoder_batched_plain_bwd(pd, pv, b1, w2, b2, w3, edges, seed,
                                   rate: float, train: bool, dtype, g):
    """Explicit backward of the batched version.  Returns (dpd, dpv, db1,
    dw2, db2, dw3), each with a leading fold axis."""
    return edge_decoder_plain_bwd(pd, pv, b1, w2, b2, w3, edges,
                                  seed[:, None], rate, train, dtype, g)


# ---------------------------------------------------------------------------
# The CUDA kernels: load, launch.

def _load():
    global _lib
    if _lib is None:
        lib = cuda_build.load("edge_decoder")
        p, i, u, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
                      ctypes.c_float)
        lib.edge_decoder_fwd.argtypes = [p] * 9 + [i, i, i, i, u, f, i, i, p]
        lib.edge_decoder_fwd.restype = i
        lib.edge_decoder_bwd.argtypes = [p] * 18 + [i] * 6 + [u, f, i, i, p]
        lib.edge_decoder_bwd.restype = i
        for kind in ("fwd", "bwd"):
            getattr(lib, f"edge_decoder_{kind}_occupancy").argtypes = [i, p]
            getattr(lib, f"edge_decoder_{kind}_occupancy").restype = i
        _lib = lib
    return _lib


def _check_edges(x, name, shape, dtype, dev):
    if x.device != dev or x.dtype != dtype or tuple(x.shape) != shape \
            or not x.is_contiguous():
        raise ValueError(f"edge decoder kernel: {name} must be a contiguous "
                         f"{dtype} {shape} tensor on {dev}, got {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}")


def _check(pd, pv, b1, w2, b2, w3, edges, seed, dtype, folds):
    check_inputs(pd, pv, b1, w2, b2, w3, seed, dtype, folds,
                 kernel="edge decoder kernel")
    ne = edges.shape[-1]
    _check_edges(edges, "edges", (*folds, 2, ne), torch.int32, pd.device)
    if ne < 1:
        raise ValueError("edge decoder kernel: the edge list is empty")
    return ne


def _launch_fwd(pd, pv, b1, w2, b2, w3, edges, seed, rate, train, dtype,
                folds):
    ne = _check(pd, pv, b1, w2, b2, w3, edges, seed, dtype, folds)
    lib = _load()
    out = torch.empty((*folds, ne), dtype=torch.float32, device=pd.device)
    ptrs = [x.data_ptr() for x in (pd, pv, b1, w2, b2, w3, edges, seed, out)]
    err = lib.edge_decoder_fwd(
        *ptrs, folds[0] if folds else 1, pd.shape[-2], pv.shape[-2], ne,
        *drop_args(rate, train), int(dtype == torch.bfloat16),
        stream_ptr(pd.device))
    if err != 0:
        raise RuntimeError(f"edge_decoder_fwd launch failed: CUDA error {err}")
    LAUNCHES["fwd_b" if folds else "fwd"] += 1
    return out


def _sum_parts(x: torch.Tensor, axis: int) -> torch.Tensor:
    """``x`` summed over its partial axis in a fixed order; a single
    partial is the sum itself."""
    return x.select(axis, 0) if x.shape[axis] == 1 else x.sum(axis)


def _launch_bwd(pd, pv, b1, w2, b2, w3, edges, seed, rate, train, dtype, g,
                order: Optional[EdgeOrder], folds):
    ne = _check(pd, pv, b1, w2, b2, w3, edges, seed, dtype, folds)
    nd, nv, dev = pd.shape[-2], pv.shape[-2], pd.device
    _check_edges(g, "g", (*folds, ne), torch.float32, dev)
    if order is None:
        order = edge_order(edges[..., 0, :], edges[..., 1, :], nd, nv)
    n_cb, n_part = -(-nv // COL_BLOCK), order.split_edge.shape[-1] - 1
    _check_edges(order.perm, "order.perm", (*folds, ne), torch.int32, dev)
    for name in ("split_edge", "split_drug"):
        _check_edges(getattr(order, name), f"order.{name}",
                     (*folds, n_cb, n_part + 1), torch.int32, dev)
    if n_part < 1:
        raise ValueError("edge decoder kernel: order.split_edge holds no part")
    lib = _load()
    nf = folds[0] if folds else 1
    n_split = bwd_split(nf, nv, n_part)
    kw = dict(dtype=torch.float32, device=dev)
    dpd = torch.empty((*folds, n_cb, nd, H1), **kw)
    dpv = torch.empty((*folds, n_split, nv, H1), **kw)
    slabs = [torch.empty((*folds, n_cb * n_split, *shape), **kw)
             for shape in ((H1,), (H1, H2), (H2,), (H2,))]
    ptrs = [x.data_ptr() for x in (
        pd, pv, b1, w2, b2, w3, edges, seed, g, order.perm, order.split_edge,
        order.split_drug, dpd, dpv, *slabs)]
    err = lib.edge_decoder_bwd(
        *ptrs, nf, nd, nv, ne, n_part, n_split, *drop_args(rate, train),
        int(dtype == torch.bfloat16), stream_ptr(dev))
    if err != 0:
        raise RuntimeError(f"edge_decoder_bwd launch failed: CUDA error {err}")
    LAUNCHES["bwd_b" if folds else "bwd"] += 1
    # Sum each partial over its block axis, in a fixed order.
    return tuple(_sum_parts(x, len(folds)) for x in (dpd, dpv, *slabs))


def fwd_occupancy(dtype) -> tuple:
    """(blocks, warps) of the ``dtype`` forward kernel resident on one SM
    of the current card, by CUDA's occupancy API."""
    return occupancy(_load(), "edge_decoder_fwd_occupancy", dtype)


def bwd_occupancy(dtype) -> tuple:
    """(blocks, warps) of the ``dtype`` backward kernel resident on one SM
    of the current card, by CUDA's occupancy API."""
    return occupancy(_load(), "edge_decoder_bwd_occupancy", dtype)


def launch_fwd(pd, pv, b1, w2, b2, w3, edges, seed, rate, train, dtype):
    """One forward launch over edges (2, E); returns (E,) f32 without b3."""
    return _launch_fwd(pd, pv, b1, w2, b2, w3, edges, seed, rate, train,
                       dtype, ())


def launch_bwd(pd, pv, b1, w2, b2, w3, edges, seed, rate, train, dtype, g,
               order=None):
    """One backward launch plus the sums over its partials; ``order`` the
    edges' ``edge_order``, built here when not given.  Returns (dpd, dpv,
    db1, dw2, db2, dw3)."""
    return _launch_bwd(pd, pv, b1, w2, b2, w3, edges, seed, rate, train,
                       dtype, g, order, ())


def launch_fwd_batched(pd, pv, b1, w2, b2, w3, edges, seed, rate, train,
                       dtype):
    """One batched forward launch over edges (F, 2, E); returns (F, E) f32
    without b3."""
    return _launch_fwd(pd, pv, b1, w2, b2, w3, edges, seed, rate, train,
                       dtype, (pd.shape[0],))


def launch_bwd_batched(pd, pv, b1, w2, b2, w3, edges, seed, rate, train,
                       dtype, g, order=None):
    """One batched backward launch plus the sums over its partials;
    ``order`` with a leading F.  Returns (dpd, dpv, db1, dw2, db2, dw3),
    each with a leading F."""
    return _launch_bwd(pd, pv, b1, w2, b2, w3, edges, seed, rate, train,
                       dtype, g, order, (pd.shape[0],))


class _FusedDecoder(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pd, pv, b1, w2, b2, w3, b3, edges, seed, rate, train,
                dtype, order, batched):
        ctx.save_for_backward(pd, pv, b1, w2, b2, w3, edges, seed)
        ctx.cfg = (rate, train, dtype, order, batched)
        if pd.is_cuda:
            launch = launch_fwd_batched if batched else launch_fwd
            out = launch(pd, pv, b1, w2, b2, w3, edges, seed, rate, train,
                         dtype)
        else:
            plain = edge_decoder_batched_plain if batched \
                else edge_decoder_plain
            out = plain(pd, pv, b1, w2, b2, w3, edges, seed, rate, train,
                        dtype)
        return out + (b3 if batched else b3[0])

    @staticmethod
    def backward(ctx, g):
        with span("decoder_bwd"):
            rate, train, dtype, order, batched = ctx.cfg
            args = (*ctx.saved_tensors, rate, train, dtype, g.contiguous())
            if g.is_cuda:
                launch = launch_bwd_batched if batched else launch_bwd
                grads = launch(*args, order)
            else:
                grads = (edge_decoder_batched_plain_bwd if batched
                         else edge_decoder_plain_bwd)(*args)
            # d/db3 (out + b3), outside the kernel
            db3 = g.sum(-1, keepdim=True)
            return (*grads, db3) + (None,) * 7


def fused_decoder(proj_drug, proj_dis, b1, w2, b2, w3, b3, edges, seed,
                  rate: float, train: bool, dtype=torch.bfloat16,
                  order: Optional[EdgeOrder] = None):
    """Per-edge decoder MLP, the contract of the JAX ``fused_decoder``
    (pallas_decoder.py:202).

    proj_drug (Nd, 128) f32, proj_dis (Nv, 128) f32, b1 (128,),
    w2 (128, 64), b2 (64,), w3 (64,), b3 (1,), edges (2, E) int32
    [src; dst] with src < Nd and dst < Nv (the kernels assert it on the
    device), seed (1,) int32 on the same device; ``order`` the edges'
    ``edge_order``, built in the backward when not given.  Returns (E,) f32
    logits.  CUDA tensors run the kernels, CPU tensors the plain version.
    """
    return _FusedDecoder.apply(
        proj_drug.contiguous(), proj_dis.contiguous(), b1.contiguous(),
        w2.contiguous(), b2.contiguous(), w3.contiguous(), b3,
        edges.contiguous(), seed, rate, train, dtype, order, False)


def fused_decoder_batched(proj_drug, proj_dis, b1, w2, b2, w3, b3, edges,
                          seed, rate: float, train: bool,
                          dtype=torch.bfloat16,
                          order: Optional[EdgeOrder] = None):
    """Fold-batched per-edge decoder MLP, the contract of the JAX
    ``fused_decoder_batched`` (pallas_decoder_batched.py:158).

    proj_drug (F, Nd, 128), proj_dis (F, Nv, 128), b1 (F, 128),
    w2 (F, 128, 64), b2 (F, 64), w3 (F, 64), b3 (F, 1), all f32,
    edges (F, 2, E) int32, seed (F,) int32, on one device; ``order`` with a
    leading F.  Returns (F, E) f32 logits.  CUDA tensors run one launch of
    each kernel, CPU tensors the plain version.
    """
    return _FusedDecoder.apply(
        proj_drug.contiguous(), proj_dis.contiguous(), b1.contiguous(),
        w2.contiguous(), b2.contiguous(), w3.contiguous(), b3,
        edges.contiguous(), seed, rate, train, dtype, order, True)


def decoder_apply_fused(params, edge_src, edge_dst, drug_feat, dis_feat, *,
                        dropout_rate: float, train: bool = False,
                        generator=None, dtype=torch.bfloat16,
                        order: Optional[EdgeOrder] = None):
    """Fused counterpart of ``nn.decoder.decoder_apply``
    (pallas_decoder.py:290-324): node projections in PyTorch, the per-edge
    MLP in the kernel.  Any node count is taken: the kernel gathers rows.
    Returns (E,) logits."""
    proj_drug, proj_dis = node_projections(params, drug_feat, dis_feat, dtype)
    edges = torch.stack([edge_src.int(), edge_dst.int()])
    seed = dropout_seeds(1, proj_drug.device, dropout_rate, train, generator)
    return fused_decoder(proj_drug, proj_dis, params["b1"], params["w2"],
                         params["b2"], params["w3"][:, 0], params["b3"],
                         edges, seed, dropout_rate, train, dtype, order)


def decoder_apply_fused_batched(params, edge_src, edge_dst, drug_feat,
                                dis_feat, *, dropout_rate: float,
                                train: bool = False, generator=None,
                                dtype=torch.bfloat16,
                                order: Optional[EdgeOrder] = None, mesh=None,
                                shard=None):
    """Fold-batched fused edge decode, the counterpart of the JAX
    ``decoder_apply_fused_batched`` (pallas_decoder_batched.py:310-363).
    Params leaves, ``edge_src``/``edge_dst`` (F, E) and features (F, N, d)
    carry a leading fold axis; the F dropout seeds come from one draw of
    ``generator``; ``order`` is the list's ``EdgeOrder``.  With a ``mesh`` they
    are this rank's folds, and the kernels run on ``shard``, the rank's
    ``EdgeShard`` of the edges over ``mp`` (sharding/decoder_spmd.py,
    built once by ``shard_edges``).  Returns (F, E) logits."""
    proj_drug, proj_dis = node_projections(params, drug_feat, dis_feat, dtype)
    seed = dropout_seeds(proj_drug.shape[0], proj_drug.device, dropout_rate,
                         train, generator)
    weights = (params["b1"], params["w2"], params["b2"],
               params["w3"][..., 0], params["b3"])
    if mesh is None:
        edges = torch.stack([edge_src.int(), edge_dst.int()], dim=1)
        return fused_decoder_batched(proj_drug, proj_dis, *weights, edges,
                                     seed, dropout_rate, train, dtype, order)
    if shard is None:
        raise ValueError("the fused edge decoder on a mesh runs on the "
                         "rank's EdgeShard: shard the stack with "
                         "sharding.partition.shard_stacked")
    from dream_gnn_tpu_torch.sharding.decoder_spmd import \
        fused_decoder_batched_spmd
    return fused_decoder_batched_spmd(mesh, proj_drug, proj_dis, *weights,
                                      shard, seed, dropout_rate, train, dtype)

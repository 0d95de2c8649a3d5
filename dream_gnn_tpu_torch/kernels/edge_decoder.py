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

The forward and the backward's first pass run their products on the
tensor cores in bf16 (``edge_fwd_mma_kernel``, ``edge_bwd_mma_kernel``)
and on the CUDA cores in fp32, where TF32 would round what the fp32 Pallas
kernel does not.  The backward's gradient scatter
into dPd and dPv runs without atomics: the first pass writes every edge's
rnd(da1) row to an (F, E, 128) buffer, and the second sums each node's
rows in list order over a CSR ordering of the edges by src and by dst
(``EdgeCSR``).  The CSR is index preparation for a fixed
edge list: ``edge_csr`` builds it with torch ops, and the trainer builds it
once per fold (``ModelInputs.dec_csr``).

Dispatch.  ``fused_decoder`` and ``fused_decoder_batched`` run the kernels
for CUDA tensors and the plain version only for CPU tensors; there is no
fallback from one to the other.  ``LAUNCHES`` counts kernel launches:
``fwd``/``bwd`` single-fold, ``fwd_b``/``bwd_b`` batched (a backward
launch is its two passes).
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
# Index preparation: the edges of a list grouped by drug and by disease.

@dataclasses.dataclass(frozen=True)
class EdgeCSR:
    """CSR orderings of an edge list (..., E) by src and by dst, with an
    optional leading fold axis.  ``src_perm[..., src_off[..., n] :
    src_off[..., n + 1]]`` are the ids of the edges with src n, in list
    order; likewise for dst.  int32 throughout."""

    src_perm: torch.Tensor     # (..., E)
    src_off: torch.Tensor      # (..., Nd + 1)
    dst_perm: torch.Tensor     # (..., E)
    dst_off: torch.Tensor      # (..., Nv + 1)


def _csr_side(idx: torch.Tensor, n: int):
    idx = idx.long()
    perm = torch.argsort(idx, dim=-1, stable=True)
    keys = torch.gather(idx, -1, perm).contiguous()
    bounds = torch.arange(n + 1, device=idx.device).expand(
        *idx.shape[:-1], n + 1).contiguous()
    off = torch.searchsorted(keys, bounds)
    return perm.int(), off.int()


def edge_csr(src: torch.Tensor, dst: torch.Tensor, nd: int,
             nv: int) -> EdgeCSR:
    """The CSR orderings of edges (src, dst), shaped (E,) or (F, E), over
    nd drugs and nv diseases."""
    src_perm, src_off = _csr_side(src, nd)
    dst_perm, dst_off = _csr_side(dst, nv)
    return EdgeCSR(src_perm, src_off, dst_perm, dst_off)


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
        lib.edge_decoder_bwd.argtypes = [p] * 20 + [i, i, i, i, u, f, i, i, p]
        lib.edge_decoder_bwd.restype = i
        lib.edge_decoder_bwd_split.argtypes = [i, i]
        lib.edge_decoder_bwd_split.restype = i
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


def _launch_bwd(pd, pv, b1, w2, b2, w3, edges, seed, rate, train, dtype, g,
                csr: Optional[EdgeCSR], folds):
    ne = _check(pd, pv, b1, w2, b2, w3, edges, seed, dtype, folds)
    nd, nv, dev = pd.shape[-2], pv.shape[-2], pd.device
    _check_edges(g, "g", (*folds, ne), torch.float32, dev)
    if csr is None:
        csr = edge_csr(edges[..., 0, :], edges[..., 1, :], nd, nv)
    for name, n in (("src_perm", ne), ("src_off", nd + 1), ("dst_perm", ne),
                    ("dst_off", nv + 1)):
        _check_edges(getattr(csr, name), f"csr.{name}", (*folds, n),
                     torch.int32, dev)
    lib = _load()
    nf = folds[0] if folds else 1
    n_split = lib.edge_decoder_bwd_split(nf, ne)
    kw = dict(dtype=torch.float32, device=dev)
    da1 = torch.empty((nf, ne, H1), **kw)
    parts = [torch.empty((*folds, n_split, *shape), **kw)
             for shape in ((H1,), (H1, H2), (H2,), (H2,))]
    dpd, dpv = torch.empty_like(pd), torch.empty_like(pv)
    ptrs = [x.data_ptr() for x in (
        pd, pv, b1, w2, b2, w3, edges, seed, g, csr.src_perm, csr.src_off,
        csr.dst_perm, csr.dst_off, da1, *parts, dpd, dpv)]
    err = lib.edge_decoder_bwd(
        *ptrs, nf, nd, nv, ne, *drop_args(rate, train),
        int(dtype == torch.bfloat16), stream_ptr(dev))
    if err != 0:
        raise RuntimeError(f"edge_decoder_bwd launch failed: CUDA error {err}")
    LAUNCHES["bwd_b" if folds else "bwd"] += 1
    # Sum each slab over its partial axis, in a fixed order.
    db1, dw2, db2, dw3 = (x.sum(len(folds)) for x in parts)
    return dpd, dpv, db1, dw2, db2, dw3


def fwd_occupancy(dtype) -> tuple:
    """(blocks, warps) of the ``dtype`` forward kernel resident on one SM
    of the current card, by CUDA's occupancy API."""
    return occupancy(_load(), "edge_decoder_fwd_occupancy", dtype)


def bwd_occupancy(dtype) -> tuple:
    """(blocks, warps) of the ``dtype`` backward's pass-1 kernel resident on
    one SM of the current card, by CUDA's occupancy API."""
    return occupancy(_load(), "edge_decoder_bwd_occupancy", dtype)


def launch_fwd(pd, pv, b1, w2, b2, w3, edges, seed, rate, train, dtype):
    """One forward launch over edges (2, E); returns (E,) f32 without b3."""
    return _launch_fwd(pd, pv, b1, w2, b2, w3, edges, seed, rate, train,
                       dtype, ())


def launch_bwd(pd, pv, b1, w2, b2, w3, edges, seed, rate, train, dtype, g,
               csr=None):
    """One backward launch (both passes) plus the sums over its partial
    slabs.  Returns (dpd, dpv, db1, dw2, db2, dw3)."""
    return _launch_bwd(pd, pv, b1, w2, b2, w3, edges, seed, rate, train,
                       dtype, g, csr, ())


def launch_fwd_batched(pd, pv, b1, w2, b2, w3, edges, seed, rate, train,
                       dtype):
    """One batched forward launch over edges (F, 2, E); returns (F, E) f32
    without b3."""
    return _launch_fwd(pd, pv, b1, w2, b2, w3, edges, seed, rate, train,
                       dtype, (pd.shape[0],))


def launch_bwd_batched(pd, pv, b1, w2, b2, w3, edges, seed, rate, train,
                       dtype, g, csr=None):
    """One batched backward launch plus the sums over its partial slabs.
    Returns (dpd, dpv, db1, dw2, db2, dw3), each with a leading F."""
    return _launch_bwd(pd, pv, b1, w2, b2, w3, edges, seed, rate, train,
                       dtype, g, csr, (pd.shape[0],))


class _FusedDecoder(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pd, pv, b1, w2, b2, w3, b3, edges, seed, rate, train,
                dtype, csr, batched):
        ctx.save_for_backward(pd, pv, b1, w2, b2, w3, edges, seed)
        ctx.cfg = (rate, train, dtype, csr, batched)
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
            rate, train, dtype, csr, batched = ctx.cfg
            args = (*ctx.saved_tensors, rate, train, dtype, g.contiguous())
            if g.is_cuda:
                launch = launch_bwd_batched if batched else launch_bwd
                grads = launch(*args, csr)
            else:
                grads = (edge_decoder_batched_plain_bwd if batched
                         else edge_decoder_plain_bwd)(*args)
            # d/db3 (out + b3), outside the kernel
            db3 = g.sum(-1, keepdim=True)
            return (*grads, db3) + (None,) * 7


def fused_decoder(proj_drug, proj_dis, b1, w2, b2, w3, b3, edges, seed,
                  rate: float, train: bool, dtype=torch.bfloat16,
                  csr: Optional[EdgeCSR] = None):
    """Per-edge decoder MLP, the contract of the JAX ``fused_decoder``
    (pallas_decoder.py:202).

    proj_drug (Nd, 128) f32, proj_dis (Nv, 128) f32, b1 (128,),
    w2 (128, 64), b2 (64,), w3 (64,), b3 (1,), edges (2, E) int32
    [src; dst] with src < Nd and dst < Nv (the kernels assert it on the
    device), seed (1,) int32 on the same device; ``csr`` the edges'
    ``edge_csr``, built in the backward when not given.  Returns (E,) f32
    logits.  CUDA tensors run the kernels, CPU tensors the plain version.
    """
    return _FusedDecoder.apply(
        proj_drug.contiguous(), proj_dis.contiguous(), b1.contiguous(),
        w2.contiguous(), b2.contiguous(), w3.contiguous(), b3,
        edges.contiguous(), seed, rate, train, dtype, csr, False)


def fused_decoder_batched(proj_drug, proj_dis, b1, w2, b2, w3, b3, edges,
                          seed, rate: float, train: bool,
                          dtype=torch.bfloat16,
                          csr: Optional[EdgeCSR] = None):
    """Fold-batched per-edge decoder MLP, the contract of the JAX
    ``fused_decoder_batched`` (pallas_decoder_batched.py:158).

    proj_drug (F, Nd, 128), proj_dis (F, Nv, 128), b1 (F, 128),
    w2 (F, 128, 64), b2 (F, 64), w3 (F, 64), b3 (F, 1), all f32,
    edges (F, 2, E) int32, seed (F,) int32, on one device; ``csr`` with a
    leading F.  Returns (F, E) f32 logits.  CUDA tensors run one launch of
    each kernel, CPU tensors the plain version.
    """
    return _FusedDecoder.apply(
        proj_drug.contiguous(), proj_dis.contiguous(), b1.contiguous(),
        w2.contiguous(), b2.contiguous(), w3.contiguous(), b3,
        edges.contiguous(), seed, rate, train, dtype, csr, True)


def decoder_apply_fused(params, edge_src, edge_dst, drug_feat, dis_feat, *,
                        dropout_rate: float, train: bool = False,
                        generator=None, dtype=torch.bfloat16,
                        csr: Optional[EdgeCSR] = None):
    """Fused counterpart of ``nn.decoder.decoder_apply``
    (pallas_decoder.py:290-324): node projections in PyTorch, the per-edge
    MLP in the kernel.  Any node count is taken: the kernel gathers rows.
    Returns (E,) logits."""
    proj_drug, proj_dis = node_projections(params, drug_feat, dis_feat, dtype)
    edges = torch.stack([edge_src.int(), edge_dst.int()])
    seed = dropout_seeds(1, proj_drug.device, dropout_rate, train, generator)
    return fused_decoder(proj_drug, proj_dis, params["b1"], params["w2"],
                         params["b2"], params["w3"][:, 0], params["b3"],
                         edges, seed, dropout_rate, train, dtype, csr)


def decoder_apply_fused_batched(params, edge_src, edge_dst, drug_feat,
                                dis_feat, *, dropout_rate: float,
                                train: bool = False, generator=None,
                                dtype=torch.bfloat16,
                                csr: Optional[EdgeCSR] = None, mesh=None,
                                shard=None):
    """Fold-batched fused edge decode, the counterpart of the JAX
    ``decoder_apply_fused_batched`` (pallas_decoder_batched.py:310-363).
    Params leaves, ``edge_src``/``edge_dst`` (F, E) and features (F, N, d)
    carry a leading fold axis; the F dropout seeds come from one draw of
    ``generator``; ``csr`` is the list's ``EdgeCSR``.  With a ``mesh`` they
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
                                     seed, dropout_rate, train, dtype, csr)
    if shard is None:
        raise ValueError("the fused edge decoder on a mesh runs on the "
                         "rank's EdgeShard: shard the stack with "
                         "sharding.partition.shard_stacked")
    from dream_gnn_tpu_torch.sharding.decoder_spmd import \
        fused_decoder_batched_spmd
    return fused_decoder_batched_spmd(mesh, proj_drug, proj_dis, *weights,
                                      shard, seed, dropout_rate, train, dtype)

"""The scale path's fused per-edge decoder: hand-written CUDA kernels and
their plain PyTorch versions.

Replaces the Pallas TPU kernels ``_k2_kernel``, ``_b1_kernel`` and
``_mirror_kernel`` of ``dream_gnn_tpu/kernels/pallas_scale_decoder.py``
(``scale_decoder``, ``decoder_apply_scale``): the per-candidate MLP decoder
at node counts where the candidate list (1M at the scale configuration) is
scored as a stream.

Slot orders.  The forward runs over the candidates stable-sorted by drug
(the forward slots), the mirror over them stable-sorted by disease (the
mirror slots).  Logits come back in forward-slot order, and the caller
scores them against labels and weights permuted into that order once per
candidate list (``ScaleDecoderLayout.slot_labels``); BCE and AUROC/AUPR do
not depend on the order.  ``inv_slot`` takes a candidate to its forward
slot.  The JAX layout pads its streams to whole chunks; here a slot is a
candidate, so ``n_pos == n_mpos == n_edges`` and every slot weighs 1,
unless the list is built with ``rank_pad``: then it is padded to that many
slots with weight-0 slots (drug 0, disease 0, candidate id ``n_edges``, one
past the list), so that every rank of the candidate-sharded decoder
(sharding/scale_decoder_spmd.py) holds the same number of slots.  JAX's
``rank_pad`` fixes its stream layouts' common rank space, for stacking
shards on one controller; this padding is the part of it a rank needs.

The pipeline (pallas_scale_decoder.py:808-877):
- forward: K2 scores every forward slot from the bf16-rounded table rows
  ``Pd[drug]`` and ``Pv[dis]`` (gathered in the kernel) and, when a gradient
  is wanted, spills the pre-activation a1 (bf16 in bf16 mode); b3 is added
  outside the kernel;
- backward: B1 reruns the MLP from the saved a1 in forward-slot order,
  writing da1 rows and the weight gradients; ``d_P_drug`` is the
  scatter-add of those rows by drug (kernels/seq_scatter.py); the mirror
  recomputes a1 from the rows in mirror-slot order and writes its da1 rows,
  scattered by disease into ``d_P_dis``.  The cotangent reaches the mirror
  through a plain gather (``gout_perm``).  A layout built with
  ``build_seq=False`` has no sequential scatters, and the two scatter-adds
  run as the grouped SpMM (kernels/spmm_gather.py) over ``scat_drug`` and
  ``scat_dis``, whose sources are slot positions and whose destinations are
  node rows (pallas_scale_decoder.py:843-863).  Both read each node's slots
  in slot order and round each message as rnd(x), so the two give the same
  bits.

B1 recomputes from the rounded saved a1 and the mirror from the unrounded
one, so in bf16 the two table gradients see different a1 roundings, as in
the JAX package.  Dropout is the JAX kernels' stateless murmur PRF of
(seed, candidate index, unit) (``slot_dropout_masks``, bit for bit
``_prf_masks``), so the three passes draw the same masks in their different
orders.  The kernel widths are H1 = 128 (the JAX package's requirement,
:824-827) and H2 = 64; the plain version takes any H2.

Dispatch.  CUDA tensors launch the kernels and CPU tensors run the plain
versions; there is no fallback.  Each kernel follows the dtype inside its C
entry point: bf16 runs on the tensor cores (K2 ``scale_fwd_mma_kernel``, B1
and the mirror ``scale_bwd_mma_kernel``), fp32 on the CUDA cores
(``scale_fwd_kernel``, ``scale_bwd_kernel``).  In bf16, K2 and the
backward sum a2 in the tensor cores' order and again in unit order (the
plain version's on the card) wherever the order could move a rounding
(tests/test_torch_port_k2_sum_order.py,
tests/test_torch_port_scale_sum_order.py).
``LAUNCHES`` counts launches of K2 (``k2``), B1 (``b1``) and the mirror
(``mirror``).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch

from dream_gnn_tpu_torch.graph.grouped import GroupedCoo, grouped_from_arrays
from dream_gnn_tpu_torch.kernels import cuda_build
from dream_gnn_tpu_torch.kernels.grid_decoder import (
    H1, H2, check_inputs, drop_args, dropout_seeds, fmix32, keep_scale,
    keep_threshold, mul32, node_projections, occupancy, round_to, stream_ptr)
from dream_gnn_tpu_torch.kernels.seq_scatter import (SeqScatter,
                                                      build_seq_scatter,
                                                      seq_scatter)
from dream_gnn_tpu_torch.kernels.spmm_gather import spmm_gather_raw
from dream_gnn_tpu_torch.utils.device import as_tensor
from dream_gnn_tpu_torch.utils.profiling import span

LAUNCHES = {"k2": 0, "b1": 0, "mirror": 0}

_lib = None


# ---------------------------------------------------------------------------
# The layout of one candidate list.

@dataclasses.dataclass(frozen=True)
class ScaleDecoderLayout:
    """Slot orders of one candidate list (static per list, like the
    reference's decoder graph).  Index tensors are int32 on the list's
    device; every per-slot array has one entry per candidate."""

    fwd_eid: torch.Tensor        # forward slot -> candidate (drug-sorted)
    drug_of_slot: torch.Tensor
    dis_of_slot: torch.Tensor
    mirror_eid: torch.Tensor     # mirror slot -> candidate (disease-sorted)
    drug_of_mslot: torch.Tensor
    dis_of_mslot: torch.Tensor
    gout_perm: torch.Tensor      # mirror slot -> forward slot
    inv_slot: torch.Tensor       # candidate -> forward slot
    scat_drug: GroupedCoo        # forward slot -> drug row
    scat_dis: GroupedCoo         # mirror slot -> disease row
    n_drug: int
    n_dis: int
    # The sequential scatters of the same slots, None with build_seq=False.
    seq_drug: Optional[SeqScatter] = None   # forward slots by drug
    seq_dis: Optional[SeqScatter] = None    # mirror slots by disease

    @property
    def n_pos(self) -> int:
        return self.fwd_eid.shape[0]

    @property
    def n_mpos(self) -> int:
        return self.mirror_eid.shape[0]

    @property
    def n_edges(self) -> int:
        return self.inv_slot.shape[0]

    def slot_labels(self, labels):
        """(labels, weights) in forward-slot order: the candidates' labels
        permuted once per list, and weight 1 for every slot but the padding
        slots of ``rank_pad``, which weigh 0."""
        lab = as_tensor(labels, torch.float32, self.fwd_eid.device)
        eid = self.fwd_eid.long()
        lab = torch.cat([lab, lab.new_zeros(1)])
        return lab[eid], (eid < lab.shape[0] - 1).to(torch.float32)


def build_scale_decoder_layout(dec_src, dec_dst, n_drug: int, n_dis: int,
                               rank_pad=None, build_seq: bool = True,
                               device=None) -> ScaleDecoderLayout:
    """The slot orders of candidates (dec_src[e], dec_dst[e]), with torch
    ops on the list's device (pallas_scale_decoder.py:191-258): the grouped
    scatter layouts always, the sequential ones with ``build_seq``; with
    ``rank_pad``, padded to that many slots (see the module doc)."""
    src = as_tensor(dec_src, torch.int64, device)
    dst = as_tensor(dec_dst, torch.int64, src.device)
    e = src.shape[0]
    if e == 0 or dst.shape[0] != e:
        raise ValueError("build_scale_decoder_layout: the candidate lists "
                         "must be non-empty and of equal length")
    for ids, n, name in ((src, n_drug, "drug"), (dst, n_dis, "disease")):
        if int(ids.min()) < 0 or int(ids.max()) >= n:
            raise ValueError(f"{name} ids must lie in [0, {n})")
    n_pos = e if rank_pad is None else rank_pad
    if n_pos < e:
        raise ValueError(f"rank_pad {rank_pad} < {e} candidates")
    pad = src.new_zeros(n_pos - e)
    src, dst = torch.cat([src, pad]), torch.cat([dst, pad])
    fwd = torch.argsort(src, stable=True)
    mirror = torch.argsort(dst, stable=True)
    slots = torch.arange(n_pos, device=src.device)
    inv_slot = torch.empty_like(fwd)
    inv_slot[fwd] = slots
    # Candidate ids; every padding slot carries e and weighs 0.
    eid = torch.clamp_max(slots, e)
    live = (slots < e).to(torch.float32)
    return ScaleDecoderLayout(
        fwd_eid=eid[fwd].int(), drug_of_slot=src[fwd].int(),
        dis_of_slot=dst[fwd].int(), mirror_eid=eid[mirror].int(),
        drug_of_mslot=src[mirror].int(), dis_of_mslot=dst[mirror].int(),
        gout_perm=inv_slot[mirror].int(), inv_slot=inv_slot[:e].int(),
        scat_drug=grouped_from_arrays(slots, src[fwd], live[fwd], n_pos,
                                      n_drug),
        scat_dis=grouped_from_arrays(slots, dst[mirror], live[mirror], n_pos,
                                     n_dis),
        seq_drug=(build_seq_scatter(src[fwd], None, None, n_drug)
                  if build_seq else None),
        seq_dis=(build_seq_scatter(dst[mirror], None, None, n_dis)
                 if build_seq else None),
        n_drug=n_drug, n_dis=n_dis)


# ---------------------------------------------------------------------------
# Plain PyTorch version.

def slot_dropout_masks(eid: torch.Tensor, seed: torch.Tensor, h1: int,
                       h2: int, rate: float):
    """(m1 (E, h1), m2 (E, h2)) f32 with values 0 or 1/(1-rate), bit for bit
    the JAX ``_prf_masks`` (transposed): base = eid * 0x9E3779B9 ^ seed,
    unit u keeps iff fmix32(base ^ u * 0x7FEB352D) >= thresh."""
    base = mul32(eid.to(torch.int64) & 0xFFFFFFFF, 0x9E3779B9) \
        ^ (seed.to(torch.int64).reshape(()) & 0xFFFFFFFF)
    unit = torch.arange(h1 + h2, device=eid.device, dtype=torch.int64)
    bits = fmix32(base[:, None] ^ mul32(unit, 0x7FEB352D)[None, :])
    m = (bits >= keep_threshold(rate)).to(torch.float32) * keep_scale(rate)
    return m[:, :h1], m[:, h1:]


def _rows_a1(pd, pv, b1, drug, dis, dtype):
    """a1 = (rnd(Pd[drug]) + rnd(Pv[dis])) + b1 per slot, f32."""
    return (round_to(pd, dtype)[drug.long()] + round_to(pv, dtype)[dis.long()]) \
        + b1


def _store_dtype(dtype):
    """The type the kernels store a1 and da1 in: bf16 in bf16 mode."""
    return torch.bfloat16 if dtype == torch.bfloat16 else torch.float32


def _stored(x, dtype):
    return x.to(_store_dtype(dtype))


def scale_fwd_plain(pd, pv, b1, w2, b2, w3, drug, dis, eid, seed, rate: float,
                    train: bool, dtype, save_a1: bool):
    """K2 in plain PyTorch: (logits (E,) without b3, a1 as stored or
    None)."""
    use_drop = train and rate > 0.0
    a1 = _rows_a1(pd, pv, b1, drug, dis, dtype)
    h = torch.relu(a1)
    if use_drop:
        m1, m2 = slot_dropout_masks(eid, seed, pd.shape[1], w2.shape[1], rate)
        h = h * m1
    a2 = torch.matmul(round_to(h, dtype), round_to(w2, dtype)) + b2
    h2 = torch.relu(a2)
    if use_drop:
        h2 = h2 * m2
    logits = round_to(h2, dtype) @ round_to(w3, dtype)
    return logits, (_stored(a1, dtype) if save_a1 else None)


def scale_bwd_plain(a1, pd, pv, drug, dis, eid, g, b1, w2, b2, w3, seed,
                    rate: float, train: bool, dtype, weight_grads: bool):
    """B1 (``a1`` the forward's spill, ``weight_grads``) or the mirror
    (``a1`` None: recomputed from the rows) in plain PyTorch.  Returns da1
    as stored, plus (dw2, db2, dw3, db1) with ``weight_grads``."""
    use_drop = train and rate > 0.0
    a1 = a1.float() if a1 is not None \
        else _rows_a1(pd, pv, b1, drug, dis, dtype)
    h1d = torch.relu(a1)
    if use_drop:
        m1, m2 = slot_dropout_masks(eid, seed, a1.shape[1], w2.shape[1], rate)
        h1d = h1d * m1
    a2 = torch.matmul(round_to(h1d, dtype), round_to(w2, dtype)) + b2
    h2d = torch.relu(a2)
    dh2 = w3 * g[:, None]
    if use_drop:
        h2d = h2d * m2
        dh2 = dh2 * m2
    da2 = torch.where(a2 > 0.0, dh2, torch.zeros_like(dh2))
    dh1 = torch.matmul(round_to(da2, dtype), round_to(w2, dtype).T)
    if use_drop:
        dh1 = dh1 * m1
    da1 = torch.where(a1 > 0.0, dh1, torch.zeros_like(dh1))
    if not weight_grads:
        return _stored(da1, dtype)
    return (_stored(da1, dtype),
            torch.matmul(round_to(h1d, dtype).T, round_to(da2, dtype)),
            da2.sum(0),
            (h2d * g[:, None]).sum(0), da1.sum(0))


# ---------------------------------------------------------------------------
# The CUDA kernels: load, launch.

def _load():
    global _lib
    if _lib is None:
        lib = cuda_build.load("scale_decoder")
        p, i, u, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
                      ctypes.c_float)
        lib.scale_decoder_fwd.argtypes = [p] * 12 + [i, i, i, u, f, i, i, p]
        lib.scale_decoder_fwd.restype = i
        lib.scale_decoder_bwd.argtypes = [p] * 17 + [i, i, i, u, f, i, i, i,
                                                     p]
        lib.scale_decoder_bwd.restype = i
        lib.scale_decoder_bwd_split.argtypes = [i]
        lib.scale_decoder_bwd_split.restype = i
        lib.scale_decoder_bwd_occupancy.argtypes = [i, i, p]
        lib.scale_decoder_bwd_occupancy.restype = i
        lib.scale_decoder_fwd_occupancy.argtypes = [i, p]
        lib.scale_decoder_fwd_occupancy.restype = i
        _lib = lib
    return _lib


def _check_slots(x, name, shape, dtype, dev):
    if x.device != dev or x.dtype != dtype or tuple(x.shape) != shape \
            or not x.is_contiguous():
        raise ValueError(f"scale decoder kernel: {name} must be a contiguous "
                         f"{dtype} {shape} tensor on {dev}, got {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}")


def _ptr(x):
    return x.data_ptr() if x is not None else None


def _check(pd, pv, b1, w2, b2, w3, seed, dtype, slots):
    check_inputs(pd, pv, b1, w2, b2, w3, seed, dtype,
                 kernel="scale decoder kernel")
    ne = slots[0].shape[0]
    if ne < 1:
        raise ValueError("scale decoder kernel: the candidate list is empty")
    for name, x in zip(("drug", "dis", "eid"), slots):
        _check_slots(x, name, (ne,), torch.int32, pd.device)
    return ne


def launch_k2(pd, pv, b1, w2, b2, w3, drug, dis, eid, seed, rate, train,
              dtype, save_a1):
    """One K2 launch over forward slots (drug, dis, eid): (logits (E,) f32
    without b3, a1 (E, H1) or None)."""
    ne = _check(pd, pv, b1, w2, b2, w3, seed, dtype, (drug, dis, eid))
    lib = _load()
    dev = pd.device
    out = torch.empty(ne, dtype=torch.float32, device=dev)
    a1 = torch.empty((ne, H1), dtype=_store_dtype(dtype), device=dev) \
        if save_a1 else None
    err = lib.scale_decoder_fwd(
        *[x.data_ptr() for x in (pd, pv, drug, dis, eid, b1, w2, b2, w3, seed,
                                 out)], _ptr(a1),
        pd.shape[0], pv.shape[0], ne, *drop_args(rate, train),
        int(dtype == torch.bfloat16), stream_ptr(dev))
    if err != 0:
        raise RuntimeError(f"scale_decoder_fwd launch failed: CUDA error {err}")
    LAUNCHES["k2"] += 1
    return out, a1


def _launch_bwd(a1, pd, pv, drug, dis, eid, g, b1, w2, b2, w3, seed, rate,
                train, dtype, mirror):
    ne = _check(pd, pv, b1, w2, b2, w3, seed, dtype, (drug, dis, eid))
    dev = pd.device
    _check_slots(g, "g", (ne,), torch.float32, dev)
    store = _store_dtype(dtype)
    if not mirror:
        _check_slots(a1, "a1", (ne, H1), store, dev)
    lib = _load()
    da1 = torch.empty((ne, H1), dtype=store, device=dev)
    n_split = lib.scale_decoder_bwd_split(ne)
    parts = [torch.empty((n_split, *shape), dtype=torch.float32, device=dev)
             for shape in ((H1,), (H1, H2), (H2,), (H2,))] if not mirror \
        else [None] * 4
    err = lib.scale_decoder_bwd(
        _ptr(a1), *[x.data_ptr() for x in (pd, pv, drug, dis, eid, g, b1, w2,
                                           b2, w3, seed, da1)],
        *[_ptr(x) for x in parts], pd.shape[0], pv.shape[0], ne,
        *drop_args(rate, train), int(dtype == torch.bfloat16), int(mirror),
        stream_ptr(dev))
    name = "mirror" if mirror else "b1"
    if err != 0:
        raise RuntimeError(f"scale_decoder_bwd ({name}) launch failed: CUDA "
                           f"error {err}")
    LAUNCHES[name] += 1
    if mirror:
        return da1
    # Sum each slab over its partial axis, in a fixed order.
    db1, dw2, db2, dw3 = (x.sum(0) for x in parts)
    return da1, dw2, db2, dw3, db1


def fwd_occupancy(dtype) -> tuple:
    """(blocks, warps) of the ``dtype`` K2 kernel resident on one SM of the
    current card, by CUDA's occupancy API."""
    return occupancy(_load(), "scale_decoder_fwd_occupancy", dtype)


def bwd_occupancy(dtype, mirror: bool) -> tuple:
    """(blocks, warps) of the ``dtype`` backward's kernel, B1 or the mirror,
    resident on one SM of the current card, by CUDA's occupancy API."""
    occ = (ctypes.c_int * 2)()
    err = _load().scale_decoder_bwd_occupancy(int(dtype == torch.bfloat16),
                                              int(mirror),
                                              ctypes.addressof(occ))
    if err != 0:
        raise RuntimeError(f"scale_decoder_bwd_occupancy: CUDA error {err}")
    return occ[0], occ[0] * occ[1]


def launch_b1(a1, pd, pv, layout: ScaleDecoderLayout, g, b1, w2, b2, w3,
              seed, rate, train, dtype):
    """One B1 launch from the saved a1 over forward slots, plus the sums of
    its partial slabs: (da1 (E, H1), dw2, db2, dw3, db1).  ``g`` is the
    forward-slot cotangent."""
    return _launch_bwd(a1, pd, pv, layout.drug_of_slot, layout.dis_of_slot,
                       layout.fwd_eid, g, b1, w2, b2, w3, seed, rate, train,
                       dtype, False)


def launch_mirror(pd, pv, layout: ScaleDecoderLayout, g_m, b1, w2, b2, w3,
                  seed, rate, train, dtype):
    """One mirror launch over mirror slots: da1 (E, H1).  ``g_m`` is the
    mirror-slot cotangent."""
    return _launch_bwd(None, pd, pv, layout.drug_of_mslot,
                       layout.dis_of_mslot, layout.mirror_eid, g_m, b1, w2,
                       b2, w3, seed, rate, train, dtype, True)


# ---------------------------------------------------------------------------
# The differentiable decoder.

def _scatter(seq: Optional[SeqScatter], scat: GroupedCoo, x, dtype):
    """The table gradient of da1 rows ``x``: the sequential scatter where
    the layout has one, else the grouped SpMM (pallas_scale_decoder.py:
    843-863)."""
    if seq is not None:
        return seq_scatter(seq, x, dtype)
    return spmm_gather_raw(scat, x, dtype)


class _ScaleDecoder(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pd, pv, b1, w2, b2, w3, b3, layout, seed, rate, train,
                dtype, save_a1):
        slots = (layout.drug_of_slot, layout.dis_of_slot, layout.fwd_eid)
        if pd.is_cuda:
            out, a1 = launch_k2(pd, pv, b1, w2, b2, w3, *slots, seed, rate,
                                train, dtype, save_a1)
        else:
            out, a1 = scale_fwd_plain(pd, pv, b1, w2, b2, w3, *slots, seed,
                                      rate, train, dtype, save_a1)
        ctx.save_for_backward(a1, pd, pv, b1, w2, b2, w3, seed)
        ctx.cfg = (layout, rate, train, dtype)
        return out + b3

    @staticmethod
    def backward(ctx, gout):
        with span("decoder_bwd"):
            a1, pd, pv, b1, w2, b2, w3, seed = ctx.saved_tensors
            layout, rate, train, dtype = ctx.cfg
            g = gout.float().contiguous()
            g_m = g[layout.gout_perm.long()]
            common = (w2, b2, w3, seed, rate, train, dtype)
            if g.is_cuda:
                da1, dw2, db2, dw3, db1 = launch_b1(a1, pd, pv, layout, g, b1,
                                                    *common)
                da1_m = launch_mirror(pd, pv, layout, g_m, b1, *common)
            else:
                da1, dw2, db2, dw3, db1 = scale_bwd_plain(
                    a1, pd, pv, layout.drug_of_slot, layout.dis_of_slot,
                    layout.fwd_eid, g, b1, *common, True)
                da1_m = scale_bwd_plain(
                    None, pd, pv, layout.drug_of_mslot, layout.dis_of_mslot,
                    layout.mirror_eid, g_m, b1, *common, False)
            d_pd = _scatter(layout.seq_drug, layout.scat_drug, da1, dtype)
            d_pv = _scatter(layout.seq_dis, layout.scat_dis, da1_m, dtype)
            db3 = g.sum(0, keepdim=True)
            return (d_pd, d_pv, db1, dw2, db2, dw3, db3) + (None,) * 6


def scale_decoder(proj_drug, proj_dis, b1, w2, b2, w3, b3,
                  layout: ScaleDecoderLayout, seed, rate: float, train: bool,
                  dtype=torch.bfloat16):
    """Fused per-edge decoder at scale, the contract of the JAX
    ``scale_decoder`` (pallas_scale_decoder.py:809): proj_drug (Nd, 128),
    proj_dis (Nv, 128), b1 (128,), w2 (128, H2), b2 (H2,), w3 (H2,),
    b3 (1,), all f32, seed (1,) int32.  Returns (layout.n_pos,) f32 logits
    in forward-slot order."""
    if b1.shape[0] != H1:
        raise ValueError(f"scale decoder requires H1={H1}; got {b1.shape[0]}")
    tensors = (proj_drug.contiguous(), proj_dis.contiguous(), b1.contiguous(),
               w2.contiguous(), b2.contiguous(), w3.contiguous(), b3)
    # K2 spills a1 only for a backward that will run (not in an eval).
    save_a1 = torch.is_grad_enabled() and any(t.requires_grad
                                              for t in tensors)
    return _ScaleDecoder.apply(*tensors, layout, seed, rate, train, dtype,
                               save_a1)


def decoder_apply_scale(params, layout: ScaleDecoderLayout, drug_feat,
                        dis_feat, *, dropout_rate: float, train: bool = False,
                        generator=None, dtype=torch.bfloat16):
    """The scale decoder of a model (pallas_scale_decoder.py:880-905): node
    projections in PyTorch, the per-edge MLP in the kernels.  Returns
    forward-slot-order logits (layout.n_pos,)."""
    proj_drug, proj_dis = node_projections(params, drug_feat, dis_feat, dtype)
    seed = dropout_seeds(1, proj_drug.device, dropout_rate, train, generator)
    return scale_decoder(proj_drug, proj_dis, params["b1"], params["w2"],
                         params["b2"], params["w3"][:, 0], params["b3"],
                         layout, seed, dropout_rate, train, dtype)

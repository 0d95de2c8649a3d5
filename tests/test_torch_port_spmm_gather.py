"""The port's grouped SpMM against the JAX package: ``spmm_gather_raw`` and
``spmm_gather`` (the plain versions, which the wrappers run for CPU
tensors) against the JAX ``_spmm_gather_raw`` and ``spmm_gather`` with
their Pallas kernel in interpret mode.

Shapes, as the JAX package's own tests (tests/test_pallas_spmm_gather.py:
28-51): several dst tiles (600 x 700, 3,000 edges), one tile (100 x 90,
200 edges) and dst tiles left empty (1200 x 300, 400 edges), at d = 128
and at an odd d = 33 (no packed panels); weights U[0.5, 1.5).  Also packed
panels in fp32, duplicate edges, PRF-masked pairs and the gradient.

Tolerances (atol scaled by the output's magnitude).  Both sides round each
message at the same points, rnd(rnd(x) * val) with packed panels and
rnd(x * val) without, and sum the messages in f32; only the order of the
sums differs.  fp32: rtol 1e-5, atol 1e-5.  bf16: rtol 1e-4, atol 1e-4, as
the slab SpMM's parity (tests/test_torch_port_spmm_slab.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dream_gnn_tpu.kernels.pallas_spmm_gather as psg
from dream_gnn_tpu.augment.masks import prf_mask_pair as j_prf_mask_pair
from dream_gnn_tpu.graph.grouped import grouped_from_arrays as j_from_arrays
from dream_gnn_tpu.graph.grouped import \
    grouped_pair_from_arrays as j_pair_from_arrays
from dream_gnn_tpu_torch.augment.masks import prf_mask_pair
from dream_gnn_tpu_torch.graph.grouped import (grouped_from_arrays,
                                               grouped_pair_from_arrays)
from dream_gnn_tpu_torch.kernels import spmm_gather as sg

DTYPES = {"float32": (torch.float32, jnp.float32, 1e-5),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 1e-4)}
SHAPES = [(600, 700, 3000), (100, 90, 200), (1200, 300, 400)]


@pytest.fixture(autouse=True)
def _interpret():
    old = psg.INTERPRET
    psg.INTERPRET = True
    yield
    psg.INTERPRET = old


def _close(a, b, tol, what):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b, np.float32)
    assert a.shape == b.shape, what
    scale = max(1e-3, float(np.abs(b).max()))
    np.testing.assert_allclose(a, b, rtol=tol, atol=tol * scale,
                               err_msg=what)


def _edges(n_dst, n_src, n_edges, seed=0):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_src, n_edges)
    dst = rng.integers(0, n_dst, n_edges)
    val = (rng.random(n_edges) + 0.5).astype(np.float32)
    return src, dst, val


# Every shape in both dtypes at d = 128 (packed panels in bf16), and the
# odd d in bf16, the one mode it changes (messages rnd(x * val)).
CASES = [(*shape, 128, name) for shape in SHAPES for name in DTYPES] \
    + [(*SHAPES[0], 33, "bfloat16")]


@pytest.mark.parametrize("n_dst,n_src,n_edges,d,name", CASES)
def test_gather_raw_matches_jax(n_dst, n_src, n_edges, d, name):
    tdt, jdt, tol = DTYPES[name]
    src, dst, val = _edges(n_dst, n_src, n_edges)
    x = np.random.default_rng(d).normal(size=(n_src, d)).astype(np.float32)
    want = psg._spmm_gather_raw(j_from_arrays(src, dst, val, n_src, n_dst),
                                jnp.asarray(x), dtype=jdt)
    g = grouped_from_arrays(src, dst, val, n_src, n_dst, device="cpu")
    got = sg.spmm_gather_raw(g, torch.tensor(x), tdt)
    assert got.dtype == torch.float32
    _close(got, want, tol, f"{name} d={d}")
    if n_dst == 1200:
        # No edge lands in some dst tiles: their rows are zeros.
        empty = np.setdiff1d(np.arange(n_dst), dst)
        assert float(got[empty].abs().max()) == 0.0


def test_packed_fp32_rounds_x_only():
    """``packed=True`` in fp32 rounds x to bf16 and keeps the messages f32
    (tests/test_pallas_spmm_gather.py:68-80); it differs from the unpacked
    fp32 result by more than the fp32 tolerance."""
    src, dst, val = _edges(600, 700, 3000)
    x = np.random.default_rng(1).normal(size=(700, 128)).astype(np.float32)
    want = psg._spmm_gather_raw(j_from_arrays(src, dst, val, 700, 600),
                                jnp.asarray(x), dtype=jnp.float32,
                                packed=True)
    g = grouped_from_arrays(src, dst, val, 700, 600, device="cpu")
    got = sg.spmm_gather_raw(g, torch.tensor(x), torch.float32, packed=True)
    _close(got, want, 1e-5, "packed fp32")
    unpacked = sg.spmm_gather_raw(g, torch.tensor(x), torch.float32)
    with pytest.raises(AssertionError):
        _close(unpacked, want, 1e-5, "unpacked")


def test_duplicate_edges_accumulate():
    src = np.array([0, 0, 5], np.int64)
    dst = np.array([1, 1, 600], np.int64)
    val = np.array([1.0, 2.0, 1.5], np.float32)
    x = np.pad(np.eye(10, dtype=np.float32), ((0, 0), (0, 118)))
    want = psg._spmm_gather_raw(j_from_arrays(src, dst, val, 10, 700),
                                jnp.asarray(x), dtype=jnp.float32)
    got = sg.spmm_gather_raw(grouped_from_arrays(src, dst, val, 10, 700,
                                                 device="cpu"),
                             torch.tensor(x), torch.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert float(got[1, 0]) == 3.0 and float(got[600, 5]) == 1.5


def _by_edge(g_val, g_eid, n_live):
    """A layout's weights indexed by physical edge id (padding dropped)."""
    val, eid = np.asarray(g_val).reshape(-1), np.asarray(g_eid).reshape(-1)
    out = np.zeros(n_live, np.float32)
    live = eid < n_live
    out[eid[live]] = val[live]
    return out


@pytest.mark.parametrize("name", list(DTYPES))
def test_prf_masked_gather_and_grad_match_jax(name):
    """PRF edge dropout on a grouped pair: both layouts drop, by edge id,
    exactly the JAX edges; the masked SpMM and its gradient (over
    ``pair.bwd``) match ``jax.grad`` of the JAX ``spmm_gather``."""
    tdt, jdt, tol = DTYPES[name]
    n_dst, n_src = 400, 300
    src, dst, val = _edges(n_dst, n_src, 2000, seed=2)
    val[::10] = 0.0                               # dropped at build
    salt, rate = 12345, 0.4
    jp = j_prf_mask_pair(j_pair_from_arrays(src, dst, val, n_src, n_dst),
                         jnp.asarray(salt, jnp.uint32), rate)
    tp = prf_mask_pair(grouped_pair_from_arrays(src, dst, val, n_src, n_dst,
                                                device="cpu"), salt, rate)
    n = tp.fwd.n_live
    assert n == tp.bwd.n_live == int((val != 0).sum())
    for jl, tl in ((jp.fwd, tp.fwd), (jp.bwd, tp.bwd)):
        np.testing.assert_array_equal(_by_edge(tl.val, tl.edge_id, n),
                                      _by_edge(jl.val, jl.edge_id, n))
    assert 0.3 < float((_by_edge(tp.fwd.val, tp.fwd.edge_id, n) == 0).mean()) \
        < 0.5

    rng = np.random.default_rng(3)
    x = rng.normal(size=(n_src, 128)).astype(np.float32)
    out_j, gx_j = jax.jit(jax.value_and_grad(
        lambda y: jnp.sum(psg.spmm_gather(jp, y, jdt) ** 2)))(jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    out = sg.spmm_gather(tp, xt, tdt)
    (out ** 2).sum().backward()
    _close((out ** 2).sum(), out_j, tol, "loss")
    _close(xt.grad, gx_j, tol, "dx")


def test_gradient_runs_over_the_transposed_layout():
    """The backward is the same SpMM over ``pair.bwd``: swapping the pair's
    layouts swaps forward and gradient."""
    src, dst, val = _edges(300, 250, 1500, seed=4)
    pair = grouped_pair_from_arrays(src, dst, val, 250, 300, device="cpu")
    g = torch.tensor(np.random.default_rng(5).normal(
        size=(300, 128)).astype(np.float32))
    x = torch.zeros(250, 128, requires_grad=True)
    sg.spmm_gather(pair, x, torch.float32).backward(g)
    flipped = dataclasses.replace(pair, fwd=pair.bwd, bwd=pair.fwd)
    assert torch.equal(x.grad, sg.spmm_gather(flipped, g, torch.float32))


def test_group_batch_is_validated_as_jax_does():
    src, dst, val = _edges(600, 700, 3000)
    g = grouped_from_arrays(src, dst, val, 700, 600, device="cpu")
    jg = j_from_arrays(src, dst, val, 700, 600)
    x = torch.zeros(700, 128)
    base = sg.spmm_gather_raw(g, x)
    for gb in (1, 4, 16):
        assert torch.equal(sg.spmm_gather_raw(g, x, group_batch=gb), base)
    for gb, msg in ((32, "> layout gpc"), (3, "must divide")):
        with pytest.raises(ValueError, match=msg):
            sg.spmm_gather_raw(g, x, group_batch=gb)
        with pytest.raises(ValueError, match=msg):
            psg._spmm_gather_raw(jg, jnp.zeros((700, 128)), group_batch=gb)
    with pytest.raises(ValueError, match="x must be"):
        sg.spmm_gather_raw(g, torch.zeros(699, 128))

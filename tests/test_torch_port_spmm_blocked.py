"""The port's blocked SpMM against the JAX package: ``spmm_blocked_raw`` and
``spmm_blocked`` (the plain versions, which the wrappers run for CPU
tensors) against the JAX ``_spmm_blocked_raw`` and ``spmm_blocked`` with
their Pallas kernel in interpret mode.

Shapes, as the JAX package's own tests (tests/test_pallas_spmm.py:29-70):
several tiles (600 x 700 at density 0.01), one tile (100 x 90 at 0.05),
sparse with empty dst tiles (1200 x 300 at 0.002), and all edges in the
first dst tile of three; d = 128, weights U[0.5, 1.5).  Also the gradient,
and a PRF-masked pair with repeated edges.

Tolerances (atol scaled by the output's magnitude).  In bf16 both sides
form each message as rnd(rnd(val) * rnd(x)), the weight rounded with the
gather one-hot (pallas_spmm.py:73, 78-79), and sum in f32; in fp32 both
form val * x.  Only the order of the sums differs: fp32 rtol 1e-5, atol
1e-5; bf16 rtol 1e-4, atol 1e-4.  The control shows that the bf16
tolerance sees the rounding of val: the grouped SpMM's messages
rnd(rnd(x) * val) miss it on the same inputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dream_gnn_tpu.kernels.pallas_spmm as ps
from dream_gnn_tpu.graph.blocked import blocked_from_arrays as j_from_arrays
from dream_gnn_tpu.graph.blocked import \
    blocked_pair_from_arrays as j_pair_from_arrays
from dream_gnn_tpu_torch.graph.blocked import (blocked_from_arrays,
                                               blocked_pair_from_arrays,
                                               blocked_pair_from_coo)
from dream_gnn_tpu_torch.graph.coo import coo_from_arrays
from dream_gnn_tpu_torch.kernels import spmm_blocked as sb
from dream_gnn_tpu_torch.kernels.spmm_slab import segment_sum_plain

DTYPES = {"float32": (torch.float32, jnp.float32, 1e-5),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 1e-4)}
SHAPES = [(600, 700, 0.01), (100, 90, 0.05), (1200, 300, 0.002)]


@pytest.fixture(autouse=True)
def _interpret():
    old = ps.INTERPRET
    ps.INTERPRET = True
    yield
    ps.INTERPRET = old


def _close(a, b, tol, what):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b, np.float32)
    assert a.shape == b.shape, what
    scale = max(1e-3, float(np.abs(b).max()))
    np.testing.assert_allclose(a, b, rtol=tol, atol=tol * scale,
                               err_msg=what)


def _edges(n_dst, n_src, density, seed=0):
    """The nonzeros of a random (n_dst, n_src) matrix, weights U[0.5, 1.5),
    in random order."""
    rng = np.random.default_rng(seed)
    dst, src = np.nonzero(rng.random((n_dst, n_src)) < density)
    perm = rng.permutation(len(src))
    val = (rng.random(len(src)) + 0.5).astype(np.float32)
    return src[perm], dst[perm], val


def _x(n_src, seed=1):
    return np.random.default_rng(seed).normal(
        size=(n_src, 128)).astype(np.float32)


@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("n_dst,n_src,density", SHAPES)
def test_blocked_raw_matches_jax(n_dst, n_src, density, name):
    tdt, jdt, tol = DTYPES[name]
    src, dst, val = _edges(n_dst, n_src, density)
    x = _x(n_src)
    want = ps._spmm_blocked_raw(j_from_arrays(src, dst, val, n_src, n_dst),
                                jnp.asarray(x), dtype=jdt)
    g = blocked_from_arrays(src, dst, val, n_src, n_dst, device="cpu")
    got = sb.spmm_blocked_raw(g, torch.tensor(x), tdt)
    assert got.dtype == torch.float32
    _close(got, want, tol, name)


def test_empty_dst_tiles_zeroed():
    """All edges land in dst rows < 100 of 1124: the rest are zeros, as in
    the JAX kernel, which zeroes tiles no chunk visits."""
    n_dst = 2 * 512 + 100
    src, dst, val = _edges(100, 64, 0.1, seed=2)
    x = _x(64)
    want = ps._spmm_blocked_raw(j_from_arrays(src, dst, val, 64, n_dst),
                                jnp.asarray(x), dtype=jnp.float32)
    got = sb.spmm_blocked_raw(blocked_from_arrays(src, dst, val, 64, n_dst,
                                                  device="cpu"),
                              torch.tensor(x), torch.float32)
    _close(got, want, 1e-5, "out")
    assert float(got[100:].abs().max()) == 0.0


@pytest.mark.parametrize("name", list(DTYPES))
def test_blocked_grad_matches_jax(name):
    """The gradient of sum(spmm_blocked(x) ** 2), which runs over
    ``pair.bwd``, against ``jax.grad``."""
    tdt, jdt, tol = DTYPES[name]
    src, dst, val = _edges(300, 250, 0.02, seed=3)
    x = _x(250, seed=4)
    jp = j_pair_from_arrays(src, dst, val, 250, 300)
    out_j, gx_j = jax.jit(jax.value_and_grad(
        lambda y: jnp.sum(ps.spmm_blocked(jp, y, jdt) ** 2)))(jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    loss = (sb.spmm_blocked(blocked_pair_from_arrays(
        src, dst, val, 250, 300, device="cpu"), xt, tdt) ** 2).sum()
    loss.backward()
    _close(loss, out_j, tol, "loss")
    _close(xt.grad, gx_j, tol, "dx")


def test_bf16_val_rounding_control():
    """In bf16 with U[0.5, 1.5) weights the blocked SpMM rounds val: its
    messages rnd(rnd(val) * rnd(x)) meet the bf16 tolerance against the
    JAX kernel, and the grouped SpMM's rnd(rnd(x) * val) miss it."""
    src, dst, val = _edges(600, 700, 0.01)
    x = _x(700)
    want = ps._spmm_blocked_raw(j_from_arrays(src, dst, val, 700, 600),
                                jnp.asarray(x), dtype=jnp.bfloat16)
    g = blocked_from_arrays(src, dst, val, 700, 600, device="cpu")
    xt = torch.tensor(x)
    b9 = segment_sum_plain(g.row_ptr, g.src, g.val, xt, True, round_val=True)
    b8 = segment_sum_plain(g.row_ptr, g.src, g.val, xt, True)
    assert torch.equal(b9, sb.spmm_blocked_raw(g, xt))
    _close(b9, want, 1e-4, "val rounded")
    with pytest.raises(AssertionError):
        _close(b8, want, 1e-4, "val not rounded")


def test_layout_from_a_padded_coo_graph():
    """``blocked_pair_from_coo`` drops a ``CooGraph``'s zero-weight padding
    and gives the layouts of its edges."""
    src, dst, val = _edges(600, 700, 0.01)
    g = coo_from_arrays(src, dst, val, 700, 600, pad_multiple=4096,
                        device="cpu")
    assert g.e_pad > len(src)
    a = blocked_pair_from_coo(g)
    b = blocked_pair_from_arrays(src, dst, val, 700, 600, device="cpu")
    x = torch.tensor(_x(700))
    assert a.fwd.n_live == len(src)
    for la, lb in ((a.fwd, b.fwd), (a.bwd, b.bwd)):
        assert torch.equal(la.row_ptr, lb.row_ptr)
    np.testing.assert_allclose(
        sb.spmm_blocked_raw(a.fwd, x, torch.float32).numpy(),
        sb.spmm_blocked_raw(b.fwd, x, torch.float32).numpy(), rtol=1e-6,
        atol=1e-5)


@pytest.mark.parametrize("name", list(DTYPES))
def test_prf_masked_pair_with_duplicates_matches_jax(name):
    """The JAX blocked layout carries no edge ids, so the PRF edge dropout
    is held against the JAX SpMM of the masked weights: the port's
    ``prf_mask_pair`` on a blocked pair drops, by live-edge index, the
    edges the JAX ``prf_keep_mask`` drops.  The edge list repeats edges and
    holds zero weights (dropped before the ids are counted)."""
    from dream_gnn_tpu.augment.masks import prf_keep_mask as j_keep
    from dream_gnn_tpu_torch.augment.masks import prf_mask_pair

    tdt, jdt, tol = DTYPES[name]
    src, dst, val = _edges(300, 250, 0.02, seed=5)
    src, dst, val = (np.concatenate([a, a[:50]]) for a in (src, dst, val))
    val[::7] = 0.0
    live = val != 0
    keep = np.asarray(j_keep(jnp.asarray(99, jnp.uint32),
                             jnp.arange(int(live.sum())), 0.3))
    masked = val.copy()
    masked[live] *= keep
    x = _x(250, seed=6)
    jp = j_pair_from_arrays(src, dst, masked, 250, 300)
    out_j, gx_j = jax.jit(jax.value_and_grad(
        lambda y: jnp.sum(ps.spmm_blocked(jp, y, jdt) ** 2)))(jnp.asarray(x))
    tp = prf_mask_pair(blocked_pair_from_arrays(src, dst, val, 250, 300,
                                                device="cpu"), 99, 0.3)
    xt = torch.tensor(x, requires_grad=True)
    loss = (sb.spmm_blocked(tp, xt, tdt) ** 2).sum()
    loss.backward()
    _close(loss, out_j, tol, "loss")
    _close(xt.grad, gx_j, tol, "dx")

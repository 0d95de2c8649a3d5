"""The port's grid decoder (plain PyTorch version, which the wrapper runs
for CPU tensors) against the Pallas kernel in interpret mode, and the
dropout hash against a numpy uint32 reference.

Tolerances: fp32 compares the same f32 arithmetic summed in another
order (rtol 1e-5, atol 1e-5 on O(1) values, as tests/test_grid_decoder.py
does for the Pallas kernel against XLA).  bf16 rounds at the same points
in both; an f32 sum that differs in its last bits may round to the
neighbouring bf16 value, so the bound is a few bf16 ulps (rtol 2e-2,
atol 1e-3).  Gradient sums over the grid get atol scaled by their
magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dream_gnn_tpu.kernels.pallas_decoder as pdm
import dream_gnn_tpu.kernels.pallas_grid_decoder as pgd
from dream_gnn_tpu.nn.decoder import decoder_apply_grid as j_grid
from dream_gnn_tpu.nn.decoder import decoder_init as j_decoder_init
from dream_gnn_tpu_torch.convert import params_from_jax
from dream_gnn_tpu_torch.kernels import grid_decoder as gd
from dream_gnn_tpu_torch.nn.decoder import decoder_apply_grid as t_grid

DTYPES = {"float32": (torch.float32, jnp.float32, 1e-5, 1e-5),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 2e-2, 1e-3)}
GRADS = ("dPd", "dPv", "db1", "dW2", "db2", "dw3")


@pytest.fixture(autouse=True)
def _interpret():
    old = pdm.INTERPRET
    pdm.INTERPRET = True
    yield
    pdm.INTERPRET = old


def _inputs(nd=37, nv=23, seed=0):
    rng = np.random.default_rng(seed)
    f = np.float32
    return dict(pd=rng.normal(0, 0.5, (nd, 128)).astype(f),
                pv=rng.normal(0, 0.5, (nv, 128)).astype(f),
                b1=rng.uniform(-0.1, 0.1, 128).astype(f),
                w2=rng.uniform(-0.1, 0.1, (128, 64)).astype(f),
                b2=rng.uniform(-0.1, 0.1, 64).astype(f),
                w3=rng.uniform(-0.2, 0.2, 64).astype(f),
                g=rng.normal(0, 1, (nd, nv)).astype(f))


NAMES = ("pd", "pv", "b1", "w2", "b2", "w3")


def _close(a, b, rtol, atol, what):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(1.0, float(np.abs(b).max()))
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol * scale,
                               err_msg=what)


@pytest.mark.parametrize("name", list(DTYPES))
def test_plain_matches_pallas_interpret(name):
    """Forward logits and all six gradients at rate 0."""
    tdt, jdt, rtol, atol = DTYPES[name]
    x = _inputs()
    jargs = [jnp.asarray(x[k]) for k in NAMES]
    seed_j = jnp.zeros((1,), jnp.int32)
    out_j = pgd.fused_grid_decoder(*jargs, seed_j, 0.0, True, jdt)
    g = jnp.asarray(x["g"])
    grads_j = jax.grad(
        lambda *a: jnp.sum(pgd.fused_grid_decoder(*a, seed_j, 0.0, True,
                                                  jdt) * g),
        argnums=tuple(range(6)))(*jargs)

    targs = [torch.tensor(x[k]) for k in NAMES]
    seed_t = torch.zeros(1, dtype=torch.int32)
    out_t = gd.grid_decoder_plain(*targs, seed_t, 0.0, True, tdt)
    grads_t = gd.grid_decoder_plain_bwd(*targs, seed_t, 0.0, True, tdt,
                                        torch.tensor(x["g"]))
    _close(out_t, out_j, rtol, atol, "logits")
    for gname, a, b in zip(GRADS, grads_t, grads_j):
        _close(a, b, rtol, atol, gname)


@pytest.mark.parametrize("name", list(DTYPES))
def test_fused_wrapper_autograd_on_cpu(name):
    """fused_grid_decoder on CPU tensors: the plain forward and the
    explicit plain backward through torch.autograd; no kernel launch."""
    tdt, jdt, rtol, atol = DTYPES[name]
    x = _inputs(nd=19, nv=41, seed=1)
    targs = [torch.tensor(x[k], requires_grad=True) for k in NAMES]
    seed = torch.zeros(1, dtype=torch.int32)
    before = dict(gd.LAUNCHES)
    out = gd.fused_grid_decoder(*targs, seed, 0.0, True, tdt)
    (out * torch.tensor(x["g"])).sum().backward()
    assert gd.LAUNCHES == before

    jargs = [jnp.asarray(x[k]) for k in NAMES]
    seed_j = jnp.zeros((1,), jnp.int32)
    grads_j = jax.grad(
        lambda *a: jnp.sum(pgd.fused_grid_decoder(*a, seed_j, 0.0, True,
                                                  jdt) * jnp.asarray(x["g"])),
        argnums=tuple(range(6)))(*jargs)
    for gname, t, b in zip(GRADS, targs, grads_j):
        _close(t.grad, b, rtol, atol, gname)


def test_plain_backward_matches_autograd_under_dropout():
    """The explicit backward against torch autograd of the plain forward,
    with dropout on (fp32: both are the same arithmetic, atol 1e-6)."""
    x = _inputs(seed=2)
    targs = [torch.tensor(x[k], requires_grad=True) for k in NAMES]
    seed = torch.tensor([987654321], dtype=torch.int32)
    out = gd.grid_decoder_plain(*targs, seed, 0.3, True, torch.float32)
    (out * torch.tensor(x["g"])).sum().backward()
    grads = gd.grid_decoder_plain_bwd(*[t.detach() for t in targs], seed, 0.3,
                                      True, torch.float32,
                                      torch.tensor(x["g"]))
    for gname, t, b in zip(GRADS, targs, grads):
        _close(t.grad, b, 1e-5, 1e-6, gname)


def _np_fmix32(x):
    x = x.astype(np.uint32)
    x ^= x >> np.uint32(16)
    x *= np.uint32(0x85EBCA6B)
    x ^= x >> np.uint32(13)
    x *= np.uint32(0xC2B2AE35)
    x ^= x >> np.uint32(16)
    return x


@pytest.mark.parametrize("seed", [0, 1, 2147483646, 123456789])
def test_dropout_bits_match_uint32_reference(seed):
    """The int64 hash equals the same hash in numpy uint32 arithmetic,
    so the CUDA kernel's uint32 masks are these bit for bit."""
    nd, nv, h = 5, 7, 128
    bits = gd.dropout_bits(torch.tensor([seed], dtype=torch.int32), 2,
                           nd, nv, h).numpy()
    with np.errstate(over="ignore"):
        x = _np_fmix32(np.uint32(seed) ^ np.uint32(2))
        x = _np_fmix32(x ^ np.arange(nd, dtype=np.uint32)[:, None, None])
        x = _np_fmix32(x ^ np.arange(nv, dtype=np.uint32)[None, :, None])
        x = _np_fmix32(x ^ np.arange(h, dtype=np.uint32)[None, None, :])
    np.testing.assert_array_equal(bits, x.astype(np.int64))


@pytest.mark.parametrize("rate", [0.1, 0.3, 0.5])
def test_mask_keep_rate(rate):
    """Keep rate within 5 sigma of 1-rate over 20*30*128 units; layers
    1 and 2 draw different masks; kept units carry 1/(1-rate)."""
    seed = torch.tensor([42], dtype=torch.int32)
    m1 = gd.dropout_mask(seed, 1, 20, 30, 128, rate)
    m2 = gd.dropout_mask(seed, 2, 20, 30, 128, rate)
    n = m1.numel()
    sigma = np.sqrt(rate * (1 - rate) / n)
    assert abs(float((m1 > 0).float().mean()) - (1 - rate)) < 5 * sigma
    assert abs(float((m2 > 0).float().mean()) - (1 - rate)) < 5 * sigma
    assert float(((m1 > 0) != (m2 > 0)).float().mean()) > 0.1
    np.testing.assert_allclose(m1[m1 > 0].numpy(),
                               np.float32(1) / np.float32(1 - rate))
    assert gd.keep_threshold(rate) == int(np.uint32(rate * 4294967295.0))


@pytest.mark.parametrize("name", list(DTYPES))
def test_decoder_apply_grid_fused_matches_jax(name):
    """Node projections (bf16 operands, f32 product) + kernel + b3, eval
    mode, against the JAX fused decoder in interpret mode."""
    tdt, jdt, rtol, atol = DTYPES[name]
    rng = np.random.default_rng(4)
    jp = j_decoder_init(jax.random.key(0), in_units=16)
    df = rng.normal(size=(13, 16)).astype(np.float32)
    vf = rng.normal(size=(9, 16)).astype(np.float32)
    ref = pgd.decoder_apply_grid_fused(jp, jnp.asarray(df), jnp.asarray(vf),
                                       dropout_rate=0.3, train=False,
                                       dtype=jdt)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    out = gd.decoder_apply_grid_fused(tp, torch.tensor(df), torch.tensor(vf),
                                      dropout_rate=0.3, train=False,
                                      dtype=tdt)
    _close(out, ref, rtol, atol, "logits")


@pytest.mark.parametrize("name", list(DTYPES))
def test_plain_grid_decoder_matches_jax(name):
    tdt, jdt, rtol, atol = DTYPES[name]
    rng = np.random.default_rng(5)
    jp = j_decoder_init(jax.random.key(1), in_units=16)
    df = rng.normal(size=(11, 16)).astype(np.float32)
    vf = rng.normal(size=(7, 16)).astype(np.float32)
    ref = j_grid(jp, jnp.asarray(df), jnp.asarray(vf), dropout_rate=0.0,
                 train=False, dtype=jdt)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    out = t_grid(tp, torch.tensor(df), torch.tensor(vf), dropout_rate=0.0,
                 train=False, dtype=tdt)
    _close(out, ref, rtol, atol, "logits")


def test_training_decoder_needs_generator():
    x = _inputs(nd=4, nv=3)
    p = {"w1": torch.zeros(256, 128), "b1": torch.tensor(x["b1"]),
         "w2": torch.tensor(x["w2"]), "b2": torch.tensor(x["b2"]),
         "w3": torch.tensor(x["w3"])[:, None], "b3": torch.zeros(1)}
    with pytest.raises(ValueError, match="generator"):
        gd.decoder_apply_grid_fused(p, torch.zeros(4, 128),
                                    torch.zeros(3, 128), dropout_rate=0.3,
                                    train=True)

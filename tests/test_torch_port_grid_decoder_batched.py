"""The port's fold-batched grid decoder (plain PyTorch version, which the
wrapper runs for CPU tensors) against the JAX ``fused_grid_decoder_batched``
with its Pallas kernels in interpret mode, and against the port's own
single-fold version fold by fold.

F = 3 folds of a 21 x 17 grid: no fold count equals a node count or a
width, so a bias broadcast over the wrong axis cannot pass.

Tolerances, as tests/test_torch_port_grid_decoder.py: fp32 compares the
same f32 arithmetic summed in another order (rtol 1e-5, atol 1e-5 scaled
by the magnitude); bf16 rounds at the same points in both, and an f32 sum
that differs in its last bits may round to the neighbouring bf16 value
(rtol 2e-2, atol 1e-3 scaled).  Fold f of the batched plain version
against the single-fold plain version with seed[f]: the same masks bit
for bit and the same arithmetic, batched or not (rtol 1e-6, atol 1e-6
scaled).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dream_gnn_tpu.kernels.pallas_decoder as pdm
import dream_gnn_tpu.kernels.pallas_grid_decoder as pgd
from dream_gnn_tpu.nn.decoder import decoder_init as j_decoder_init
from dream_gnn_tpu_torch.convert import params_from_jax
from dream_gnn_tpu_torch.kernels import grid_decoder as gd

DTYPES = {"float32": (torch.float32, jnp.float32, 1e-5, 1e-5),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 2e-2, 1e-3)}
GRADS = ("dPd", "dPv", "db1", "dW2", "db2", "dw3")
NAMES = ("pd", "pv", "b1", "w2", "b2", "w3")
F = 3


@pytest.fixture(autouse=True)
def _interpret():
    old = pdm.INTERPRET
    pdm.INTERPRET = True
    yield
    pdm.INTERPRET = old


def _inputs(nd=21, nv=17, seed=0):
    rng = np.random.default_rng(seed)
    f = np.float32
    return dict(pd=rng.normal(0, 0.5, (F, nd, 128)).astype(f),
                pv=rng.normal(0, 0.5, (F, nv, 128)).astype(f),
                b1=rng.uniform(-0.1, 0.1, (F, 128)).astype(f),
                w2=rng.uniform(-0.1, 0.1, (F, 128, 64)).astype(f),
                b2=rng.uniform(-0.1, 0.1, (F, 64)).astype(f),
                w3=rng.uniform(-0.2, 0.2, (F, 64)).astype(f),
                g=rng.normal(0, 1, (F, nd, nv)).astype(f))


def _close(a, b, rtol, atol, what):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, what
    scale = max(1.0, float(np.abs(b).max()))
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol * scale,
                               err_msg=what)


def _jax_ref(x, jdt):
    """JAX batched logits and the six gradients of sum(logits * g)."""
    jargs = [jnp.asarray(x[k]) for k in NAMES]
    seed = jnp.zeros((F,), jnp.int32)
    g = jnp.asarray(x["g"])
    out = pgd.fused_grid_decoder_batched(*jargs, seed, 0.0, True, jdt)
    grads = jax.grad(
        lambda *a: jnp.sum(pgd.fused_grid_decoder_batched(
            *a, seed, 0.0, True, jdt) * g), argnums=tuple(range(6)))(*jargs)
    return out, grads


@pytest.mark.parametrize("name", list(DTYPES))
def test_batched_plain_matches_pallas_interpret(name):
    """Logits and all six gradients at rate 0."""
    tdt, jdt, rtol, atol = DTYPES[name]
    x = _inputs()
    out_j, grads_j = _jax_ref(x, jdt)
    targs = [torch.tensor(x[k]) for k in NAMES]
    seed = torch.zeros(F, dtype=torch.int32)
    out_t = gd.grid_decoder_batched_plain(*targs, seed, 0.0, True, tdt)
    grads_t = gd.grid_decoder_batched_plain_bwd(*targs, seed, 0.0, True, tdt,
                                                torch.tensor(x["g"]))
    _close(out_t, out_j, rtol, atol, "logits")
    for gname, a, b in zip(GRADS, grads_t, grads_j):
        _close(a, b, rtol, atol, gname)


@pytest.mark.parametrize("name", list(DTYPES))
def test_batched_wrapper_autograd_on_cpu(name):
    """fused_grid_decoder_batched on CPU tensors: the plain forward and the
    explicit plain backward through torch.autograd, no kernel launch; the
    gradients equal grid_decoder_batched_plain_bwd and the JAX ones."""
    tdt, jdt, rtol, atol = DTYPES[name]
    x = _inputs(nd=19, nv=22, seed=1)
    targs = [torch.tensor(x[k], requires_grad=True) for k in NAMES]
    seed = torch.tensor([5, 6, 7], dtype=torch.int32)
    g = torch.tensor(x["g"])
    before = dict(gd.LAUNCHES)
    out = gd.fused_grid_decoder_batched(*targs, seed, 0.3, True, tdt)
    (out * g).sum().backward()
    assert gd.LAUNCHES == before
    refs = gd.grid_decoder_batched_plain_bwd(
        *[t.detach() for t in targs], seed, 0.3, True, tdt, g)
    for gname, t, r in zip(GRADS, targs, refs):
        assert torch.equal(t.grad, r), gname

    _, grads_j = _jax_ref(x, jdt)
    targs = [torch.tensor(x[k], requires_grad=True) for k in NAMES]
    out = gd.fused_grid_decoder_batched(*targs, torch.zeros(F, dtype=torch.int32),
                                        0.0, True, tdt)
    (out * g).sum().backward()
    for gname, t, b in zip(GRADS, targs, grads_j):
        _close(t.grad, b, rtol, atol, gname)


@pytest.mark.parametrize("name", list(DTYPES))
def test_fold_equals_single_fold_version(name):
    """Under dropout 0.3, fold f of the batched plain version is the
    single-fold plain version called with seed[f], forward and backward;
    its masks are the single-fold masks bit for bit and differ between
    folds."""
    tdt = DTYPES[name][0]
    x = _inputs(seed=2)
    targs = [torch.tensor(x[k]) for k in NAMES]
    g = torch.tensor(x["g"])
    seed = torch.tensor([11, 2147483646, 987654321], dtype=torch.int32)
    out = gd.grid_decoder_batched_plain(*targs, seed, 0.3, True, tdt)
    grads = gd.grid_decoder_batched_plain_bwd(*targs, seed, 0.3, True, tdt, g)
    masks = gd.dropout_mask(seed[:, None], 1, 21, 17, 128, 0.3)
    for f in range(F):
        one = [t[f] for t in targs]
        s = seed[f:f + 1]
        _close(out[f], gd.grid_decoder_plain(*one, s, 0.3, True, tdt),
               1e-6, 1e-6, f"fold {f} logits")
        refs = gd.grid_decoder_plain_bwd(*one, s, 0.3, True, tdt, g[f])
        for gname, a, b in zip(GRADS, grads, refs):
            _close(a[f], b, 1e-6, 1e-6, f"fold {f} {gname}")
        assert torch.equal(masks[f], gd.dropout_mask(s, 1, 21, 17, 128, 0.3))
    assert not torch.equal(masks[0], masks[1])
    assert not torch.equal(masks[1], masks[2])


@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("train", [False, True])
def test_decoder_apply_grid_fused_batched_matches_jax(name, train):
    """Node projections (bf16 operands, f32 product), the batched kernel's
    plain version and b3, against the JAX function of the same name; the
    training case at dropout 0, where no random draw is made."""
    tdt, jdt, rtol, atol = DTYPES[name]
    rng = np.random.default_rng(4)
    jps = [j_decoder_init(jax.random.key(s), in_units=16) for s in range(F)]
    jp = jax.tree.map(lambda *xs: jnp.stack(xs), *jps)
    df = rng.normal(size=(F, 13, 16)).astype(np.float32)
    vf = rng.normal(size=(F, 9, 16)).astype(np.float32)
    key = jax.vmap(jax.random.key)(jnp.arange(F, dtype=jnp.uint32))
    ref = pgd.decoder_apply_grid_fused_batched(
        jp, jnp.asarray(df), jnp.asarray(vf), dropout_rate=0.0, train=train,
        key=key, dtype=jdt)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    out = gd.decoder_apply_grid_fused_batched(
        tp, torch.tensor(df), torch.tensor(vf), dropout_rate=0.0, train=train,
        generator=torch.Generator(), dtype=tdt)
    assert out.shape == (F, 13, 9)
    _close(out, ref, rtol, atol, "logits")


def test_batched_decoder_draws_one_seed_per_fold():
    """In training with dropout, the F decoder seeds are one draw from the
    generator: a fresh generator with the same seed gives the same logits,
    and each fold draws its own mask."""
    tp = params_from_jax(jax.tree.map(np.asarray, jax.tree.map(
        lambda *xs: jnp.stack(xs),
        *[j_decoder_init(jax.random.key(s), in_units=8) for s in range(F)])),
        device="cpu")
    rng = np.random.default_rng(5)
    df = torch.tensor(rng.normal(size=(F, 6, 8)).astype(np.float32))
    vf = torch.tensor(rng.normal(size=(F, 5, 8)).astype(np.float32))

    def run(seed):
        return gd.decoder_apply_grid_fused_batched(
            tp, df, vf, dropout_rate=0.3, train=True,
            generator=torch.Generator().manual_seed(seed),
            dtype=torch.float32)

    a, b = run(1), run(1)
    assert torch.equal(a, b)
    assert not torch.equal(a, run(2))
    with pytest.raises(ValueError, match="generator"):
        gd.decoder_apply_grid_fused_batched(tp, df, vf, dropout_rate=0.3,
                                            train=True)

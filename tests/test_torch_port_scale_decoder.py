"""The port's scale decoder against the JAX package: ``scale_decoder`` (the
plain versions, which the wrapper runs for CPU tensors) against the JAX
``scale_decoder`` with its Pallas kernels (K2, B1, mirror, seq_scatter) in
interpret mode, at the same injected dropout seed: per-candidate logits and
all seven gradients in fp32 and bf16, dropout 0 and 0.3; the dropout masks
bit for bit; the layout's invariants.

Sizes: 2,000 candidates (with repeated nodes) over 300 drugs x 250
diseases, H1 = 128, H2 = 64, as the JAX package's own scale decoder tests.
Each side returns logits in its own slot order; both are unscrambled to
candidate order with their ``inv_slot``.

Tolerances (atol scaled by each array's magnitude).  fp32: the same f32
arithmetic in another summation order, rtol 1e-5, atol 1e-5.  bf16: both
round at the same points (the table rows, h1d, w2, da2, h2d, w3, the saved
a1 and da1); products of bf16 values are exact in f32, so the two differ by
the order of f32 sums only: rtol 1e-4, atol 1e-4.  A B1 that recomputes from
the unrounded a1 moves d_P_drug by far more (the control case).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dream_gnn_tpu.kernels.pallas_scale_decoder as psd
import dream_gnn_tpu.kernels.pallas_seq_scatter as psq
import dream_gnn_tpu.kernels.pallas_spmm_gather as psg
from dream_gnn_tpu_torch.kernels import scale_decoder as sd
from dream_gnn_tpu_torch.kernels.seq_scatter import seq_scatter

ND, NV, E = 300, 250, 2000
SEED = 918273
DTYPES = {"float32": (torch.float32, jnp.float32, 1e-5),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 1e-4)}
GRADS = ("d_P_drug", "d_P_dis", "db1", "dW2", "db2", "dw3", "db3")
_JAX = {}


@pytest.fixture(autouse=True)
def _interpret():
    old = psd.INTERPRET, psq.INTERPRET, psg.INTERPRET
    psd.INTERPRET = psq.INTERPRET = psg.INTERPRET = True
    yield
    psd.INTERPRET, psq.INTERPRET, psg.INTERPRET = old


def _case():
    rng = np.random.default_rng(0)
    f = np.float32
    return dict(pd=rng.normal(0, 0.5, (ND, 128)).astype(f),
                pv=rng.normal(0, 0.5, (NV, 128)).astype(f),
                b1=rng.uniform(-0.1, 0.1, 128).astype(f),
                w2=rng.uniform(-0.1, 0.1, (128, 64)).astype(f),
                b2=rng.uniform(-0.1, 0.1, 64).astype(f),
                w3=rng.uniform(-0.2, 0.2, 64).astype(f),
                b3=rng.uniform(-0.2, 0.2, 1).astype(f),
                src=rng.integers(0, ND, E), dst=rng.integers(0, NV, E),
                g=rng.normal(0, 1, E).astype(f))


NAMES = ("pd", "pv", "b1", "w2", "b2", "w3", "b3")


def _jax(name, rate):
    """JAX per-candidate logits and the seven gradients of
    sum(logits * g), cached per case."""
    if (name, rate) not in _JAX:
        x = _case()
        lay = psd.build_scale_decoder_layout(x["src"], x["dst"], ND, NV)
        seed = jnp.asarray([SEED], jnp.int32)
        g_slots, w = lay.slot_labels(jnp.asarray(x["g"]))
        out, vjp = jax.vjp(
            lambda *a: psd.scale_decoder(rate, True, DTYPES[name][1], lay, *a,
                                         seed),
            *[jnp.asarray(x[k]) for k in NAMES])
        inv = np.asarray(lay.inv_slot)
        _JAX[name, rate] = (np.asarray(out)[inv],
                            [np.asarray(v) for v in vjp(g_slots * w)])
    return _JAX[name, rate]


def _port(name, rate):
    """The port's per-candidate logits and seven gradients."""
    x = _case()
    lay = sd.build_scale_decoder_layout(x["src"], x["dst"], ND, NV,
                                        device="cpu")
    leaves = [torch.tensor(x[k], requires_grad=True) for k in NAMES]
    out = sd.scale_decoder(*leaves, lay, torch.tensor([SEED],
                                                      dtype=torch.int32),
                           rate, True, DTYPES[name][0])
    g_slots, _ = lay.slot_labels(x["g"])
    (out * g_slots).sum().backward()
    return (out.detach()[lay.inv_slot.long()].numpy(),
            [t.grad.numpy() for t in leaves])


def _close(a, b, tol, what):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape, what
    scale = max(1e-3, float(np.abs(b).max()))
    np.testing.assert_allclose(a, b, rtol=tol, atol=tol * scale,
                               err_msg=what)


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("name", list(DTYPES))
def test_scale_decoder_matches_jax(name, rate):
    tol = DTYPES[name][2]
    out_j, grads_j = _jax(name, rate)
    out_t, grads_t = _port(name, rate)
    _close(out_t, out_j, tol, "logits")
    for gname, a, b in zip(GRADS, grads_t, grads_j):
        _close(a, b, tol, gname)


def test_b1_from_unrounded_a1_misses_the_bf16_tolerance():
    """Control: with dropout on, a B1 that recomputes from the unrounded a1
    instead of the saved bf16 one moves d_P_drug beyond the bf16
    tolerance."""
    x = _case()
    lay = sd.build_scale_decoder_layout(x["src"], x["dst"], ND, NV,
                                        device="cpu")
    t = {k: torch.tensor(x[k]) for k in NAMES}
    seed, dt = torch.tensor([SEED], dtype=torch.int32), torch.bfloat16
    fwd = (lay.drug_of_slot, lay.dis_of_slot, lay.fwd_eid)
    a1 = sd._rows_a1(t["pd"], t["pv"], t["b1"], lay.drug_of_slot,
                     lay.dis_of_slot, dt)
    g_slots, _ = lay.slot_labels(x["g"])
    da1, *_ = sd.scale_bwd_plain(a1, t["pd"], t["pv"], *fwd, g_slots,
                                 t["b1"], t["w2"], t["b2"], t["w3"], seed,
                                 0.3, True, dt, True)
    d_pd = seq_scatter(lay.seq_drug, da1, dt)
    _close(_port("bfloat16", 0.3)[1][0], _jax("bfloat16", 0.3)[1][0], 1e-4,
           "d_P_drug")
    with pytest.raises(AssertionError):
        _close(d_pd, _jax("bfloat16", 0.3)[1][0], 1e-4, "unrounded a1")


@pytest.mark.parametrize("rate", [0.1, 0.3, 0.5])
def test_dropout_masks_bit_exact(rate):
    eid = np.concatenate([np.arange(3000), [2 ** 31 - 1, 123456789]])
    for seed in (0, SEED, 2 ** 31 - 2):
        m1_j, m2_j = psd._prf_masks(jnp.asarray(eid, jnp.int32), 64,
                                    jnp.asarray([seed], jnp.int32)[0], rate)
        m1, m2 = sd.slot_dropout_masks(torch.tensor(eid), torch.tensor(
            [seed], dtype=torch.int32), 128, 64, rate)
        np.testing.assert_array_equal(m1.numpy(), np.asarray(m1_j).T)
        np.testing.assert_array_equal(m2.numpy(), np.asarray(m2_j).T)


def test_layout_invariants():
    x = _case()
    src, dst = x["src"], x["dst"]
    lay = sd.build_scale_decoder_layout(src, dst, ND, NV, device="cpu")
    fwd, mir = lay.fwd_eid.long().numpy(), lay.mirror_eid.long().numpy()
    inv, gp = lay.inv_slot.long().numpy(), lay.gout_perm.long().numpy()
    assert lay.n_pos == lay.n_mpos == lay.n_edges == E
    for perm in (fwd, mir, inv, gp):
        assert np.array_equal(np.sort(perm), np.arange(E))
    np.testing.assert_array_equal(fwd[inv], np.arange(E))
    np.testing.assert_array_equal(fwd[gp], mir)
    np.testing.assert_array_equal(lay.drug_of_slot.numpy(), src[fwd])
    np.testing.assert_array_equal(lay.dis_of_slot.numpy(), dst[fwd])
    np.testing.assert_array_equal(lay.drug_of_mslot.numpy(), src[mir])
    np.testing.assert_array_equal(lay.dis_of_mslot.numpy(), dst[mir])
    assert np.all(np.diff(src[fwd]) >= 0) and np.all(np.diff(dst[mir]) >= 0)
    # Stable sorts: candidates of one node keep their list order.
    assert np.all(np.diff(fwd)[np.diff(src[fwd]) == 0] > 0)
    # slot_labels: the labels per candidate equal the JAX layout's.
    labels = np.arange(E, dtype=np.float32)
    lab, w = lay.slot_labels(labels)
    np.testing.assert_array_equal(lab.numpy()[inv], labels)
    assert torch.equal(w, torch.ones(E))
    jl = psd.build_scale_decoder_layout(src, dst, ND, NV)
    jlab, _ = jl.slot_labels(jnp.asarray(labels))
    np.testing.assert_array_equal(np.asarray(jlab)[np.asarray(jl.inv_slot)],
                                  lab.numpy()[inv])


def test_h1_and_unported_layouts_raise():
    x = _case()
    lay = sd.build_scale_decoder_layout(x["src"], x["dst"], ND, NV,
                                        device="cpu")
    t = [torch.tensor(x[k]) for k in NAMES]
    with pytest.raises(ValueError, match="H1"):
        sd.scale_decoder(t[0][:, :64], t[1][:, :64], t[2][:64], t[3][:64],
                         *t[4:], lay, torch.zeros(1, dtype=torch.int32), 0.0,
                         False)
    with pytest.raises(NotImplementedError, match="item 10"):
        sd.build_scale_decoder_layout(x["src"], x["dst"], ND, NV,
                                      rank_pad=4096, device="cpu")

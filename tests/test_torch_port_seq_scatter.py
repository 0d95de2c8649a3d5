"""The port's ``seq_scatter`` (the plain version, which the wrapper runs for
CPU tensors) against the JAX ``seq_scatter`` with its Pallas kernel in
interpret mode: a node-sorted slot stream with padding (``live`` False)
slots, empty nodes and random weights, in fp32 and bf16 modes, with f32 and
bf16 inputs; and the scale decoder's stream without padding or weights.

Sizes: 5,000 slots, 20% of them padding, over 3,000 nodes (most nodes
empty), d = 16 and 128.

Tolerances (atol scaled by the output's magnitude): both compute the same
messages (in bf16 mode rnd(rnd(x) * rnd(val))) and differ by the order of
their f32 sums only: rtol 1e-5, atol 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dream_gnn_tpu.kernels.pallas_seq_scatter as pseq
from dream_gnn_tpu_torch.kernels.seq_scatter import (build_seq_scatter,
                                                      seq_scatter)

N_SLOTS, N_DST = 5000, 3000


@pytest.fixture(autouse=True)
def _interpret():
    old = pseq.INTERPRET
    pseq.INTERPRET = True
    yield
    pseq.INTERPRET = old


def _stream(d):
    rng = np.random.default_rng(d)
    live = rng.random(N_SLOTS) > 0.2
    node = np.zeros(N_SLOTS, np.int64)
    node[live] = np.sort(rng.integers(0, N_DST, live.sum()))
    val = (rng.random(N_SLOTS) + 0.5).astype(np.float32)
    x = rng.normal(size=(N_SLOTS, d)).astype(np.float32)
    return node, live, val, x


@pytest.mark.parametrize("d,x_bf16", [(16, False), (128, True)])
@pytest.mark.parametrize("name", ["float32", "bfloat16"])
def test_seq_scatter_matches_jax(d, x_bf16, name):
    node, live, val, x = _stream(d)
    tdt, jdt = {"float32": (torch.float32, jnp.float32),
                "bfloat16": (torch.bfloat16, jnp.bfloat16)}[name]
    jx = jnp.asarray(x, jnp.bfloat16 if x_bf16 else jnp.float32)
    want = np.asarray(pseq.seq_scatter(
        pseq.build_seq_scatter(node, live, val, N_DST), jx, dtype=jdt))
    tx = torch.tensor(x).to(torch.bfloat16 if x_bf16 else torch.float32)
    got = seq_scatter(build_seq_scatter(node, live, val, N_DST,
                                        device="cpu"), tx, tdt).numpy()
    assert got.shape == want.shape == (N_DST, d)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale)
    empty = np.setdiff1d(np.arange(N_DST), node[live])
    assert empty.size and float(np.abs(got[empty]).max()) == 0.0


@pytest.mark.parametrize("name", ["float32", "bfloat16"])
def test_unit_weights_without_val(name):
    """A stream without padding or weights (the scale decoder's layout)
    gives the bits of the same stream with weights 1, and the JAX result."""
    rng = np.random.default_rng(7)
    node = np.sort(rng.integers(0, N_DST, N_SLOTS))
    x = rng.normal(size=(N_SLOTS, 16)).astype(np.float32)
    live, ones = np.ones(N_SLOTS, bool), np.ones(N_SLOTS, np.float32)
    tdt, jdt = {"float32": (torch.float32, jnp.float32),
                "bfloat16": (torch.bfloat16, jnp.bfloat16)}[name]
    g = build_seq_scatter(node, None, None, N_DST, device="cpu")
    assert g.val is None and g.n_slots == N_SLOTS
    got = seq_scatter(g, torch.tensor(x), tdt)
    weighted = build_seq_scatter(node, live, ones, N_DST, device="cpu")
    assert torch.equal(g.offsets, weighted.offsets)
    assert torch.equal(got, seq_scatter(weighted, torch.tensor(x), tdt))
    want = np.asarray(pseq.seq_scatter(
        pseq.build_seq_scatter(node, live, ones, N_DST), jnp.asarray(x),
        dtype=jdt))
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * scale)


def test_layout_offsets_and_padding():
    node, live, val, _ = _stream(16)
    g = build_seq_scatter(node, live, val, N_DST, device="cpu")
    off = g.offsets.numpy()
    assert off[0] == 0 and off[-1] == N_SLOTS and np.all(np.diff(off) >= 0)
    counts = np.bincount(node[live], minlength=N_DST)
    # A node's run holds its live slots plus the padding slots after them.
    assert np.all(np.diff(off) >= counts)
    np.testing.assert_array_equal(g.val.numpy(), np.where(live, val, 0.0))


def test_unsorted_stream_raises():
    with pytest.raises(ValueError, match="ascend"):
        build_seq_scatter(np.array([3, 1, 2]), np.ones(3, bool),
                          np.ones(3, np.float32), 5, device="cpu")

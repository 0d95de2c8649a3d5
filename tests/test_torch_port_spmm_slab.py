"""The port's slabbed encoder SpMM against the JAX package: ``spmm_slab``
(the plain version, which the wrapper runs for CPU tensors) against the JAX
``spmm_slab`` with its Pallas kernel in interpret mode, forward and VJP;
the PRF edge masks bit for bit; the slabbed ``gcmc_layer_apply`` with PRF
edge dropout against the JAX layer.

Sizes: 700 sources, 650 destinations, 6,000 edges with repeats, 10% of
them zero-weight (dropped at build), and no edge into the last 150
destinations (empty rows); d = 16 in fp32 and d = 128 in bf16.

Tolerances (atol scaled by the output's magnitude).  fp32: the same f32
products summed in another order, rtol 1e-5, atol 1e-5.  bf16: both round
x and each message to bf16 at the same points and sum in f32, so they
differ by the order of the sums only: rtol 1e-4, atol 1e-4.  An SpMM that
skips the bf16 rounding of x is off by about 2e-3 (the control case).
The layer: rtol 1e-4, atol 1e-5, as the dense layer's tests.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dream_gnn_tpu.kernels.pallas_spmm_slab as pss
from dream_gnn_tpu.augment.masks import prf_keep_mask as j_prf_keep_mask
from dream_gnn_tpu.augment.masks import prf_mask_pair as j_prf_mask_pair
from dream_gnn_tpu.graph.slabbed import \
    build_enc_graph_slabbed as j_build_enc_graph_slabbed
from dream_gnn_tpu.graph.slabbed import \
    slabbed_pair_from_arrays as j_pair_from_arrays
from dream_gnn_tpu.nn.gcmc import gcmc_layer_apply as j_gcmc_apply
from dream_gnn_tpu.nn.gcmc import gcmc_layer_init as j_gcmc_init
from dream_gnn_tpu_torch.augment.masks import (edge_dropout_masks_grouped,
                                               prf_keep_mask, prf_mask_graph,
                                               prf_mask_pair)
from dream_gnn_tpu_torch.graph import csr
from dream_gnn_tpu_torch.graph.slabbed import (build_enc_graph_slabbed,
                                               slabbed_pair_from_arrays)
from dream_gnn_tpu_torch.kernels import bilinear_decoder as bd
from dream_gnn_tpu_torch.kernels import spmm_slab as sp
from dream_gnn_tpu_torch.kernels.spmm_slab import spmm_slab
from dream_gnn_tpu_torch.nn.gcmc import gcmc_layer_apply
from tests import _segment_pieces as pieces_ref
from tests._torch_port_setup import numpy_tree

N_SRC, N_DST, E = 700, 650, 6000
DTYPES = {"float32": (torch.float32, jnp.float32, 1e-5),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 1e-4)}
_JAX = {}


@pytest.fixture(autouse=True)
def _interpret():
    old = pss.INTERPRET
    pss.INTERPRET = True
    yield
    pss.INTERPRET = old


def _close(a, b, rtol, atol, what):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b, np.float32)
    assert a.shape == b.shape, what
    scale = max(1e-3, float(np.abs(b).max()))
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol * scale,
                               err_msg=what)


def _edges():
    rng = np.random.default_rng(0)
    src = rng.integers(0, N_SRC, E)
    dst = rng.integers(0, N_DST - 150, E)
    val = (rng.random(E) + 0.5).astype(np.float32)
    val[rng.random(E) < 0.1] = 0.0
    return src, dst, val


def _jax_spmm(d, name):
    """JAX spmm_slab output and VJP (cached per case), with its x and
    cotangent."""
    if (d, name) not in _JAX:
        rng = np.random.default_rng(d)
        x = rng.normal(size=(N_SRC, d)).astype(np.float32)
        gout = rng.normal(size=(N_DST, d)).astype(np.float32)
        pair = j_pair_from_arrays(*_edges(), N_SRC, N_DST, tile=256, span=4,
                                  window=3)

        @jax.jit
        def run(y):
            out, vjp = jax.vjp(
                lambda z: pss.spmm_slab(pair, z, DTYPES[name][1]), y)
            return out, vjp(jnp.asarray(gout))[0]

        out, gx = run(jnp.asarray(x))
        _JAX[d, name] = (x, gout, np.asarray(out), np.asarray(gx))
    return _JAX[d, name]


@pytest.mark.parametrize("d,name", [(16, "float32"), (128, "bfloat16")])
def test_spmm_slab_matches_jax(d, name):
    tdt, _, tol = DTYPES[name]
    x, gout, out_j, gx_j = _jax_spmm(d, name)
    pair = slabbed_pair_from_arrays(*_edges(), N_SRC, N_DST, device="cpu")
    assert pair.fwd.n_live == pair.bwd.n_live == int((_edges()[2] != 0).sum())
    xt = torch.tensor(x, requires_grad=True)
    out = spmm_slab(pair, xt, tdt)
    out.backward(torch.tensor(gout))
    _close(out, out_j, tol, tol, "out")
    _close(xt.grad, gx_j, tol, tol, "dx")
    assert float(out.detach()[N_DST - 150:].abs().max()) == 0.0  # empty rows


def test_spmm_without_bf16_rounding_misses_the_tolerance():
    """Control: the messages without the bf16 rounding of x, held against
    the JAX bf16 SpMM, fail the bf16 tolerance."""
    x, _, out_j, _ = _jax_spmm(128, "bfloat16")
    g = slabbed_pair_from_arrays(*_edges(), N_SRC, N_DST, device="cpu").fwd
    out = sp.segment_sum_plain(g.row_ptr, g.src, g.val, torch.tensor(x),
                               rounded=False)
    with pytest.raises(AssertionError):
        _close(out, out_j, 1e-4, 1e-4, "unrounded")


def test_rounding_modes_are_the_kernel_enum():
    """rounding_mode hands the kernel the values of csrc/spmm.cu's ``enum
    Mode``, and refuses rounding val without x, which no mode does."""
    src = (Path(sp.__file__).parent / "csrc" / "spmm.cu").read_text()
    enum = {k: int(v) for k, v in re.findall(r"(MODE_\w+) = (\d+)", src)}
    assert enum == {"MODE_F32": sp.rounding_mode(False),
                    "MODE_RX": sp.rounding_mode(True),
                    "MODE_MSG": sp.rounding_mode(True, round_x=False),
                    "MODE_RX_RV": sp.rounding_mode(True, round_val=True)}
    with pytest.raises(ValueError):
        sp.rounding_mode(True, round_x=False, round_val=True)


@pytest.mark.parametrize("salt", [0, 12345, 2 ** 31 - 2])
def test_prf_keep_mask_bit_exact(salt):
    ids = np.concatenate([np.arange(20000), np.random.default_rng(1).integers(
        0, 2 ** 31 - 1, 20000)]).astype(np.int32)
    for rate in (0.1, 0.3, 0.5):
        want = np.asarray(j_prf_keep_mask(jnp.asarray(salt, jnp.uint32),
                                          jnp.asarray(ids), rate))
        got = prf_keep_mask(salt, torch.tensor(ids), rate).numpy()
        np.testing.assert_array_equal(got, want)
        assert 0.0 < got.mean() < 1.0


def _by_edge(g_val, g_eid, n_live):
    """A layout's weights indexed by physical edge id (padding dropped)."""
    val, eid = np.asarray(g_val).reshape(-1), np.asarray(g_eid).reshape(-1)
    out = np.zeros(n_live, np.float32)
    live = eid < n_live
    out[eid[live]] = val[live]
    return out


def test_prf_mask_pair_drops_the_jax_edges():
    """Both layouts of a pair drop, by physical edge id, exactly the edges
    the JAX prf_mask_pair drops, and keep their weights."""
    src, dst, val = _edges()
    jp = j_prf_mask_pair(j_pair_from_arrays(src, dst, val, N_SRC, N_DST),
                         jnp.asarray(777, jnp.uint32), 0.3)
    tp = prf_mask_pair(slabbed_pair_from_arrays(src, dst, val, N_SRC, N_DST,
                                                device="cpu"), 777, 0.3)
    n = tp.fwd.n_live
    for jl, tl in ((jp.fwd, tp.fwd), (jp.bwd, tp.bwd)):
        np.testing.assert_array_equal(_by_edge(tl.val, tl.edge_id, n),
                                      _by_edge(jl.val, jl.edge_id, n))
    dropped = _by_edge(tp.fwd.val, tp.fwd.edge_id, n) == 0
    assert 0.2 < dropped.mean() < 0.4


def _bipartite():
    rng = np.random.default_rng(3)
    nd, nv, e = 40, 30, 700
    cells = rng.choice(nd * nv, e, replace=False)
    pairs = np.stack([cells // nv, cells % nv])
    values = (rng.random(e) < 0.2).astype(np.int64)
    return pairs, values, nd, nv


def test_slabbed_graph_norms_match_jax():
    pairs, values, nd, nv = _bipartite()
    jg = j_build_enc_graph_slabbed(pairs, values, nd, nv)
    tg = build_enc_graph_slabbed(pairs, values, nd, nv, device="cpu")
    for f in ("ci_drug", "cj_drug", "ci_dis", "cj_dis"):
        np.testing.assert_array_equal(getattr(tg, f).numpy(),
                                      np.asarray(getattr(jg, f)), err_msg=f)
    for r in range(2):
        for side in ("fwd", "rev"):
            jl, tl = getattr(jg, side)[r].fwd, getattr(tg, side)[r].fwd
            assert tl.n_live == jl.n_live and tl.n_dst == jl.n_dst


def test_slabbed_gcmc_layer_matches_jax():
    """One GCMC layer over the slabbed graph with PRF edge dropout from the
    same salts (eval mode, so no node dropout): drug and disease outputs."""
    pairs, values, nd, nv = _bipartite()
    rng = np.random.default_rng(4)
    jg = j_build_enc_graph_slabbed(pairs, values, nd, nv)
    tg = build_enc_graph_slabbed(pairs, values, nd, nv, device="cpu")
    jparams = j_gcmc_init(jax.random.key(2), in_units=24, msg_units=16,
                          out_units=8)
    feats = [rng.normal(size=(n, 24)).astype(np.float32) for n in (nd, nv)]
    salts = np.array([[11, 22], [33, 44]], np.uint32)
    jm = {"fwd_salts": jnp.asarray(salts[0]), "rev_salts": jnp.asarray(
        salts[1]), "rate": 0.3, "kind": "grouped_prf"}
    tm = {"fwd_salts": torch.tensor(salts[0].astype(np.int64)),
          "rev_salts": torch.tensor(salts[1].astype(np.int64)), "rate": 0.3,
          "kind": "grouped_prf"}
    jout = jax.jit(lambda p, *f: j_gcmc_apply(
        p, jg, *f, dropout_rate=0.3, edge_masks=jm))(
        jparams, *map(jnp.asarray, feats))
    tparams = {k: torch.tensor(v) for k, v in numpy_tree(jparams).items()}
    tout = gcmc_layer_apply(tparams, prf_mask_graph(tg, tm),
                            *map(torch.tensor, feats), dropout_rate=0.3)
    for name, a, b in zip(("drug", "dis"), tout, jout):
        _close(a, b, 1e-4, 1e-5, name)


def test_grouped_salts_are_drawn_per_relation():
    pairs, values, nd, nv = _bipartite()
    tg = build_enc_graph_slabbed(pairs, values, nd, nv, device="cpu")
    m = edge_dropout_masks_grouped(torch.Generator().manual_seed(0), tg, 0.1)
    assert m["kind"] == "grouped_prf" and m["rate"] == 0.1
    assert m["fwd_salts"].shape == m["rev_salts"].shape == (2,)
    assert not torch.equal(m["fwd_salts"], m["rev_salts"])
    params = {k: torch.tensor(v) for k, v in numpy_tree(j_gcmc_init(
        jax.random.key(0), in_units=4, msg_units=4, out_units=4)).items()}
    with pytest.raises(ValueError, match="PRF"):
        prf_mask_graph(tg, {"fwd": None})
    # The dropout has one site: the layer refuses masks on a slabbed graph.
    with pytest.raises(ValueError, match="prf_mask_graph"):
        gcmc_layer_apply(params, tg, torch.zeros(nd, 4), torch.zeros(nv, 4),
                         dropout_rate=0.0, edge_masks=m)


# The narrow segment sum's pieces (graph/csr.py:segment_pieces): rows of
# 0 to 20,000 entries, at, under and over a piece's size.
def _skewed_lengths(n=400, seed=3):
    """Popularity-skewed row lengths, as GCMC's movies: a few long rows."""
    rank = np.random.default_rng(seed).permutation(n)
    return [int(6000 / (r + 3)) for r in rank]


PIECE_ROWS = {
    "short": [0, 1, 5, csr.PIECE, 0, 17],
    "boundaries": [0, csr.PIECE - 1, csr.PIECE, csr.PIECE + 1,
                   2 * csr.PIECE, 2 * csr.PIECE + 1, 0],
    "long": [3, 20_000, 0, 1],
    "skewed": _skewed_lengths(),
    "empty": [0, 0, 0],
}


def _ptr(lengths):
    return torch.tensor(np.concatenate([[0], np.cumsum(lengths)]),
                        dtype=torch.int32)


@pytest.mark.parametrize("k", [csr.PIECE, 7])
@pytest.mark.parametrize("rows", list(PIECE_ROWS))
def test_segment_pieces_cover_each_row_in_order(rows, k):
    """A row's first piece is its first min(len, k) entries; the further
    pieces of a longer row follow in order, at most k entries each, each
    listed once with its row, so that every entry is in exactly one piece;
    split_ptr gives each split row its further pieces; the sizes the
    counter reads are the counts of split rows and of their pieces."""
    lengths = PIECE_ROWS[rows]
    pc = csr.segment_pieces(_ptr(lengths), k)
    beg, row, split, start = [], [], [], 0
    for r, n in enumerate(lengths):
        if n > k:
            split.append((r, len(beg)))
            beg += [start + i * k for i in range(1, -(-n // k))]
            row += [r] * (-(-n // k) - 1)
        start += n
    assert pc.extra_beg.tolist() == beg
    assert pc.extra_row.tolist() == row
    assert pc.split_row.tolist() == [r for r, _ in split]
    assert pc.split_ptr.tolist() == [e for _, e in split] + [len(beg)]
    assert (pc.k, pc.n_rows, pc.nnz) == (k, len(lengths), start)
    assert pc.n_split == sum(n > k for n in lengths)
    assert pc.n_split + pc.n_extra == sum(-(-n // k) for n in lengths
                                          if n > k)
    covered = torch.zeros(start, dtype=torch.int64)
    ptr = _ptr(lengths).long()
    for b, n in zip(ptr[:-1].tolist(), lengths):
        covered[b:b + min(n, k)] += 1
    for b, r in zip(beg, row):
        covered[b:min(b + k, int(ptr[r + 1]))] += 1
    assert bool((covered == 1).all())
    assert all(t.dtype == torch.int32 for t in
               (pc.extra_beg, pc.extra_row, pc.split_row, pc.split_ptr))


@pytest.mark.parametrize("d", [3, 50])
@pytest.mark.parametrize("mode", [(False, True, False), (True, True, False),
                                  (True, False, False), (True, True, True)],
                         ids=["f32", "rx", "msg", "rx_rv"])
def test_piece_order_sum_matches_plain(mode, d):
    """The narrow kernel's order of additions, emulated: pieces in list
    order, then each split row's partial rows in piece order, agrees with
    segment_sum_plain within the kernel tests' 1e-4 of the largest value,
    and is exactly it on rows of one piece (f32 sums of the same messages
    in the same order)."""
    lengths = PIECE_ROWS["skewed"] + PIECE_ROWS["boundaries"]
    ptr = _ptr(lengths)
    rng = np.random.default_rng(7)
    nnz = int(ptr[-1])
    src = torch.tensor(rng.integers(0, 900, nnz), dtype=torch.int32)
    val = torch.tensor((rng.random(nnz) + 0.5).astype(np.float32))
    x = torch.tensor(rng.normal(size=(900, d)).astype(np.float32))
    out = pieces_ref.piece_order_sum(ptr, src, val, x, *mode)
    ref = sp.segment_sum_plain(ptr, src, val, x, *mode)
    err = float((out - ref).abs().max()) / float(ref.abs().max())
    assert err <= 1e-4
    one = torch.tensor(lengths) <= csr.PIECE
    plain = pieces_ref.run_sums(ptr[:-1].long(), ptr[1:].long() - ptr[:-1],
                                pieces_ref.messages(src, val, x, *mode))
    assert torch.equal(out[one], plain[one])


def _layouts():
    from dream_gnn_tpu_torch.graph.blocked import blocked_pair_from_arrays
    from dream_gnn_tpu_torch.graph.grouped import grouped_pair_from_arrays

    args = (*_edges(), N_SRC, N_DST)
    yield "slabbed", slabbed_pair_from_arrays(*args, device="cpu").fwd
    yield "grouped", grouped_pair_from_arrays(*args, device="cpu").bwd
    yield "blocked", blocked_pair_from_arrays(*args, device="cpu").fwd


@pytest.mark.parametrize("kind", ["slabbed", "grouped", "blocked"])
def test_layouts_carry_their_pieces(kind):
    """Each CSR layout (graph/csr.py) is built with its rows' pieces, which
    the PRF edge dropout's masked copies keep."""
    g = dict(_layouts())[kind]
    want = csr.segment_pieces(g.row_ptr)
    for f in ("extra_beg", "extra_row", "split_row", "split_ptr"):
        assert torch.equal(getattr(g.pieces, f), getattr(want, f)), f
    assert (g.pieces.k, g.pieces.n_rows, g.pieces.nnz) == \
        (want.k, want.n_rows, want.nnz)
    if kind == "slabbed":
        pair = slabbed_pair_from_arrays(*_edges(), N_SRC, N_DST,
                                        device="cpu")
        masked = prf_mask_pair(pair, 5, 0.3)
        assert masked.fwd.pieces is pair.fwd.pieces


def test_seq_scatter_layout_carries_its_pieces():
    """build_seq_scatter cuts its nodes' runs once, as the CSR layouts do,
    so that the scatter's launches build none."""
    from dream_gnn_tpu_torch.kernels.seq_scatter import build_seq_scatter

    lengths = PIECE_ROWS["skewed"]
    node = torch.repeat_interleave(torch.arange(len(lengths)),
                                   torch.tensor(lengths))
    g = build_seq_scatter(node, None, None, len(lengths), device="cpu")
    want = csr.segment_pieces(_ptr(lengths))
    assert torch.equal(g.offsets, _ptr(lengths))
    for f in ("extra_beg", "extra_row", "split_row", "split_ptr"):
        assert torch.equal(getattr(g.pieces, f), getattr(want, f)), f
    assert (g.pieces.n_rows, g.pieces.nnz, g.pieces.n_split) == \
        (want.n_rows, want.nnz, want.n_split) and want.n_split > 0


@pytest.mark.parametrize("pieces", ["none", "other rows"])
def test_narrow_launch_needs_its_rows_pieces(pieces):
    """A launch at a width that is not a multiple of 8 is refused without
    the pieces of its ptr's rows, before any kernel is loaded: the launch
    builds none itself."""
    lengths = PIECE_ROWS["boundaries"]
    ptr = _ptr(lengths)
    nnz = int(ptr[-1])
    src = torch.zeros(nnz, dtype=torch.int32)
    x = torch.ones(4, 50)
    pc = None if pieces == "none" else csr.segment_pieces(_ptr(lengths[1:]))
    with pytest.raises(ValueError, match="pieces"):
        sp.launch_segment_sum(ptr, src, None, x, False, pieces=pc)


@pytest.mark.parametrize("task", [bd.TASK, 7])
def test_bilinear_tasks_are_the_shared_cut(task):
    """The bilinear decoder's tasks, cut by graph/csr.py:cut_runs, are each
    node's run cut into pieces of at most ``task`` positions, nodes
    without positions having none: the same as before the cut was
    shared."""
    counts = [0, 3, task, task + 1, 0, 5 * task - 2, 1]
    node_of_pos = torch.repeat_interleave(torch.arange(len(counts)),
                                          torch.tensor(counts))
    node, beg, tptr = bd._tasks(node_of_pos.int(), len(counts), task)
    want_node, want_beg, want_tptr, start = [], [], [0], 0
    for n, c in enumerate(counts):
        for i in range(-(-c // task)):
            want_node.append(n)
            want_beg.append(start + i * task)
        want_tptr.append(len(want_node))
        start += c
    assert node.tolist() == want_node
    assert beg.tolist() == want_beg + [start]
    assert tptr.tolist() == want_tptr
    assert node.dtype == beg.dtype == tptr.dtype == torch.int32

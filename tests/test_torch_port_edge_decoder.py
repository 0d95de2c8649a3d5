"""The port's per-edge decoders against the JAX package: the fused
decoder's plain version (which the wrapper runs for CPU tensors) against
``fused_decoder`` and ``fused_decoder_batched`` with their Pallas kernels
in interpret mode, the plain ``decoder_apply`` against JAX
``decoder_apply``, and the edge decoder against the port's grid decoder.

Sizes: E = 300 edges over 37 x 23 nodes, F = 3 folds; no fold count equals
a node count or a width.

Tolerances.  fp32: the same f32 arithmetic summed in another order, rtol
1e-5 with atol 1e-5 scaled by the magnitude.  bf16: both round at the same
points and differ only in the order of f32 sums; the largest error
measured here is 2.3e-6 of the magnitude, so rtol 1e-4, atol 1e-4 scaled.
That is tight enough to see the two bf16 contracts apart: the fused
decoder rounds the node tables and decoder_apply does not, which moves the
logits by about 1e-2 of their magnitude.  Port against port with the same
masks (fold f against the single-fold version, edges against grid cells):
rtol 1e-6, atol 1e-6 scaled.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dream_gnn_tpu.kernels.pallas_decoder as pdm
import dream_gnn_tpu.kernels.pallas_decoder_batched as pdb
from dream_gnn_tpu.nn.decoder import decoder_apply as j_decoder_apply
from dream_gnn_tpu.nn.decoder import decoder_init as j_decoder_init
from dream_gnn_tpu_torch.convert import params_from_jax
from dream_gnn_tpu_torch.data.loader import DreamDataset
from dream_gnn_tpu_torch.data.synthetic import synthetic_raw_data
from dream_gnn_tpu_torch.kernels import edge_decoder as ed
from dream_gnn_tpu_torch.kernels import grid_decoder as gd
from dream_gnn_tpu_torch.nn.decoder import decoder_apply

DTYPES = {"float32": (torch.float32, jnp.float32, 1e-5, 1e-5),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 1e-4, 1e-4)}
GRADS = ("dPd", "dPv", "db1", "dW2", "db2", "dw3", "db3")
NAMES = ("pd", "pv", "b1", "w2", "b2", "w3", "b3")
ND, NV, E, F = 37, 23, 300, 3


@pytest.fixture(autouse=True)
def _interpret():
    old = pdm.INTERPRET
    pdm.INTERPRET = True
    yield
    pdm.INTERPRET = old


def _inputs(nf=None, seed=0):
    """Tables, weights, b3, edges (with repeated nodes) and a cotangent."""
    rng = np.random.default_rng(seed)
    f = np.float32
    lead = () if nf is None else (nf,)
    return dict(pd=rng.normal(0, 0.5, (*lead, ND, 128)).astype(f),
                pv=rng.normal(0, 0.5, (*lead, NV, 128)).astype(f),
                b1=rng.uniform(-0.1, 0.1, (*lead, 128)).astype(f),
                w2=rng.uniform(-0.1, 0.1, (*lead, 128, 64)).astype(f),
                b2=rng.uniform(-0.1, 0.1, (*lead, 64)).astype(f),
                w3=rng.uniform(-0.2, 0.2, (*lead, 64)).astype(f),
                b3=rng.uniform(-0.2, 0.2, (*lead, 1)).astype(f),
                edges=np.stack([rng.integers(0, ND, (*lead, E)),
                                rng.integers(0, NV, (*lead, E))],
                               axis=-2).astype(np.int32),
                g=rng.normal(0, 1, (*lead, E)).astype(f))


def _close(a, b, rtol, atol, what):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, what
    scale = max(1.0, float(np.abs(b).max()))
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol * scale,
                               err_msg=what)


def _jax_ref(x, jdt, batched):
    """JAX logits and the seven gradients of sum(logits * g), rate 0."""
    fn = pdb.fused_decoder_batched if batched else pdm.fused_decoder
    jargs = [jnp.asarray(x[k]) for k in NAMES]
    edges = jnp.asarray(x["edges"])
    seed = jnp.zeros((F,) if batched else (1,), jnp.int32)
    g = jnp.asarray(x["g"])
    out = fn(*jargs, edges, seed, 0.0, True, jdt)
    grads = jax.grad(lambda *a: jnp.sum(fn(*a, edges, seed, 0.0, True, jdt)
                                        * g), argnums=tuple(range(7)))(*jargs)
    return out, grads


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("name", list(DTYPES))
def test_plain_matches_pallas_interpret(name, batched):
    """The plain forward (+ b3) and explicit backward (+ db3 = sum g) at
    rate 0: logits and all seven gradients."""
    tdt, jdt, rtol, atol = DTYPES[name]
    x = _inputs(F if batched else None)
    out_j, grads_j = _jax_ref(x, jdt, batched)
    targs = [torch.tensor(x[k]) for k in NAMES[:6]]
    edges, g = torch.tensor(x["edges"]), torch.tensor(x["g"])
    seed = torch.zeros(F if batched else 1, dtype=torch.int32)
    plain = ed.edge_decoder_batched_plain if batched else ed.edge_decoder_plain
    plain_bwd = ed.edge_decoder_batched_plain_bwd if batched \
        else ed.edge_decoder_plain_bwd
    b3 = torch.tensor(x["b3"])
    out_t = plain(*targs, edges, seed, 0.0, True, tdt) \
        + (b3 if batched else b3[0])
    grads_t = (*plain_bwd(*targs, edges, seed, 0.0, True, tdt, g),
               g.sum(-1, keepdim=True))
    _close(out_t, out_j, rtol, atol, "logits")
    for gname, a, b in zip(GRADS, grads_t, grads_j):
        _close(a, b, rtol, atol, gname)


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("name", list(DTYPES))
def test_wrapper_autograd_on_cpu(name, batched):
    """fused_decoder(_batched) on CPU tensors: the plain forward (+ b3) and
    the explicit plain backward through torch.autograd, no kernel launch;
    under dropout the gradients equal the plain backward's bit for bit
    (which test_plain_matches_pallas_interpret holds against JAX), and
    db3 is the sum of g."""
    tdt = DTYPES[name][0]
    x = _inputs(F if batched else None, seed=1)
    fn = ed.fused_decoder_batched if batched else ed.fused_decoder
    plain_bwd = ed.edge_decoder_batched_plain_bwd if batched \
        else ed.edge_decoder_plain_bwd
    edges, g = torch.tensor(x["edges"]), torch.tensor(x["g"])
    seed = torch.tensor([5, 6, 7][:F if batched else 1], dtype=torch.int32)
    targs = [torch.tensor(x[k], requires_grad=True) for k in NAMES]
    before = dict(ed.LAUNCHES)
    (fn(*targs, edges, seed, 0.3, True, tdt) * g).sum().backward()
    assert ed.LAUNCHES == before
    refs = plain_bwd(*[t.detach() for t in targs[:6]], edges, seed, 0.3, True,
                     tdt, g)
    for gname, t, r in zip(GRADS, targs, refs):
        assert torch.equal(t.grad, r), gname
    assert torch.equal(targs[6].grad, g.sum(-1, keepdim=True))


@pytest.mark.parametrize("name", list(DTYPES))
def test_fold_equals_single_fold_version(name):
    """Under dropout 0.3, fold f of the batched plain version is the
    single-fold plain version called with seed[f], forward and backward;
    the folds draw different masks."""
    tdt = DTYPES[name][0]
    x = _inputs(F, seed=2)
    targs = [torch.tensor(x[k]) for k in NAMES[:6]]
    edges, g = torch.tensor(x["edges"]), torch.tensor(x["g"])
    seed = torch.tensor([11, 2147483646, 987654321], dtype=torch.int32)
    out = ed.edge_decoder_batched_plain(*targs, edges, seed, 0.3, True, tdt)
    grads = ed.edge_decoder_batched_plain_bwd(*targs, edges, seed, 0.3, True,
                                              tdt, g)
    for f in range(F):
        one = [t[f] for t in targs]
        s = seed[f:f + 1]
        _close(out[f], ed.edge_decoder_plain(*one, edges[f], s, 0.3, True,
                                             tdt), 1e-6, 1e-6, f"fold {f}")
        refs = ed.edge_decoder_plain_bwd(*one, edges[f], s, 0.3, True, tdt,
                                         g[f])
        for gname, a, b in zip(GRADS, grads, refs):
            _close(a[f], b, 1e-6, 1e-6, f"fold {f} {gname}")
    src, dst = edges[:, 0].long(), edges[:, 1].long()
    masks = ed.edge_dropout_mask(seed[:, None], 1, src, dst, 128, 0.3)
    assert not torch.equal(masks[0], masks[1])


def test_edges_equal_grid_cells():
    """In fp32 with dropout 0.3, the edge decoder's logit of edge (i, j) is
    the grid decoder's cell [i, j], and each gradient that sums over edges
    is the grid's gradient with g placed on the edges' cells."""
    x = _inputs(seed=3)
    targs = [torch.tensor(x[k]) for k in NAMES[:6]]
    seed = torch.tensor([4242], dtype=torch.int32)
    # Unique pairs, so that g on the edges' cells is g itself.
    cells = np.random.default_rng(3).permutation(ND * NV)[:E]
    edges = torch.tensor(np.stack([cells // NV, cells % NV]), dtype=torch.int32)
    out = ed.edge_decoder_plain(*targs, edges, seed, 0.3, True, torch.float32)
    grid = gd.grid_decoder_plain(*targs, seed, 0.3, True, torch.float32)
    src, dst = edges[0].long(), edges[1].long()
    _close(out, grid[src, dst], 1e-6, 1e-6, "logits")
    g = torch.tensor(x["g"])
    g_grid = torch.zeros(ND, NV)
    g_grid[src, dst] = g
    for gname, a, b in zip(GRADS, ed.edge_decoder_plain_bwd(
            *targs, edges, seed, 0.3, True, torch.float32, g),
            gd.grid_decoder_plain_bwd(*targs, seed, 0.3, True, torch.float32,
                                      g_grid)):
        _close(a, b, 1e-5, 1e-5, gname)


def _decoder_params(nf=None, seed=0):
    keys = [jax.random.key(seed + s) for s in range(nf or 1)]
    jps = [j_decoder_init(k, in_units=16) for k in keys]
    jp = jps[0] if nf is None else jax.tree.map(lambda *xs: jnp.stack(xs),
                                                *jps)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _features(nf=None, seed=4):
    rng = np.random.default_rng(seed)
    lead = () if nf is None else (nf,)
    x = _inputs(nf, seed)
    return (rng.normal(size=(*lead, ND, 16)).astype(np.float32),
            rng.normal(size=(*lead, NV, 16)).astype(np.float32),
            x["edges"][..., 0, :], x["edges"][..., 1, :])


@pytest.mark.parametrize("name", list(DTYPES))
def test_decoder_apply_matches_jax(name):
    """The plain per-edge decoder against JAX decoder_apply in eval mode,
    for one fold and over a leading fold axis (JAX vmapped)."""
    tdt, jdt, rtol, atol = DTYPES[name]
    jp, tp = _decoder_params()
    df, vf, src, dst = _features()
    ref = j_decoder_apply(jp, jnp.asarray(src), jnp.asarray(dst),
                          jnp.asarray(df), jnp.asarray(vf), dropout_rate=0.3,
                          dtype=jdt)
    out = decoder_apply(tp, torch.tensor(src), torch.tensor(dst),
                        torch.tensor(df), torch.tensor(vf), dropout_rate=0.3,
                        dtype=tdt)
    assert out.shape == (E,)
    _close(out, ref, rtol, atol, "logits")

    jp, tp = _decoder_params(F)
    df, vf, src, dst = _features(F)
    ref = jax.vmap(lambda p, s, d, a, b: j_decoder_apply(
        p, s, d, a, b, dropout_rate=0.3, dtype=jdt))(
        jp, jnp.asarray(src), jnp.asarray(dst), jnp.asarray(df),
        jnp.asarray(vf))
    out = decoder_apply(tp, torch.tensor(src), torch.tensor(dst),
                        torch.tensor(df), torch.tensor(vf), dropout_rate=0.3,
                        dtype=tdt)
    assert out.shape == (F, E)
    _close(out, ref, rtol, atol, "stacked logits")


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("name", list(DTYPES))
def test_decoder_apply_fused_matches_jax(name, batched):
    """Node projections (bf16 operands, f32 product), the kernel's plain
    version and b3, against the JAX function of the same name, in training
    at dropout 0, where no random draw is made."""
    train = True
    tdt, jdt, rtol, atol = DTYPES[name]
    nf = F if batched else None
    jp, tp = _decoder_params(nf)
    df, vf, src, dst = _features(nf)
    if batched:
        key = jax.vmap(jax.random.key)(jnp.arange(F, dtype=jnp.uint32))
        ref = pdb.decoder_apply_fused_batched(
            jp, jnp.asarray(src), jnp.asarray(dst), jnp.asarray(df),
            jnp.asarray(vf), dropout_rate=0.0, train=train, key=key,
            dtype=jdt)
        fn = ed.decoder_apply_fused_batched
    else:
        ref = pdm.decoder_apply_fused(
            jp, jnp.asarray(src), jnp.asarray(dst), jnp.asarray(df),
            jnp.asarray(vf), dropout_rate=0.0, train=train,
            key=jax.random.key(0), dtype=jdt)
        fn = ed.decoder_apply_fused
    out = fn(tp, torch.tensor(src), torch.tensor(dst), torch.tensor(df),
             torch.tensor(vf), dropout_rate=0.0, train=train,
             generator=torch.Generator(), dtype=tdt)
    _close(out, ref, rtol, atol, "logits")


@pytest.mark.parametrize("name", list(DTYPES))
def test_each_decoder_holds_to_its_own_contract(name):
    """In bf16 the fused decoder's contract rounds the node tables and
    decoder_apply's does not: each port function agrees with its own JAX
    counterpart and misses the bf16 tolerance against the other's, so the
    tests can tell the two apart.  In fp32 all four agree."""
    tdt, jdt, rtol, atol = DTYPES[name]
    jp, tp = _decoder_params()
    df, vf, src, dst = _features()
    jin = [jnp.asarray(a) for a in (src, dst, df, vf)]
    tin = [torch.tensor(a) for a in (src, dst, df, vf)]
    refs = {f: f(jp, *jin, dropout_rate=0.0, dtype=jdt)
            for f in (j_decoder_apply, pdm.decoder_apply_fused)}
    for ours, own, other in (
            (decoder_apply, j_decoder_apply, pdm.decoder_apply_fused),
            (ed.decoder_apply_fused, pdm.decoder_apply_fused,
             j_decoder_apply)):
        out = ours(tp, *tin, dropout_rate=0.0, dtype=tdt)
        _close(out, refs[own], rtol, atol, f"{ours.__name__} vs its own")
        if tdt == torch.float32:
            _close(out, refs[other], rtol, atol, f"{ours.__name__} vs other")
        else:
            with pytest.raises(AssertionError):
                _close(out, refs[other], rtol, atol, "other")


@pytest.mark.parametrize("preset", ["Gdataset", "Cdataset", "lrssl"])
def test_loader_candidate_pairs_are_unique(preset):
    """Every fold's real candidate pairs are unique (a pair listed twice
    would draw one dropout mask for both); the padding edges point at
    (0, 0) with weight 0."""
    ds = DreamDataset(synthetic_raw_data(preset, seed=0), k=4, device="cpu")
    for cv in range(len(ds.splits)):
        split, fold = ds.splits[cv], ds.fold(cv)
        for pairs, src, dst, w in (
                (split.train_pairs, fold.train_src, fold.train_dst,
                 fold.train_w),
                (split.test_pairs, fold.test_src, fold.test_dst, fold.test_w)):
            e = pairs.shape[1]
            keys = pairs[0].astype(np.int64) * ds.n_dis + pairs[1]
            assert np.unique(keys).size == e, (preset, cv)
            assert int(w.sum()) == e
            assert not src[e:].any() and not dst[e:].any() \
                and not w[e:].any()


def _order_case(kind, nf, seed):
    """Edges (..., E) over 37 drugs and 75 diseases (three column blocks,
    the last of 11): random pairs with repeats, unique pairs padded with
    the loader's (0, 0) to a multiple of 256, or a sparse list (the first
    column block empty, a third of the drugs absent from each other)."""
    nd, nv = 37, 75
    rng = np.random.default_rng(seed)
    lists = []
    for _ in range(nf or 1):
        if kind == "repeats":
            pairs = np.stack([rng.integers(0, nd, 3000),
                              rng.integers(0, nv, 3000)])
        else:
            cells = rng.permutation(nd * nv)
            if kind == "sparse":
                d, j = cells // nv, cells % nv
                cells = cells[(j >= 32) & ((d + j // 32) % 3 > 0)][:640]
            else:
                cells = cells[:2000]
                cells = np.concatenate([cells, np.zeros(
                    -len(cells) % 256, np.int64)])
            pairs = np.stack([cells // nv, cells % nv])
            if kind == "padded":
                pairs[:, 2000:] = 0
        lists.append(pairs)
    edges = torch.tensor(np.stack(lists) if nf else lists[0])
    return edges[..., 0, :], edges[..., 1, :], nd, nv


@pytest.mark.parametrize("kind", ["repeats", "padded", "sparse"])
@pytest.mark.parametrize("batched", [False, True])
def test_edge_order(batched, kind):
    """The ordering lists every edge once, by (dst // 32, src) and in list
    order within a pair; its column-block offsets count the edges of the
    lower blocks; each column block's parts start where a drug's run
    starts and hold exactly the runs of their drugs; and the partial sums
    the backward takes over it, for every grouping of the parts into
    blocks, give the index_add sums, each (column block, drug) row and each
    dPv row of a block written once."""
    src, dst, nd, nv = _order_case(kind, F if batched else None, seed=5)
    order = ed.edge_order(src, dst, nd, nv)
    ne, n_cb = src.shape[-1], -(-nv // 32)
    n_part = order.split_edge.shape[-1] - 1
    assert n_part == ed.order_parts(ne, nv) > 1
    assert order.perm.dtype == order.split_edge.dtype \
        == order.split_drug.dtype == torch.int32
    assert order.split_edge.shape == order.split_drug.shape \
        == (*src.shape[:-1], n_cb, n_part + 1)
    rows = torch.tensor(np.random.default_rng(5).normal(
        size=(*src.shape, 4)).astype(np.float32))
    for f in range(F if batched else 1):
        p, se, sd, i, j, r = (x[f] if batched else x for x in (
            order.perm.long(), order.split_edge.long(),
            order.split_drug.long(), src.long(), dst.long(), rows))
        assert torch.equal(torch.sort(p).values, torch.arange(ne))
        key = (j // 32) * nd + i
        ref = sorted(range(ne), key=lambda e: (int(key[e]), e))
        assert p.tolist() == ref
        col_off = (order.col_off[f] if batched else order.col_off).long()
        assert col_off.tolist() == [int((j // 32 < c).sum())
                                    for c in range(n_cb + 1)]
        assert torch.equal(se[:, 0], col_off[:-1])
        assert torch.equal(se[:, -1], col_off[1:])
        assert bool((sd[:, 0] == 0).all()) and bool((sd[:, -1] == nd).all())
        assert bool((se.diff() >= 0).all()) and bool((sd.diff() >= 0).all())
        ps, pj = i[p], j[p]
        for c in range(n_cb):
            for s in range(n_part):
                lo, hi = int(se[c, s]), int(se[c, s + 1])
                # A part starts at its column block or where a run starts.
                assert lo == int(se[c, 0]) or lo == int(se[c, -1]) \
                    or ps[lo] != ps[lo - 1]
                held = ps[lo:hi]
                assert bool(((held >= sd[c, s]) & (held < sd[c, s + 1]))
                            .all())
                assert bool((pj[lo:hi] // 32 == c).all())
        ref_pd = torch.zeros(nd, 4).index_add_(0, i, r)
        ref_pv = torch.zeros(nv, 4).index_add_(0, j, r)
        for n_split in sorted({1, 2, n_part}):
            dpd = torch.full((n_cb, nd, 4), float("nan"))
            dpv = torch.zeros(n_split, nv, 4)
            for c in range(n_cb):
                for b in range(n_split):
                    g0, g1 = b * n_part // n_split, (b + 1) * n_part // n_split
                    d_lo, d_hi = int(sd[c, g0]), int(sd[c, g1])
                    assert bool(dpd[c, d_lo:d_hi].isnan().all())
                    dpd[c, d_lo:d_hi] = 0.0
                    for q in range(int(se[c, g0]), int(se[c, g1])):
                        dpd[c, ps[q]] += r[p[q]]
                        dpv[b, pj[q]] += r[p[q]]
            assert not bool(dpd.isnan().any())
            torch.testing.assert_close(dpd.sum(0), ref_pd)
            torch.testing.assert_close(dpv.sum(0), ref_pv)


@pytest.mark.parametrize("nf,n_split", [(1, 13), (10, 13), (100, 3)])
def test_edge_order_parts_fill_waves(nf, n_split):
    """At one fold's 167,168 training edges over 313 diseases the ordering
    cuts each of the 10 column blocks into 13 parts, and a backward launch
    of nf folds takes them in n_split groups: whole waves of one block on
    each of 132 SMs, filled to 63/64 or more."""
    n_part = ed.order_parts(167_168, 313)
    assert n_part == 13
    assert ed.bwd_split(nf, 313, n_part) == n_split
    blocks = nf * 10 * n_split
    assert blocks / (-(-blocks // 132) * 132) >= 63 / 64


def test_seeds_drawn_once_per_call():
    """In training with dropout the decoder seeds are one draw from the
    generator: a fresh generator with the same seed gives the same logits,
    another seed other logits, and no generator raises."""
    _, tp = _decoder_params(F)
    df, vf, src, dst = [torch.tensor(a) for a in _features(F)]

    def run(seed):
        return ed.decoder_apply_fused_batched(
            tp, src, dst, df, vf, dropout_rate=0.3, train=True,
            generator=torch.Generator().manual_seed(seed), dtype=torch.float32)

    a, b = run(1), run(1)
    assert torch.equal(a, b)
    assert not torch.equal(a, run(2))
    with pytest.raises(ValueError, match="generator"):
        ed.decoder_apply_fused(tp[0] if isinstance(tp, list) else
                               {k: v[0] for k, v in tp.items()}, src[0],
                               dst[0], df[0], vf[0], dropout_rate=0.3,
                               train=True)

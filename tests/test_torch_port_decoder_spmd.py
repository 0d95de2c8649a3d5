"""The three decoder wrappers of the dp x mp mesh
(dream_gnn_tpu_torch/sharding/decoder_spmd.py) against the JAX package's,
and the grid decoder's dropout hash with row and column bases.

The JAX side runs ``decoder_apply_grid_fused_batched(mesh=)``,
``decoder_apply_fused_batched(mesh=)`` and ``fused_grid_decoder_spmd2d``
on a 2 x 2 mesh of the conftest's virtual devices, its Pallas kernels in
interpret mode (tests/test_decoder_spmd.py of the JAX package: F = 3 folds,
Nd = 10, Nv = 9, E = 37 edges, none divisible by the mesh).  The port runs
them over 2 x 2 gloo ranks on the CPU, where the wrappers run the kernels'
plain versions, spawned once for the module through a file under
``tmp_path`` (tests/_torch_port_mesh_worker.py): each rank takes its block
of the folds (``fold_rows``), decodes its mp block of the columns or edges,
and the whole stack's logits are gathered.  Dropout 0, f32: logits and the
gradients of sum(sin(logits)) at JAX's tolerance, rtol 1e-4, atol 1e-5.

With dropout 0.5 the mesh is held against the same wrappers without a mesh
on one rank, with the same seeds: the logits bit for bit (every block
hashes its cells by their global row and column, or by the edge's node
ids), the gradients within 1e-5 of each one's largest (the mp blocks'
weight gradients are summed as partial sums, in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dream_gnn_tpu.kernels.pallas_decoder as pdk
from dream_gnn_tpu.kernels.pallas_decoder_batched import \
    decoder_apply_fused_batched as j_edges
from dream_gnn_tpu.kernels.pallas_grid_decoder import \
    decoder_apply_grid_fused_batched as j_grid
from dream_gnn_tpu.kernels.pallas_grid_decoder import \
    fused_grid_decoder_spmd2d as j_spmd2d
from dream_gnn_tpu.nn.decoder import decoder_init
from dream_gnn_tpu.sharding.mesh import make_mesh as j_make_mesh
from dream_gnn_tpu_torch.kernels import grid_decoder as gd
from dream_gnn_tpu_torch.sharding.multihost import spawn
import _torch_port_mesh_worker as W

DP, MP = 2, 2


def _problem():
    """The JAX test's decoder weights, features and edges, as numpy."""
    p = W.DECODER
    keys = jax.random.split(jax.random.key(0), p["f"])
    params = jax.vmap(lambda k: decoder_init(
        k, in_units=p["d"], hidden1=p["h1"], hidden2=p["h2"]))(keys)
    kd, kv, ks, kt = jax.random.split(jax.random.key(1), 4)
    drug = jax.random.normal(kd, (p["f"], p["nd"], p["d"]), jnp.float32)
    dis = jax.random.normal(kv, (p["f"], p["nv"], p["d"]), jnp.float32)
    src = jax.random.randint(ks, (p["f"], p["e"]), 0, p["nd"])
    dst = jax.random.randint(kt, (p["f"], p["e"]), 0, p["nv"])
    return params, drug, dis, src, dst


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX wrappers' logits and gradients of sum(sin(logits))."""
    params, drug, dis, src, dst = _problem()
    mesh = j_make_mesh(dp=DP, mp=MP, devices=jax.devices()[:DP * MP])
    kw = dict(dropout_rate=0.0, train=False, dtype=jnp.float32, mesh=mesh)

    def grid(p):
        logits = j_grid(p, drug, dis, **kw)
        return jnp.sum(jnp.sin(logits)), logits

    def edges(p):
        logits = j_edges(p, src, dst, drug, dis, **kw)
        return jnp.sum(jnp.sin(logits)), logits

    def spmd2d(p):
        d = drug.shape[2]
        logits = j_spmd2d(mesh, "dp", "mp", drug[0] @ p["w1"][:d],
                          dis[0] @ p["w1"][d:], p["b1"], p["w2"], p["b2"],
                          p["w3"][:, 0], jnp.zeros((1,), jnp.int32), 0.0,
                          False, jnp.float32) + p["b3"][0]
        return jnp.sum(jnp.sin(logits)), logits

    old = pdk.INTERPRET
    pdk.INTERPRET = True
    try:
        out = {}
        for tag, fn, p in (("grid", grid, params), ("edges", edges, params),
                           ("spmd2d", spmd2d,
                            jax.tree.map(lambda x: x[0], params))):
            (_, logits), grads = jax.jit(jax.value_and_grad(
                fn, has_aux=True))(p)
            out[f"{tag}_logits"] = np.asarray(logits)
            out.update({f"{tag}_grad/{k}": np.asarray(v)
                        for k, v in grads.items()})
    finally:
        pdk.INTERPRET = old
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    params, drug, dis, src, dst = _problem()
    d = tmp_path_factory.mktemp("decoder_spmd")
    torch.save({"decoder": jax.tree.map(np.asarray, params),
                "drug_feat": np.asarray(drug), "dis_feat": np.asarray(dis),
                "src": np.asarray(src), "dst": np.asarray(dst)},
               d / "inputs.pt")
    spawn(W.run, DP * MP, "gloo",
          (str(d), ("wrappers", "wrappers_dropout"), DP, MP), cpu=True,
          workdir=str(d))
    return [torch.load(d / f"rank{r}.pt", weights_only=False)
            for r in range(DP * MP)]


def test_ranks_agree(ranks):
    """Every rank holds the same gathered logits and whole gradients."""
    for r in ranks[1:]:
        for k, v in r.items():
            if "/1/" not in k:
                np.testing.assert_array_equal(v, ranks[0][k], err_msg=k)


@pytest.mark.parametrize("tag", ["grid", "edges", "spmd2d"])
def test_wrapper_matches_jax(ranks, jax_ref, tag):
    """fused_grid_decoder_batched_spmd, fused_decoder_batched_spmd and
    fused_grid_decoder_spmd2d: logits and every weight's gradient."""
    got = ranks[0]
    keys = [k for k in jax_ref if k.startswith(f"{tag}_")]
    assert len(keys) == 7
    for k in keys:
        np.testing.assert_allclose(got[k], jax_ref[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("tag", ["grid", "edges", "spmd2d"])
def test_wrapper_with_dropout_matches_one_rank(ranks, tag):
    """Dropout 0.5: the mesh draws one rank's masks, so the logits are one
    rank's bit for bit and the gradients differ by the order of sums."""
    r0 = ranks[0]
    keys = [k for k in r0 if k.startswith(f"drop/S/{tag}_")]
    assert len(keys) == 7
    for k in keys:
        one = r0[k.replace("/S/", "/1/")]
        if k.endswith("logits"):
            np.testing.assert_array_equal(r0[k], one, err_msg=k)
            assert (one != 0).any() and np.isfinite(one).all()
        else:
            scale = max(float(np.abs(one).max()), 1e-12)
            np.testing.assert_allclose(r0[k], one, rtol=1e-5,
                                       atol=1e-5 * scale, err_msg=k)


# ---------------------------------------------------------------------------
# The grid hash with row and column bases (no ranks).

@pytest.mark.parametrize("rows,cols", [((0, 7), (3, 9)), ((5, 11), (0, 4)),
                                       ((2, 3), (6, 7))])
def test_hash_with_bases_is_a_block_of_the_whole(rows, cols):
    """With bases, the hash bits of a block equal that block of the whole
    grid's, bit for bit, for one seed and for a fold stack of seeds."""
    nd, nv, h = 11, 9, 8
    for seed in (torch.tensor([918273]), torch.tensor([[5], [2 ** 31 - 2]])):
        whole = gd.dropout_bits(seed, 2, nd, nv, h)
        block = gd.dropout_bits(seed, 2, rows[1] - rows[0], cols[1] - cols[0],
                                h, rows[0], cols[0])
        assert torch.equal(block, whole[..., rows[0]:rows[1],
                                        cols[0]:cols[1], :])


def test_hash_with_bases_of_zero_is_unchanged():
    """Bases of 0 give the hash of the definition in kernels/grid_decoder.py
    (fmix32 over seed ^ layer, i, j, k), as before the bases."""
    nd, nv, h = 6, 5, 128
    seed = torch.tensor([123456789])
    i = torch.arange(nd).view(nd, 1, 1)
    j = torch.arange(nv).view(1, nv, 1)
    k = torch.arange(h).view(1, 1, h)
    for layer in (1, 2):
        want = gd.hash_bits(seed.view(1, 1, 1), layer, i, j, k)
        assert torch.equal(gd.dropout_bits(seed, layer, nd, nv, h), want)
        assert torch.equal(gd.dropout_bits(seed, layer, nd, nv, h, 0, 0),
                           want)


@pytest.mark.parametrize("batched", [False, True])
def test_plain_decoder_with_bases_is_a_block_of_the_whole(batched):
    """The plain grid decoder on a block, with the block's bases, gives
    that block of the whole grid's logits, and its backward the block's
    share of the gradients, with dropout 0.3."""
    rng = np.random.default_rng(0)
    nf, nd, nv = (2,) if batched else (), 9, 7
    t = lambda *s: torch.tensor(rng.normal(size=s), dtype=torch.float32)
    pd, pv = t(*nf, nd, 128) * 0.3, t(*nf, nv, 128) * 0.3
    w = (t(*nf, 128) * 0.1, t(*nf, 128, 64) * 0.1, t(*nf, 64) * 0.1,
         t(*nf, 64) * 0.3)
    seed = torch.tensor([77, 91] if batched else [77], dtype=torch.int32)
    fwd = gd.grid_decoder_batched_plain if batched else gd.grid_decoder_plain
    bwd = gd.grid_decoder_batched_plain_bwd if batched \
        else gd.grid_decoder_plain_bwd
    args = (seed, 0.3, True, torch.float32)
    whole = fwd(pd, pv, *w, *args)
    g = t(*nf, nd, nv)
    r0, r1, c0, c1 = 2, 8, 3, 7
    blk = fwd(pd[..., r0:r1, :], pv[..., c0:c1, :], *w, *args, r0, c0)
    torch.testing.assert_close(blk, whole[..., r0:r1, c0:c1], rtol=1e-6,
                               atol=1e-6)
    gw = bwd(pd, pv, *w, *args, g)
    gb = bwd(pd[..., r0:r1, :], pv[..., c0:c1, :], *w, *args,
             g[..., r0:r1, c0:c1].contiguous(), r0, c0)
    # Only the block's cells reach the gradients: the whole grid's with g
    # zero outside the block.
    g_in = torch.zeros_like(g)
    g_in[..., r0:r1, c0:c1] = g[..., r0:r1, c0:c1]
    gz = bwd(pd, pv, *w, *args, g_in)
    torch.testing.assert_close(gb[0], gz[0][..., r0:r1, :], rtol=1e-5,
                               atol=1e-6)
    torch.testing.assert_close(gb[1], gz[1][..., c0:c1, :], rtol=1e-5,
                               atol=1e-6)
    for a, b in zip(gb[2:], gz[2:]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    assert not torch.equal(gw[2], gz[2])

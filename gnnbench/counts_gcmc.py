"""Operations and bytes of GCMC alone's training step (configuration
``gcmc-ml10m``), counted from its shapes, and the bilinear decoder
kernel's least time; the peaks are ``counts.py``'s.

Per rating, with B basis matrices of width D and R levels, the kernel does
2BD + 2RB operations forward (the B dots, the R logits) and 3 x 2BD + 2 x
2RB backward (the dots again, the users' and the movies' node sums, ds and
da).  Its least bytes are each input read once and each output written
once: forward the user and movie ids (8 bytes a rating), the tables u P
(n_users x B x D) and v, and the (R, E) logits; backward the cotangent
(R floats a rating), the ids and the movie order (12 bytes a rating),
u P, u and v, and the node sums d(u P) and W (B x D a node).  The
segment sums of the encoder read float32 messages (``counts.py`` counts
bf16 ones).  The program never reads this file.
"""

from __future__ import annotations

from gnnbench import counts


def bilinear_work(n_edges: float, n_users: int, n_movies: int, r: int,
                  b: int, d: int) -> tuple:
    """((ops by dtype, bytes) of the forward launch, the same of the
    backward's passes)."""
    tables = (n_users * b * d + n_movies * d) * 4
    fwd = ({"float32": n_edges * (2 * b * d + 2 * r * b)},
           n_edges * (8 + 4 * r) + tables)
    bwd = ({"float32": n_edges * (3 * 2 * b * d + 2 * 2 * r * b)},
           n_edges * (4 * r + 12) + tables + n_users * d * 4
           + (n_users + n_movies) * b * d * 4)
    return fwd, bwd


def bilinear_least_s(n_edges: float, n_users: int, n_movies: int, r: int,
                     b: int, d: int) -> float:
    """The kernel's least time: the forward's and the backward's least
    times (each the larger of its operations and its bytes), summed, since
    the two never run at once."""
    return sum(counts.least_seconds(ops, nbytes) for ops, nbytes in
               bilinear_work(n_edges, n_users, n_movies, r, b, d))


def segment_sum_bytes(n_src: int, n_dst: int, nnz: int, d: int) -> float:
    """Bytes of one float32 segmented sum: the row pointers, the entries'
    sources and weights, x once and the output once."""
    return (n_dst + 1) * 4 + nnz * 8 + n_src * d * 4 + n_dst * d * 4


def step_ops(cfg: dict, edges_by_level, n_train: int) -> dict:
    """Operations by dtype of one training step."""
    t = counts.Ops()
    nu, nm = cfg["n_users"], cfg["n_movies"]
    r, units = cfg["num_ratings"], cfg["gcn_agg_units"]
    msg, d, b = units // r, cfg["gcn_out_units"], cfg["gen_r_num_basis_func"]
    for e in edges_by_level:
        # Two directions, each a forward sum and its transposed backward.
        t.add(2 * 2 * 2.0 * e * msg)
    t.mm(nu + nm, units, d, grads=2)                 # ifc, fc
    t.mm(nu, d, b * d, grads=2)                      # u P
    t.mm(nm, b * d, d, grads=0)                      # dv = W P
    t.add(sum(ops["float32"]
              for ops, _ in bilinear_work(n_train, nu, nm, r, b, d)))
    t.add(6.0 * r * n_train)                         # softmax cross-entropy
    return t.by_dtype

"""Operations and bytes of a training step, counted from the configuration's
shapes, and the H100's peaks they are held to.

The decoder's per-cell operations are copied from the port's
``utils/timing.py`` (``decoder_flops``): 2*H1*H2 + 2*H1 + 2*H2 in the
forward, and 2*(2*H1*H2) + 4*H2 + 3*H1 more in the backward, without the
recomputed forward that the kernels run.  The segment sum's bytes follow
``PERF.md``'s table of kernels (rows 9-12): each input read once and the
float32 output written once.  The peaks are NVIDIA's published H100 SXM
figures (dense, at 700 W), as ``utils/timing.py`` has them.

A product (m x k) @ (k x n) is 2mkn operations forward and 2mkn more for
each operand that takes a gradient.  The program never reads this file.
"""

from __future__ import annotations

PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12


def decoder_cell_ops(h1: int, h2: int) -> tuple:
    """(forward, backward) operations of the decoder MLP on one cell."""
    fwd = 2 * h1 * h2 + 2 * h1 + 2 * h2
    bwd = 2 * (2 * h1 * h2) + 4 * h2 + 3 * h1
    return fwd, bwd


def least_seconds(ops: dict, nbytes: float = 0.0) -> float:
    """The least time the card could take: the larger of the operations
    (by dtype, each at its own peak) and the bytes at the memory rate."""
    t_ops = sum(n / PEAK_FLOPS[dt] for dt, n in ops.items())
    return max(t_ops, nbytes / PEAK_BYTES)


class Ops:
    """A tally of operations by dtype."""

    def __init__(self):
        self.by_dtype = {"float32": 0.0, "bfloat16": 0.0}

    def mm(self, m, k, n, grads: int, dtype="float32", times=1):
        """``times`` products (m x k) @ (k x n), ``grads`` of whose operands
        take a gradient."""
        self.by_dtype[dtype] += times * 2.0 * m * k * n * (1 + grads)

    def add(self, n, dtype="float32"):
        self.by_dtype[dtype] += n


def _msg_units(cfg: dict, i: int) -> int:
    return cfg["gcn_agg_units"] // 3 if i == 0 else cfg["gcn_out_units"]


def _gcmc(t: Ops, cfg: dict, nd: int, nv: int, in0: int, aggregate):
    """The GCMC layers; ``aggregate(t, msg)`` counts a layer's
    aggregations of width ``msg`` over every rating and both directions."""
    r, b, out = cfg["num_ratings"], cfg["basis_units"], cfg["gcn_out_units"]
    for i in range(cfg["layers"]):
        fin, msg = (in0 if i == 0 else out), _msg_units(cfg, i)
        x_grad = 0 if i == 0 else 1
        t.mm(r, b, fin * msg, grads=2)                     # att . basis
        t.mm(nd, fin, msg, grads=1 + x_grad, times=r)     # X_drug W_r
        t.mm(nv, fin, msg, grads=1 + x_grad, times=r)     # X_dis W_r
        aggregate(t, msg)
        t.mm(nd + nv, msg, out, grads=2)                 # the shared Linear


def _attention_and_tables(t: Ops, cfg: dict, nd: int, nv: int):
    out, a = cfg["gcn_out_units"], cfg["attention_hidden"]
    for n in (nd, nv):
        t.mm(2 * n, out, a, grads=2)
        t.mm(2 * n, a, 1, grads=2)
    # The decoder's node tables: bf16 operands.
    t.mm(nd + nv, out, cfg["decoder_hidden1"], grads=2, dtype="bfloat16")


def dense_step(cfg: dict, nd: int, nv: int, cells: float) -> dict:
    """Operations by dtype of one model's training step on the dense
    encoder graph, with ``cells`` decoder cells or edges."""
    t = Ops()

    def aggregate(t, msg):
        r = cfg["num_ratings"]
        t.mm(nv, nd, msg, grads=1, times=r)  # A_r^T (.): A takes no grad
        t.mm(nd, nv, msg, grads=1, times=r)

    _gcmc(t, cfg, nd, nv, cfg["embed_dim"], aggregate)
    h1, h2 = cfg["nhid1"], cfg["nhid2"]
    for n in (nd, nv):               # the FGCN input width is the node count
        t.mm(n, n, h1, grads=1, times=2)      # sim rows . w1 (no input grad)
        t.mm(n, n, h1, grads=1, times=2)      # adjacency . (.)
        t.mm(n, h1, h2, grads=2, times=2)
        t.mm(n, n, h2, grads=1, times=2)
        t.mm(n, 2 * h2, h2, grads=2)          # fusion
    _attention_and_tables(t, cfg, nd, nv)
    if cfg["beta"]:
        for n in (nd, nv):                    # two Gram matrices per entity
            t.mm(n, cfg["gcn_out_units"], n, grads=1, times=2)
    fwd, bwd = decoder_cell_ops(cfg["decoder_hidden1"], cfg["decoder_hidden2"])
    t.add(cells * (fwd + bwd), "bfloat16")
    return t.by_dtype


def sparse_step(cfg: dict, nd: int, nv: int, edges_by_rating, cells: float,
                d: int) -> dict:
    """Operations by dtype of one training step of the scale path: sparse
    GCMC aggregation (2 operations an edge and unit, forward and
    backward), the FGCN on identity graphs, no feature graphs."""
    t = Ops()

    def aggregate(t, msg):
        for e in edges_by_rating:
            # Two directions, each a forward sum and its transposed backward.
            t.add(2 * 2 * 2.0 * e * msg)

    _gcmc(t, cfg, nd, nv, d, aggregate)
    h1, h2 = cfg["nhid1"], cfg["nhid2"]
    for n in (nd, nv):
        t.mm(n, d, h1, grads=1)               # features . w1 (no input grad)
        t.add(2 * 2.0 * n * h1)               # identity graph, fwd + bwd
        t.mm(n, h1, h2, grads=2)
        t.add(2 * 2.0 * n * h2)
    _attention_and_tables(t, cfg, nd, nv)
    fwd, bwd = decoder_cell_ops(cfg["decoder_hidden1"], cfg["decoder_hidden2"])
    t.add(cells * (fwd + bwd), "bfloat16")
    return t.by_dtype


def decoder_work(cfg: dict, nd: int, nv: int, cells: float,
                 indexed: bool) -> tuple:
    """(ops by dtype, bytes) of the decoder MLP's forward and backward over
    ``cells`` cells or candidates of one model: the node tables, weights
    and per-cell indices (``indexed``) read, the logits written, the
    cotangent read and the gradients written, each once."""
    h1, h2 = cfg["decoder_hidden1"], cfg["decoder_hidden2"]
    fwd, bwd = decoder_cell_ops(h1, h2)
    tables = (nd + nv) * h1 * 4
    weights = (h1 + h1 * h2 + 2 * h2 + 1) * 4
    per_cell = 4 + 4 + (8 if indexed else 0)       # logit, cotangent, ids
    nbytes = 2 * (tables + weights) + cells * per_cell
    return {"bfloat16": cells * (fwd + bwd)}, nbytes


def segment_sum_bytes(n_src: int, n_dst: int, nnz: int, d: int,
                      gathered: bool = True) -> float:
    """Bytes of one segmented sum: the row pointers, the entries' sources
    and weights (``gathered``), x once in bf16, the float32 output."""
    entries = nnz * 8 if gathered else 0
    return (n_dst + 1) * 4 + entries + n_src * d * 2 + n_dst * d * 4

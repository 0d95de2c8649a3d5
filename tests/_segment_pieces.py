"""The segment sum kernel's orders of addition (csrc/spmm.cu) in plain
PyTorch, for the tests on the CPU and on the card; imports no JAX.

On the card each matches the kernel bit for bit where a message is exact
before it is added (a rounded mode, or f32 messages whose weights are
powers of two): the kernel adds a f32 product into its sum with one fused
multiply-add."""

import torch

from dream_gnn_tpu_torch.kernels.grid_decoder import round_to


def messages(src, val, x, rounded, round_x=True, round_val=False):
    """Each entry's f32 message, rounded as ``segment_sum_plain`` rounds
    it."""
    nnz = (src if src is not None else val).shape[0]
    xs = (x[src.long()] if src is not None else x[:nnz]).float()
    dtype = torch.bfloat16 if rounded else torch.float32
    msg = round_to(xs, dtype) if round_x else xs
    if val is not None:
        msg = msg * (round_to(val, dtype) if round_val else val)[:, None]
    return round_to(msg, dtype)


def run_sums(starts, lens, rows):
    """(len(starts), d): the rows ``starts[i] .. starts[i] + lens[i] - 1``
    of ``rows`` added one by one in order, from 0."""
    acc = torch.zeros((starts.shape[0], rows.shape[1]), dtype=torch.float32,
                      device=rows.device)
    for j in range(int(lens.max()) if lens.numel() else 0):
        live = lens > j
        acc[live] = acc[live] + rows[starts[live] + j]
    return acc


def piece_order_sum(ptr, src, val, x, rounded, round_x=True,
                    round_val=False, pieces=None):
    """The narrow path's order: each piece's messages in list order from 0
    (a row's first piece into its output), then each split row's partial
    rows added to its output in piece order."""
    from dream_gnn_tpu_torch.graph.csr import segment_pieces

    pc = segment_pieces(ptr) if pieces is None else pieces
    msg = messages(src, val, x, rounded, round_x, round_val)
    p = ptr.long()
    out = run_sums(p[:-1], torch.clamp_max(p[1:] - p[:-1], pc.k), msg)
    beg, row = pc.extra_beg.long(), pc.extra_row.long()
    part = run_sums(beg, torch.clamp_max(p[row + 1] - beg, pc.k), msg)
    sp = pc.split_ptr.long()
    split = pc.split_row.long()
    for t in range(int((sp[1:] - sp[:-1]).max()) if pc.n_split else 0):
        live = sp[1:] - sp[:-1] > t
        out[split[live]] = out[split[live]] + part[sp[:-1][live] + t]
    return out


def wide_order_sum(ptr, src, val, x, rounded, round_x=True,
                   round_val=False, groups=1):
    """The wide path's order with ``groups`` lane groups a warp: group g
    adds entries g, g + G, ... of a row in order from 0, and the groups'
    sums are added pairwise, ((g0 + g1) + (g2 + g3))."""
    msg = messages(src, val, x, rounded, round_x, round_val)
    p = ptr.long()
    lens = p[1:] - p[:-1]
    part = []
    for g in range(groups):
        n = torch.clamp_min((lens - g + groups - 1) // groups, 0)
        acc = torch.zeros((lens.shape[0], x.shape[1]), dtype=torch.float32,
                          device=x.device)
        for j in range(int(n.max()) if n.numel() else 0):
            live = n > j
            acc[live] = acc[live] + msg[p[:-1][live] + g + groups * j]
        part.append(acc)
    while len(part) > 1:
        part = [a + b for a, b in zip(part[::2], part[1::2])]
    return part[0]

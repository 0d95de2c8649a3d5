"""The operation and byte counts against hand counts at tiny shapes."""

from __future__ import annotations

import pytest

from gnnbench import counts

CFG = dict(num_ratings=2, basis_units=2, gcn_out_units=4, gcn_agg_units=6,
           layers=2, embed_dim=5, nhid1=3, nhid2=2, attention_hidden=2,
           decoder_hidden1=4, decoder_hidden2=2, beta=0.001)


def test_decoder_cell_ops_match_the_port_table():
    # 2*H1*H2 + 2*H1 + 2*H2 and 2*(2*H1*H2) + 4*H2 + 3*H1 at 128 / 64.
    assert counts.decoder_cell_ops(128, 64) == (16768, 33408)
    assert sum(counts.decoder_cell_ops(128, 64)) == 50176


def test_mm_counts_forward_and_each_gradient():
    t = counts.Ops()
    t.mm(2, 3, 4, grads=0)
    assert t.by_dtype["float32"] == 48
    t.mm(2, 3, 4, grads=2, dtype="bfloat16", times=3)
    assert t.by_dtype["bfloat16"] == 3 * 48 * 3


def test_dense_step_by_hand():
    nd, nv, cells = 3, 2, 6
    r, b, out = 2, 2, 4
    f32 = 0
    # Layer 0: in 5, msg 6 // 3 = 2, no input gradient.
    f32 += 2 * r * b * 5 * 2 * 3
    f32 += r * (2 * nd * 5 * 2 * 2 + 2 * nv * 5 * 2 * 2)
    f32 += r * (2 * nv * nd * 2 * 2 + 2 * nd * nv * 2 * 2)
    f32 += 2 * (nd + nv) * 2 * out * 3
    # Layer 1: in 4, msg 4, the input takes a gradient.
    f32 += 2 * r * b * 4 * 4 * 3
    f32 += r * (2 * nd * 4 * 4 * 3 + 2 * nv * 4 * 4 * 3)
    f32 += r * (2 * nv * nd * 4 * 2 + 2 * nd * nv * 4 * 2)
    f32 += 2 * (nd + nv) * 4 * out * 3
    for n in (nd, nv):
        f32 += 2 * (2 * n * n * 3 * 2) * 2      # x w1 and A (.), twice
        f32 += 2 * (2 * n * 3 * 2 * 3)          # h w2
        f32 += 2 * (2 * n * n * 2 * 2)          # A (.)
        f32 += 2 * n * 4 * 2 * 3                # fusion
        f32 += 2 * (2 * n) * out * 2 * 3 + 2 * (2 * n) * 2 * 1 * 3
        f32 += 2 * (2 * n * out * n * 2)        # two Gram matrices
    bf16 = 2 * (nd + nv) * out * 4 * 3 + cells * sum(
        counts.decoder_cell_ops(4, 2))
    got = counts.dense_step(CFG, nd, nv, cells)
    assert got["float32"] == pytest.approx(f32)
    assert got["bfloat16"] == pytest.approx(bf16)


def test_sparse_step_aggregations_by_hand():
    cfg = dict(CFG, beta=0.0)
    nd, nv, d, cells = 3, 2, 5, 7
    edges = [10, 3]
    dense_part = counts.sparse_step(cfg, nd, nv, [0, 0], cells, d)
    full = counts.sparse_step(cfg, nd, nv, edges, cells, d)
    # Per layer: 2 directions x (forward + backward) x 2 * edges * msg.
    agg = sum(2 * 2 * 2 * e * m for m in (2, 4) for e in edges)
    assert full["float32"] - dense_part["float32"] == pytest.approx(agg)
    assert full["bfloat16"] == dense_part["bfloat16"]


def test_least_seconds_takes_the_larger_bound():
    ops = {"float32": 67e12, "bfloat16": 989e12}
    assert counts.least_seconds(ops) == pytest.approx(2.0)
    assert counts.least_seconds({"float32": 0.0}, 3.35e12 * 5) == \
        pytest.approx(5.0)


def test_segment_sum_bytes_row_10_of_the_kernel_table():
    # PERF.md's row 10/11: 157.2 MB for 10M edges at 100k x 100k, d 128.
    b = counts.segment_sum_bytes(100_000, 100_000, 10_000_000, 128)
    assert b == pytest.approx(157.2e6, rel=1e-3)
    # Row 12: 256 MB of bf16 da1 read, the f32 table written.
    s = counts.segment_sum_bytes(1_000_000, 100_000, 1_000_000, 128,
                                 gathered=False)
    assert s == pytest.approx(256e6 + 51.2e6 + 400_004)


def test_decoder_work_bytes_by_hand():
    ops, nbytes = counts.decoder_work(CFG, 3, 2, 6, indexed=True)
    tables = 5 * 4 * 4
    weights = (4 + 8 + 4 + 1) * 4
    assert nbytes == 2 * (tables + weights) + 6 * 16
    assert ops["bfloat16"] == 6 * sum(counts.decoder_cell_ops(4, 2))

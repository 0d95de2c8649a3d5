// Fused per-edge MLP decoder for Hopper (sm_90a), forward and backward, for
// one fold or a stack of F folds.
//
// Replaces the Pallas TPU kernels _fwd_kernel / _bwd_kernel of
// dream_gnn_tpu/kernels/pallas_decoder.py (fused_decoder) and of
// dream_gnn_tpu/kernels/pallas_decoder_batched.py (fused_decoder_batched).
// For every fold f and candidate edge e, with i = src[e], j = dst[e]:
//
//     a1  = rnd(Pd[i]) + rnd(Pv[j]) + b1       (H1 = 128 units)
//     h1d = relu(a1) * m1                      (m1: dropout mask, layer 1)
//     a2  = rnd(h1d) @ rnd(w2) + b2            (H2 = 64 units, f32 sums)
//     h2d = relu(a2) * m2                      (m2: dropout mask, layer 2)
//     out[e] = h2d . w3                        (b3 is added by the caller)
//
// rnd() rounds to bf16 in bf16 mode and is the identity in fp32 mode, at
// the points of the Pallas kernels: unlike the grid kernels they round the
// node tables before the gather (pallas_decoder.py:107-108), and the
// backward rounds da1 before it sums into dPd and dPv (:164-167).  Dropout
// bits are the grid kernels' hash of (seed[f], layer, i, j, k), so an edge
// draws the masks of grid cell [i, j] and, in fp32, gives its logit.
//
// What bounds it on an H100: about 16.8 kFLOP per edge forward and 50.2
// kFLOP backward against a few bytes per edge, so operations, by far.  The
// backward also owes every edge's rnd(da1) row to the node gradients dPd
// and dPv: 512 bytes an edge, 8.56 GB at 100 folds of 167,168 edges, if it
// leaves the block, and read twice more to be summed.  So the backward sums
// those rows where it forms them, in shared memory, and writes per-node
// partials only.
//
// Design:
// - forward, the fold on blockIdx.y:
//   - bf16 (edge_fwd_mma_kernel): the a2 product on the tensor cores, as
//     in grid_fwd_mma_kernel (grid_decoder.cu) and with the same tile
//     (fwd_mma_rows, decoder_common.cuh): 8 warps of 16 edges, 128 edges a
//     tile, rnd(h1d) built in the A fragments from the rounded table rows.
//     A block stages w2 in bf16 once and walks a fixed, strided subset of
//     its fold's tiles, in whole waves of two blocks an SM; each thread
//     reads its two edges' table rows from L2 one k-step ahead of the mma.
//     No unit-order recompute: h2d is not rounded and the logit is
//     continuous in a2.
//   - fp32 (edge_fwd_kernel): on the CUDA cores, where TF32 would round
//     what the fp32 Pallas kernel does not: one thread per edge, 128 edges
//     a block.  w2, b1, b2 and w3 sit in shared memory; each thread reads
//     its two table rows from global memory (the tables stay in L2) and
//     keeps its 64 a2 sums in registers.
// - backward, one pass over an ordering of each fold's edges by column
//   block dst / 32, then by src, stable (EdgeOrder, built once per edge
//   list by edge_decoder.py:edge_order).  A block owns one 32-disease
//   column block of one fold, or a contiguous group of the parts that the
//   ordering cuts it into at the starts of drug runs
//   (edge_decoder.py:bwd_split).  It walks its positions in 128-edge tiles,
//   in order, each tile's edge ids, drugs, diseases and g fetched a tile
//   ahead.  Per tile it recomputes the forward, forms da2 and da1, sums
//   dW2, db1, db2 and dw3 over its tiles, and puts each edge's rnd(da1) row
//   into a shared-memory tile.  tile_node_sums then adds the rows into the
//   node gradients, a warp a segment, each segment's rows added in order:
//   - dPd over the tile's runs of one drug: a run that ends in the tile is
//     the block's partial row of that (column block, drug) pair; the run
//     that ends the tile is carried to the next.  Every pair has one
//     writer, which writes 0 for a drug without edges there.
//   - dPv over the tile's columns (a stable counting sort of the tile in
//     shared memory), each added to the block's 32 dPv rows in shared
//     memory, written out once as the block's partial.
//   A walk over the tile's 128 edges, one edge a step, is a chain of
//   dependent instructions; a segment a warp spreads the work over the 8
//   warps (a tile of a Gdataset fold holds about 4 runs and 29 columns).  The partials, (F, n_cb, nd, 128) for dPd (304 MB at 100 folds)
//   and (F, n_split, nv, 128) for dPv, and the weight slabs are summed by
//   the caller in a fixed order.  No float atomics anywhere, so two runs
//   give the same bits.
//   - bf16 (edge_bwd_mma_kernel): the tile's three products, a2 = rnd(h1d)
//     @ rnd(w2), dW2 += rnd(h1d)^T @ rnd(da2) and dh1 = rnd(da2) @
//     rnd(w2)^T, run on the tensor cores as mma.sync m16n8k16 bf16 x bf16
//     -> f32, as in grid_bwd_mma_kernel (grid_decoder.cu), whose design
//     notes hold here: 8 warps, each owning 16 edges of the tile for a2
//     and dh1 and 16 H1 units for dW2; h1d formed in the A fragments with
//     its dropout hash once per unit; each k-step's a2 product started from
//     0 and added in f32, and the rare a2 near a step of what follows
//     summed again in unit order (seq_a2), which the plain version's
//     result needs; dW2 and db1 in registers across tiles, fixed shuffle
//     trees and a fixed warp order for the cross-lane sums.  Unlike the
//     grid kernel it rounds da1 before dPd and dPv sum it, so dh1 too is
//     added in per-k-step partials and summed again in unit order where
//     da1 is near a bf16 midpoint (seq_dh1).  As in the grid kernel the
//     block stages its column block's 32 Pv rows once (rounded, in bf16),
//     so only the Pd rows are gathered: each thread reads its two edges'
//     at its units from global memory, one k-step ahead.  The tile's
//     rnd(da1) rows sit in shared memory in bf16, which holds them exactly
//     and halves what the node sums read.
//   - fp32 (edge_bwd_kernel): the tensor cores would take fp32 operands
//     only as TF32, which rounds where the fp32 Pallas kernel does not, so
//     the products stay on the CUDA cores: one thread per edge, f32 tiles
//     in shared memory, the same node sums over its f32 da1 rows.
//
// Every entry point returns cudaGetLastError() after its launches.

#include <cassert>

#include "decoder_common.cuh"

namespace {

constexpr int TE = 128;          // edges per tile, one thread per edge
static_assert(TE == H1, "the backward's reductions map one thread to one H1 unit");
constexpr int CB = 32;           // diseases of a column block: a lane each in a scan
constexpr int TW = TE / 32;      // warps that load a tile's edges

// A backward tile's edges in shared memory, in ints (TileEdges).
constexpr int IDX_SMEM = 6 * TE + TW * CB + 2 * CB + 8;
// The dPd row carried from one tile to the next, in floats: two slots by
// tile parity, and their drugs.
constexpr int RUN_SMEM = 2 * H1 + 4;

// Shared memory, in floats.
constexpr int FWD_SMEM = H1 * H2 + H1 + 2 * H2;
constexpr int BWD_SMEM = H1 * H2          // w2
                       + H1 + 2 * H2      // b1, b2, w3
                       + TE * LD1         // h1d of the tile, then da1
                       + TE * LD2         // da2 of the tile
                       + 2 * (TE / 32) * H2   // per-warp sums for db2, dw3
                       + H1 * LD2         // dW2 accumulator
                       + CB * H1          // dPv rows of the column block
                       + IDX_SMEM + RUN_SMEM;

// The bf16 backward: MW = 8 warps (decoder_common.cuh), each owning 16
// edges of a tile.  Shared memory, in bytes.
static_assert(TE == MW * 16, "each warp owns one 16-row mma tile of edges");
static_assert(H1 == MW * 16, "each warp owns 16 H1 units of dW2");
static_assert(MT == H1 + 2 * H2, "the final sums map one thread to one output");
constexpr int MMA_SMEM = H1 * LDW * 2     // w2, bf16
                       + TE * LDH * 2     // rnd(h1d) of the tile
                       + TE * LDW * 2     // rnd(da2) of the tile
                       + CB * LDH * 2     // rnd(Pv) rows of the column block, bf16
                       + TE * LDH * 2     // rnd(da1) rows of the tile, bf16
                       + CB * H1 * 4      // dPv rows of the column block
                       + (H1 + 2 * H2) * 4    // b1, b2, w3
                       + 2 * MW * H1 * 4  // per-warp db1, db2 and dw3 sums
                       + (IDX_SMEM + RUN_SMEM) * 4
                       + 4                // max |rnd(w2)|
                       + MT * FIX_LD * 4; // a2 and da1 taken again, per thread

// The bf16 forward, in bytes: w2 in bf16, b1, b2, w3.
constexpr int FWD_MMA_SMEM = H1 * LDW * 2 + (H1 + 2 * H2) * 4;

// The backward's view of its block: fold f, column block cb (diseases j0
// ..), its edges at positions [lo, hi) of the fold's ordering, the drugs
// [d_lo, d_hi) whose dPd rows it writes, and its index among the fold's
// n_cb * n_split blocks.  blockIdx.x = cb * n_split + split: a column
// block's parts, n_part of them, go to n_split blocks in contiguous groups.
struct BwdBlock {
  int f, cb, split, n_split, j0, lo, hi, d_lo, d_hi;
};

__device__ __forceinline__ BwdBlock bwd_block(const int* split_edge, const int* split_drug,
                                              int nv, int n_part) {
  BwdBlock b;
  const int n_cb = (nv + CB - 1) / CB;
  b.f = blockIdx.y;
  b.n_split = gridDim.x / n_cb;
  b.cb = blockIdx.x / b.n_split;
  b.split = blockIdx.x % b.n_split;
  b.j0 = b.cb * CB;
  const size_t at = ((size_t)b.f * n_cb + b.cb) * (n_part + 1);
  const int p_lo = b.split * n_part / b.n_split, p_hi = (b.split + 1) * n_part / b.n_split;
  b.lo = split_edge[at + p_lo];
  b.hi = split_edge[at + p_hi];
  b.d_lo = split_drug[at + p_lo];
  b.d_hi = split_drug[at + p_hi];
  return b;
}

// A tile's edges in shared memory (IDX_SMEM ints).
struct TileEdges {
  int* src;      // [TE] drug
  int* col;      // [TE] disease - j0
  float* g;      // [TE] cotangent, 0 past the tile's n edges
  int* byc;      // [TE] the tile's edges by column, stable
  int* cnt;      // [TW][CB] edges of each warp's 32 in each column
  int* ctot;     // [CB] edges in each column
  int* cstart;   // [CB] their first position in byc
  int* rstart;   // [TE + 1] the first edge of each run of one drug, then n
  int* rdrug;    // [TE] the run's drug
  int* nrun;     // [1] runs in the tile
  int* prev;     // [2] the drug of the last edge before the tile, by parity

  __device__ explicit TileEdges(int* base)
      : src(base), col(base + TE), g(reinterpret_cast<float*>(base + 2 * TE)),
        byc(base + 3 * TE), cnt(base + 4 * TE), ctot(cnt + TW * CB), cstart(ctot + CB),
        rstart(cstart + CB), rdrug(rstart + TE + 4), nrun(rdrug + TE), prev(nrun + 1) {}
};

// One edge of a tile as thread t < TE fetches it for the tile after the
// current one, so that its global loads have a tile's time to land: the
// edge id at position p is read two tiles ahead (edge_id), its drug,
// disease and g one tile ahead (fetch_edge).  A position past the block's
// edges is id -1, which fetches drug 0, column 0 and g = 0: it adds
// nothing to any sum.
struct EdgeIdx {
  int i, j;
  float g;
};

__device__ __forceinline__ int edge_id(const int* __restrict__ perm, int p, int hi) {
  return p < hi ? perm[p] : -1;
}

__device__ __forceinline__ EdgeIdx fetch_edge(const int* __restrict__ edges,
                                              const float* __restrict__ g, int id, int j0,
                                              int ne) {
  EdgeIdx e = {0, j0, 0.f};
  if (id >= 0) {
    assert(id < ne);
    e = {edges[id], edges[ne + id], g[id]};
  }
  return e;
}

// Thread t < TE stores edge t of the tile (of n edges) and counts its
// warp's edges in each column.
__device__ __forceinline__ void store_tile_edge(const TileEdges& te, const EdgeIdx& e, int n,
                                                int j0, int nd, int nv, int t) {
  const int lane = t % 32, w = t / 32;
  const bool valid = t < n;
  const int j = e.j - j0;
  // A row outside the tables, or an ordering of other edges.
  assert(0 <= e.i && e.i < nd && 0 <= j && j < CB && e.j < nv);
  te.src[t] = e.i;
  te.col[t] = j;
  te.g[t] = e.g;
  te.cnt[w * CB + lane] = 0;
  __syncwarp();
  const unsigned peers = __match_any_sync(0xffffffffu, valid ? j : CB + lane);
  if (valid && (peers & ((1u << lane) - 1u)) == 0u) te.cnt[w * CB + j] = __popc(peers);
}

// After store_tile_edge and a barrier, thread t < TE of the tile of parity
// par: places its edge in te.byc, after every edge of a lower column and
// every earlier edge of its own (warp 0 leaves each column's count and
// start); numbers the tile's runs of one drug, each starting where the
// drug differs from the edge before it in the tile; where its edge starts
// a drug's run, writes the zero dPd rows of the drugs skipped since the
// run before; and the tile's last edge leaves its drug for the next tile.
__device__ __forceinline__ void place_tile_edge(const TileEdges& te, int n, int par, int t,
                                                float* __restrict__ dpd) {
  const int lane = t % 32, w = t / 32;
  int total = 0;
#pragma unroll
  for (int v = 0; v < TW; ++v) total += te.cnt[v * CB + lane];
  int incl = total;   // inclusive scan over the columns
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int x = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += x;
  }
  if (w == 0) {
    te.ctot[lane] = total;
    te.cstart[lane] = incl - total;
  }
  const bool valid = t < n;
  const int j = te.col[t];
  int pos = __shfl_sync(0xffffffffu, incl - total, j);
  const unsigned peers = __match_any_sync(0xffffffffu, valid ? j : CB + lane);
  pos += __popc(peers & ((1u << lane) - 1u));
  for (int v = 0; v < w; ++v) pos += te.cnt[v * CB + j];
  // Run starts, counted over the warps in order.
  int before = 0, runs = 0;
  bool starts = false;
#pragma unroll
  for (int v = 0; v < TW; ++v) {
    const int e = 32 * v + lane;
    const bool s = e < n && (e == 0 || te.src[e] != te.src[e - 1]);
    const unsigned m = __ballot_sync(0xffffffffu, s);
    if (v < w) before += __popc(m);
    if (v == w) {
      before += __popc(m & ((1u << lane) - 1u));
      starts = s;
    }
    runs += __popc(m);
  }
  if (t == 0) {
    te.rstart[runs] = n;
    *te.nrun = runs;
  }
  if (valid) {
    te.byc[pos] = t;
    const int d = te.src[t];
    if (starts) {
      te.rstart[before] = t;
      te.rdrug[before] = d;
      const int last = t == 0 ? te.prev[par] : te.src[t - 1];
      for (int z = last + 1; z < d; ++z)
        for (int k = 0; k < H1; k += 4)
          *reinterpret_cast<float4*>(dpd + (size_t)z * H1 + k) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    if (t == n - 1) te.prev[par ^ 1] = d;
  }
}

// Units 4 lane .. 4 lane + 3 of row p of a tile's rnd(da1) rows: f32
// (row stride LD1), or bf16 (row stride LDH), where rnd(da1) is exact.
__device__ __forceinline__ float4 row4(const float* rows, int p, int lane) {
  return *reinterpret_cast<const float4*>(rows + p * LD1 + 4 * lane);
}

__device__ __forceinline__ float4 row4(const __nv_bfloat16* rows, int p, int lane) {
  const uint2 u = *reinterpret_cast<const uint2*>(rows + p * LDH + 4 * lane);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xFFFF0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xFFFF0000u));
}

// s + the tile's rows at positions [lo, hi), rows idx[p] (p where idx is
// null), at lane's four units, added one row at a time in order; four
// rows' loads at once.
template <typename T>
__device__ __forceinline__ float4 segment_sum(const T* da1s, const int* idx, int lo, int hi,
                                              float4 s, int lane) {
  auto row = [&](int p) { return row4(da1s, idx ? idx[p] : p, lane); };
  auto add = [&](const float4& x) {
    s = make_float4(s.x + x.x, s.y + x.y, s.z + x.z, s.w + x.w);
  };
  int p = lo;
  for (; p + 4 <= hi; p += 4) {
    const float4 a = row(p), b = row(p + 1), c = row(p + 2), d = row(p + 3);
    add(a);
    add(b);
    add(c);
    add(d);
  }
  for (; p < hi; ++p) add(row(p));
  return s;
}

// The tile's node sums from its rnd(da1) rows in da1s (row4), shared by
// both backward kernels: warp w of nw, each lane at four units, takes
// whole segments, each summed in order in one warp (segment_sum).
// - PD: dPd over the tile's runs of one drug (te.rstart, in list order
//   within a drug), runs w, w + nw, ...  The run that ends the tile is
//   carried to the next in carry (RUN_SMEM; slot par holds the row from
//   the tile before, slot par ^ 1 takes this tile's), where the first run
//   of the next tile adds to it if it is of the same drug; otherwise that
//   run writes the carried row out.  A finished run's row goes to dpd (the
//   block's fold and column block, row stride H1).
// - !PD: dPv over the tile's columns (te.byc from te.cstart), columns w,
//   w + nw, ..., each added to its row of dpvs, the block's dPv rows.
template <bool PD, typename T>
__device__ __forceinline__ void tile_node_sums(const T* da1s, const TileEdges& te, int w,
                                               int nw, int lane, int par, float* carry,
                                               float* __restrict__ dpd, float* dpvs) {
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  if constexpr (PD) {
    int* cdrug = reinterpret_cast<int*>(carry + 2 * H1);
    const int runs = *te.nrun;
    for (int r = w; r < runs; r += nw) {
      const int d = te.rdrug[r];
      float4 s = zero;
      if (r == 0) {
        const int c = cdrug[par];
        const float4 x = reinterpret_cast<const float4*>(carry + par * H1)[lane];
        if (c == d)
          s = x;
        else if (c >= 0)
          reinterpret_cast<float4*>(dpd + (size_t)c * H1)[lane] = x;
      }
      s = segment_sum(da1s, nullptr, te.rstart[r], te.rstart[r + 1], s, lane);
      if (r == runs - 1) {
        reinterpret_cast<float4*>(carry + (par ^ 1) * H1)[lane] = s;
        if (lane == 0) cdrug[par ^ 1] = d;
      } else {
        reinterpret_cast<float4*>(dpd + (size_t)d * H1)[lane] = s;
      }
    }
  } else {
    for (int j = w; j < CB; j += nw) {
      const int cnt = te.ctot[j];
      if (cnt == 0) continue;
      const float4 s = segment_sum(da1s, te.byc, te.cstart[j], te.cstart[j] + cnt, zero, lane);
      float4* r = reinterpret_cast<float4*>(dpvs + j * H1) + lane;
      const float4 a = *r;
      *r = make_float4(a.x + s.x, a.y + s.y, a.z + s.z, a.w + s.w);
    }
  }
}

// The carried dPd row: none at the block's start (by one thread), written
// out at its end (by a warp).
__device__ __forceinline__ void start_carry(float* carry) {
  reinterpret_cast<int*>(carry + 2 * H1)[0] = -1;
}

__device__ __forceinline__ void finish_carry(const float* carry, int par, int lane,
                                             float* __restrict__ dpd) {
  const int c = reinterpret_cast<const int*>(carry + 2 * H1)[par];
  if (c >= 0)
    reinterpret_cast<float4*>(dpd + (size_t)c * H1)[lane] =
        reinterpret_cast<const float4*>(carry + par * H1)[lane];
}

// The zero dPd rows of the block's drugs after its last run (te.prev[par]
// holds the drug of the block's last edge, or d_lo - 1), by nthreads
// threads.
__device__ __forceinline__ void zero_tail(const TileEdges& te, int par, int d_hi,
                                          float* __restrict__ dpd, int t, int nthreads) {
  const int z0 = te.prev[par] + 1;
  for (int e = t; e < (d_hi - z0) * (H1 / 4); e += nthreads)
    reinterpret_cast<float4*>(dpd + (size_t)z0 * H1)[e] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// The block's dPv rows, those of diseases below nv, to its partial (F,
// n_split, nv, H1), by nthreads threads.
__device__ __forceinline__ void write_dpv(const float* dpvs, const BwdBlock& b, int nv,
                                          float* __restrict__ dpv_part, int t, int nthreads) {
  float* out = dpv_part + (((size_t)b.f * b.n_split + b.split) * nv + b.j0) * H1;
  const int rows = min(CB, nv - b.j0);
  for (int e = t; e < rows * H1; e += nthreads) out[e] = dpvs[e];
}

__global__ void __launch_bounds__(TE) edge_fwd_kernel(
    const float* __restrict__ pd, const float* __restrict__ pv,
    const float* __restrict__ b1, const float* __restrict__ w2,
    const float* __restrict__ b2, const float* __restrict__ w3,
    const int* __restrict__ edges, const int* __restrict__ seed_ptr,
    float* __restrict__ out, int nd, int nv, int ne, uint32_t thresh,
    float scale, int use_drop) {
  extern __shared__ float4 smem4[];
  float* w2s = reinterpret_cast<float*>(smem4);
  float* b1s = w2s + H1 * H2;
  float* b2s = b1s + H1;
  float* w3s = b2s + H2;

  const int f = blockIdx.y;
  pd += (size_t)f * nd * H1;
  pv += (size_t)f * nv * H1;
  b1 += f * H1;
  w2 += f * H1 * H2;
  b2 += f * H2;
  w3 += f * H2;
  edges += (size_t)f * 2 * ne;
  out += (size_t)f * ne;
  const int t = threadIdx.x;
  for (int e = t; e < H1 * H2; e += TE) w2s[e] = w2[e];
  b1s[t] = b1[t];
  if (t < H2) {
    b2s[t] = b2[t];
    w3s[t] = w3[t];
  }
  __syncthreads();

  const int e = blockIdx.x * TE + t;
  const bool valid = e < ne;
  const int i = valid ? edges[e] : 0, j = valid ? edges[ne + e] : 0;
  assert(0 <= i && i < nd && 0 <= j && j < nv);   // a row outside the tables
  const bool drop = use_drop != 0;
  const uint32_t seed = (uint32_t)seed_ptr[f];
  float acc[H2];
  cell_layer1(pd + (size_t)i * H1, pv + (size_t)j * H1, b1s, w2s,
              cell_key(seed, 1u, i, j), drop, thresh, scale, acc, nullptr);
  const uint32_t key2 = cell_key(seed, 2u, i, j);
  float s = 0.f;
#pragma unroll
  for (int n = 0; n < H2; ++n) {
    float h2 = fmaxf(acc[n] + b2s[n], 0.f);
    if (drop) h2 = h2 * (fmix32(key2 ^ (uint32_t)n) >= thresh ? scale : 0.f);
    s += h2 * w3s[n];
  }
  if (valid) out[e] = s;
}

__global__ void __launch_bounds__(TE) edge_bwd_kernel(
    const float* __restrict__ pd, const float* __restrict__ pv,
    const float* __restrict__ b1, const float* __restrict__ w2,
    const float* __restrict__ b2, const float* __restrict__ w3,
    const int* __restrict__ edges, const int* __restrict__ seed_ptr,
    const float* __restrict__ g, const int* __restrict__ perm,
    const int* __restrict__ split_edge, const int* __restrict__ split_drug,
    float* __restrict__ dpd_part,   // (F, n_cb, nd, H1)
    float* __restrict__ dpv_part,   // (F, n_split, nv, H1)
    float* __restrict__ db1_part,   // (F, n_cb * n_split, H1)
    float* __restrict__ dw2_part,   // (F, n_cb * n_split, H1, H2)
    float* __restrict__ db2_part,   // (F, n_cb * n_split, H2)
    float* __restrict__ dw3_part,   // (F, n_cb * n_split, H2)
    int nd, int nv, int ne, int n_part, uint32_t thresh, float scale, int use_drop) {
  extern __shared__ float4 smem4[];
  float* w2s = reinterpret_cast<float*>(smem4);
  float* b1s = w2s + H1 * H2;
  float* b2s = b1s + H1;
  float* w3s = b2s + H2;
  float* hbuf = w3s + H2;
  float* da2s = hbuf + TE * LD1;
  float* red = da2s + TE * LD2;            // [2][TE/32][H2]: db2, then dw3
  float* dw2acc = red + 2 * (TE / 32) * H2;
  float* dpvs = dw2acc + H1 * LD2;
  float* carry = dpvs + CB * H1;
  const TileEdges te(reinterpret_cast<int*>(carry + RUN_SMEM));

  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const BwdBlock bb = bwd_block(split_edge, split_drug, nv, n_part);
  const int f = bb.f, blk = f * gridDim.x + blockIdx.x;
  const bool drop = use_drop != 0;
  const uint32_t seed = (uint32_t)seed_ptr[f];
  pd += (size_t)f * nd * H1;
  pv += (size_t)f * nv * H1;
  b1 += f * H1;
  w2 += f * H1 * H2;
  b2 += f * H2;
  w3 += f * H2;
  edges += (size_t)f * 2 * ne;
  g += (size_t)f * ne;
  perm += (size_t)f * ne;
  float* dpd = dpd_part + ((size_t)f * ((nv + CB - 1) / CB) + bb.cb) * nd * H1;

  for (int e = t; e < H1 * H2; e += TE) w2s[e] = w2[e];
  for (int e = t; e < H1 * LD2; e += TE) dw2acc[e] = 0.f;
  for (int e = t; e < CB * H1; e += TE) dpvs[e] = 0.f;
  b1s[t] = b1[t];
  if (t < H2) {
    b2s[t] = b2[t];
    w3s[t] = w3[t];
  }
  if (t == 0) {
    start_carry(carry);
    te.prev[0] = bb.d_lo - 1;
  }
  float db1acc = 0.f, db2acc = 0.f, dw3acc = 0.f;
  EdgeIdx nxt = fetch_edge(edges, g, edge_id(perm, bb.lo + t, bb.hi), bb.j0, ne);
  int nxt_id = edge_id(perm, bb.lo + TE + t, bb.hi);
  int par = 0;   // the tile's parity

  for (int p0 = bb.lo; p0 < bb.hi; p0 += TE, par ^= 1) {
    const int tn = min(TE, bb.hi - p0);  // edges in the tile
    __syncthreads();   // the previous tile is done with hbuf, da2s and its edges
    store_tile_edge(te, nxt, tn, bb.j0, nd, nv, t);
    __syncthreads();
    place_tile_edge(te, tn, par, t, dpd);
    nxt = fetch_edge(edges, g, nxt_id, bb.j0, ne);
    nxt_id = edge_id(perm, p0 + 2 * TE + t, bb.hi);
    const int i = te.src[t], j = bb.j0 + te.col[t];
    const float* pd_row = pd + (size_t)i * H1;
    const float* pv_row = pv + (size_t)j * H1;
    const float gc = te.g[t];

    // Per edge: recompute the forward, then da2 = (a2 > 0) * g * w3 * m2.
    {
      float acc[H2];
      cell_layer1(pd_row, pv_row, b1s, w2s, cell_key(seed, 1u, i, j), drop, thresh,
                  scale, acc, hbuf + t * LD1);
      const uint32_t key2 = cell_key(seed, 2u, i, j);
#pragma unroll
      for (int n = 0; n < H2; ++n) {
        const float a2 = acc[n] + b2s[n];
        float h2d = fmaxf(a2, 0.f);
        float dh2 = gc * w3s[n];
        if (drop) {
          const float m2 = fmix32(key2 ^ (uint32_t)n) >= thresh ? scale : 0.f;
          h2d = h2d * m2;
          dh2 = dh2 * m2;
        }
        const float da2 = a2 > 0.f ? dh2 : 0.f;
        const float sdw3 = warp_sum(gc * h2d);
        const float sdb2 = warp_sum(da2);
        if (lane == 0) {
          red[warp * H2 + n] = sdb2;
          red[(TE / 32 + warp) * H2 + n] = sdw3;
        }
        acc[n] = da2;
      }
      float4* drow = reinterpret_cast<float4*>(da2s + t * LD2);
#pragma unroll
      for (int q = 0; q < H2 / 4; ++q)
        drow[q] = make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]);
    }
    __syncthreads();

    // Thread k: row k of dW2 += sum over edges of h1d[k] * da2.
    {
      const int k = t;
      float r[H2];
      float4* arow = reinterpret_cast<float4*>(dw2acc + k * LD2);
#pragma unroll
      for (int q = 0; q < H2 / 4; ++q) {
        const float4 v = arow[q];
        r[4 * q] = v.x; r[4 * q + 1] = v.y; r[4 * q + 2] = v.z; r[4 * q + 3] = v.w;
      }
#pragma unroll 1
      for (int c = 0; c < TE; ++c) {
        const float h = hbuf[c * LD1 + k];
        const float4* drow = reinterpret_cast<const float4*>(da2s + c * LD2);
#pragma unroll
        for (int q = 0; q < H2 / 4; ++q) {
          const float4 d = drow[q];
          r[4 * q + 0] += h * d.x;
          r[4 * q + 1] += h * d.y;
          r[4 * q + 2] += h * d.z;
          r[4 * q + 3] += h * d.w;
        }
      }
#pragma unroll
      for (int q = 0; q < H2 / 4; ++q)
        arow[q] = make_float4(r[4 * q], r[4 * q + 1], r[4 * q + 2], r[4 * q + 3]);
      if (t < H2) {
#pragma unroll
        for (int w = 0; w < TE / 32; ++w) {
          db2acc += red[w * H2 + t];
          dw3acc += red[(TE / 32 + w) * H2 + t];
        }
      }
    }
    __syncthreads();   // hbuf is read above and overwritten with da1 below

    // Per edge: dh1 = da2 @ w2^T, da1 = (a1 > 0) * dh1 * m1.
    {
      float d[H2];
      const float4* drow = reinterpret_cast<const float4*>(da2s + t * LD2);
#pragma unroll
      for (int q = 0; q < H2 / 4; ++q) {
        const float4 v = drow[q];
        d[4 * q] = v.x; d[4 * q + 1] = v.y; d[4 * q + 2] = v.z; d[4 * q + 3] = v.w;
      }
      const uint32_t key1 = cell_key(seed, 1u, i, j);
#pragma unroll 1
      for (int k = 0; k < H1; k += 4) {
        const float4 pa = *reinterpret_cast<const float4*>(pd_row + k);
        const float4 pb = *reinterpret_cast<const float4*>(pv_row + k);
        const float rows[4] = {pa.x + pb.x, pa.y + pb.y, pa.z + pb.z, pa.w + pb.w};
        float out4[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float4* wr = reinterpret_cast<const float4*>(w2s + (k + u) * H2);
          float s = 0.f;
#pragma unroll
          for (int q = 0; q < H2 / 4; ++q) {
            const float4 w = wr[q];
            s += d[4 * q] * w.x;
            s += d[4 * q + 1] * w.y;
            s += d[4 * q + 2] * w.z;
            s += d[4 * q + 3] * w.w;
          }
          if (drop) s = s * (fmix32(key1 ^ (uint32_t)(k + u)) >= thresh ? scale : 0.f);
          out4[u] = rows[u] + b1s[k + u] > 0.f ? s : 0.f;
        }
        *reinterpret_cast<float4*>(hbuf + t * LD1 + k) =
            make_float4(out4[0], out4[1], out4[2], out4[3]);
      }
    }
    __syncthreads();

    // Thread k: db1 sums da1 over the tile.  Then the node sums.
#pragma unroll 4
    for (int c = 0; c < TE; ++c) db1acc += hbuf[c * LD1 + t];
    tile_node_sums<true>(hbuf, te, warp, TE / 32, lane, par, carry, dpd, dpvs);
    tile_node_sums<false>(hbuf, te, warp, TE / 32, lane, par, carry, dpd, dpvs);
  }
  __syncthreads();
  if (warp == 0) finish_carry(carry, par, lane, dpd);
  zero_tail(te, par, bb.d_hi, dpd, t, TE);

  write_dpv(dpvs, bb, nv, dpv_part, t, TE);
  for (int e = t; e < H1 * H2; e += TE)
    dw2_part[(size_t)blk * H1 * H2 + e] = dw2acc[(e / H2) * LD2 + e % H2];
  db1_part[(size_t)blk * H1 + t] = db1acc;
  if (t < H2) {
    db2_part[(size_t)blk * H2 + t] = db2acc;
    dw3_part[(size_t)blk * H2 + t] = dw3acc;
  }
}

// The bf16 forward on the tensor cores (fwd_mma_rows, decoder_common.cuh):
// a thread of warp w holds edges c0 = 16 w + gq and c1 = c0 + 8 of a tile
// (lane = 4 gq + q).  An edge past ne computes on row 0 and is not
// written; a warp whose 16 edges all lie past ne skips the tile.
__global__ void __launch_bounds__(MT, FWD_RESIDENT) edge_fwd_mma_kernel(
    const float* __restrict__ pd, const float* __restrict__ pv,
    const float* __restrict__ b1, const float* __restrict__ w2,
    const float* __restrict__ b2, const float* __restrict__ w3,
    const int* __restrict__ edges, const int* __restrict__ seed_ptr,
    float* __restrict__ out, int nd, int nv, int ne, uint32_t thresh,
    float scale, int use_drop) {
  extern __shared__ float4 smem4[];
  __nv_bfloat16* w2s = reinterpret_cast<__nv_bfloat16*>(smem4);
  float* b1s = reinterpret_cast<float*>(w2s + H1 * LDW);
  float* b2s = b1s + H1;
  float* w3s = b2s + H2;

  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const int gq = lane >> 2, q = lane & 3;
  const int f = blockIdx.y, n_tiles = (ne + TE - 1) / TE;
  const bool drop = use_drop != 0;
  const uint32_t seed = (uint32_t)seed_ptr[f];
  pd += (size_t)f * nd * H1;
  pv += (size_t)f * nv * H1;
  b1 += f * H1;
  w2 += f * H1 * H2;
  b2 += f * H2;
  w3 += f * H2;
  edges += (size_t)f * 2 * ne;
  out += (size_t)f * ne;

  for (int e = t; e < H1 * H2 / 2; e += MT) {
    const int k = e / (H2 / 2), n = 2 * (e % (H2 / 2));
    const float2 v = *reinterpret_cast<const float2*>(w2 + k * H2 + n);
    *reinterpret_cast<uint32_t*>(w2s + k * LDW + n) = pack_bf16(v.x, v.y);
  }
  if (t < H1) b1s[t] = b1[t];
  if (t < H2) {
    b2s[t] = b2[t];
    w3s[t] = w3[t];
  }
  __syncthreads();

  const int c0 = warp * 16 + gq, c1 = c0 + 8;
  const float* b1q = b1s + 2 * q;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int e0 = tile * TE;
    if (e0 + warp * 16 >= ne) continue;
    const bool v0 = e0 + c0 < ne, v1 = e0 + c1 < ne;
    const int i0 = v0 ? edges[e0 + c0] : 0, j0 = v0 ? edges[ne + e0 + c0] : 0;
    const int i1 = v1 ? edges[e0 + c1] : 0, j1 = v1 ? edges[ne + e0 + c1] : 0;
    assert(0 <= i0 && i0 < nd && 0 <= j0 && j0 < nv);   // a row outside the tables
    assert(0 <= i1 && i1 < nd && 0 <= j1 && j1 < nv);
    const uint32_t key1[2] = {drop ? cell_key(seed, 1u, i0, j0) : 0u,
                              drop ? cell_key(seed, 1u, i1, j1) : 0u};
    const uint32_t key2[2] = {drop ? cell_key(seed, 2u, i0, j0) : 0u,
                              drop ? cell_key(seed, 2u, i1, j1) : 0u};
    const float* rows[4] = {pd + (size_t)i0 * H1 + 2 * q, pv + (size_t)j0 * H1 + 2 * q,
                            pd + (size_t)i1 * H1 + 2 * q, pv + (size_t)j1 * H1 + 2 * q};
    // The rows' values at the thread's units of the next k-step: [h][row].
    float2 nxt[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int r = 0; r < 4; ++r) nxt[h][r] = *reinterpret_cast<const float2*>(rows[r] + 8 * h);
    auto a1_at = [&](int ks, float4(&x)[2]) {
      float2 cur[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int r = 0; r < 4; ++r) cur[h][r] = nxt[h][r];
      if (ks + 1 < H1 / 16) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            nxt[h][r] = *reinterpret_cast<const float2*>(rows[r] + 16 * (ks + 1) + 8 * h);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)
        x[h] = pair_a1<true>(cur[h][0], cur[h][1], cur[h][2], cur[h][3],
                             *reinterpret_cast<const float2*>(b1q + 16 * ks + 8 * h));
    };
    const float2 s = fwd_mma_rows(a1_at, w2s, b2s, w3s, key1, key2, drop, thresh, scale,
                                  lane);
    if (q == 0 && v0) out[e0 + c0] = s.x;
    if (q == 1 && v1) out[e0 + c1] = s.y;
  }
}

// near_step, with the midpoints of h2d = a2 * m2 also taken within the
// absolute band: where |a2| is small against its terms, the sums' noise
// spans more f32 ulps of a2 than MID_ULPS.
__device__ __forceinline__ bool near_step_abs(float a2, float m2, float band) {
  return near_step(a2, m2, band) || (a2 > 0.f && near_mid(a2 * m2, band * m2));
}

// The bf16 backward on the tensor cores.  The fragment layout of mma
// m16n8k16 (lane = 4 gq + q; see grid_bwd_mma_kernel) gives a thread of
// warp w edges c0 = 16 w + gq and c1 = c0 + 8 of the tile, and of each
// 128-unit row the units 8 m + 2 q + e, m < 16, e < 2, which it indexes as
// 2 m + e.  It reads those units of its two edges' Pd rows straight from
// global memory (a fold's tables stay in L2), one k-step ahead of the a2
// product that consumes them, and of their Pv rows from the block's staged
// column block.
__global__ void __launch_bounds__(MT, 1) edge_bwd_mma_kernel(
    const float* __restrict__ pd, const float* __restrict__ pv,
    const float* __restrict__ b1, const float* __restrict__ w2,
    const float* __restrict__ b2, const float* __restrict__ w3,
    const int* __restrict__ edges, const int* __restrict__ seed_ptr,
    const float* __restrict__ g, const int* __restrict__ perm,
    const int* __restrict__ split_edge, const int* __restrict__ split_drug,
    float* __restrict__ dpd_part,   // (F, n_cb, nd, H1)
    float* __restrict__ dpv_part,   // (F, n_split, nv, H1)
    float* __restrict__ db1_part,   // (F, n_cb * n_split, H1)
    float* __restrict__ dw2_part,   // (F, n_cb * n_split, H1, H2)
    float* __restrict__ db2_part,   // (F, n_cb * n_split, H2)
    float* __restrict__ dw3_part,   // (F, n_cb * n_split, H2)
    int nd, int nv, int ne, int n_part, uint32_t thresh, float scale, int use_drop) {
  extern __shared__ float4 smem4[];
  __nv_bfloat16* w2s = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* h1s = w2s + H1 * LDW;
  __nv_bfloat16* da2s = h1s + TE * LDH;
  __nv_bfloat16* pvs = da2s + TE * LDW;   // rnd(Pv) rows j0 .. j0 + CB - 1
  __nv_bfloat16* da1s = pvs + CB * LDH;   // rnd(da1) of the tile
  float* dpvs = reinterpret_cast<float*>(da1s + TE * LDH);
  float* b1s = dpvs + CB * H1;
  float* b2s = b1s + H1;
  float* w3s = b2s + H2;
  float* red = w3s + H2;                  // [MW][H1] db1, then [MW][2 H2] db2, dw3
  float* carry = red + 2 * MW * H1;
  const TileEdges te(reinterpret_cast<int*>(carry + RUN_SMEM));
  float* wmx = carry + RUN_SMEM + IDX_SMEM;
  float* fixv = wmx + 1 + threadIdx.x * FIX_LD;

  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const int gq = lane >> 2, q = lane & 3;
  const int mi = lane >> 3, mr = lane & 7;   // ldmatrix: matrix and row
  const BwdBlock bb = bwd_block(split_edge, split_drug, nv, n_part);
  const int f = bb.f, blk = f * gridDim.x + blockIdx.x;
  const bool drop = use_drop != 0;
  const uint32_t seed = (uint32_t)seed_ptr[f];
  pd += (size_t)f * nd * H1;
  pv += (size_t)f * nv * H1;
  b1 += f * H1;
  w2 += f * H1 * H2;
  b2 += f * H2;
  w3 += f * H2;
  edges += (size_t)f * 2 * ne;
  g += (size_t)f * ne;
  perm += (size_t)f * ne;
  float* dpd = dpd_part + ((size_t)f * ((nv + CB - 1) / CB) + bb.cb) * nd * H1;

  for (int e = t; e < H1 * H2 / 2; e += MT) {
    const int k = e / (H2 / 2), n = 2 * (e % (H2 / 2));
    const float2 v = *reinterpret_cast<const float2*>(w2 + k * H2 + n);
    *reinterpret_cast<uint32_t*>(w2s + k * LDW + n) = pack_bf16(v.x, v.y);
  }
  for (int e = t; e < CB * H1 / 2; e += MT) {
    const int r = e / (H1 / 2), k = 2 * (e % (H1 / 2)), j = bb.j0 + r;
    const float2 v = j < nv ? *reinterpret_cast<const float2*>(pv + (size_t)j * H1 + k)
                            : make_float2(0.f, 0.f);
    *reinterpret_cast<uint32_t*>(pvs + r * LDH + k) = pack_bf16(v.x, v.y);
  }
  for (int e = t; e < CB * H1; e += MT) dpvs[e] = 0.f;
  if (t < H1) b1s[t] = b1[t];
  if (t == 0) {
    start_carry(carry);
    te.prev[0] = bb.d_lo - 1;
  }
  if (t < H2) {
    b2s[t] = b2[t];
    w3s[t] = w3[t];
  }
  __syncthreads();
  if (warp == 0) {
    float m = 0.f;
    for (int e = lane; e < H1 * H2; e += 32)
      m = fmaxf(m, fabsf(__bfloat162float(w2s[(e / H2) * LDW + e % H2])));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (lane == 0) *wmx = m;
  }

  const int c0 = warp * 16 + gq, c1 = c0 + 8;
  float dw2acc[H2 / 8][4];      // dW2 rows 16 warp + gq (+ 8), columns 8 nt + 2 q + e
  float db1acc[2][16];          // db1 units 64 half + 8 nt + 2 q + e, at [half][2 nt + e]
  float db2acc[2] = {0.f, 0.f}, dw3acc[2] = {0.f, 0.f};   // columns 8 gq + 2 q + e
#pragma unroll
  for (int nt = 0; nt < H2 / 8; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) dw2acc[nt][c] = 0.f;
#pragma unroll
  for (int x = 0; x < 16; ++x) db1acc[0][x] = db1acc[1][x] = 0.f;

  // Warps 0-3 fetch the tiles' edges, a tile ahead (EdgeIdx).
  EdgeIdx nxt = {0, 0, 0.f};
  int nxt_id = -1;
  if (t < TE) {
    nxt = fetch_edge(edges, g, edge_id(perm, bb.lo + t, bb.hi), bb.j0, ne);
    nxt_id = edge_id(perm, bb.lo + TE + t, bb.hi);
  }

  int par = 0;   // the tile's parity

  for (int p0 = bb.lo; p0 < bb.hi; p0 += TE, par ^= 1) {
    const int tn = min(TE, bb.hi - p0);  // edges in the tile
    __syncthreads();   // the previous tile is done with h1s, da2s, da1s and its edges
    if (t < TE) store_tile_edge(te, nxt, tn, bb.j0, nd, nv, t);
    __syncthreads();
    if (t < TE) {
      place_tile_edge(te, tn, par, t, dpd);
      nxt = fetch_edge(edges, g, nxt_id, bb.j0, ne);
      nxt_id = edge_id(perm, p0 + 2 * TE + t, bb.hi);
    }
    // Edges c0 and c1 (an edge past n is drug 0, column 0 with g = 0).
    const int i0 = te.src[c0], i1 = te.src[c1];
    const __nv_bfloat16* pv0 = pvs + te.col[c0] * LDH + 2 * q;
    const __nv_bfloat16* pv1 = pvs + te.col[c1] * LDH + 2 * q;
    const int j0 = bb.j0 + te.col[c0], j1 = bb.j0 + te.col[c1];
    const float gc[2] = {te.g[c0], te.g[c1]};
    const float* rows[2] = {pd + (size_t)i0 * H1 + 2 * q, pd + (size_t)i1 * H1 + 2 * q};
    // The Pd rows' values at the units of one k-step: [h][row] at units
    // 8 (2 ks + h) + 2 q + {0, 1}.
    float2 nxt[2][2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int r = 0; r < 2; ++r) nxt[h][r] = *reinterpret_cast<const float2*>(rows[r] + 8 * h);

    // a2 = rnd(h1d) @ rnd(w2), with h1d formed in the A fragments from the
    // rounded table rows; the da1 gate (a1 > 0 and the m1 keep bit) of each
    // unit is kept in gate0 / gate1 for edges c0 / c1.  Each k-step's
    // product starts from 0 and is added in f32: an mma that carries the
    // sum of earlier steps rounds it to fewer bits.  hs0 / hs1 sum the
    // edges' h1d, which bounds |a2 - b2| over max |w2|.
    uint32_t gate0 = 0u, gate1 = 0u;
    float hs0 = 0.f, hs1 = 0.f;
    float acc[H2 / 8][4];
#pragma unroll
    for (int nt = 0; nt < H2 / 8; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[nt][c] = 0.f;
    {
      const uint32_t key0 = cell_key(seed, 1u, i0, j0);
      const uint32_t key1 = cell_key(seed, 1u, i1, j1);
#pragma unroll 1
      for (int ks = 0; ks < H1 / 16; ++ks) {
        float2 cur[2][2];
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int r = 0; r < 2; ++r) cur[h][r] = nxt[h][r];
        if (ks + 1 < H1 / 16) {
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int r = 0; r < 2; ++r)
              nxt[h][r] = *reinterpret_cast<const float2*>(rows[r] + 8 * (2 * ks + 2 + h));
        }
        uint32_t a[4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = 2 * ks + h, k = 8 * m + 2 * q;
          const float2 bv = *reinterpret_cast<const float2*>(b1s + k);
          const float2 p0 = cur[h][0], p1 = cur[h][1];
          const float2 q0 = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(pv0 + 8 * m));
          const float2 q1 = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(pv1 + 8 * m));
          const float x[4] = {(rnd<true>(p0.x) + q0.x) + bv.x, (rnd<true>(p0.y) + q0.y) + bv.y,
                              (rnd<true>(p1.x) + q1.x) + bv.x, (rnd<true>(p1.y) + q1.y) + bv.y};
          float hv[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const uint32_t kk = (uint32_t)(k + (u & 1));
            const bool keep = !drop || fmix32((u < 2 ? key0 : key1) ^ kk) >= thresh;
            float hx = fmaxf(x[u], 0.f);
            if (drop) hx = hx * (keep ? scale : 0.f);
            hv[u] = hx;
            const uint32_t bit = (keep && x[u] > 0.f) ? 1u << (2 * m + (u & 1)) : 0u;
            if (u < 2) gate0 |= bit; else gate1 |= bit;
          }
          hs0 += hv[0] + hv[1];
          hs1 += hv[2] + hv[3];
          a[2 * h] = pack_bf16(hv[0], hv[1]);
          a[2 * h + 1] = pack_bf16(hv[2], hv[3]);
          *reinterpret_cast<uint32_t*>(h1s + c0 * LDH + k) = a[2 * h];
          *reinterpret_cast<uint32_t*>(h1s + c1 * LDH + k) = a[2 * h + 1];
        }
#pragma unroll
        for (int np = 0; np < H2 / 16; ++np) {
          uint32_t b[4];
          ldsm_t(b, smem_addr(w2s + (16 * ks + (mi & 1) * 8 + mr) * LDW +
                              16 * np + (mi >> 1) * 8));
          float s0[4] = {0.f, 0.f, 0.f, 0.f}, s1[4] = {0.f, 0.f, 0.f, 0.f};
          mma_bf16(s0, a, b[0], b[1]);
          mma_bf16(s1, a, b[2], b[3]);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            acc[2 * np][c] += s0[c];
            acc[2 * np + 1][c] += s1[c];
          }
        }
      }
      hs0 += __shfl_xor_sync(0xffffffffu, hs0, 1);
      hs0 += __shfl_xor_sync(0xffffffffu, hs0, 2);
      hs1 += __shfl_xor_sync(0xffffffffu, hs1, 1);
      hs1 += __shfl_xor_sync(0xffffffffu, hs1, 2);
    }
    __syncwarp();   // h1s holds the warp's 16 rows for seq_a2

    // On the accumulator: a2 = acc + b2 (taken again in the plain version's
    // order where it is near a step), h2d, da2 = (a2 > 0) * g * w3 * m2, the
    // db2 and dw3 sums, and rnd(da2) as the A fragments of dh1 and into
    // da2s for dW2.
    uint32_t da[H2 / 16][4];
    float band3[2];
    const float mk = drop ? scale : 1.f;
    {
      const uint32_t key0 = cell_key(seed, 2u, i0, j0);
      const uint32_t key1 = cell_key(seed, 2u, i1, j1);
      const float band[2] = {0x1p-20f * hs0 * *wmx, 0x1p-20f * hs1 * *wmx};
      // acc becomes a2; the thread's value v = 4 nt + 2 e + r gets its m2
      // keep bit, and a flag where a2 is near a step.
      uint32_t keep2 = 0u, fix = 0u;
#pragma unroll
      for (int nt = 0; nt < H2 / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = 8 * nt + 2 * q + e;
          const float bn = b2s[n];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int v = 4 * nt + 2 * e + r;
            const float a2 = acc[nt][2 * r + e] + bn;
            acc[nt][2 * r + e] = a2;
            const bool kp = !drop || fmix32((r == 0 ? key0 : key1) ^ (uint32_t)n) >= thresh;
            keep2 |= kp ? 1u << v : 0u;
            fix |= kp && near_step_abs(a2, mk, band[r]) ? 1u << v : 0u;
          }
        }
      }
      // The flagged values in the plain version's order, one lane each.
      for (uint32_t todo = fix; todo != 0u; todo &= todo - 1u) {
        const int v = __ffs((int)todo) - 1, nt = v >> 2, e = (v >> 1) & 1, r = v & 1;
        fixv[v] = seq_a2(h1s + (r == 0 ? c0 : c1) * LDH, w2s + 8 * nt + 2 * q + e) +
                  b2s[8 * nt + 2 * q + e];
      }
      const float gr[2] = {rnd<true>(gc[0]), rnd<true>(gc[1])};
      float sdb[16], sdw[16];
      float as0 = 0.f, as1 = 0.f;
#pragma unroll
      for (int nt = 0; nt < H2 / 8; ++nt) {
        float d[2][2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = 8 * nt + 2 * q + e;
          float hw[2];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int v = 4 * nt + 2 * e + r;
            float a2 = acc[nt][2 * r + e];
            if ((fix >> v) & 1u) a2 = fixv[v];
            const float m2 = (keep2 >> v) & 1u ? mk : 0.f;
            float h2d = fmaxf(a2, 0.f);
            float dh2 = gc[r] * w3s[n];
            if (drop) {
              h2d = h2d * m2;
              dh2 = dh2 * m2;
            }
            d[r][e] = a2 > 0.f ? dh2 : 0.f;
            hw[r] = gr[r] * rnd<true>(h2d);
          }
          sdb[2 * nt + e] = d[0][e] + d[1][e];
          sdw[2 * nt + e] = hw[0] + hw[1];
        }
        as0 += fabsf(d[0][0]) + fabsf(d[0][1]);
        as1 += fabsf(d[1][0]) + fabsf(d[1][1]);
        const uint32_t r0 = pack_bf16(d[0][0], d[0][1]);
        const uint32_t r1 = pack_bf16(d[1][0], d[1][1]);
        da[nt / 2][2 * (nt % 2)] = r0;
        da[nt / 2][2 * (nt % 2) + 1] = r1;
        *reinterpret_cast<uint32_t*>(da2s + c0 * LDW + 8 * nt + 2 * q) = r0;
        *reinterpret_cast<uint32_t*>(da2s + c1 * LDW + 8 * nt + 2 * q) = r1;
      }
      row_sum(sdb, lane);
      row_sum(sdw, lane);
      db2acc[0] += sdb[0];
      db2acc[1] += sdb[1];
      dw3acc[0] += sdw[0];
      dw3acc[1] += sdw[1];
      as0 += __shfl_xor_sync(0xffffffffu, as0, 1);
      as0 += __shfl_xor_sync(0xffffffffu, as0, 2);
      as1 += __shfl_xor_sync(0xffffffffu, as1, 1);
      as1 += __shfl_xor_sync(0xffffffffu, as1, 2);
      // |dh1 (* scale)| of an edge is bounded by its sum(|da2|) * max |w2|
      // (* scale): the window of the sums' noise around a bf16 midpoint of
      // da1, which rounds before its sum into dPd and dPv.
      band3[0] = 0x1p-20f * as0 * *wmx * mk;
      band3[1] = 0x1p-20f * as1 * *wmx * mk;
    }
    __syncwarp();   // da2s holds the warp's 16 rows for seq_dh1

    // dh1 = rnd(da2) @ rnd(w2)^T in two halves of 64 units, each k-step's
    // product started from 0 and added in f32; da1 = gate * dh1 (* scale
    // with dropout), summed again in unit order where it is near a bf16
    // midpoint, into db1 and, rounded, into the tile's da1 rows.  It needs
    // only the warp's own rows and w2s, so it runs before the barrier that
    // the dW2 product waits at.
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float acc3[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc3[nt][c] = 0.f;
#pragma unroll
      for (int ks = 0; ks < H2 / 16; ++ks) {
#pragma unroll
        for (int up = 0; up < 4; ++up) {
          uint32_t b[4];
          ldsm(b, smem_addr(w2s + (64 * half + 16 * up + (mi >> 1) * 8 + mr) * LDW +
                            16 * ks + (mi & 1) * 8));
          float s0[4] = {0.f, 0.f, 0.f, 0.f}, s1[4] = {0.f, 0.f, 0.f, 0.f};
          mma_bf16(s0, da[ks], b[0], b[1]);
          mma_bf16(s1, da[ks], b[2], b[3]);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            acc3[2 * up][c] += s0[c];
            acc3[2 * up + 1][c] += s1[c];
          }
        }
      }
      // acc3 becomes da1; the value v = 4 nt + c (c = 2 r + e) is flagged
      // where its gate is open and it is near a midpoint.
      uint32_t fix = 0u;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int r = c >> 1, x = 2 * (8 * half + nt) + (c & 1);
          float s = acc3[nt][c];
          if (drop) s = s * scale;
          const bool open = (((r == 0 ? gate0 : gate1) >> x) & 1u) != 0u;
          acc3[nt][c] = open ? s : 0.f;
          fix |= open && near_mid(s, band3[r]) ? 1u << (4 * nt + c) : 0u;
        }
      }
      for (uint32_t todo = fix; todo != 0u; todo &= todo - 1u) {
        const int v = __ffs((int)todo) - 1, nt = v >> 2, r = (v >> 1) & 1, e = v & 1;
        float s = seq_dh1(da2s + (r == 0 ? c0 : c1) * LDW,
                          w2s + (64 * half + 8 * nt + 2 * q + e) * LDW);
        if (drop) s = s * scale;
        fixv[v] = s;
      }
      __nv_bfloat16* out0 = da1s + c0 * LDH + 64 * half + 2 * q;
      __nv_bfloat16* out1 = da1s + c1 * LDH + 64 * half + 2 * q;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        float d[4];
#pragma unroll
        for (int c = 0; c < 4; ++c)
          d[c] = (fix >> (4 * nt + c)) & 1u ? fixv[4 * nt + c] : acc3[nt][c];
        db1acc[half][2 * nt] += d[0] + d[2];
        db1acc[half][2 * nt + 1] += d[1] + d[3];
        *reinterpret_cast<uint32_t*>(out0 + 8 * nt) = pack_bf16(d[0], d[1]);
        *reinterpret_cast<uint32_t*>(out1 + 8 * nt) = pack_bf16(d[2], d[3]);
      }
    }
    __syncthreads();   // h1s, da2s and da1s hold the whole tile

    // The tile's rnd(da1) rows into the node gradients; then the dW2
    // product, whose tensor-core work drains while the next tile's edges
    // are stored.
    tile_node_sums<true>(da1s, te, warp, MW, lane, par, carry, dpd, dpvs);
    tile_node_sums<false>(da1s, te, warp, MW, lane, par, carry, dpd, dpvs);

    // dW2 rows 16 warp .. + 15 += rnd(h1d)^T @ rnd(da2) over the tile's edges.
#pragma unroll
    for (int ks = 0; ks < TE / 16; ++ks) {
      uint32_t a[4];
      ldsm_t(a, smem_addr(h1s + (16 * ks + (mi >> 1) * 8 + mr) * LDH +
                          16 * warp + (mi & 1) * 8));
#pragma unroll
      for (int np = 0; np < H2 / 16; ++np) {
        uint32_t b[4];
        ldsm_t(b, smem_addr(da2s + (16 * ks + (mi & 1) * 8 + mr) * LDW +
                            16 * np + (mi >> 1) * 8));
        mma_bf16(dw2acc[2 * np], a, b[0], b[1]);
        mma_bf16(dw2acc[2 * np + 1], a, b[2], b[3]);
      }
    }

  }
  __syncthreads();   // the sums are done with dpvs and carry, the last tile with te.prev
  if (warp == 0) finish_carry(carry, par, lane, dpd);
  zero_tail(te, par, bb.d_hi, dpd, t, MT);
  write_dpv(dpvs, bb, nv, dpv_part, t, MT);

  // db1 over the lanes of each column (fixed shuffle tree), then db1, db2
  // and dw3 over the warps in order.
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    row_sum(db1acc[half], lane);   // [half][e]: units 64 half + 8 gq + 2 q + e
    *reinterpret_cast<float2*>(red + warp * H1 + 64 * half + 8 * gq + 2 * q) =
        make_float2(db1acc[half][0], db1acc[half][1]);
  }
  float* red2 = red + MW * H1;
  *reinterpret_cast<float2*>(red2 + warp * 2 * H2 + 8 * gq + 2 * q) =
      make_float2(db2acc[0], db2acc[1]);
  *reinterpret_cast<float2*>(red2 + warp * 2 * H2 + H2 + 8 * gq + 2 * q) =
      make_float2(dw3acc[0], dw3acc[1]);
  float* dw2b = dw2_part + (size_t)blk * H1 * H2;
#pragma unroll
  for (int nt = 0; nt < H2 / 8; ++nt) {
    const int n = 8 * nt + 2 * q;
    *reinterpret_cast<float2*>(dw2b + (16 * warp + gq) * H2 + n) =
        make_float2(dw2acc[nt][0], dw2acc[nt][1]);
    *reinterpret_cast<float2*>(dw2b + (16 * warp + gq + 8) * H2 + n) =
        make_float2(dw2acc[nt][2], dw2acc[nt][3]);
  }
  __syncthreads();
  float s = 0.f;
  if (t < H1) {
    for (int w = 0; w < MW; ++w) s += red[w * H1 + t];
    db1_part[(size_t)blk * H1 + t] = s;
  } else {
    const int c = t - H1;
    for (int w = 0; w < MW; ++w) s += red2[w * 2 * H2 + c];
    if (c < H2)
      db2_part[(size_t)blk * H2 + c] = s;
    else
      dw3_part[(size_t)blk * H2 + c - H2] = s;
  }
}
}  // namespace

extern "C" {

// nf folds in one launch: pd (nf, nd, H1), pv (nf, nv, H1), b1 (nf, H1),
// w2 (nf, H1, H2), b2 (nf, H2), w3 (nf, H2), edges (nf, 2, ne) int32
// [src; dst], seed (nf,), out (nf, ne).  One fold is nf = 1.  bf16 runs
// on the tensor cores, fp32 on the CUDA cores.
int edge_decoder_fwd(const float* pd, const float* pv, const float* b1,
                     const float* w2, const float* b2, const float* w3,
                     const int* edges, const int* seed, float* out, int nf,
                     int nd, int nv, int ne, unsigned int thresh, float scale,
                     int use_drop, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    // Blocks per fold: whole waves of two blocks an SM (wave_split).  For 10
    // folds of 167,168 edges (1,306 tiles a fold) 25, blocks of 52 or 53 tiles.
    const int split = wave_split((ne + TE - 1) / TE, (long)nf, FWD_BLOCKS);
    edge_fwd_mma_kernel<<<dim3(split, nf), MT, FWD_MMA_SMEM, s>>>(
        pd, pv, b1, w2, b2, w3, edges, seed, out, nd, nv, ne, thresh, scale, use_drop);
  } else {
    edge_fwd_kernel<<<dim3((ne + TE - 1) / TE, nf), TE, FWD_SMEM * sizeof(float), s>>>(
        pd, pv, b1, w2, b2, w3, edges, seed, out, nd, nv, ne, thresh, scale, use_drop);
  }
  return (int)cudaGetLastError();
}

// Residency of the forward kernel of one dtype on one SM of this card:
// occ[] receives {blocks, warps a block}.  Returns 0 or the CUDA error.
int edge_decoder_fwd_occupancy(int bf16, int* occ) {
  int blocks = 0;
  const cudaError_t err =
      bf16 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, edge_fwd_mma_kernel, MT,
                                                           FWD_MMA_SMEM)
           : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, edge_fwd_kernel, TE,
                                                           FWD_SMEM * sizeof(float));
  occ[0] = blocks;
  occ[1] = (bf16 ? MT : TE) / 32;
  return (int)err;
}

// Its backward: g (nf, ne); the edges' ordering (EdgeOrder) perm (nf, ne)
// and split_edge / split_drug (nf, n_cb, n_part + 1), n_cb = ceil(nv / 32),
// whose n_part parts of a column block go to n_split blocks
// (edge_decoder.py:bwd_split); the partials, each written whole: dpd_part
// (nf, n_cb, nd, H1), dpv_part (nf, n_split, nv, H1) and the weight slabs
// (nf, n_cb * n_split, ...).  One block an SM in both dtypes (the fp32
// block by its shared memory, the bf16 block by its registers).  bf16 runs
// on the tensor cores, fp32 on the CUDA cores.
int edge_decoder_bwd(const float* pd, const float* pv, const float* b1,
                     const float* w2, const float* b2, const float* w3,
                     const int* edges, const int* seed, const float* g,
                     const int* perm, const int* split_edge, const int* split_drug,
                     float* dpd_part, float* dpv_part, float* db1_part,
                     float* dw2_part, float* db2_part, float* dw3_part, int nf,
                     int nd, int nv, int ne, int n_part, int n_split,
                     unsigned int thresh, float scale, int use_drop, int bf16,
                     void* stream) {
  const dim3 grid((nv + CB - 1) / CB * n_split, nf);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bf16) {
    err = prepare(edge_bwd_mma_kernel, MMA_SMEM / (int)sizeof(float));
    if (err != cudaSuccess) return (int)err;
    edge_bwd_mma_kernel<<<grid, MT, MMA_SMEM, s>>>(
        pd, pv, b1, w2, b2, w3, edges, seed, g, perm, split_edge, split_drug, dpd_part,
        dpv_part, db1_part, dw2_part, db2_part, dw3_part, nd, nv, ne, n_part, thresh, scale,
        use_drop);
  } else {
    err = prepare(edge_bwd_kernel, BWD_SMEM);
    if (err != cudaSuccess) return (int)err;
    edge_bwd_kernel<<<grid, TE, BWD_SMEM * sizeof(float), s>>>(
        pd, pv, b1, w2, b2, w3, edges, seed, g, perm, split_edge, split_drug, dpd_part,
        dpv_part, db1_part, dw2_part, db2_part, dw3_part, nd, nv, ne, n_part, thresh, scale,
        use_drop);
  }
  return (int)cudaGetLastError();
}

// Residency of the backward of one dtype on one SM of this card: occ[]
// receives {blocks, warps a block}.  Returns 0 or the CUDA error.
int edge_decoder_bwd_occupancy(int bf16, int* occ) {
  cudaError_t err;
  int blocks = 0;
  if (bf16) {
    err = prepare(edge_bwd_mma_kernel, MMA_SMEM / (int)sizeof(float));
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, edge_bwd_mma_kernel,
                                                          MT, MMA_SMEM);
  } else {
    err = prepare(edge_bwd_kernel, BWD_SMEM);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, edge_bwd_kernel, TE,
                                                          BWD_SMEM * sizeof(float));
  }
  occ[0] = blocks;
  occ[1] = (bf16 ? MT : TE) / 32;
  return (int)err;
}

}  // extern "C"

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
// kFLOP backward against a few bytes per edge, so operations, by far.
//
// Design:
// - forward, the fold on blockIdx.y:
//   - bf16 (edge_fwd_mma_kernel): the a2 product on the tensor cores, as
//     in grid_fwd_mma_kernel (grid_decoder.cu) and with the same tile
//     (fwd_mma_rows, decoder_common.cuh): 8 warps of 16 edges, 128 edges a
//     tile, rnd(h1d) built in the A fragments from the rounded table rows.
//     A block stages w2 in bf16 once and walks a fixed, strided subset of
//     its fold's tiles, in whole waves of two blocks an SM; each thread
//     reads its two edges' table rows from L2 one k-step ahead of the mma,
//     as edge_bwd_mma_kernel does.  No unit-order recompute: h2d is not
//     rounded and the logit is continuous in a2.
//   - fp32 (edge_fwd_kernel): on the CUDA cores, where TF32 would round
//     what the fp32 Pallas kernel does not: one thread per edge, 128 edges
//     a block.  w2, b1, b2 and w3 sit in shared memory; each thread reads
//     its two table rows from global memory (the tables stay in L2) and
//     keeps its 64 a2 sums in registers.
// - backward, pass 1: a block walks a fixed, strided subset of one fold's
//   128-edge tiles.  Per tile it recomputes the forward, forms da2 and da1,
//   sums dW2, db1, db2 and dw3 over its tiles, and writes each edge's
//   rnd(da1) row to an (F, E, 128) buffer.  Each block writes its own
//   partial slabs, which the caller sums in a fixed order.
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
//     da1 is near a bf16 midpoint (seq_dh1); and it has no table tile to
//     share: each thread reads its two edges' table rows at its units from
//     global memory, one k-step ahead.
//   - fp32 (edge_bwd_kernel): the tensor cores would take fp32 operands
//     only as TF32, which rounds where the fp32 Pallas kernel does not, so
//     the products stay on the CUDA cores: one thread per edge, f32 tiles
//     in shared memory.
// - backward, pass 2: a segmented row sum of that buffer into dPd and dPv,
//   one block per node and fold, over a CSR ordering of the fold's edges by
//   src and by dst (stable, so each node's edges in list order).  No float
//   atomics anywhere, so two runs give the same bits.
//
// Every entry point returns cudaGetLastError() after its launches.

#include <cassert>

#include "decoder_common.cuh"

namespace {

constexpr int TE = 128;          // edges per tile, one thread per edge
static_assert(TE == H1, "the backward's reductions map one thread to one H1 unit");

// Shared memory, in floats.
constexpr int FWD_SMEM = H1 * H2 + H1 + 2 * H2;
constexpr int BWD_SMEM = H1 * H2          // w2
                       + H1 + 2 * H2      // b1, b2, w3
                       + TE * LD1         // h1d of the tile, then da1
                       + TE * LD2         // da2 of the tile
                       + 2 * (TE / 32) * H2   // per-warp sums for db2, dw3
                       + H1 * LD2;        // dW2 accumulator

// The bf16 backward: MW = 8 warps (decoder_common.cuh), each owning 16
// edges of a tile.  Shared memory, in bytes.
static_assert(TE == MW * 16, "each warp owns one 16-row mma tile of edges");
static_assert(H1 == MW * 16, "each warp owns 16 H1 units of dW2");
static_assert(MT == H1 + 2 * H2, "the final sums map one thread to one output");
constexpr int MMA_SMEM = H1 * LDW * 2     // w2, bf16
                       + TE * LDH * 2     // rnd(h1d) of the tile
                       + TE * LDW * 2     // rnd(da2) of the tile
                       + (H1 + 2 * H2) * 4    // b1, b2, w3
                       + 2 * MW * H1 * 4  // per-warp db1, db2 and dw3 sums
                       + 4                // max |rnd(w2)|
                       + MT * FIX_LD * 4; // a2 and da1 taken again, per thread

// The bf16 forward, in bytes: w2 in bf16, b1, b2, w3.
constexpr int FWD_MMA_SMEM = H1 * LDW * 2 + (H1 + 2 * H2) * 4;

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
    const float* __restrict__ g,
    float* __restrict__ da1_out,    // (F, ne, H1): da1 per edge
    float* __restrict__ db1_part,   // (F, n_split, H1)
    float* __restrict__ dw2_part,   // (F, n_split, H1, H2)
    float* __restrict__ db2_part,   // (F, n_split, H2)
    float* __restrict__ dw3_part,   // (F, n_split, H2)
    int nd, int nv, int ne, uint32_t thresh, float scale, int use_drop) {
  extern __shared__ float4 smem4[];
  float* w2s = reinterpret_cast<float*>(smem4);
  float* b1s = w2s + H1 * H2;
  float* b2s = b1s + H1;
  float* w3s = b2s + H2;
  float* hbuf = w3s + H2;
  float* da2s = hbuf + TE * LD1;
  float* red = da2s + TE * LD2;            // [2][TE/32][H2]: db2, then dw3
  float* dw2acc = red + 2 * (TE / 32) * H2;

  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const int split = blockIdx.x, n_split = gridDim.x;
  const int f = blockIdx.y, blk = f * n_split + split;
  const int n_tiles = (ne + TE - 1) / TE;
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
  da1_out += (size_t)f * ne * H1;

  for (int e = t; e < H1 * H2; e += TE) w2s[e] = w2[e];
  for (int e = t; e < H1 * LD2; e += TE) dw2acc[e] = 0.f;
  b1s[t] = b1[t];
  if (t < H2) {
    b2s[t] = b2[t];
    w3s[t] = w3[t];
  }
  float db1acc = 0.f, db2acc = 0.f, dw3acc = 0.f;

  for (int tile = split; tile < n_tiles; tile += n_split) {
    const int e0 = tile * TE, e = e0 + t;
    const bool valid = e < ne;
    // A padding thread runs edge (0, 0) with g = 0: it adds nothing to any
    // sum and writes no da1 row.
    const int i = valid ? edges[e] : 0, j = valid ? edges[ne + e] : 0;
    assert(0 <= i && i < nd && 0 <= j && j < nv);
    const float* pd_row = pd + (size_t)i * H1;
    const float* pv_row = pv + (size_t)j * H1;
    const float gc = valid ? g[e] : 0.f;
    __syncthreads();   // the previous tile is done with hbuf and da2s

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

    // Thread k: db1 sums da1, and each edge's da1 row goes out whole.
    {
      const int k = t;
      const int n_valid = min(TE, ne - e0);
#pragma unroll 4
      for (int c = 0; c < TE; ++c) {
        const float v = hbuf[c * LD1 + k];
        db1acc += v;
        if (c < n_valid) da1_out[(size_t)(e0 + c) * H1 + k] = v;
      }
    }
  }
  __syncthreads();

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

// The bf16 backward on the tensor cores, pass 1.  The fragment layout of
// mma m16n8k16 (lane = 4 gq + q; see grid_bwd_mma_kernel) gives a thread
// of warp w edges c0 = 16 w + gq and c1 = c0 + 8 of the tile, and of each
// 128-unit row the units 8 m + 2 q + e, m < 16, e < 2, which it indexes as
// 2 m + e.  It reads those units of its two edges' table rows straight from
// global memory (a fold's tables stay in L2), one k-step ahead of the a2
// product that consumes them.
__global__ void __launch_bounds__(MT, 1) edge_bwd_mma_kernel(
    const float* __restrict__ pd, const float* __restrict__ pv,
    const float* __restrict__ b1, const float* __restrict__ w2,
    const float* __restrict__ b2, const float* __restrict__ w3,
    const int* __restrict__ edges, const int* __restrict__ seed_ptr,
    const float* __restrict__ g,
    float* __restrict__ da1_out,    // (F, ne, H1): rnd(da1) per edge
    float* __restrict__ db1_part,   // (F, n_split, H1)
    float* __restrict__ dw2_part,   // (F, n_split, H1, H2)
    float* __restrict__ db2_part,   // (F, n_split, H2)
    float* __restrict__ dw3_part,   // (F, n_split, H2)
    int nd, int nv, int ne, uint32_t thresh, float scale, int use_drop) {
  extern __shared__ float4 smem4[];
  __nv_bfloat16* w2s = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* h1s = w2s + H1 * LDW;
  __nv_bfloat16* da2s = h1s + TE * LDH;
  float* b1s = reinterpret_cast<float*>(da2s + TE * LDW);
  float* b2s = b1s + H1;
  float* w3s = b2s + H2;
  float* red = w3s + H2;                  // [MW][H1] db1, then [MW][2 H2] db2, dw3
  float* wmx = red + 2 * MW * H1;
  float* fixv = wmx + 1 + threadIdx.x * FIX_LD;

  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const int gq = lane >> 2, q = lane & 3;
  const int mi = lane >> 3, mr = lane & 7;   // ldmatrix: matrix and row
  const int split = blockIdx.x, n_split = gridDim.x;
  const int f = blockIdx.y, blk = f * n_split + split;
  const int n_tiles = (ne + TE - 1) / TE;
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
  da1_out += (size_t)f * ne * H1;

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

  for (int tile = split; tile < n_tiles; tile += n_split) {
    // Edges c0 and c1.  A padding edge is (0, 0) with g = 0: it adds
    // nothing to any sum and writes no da1 row.
    const int e0 = tile * TE;
    const bool v0 = e0 + c0 < ne, v1 = e0 + c1 < ne;
    const int i0 = v0 ? edges[e0 + c0] : 0, j0 = v0 ? edges[ne + e0 + c0] : 0;
    const int i1 = v1 ? edges[e0 + c1] : 0, j1 = v1 ? edges[ne + e0 + c1] : 0;
    assert(0 <= i0 && i0 < nd && 0 <= j0 && j0 < nv);
    assert(0 <= i1 && i1 < nd && 0 <= j1 && j1 < nv);
    const float gc[2] = {v0 ? g[e0 + c0] : 0.f, v1 ? g[e0 + c1] : 0.f};
    const float* rows[4] = {pd + (size_t)i0 * H1, pv + (size_t)j0 * H1,
                            pd + (size_t)i1 * H1, pv + (size_t)j1 * H1};
    // The rows' values at the units of one k-step: [h][row] at units
    // 8 (2 ks + h) + 2 q + {0, 1}.
    float2 nxt[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        nxt[h][r] = *reinterpret_cast<const float2*>(rows[r] + 8 * h + 2 * q);
    __syncthreads();   // the previous tile's dW2 product is done with h1s and da2s

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
              nxt[h][r] = *reinterpret_cast<const float2*>(
                  rows[r] + 8 * (2 * ks + 2 + h) + 2 * q);
        }
        uint32_t a[4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = 2 * ks + h, k = 8 * m + 2 * q;
          const float2 bv = *reinterpret_cast<const float2*>(b1s + k);
          const float2 p0 = cur[h][0], q0 = cur[h][1], p1 = cur[h][2], q1 = cur[h][3];
          const float x[4] = {(rnd<true>(p0.x) + rnd<true>(q0.x)) + bv.x,
                              (rnd<true>(p0.y) + rnd<true>(q0.y)) + bv.y,
                              (rnd<true>(p1.x) + rnd<true>(q1.x)) + bv.x,
                              (rnd<true>(p1.y) + rnd<true>(q1.y)) + bv.y};
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
    // midpoint, into db1 and, rounded, into the edges' da1 rows.  It needs
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
      float* out0 = da1_out + (size_t)(e0 + c0) * H1 + 64 * half + 2 * q;
      float* out1 = da1_out + (size_t)(e0 + c1) * H1 + 64 * half + 2 * q;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        float d[4];
#pragma unroll
        for (int c = 0; c < 4; ++c)
          d[c] = (fix >> (4 * nt + c)) & 1u ? fixv[4 * nt + c] : acc3[nt][c];
        db1acc[half][2 * nt] += d[0] + d[2];
        db1acc[half][2 * nt + 1] += d[1] + d[3];
        if (v0)
          *reinterpret_cast<float2*>(out0 + 8 * nt) =
              make_float2(rnd<true>(d[0]), rnd<true>(d[1]));
        if (v1)
          *reinterpret_cast<float2*>(out1 + 8 * nt) =
              make_float2(rnd<true>(d[2]), rnd<true>(d[3]));
      }
    }
    __syncthreads();   // h1s and da2s hold the whole tile

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

// Pass 2: dPd[f, n] = sum of da1[f, e] over the edges e with src[e] = n, in
// list order (blocks 0 .. nd-1), and dPv likewise by dst (blocks nd ..).
// Thread k sums unit k.
__global__ void __launch_bounds__(H1) edge_scatter_kernel(
    const float* __restrict__ da1,
    const int* __restrict__ src_perm, const int* __restrict__ src_off,
    const int* __restrict__ dst_perm, const int* __restrict__ dst_off,
    float* __restrict__ dpd, float* __restrict__ dpv, int nd, int nv, int ne) {
  const int f = blockIdx.y, k = threadIdx.x;
  int n = blockIdx.x;
  const int* perm;
  const int* off;
  float* out;
  if (n < nd) {
    perm = src_perm + (size_t)f * ne;
    off = src_off + (size_t)f * (nd + 1);
    out = dpd + ((size_t)f * nd + n) * H1;
  } else {
    n -= nd;
    perm = dst_perm + (size_t)f * ne;
    off = dst_off + (size_t)f * (nv + 1);
    out = dpv + ((size_t)f * nv + n) * H1;
  }
  da1 += (size_t)f * ne * H1;
  const int p1 = off[n + 1];
  float s = 0.f;
#pragma unroll 4
  for (int p = off[n]; p < p1; ++p) s += da1[(size_t)perm[p] * H1 + k];
  out[k] = s;
}

}  // namespace

extern "C" {

// Blocks per fold of the backward's pass 1 for nf folds of ne edges: the
// partial slabs are (nf, split, ...).  One block an SM in both dtypes (the
// fp32 block by its shared memory, the bf16 block by its registers).
int edge_decoder_bwd_split(int nf, int ne) {
  return wave_split((ne + TE - 1) / TE, (long)nf);
}

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

// Its backward: g (nf, ne); the CSR orderings src_perm / dst_perm (nf, ne)
// and src_off (nf, nd + 1) / dst_off (nf, nv + 1); the da1 buffer
// (nf, ne, H1); partial slabs (nf, split, ...) with split from
// edge_decoder_bwd_split; dpd (nf, nd, H1) and dpv (nf, nv, H1), written
// whole by pass 2.  bf16 runs pass 1 on the tensor cores, fp32 on the CUDA
// cores.
int edge_decoder_bwd(const float* pd, const float* pv, const float* b1,
                     const float* w2, const float* b2, const float* w3,
                     const int* edges, const int* seed, const float* g,
                     const int* src_perm, const int* src_off,
                     const int* dst_perm, const int* dst_off, float* da1,
                     float* db1_part, float* dw2_part, float* db2_part,
                     float* dw3_part, float* dpd, float* dpv, int nf, int nd,
                     int nv, int ne, unsigned int thresh, float scale,
                     int use_drop, int bf16, void* stream) {
  const dim3 grid(edge_decoder_bwd_split(nf, ne), nf);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bf16) {
    err = prepare(edge_bwd_mma_kernel, MMA_SMEM / (int)sizeof(float));
    if (err != cudaSuccess) return (int)err;
    edge_bwd_mma_kernel<<<grid, MT, MMA_SMEM, s>>>(
        pd, pv, b1, w2, b2, w3, edges, seed, g, da1, db1_part, dw2_part, db2_part,
        dw3_part, nd, nv, ne, thresh, scale, use_drop);
  } else {
    err = prepare(edge_bwd_kernel, BWD_SMEM);
    if (err != cudaSuccess) return (int)err;
    edge_bwd_kernel<<<grid, TE, BWD_SMEM * sizeof(float), s>>>(
        pd, pv, b1, w2, b2, w3, edges, seed, g, da1, db1_part, dw2_part, db2_part,
        dw3_part, nd, nv, ne, thresh, scale, use_drop);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  edge_scatter_kernel<<<dim3(nd + nv, nf), H1, 0, s>>>(
      da1, src_perm, src_off, dst_perm, dst_off, dpd, dpv, nd, nv, ne);
  return (int)cudaGetLastError();
}

// Residency of the backward's pass 1 of one dtype on one SM of this card:
// occ[] receives {blocks, warps a block}.  Returns 0 or the CUDA error.
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

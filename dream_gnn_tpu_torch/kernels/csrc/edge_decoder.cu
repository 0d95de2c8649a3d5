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
// kFLOP backward against a few bytes per edge, so operations, by far.  This
// first version runs the products on the CUDA cores in f32, like the grid
// kernels, and leaves the tensor cores unused.
//
// Design (simple first):
// - forward: one thread per edge, 128 edges a block, the fold on
//   blockIdx.y.  w2, b1, b2 and w3 sit in shared memory; each thread reads
//   its two table rows from global memory (the tables stay in L2) and keeps
//   its 64 a2 sums in registers.
// - backward, pass 1: a block walks a fixed, strided subset of one fold's
//   128-edge tiles.  Per tile it recomputes the forward, forms da2 and da1,
//   sums dW2 in shared memory and db1, db2, dw3 in registers over its tiles,
//   and writes each edge's rnd(da1) row to an (F, E, 128) buffer.  Each
//   block writes its own partial slabs, which the caller sums in a fixed
//   order.
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
constexpr int BWD_SMEM = H1 * H2          // w2 (rounded)
                       + H1 + 2 * H2      // b1, b2, w3
                       + TE * LD1         // rnd(h1d) of the tile, then da1
                       + TE * LD2         // rnd(da2) of the tile
                       + 2 * (TE / 32) * H2   // per-warp sums for db2, dw3
                       + H1 * LD2;        // dW2 accumulator

template <bool BF16>
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
  for (int e = t; e < H1 * H2; e += TE) w2s[e] = rnd<BF16>(w2[e]);
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
  cell_layer1<BF16, true>(pd + (size_t)i * H1, pv + (size_t)j * H1, b1s, w2s,
                          cell_key(seed, 1u, i, j), drop, thresh, scale, acc,
                          nullptr);
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

template <bool BF16>
__global__ void __launch_bounds__(TE) edge_bwd_kernel(
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

  for (int e = t; e < H1 * H2; e += TE) w2s[e] = rnd<BF16>(w2[e]);
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
    const float gc = valid ? g[e] : 0.f, gr = rnd<BF16>(gc);
    __syncthreads();   // the previous tile is done with hbuf and da2s

    // Per edge: recompute the forward, then da2 = (a2 > 0) * g * w3 * m2.
    {
      float acc[H2];
      cell_layer1<BF16, true>(pd_row, pv_row, b1s, w2s, cell_key(seed, 1u, i, j),
                              drop, thresh, scale, acc, hbuf + t * LD1);
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
        const float sdw3 = warp_sum(gr * rnd<BF16>(h2d));
        const float sdb2 = warp_sum(da2);
        if (lane == 0) {
          red[warp * H2 + n] = sdb2;
          red[(TE / 32 + warp) * H2 + n] = sdw3;
        }
        acc[n] = rnd<BF16>(da2);
      }
      float4* drow = reinterpret_cast<float4*>(da2s + t * LD2);
#pragma unroll
      for (int q = 0; q < H2 / 4; ++q)
        drow[q] = make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]);
    }
    __syncthreads();

    // Thread k: row k of dW2 += sum over edges of rnd(h1d)[k] * rnd(da2).
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

    // Per edge: dh1 = rnd(da2) @ rnd(w2)^T, da1 = (a1 > 0) * dh1 * m1.
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
        const float rows[4] = {rnd<BF16>(pa.x) + rnd<BF16>(pb.x),
                               rnd<BF16>(pa.y) + rnd<BF16>(pb.y),
                               rnd<BF16>(pa.z) + rnd<BF16>(pb.z),
                               rnd<BF16>(pa.w) + rnd<BF16>(pb.w)};
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

    // Thread k: db1 sums da1, and each edge's rnd(da1) row goes out whole.
    {
      const int k = t;
      const int n_valid = min(TE, ne - e0);
#pragma unroll 4
      for (int c = 0; c < TE; ++c) {
        const float v = hbuf[c * LD1 + k];
        db1acc += v;
        if (c < n_valid) da1_out[(size_t)(e0 + c) * H1 + k] = rnd<BF16>(v);
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
// partial slabs are (nf, split, ...).
int edge_decoder_bwd_split(int nf, int ne) {
  return wave_split((ne + TE - 1) / TE, (long)nf);
}

// nf folds in one launch: pd (nf, nd, H1), pv (nf, nv, H1), b1 (nf, H1),
// w2 (nf, H1, H2), b2 (nf, H2), w3 (nf, H2), edges (nf, 2, ne) int32
// [src; dst], seed (nf,), out (nf, ne).  One fold is nf = 1.
int edge_decoder_fwd(const float* pd, const float* pv, const float* b1,
                     const float* w2, const float* b2, const float* w3,
                     const int* edges, const int* seed, float* out, int nf,
                     int nd, int nv, int ne, unsigned int thresh, float scale,
                     int use_drop, int bf16, void* stream) {
  const dim3 grid((ne + TE - 1) / TE, nf);
  const size_t smem = FWD_SMEM * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    edge_fwd_kernel<true><<<grid, TE, smem, s>>>(pd, pv, b1, w2, b2, w3, edges, seed,
                                                 out, nd, nv, ne, thresh, scale, use_drop);
  } else {
    edge_fwd_kernel<false><<<grid, TE, smem, s>>>(pd, pv, b1, w2, b2, w3, edges, seed,
                                                  out, nd, nv, ne, thresh, scale, use_drop);
  }
  return (int)cudaGetLastError();
}

// Its backward: g (nf, ne); the CSR orderings src_perm / dst_perm (nf, ne)
// and src_off (nf, nd + 1) / dst_off (nf, nv + 1); the da1 buffer
// (nf, ne, H1); partial slabs (nf, split, ...) with split from
// edge_decoder_bwd_split; dpd (nf, nd, H1) and dpv (nf, nv, H1), written
// whole by pass 2.
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
  const size_t smem = BWD_SMEM * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bf16) {
    err = prepare(edge_bwd_kernel<true>, BWD_SMEM);
    if (err != cudaSuccess) return (int)err;
    edge_bwd_kernel<true><<<grid, TE, smem, s>>>(
        pd, pv, b1, w2, b2, w3, edges, seed, g, da1, db1_part, dw2_part, db2_part,
        dw3_part, nd, nv, ne, thresh, scale, use_drop);
  } else {
    err = prepare(edge_bwd_kernel<false>, BWD_SMEM);
    if (err != cudaSuccess) return (int)err;
    edge_bwd_kernel<false><<<grid, TE, smem, s>>>(
        pd, pv, b1, w2, b2, w3, edges, seed, g, da1, db1_part, dw2_part, db2_part,
        dw3_part, nd, nv, ne, thresh, scale, use_drop);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  edge_scatter_kernel<<<dim3(nd + nv, nf), H1, 0, s>>>(
      da1, src_perm, src_off, dst_perm, dst_off, dpd, dpv, nd, nv, ne);
  return (int)cudaGetLastError();
}

}  // extern "C"

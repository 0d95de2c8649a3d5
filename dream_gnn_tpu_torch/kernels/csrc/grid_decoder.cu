// Fused dense-grid MLP decoder for Hopper (sm_90a), forward and backward.
//
// Replaces the Pallas TPU kernels _fwd_kernel and _bwd_kernel of
// dream_gnn_tpu/kernels/pallas_grid_decoder.py.  For every cell (drug i,
// disease j) of the grid:
//
//     a1  = Pd[i] + Pv[j] + b1                 (H1 = 128 units)
//     h1d = relu(a1) * m1                      (m1: dropout mask, layer 1)
//     a2  = rnd(h1d) @ rnd(w2) + b2            (H2 = 64 units, f32 sums)
//     h2d = relu(a2) * m2                      (m2: dropout mask, layer 2)
//     out[i, j] = h2d . w3                     (b3 is added by the caller)
//
// rnd() rounds to bf16 in bf16 mode and is the identity in fp32 mode, at
// the same points as the Pallas kernels.  Dropout bits are a stateless hash
// of (seed, layer, i, j, k); see dream_gnn_tpu_torch/kernels/grid_decoder.py
// for the definition that the plain PyTorch version shares bit for bit.
//
// Design (simple first; the tensor cores are left unused):
// - forward: one block of 128 threads per 4 x 32 tile of cells, one thread
//   per cell; w2, b1, b2, w3 and the tile's Pd / Pv rows sit in shared
//   memory; each thread keeps its 64 a2 sums in registers and reads w2
//   rows as float4 broadcasts.
// - backward: a block owns one 32-disease column of tiles and walks over a
//   fixed, strided subset of the 4-drug row tiles.  Per tile it recomputes
//   the forward, forms da2 and da1 per cell, and reduces the cross-cell
//   sums through shared memory: dW2 and dPv accumulate in shared memory
//   over the block's tiles, dPd is written once per tile.  Each block
//   writes its own partial slabs, which the caller sums in a second pass:
//   no float atomics, so the result does not change from run to run.
//
// Every entry point returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int H1 = 128;          // decoder hidden1; one thread per unit in reductions
constexpr int H2 = 64;           // decoder hidden2
constexpr int TI = 4;            // drugs per tile
constexpr int TJ = 32;           // diseases per tile (one warp per drug row)
constexpr int NT = TI * TJ;      // threads per block, one per cell of a tile
static_assert(NT == H1, "the backward's reductions map one thread to one H1 unit");
constexpr int LD1 = H1 + 4;      // padded row stride of H1-wide tiles (16-byte aligned)
constexpr int LD2 = H2 + 4;      // padded row stride of H2-wide tiles

// Shared memory, in floats.
constexpr int FWD_SMEM = H1 * H2 + TJ * LD1 + TI * H1 + H1 + 2 * H2;
constexpr int BWD_SMEM = H1 * H2          // w2 (rounded)
                       + TJ * LD1         // Pv rows of the block's disease tile
                       + TI * H1          // Pd rows of the current drug tile
                       + H1 + 2 * H2      // b1, b2, w3
                       + NT               // g of the current tile
                       + NT * LD1         // h1d of the tile, then da1
                       + NT * LD2         // rnd(da2) of the tile
                       + 2 * (NT / 32) * H2   // per-warp sums for db2, dw3
                       + H1 * LD2         // dW2 accumulator
                       + TJ * H1;         // dPv accumulator

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// Hash prefix of one cell and layer; the unit's bits are fmix32(key ^ k).
__device__ __forceinline__ uint32_t cell_key(uint32_t seed, uint32_t layer,
                                             uint32_t i, uint32_t j) {
  return fmix32(fmix32(fmix32(seed ^ layer) ^ i) ^ j);
}

template <bool BF16>
__device__ __forceinline__ float rnd(float x) {
  if constexpr (BF16) {
    return __bfloat162float(__float2bfloat16_rn(x));
  } else {
    return x;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Layer 1 and the a2 product of one cell.  acc[n] receives rnd(h1d) @ rnd(w2)
// without b2.  When hrow is given, rnd(h1d) is stored there.
template <bool BF16>
__device__ __forceinline__ void cell_layer1(
    const float* pd_row, const float* pv_row, const float* b1s,
    const float* w2s, uint32_t key1, bool drop, uint32_t thresh, float scale,
    float (&acc)[H2], float* hrow) {
#pragma unroll
  for (int n = 0; n < H2; ++n) acc[n] = 0.f;
#pragma unroll 1
  for (int k = 0; k < H1; k += 4) {
    const float4 a = *reinterpret_cast<const float4*>(pd_row + k);
    const float4 b = *reinterpret_cast<const float4*>(pv_row + k);
    const float4 c = *reinterpret_cast<const float4*>(b1s + k);
    float h[4] = {(a.x + b.x) + c.x, (a.y + b.y) + c.y,
                  (a.z + b.z) + c.z, (a.w + b.w) + c.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float x = fmaxf(h[u], 0.f);
      if (drop) x = x * (fmix32(key1 ^ (uint32_t)(k + u)) >= thresh ? scale : 0.f);
      h[u] = rnd<BF16>(x);
    }
    if (hrow) *reinterpret_cast<float4*>(hrow + k) = make_float4(h[0], h[1], h[2], h[3]);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float4* wr = reinterpret_cast<const float4*>(w2s + (k + u) * H2);
#pragma unroll
      for (int q = 0; q < H2 / 4; ++q) {
        const float4 w = wr[q];
        acc[4 * q + 0] += h[u] * w.x;
        acc[4 * q + 1] += h[u] * w.y;
        acc[4 * q + 2] += h[u] * w.z;
        acc[4 * q + 3] += h[u] * w.w;
      }
    }
  }
}

template <bool BF16>
__global__ void __launch_bounds__(NT) grid_fwd_kernel(
    const float* __restrict__ pd, const float* __restrict__ pv,
    const float* __restrict__ b1, const float* __restrict__ w2,
    const float* __restrict__ b2, const float* __restrict__ w3,
    const int* __restrict__ seed_ptr, float* __restrict__ out, int nd, int nv,
    uint32_t thresh, float scale, int use_drop) {
  extern __shared__ float4 smem4[];
  float* w2s = reinterpret_cast<float*>(smem4);
  float* pvs = w2s + H1 * H2;
  float* pds = pvs + TJ * LD1;
  float* b1s = pds + TI * H1;
  float* b2s = b1s + H1;
  float* w3s = b2s + H2;

  const int t = threadIdx.x;
  const int i0 = blockIdx.y * TI, j0 = blockIdx.x * TJ;
  for (int e = t; e < H1 * H2; e += NT) w2s[e] = rnd<BF16>(w2[e]);
  for (int e = t; e < TJ * H1; e += NT) {
    const int r = e / H1, k = e % H1, j = j0 + r;
    pvs[r * LD1 + k] = j < nv ? pv[(size_t)j * H1 + k] : 0.f;
  }
  for (int e = t; e < TI * H1; e += NT) {
    const int r = e / H1, k = e % H1, i = i0 + r;
    pds[r * H1 + k] = i < nd ? pd[(size_t)i * H1 + k] : 0.f;
  }
  b1s[t] = b1[t];
  if (t < H2) {
    b2s[t] = b2[t];
    w3s[t] = w3[t];
  }
  __syncthreads();

  const int ti = t / TJ, tj = t % TJ, i = i0 + ti, j = j0 + tj;
  const bool drop = use_drop != 0;
  const uint32_t seed = (uint32_t)seed_ptr[0];
  float acc[H2];
  cell_layer1<BF16>(pds + ti * H1, pvs + tj * LD1, b1s, w2s,
                    cell_key(seed, 1u, i, j), drop, thresh, scale, acc, nullptr);
  const uint32_t key2 = cell_key(seed, 2u, i, j);
  float s = 0.f;
#pragma unroll
  for (int n = 0; n < H2; ++n) {
    float h2 = fmaxf(acc[n] + b2s[n], 0.f);
    if (drop) h2 = h2 * (fmix32(key2 ^ (uint32_t)n) >= thresh ? scale : 0.f);
    s += h2 * w3s[n];
  }
  if (i < nd && j < nv) out[(size_t)i * nv + j] = s;
}

template <bool BF16>
__global__ void __launch_bounds__(NT) grid_bwd_kernel(
    const float* __restrict__ pd, const float* __restrict__ pv,
    const float* __restrict__ b1, const float* __restrict__ w2,
    const float* __restrict__ b2, const float* __restrict__ w3,
    const int* __restrict__ seed_ptr, const float* __restrict__ g,
    float* __restrict__ dpd_part,   // (n_jt, n_it * TI, H1)
    float* __restrict__ dpv_part,   // (n_split, n_jt * TJ, H1)
    float* __restrict__ db1_part,   // (n_blocks, H1)
    float* __restrict__ dw2_part,   // (n_blocks, H1, H2)
    float* __restrict__ db2_part,   // (n_blocks, H2)
    float* __restrict__ dw3_part,   // (n_blocks, H2)
    int nd, int nv, uint32_t thresh, float scale, int use_drop) {
  extern __shared__ float4 smem4[];
  float* w2s = reinterpret_cast<float*>(smem4);
  float* pvs = w2s + H1 * H2;
  float* pds = pvs + TJ * LD1;
  float* b1s = pds + TI * H1;
  float* b2s = b1s + H1;
  float* w3s = b2s + H2;
  float* gs = w3s + H2;
  float* hbuf = gs + NT;
  float* da2s = hbuf + NT * LD1;
  float* red = da2s + NT * LD2;           // [2][NT/32][H2]: db2, then dw3
  float* dw2acc = red + 2 * (NT / 32) * H2;
  float* dpvacc = dw2acc + H1 * LD2;

  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const int jt = blockIdx.x, n_jt = gridDim.x;
  const int split = blockIdx.y, n_split = gridDim.y;
  const int n_it = (nd + TI - 1) / TI;
  const int nd_pad = n_it * TI, nv_pad = n_jt * TJ;
  const int j0 = jt * TJ;
  const bool drop = use_drop != 0;
  const uint32_t seed = (uint32_t)seed_ptr[0];

  for (int e = t; e < H1 * H2; e += NT) w2s[e] = rnd<BF16>(w2[e]);
  for (int e = t; e < TJ * H1; e += NT) {
    const int r = e / H1, k = e % H1, j = j0 + r;
    pvs[r * LD1 + k] = j < nv ? pv[(size_t)j * H1 + k] : 0.f;
    dpvacc[e] = 0.f;
  }
  for (int e = t; e < H1 * LD2; e += NT) dw2acc[e] = 0.f;
  b1s[t] = b1[t];
  if (t < H2) {
    b2s[t] = b2[t];
    w3s[t] = w3[t];
  }
  float db1acc = 0.f, db2acc = 0.f, dw3acc = 0.f;

  const int ti = t / TJ, tj = t % TJ, j = j0 + tj;
  for (int it = split; it < n_it; it += n_split) {
    const int i0 = it * TI, i = i0 + ti;
    __syncthreads();   // the previous tile is done with pds, gs and hbuf
    for (int e = t; e < TI * H1; e += NT) {
      const int r = e / H1, k = e % H1;
      pds[r * H1 + k] = i0 + r < nd ? pd[(size_t)(i0 + r) * H1 + k] : 0.f;
    }
    gs[t] = (i < nd && j < nv) ? g[(size_t)i * nv + j] : 0.f;
    __syncthreads();

    // Per cell: recompute the forward, then da2 = (a2 > 0) * g * w3 * m2.
    {
      float acc[H2];
      const uint32_t key1 = cell_key(seed, 1u, i, j);
      cell_layer1<BF16>(pds + ti * H1, pvs + tj * LD1, b1s, w2s, key1, drop,
                        thresh, scale, acc, hbuf + t * LD1);
      const uint32_t key2 = cell_key(seed, 2u, i, j);
      const float gc = gs[t], gr = rnd<BF16>(gc);
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
          red[(NT / 32 + warp) * H2 + n] = sdw3;
        }
        acc[n] = rnd<BF16>(da2);
      }
      float4* drow = reinterpret_cast<float4*>(da2s + t * LD2);
#pragma unroll
      for (int q = 0; q < H2 / 4; ++q)
        drow[q] = make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]);
    }
    __syncthreads();

    // Thread k: row k of dW2 += sum over cells of rnd(h1d)[k] * rnd(da2).
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
      for (int c = 0; c < NT; ++c) {
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
        for (int w = 0; w < NT / 32; ++w) {
          db2acc += red[w * H2 + t];
          dw3acc += red[(NT / 32 + w) * H2 + t];
        }
      }
    }
    __syncthreads();   // hbuf is read above and overwritten with da1 below

    // Per cell: dh1 = rnd(da2) @ rnd(w2)^T, da1 = (a1 > 0) * dh1 * m1.
    {
      float d[H2];
      const float4* drow = reinterpret_cast<const float4*>(da2s + t * LD2);
#pragma unroll
      for (int q = 0; q < H2 / 4; ++q) {
        const float4 v = drow[q];
        d[4 * q] = v.x; d[4 * q + 1] = v.y; d[4 * q + 2] = v.z; d[4 * q + 3] = v.w;
      }
      const uint32_t key1 = cell_key(seed, 1u, i, j);
      const float* pd_row = pds + ti * H1;
      const float* pv_row = pvs + tj * LD1;
#pragma unroll 1
      for (int k = 0; k < H1; k += 4) {
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
          const float a1 = (pd_row[k + u] + pv_row[k + u]) + b1s[k + u];
          out4[u] = a1 > 0.f ? s : 0.f;
        }
        *reinterpret_cast<float4*>(hbuf + t * LD1 + k) =
            make_float4(out4[0], out4[1], out4[2], out4[3]);
      }
    }
    __syncthreads();

    // Thread k: dPd rows of this tile, dPv and db1 accumulators.
    {
      const int k = t;
#pragma unroll
      for (int r = 0; r < TI; ++r) {
        float s = 0.f;
#pragma unroll 4
        for (int c = 0; c < TJ; ++c) {
          const float v = hbuf[(r * TJ + c) * LD1 + k];
          s += v;
          dpvacc[c * H1 + k] += v;
        }
        dpd_part[((size_t)jt * nd_pad + i0 + r) * H1 + k] = s;
        db1acc += s;
      }
    }
  }
  __syncthreads();

  const int blk = split * n_jt + jt;
  for (int e = t; e < TJ * H1; e += NT) {
    const int r = e / H1, k = e % H1;
    dpv_part[((size_t)split * nv_pad + j0 + r) * H1 + k] = dpvacc[e];
  }
  for (int e = t; e < H1 * H2; e += NT)
    dw2_part[(size_t)blk * H1 * H2 + e] = dw2acc[(e / H2) * LD2 + e % H2];
  db1_part[(size_t)blk * H1 + t] = db1acc;
  if (t < H2) {
    db2_part[(size_t)blk * H2 + t] = db2acc;
    dw3_part[(size_t)blk * H2 + t] = dw3acc;
  }
}

template <typename K>
cudaError_t prepare(K kernel, int smem_floats) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem_floats * (int)sizeof(float));
}

// Backward blocks aimed at: one per SM of an H100.  The split depends on the
// shapes only, so the order of the partial sums, and with it the result, is
// the same on every run and every card.
constexpr int BWD_BLOCKS = 132;

int bwd_split(int n_it, int n_jt) {
  const int s = BWD_BLOCKS / n_jt;
  return s < 1 ? 1 : (s < n_it ? s : n_it);
}

}  // namespace

extern "C" {

// Layout of the backward's partial slabs for an nd x nv grid, which the
// caller allocates and sums:
//   dpd_part (n_jt, nd_pad, H1), dpv_part (n_split, nv_pad, H1),
//   db1/dw2/db2/dw3 parts (n_split * n_jt, ...).
// layout[] receives {n_jt, n_split, nd_pad, nv_pad}.
void grid_decoder_bwd_layout(int nd, int nv, int* layout) {
  const int n_it = (nd + TI - 1) / TI, n_jt = (nv + TJ - 1) / TJ;
  layout[0] = n_jt;
  layout[1] = bwd_split(n_it, n_jt);
  layout[2] = n_it * TI;
  layout[3] = n_jt * TJ;
}

int grid_decoder_fwd(const float* pd, const float* pv, const float* b1,
                     const float* w2, const float* b2, const float* w3,
                     const int* seed, float* out, int nd, int nv,
                     unsigned int thresh, float scale, int use_drop, int bf16,
                     void* stream) {
  const dim3 grid((nv + TJ - 1) / TJ, (nd + TI - 1) / TI);
  const size_t smem = FWD_SMEM * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bf16) {
    err = prepare(grid_fwd_kernel<true>, FWD_SMEM);
    if (err != cudaSuccess) return (int)err;
    grid_fwd_kernel<true><<<grid, NT, smem, s>>>(pd, pv, b1, w2, b2, w3, seed, out,
                                                 nd, nv, thresh, scale, use_drop);
  } else {
    err = prepare(grid_fwd_kernel<false>, FWD_SMEM);
    if (err != cudaSuccess) return (int)err;
    grid_fwd_kernel<false><<<grid, NT, smem, s>>>(pd, pv, b1, w2, b2, w3, seed, out,
                                                  nd, nv, thresh, scale, use_drop);
  }
  return (int)cudaGetLastError();
}

int grid_decoder_bwd(const float* pd, const float* pv, const float* b1,
                     const float* w2, const float* b2, const float* w3,
                     const int* seed, const float* g, float* dpd_part,
                     float* dpv_part, float* db1_part, float* dw2_part,
                     float* db2_part, float* dw3_part, int nd, int nv,
                     unsigned int thresh, float scale, int use_drop, int bf16,
                     void* stream) {
  const int n_jt = (nv + TJ - 1) / TJ;
  const dim3 grid(n_jt, bwd_split((nd + TI - 1) / TI, n_jt));
  const size_t smem = BWD_SMEM * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bf16) {
    err = prepare(grid_bwd_kernel<true>, BWD_SMEM);
    if (err != cudaSuccess) return (int)err;
    grid_bwd_kernel<true><<<grid, NT, smem, s>>>(
        pd, pv, b1, w2, b2, w3, seed, g, dpd_part, dpv_part, db1_part, dw2_part,
        db2_part, dw3_part, nd, nv, thresh, scale, use_drop);
  } else {
    err = prepare(grid_bwd_kernel<false>, BWD_SMEM);
    if (err != cudaSuccess) return (int)err;
    grid_bwd_kernel<false><<<grid, NT, smem, s>>>(
        pd, pv, b1, w2, b2, w3, seed, g, dpd_part, dpv_part, db1_part, dw2_part,
        db2_part, dw3_part, nd, nv, thresh, scale, use_drop);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"

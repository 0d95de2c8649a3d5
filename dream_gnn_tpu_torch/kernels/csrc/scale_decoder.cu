// The scale path's fused per-slot decoder MLP for Hopper (sm_90a): the
// forward (K2) and one backward kernel launched twice (B1 and the mirror).
//
// Replaces the Pallas TPU kernels of dream_gnn_tpu/kernels/pallas_scale_decoder.py:
// - _k2_kernel: for every candidate slot e of the forward stream (the
//   candidates sorted by drug), with i = drug[e], j = dis[e]:
//       a1  = (rnd(Pd[i]) + rnd(Pv[j])) + b1
//       h1d = relu(a1) * m1;  a2 = rnd(h1d) @ rnd(w2) + b2
//       h2d = relu(a2) * m2;  out[e] = rnd(h2d) . rnd(w3)   (b3: the caller)
//   and, in training, spills a1 (bf16 in bf16 mode, else f32);
// - _b1_kernel: from the saved a1, in forward-slot order, the backward chain
//   to da1 plus the weight gradients dW2, db2, dw3 and db1;
// - _mirror_kernel: the same chain for the mirror stream (the candidates
//   sorted by disease), with a1 recomputed from the table rows and no weight
//   gradients.
// The table gradients are segmented sums of the da1 rows (spmm.cu).
//
// Rounding points, as the Pallas kernels (rnd rounds to bf16 in bf16 mode and
// is the identity in fp32 mode): the table rows round before their sum
// (:490-492); K2's logits use the unrounded a1 (:492-505); B1 recomputes from
// the saved, rounded a1 while the mirror recomputes the unrounded one
// (:608, :711); h1d, w2, da2 and h2d round before each product (_mlp_fwd
// :397, _mlp_bwd :416); dw3 = sum h2d * g, db2 = sum da2 and db1 = sum da1
// add unrounded values in f32 (:446-452); da1 rounds when it is stored
// (:619-621, :722-724).
//
// Dropout is the murmur PRF of _prf_masks (:375-394): with base =
// eid * 0x9E3779B9 ^ seed, unit u keeps iff fmix32(base ^ u * 0x7FEB352D) >=
// thresh; units 0 .. H1-1 give m1, H1 .. H1+H2-1 give m2.  eid is the
// candidate's index in the caller's list, so K2, B1 and the mirror draw the
// same masks in their different slot orders.
//
// What bounds it on an H100: about 16.8 kFLOP per slot forward and 50.2 kFLOP
// backward against about 1 KB of rows, so operations.  This first version
// runs the products on the CUDA cores in f32, as the per-edge kernels
// (edge_decoder.cu) do, and leaves the tensor cores unused.
//
// Design (simple first), the per-edge kernels' with another hash and other
// rounding points:
// - K2: one thread per slot, 128 slots a block; w2, b1, b2, w3 in shared
//   memory; each thread gathers its two table rows from global memory.
// - backward: a block walks a fixed, strided subset of the 128-slot tiles;
//   per tile it recomputes the forward, forms da2 and da1, writes each slot's
//   rounded da1 row, and (B1) sums dW2 in shared memory and db1, db2, dw3 in
//   registers; each block writes its own partial slabs, which the caller sums
//   in a fixed order.  No float atomics, so two runs give the same bits.
//
// Every entry point returns cudaGetLastError() after its launches.

#include <cassert>
#include <type_traits>

#include "decoder_common.cuh"

namespace {

constexpr int TS = 128;          // slots per tile, one thread per slot
static_assert(TS == H1, "the backward's reductions map one thread to one H1 unit");

constexpr int FWD_SMEM = H1 * H2 + H1 + 2 * H2;
// Shared memory of the backward, in floats; the mirror needs neither the
// per-warp sums nor the dW2 accumulator.
constexpr int BWD_SMEM_BASE = H1 * H2 + H1 + 2 * H2 + TS * LD1 + TS * LD2;
constexpr int BWD_SMEM_GRADS = BWD_SMEM_BASE + 2 * (TS / 32) * H2 + H1 * LD2;

template <bool BF16>
using store_t = typename std::conditional<BF16, __nv_bfloat16, float>::type;

// The PRF of _prf_masks: the hash bits of unit u of the slot with base b.
__device__ __forceinline__ uint32_t slot_base(uint32_t eid, uint32_t seed) {
  return eid * 0x9E3779B9u ^ seed;
}
__device__ __forceinline__ uint32_t slot_bits(uint32_t base, uint32_t u) {
  return fmix32(base ^ u * 0x7FEB352Du);
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<uint32_t*>(&lo);
  raw.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <bool BF16, bool SAVE_A1>
__global__ void __launch_bounds__(TS) scale_fwd_kernel(
    const float* __restrict__ pd, const float* __restrict__ pv,
    const int* __restrict__ drug, const int* __restrict__ dis,
    const int* __restrict__ eid, const float* __restrict__ b1,
    const float* __restrict__ w2, const float* __restrict__ b2,
    const float* __restrict__ w3, const int* __restrict__ seed_ptr,
    float* __restrict__ out, store_t<BF16>* __restrict__ a1_out, int nd,
    int nv, int ne, uint32_t thresh, float scale, int use_drop) {
  extern __shared__ float4 smem4[];
  float* w2s = reinterpret_cast<float*>(smem4);
  float* b1s = w2s + H1 * H2;
  float* b2s = b1s + H1;
  float* w3s = b2s + H2;

  const int t = threadIdx.x;
  for (int q = t; q < H1 * H2; q += TS) w2s[q] = rnd<BF16>(w2[q]);
  b1s[t] = b1[t];
  if (t < H2) {
    b2s[t] = b2[t];
    w3s[t] = rnd<BF16>(w3[t]);
  }
  __syncthreads();

  const int e = blockIdx.x * TS + t;
  if (e >= ne) return;               // no block-wide sync below
  const int i = drug[e], j = dis[e];
  assert(0 <= i && i < nd && 0 <= j && j < nv);   // a row outside the tables
  const float* pd_row = pd + (size_t)i * H1;
  const float* pv_row = pv + (size_t)j * H1;
  const bool drop = use_drop != 0;
  const uint32_t base = slot_base((uint32_t)eid[e], (uint32_t)seed_ptr[0]);
  float acc[H2];
  layer1<BF16>(
      [=](int k) {
        const float4 a = rows_a1<BF16, true>(pd_row, pv_row, b1s, k);
        if constexpr (SAVE_A1) store4(a1_out + (size_t)e * H1 + k, a);
        return a;
      },
      [=](uint32_t u) { return slot_bits(base, u); }, w2s, drop, thresh, scale,
      acc, nullptr);
  float s = 0.f;
#pragma unroll
  for (int n = 0; n < H2; ++n) {
    float h2 = fmaxf(acc[n] + b2s[n], 0.f);
    if (drop) h2 = h2 * (slot_bits(base, (uint32_t)(H1 + n)) >= thresh ? scale : 0.f);
    s += rnd<BF16>(h2) * w3s[n];
  }
  out[e] = s;
}

// FROM_SAVED_A1: B1 (a1 from the forward's spill, weight gradients when
// WEIGHT_GRADS); else the mirror (a1 from the table rows).
template <bool BF16, bool FROM_SAVED_A1, bool WEIGHT_GRADS>
__global__ void __launch_bounds__(TS) scale_bwd_kernel(
    const store_t<BF16>* __restrict__ a1_saved, const float* __restrict__ pd,
    const float* __restrict__ pv, const int* __restrict__ drug,
    const int* __restrict__ dis, const int* __restrict__ eid,
    const float* __restrict__ g, const float* __restrict__ b1,
    const float* __restrict__ w2, const float* __restrict__ b2,
    const float* __restrict__ w3, const int* __restrict__ seed_ptr,
    store_t<BF16>* __restrict__ da1_out,
    float* __restrict__ db1_part,   // (n_split, H1)
    float* __restrict__ dw2_part,   // (n_split, H1, H2)
    float* __restrict__ db2_part,   // (n_split, H2)
    float* __restrict__ dw3_part,   // (n_split, H2)
    int nd, int nv, int ne, uint32_t thresh, float scale, int use_drop) {
  extern __shared__ float4 smem4[];
  float* w2s = reinterpret_cast<float*>(smem4);
  float* b1s = w2s + H1 * H2;
  float* b2s = b1s + H1;
  float* w3s = b2s + H2;
  float* hbuf = w3s + H2;
  float* da2s = hbuf + TS * LD1;
  float* red = da2s + TS * LD2;            // [2][TS/32][H2]: db2, then dw3
  float* dw2acc = red + 2 * (TS / 32) * H2;

  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const int split = blockIdx.x, n_split = gridDim.x;
  const int n_tiles = (ne + TS - 1) / TS;
  const bool drop = use_drop != 0;
  const uint32_t seed = (uint32_t)seed_ptr[0];

  for (int q = t; q < H1 * H2; q += TS) w2s[q] = rnd<BF16>(w2[q]);
  if constexpr (WEIGHT_GRADS) {
    for (int q = t; q < H1 * LD2; q += TS) dw2acc[q] = 0.f;
  }
  if constexpr (!FROM_SAVED_A1) b1s[t] = b1[t];
  if (t < H2) {
    b2s[t] = b2[t];
    w3s[t] = w3[t];
  }
  float db1acc = 0.f, db2acc = 0.f, dw3acc = 0.f;

  for (int tile = split; tile < n_tiles; tile += n_split) {
    const int e0 = tile * TS, e = e0 + t;
    const bool valid = e < ne;
    // A padding thread runs slot 0 with g = 0: it adds nothing to any sum
    // and writes no da1 row.
    const int es = valid ? e : 0;
    const float gc = valid ? g[e] : 0.f;
    const uint32_t base = slot_base((uint32_t)eid[es], seed);
    const auto bits = [=](uint32_t u) { return slot_bits(base, u); };
    const store_t<BF16>* a1_row = nullptr;
    const float* pd_row = nullptr;
    const float* pv_row = nullptr;
    if constexpr (FROM_SAVED_A1) {
      a1_row = a1_saved + (size_t)es * H1;
    } else {
      const int i = drug[es], j = dis[es];
      assert(0 <= i && i < nd && 0 <= j && j < nv);
      pd_row = pd + (size_t)i * H1;
      pv_row = pv + (size_t)j * H1;
    }
    const auto a1_at = [=](int k) {
      if constexpr (FROM_SAVED_A1) {
        return load4(a1_row + k);
      } else {
        return rows_a1<BF16, true>(pd_row, pv_row, b1s, k);
      }
    };
    __syncthreads();   // the previous tile is done with hbuf and da2s

    // Per slot: recompute the forward, then da2 = (a2 > 0) * g * w3 * m2.
    {
      float acc[H2];
      layer1<BF16>(a1_at, bits, w2s, drop, thresh, scale, acc,
                   WEIGHT_GRADS ? hbuf + t * LD1 : nullptr);
#pragma unroll
      for (int n = 0; n < H2; ++n) {
        const float a2 = acc[n] + b2s[n];
        float h2d = fmaxf(a2, 0.f);
        float dh2 = w3s[n] * gc;
        if (drop) {
          const float m2 = bits((uint32_t)(H1 + n)) >= thresh ? scale : 0.f;
          h2d = h2d * m2;
          dh2 = dh2 * m2;
        }
        const float da2 = a2 > 0.f ? dh2 : 0.f;
        if constexpr (WEIGHT_GRADS) {
          const float sdw3 = warp_sum(h2d * gc);
          const float sdb2 = warp_sum(da2);
          if (lane == 0) {
            red[warp * H2 + n] = sdb2;
            red[(TS / 32 + warp) * H2 + n] = sdw3;
          }
        }
        acc[n] = rnd<BF16>(da2);
      }
      float4* drow = reinterpret_cast<float4*>(da2s + t * LD2);
#pragma unroll
      for (int q = 0; q < H2 / 4; ++q)
        drow[q] = make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]);
    }
    __syncthreads();

    // Thread k: row k of dW2 += sum over slots of rnd(h1d)[k] * rnd(da2).
    if constexpr (WEIGHT_GRADS) {
      const int k = t;
      float r[H2];
      float4* arow = reinterpret_cast<float4*>(dw2acc + k * LD2);
#pragma unroll
      for (int q = 0; q < H2 / 4; ++q) {
        const float4 v = arow[q];
        r[4 * q] = v.x; r[4 * q + 1] = v.y; r[4 * q + 2] = v.z; r[4 * q + 3] = v.w;
      }
#pragma unroll 1
      for (int c = 0; c < TS; ++c) {
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
        for (int w = 0; w < TS / 32; ++w) {
          db2acc += red[w * H2 + t];
          dw3acc += red[(TS / 32 + w) * H2 + t];
        }
      }
      __syncthreads();   // hbuf is read above and overwritten with da1 below
    }

    // Per slot: dh1 = rnd(da2) @ rnd(w2)^T, da1 = (a1 > 0) * dh1 * m1.
    {
      float d[H2];
      const float4* drow = reinterpret_cast<const float4*>(da2s + t * LD2);
#pragma unroll
      for (int q = 0; q < H2 / 4; ++q) {
        const float4 v = drow[q];
        d[4 * q] = v.x; d[4 * q + 1] = v.y; d[4 * q + 2] = v.z; d[4 * q + 3] = v.w;
      }
#pragma unroll 1
      for (int k = 0; k < H1; k += 4) {
        const float4 a = a1_at(k);
        const float a1v[4] = {a.x, a.y, a.z, a.w};
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
          if (drop) s = s * (bits((uint32_t)(k + u)) >= thresh ? scale : 0.f);
          out4[u] = a1v[u] > 0.f ? s : 0.f;
        }
        *reinterpret_cast<float4*>(hbuf + t * LD1 + k) =
            make_float4(out4[0], out4[1], out4[2], out4[3]);
      }
    }
    __syncthreads();

    // Thread k: db1 sums da1, and each slot's rounded da1 row goes out whole.
    {
      const int k = t;
      const int n_valid = min(TS, ne - e0);
#pragma unroll 4
      for (int c = 0; c < TS; ++c) {
        const float v = hbuf[c * LD1 + k];
        if constexpr (WEIGHT_GRADS) db1acc += v;
        if (c < n_valid) store1(da1_out + (size_t)(e0 + c) * H1 + k, v);
      }
    }
  }

  if constexpr (WEIGHT_GRADS) {
    __syncthreads();
    for (int q = t; q < H1 * H2; q += TS)
      dw2_part[(size_t)split * H1 * H2 + q] = dw2acc[(q / H2) * LD2 + q % H2];
    db1_part[(size_t)split * H1 + t] = db1acc;
    if (t < H2) {
      db2_part[(size_t)split * H2 + t] = db2acc;
      dw3_part[(size_t)split * H2 + t] = dw3acc;
    }
  }
}

template <bool BF16, bool FROM_SAVED_A1, bool WEIGHT_GRADS>
cudaError_t launch_bwd(const void* a1, const float* pd, const float* pv,
                       const int* drug, const int* dis, const int* eid,
                       const float* g, const float* b1, const float* w2,
                       const float* b2, const float* w3, const int* seed,
                       void* da1, float* db1_part, float* dw2_part,
                       float* db2_part, float* dw3_part, int nd, int nv, int ne,
                       uint32_t thresh, float scale, int use_drop, int n_split,
                       cudaStream_t s) {
  constexpr int smem = WEIGHT_GRADS ? BWD_SMEM_GRADS : BWD_SMEM_BASE;
  auto kernel = scale_bwd_kernel<BF16, FROM_SAVED_A1, WEIGHT_GRADS>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<n_split, TS, smem * sizeof(float), s>>>(
      static_cast<const store_t<BF16>*>(a1), pd, pv, drug, dis, eid, g, b1, w2,
      b2, w3, seed, static_cast<store_t<BF16>*>(da1), db1_part, dw2_part,
      db2_part, dw3_part, nd, nv, ne, thresh, scale, use_drop);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Blocks of the backward for ne slots: the partial slabs are (split, ...).
int scale_decoder_bwd_split(int ne) {
  return wave_split((ne + TS - 1) / TS, 1L);
}

// K2 over ne slots: pd (nd, H1), pv (nv, H1), drug / dis / eid (ne,) int32,
// b1 (H1,), w2 (H1, H2), b2 (H2,), w3 (H2,), seed (1,), out (ne,).  a1 (ne,
// H1), bf16 when bf16 else f32, is written when it is not null.
int scale_decoder_fwd(const float* pd, const float* pv, const int* drug,
                      const int* dis, const int* eid, const float* b1,
                      const float* w2, const float* b2, const float* w3,
                      const int* seed, float* out, void* a1, int nd, int nv,
                      int ne, unsigned int thresh, float scale, int use_drop,
                      int bf16, void* stream) {
  const dim3 grid((ne + TS - 1) / TS);
  const size_t smem = FWD_SMEM * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SCALE_FWD(B, S)                                                      \
  scale_fwd_kernel<B, S><<<grid, TS, smem, s>>>(                             \
      pd, pv, drug, dis, eid, b1, w2, b2, w3, seed, out,                     \
      static_cast<store_t<B>*>(a1), nd, nv, ne, thresh, scale, use_drop)
  if (bf16) {
    if (a1) SCALE_FWD(true, true); else SCALE_FWD(true, false);
  } else {
    if (a1) SCALE_FWD(false, true); else SCALE_FWD(false, false);
  }
#undef SCALE_FWD
  return (int)cudaGetLastError();
}

// The backward over ne slots.  mirror = 0 (B1): a1 (ne, H1) is the forward's
// spill, and the partial slabs db1 (split, H1), dw2 (split, H1, H2), db2 and
// dw3 (split, H2) are written; pd, pv, drug, dis and b1 are not read.
// mirror = 1: a1 is recomputed from pd, pv, drug, dis and b1; the slabs and
// a1 are not touched.  g (ne,) is the cotangent in this launch's slot order;
// da1 (ne, H1) bf16 when bf16 else f32.
int scale_decoder_bwd(const void* a1, const float* pd, const float* pv,
                      const int* drug, const int* dis, const int* eid,
                      const float* g, const float* b1, const float* w2,
                      const float* b2, const float* w3, const int* seed,
                      void* da1, float* db1_part, float* dw2_part,
                      float* db2_part, float* dw3_part, int nd, int nv, int ne,
                      unsigned int thresh, float scale, int use_drop, int bf16,
                      int mirror, void* stream) {
  const int n_split = scale_decoder_bwd_split(ne);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SCALE_BWD(B, SAVED, GRADS)                                           \
  launch_bwd<B, SAVED, GRADS>(a1, pd, pv, drug, dis, eid, g, b1, w2, b2, w3, \
                              seed, da1, db1_part, dw2_part, db2_part,       \
                              dw3_part, nd, nv, ne, thresh, scale, use_drop, \
                              n_split, s)
  cudaError_t err;
  if (bf16) {
    err = mirror ? SCALE_BWD(true, false, false) : SCALE_BWD(true, true, true);
  } else {
    err = mirror ? SCALE_BWD(false, false, false) : SCALE_BWD(false, true, true);
  }
#undef SCALE_BWD
  return (int)err;
}

}  // extern "C"

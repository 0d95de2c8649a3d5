// Device code shared by the decoder kernels (grid_decoder.cu, edge_decoder.cu,
// scale_decoder.cu): the dropout hash, bf16 rounding, a warp sum, the first
// layer of the per-cell MLP, the block-count rules, the tensor-core helpers
// of the three bf16 backwards (grid_bwd_mma_kernel, edge_bwd_mma_kernel,
// scale_bwd_mma_kernel): ldmatrix, mma.sync, fixed shuffle trees, and the
// unit-order a2 and dh1 where a2 sits near a step or da1 near a bf16
// midpoint; and the tensor-core tile of the two bf16 forwards
// (grid_fwd_mma_kernel, edge_fwd_mma_kernel): fwd_mma_rows.
//
// The grid and per-edge kernels' dropout bits are fmix32(cell_key(seed,
// layer, i, j) ^ k) for drug i, disease j and unit k;
// dream_gnn_tpu_torch/kernels/grid_decoder.py defines the same hash for the
// plain PyTorch versions, bit for bit.  The scale kernels draw theirs from
// another hash (scale_decoder.cu), through the same layer1.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int H1 = 128;          // decoder hidden1
constexpr int H2 = 64;           // decoder hidden2
constexpr int LD1 = H1 + 4;      // padded row stride of H1-wide tiles (16-byte aligned)
constexpr int LD2 = H2 + 4;      // padded row stride of H2-wide tiles

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

// a1[k .. k+3] = (rnd(pd_row) + rnd(pv_row)) + b1 when ROUND_ROWS, else
// without the rounding: the per-edge and scale kernels round the table rows
// before their sum, the grid kernels do not.  The rows may lie in shared or
// in global memory.
template <bool BF16, bool ROUND_ROWS>
__device__ __forceinline__ float4 rows_a1(const float* pd_row, const float* pv_row,
                                          const float* b1s, int k) {
  float4 a = *reinterpret_cast<const float4*>(pd_row + k);
  float4 b = *reinterpret_cast<const float4*>(pv_row + k);
  if constexpr (ROUND_ROWS) {
    a = make_float4(rnd<BF16>(a.x), rnd<BF16>(a.y), rnd<BF16>(a.z), rnd<BF16>(a.w));
    b = make_float4(rnd<BF16>(b.x), rnd<BF16>(b.y), rnd<BF16>(b.z), rnd<BF16>(b.w));
  }
  const float4 c = *reinterpret_cast<const float4*>(b1s + k);
  return make_float4((a.x + b.x) + c.x, (a.y + b.y) + c.y, (a.z + b.z) + c.z,
                     (a.w + b.w) + c.w);
}

// Layer 1 and the a2 product of one cell, edge or slot.  a1_at(k) returns
// a1[k .. k+3]; bits(k) the dropout hash bits of unit k.  acc[n] receives
// rnd(h1d) @ rnd(w2) without b2.  When hrow is given, rnd(h1d) is stored
// there.
template <bool BF16, class A1, class Bits>
__device__ __forceinline__ void layer1(A1 a1_at, Bits bits, const float* w2s,
                                       bool drop, uint32_t thresh, float scale,
                                       float (&acc)[H2], float* hrow) {
#pragma unroll
  for (int n = 0; n < H2; ++n) acc[n] = 0.f;
#pragma unroll 1
  for (int k = 0; k < H1; k += 4) {
    const float4 a = a1_at(k);
    float h[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float x = fmaxf(h[u], 0.f);
      if (drop) x = x * (bits((uint32_t)(k + u)) >= thresh ? scale : 0.f);
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

// layer1 of one grid cell or edge in fp32 (the CUDA-core kernels): a1 from
// the two table rows, the grid hash keyed by cell_key (key1).
__device__ __forceinline__ void cell_layer1(
    const float* pd_row, const float* pv_row, const float* b1s,
    const float* w2s, uint32_t key1, bool drop, uint32_t thresh, float scale,
    float (&acc)[H2], float* hrow) {
  layer1<false>([=](int k) { return rows_a1<false, false>(pd_row, pv_row, b1s, k); },
                [=](uint32_t k) { return fmix32(key1 ^ k); }, w2s, drop, thresh,
                scale, acc, hrow);
}

template <typename K>
cudaError_t prepare(K kernel, int smem_floats) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem_floats * (int)sizeof(float));
}

// A backward wave: one block per SM of an H100 (a backward block holds over
// 170 KB of shared memory).  A backward splits each fold's work into
// `split` blocks; the split aims at whole waves of `slots` blocks: it is
// the smallest split (at most max_split) whose per_split * split blocks
// fill their last wave to at least 15/16 of the waves they take, else the
// split that fills them best.  It depends on the shapes only, so the order
// of the partial sums, and with it the result, is the same on every run
// and every card.
constexpr int BWD_BLOCKS = 132;
// A bf16 forward wave: two blocks an SM (at most 128 registers a thread and
// under 48 KB of shared memory a block).  The forward writes no partial
// sums, so its split moves its time only, never its result.
constexpr int FWD_RESIDENT = 2;
constexpr int FWD_BLOCKS = FWD_RESIDENT * BWD_BLOCKS;

int wave_split(int max_split, long per_split, int slots = BWD_BLOCKS) {
  int best = 1;
  double best_fill = 0.0;
  for (int s = 1; s <= max_split; ++s) {
    const long blocks = per_split * s;
    const long waves = (blocks + slots - 1) / slots;
    const double fill = (double)blocks / (double)(waves * slots);
    if (fill >= 15.0 / 16.0) return s;
    if (fill > best_fill) {
      best = s;
      best_fill = fill;
    }
  }
  return best;
}

// ---------------------------------------------------------------------------
// The bf16 backwards on the tensor cores (grid_bwd_mma_kernel,
// edge_bwd_mma_kernel, scale_bwd_mma_kernel): a block of 8 warps; bf16
// rows padded by 16 bytes (w2 and da2 tiles 144 B, h1d tiles 272 B), so
// that the 8 rows of an ldmatrix and the lanes of a fragment store fall in
// distinct banks.

constexpr int MW = 8;            // warps of a bf16 backward block
constexpr int MT = MW * 32;      // its threads
constexpr int LDW = H2 + 8;      // bf16 row stride of w2s and da2s
constexpr int LDH = H1 + 8;      // bf16 row stride of h1s
constexpr int FIX_LD = 33;       // f32 stride of a thread's 32 sums taken again

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Four 8 x 8 bf16 matrices; lane l gives the address of row l % 8 of
// matrix l / 8.  ldsm_t loads them transposed.
__device__ __forceinline__ void ldsm(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// d += a @ b on one 16 x 8 tile: a a 16 x 16 bf16 A fragment, (b0, b1) a
// 16 x 8 bf16 B fragment, d the f32 accumulator.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two values rounded to bf16 and packed, lo in the low half, as a fragment
// holds two neighbouring columns.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// One step of row_sum: lanes M apart swap halves of v[0 .. LEN) and add.
template <int M, int LEN, int N>
__device__ __forceinline__ void row_sum_step(float (&v)[N], int lane) {
  const bool upper = (lane & M) != 0;
#pragma unroll
  for (int p = 0; p < LEN / 2; ++p) {
    const float send = upper ? v[p] : v[p + LEN / 2];
    const float keep = upper ? v[p + LEN / 2] : v[p];
    v[p] = keep + __shfl_xor_sync(0xffffffffu, send, M);
  }
}

// Sums v over the 8 lanes that share lane % 4 (the rows of an mma
// fragment) in a fixed tree: halve, swap with the lane 16, 8, then 4
// apart.  On return v[0 .. N/8) holds the sums of entries (N/8) * (lane /
// 4) + [0, N/8) of the input.
template <int N>
__device__ __forceinline__ void row_sum(float (&v)[N], int lane) {
  row_sum_step<16, N>(v, lane);
  row_sum_step<8, N / 2>(v, lane);
  row_sum_step<4, N / 4>(v, lane);
}

// a2 near a step of what the backward makes of it: the relu and the a2 > 0
// gate at 0 (within band, 2^-20 of the bound sum(h1d) * max |w2| on the
// terms' size), or a bf16 rounding midpoint of h2d = a2 * m2 (within
// MID_ULPS f32 ulps).  There the order of the f32 sums decides the result,
// and the kernel takes the sequential one: seq_a2.  A difference that
// escapes the window comes from cancellation, where |a2| is small against
// its terms, and so does h2d and what a flip of its rounding moves in dw3.
constexpr int MID_ULPS = 64;

__device__ __forceinline__ bool near_step(float a2, float m2, float band) {
  if (fabsf(a2) <= band) return true;
  if (a2 < 0.f) return false;
  const int lo = (int)(__float_as_uint(a2 * m2) & 0xFFFFu);
  return abs(lo - 0x8000) <= MID_ULPS;
}

// rnd(h1d) . rnd(w2)[:, n] summed as the f32 CUDA-core kernels sum it: one
// fused multiply-add per unit, in unit order.  On the card this gives the
// plain version's a2 (a bf16 x bf16 product is exact, and the f32 matmul
// adds in unit order) in every case the tests and chip_smoke.py hold.
__device__ __forceinline__ float seq_a2(const __nv_bfloat16* hrow,
                                        const __nv_bfloat16* wcol) {
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(hrow);
  float s = 0.f;
#pragma unroll 8
  for (int k = 0; k < H1; k += 2) {
    const float2 h = __bfloat1622float2(h2[k / 2]);
    s = fmaf(h.x, __bfloat162float(wcol[k * LDW]), s);
    s = fmaf(h.y, __bfloat162float(wcol[(k + 1) * LDW]), s);
  }
  return s;
}

// x within band of a bf16 rounding midpoint (the one above |x|'s bf16
// truncation; the one below lies half a bf16 ulp away, so it is within band
// only when that one is too).  There a difference of up to band in x, as
// between two orders of an f32 sum, can flip rnd(x).
__device__ __forceinline__ bool near_mid(float x, float band) {
  const float mid = __uint_as_float((__float_as_uint(x) & 0xFFFF0000u) | 0x8000u);
  return fabsf(x - mid) <= band;
}

// rnd(da2) . rnd(w2)[k, :], one fused multiply-add per unit in unit order,
// as the f32 CUDA-core kernel and the plain version's f32 matmul sum dh1.
__device__ __forceinline__ float seq_dh1(const __nv_bfloat16* drow,
                                         const __nv_bfloat16* wrow) {
  const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(drow);
  const __nv_bfloat162* w2 = reinterpret_cast<const __nv_bfloat162*>(wrow);
  float s = 0.f;
#pragma unroll 8
  for (int n = 0; n < H2; n += 2) {
    const float2 d = __bfloat1622float2(d2[n / 2]);
    const float2 w = __bfloat1622float2(w2[n / 2]);
    s = fmaf(d.x, w.x, s);
    s = fmaf(d.y, w.y, s);
  }
  return s;
}

// ---------------------------------------------------------------------------
// The bf16 forwards on the tensor cores (grid_fwd_mma_kernel,
// edge_fwd_mma_kernel): a block of MW = 8 warps, each owning 16 rows (cells
// or edges) of a 128-row tile.  In the fragment layout of mma m16n8k16
// (lane = 4 gq + q) a thread holds rows c0 = gq and c1 = gq + 8 of its
// warp's 16 and, of each 128-unit row, the units 16 ks + 8 h + 2 q + e
// (k-step ks < 8; h, e < 2); of the a2 accumulator, the same rows at the
// columns 8 nt + 2 q + e of n-tile nt < 8.
//
// Unlike the backwards, a forward needs no unit-order recompute: it rounds
// neither a2 nor h2d = relu(a2 + b2) * m2, and the logit is continuous in
// a2, so the order of a2's f32 sum moves it by f32 noise only
// (tests/test_torch_port_fwd_sum_order.py).  So a2 accumulates across the
// k-steps in the mma itself.

// a1 of units k, k + 1 of rows c0 and c1 from their table values there:
// {c0: k, k + 1; c1: k, k + 1} = (rnd(pd) + rnd(pv)) + b1 when ROUND_ROWS
// (the per-edge kernel), else without the rounding (the grid kernel).
template <bool ROUND_ROWS>
__device__ __forceinline__ float4 pair_a1(float2 pd0, float2 pv0, float2 pd1,
                                          float2 pv1, float2 b) {
  if constexpr (ROUND_ROWS) {
    pd0 = make_float2(rnd<true>(pd0.x), rnd<true>(pd0.y));
    pv0 = make_float2(rnd<true>(pv0.x), rnd<true>(pv0.y));
    pd1 = make_float2(rnd<true>(pd1.x), rnd<true>(pd1.y));
    pv1 = make_float2(rnd<true>(pv1.x), rnd<true>(pv1.y));
  }
  return make_float4((pd0.x + pv0.x) + b.x, (pd0.y + pv0.y) + b.y,
                     (pd1.x + pv1.x) + b.x, (pd1.y + pv1.y) + b.y);
}

// The logits of rows c0 and c1, s = sum_n m2[n] * relu(a2[n] + b2[n]) *
// w3[n] with a2 = rnd(h1d) @ rnd(w2), each the same in the four lanes of a
// quad.  a1_at(ks, x) gives x[h] = a1 of units 16 ks + 8 h + 2 q (+ 1) of
// rows c0 and c1 (pair_a1); it is called once per k-step, in order.  key1
// and key2 are the rows' cell keys of layers 1 and 2; w2s holds rnd(w2) in
// bf16 at row stride LDW.  rnd(h1d) is built straight into the A
// fragments.  A thread sums its 16 columns of a row in column order, then
// the quad's four partials meet in a fixed tree (lanes 1, then 2 apart):
// a row's logit does not depend on where the row sits in the tile.
template <class A1>
__device__ __forceinline__ float2 fwd_mma_rows(
    A1 a1_at, const __nv_bfloat16* w2s, const float* b2s, const float* w3s,
    const uint32_t (&key1)[2], const uint32_t (&key2)[2], bool drop,
    uint32_t thresh, float scale, int lane) {
  const int q = lane & 3, mi = lane >> 3, mr = lane & 7;
  float acc[H2 / 8][4];
#pragma unroll
  for (int nt = 0; nt < H2 / 8; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[nt][c] = 0.f;
#pragma unroll 1
  for (int ks = 0; ks < H1 / 16; ++ks) {
    float4 x[2];
    a1_at(ks, x);
    uint32_t a[4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t k = (uint32_t)(16 * ks + 8 * h + 2 * q);
      float v[4] = {x[h].x, x[h].y, x[h].z, x[h].w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        v[u] = fmaxf(v[u], 0.f);
        if (drop)
          v[u] = v[u] * (fmix32(key1[u >> 1] ^ (k + (uint32_t)(u & 1))) >= thresh ? scale
                                                                                  : 0.f);
      }
      a[2 * h] = pack_bf16(v[0], v[1]);
      a[2 * h + 1] = pack_bf16(v[2], v[3]);
    }
#pragma unroll
    for (int np = 0; np < H2 / 16; ++np) {
      uint32_t b[4];
      ldsm_t(b, smem_addr(w2s + (16 * ks + (mi & 1) * 8 + mr) * LDW + 16 * np +
                          (mi >> 1) * 8));
      mma_bf16(acc[2 * np], a, b[0], b[1]);
      mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
  // acc[nt][c]: row c >> 1 (c0, c1), column 8 nt + 2 q + (c & 1).
  float s[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < H2 / 8; ++nt) {
    const int n = 8 * nt + 2 * q;
    const float2 bn = *reinterpret_cast<const float2*>(b2s + n);
    const float2 wn = *reinterpret_cast<const float2*>(w3s + n);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int r = c >> 1, e = c & 1;
      float h2 = fmaxf(acc[nt][c] + (e ? bn.y : bn.x), 0.f);
      if (drop)
        h2 = h2 * (fmix32(key2[r] ^ (uint32_t)(n + e)) >= thresh ? scale : 0.f);
      s[r] += h2 * (e ? wn.y : wn.x);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    s[r] += __shfl_xor_sync(0xffffffffu, s[r], 1);
    s[r] += __shfl_xor_sync(0xffffffffu, s[r], 2);
  }
  return make_float2(s[0], s[1]);
}

}  // namespace

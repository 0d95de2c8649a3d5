// The scale path's fused per-slot decoder MLP for Hopper (sm_90a): the
// forward (K2) and the backward, one kernel per dtype launched twice (B1 and
// the mirror).
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
// backward against about 1 KB of rows read and (K2's spill, B1's and the
// mirror's da1) 256 bytes written, so bytes at the tensor cores' peak.
//
// Design, the per-edge kernels' (edge_decoder.cu) with another hash and
// other rounding points:
// - K2:
//   - bf16 (scale_fwd_mma_kernel): the a2 product on the tensor cores as
//     mma.sync m16n8k16 bf16 x bf16 -> f32, laid out as the grid and
//     per-edge forwards' tile (fwd_mma_rows, decoder_common.cuh) but
//     written out here, as its hash, spill, rounding and sum order differ:
//     8 warps of 16 slots, 128 slots a tile; rnd(h1d) built in the A
//     fragments from the rounded table rows, each unit hashed once; w2
//     staged once a block in bf16; blocks walk a strided set of tiles, as
//     many blocks as the card holds resident (two an SM); each thread reads
//     its two slots' table rows one k-step ahead of the mma (the forward
//     slots are drug-sorted, so neighbouring slots share Pd rows through
//     L2).  In training it
//     spills a1 from the same registers, before the relu, as 4-byte stores
//     (a quad writes 32 contiguous bytes of a row a k-step).  Unlike those
//     forwards, K2 rounds h2d before the logit's dot (_mlp_fwd :408-411),
//     so an a2 whose h2d sits near a bf16 midpoint would move the logit by
//     one bf16 step of h2d times |w3| if the tensor cores' sum order put it
//     on the other side (tests/test_torch_port_k2_sum_order.py).  So each
//     k-step's product starts from 0 and is added in f32, as in the
//     backwards, and an a2 whose h2d lies within the window of a midpoint
//     (near_h2d_mid) is summed again in unit order (seq_a2) from the warp's
//     rnd(h1d) rows in shared memory.  relu and rnd are continuous at 0,
//     so the gate needs no test.  A thread sums its 16 columns in column
//     order and the quad's partials meet in a fixed shuffle tree: a slot's
//     logit depends only on its inputs.
//   - fp32 (scale_fwd_kernel): the tensor cores would take fp32 operands
//     only as TF32, which rounds where the fp32 Pallas kernel does not, so
//     the products stay on the CUDA cores: one thread per slot, 128 slots a
//     block; w2, b1, b2, w3 in shared memory; each thread gathers its two
//     table rows from global memory.
// - backward: a block walks a fixed, strided subset of the 128-slot tiles;
//   per tile it recomputes the forward, forms da2 and da1, writes each
//   slot's rounded da1 row, and (B1) sums dW2, db1, db2 and dw3 over its
//   tiles; each block writes its own partial slabs, which the caller sums
//   in a fixed order.  No float atomics, so two runs give the same bits.
//   - bf16 (scale_bwd_mma_kernel): the tile's three products, a2 = rnd(h1d)
//     @ rnd(w2), dW2 += rnd(h1d)^T @ rnd(da2) (B1) and dh1 = rnd(da2) @
//     rnd(w2)^T, run on the tensor cores as mma.sync m16n8k16 bf16 x bf16
//     -> f32, as edge_bwd_mma_kernel runs them: 8 warps, each owning 16
//     slots of a tile for a2 and dh1 and (B1) 16 H1 units for dW2; h1d
//     formed in the A fragments with its dropout hash once per unit; each
//     k-step's product started from 0 and added in f32; dW2 and db1 in
//     registers across tiles, fixed shuffle trees and a fixed warp order for
//     the cross-lane sums.  Two sums are taken again in unit order where
//     the order of the tensor cores' f32 sums could move a result: a2
//     within a band of 0, where the a2 > 0 gate flips (seq_a2), and an open
//     da1 near a bf16 midpoint, where the stored row rounds (seq_dh1).  h2d
//     rounds nowhere in this backward (dw3 sums h2d * g in f32), so unlike
//     the per-edge kernel it needs no midpoint test on a2
//     (tests/test_torch_port_scale_sum_order.py).  Each thread reads its
//     two slots' a1 at its units one k-step ahead: B1 from shared memory,
//     where each warp's 16 rows of K2's bf16 spill arrive by cp.async one
//     tile ahead; the mirror from the two f32 table rows of each slot in
//     global memory.  The mirror has no weight gradients and no block
//     barrier in its tile loop: a warp reads only its own rows of the tile
//     (h1d for seq_a2, da2 for seq_dh1).  It fits two blocks an SM (17%
//     faster than one on the H100); its grid is what the card holds
//     resident, as its result does not depend on the split.
//   - fp32 (scale_bwd_kernel): the tensor cores would take fp32 operands
//     only as TF32, which rounds where the fp32 Pallas kernel does not, so
//     the products stay on the CUDA cores: one thread per slot, f32 tiles
//     in shared memory, dW2 in shared memory.
//
// Every entry point returns cudaGetLastError() after its launches.

#include <algorithm>
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

// The bf16 backward: MW = 8 warps (decoder_common.cuh), each owning 16
// slots of a tile.  Shared memory, in bytes; the mirror needs no per-warp
// sums.
static_assert(TS == MW * 16, "each warp owns one 16-row mma tile of slots");
static_assert(H1 == MW * 16, "each warp owns 16 H1 units of dW2");
static_assert(MT == H1 + 2 * H2, "the final sums map one thread to one output");
template <bool MIRROR>
constexpr int mma_smem() {
  return H1 * LDW * 2                      // w2, bf16
         + TS * LDH * 2                    // rnd(h1d) of the tile
         + TS * LDW * 2                    // rnd(da2) of the tile
         + (H1 + 2 * H2) * 4               // b1, b2, w3
         + (MIRROR ? 0 : 2 * MW * H1 * 4)  // per-warp db1, db2 and dw3 sums
         + 4                               // max |rnd(w2)|
         + MT * FIX_LD * 4                 // a2 and da1 taken again, per thread
         + (MIRROR ? 0 : 12 + TS * LDH * 2);   // B1: the tile's a1, 16-byte aligned
}

// A 16-byte copy from global to shared memory that the thread does not
// wait for, and the wait for all of the thread's copies.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :
               : "r"(smem_addr(smem)), "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// B1: the warp's 16 rows of the saved a1 of the tile at slot e0 into a1s
// (rows of LDH), 16 bytes a copy; a padding slot copies slot 0's row.
__device__ __forceinline__ void a1_prefetch(__nv_bfloat16* a1s,
                                            const __nv_bfloat16* a1_saved,
                                            int e0, int warp, int lane, int ne) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int chunk = lane + 32 * i, row = 16 * warp + chunk / 16;
    const int col = 8 * (chunk % 16), e = e0 + row < ne ? e0 + row : 0;
    cp_async16(a1s + row * LDH + col, a1_saved + (size_t)e * H1 + col);
  }
}

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
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// K2 in fp32 on the CUDA cores.
template <bool SAVE_A1>
__global__ void __launch_bounds__(TS) scale_fwd_kernel(
    const float* __restrict__ pd, const float* __restrict__ pv,
    const int* __restrict__ drug, const int* __restrict__ dis,
    const int* __restrict__ eid, const float* __restrict__ b1,
    const float* __restrict__ w2, const float* __restrict__ b2,
    const float* __restrict__ w3, const int* __restrict__ seed_ptr,
    float* __restrict__ out, float* __restrict__ a1_out, int nd, int nv,
    int ne, uint32_t thresh, float scale, int use_drop) {
  extern __shared__ float4 smem4[];
  float* w2s = reinterpret_cast<float*>(smem4);
  float* b1s = w2s + H1 * H2;
  float* b2s = b1s + H1;
  float* w3s = b2s + H2;

  const int t = threadIdx.x;
  for (int q = t; q < H1 * H2; q += TS) w2s[q] = w2[q];
  b1s[t] = b1[t];
  if (t < H2) {
    b2s[t] = b2[t];
    w3s[t] = w3[t];
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
  layer1<false>(
      [=](int k) {
        const float4 a = rows_a1<false, true>(pd_row, pv_row, b1s, k);
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
    s += h2 * w3s[n];
  }
  out[e] = s;
}

// h2d = a2 * m2 (a2 > 0) near a bf16 midpoint, where the order of a2's f32
// sum can decide rnd(h2d): within MID_ULPS f32 ulps of it (near_step's
// midpoint branch), or within the absolute band, which bounds the sums'
// noise where |a2| is small against its terms (near_step_abs,
// edge_decoder.cu).  At a2 = 0 relu and rnd are continuous, so an a2 near
// the gate moves the logit by f32 noise only and is not flagged.
__device__ __forceinline__ bool near_h2d_mid(float a2, float m2, float band) {
  if (a2 <= 0.f) return false;
  const float h = a2 * m2;
  const int lo = (int)(__float_as_uint(h) & 0xFFFFu);
  return abs(lo - 0x8000) <= MID_ULPS || near_mid(h, band * m2);
}

// Shared memory of the bf16 K2, in bytes.
constexpr int FWD_MMA_SMEM = H1 * LDW * 2      // w2, bf16
                             + TS * LDH * 2    // rnd(h1d) of the tile
                             + (H1 + 2 * H2) * 4   // b1, b2, rnd(w3)
                             + 4               // max |rnd(w2)|
                             + MT * FIX_LD * 4;    // a2 taken again, per thread

// K2 in bf16 on the tensor cores.  The fragment layout of mma m16n8k16
// (lane = 4 gq + q; see fwd_mma_rows) gives a thread of warp w slots c0 =
// 16 w + gq and c1 = c0 + 8 of a tile and, of each 128-unit row, the units
// 16 ks + 8 h + 2 q + e (k-step ks < 8; h, e < 2); of the a2 accumulator,
// the same slots at the columns 8 nt + 2 q + e of n-tile nt < 8.  A slot
// past ne computes on slot 0 and writes nothing, neither its logit nor its
// a1 row; a warp whose 16 slots all lie past ne skips the tile.  A warp
// reads only its own rows of h1s, so the tile loop has no block barrier.
template <bool SAVE_A1>
__global__ void __launch_bounds__(MT, FWD_RESIDENT) scale_fwd_mma_kernel(
    const float* __restrict__ pd, const float* __restrict__ pv,
    const int* __restrict__ drug, const int* __restrict__ dis,
    const int* __restrict__ eid, const float* __restrict__ b1,
    const float* __restrict__ w2, const float* __restrict__ b2,
    const float* __restrict__ w3, const int* __restrict__ seed_ptr,
    float* __restrict__ out, __nv_bfloat16* __restrict__ a1_out, int nd,
    int nv, int ne, uint32_t thresh, float scale, int use_drop) {
  extern __shared__ float4 smem4[];
  __nv_bfloat16* w2s = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* h1s = w2s + H1 * LDW;
  float* b1s = reinterpret_cast<float*>(h1s + TS * LDH);
  float* b2s = b1s + H1;
  float* w3s = b2s + H2;
  float* wmx = w3s + H2;
  float* fixv = wmx + 1 + threadIdx.x * FIX_LD;

  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const int gq = lane >> 2, q = lane & 3;
  const int mi = lane >> 3, mr = lane & 7;   // ldmatrix: matrix and row
  const int n_tiles = (ne + TS - 1) / TS;
  const bool drop = use_drop != 0;
  const uint32_t seed = (uint32_t)seed_ptr[0];

  for (int e = t; e < H1 * H2 / 2; e += MT) {
    const int k = e / (H2 / 2), n = 2 * (e % (H2 / 2));
    const float2 v = *reinterpret_cast<const float2*>(w2 + k * H2 + n);
    *reinterpret_cast<uint32_t*>(w2s + k * LDW + n) = pack_bf16(v.x, v.y);
  }
  if (t < H1) b1s[t] = b1[t];
  if (t < H2) {
    b2s[t] = b2[t];
    w3s[t] = rnd<true>(w3[t]);
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
  __syncthreads();   // wmx

  const int c0 = warp * 16 + gq, c1 = c0 + 8;
  const float mk = drop ? scale : 1.f;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int e0 = tile * TS;
    if (e0 + warp * 16 >= ne) continue;
    const bool v0 = e0 + c0 < ne, v1 = e0 + c1 < ne;
    const int s0 = v0 ? e0 + c0 : 0, s1 = v1 ? e0 + c1 : 0;
    const int i0 = drug[s0], j0 = dis[s0], i1 = drug[s1], j1 = dis[s1];
    assert(0 <= i0 && i0 < nd && 0 <= j0 && j0 < nv);   // a row outside the tables
    assert(0 <= i1 && i1 < nd && 0 <= j1 && j1 < nv);
    const uint32_t base0 = drop ? slot_base((uint32_t)eid[s0], seed) : 0u;
    const uint32_t base1 = drop ? slot_base((uint32_t)eid[s1], seed) : 0u;
    const float* rows[4] = {pd + (size_t)i0 * H1 + 2 * q, pv + (size_t)j0 * H1 + 2 * q,
                            pd + (size_t)i1 * H1 + 2 * q, pv + (size_t)j1 * H1 + 2 * q};
    // The rows' values at the thread's units of the next k-step: [h][row].
    float2 nxt[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int r = 0; r < 4; ++r) nxt[h][r] = *reinterpret_cast<const float2*>(rows[r] + 8 * h);
    __syncwarp();   // the warp's lanes are done with its rows of h1s

    // a2 = rnd(h1d) @ rnd(w2), each k-step's product started from 0 and
    // added in f32; hs0 / hs1 sum the slots' h1d, which bounds |a2 - b2|
    // over max |w2|.
    float acc[H2 / 8][4];
#pragma unroll
    for (int nt = 0; nt < H2 / 8; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[nt][c] = 0.f;
    float hs0 = 0.f, hs1 = 0.f;
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
            nxt[h][r] = *reinterpret_cast<const float2*>(rows[r] + 16 * (ks + 1) + 8 * h);
      }
      uint32_t a[4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = 16 * ks + 8 * h + 2 * q;
        const float4 x = pair_a1<true>(cur[h][0], cur[h][1], cur[h][2], cur[h][3],
                                       *reinterpret_cast<const float2*>(b1s + k));
        if constexpr (SAVE_A1) {
          if (v0)
            *reinterpret_cast<uint32_t*>(a1_out + (size_t)s0 * H1 + k) = pack_bf16(x.x, x.y);
          if (v1)
            *reinterpret_cast<uint32_t*>(a1_out + (size_t)s1 * H1 + k) = pack_bf16(x.z, x.w);
        }
        float v[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          v[u] = fmaxf(v[u], 0.f);
          if (drop)
            v[u] = v[u] * (slot_bits(u < 2 ? base0 : base1, (uint32_t)(k + (u & 1))) >= thresh
                               ? scale
                               : 0.f);
        }
        hs0 += v[0] + v[1];
        hs1 += v[2] + v[3];
        a[2 * h] = pack_bf16(v[0], v[1]);
        a[2 * h + 1] = pack_bf16(v[2], v[3]);
        *reinterpret_cast<uint32_t*>(h1s + c0 * LDH + k) = a[2 * h];
        *reinterpret_cast<uint32_t*>(h1s + c1 * LDH + k) = a[2 * h + 1];
      }
#pragma unroll
      for (int np = 0; np < H2 / 16; ++np) {
        uint32_t b[4];
        ldsm_t(b, smem_addr(w2s + (16 * ks + (mi & 1) * 8 + mr) * LDW + 16 * np +
                            (mi >> 1) * 8));
        float p0[4] = {0.f, 0.f, 0.f, 0.f}, p1[4] = {0.f, 0.f, 0.f, 0.f};
        mma_bf16(p0, a, b[0], b[1]);
        mma_bf16(p1, a, b[2], b[3]);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          acc[2 * np][c] += p0[c];
          acc[2 * np + 1][c] += p1[c];
        }
      }
    }
    hs0 += __shfl_xor_sync(0xffffffffu, hs0, 1);
    hs0 += __shfl_xor_sync(0xffffffffu, hs0, 2);
    hs1 += __shfl_xor_sync(0xffffffffu, hs1, 1);
    hs1 += __shfl_xor_sync(0xffffffffu, hs1, 2);
    __syncwarp();   // h1s holds the warp's 16 rows for seq_a2

    // acc becomes a2 = acc + b2; the thread's value v = 4 nt + 2 e + r
    // (slot r, column 8 nt + 2 q + e) gets its m2 keep bit, and a flag
    // where its h2d is near a bf16 midpoint; the flagged ones are taken
    // again in unit order, one lane each.
    const float band[2] = {0x1p-20f * hs0 * *wmx, 0x1p-20f * hs1 * *wmx};
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
          const bool kp = !drop || slot_bits(r == 0 ? base0 : base1,
                                             (uint32_t)(H1 + n)) >= thresh;
          keep2 |= kp ? 1u << v : 0u;
          fix |= kp && near_h2d_mid(a2, mk, band[r]) ? 1u << v : 0u;
        }
      }
    }
    for (uint32_t todo = fix; todo != 0u; todo &= todo - 1u) {
      const int v = __ffs((int)todo) - 1, nt = v >> 2, e = (v >> 1) & 1, r = v & 1;
      fixv[v] = seq_a2(h1s + (r == 0 ? c0 : c1) * LDH, w2s + 8 * nt + 2 * q + e) +
                b2s[8 * nt + 2 * q + e];
    }

    // The logits: s = sum_n rnd(m2 * relu(a2)) * rnd(w3), each thread's 16
    // columns in column order, then the quad's partials in a fixed tree.
    float s[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < H2 / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = 8 * nt + 2 * q + e;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int v = 4 * nt + 2 * e + r;
          const float a2 = (fix >> v) & 1u ? fixv[v] : acc[nt][2 * r + e];
          float h2 = fmaxf(a2, 0.f);
          if (drop) h2 = h2 * ((keep2 >> v) & 1u ? scale : 0.f);
          s[r] += rnd<true>(h2) * w3s[n];
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      s[r] += __shfl_xor_sync(0xffffffffu, s[r], 1);
      s[r] += __shfl_xor_sync(0xffffffffu, s[r], 2);
    }
    if (q == 0 && v0) out[e0 + c0] = s[0];
    if (q == 1 && v1) out[e0 + c1] = s[1];
  }
}

// The fp32 backward on the CUDA cores.  FROM_SAVED_A1: B1 (a1 from the
// forward's spill, weight gradients when WEIGHT_GRADS); else the mirror (a1
// from the table rows).
template <bool FROM_SAVED_A1, bool WEIGHT_GRADS>
__global__ void __launch_bounds__(TS) scale_bwd_kernel(
    const float* __restrict__ a1_saved, const float* __restrict__ pd,
    const float* __restrict__ pv, const int* __restrict__ drug,
    const int* __restrict__ dis, const int* __restrict__ eid,
    const float* __restrict__ g, const float* __restrict__ b1,
    const float* __restrict__ w2, const float* __restrict__ b2,
    const float* __restrict__ w3, const int* __restrict__ seed_ptr,
    float* __restrict__ da1_out,
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

  for (int q = t; q < H1 * H2; q += TS) w2s[q] = w2[q];
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
    const float* a1_row = nullptr;
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
        return rows_a1<false, true>(pd_row, pv_row, b1s, k);
      }
    };
    __syncthreads();   // the previous tile is done with hbuf and da2s

    // Per slot: recompute the forward, then da2 = (a2 > 0) * g * w3 * m2.
    {
      float acc[H2];
      layer1<false>(a1_at, bits, w2s, drop, thresh, scale, acc,
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
        acc[n] = da2;
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

    // Thread k: db1 sums da1, and each slot's da1 row goes out whole.
    {
      const int k = t;
      const int n_valid = min(TS, ne - e0);
#pragma unroll 4
      for (int c = 0; c < TS; ++c) {
        const float v = hbuf[c * LD1 + k];
        if constexpr (WEIGHT_GRADS) db1acc += v;
        if (c < n_valid) da1_out[(size_t)(e0 + c) * H1 + k] = v;
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

// One bf16 pair of a saved a1 row, as two floats.
__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// The bf16 backward on the tensor cores: B1 (MIRROR false; a1 from the
// forward's bf16 spill, and the weight gradients into the block's partial
// slabs) or the mirror (a1 from the table rows, no weight gradients).  The
// fragment layout of mma m16n8k16 (lane = 4 gq + q; see grid_bwd_mma_kernel)
// gives a thread of warp w slots c0 = 16 w + gq and c1 = c0 + 8 of the
// tile, and of each 128-unit row the units 8 m + 2 q + e, m < 16, e < 2,
// which it indexes as 2 m + e.  It reads those units of its two slots' a1
// one k-step ahead of the a2 product that consumes them: in B1 from the
// warp's rows of a1s, which cp.async filled while the warp worked on its
// previous tile; in the mirror from the slots' table rows in global memory.
// (Read straight from global memory, B1 took 3% longer on the H100.)
template <bool MIRROR>
__global__ void __launch_bounds__(MT, MIRROR ? 2 : 1) scale_bwd_mma_kernel(
    const __nv_bfloat16* __restrict__ a1_saved, const float* __restrict__ pd,
    const float* __restrict__ pv, const int* __restrict__ drug,
    const int* __restrict__ dis, const int* __restrict__ eid,
    const float* __restrict__ g, const float* __restrict__ b1,
    const float* __restrict__ w2, const float* __restrict__ b2,
    const float* __restrict__ w3, const int* __restrict__ seed_ptr,
    __nv_bfloat16* __restrict__ da1_out,   // (ne, H1): rnd(da1) per slot
    float* __restrict__ db1_part,   // (n_split, H1)
    float* __restrict__ dw2_part,   // (n_split, H1, H2)
    float* __restrict__ db2_part,   // (n_split, H2)
    float* __restrict__ dw3_part,   // (n_split, H2)
    int nd, int nv, int ne, uint32_t thresh, float scale, int use_drop) {
  extern __shared__ float4 smem4[];
  __nv_bfloat16* w2s = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* h1s = w2s + H1 * LDW;
  __nv_bfloat16* da2s = h1s + TS * LDH;
  float* b1s = reinterpret_cast<float*>(da2s + TS * LDW);
  float* b2s = b1s + H1;
  float* w3s = b2s + H2;
  float* red = w3s + H2;                  // B1: [MW][H1] db1, then [MW][2 H2] db2, dw3
  float* wmx = red + (MIRROR ? 0 : 2 * MW * H1);
  float* fixv = wmx + 1 + threadIdx.x * FIX_LD;
  __nv_bfloat16* a1s = reinterpret_cast<__nv_bfloat16*>(
      smem4 + (reinterpret_cast<char*>(wmx + 1 + MT * FIX_LD) -
               reinterpret_cast<char*>(smem4) + 15) / 16);

  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const int gq = lane >> 2, q = lane & 3;
  const int mi = lane >> 3, mr = lane & 7;   // ldmatrix: matrix and row
  const int n_tiles = (ne + TS - 1) / TS;
  const bool drop = use_drop != 0;
  const uint32_t seed = (uint32_t)seed_ptr[0];

  for (int e = t; e < H1 * H2 / 2; e += MT) {
    const int k = e / (H2 / 2), n = 2 * (e % (H2 / 2));
    const float2 v = *reinterpret_cast<const float2*>(w2 + k * H2 + n);
    *reinterpret_cast<uint32_t*>(w2s + k * LDW + n) = pack_bf16(v.x, v.y);
  }
  if constexpr (MIRROR) {
    if (t < H1) b1s[t] = b1[t];
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
  __syncthreads();   // wmx

  const int c0 = warp * 16 + gq, c1 = c0 + 8;
  float dw2acc[H2 / 8][4];      // B1: dW2 rows 16 warp + gq (+ 8), columns 8 nt + 2 q + e
  float db1acc[2][16];          // B1: db1 units 64 half + 8 nt + 2 q + e, at [half][2 nt + e]
  float db2acc[2] = {0.f, 0.f}, dw3acc[2] = {0.f, 0.f};   // B1: columns 8 gq + 2 q + e
#pragma unroll
  for (int nt = 0; nt < H2 / 8; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) dw2acc[nt][c] = 0.f;
#pragma unroll
  for (int x = 0; x < 16; ++x) db1acc[0][x] = db1acc[1][x] = 0.f;

  // B1 reads a unit pair of a slot as one bf16 pair of its a1 row in a1s;
  // the mirror reads it from each of the slot's two f32 table rows.
  constexpr int NR = MIRROR ? 4 : 2;
  using row_t = typename std::conditional<MIRROR, float, __nv_bfloat16>::type;
  using pair_t = typename std::conditional<MIRROR, float2, uint32_t>::type;
  if constexpr (!MIRROR) {
    if ((int)blockIdx.x < n_tiles)
      a1_prefetch(a1s, a1_saved, blockIdx.x * TS, warp, lane, ne);
  }

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    // Slots c0 and c1.  A padding slot runs slot 0 with g = 0: it adds
    // nothing to any sum and writes no da1 row.
    const int e0 = tile * TS;
    const bool v0 = e0 + c0 < ne, v1 = e0 + c1 < ne;
    const int s0 = v0 ? e0 + c0 : 0, s1 = v1 ? e0 + c1 : 0;
    const float gc[2] = {v0 ? g[s0] : 0.f, v1 ? g[s1] : 0.f};
    const uint32_t base0 = slot_base((uint32_t)eid[s0], seed);
    const uint32_t base1 = slot_base((uint32_t)eid[s1], seed);
    const row_t* rows[NR];
    if constexpr (MIRROR) {
      const int i0 = drug[s0], j0 = dis[s0], i1 = drug[s1], j1 = dis[s1];
      assert(0 <= i0 && i0 < nd && 0 <= j0 && j0 < nv);
      assert(0 <= i1 && i1 < nd && 0 <= j1 && j1 < nv);
      rows[0] = pd + (size_t)i0 * H1;
      rows[1] = pv + (size_t)j0 * H1;
      rows[2] = pd + (size_t)i1 * H1;
      rows[3] = pv + (size_t)j1 * H1;
    } else {
      rows[0] = a1s + c0 * LDH;
      rows[1] = a1s + c1 * LDH;
      cp_async_wait_all();   // the warp's rows of this tile
      __syncwarp();
    }
    // The rows' values at the units of one k-step: [h][row] at units
    // 8 (2 ks + h) + 2 q + {0, 1}.
    pair_t nxt[2][NR];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int r = 0; r < NR; ++r)
        nxt[h][r] = *reinterpret_cast<const pair_t*>(rows[r] + 8 * h + 2 * q);
    // B1: the previous tile's dW2 product is done with h1s and da2s.  The
    // mirror's warps read only their own rows of them.
    if constexpr (MIRROR) {
      __syncwarp();
    } else {
      __syncthreads();
    }

    // a2 = rnd(h1d) @ rnd(w2), with h1d formed in the A fragments from a1;
    // the da1 gate (a1 > 0 and the m1 keep bit) of each unit is kept in
    // gate0 / gate1 for slots c0 / c1.  Each k-step's product starts from
    // 0 and is added in f32: an mma that carries the sum of earlier steps
    // rounds it to fewer bits.  hs0 / hs1 sum the slots' h1d, which bounds
    // |a2 - b2| over max |w2|.
    uint32_t gate0 = 0u, gate1 = 0u;
    float hs0 = 0.f, hs1 = 0.f;
    float acc[H2 / 8][4];
#pragma unroll
    for (int nt = 0; nt < H2 / 8; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[nt][c] = 0.f;
#pragma unroll 1
    for (int ks = 0; ks < H1 / 16; ++ks) {
      pair_t cur[2][NR];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int r = 0; r < NR; ++r) cur[h][r] = nxt[h][r];
      if (ks + 1 < H1 / 16) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int r = 0; r < NR; ++r)
            nxt[h][r] = *reinterpret_cast<const pair_t*>(
                rows[r] + 8 * (2 * ks + 2 + h) + 2 * q);
      }
      uint32_t a[4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = 2 * ks + h, k = 8 * m + 2 * q;
        float x[4];
        if constexpr (MIRROR) {
          const float2 bv = *reinterpret_cast<const float2*>(b1s + k);
          const float2 p0 = cur[h][0], q0 = cur[h][1], p1 = cur[h][2], q1 = cur[h][3];
          x[0] = (rnd<true>(p0.x) + rnd<true>(q0.x)) + bv.x;
          x[1] = (rnd<true>(p0.y) + rnd<true>(q0.y)) + bv.y;
          x[2] = (rnd<true>(p1.x) + rnd<true>(q1.x)) + bv.x;
          x[3] = (rnd<true>(p1.y) + rnd<true>(q1.y)) + bv.y;
        } else {
          const float2 u0 = unpack_bf16(cur[h][0]), u1 = unpack_bf16(cur[h][1]);
          x[0] = u0.x;
          x[1] = u0.y;
          x[2] = u1.x;
          x[3] = u1.y;
        }
        float hv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const uint32_t kk = (uint32_t)(k + (u & 1));
          const bool keep = !drop || slot_bits(u < 2 ? base0 : base1, kk) >= thresh;
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
        float p0[4] = {0.f, 0.f, 0.f, 0.f}, p1[4] = {0.f, 0.f, 0.f, 0.f};
        mma_bf16(p0, a, b[0], b[1]);
        mma_bf16(p1, a, b[2], b[3]);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          acc[2 * np][c] += p0[c];
          acc[2 * np + 1][c] += p1[c];
        }
      }
    }
    hs0 += __shfl_xor_sync(0xffffffffu, hs0, 1);
    hs0 += __shfl_xor_sync(0xffffffffu, hs0, 2);
    hs1 += __shfl_xor_sync(0xffffffffu, hs1, 1);
    hs1 += __shfl_xor_sync(0xffffffffu, hs1, 2);
    __syncwarp();   // h1s holds the warp's 16 rows for seq_a2
    if constexpr (!MIRROR) {
      // The warp is done with its rows of a1s: fetch those of its next tile.
      if (tile + (int)gridDim.x < n_tiles)
        a1_prefetch(a1s, a1_saved, (tile + gridDim.x) * TS, warp, lane, ne);
    }

    // On the accumulator: a2 = acc + b2 (taken again in unit order within
    // the band of 0), h2d, da2 = (a2 > 0) * g * w3 * m2, (B1) the db2 and
    // dw3 sums, and rnd(da2) as the A fragments of dh1 and into da2s.  dw3
    // sums h2d * g unrounded, so of a2 only its gate at 0 decides a rounding.
    uint32_t da[H2 / 16][4];
    float band3[2];
    const float mk = drop ? scale : 1.f;
    {
      const float band[2] = {0x1p-20f * hs0 * *wmx, 0x1p-20f * hs1 * *wmx};
      // acc becomes a2; the thread's value v = 4 nt + 2 e + r gets its m2
      // keep bit, and a flag where a2 is within the band of 0.
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
            const bool kp = !drop || slot_bits(r == 0 ? base0 : base1,
                                               (uint32_t)(H1 + n)) >= thresh;
            keep2 |= kp ? 1u << v : 0u;
            fix |= kp && fabsf(a2) <= band[r] ? 1u << v : 0u;
          }
        }
      }
      // The flagged values in unit order, one lane each.
      for (uint32_t todo = fix; todo != 0u; todo &= todo - 1u) {
        const int v = __ffs((int)todo) - 1, nt = v >> 2, e = (v >> 1) & 1, r = v & 1;
        fixv[v] = seq_a2(h1s + (r == 0 ? c0 : c1) * LDH, w2s + 8 * nt + 2 * q + e) +
                  b2s[8 * nt + 2 * q + e];
      }
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
            float dh2 = w3s[n] * gc[r];
            if (drop) {
              h2d = h2d * m2;
              dh2 = dh2 * m2;
            }
            d[r][e] = a2 > 0.f ? dh2 : 0.f;
            hw[r] = h2d * gc[r];
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
      if constexpr (!MIRROR) {
        row_sum(sdb, lane);
        row_sum(sdw, lane);
        db2acc[0] += sdb[0];
        db2acc[1] += sdb[1];
        dw3acc[0] += sdw[0];
        dw3acc[1] += sdw[1];
      }
      as0 += __shfl_xor_sync(0xffffffffu, as0, 1);
      as0 += __shfl_xor_sync(0xffffffffu, as0, 2);
      as1 += __shfl_xor_sync(0xffffffffu, as1, 1);
      as1 += __shfl_xor_sync(0xffffffffu, as1, 2);
      // |dh1 (* scale)| of a slot is bounded by its sum(|da2|) * max |w2|
      // (* scale): the window of the sums' noise around a bf16 midpoint of
      // da1, which rounds when it is stored.
      band3[0] = 0x1p-20f * as0 * *wmx * mk;
      band3[1] = 0x1p-20f * as1 * *wmx * mk;
    }
    __syncwarp();   // da2s holds the warp's 16 rows for seq_dh1

    // dh1 = rnd(da2) @ rnd(w2)^T in two halves of 64 units, each k-step's
    // product started from 0 and added in f32; da1 = gate * dh1 (* scale
    // with dropout), summed again in unit order where it is near a bf16
    // midpoint, into (B1) db1 and, rounded, into the slots' da1 rows.  It
    // needs only the warp's own rows and w2s, so in B1 it runs before the
    // barrier that the dW2 product waits at.
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
          float p0[4] = {0.f, 0.f, 0.f, 0.f}, p1[4] = {0.f, 0.f, 0.f, 0.f};
          mma_bf16(p0, da[ks], b[0], b[1]);
          mma_bf16(p1, da[ks], b[2], b[3]);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            acc3[2 * up][c] += p0[c];
            acc3[2 * up + 1][c] += p1[c];
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
      __nv_bfloat16* out0 = da1_out + (size_t)(e0 + c0) * H1 + 64 * half + 2 * q;
      __nv_bfloat16* out1 = da1_out + (size_t)(e0 + c1) * H1 + 64 * half + 2 * q;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        float d[4];
#pragma unroll
        for (int c = 0; c < 4; ++c)
          d[c] = (fix >> (4 * nt + c)) & 1u ? fixv[4 * nt + c] : acc3[nt][c];
        if constexpr (!MIRROR) {
          db1acc[half][2 * nt] += d[0] + d[2];
          db1acc[half][2 * nt + 1] += d[1] + d[3];
        }
        if (v0) *reinterpret_cast<uint32_t*>(out0 + 8 * nt) = pack_bf16(d[0], d[1]);
        if (v1) *reinterpret_cast<uint32_t*>(out1 + 8 * nt) = pack_bf16(d[2], d[3]);
      }
    }

    if constexpr (!MIRROR) {
      __syncthreads();   // h1s and da2s hold the whole tile

      // dW2 rows 16 warp .. + 15 += rnd(h1d)^T @ rnd(da2) over the tile's slots.
#pragma unroll
      for (int ks = 0; ks < TS / 16; ++ks) {
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
  }

  if constexpr (!MIRROR) {
    // db1 over the lanes of each column (fixed shuffle tree), then db1, db2
    // and dw3 over the warps in order.
    const int blk = blockIdx.x;
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
}

template <bool FROM_SAVED_A1, bool WEIGHT_GRADS>
cudaError_t launch_bwd(const void* a1, const float* pd, const float* pv,
                       const int* drug, const int* dis, const int* eid,
                       const float* g, const float* b1, const float* w2,
                       const float* b2, const float* w3, const int* seed,
                       void* da1, float* db1_part, float* dw2_part,
                       float* db2_part, float* dw3_part, int nd, int nv, int ne,
                       uint32_t thresh, float scale, int use_drop, int n_split,
                       cudaStream_t s) {
  constexpr int smem = WEIGHT_GRADS ? BWD_SMEM_GRADS : BWD_SMEM_BASE;
  auto kernel = scale_bwd_kernel<FROM_SAVED_A1, WEIGHT_GRADS>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<n_split, TS, smem * sizeof(float), s>>>(
      static_cast<const float*>(a1), pd, pv, drug, dis, eid, g, b1, w2, b2, w3,
      seed, static_cast<float*>(da1), db1_part, dw2_part, db2_part, dw3_part,
      nd, nv, ne, thresh, scale, use_drop);
  return cudaGetLastError();
}

// Blocks of kernel, of MT threads and smem bytes of shared memory, resident
// on one SM of this card.
template <typename K>
cudaError_t mma_resident(K kernel, int smem, int* blocks) {
  cudaError_t err = prepare(kernel, smem / (int)sizeof(float));
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, MT, smem);
}

// The grid of a kernel whose result does not depend on it (K2 in bf16, the
// mirror): every block the card holds resident, at most one a tile.
template <typename K>
cudaError_t resident_grid(K kernel, int smem, int n_tiles, int* blocks) {
  int per_sm = 0, dev = 0, sms = 0;
  cudaError_t err = mma_resident(kernel, smem, &per_sm);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *blocks = std::min(n_tiles, std::max(per_sm, 1) * sms);
  return err;
}

// B1 on n_split blocks (its partial slabs); the mirror on resident_grid.
template <bool MIRROR>
cudaError_t launch_mma(const void* a1, const float* pd, const float* pv,
                       const int* drug, const int* dis, const int* eid,
                       const float* g, const float* b1, const float* w2,
                       const float* b2, const float* w3, const int* seed,
                       void* da1, float* db1_part, float* dw2_part,
                       float* db2_part, float* dw3_part, int nd, int nv, int ne,
                       uint32_t thresh, float scale, int use_drop, int n_split,
                       cudaStream_t s) {
  auto kernel = scale_bwd_mma_kernel<MIRROR>;
  constexpr int smem = mma_smem<MIRROR>();
  int blocks = n_split;
  const cudaError_t err = MIRROR ? resident_grid(kernel, smem, (ne + TS - 1) / TS, &blocks)
                                 : prepare(kernel, smem / (int)sizeof(float));
  if (err != cudaSuccess) return err;
  kernel<<<blocks, MT, smem, s>>>(
      static_cast<const __nv_bfloat16*>(a1), pd, pv, drug, dis, eid, g, b1, w2,
      b2, w3, seed, static_cast<__nv_bfloat16*>(da1), db1_part, dw2_part,
      db2_part, dw3_part, nd, nv, ne, thresh, scale, use_drop);
  return cudaGetLastError();
}

// K2 over ne slots, a1 spilled when SAVE_A1: bf16 on the tensor cores, on
// resident_grid; fp32 on the CUDA cores, one block a tile.
template <bool SAVE_A1>
cudaError_t launch_fwd(const float* pd, const float* pv, const int* drug,
                       const int* dis, const int* eid, const float* b1,
                       const float* w2, const float* b2, const float* w3,
                       const int* seed, float* out, void* a1, int nd, int nv,
                       int ne, uint32_t thresh, float scale, int use_drop,
                       bool bf16, cudaStream_t s) {
  const int n_tiles = (ne + TS - 1) / TS;
  if (!bf16) {
    scale_fwd_kernel<SAVE_A1><<<n_tiles, TS, FWD_SMEM * sizeof(float), s>>>(
        pd, pv, drug, dis, eid, b1, w2, b2, w3, seed, out, static_cast<float*>(a1),
        nd, nv, ne, thresh, scale, use_drop);
    return cudaGetLastError();
  }
  auto kernel = scale_fwd_mma_kernel<SAVE_A1>;
  int blocks = 0;
  const cudaError_t err = resident_grid(kernel, FWD_MMA_SMEM, n_tiles, &blocks);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, MT, FWD_MMA_SMEM, s>>>(
      pd, pv, drug, dis, eid, b1, w2, b2, w3, seed, out,
      static_cast<__nv_bfloat16*>(a1), nd, nv, ne, thresh, scale, use_drop);
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
// H1), bf16 when bf16 else f32, is written when it is not null.  bf16 runs
// on the tensor cores (scale_fwd_mma_kernel), fp32 on the CUDA cores
// (scale_fwd_kernel).
int scale_decoder_fwd(const float* pd, const float* pv, const int* drug,
                      const int* dis, const int* eid, const float* b1,
                      const float* w2, const float* b2, const float* w3,
                      const int* seed, float* out, void* a1, int nd, int nv,
                      int ne, unsigned int thresh, float scale, int use_drop,
                      int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto launch = a1 ? launch_fwd<true> : launch_fwd<false>;
  return (int)launch(pd, pv, drug, dis, eid, b1, w2, b2, w3, seed, out, a1, nd,
                     nv, ne, thresh, scale, use_drop, bf16 != 0, s);
}

// Residency of K2 of one dtype (the instantiation that spills a1) on one SM
// of this card: occ[] receives {blocks, warps a block}.  Returns 0 or the
// CUDA error.
int scale_decoder_fwd_occupancy(int bf16, int* occ) {
  int blocks = 0;
  const cudaError_t err =
      bf16 ? mma_resident(scale_fwd_mma_kernel<true>, FWD_MMA_SMEM, &blocks)
           : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                 &blocks, scale_fwd_kernel<true>, TS, FWD_SMEM * sizeof(float));
  occ[0] = blocks;
  occ[1] = (bf16 ? MT : TS) / 32;
  return (int)err;
}

// The backward over ne slots.  mirror = 0 (B1): a1 (ne, H1) is the forward's
// spill, and the partial slabs db1 (split, H1), dw2 (split, H1, H2), db2 and
// dw3 (split, H2) are written; pd, pv, drug, dis and b1 are not read.
// mirror = 1: a1 is recomputed from pd, pv, drug, dis and b1; the slabs and
// a1 are not touched.  g (ne,) is the cotangent in this launch's slot order;
// da1 (ne, H1) bf16 when bf16 else f32.  bf16 runs on the tensor cores
// (scale_bwd_mma_kernel), fp32 on the CUDA cores (scale_bwd_kernel).
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
#define SCALE_BWD(LAUNCH)                                                    \
  LAUNCH(a1, pd, pv, drug, dis, eid, g, b1, w2, b2, w3, seed, da1, db1_part, \
         dw2_part, db2_part, dw3_part, nd, nv, ne, thresh, scale, use_drop,  \
         n_split, s)
  cudaError_t err;
  if (bf16) {
    err = mirror ? SCALE_BWD(launch_mma<true>) : SCALE_BWD(launch_mma<false>);
  } else {
    err = mirror ? SCALE_BWD((launch_bwd<false, false>))
                 : SCALE_BWD((launch_bwd<true, true>));
  }
#undef SCALE_BWD
  return (int)err;
}

// Residency of the backward of one dtype, B1 or the mirror, on one SM of
// this card: occ[] receives {blocks, warps a block}.  Returns 0 or the CUDA
// error.
int scale_decoder_bwd_occupancy(int bf16, int mirror, int* occ) {
  cudaError_t err;
  int blocks = 0;
  if (bf16) {
    err = mirror ? mma_resident(scale_bwd_mma_kernel<true>, mma_smem<true>(), &blocks)
                 : mma_resident(scale_bwd_mma_kernel<false>, mma_smem<false>(), &blocks);
  } else {
    const int smem = mirror ? BWD_SMEM_BASE : BWD_SMEM_GRADS;
    auto kernel = mirror ? scale_bwd_kernel<false, false> : scale_bwd_kernel<true, true>;
    err = prepare(kernel, smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, TS,
                                                          smem * sizeof(float));
  }
  occ[0] = blocks;
  occ[1] = (bf16 ? MT : TS) / 32;
  return (int)err;
}

}  // extern "C"

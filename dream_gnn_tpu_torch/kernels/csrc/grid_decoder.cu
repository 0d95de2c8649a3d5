// Fused dense-grid MLP decoder for Hopper (sm_90a), forward and backward,
// for one fold or a stack of F folds.
//
// Replaces the Pallas TPU kernels _fwd_kernel / _bwd_kernel and their
// fold-batched forms _fwd_kernel_b / _bwd_kernel_b of
// dream_gnn_tpu/kernels/pallas_grid_decoder.py.  For every fold f and cell
// (drug i, disease j) of its grid:
//
//     a1  = Pd[i] + Pv[j] + b1                 (H1 = 128 units)
//     h1d = relu(a1) * m1                      (m1: dropout mask, layer 1)
//     a2  = rnd(h1d) @ rnd(w2) + b2            (H2 = 64 units, f32 sums)
//     h2d = relu(a2) * m2                      (m2: dropout mask, layer 2)
//     out[i, j] = h2d . w3                     (b3 is added by the caller)
//
// rnd() rounds to bf16 in bf16 mode and is the identity in fp32 mode, at
// the same points as the Pallas kernels.  Dropout bits are a stateless hash
// of (seed[f], layer, row_base + i, col_base + j, k), with no fold term; see
// dream_gnn_tpu_torch/kernels/grid_decoder.py for the definition that the
// plain PyTorch version shares bit for bit.  The bases are 0 for a whole
// grid; a launch on one block of a larger grid (the mesh wrappers) passes
// the block's first global row and column, and so draws that block of the
// whole grid's masks.
//
// Folds.  The fold index is blockIdx.z: each fold reads its own Pd, Pv, b1,
// w2, b2, w3, g and seed at a fold stride and writes its own slice of the
// outputs.  A single-fold call is the same kernel with one fold, so fold f
// of a batched call computes exactly what a single-fold call with seed[f]
// computes.
//
// What bounds the kernels on an H100: operations.  A cell costs 16,768
// operations forward and 50,176 backward (three 128 x 64 products and the
// elementwise work around them) against a few bytes of table rows, so the
// backward's bound is its tensor-core time.
//
// Forward.
// - bf16 (grid_fwd_mma_kernel): the a2 product on the tensor cores, as
//   mma.sync m16n8k16 bf16 x bf16 -> f32 on the operands the plain version
//   rounds to (fwd_mma_rows, decoder_common.cuh).  8 warps, each owning 16
//   cells of a 4 x 32 tile (one drug row, 16 disease columns); rnd(h1d) is
//   built straight into the A fragments with its dropout hash, and the B
//   fragments of rnd(w2) come by ldmatrix from a bf16 copy in shared
//   memory.  A block owns one 32-disease column of one fold: it stages w2
//   and the column's 32 Pv rows once, then walks a fixed, strided subset
//   of the 4-drug row tiles, each warp reading its drug row's Pd values
//   from L2 one k-step ahead, with no barrier in the walk.  The split into
//   blocks aims at whole waves of two blocks an SM (wave_split); it moves
//   the time only, since a cell's logit depends on its own inputs alone.
//   Unlike the backward it needs no unit-order recompute: h2d is not
//   rounded and the logit is continuous in a2.
// - fp32 (grid_fwd_kernel): the tensor cores would take fp32 operands only
//   as TF32, so the product stays on the CUDA cores: one block of 128
//   threads per 4 x 32 tile of cells, one thread per cell; w2, b1, b2, w3
//   and the tile's Pd / Pv rows sit in shared memory; each thread keeps its
//   64 a2 sums in registers and reads w2 rows as float4 broadcasts.
//
// Backward.  A block owns one 32-disease column of tiles of one fold and
// walks over a fixed, strided subset of the 4-drug row tiles.  Per tile it
// recomputes the forward, forms da2 and da1 per cell, and reduces the
// cross-cell sums: dW2 and dPv accumulate over the block's tiles, dPd is
// written once per tile.  Each block writes its own partial slabs, which
// the caller sums in a second pass: no float atomics, so the result does
// not change from run to run.  The split depends on the shapes only and is
// the same for both dtypes (one block an SM in both).
// - bf16 (grid_bwd_mma_kernel): the three products of a tile, a2 =
//   rnd(h1d) @ rnd(w2), dW2 += rnd(h1d)^T @ rnd(da2) and dh1 = rnd(da2) @
//   rnd(w2)^T, run on the tensor cores as mma.sync m16n8k16 bf16 x bf16 ->
//   f32: the operands are the bf16 values the plain version rounds to, a
//   product of two is exact in f32, so only the f32 sums differ: the tensor
//   cores add a k-step's 16 products in their own order and precision.
//   That matters where a2 sits on a step of what follows it: the relu and
//   the a2 > 0 gate at 0, and the bf16 rounding of h2d, whose midpoints
//   dw3 sees.  There a difference in the last bits of a2 moves dw3 beyond
//   the 1e-4 tolerance in a small grid: the plain version's own dw3 does
//   when its a2 sum is merely reversed
//   (tests/test_torch_port_grid_sum_order.py).  So each a2 starts every
//   k-step's mma from 0 and adds the 8 partials in f32, and the rare a2
//   within the sums' noise of a step is summed again on the CUDA cores in
//   unit order, one fused multiply-add per unit (seq_a2).  8 warps, each owning 16 cells of the
//   tile for a2 and dh1 and
//   16 H1 units for dW2; w2, h1d and da2 sit in shared memory in bf16,
//   rows padded so that ldmatrix and the fragment stores hit distinct
//   banks.  h1d is formed straight in the A-fragment layout of the a2
//   product, whose (cell, unit) pairs are those of the dh1 accumulator, so
//   the layer-1 dropout hash runs once per cell and unit and its keep and
//   a1 > 0 bits stay in two registers for the da1 gate.  da2 goes from the
//   a2 accumulator to the A fragments of the dh1 product in registers.
//   dW2 and each thread's dPv rows accumulate in registers over the
//   block's tiles; the cross-lane sums (dPd, db2, dw3) run as fixed
//   shuffle trees.
// - fp32 (grid_bwd_kernel): the tensor cores would take fp32 operands only
//   as TF32, which rounds where the fp32 Pallas kernel does not, so the
//   products stay on the CUDA cores: one thread per cell, f32 tiles in
//   shared memory, one block of 4 warps an SM.

// Every entry point returns cudaGetLastError() after its launch.

#include "decoder_common.cuh"

namespace {

constexpr int TI = 4;            // drugs per tile
constexpr int TJ = 32;           // diseases per tile (one warp per drug row)
constexpr int NT = TI * TJ;      // threads per block, one per cell of a tile
static_assert(NT == H1, "the backward's reductions map one thread to one H1 unit");

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

// The bf16 kernels on the tensor cores: MW = 8 warps (decoder_common.cuh),
// each owning 16 cells of a tile; f32 Pv rows padded by 32 bytes, so that
// the lanes of a float2 load fall in distinct banks.
constexpr int LDP = H1 + 8;      // f32 row stride of the Pv rows
static_assert(NT == MW * 16, "each warp owns one 16-row mma tile of cells");
static_assert(H1 == MW * 16, "each warp owns 16 H1 units of dW2");
static_assert(TJ * H1 * 4 <= NT * LDH * 2, "the dPv sum reuses h1s");
static_assert(2 * MW * H2 <= MW * H1, "the db2 / dw3 sums reuse red");

// Shared memory, in bytes.
constexpr int MMA_SMEM = H1 * LDW * 2     // w2, bf16
                       + NT * LDH * 2     // rnd(h1d) of the tile
                       + NT * LDW * 2     // rnd(da2) of the tile
                       + TJ * LDP * 4     // Pv rows of the block's disease tile
                       + TI * H1 * 4      // Pd rows of the current drug tile
                       + (H1 + 2 * H2) * 4    // b1, b2, w3
                       + NT * 4           // g of the current tile
                       + MW * H1 * 4      // per-warp dPd sums
                       + 4                // max |rnd(w2)|
                       + MT * FIX_LD * 4; // a2 taken again, per thread

// The bf16 forward, in bytes: w2 in bf16, the block's Pv rows, b1, b2, w3.
constexpr int FWD_MMA_SMEM = H1 * LDW * 2 + TJ * LDP * 4 + (H1 + 2 * H2) * 4;
static_assert(FWD_MMA_SMEM <= 48 * 1024, "the bf16 forward needs no opt-in");

__global__ void __launch_bounds__(NT) grid_fwd_kernel(
    const float* __restrict__ pd, const float* __restrict__ pv,
    const float* __restrict__ b1, const float* __restrict__ w2,
    const float* __restrict__ b2, const float* __restrict__ w3,
    const int* __restrict__ seed_ptr, float* __restrict__ out, int nd, int nv,
    uint32_t thresh, float scale, int use_drop, int row_base,
    int col_base) {
  extern __shared__ float4 smem4[];
  float* w2s = reinterpret_cast<float*>(smem4);
  float* pvs = w2s + H1 * H2;
  float* pds = pvs + TJ * LD1;
  float* b1s = pds + TI * H1;
  float* b2s = b1s + H1;
  float* w3s = b2s + H2;

  const int f = blockIdx.z;
  pd += (size_t)f * nd * H1;
  pv += (size_t)f * nv * H1;
  b1 += f * H1;
  w2 += f * H1 * H2;
  b2 += f * H2;
  w3 += f * H2;
  out += (size_t)f * nd * nv;
  const int t = threadIdx.x;
  const int i0 = blockIdx.y * TI, j0 = blockIdx.x * TJ;
  for (int e = t; e < H1 * H2; e += NT) w2s[e] = w2[e];
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
  const uint32_t seed = (uint32_t)seed_ptr[f];
  float acc[H2];
  cell_layer1(pds + ti * H1, pvs + tj * LD1, b1s, w2s,
              cell_key(seed, 1u, row_base + i, col_base + j), drop, thresh,
              scale, acc, nullptr);
  const uint32_t key2 = cell_key(seed, 2u, row_base + i, col_base + j);
  float s = 0.f;
#pragma unroll
  for (int n = 0; n < H2; ++n) {
    float h2 = fmaxf(acc[n] + b2s[n], 0.f);
    if (drop) h2 = h2 * (fmix32(key2 ^ (uint32_t)n) >= thresh ? scale : 0.f);
    s += h2 * w3s[n];
  }
  if (i < nd && j < nv) out[(size_t)i * nv + j] = s;
}

__global__ void __launch_bounds__(NT) grid_bwd_kernel(
    const float* __restrict__ pd, const float* __restrict__ pv,
    const float* __restrict__ b1, const float* __restrict__ w2,
    const float* __restrict__ b2, const float* __restrict__ w3,
    const int* __restrict__ seed_ptr, const float* __restrict__ g,
    float* __restrict__ dpd_part,   // (F, n_jt, n_it * TI, H1)
    float* __restrict__ dpv_part,   // (F, n_split, n_jt * TJ, H1)
    float* __restrict__ db1_part,   // (F, n_blocks, H1)
    float* __restrict__ dw2_part,   // (F, n_blocks, H1, H2)
    float* __restrict__ db2_part,   // (F, n_blocks, H2)
    float* __restrict__ dw3_part,   // (F, n_blocks, H2)
    int nd, int nv, uint32_t thresh, float scale, int use_drop,
    int row_base, int col_base) {
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

  const int f = blockIdx.z, n_blk = n_split * n_jt;
  const uint32_t seed = (uint32_t)seed_ptr[f];
  pd += (size_t)f * nd * H1;
  pv += (size_t)f * nv * H1;
  b1 += f * H1;
  w2 += f * H1 * H2;
  b2 += f * H2;
  w3 += f * H2;
  g += (size_t)f * nd * nv;
  dpd_part += (size_t)f * n_jt * nd_pad * H1;
  dpv_part += (size_t)f * n_split * nv_pad * H1;
  db1_part += (size_t)f * n_blk * H1;
  dw2_part += (size_t)f * n_blk * H1 * H2;
  db2_part += (size_t)f * n_blk * H2;
  dw3_part += (size_t)f * n_blk * H2;

  for (int e = t; e < H1 * H2; e += NT) w2s[e] = w2[e];
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
      const uint32_t key1 = cell_key(seed, 1u, row_base + i, col_base + j);
      cell_layer1(pds + ti * H1, pvs + tj * LD1, b1s, w2s, key1, drop, thresh,
                  scale, acc, hbuf + t * LD1);
      const uint32_t key2 = cell_key(seed, 2u, row_base + i, col_base + j);
      const float gc = gs[t];
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
          red[(NT / 32 + warp) * H2 + n] = sdw3;
        }
        acc[n] = da2;
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
      const uint32_t key1 = cell_key(seed, 1u, row_base + i, col_base + j);
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

// ---------------------------------------------------------------------------
// The bf16 forward on the tensor cores (fwd_mma_rows, decoder_common.cuh).
// Warp w owns drug row w / 2 of a tile and the disease columns tj0 = 16 (w
// % 2) + gq and tj1 = tj0 + 8 of the block's 32 (lane = 4 gq + q): its
// rows c0 and c1.  A warp whose drug row lies past nd (the ragged last
// tile) skips the tile; a column past nv computes on the zero Pv row staged
// for it and is not written.
__global__ void __launch_bounds__(MT, FWD_RESIDENT) grid_fwd_mma_kernel(
    const float* __restrict__ pd, const float* __restrict__ pv,
    const float* __restrict__ b1, const float* __restrict__ w2,
    const float* __restrict__ b2, const float* __restrict__ w3,
    const int* __restrict__ seed_ptr, float* __restrict__ out, int nd, int nv,
    uint32_t thresh, float scale, int use_drop, int row_base,
    int col_base) {
  extern __shared__ float4 smem4[];
  __nv_bfloat16* w2s = reinterpret_cast<__nv_bfloat16*>(smem4);
  float* pvs = reinterpret_cast<float*>(w2s + H1 * LDW);
  float* b1s = pvs + TJ * LDP;
  float* b2s = b1s + H1;
  float* w3s = b2s + H2;

  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const int gq = lane >> 2, q = lane & 3;
  const int j0 = blockIdx.x * TJ, n_it = (nd + TI - 1) / TI;
  const int f = blockIdx.z;
  const bool drop = use_drop != 0;
  const uint32_t seed = (uint32_t)seed_ptr[f];
  pd += (size_t)f * nd * H1;
  pv += (size_t)f * nv * H1;
  b1 += f * H1;
  w2 += f * H1 * H2;
  b2 += f * H2;
  w3 += f * H2;
  out += (size_t)f * nd * nv;

  for (int e = t; e < H1 * H2 / 2; e += MT) {
    const int k = e / (H2 / 2), n = 2 * (e % (H2 / 2));
    const float2 v = *reinterpret_cast<const float2*>(w2 + k * H2 + n);
    *reinterpret_cast<uint32_t*>(w2s + k * LDW + n) = pack_bf16(v.x, v.y);
  }
  for (int e = t; e < TJ * H1; e += MT) {
    const int r = e / H1, k = e % H1, j = j0 + r;
    pvs[r * LDP + k] = j < nv ? pv[(size_t)j * H1 + k] : 0.f;
  }
  if (t < H1) b1s[t] = b1[t];
  if (t < H2) {
    b2s[t] = b2[t];
    w3s[t] = w3[t];
  }
  __syncthreads();

  const int ti = warp / 2, tj0 = 16 * (warp % 2) + gq, tj1 = tj0 + 8;
  const int jc0 = j0 + tj0, jc1 = j0 + tj1;
  const float* pv0 = pvs + tj0 * LDP + 2 * q;
  const float* pv1 = pvs + tj1 * LDP + 2 * q;
  const float* b1q = b1s + 2 * q;
  for (int it = blockIdx.y; it < n_it; it += gridDim.y) {
    const int i = it * TI + ti;
    if (i >= nd) continue;
    const int gi = row_base + i, g0 = col_base + jc0, g1 = col_base + jc1;
    const uint32_t key1[2] = {drop ? cell_key(seed, 1u, gi, g0) : 0u,
                              drop ? cell_key(seed, 1u, gi, g1) : 0u};
    const uint32_t key2[2] = {drop ? cell_key(seed, 2u, gi, g0) : 0u,
                              drop ? cell_key(seed, 2u, gi, g1) : 0u};
    // The drug row's values at the thread's units of the next k-step.
    const float* pdr = pd + (size_t)i * H1 + 2 * q;
    float2 nxt[2] = {*reinterpret_cast<const float2*>(pdr),
                     *reinterpret_cast<const float2*>(pdr + 8)};
    auto a1_at = [&](int ks, float4(&x)[2]) {
      const float2 cur[2] = {nxt[0], nxt[1]};
      if (ks + 1 < H1 / 16) {
        nxt[0] = *reinterpret_cast<const float2*>(pdr + 16 * (ks + 1));
        nxt[1] = *reinterpret_cast<const float2*>(pdr + 16 * (ks + 1) + 8);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = 16 * ks + 8 * h;
        x[h] = pair_a1<false>(cur[h], *reinterpret_cast<const float2*>(pv0 + k), cur[h],
                              *reinterpret_cast<const float2*>(pv1 + k),
                              *reinterpret_cast<const float2*>(b1q + k));
      }
    };
    const float2 s = fwd_mma_rows(a1_at, w2s, b2s, w3s, key1, key2, drop, thresh, scale,
                                  lane);
    float* orow = out + (size_t)i * nv;
    if (q == 0 && jc0 < nv) orow[jc0] = s.x;
    if (q == 1 && jc1 < nv) orow[jc1] = s.y;
  }
}

// ---------------------------------------------------------------------------
// The bf16 backward on the tensor cores (helpers in decoder_common.cuh).

// Fragment layout (mma m16n8k16): lane = 4 * gq + q.  An accumulator tile
// holds rows gq and gq + 8 at columns 2q, 2q + 1; an A fragment the same
// rows at columns 2q, 2q + 1 and 2q + 8, 2q + 9.  Over all its tiles a
// thread of warp w so holds cells c0 = 16 w + gq and c1 = c0 + 8 of the
// tile (drug row w / 2, disease columns 16 (w % 2) + gq and + 8), and of
// each 128-unit row the units 8 m + 2 q + e, m < 16, e < 2, which it
// indexes as 2 m + e.
__global__ void __launch_bounds__(MT, 1) grid_bwd_mma_kernel(
    const float* __restrict__ pd, const float* __restrict__ pv,
    const float* __restrict__ b1, const float* __restrict__ w2,
    const float* __restrict__ b2, const float* __restrict__ w3,
    const int* __restrict__ seed_ptr, const float* __restrict__ g,
    float* __restrict__ dpd_part, float* __restrict__ dpv_part,
    float* __restrict__ db1_part, float* __restrict__ dw2_part,
    float* __restrict__ db2_part, float* __restrict__ dw3_part,
    int nd, int nv, uint32_t thresh, float scale, int use_drop,
    int row_base, int col_base) {
  extern __shared__ float4 smem4[];
  __nv_bfloat16* w2s = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* h1s = w2s + H1 * LDW;
  __nv_bfloat16* da2s = h1s + NT * LDH;
  float* pvs = reinterpret_cast<float*>(da2s + NT * LDW);
  float* pds = pvs + TJ * LDP;
  float* b1s = pds + TI * H1;
  float* b2s = b1s + H1;
  float* w3s = b2s + H2;
  float* gs = w3s + H2;
  float* red = gs + NT;                   // [MW][H1]
  float* wmx = red + MW * H1;
  float* fixv = wmx + 1 + threadIdx.x * FIX_LD;

  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const int gq = lane >> 2, q = lane & 3;
  const int mi = lane >> 3, mr = lane & 7;   // ldmatrix: matrix and row
  const int jt = blockIdx.x, n_jt = gridDim.x;
  const int split = blockIdx.y, n_split = gridDim.y;
  const int n_it = (nd + TI - 1) / TI;
  const int nd_pad = n_it * TI, nv_pad = n_jt * TJ;
  const int j0 = jt * TJ;
  const bool drop = use_drop != 0;

  const int f = blockIdx.z, n_blk = n_split * n_jt;
  const uint32_t seed = (uint32_t)seed_ptr[f];
  pd += (size_t)f * nd * H1;
  pv += (size_t)f * nv * H1;
  b1 += f * H1;
  w2 += f * H1 * H2;
  b2 += f * H2;
  w3 += f * H2;
  g += (size_t)f * nd * nv;
  dpd_part += (size_t)f * n_jt * nd_pad * H1;
  dpv_part += (size_t)f * n_split * nv_pad * H1;
  db1_part += (size_t)f * n_blk * H1;
  dw2_part += (size_t)f * n_blk * H1 * H2;
  db2_part += (size_t)f * n_blk * H2;
  dw3_part += (size_t)f * n_blk * H2;

  for (int e = t; e < H1 * H2 / 2; e += MT) {
    const int k = e / (H2 / 2), n = 2 * (e % (H2 / 2));
    const float2 v = *reinterpret_cast<const float2*>(w2 + k * H2 + n);
    *reinterpret_cast<uint32_t*>(w2s + k * LDW + n) = pack_bf16(v.x, v.y);
  }
  for (int e = t; e < TJ * H1; e += MT) {
    const int r = e / H1, k = e % H1, j = j0 + r;
    pvs[r * LDP + k] = j < nv ? pv[(size_t)j * H1 + k] : 0.f;
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

  const int ti = warp / 2, c0 = warp * 16 + gq, c1 = c0 + 8;
  const int tj0 = c0 % TJ, tj1 = tj0 + 8;
  const float* pv0 = pvs + tj0 * LDP;
  const float* pv1 = pvs + tj1 * LDP;
  float dw2acc[H2 / 8][4];      // dW2 rows 16 warp + gq (+ 8), columns 8 nt + 2 q + e
  float dpv0[32], dpv1[32];     // dPv rows tj0 and tj1, units 2 m + e
  float db2acc[2] = {0.f, 0.f}, dw3acc[2] = {0.f, 0.f};   // columns 8 gq + 2 q + e
#pragma unroll
  for (int nt = 0; nt < H2 / 8; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) dw2acc[nt][c] = 0.f;
#pragma unroll
  for (int x = 0; x < 32; ++x) dpv0[x] = dpv1[x] = 0.f;

  for (int it = split; it < n_it; it += n_split) {
    const int i0 = it * TI, i = i0 + ti;
    __syncthreads();   // the previous tile is done with pds, gs, h1s, da2s, red
    for (int e = t; e < TI * H1; e += MT) {
      const int r = e / H1, k = e % H1;
      pds[e] = i0 + r < nd ? pd[(size_t)(i0 + r) * H1 + k] : 0.f;
    }
    if (t < NT) {
      const int ci = i0 + t / TJ, cj = j0 + t % TJ;
      gs[t] = (ci < nd && cj < nv) ? g[(size_t)ci * nv + cj] : 0.f;
    }
    __syncthreads();

    // a2 = rnd(h1d) @ rnd(w2), with h1d formed in the A fragments; the
    // da1 gate (a1 > 0 and the m1 keep bit) of each unit is kept in gate0
    // / gate1 for rows c0 / c1.  Each k-step's product starts from 0 and is
    // added in f32: an mma that carries the sum of earlier steps rounds it
    // to fewer bits.  hs0 / hs1 sum the rows' h1d, which bounds |a2 - b2|
    // over max |w2|.
    uint32_t gate0 = 0u, gate1 = 0u;
    float hs0 = 0.f, hs1 = 0.f;
    float acc[H2 / 8][4];
#pragma unroll
    for (int nt = 0; nt < H2 / 8; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[nt][c] = 0.f;
    {
      const uint32_t key0 = cell_key(seed, 1u, row_base + i, col_base + j0 + tj0);
      const uint32_t key1 = cell_key(seed, 1u, row_base + i, col_base + j0 + tj1);
      const float* pdr = pds + ti * H1;
#pragma unroll 1
      for (int ks = 0; ks < H1 / 16; ++ks) {
        uint32_t a[4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = 2 * ks + h, k = 8 * m + 2 * q;
          const float2 pdv = *reinterpret_cast<const float2*>(pdr + k);
          const float2 bv = *reinterpret_cast<const float2*>(b1s + k);
          const float2 p0 = *reinterpret_cast<const float2*>(pv0 + k);
          const float2 p1 = *reinterpret_cast<const float2*>(pv1 + k);
          const float x[4] = {(pdv.x + p0.x) + bv.x, (pdv.y + p0.y) + bv.y,
                              (pdv.x + p1.x) + bv.x, (pdv.y + p1.y) + bv.y};
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
    }
    __syncwarp();   // h1s holds the warp's 16 rows for seq_a2

    // On the accumulator: a2 = acc + b2 (taken again in the plain version's
    // order where it is near a step), h2d, da2 = (a2 > 0) * g * w3 * m2, the
    // db2 and dw3 sums, and rnd(da2) as the A fragments of dh1 and into
    // da2s for dW2.
    uint32_t da[H2 / 16][4];
    {
      const uint32_t key0 = cell_key(seed, 2u, row_base + i, col_base + j0 + tj0);
      const uint32_t key1 = cell_key(seed, 2u, row_base + i, col_base + j0 + tj1);
      const float mk = drop ? scale : 1.f;
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
            fix |= kp && near_step(a2, mk, band[r]) ? 1u << v : 0u;
          }
        }
      }
      // The flagged values in the plain version's order, one lane each.
      for (uint32_t todo = fix; todo != 0u; todo &= todo - 1u) {
        const int v = __ffs((int)todo) - 1, nt = v >> 2, e = (v >> 1) & 1, r = v & 1;
        fixv[v] = seq_a2(h1s + (r == 0 ? c0 : c1) * LDH, w2s + 8 * nt + 2 * q + e) +
                  b2s[8 * nt + 2 * q + e];
      }
      const float gc[2] = {gs[c0], gs[c1]};
      const float gr[2] = {rnd<true>(gc[0]), rnd<true>(gc[1])};
      float sdb[16], sdw[16];
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
    }
    __syncthreads();   // h1s and da2s hold the whole tile

    // dW2 rows 16 warp .. + 15 += rnd(h1d)^T @ rnd(da2) over the tile's cells.
#pragma unroll
    for (int ks = 0; ks < NT / 16; ++ks) {
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

    // dh1 = rnd(da2) @ rnd(w2)^T in two halves of 64 units; da1 = gate *
    // dh1 (* scale with dropout) into the dPv rows and the dPd sums.
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
          mma_bf16(acc3[2 * up], da[ks], b[0], b[1]);
          mma_bf16(acc3[2 * up + 1], da[ks], b[2], b[3]);
        }
      }
      float v[16];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int x = 2 * (8 * half + nt) + e;
          float s0 = acc3[nt][e], s1 = acc3[nt][2 + e];
          if (drop) {
            s0 = s0 * scale;
            s1 = s1 * scale;
          }
          const float d0 = (gate0 >> x) & 1u ? s0 : 0.f;
          const float d1 = (gate1 >> x) & 1u ? s1 : 0.f;
          dpv0[x] += d0;
          dpv1[x] += d1;
          v[2 * nt + e] = d0 + d1;
        }
      }
      row_sum(v, lane);   // v[e]: units 64 half + 8 gq + 2 q + e
      *reinterpret_cast<float2*>(red + warp * H1 + 64 * half + 8 * gq + 2 * q) =
          make_float2(v[0], v[1]);
    }
    __syncthreads();

    // dPd rows of this tile: the two warps of each drug row.
    for (int e = t; e < TI * H1; e += MT) {
      const int r = e / H1, k = e % H1;
      dpd_part[((size_t)jt * nd_pad + i0 + r) * H1 + k] =
          red[2 * r * H1 + k] + red[(2 * r + 1) * H1 + k];
    }
  }
  __syncthreads();

  // dPv: the four warps of each column half add their rows in drug-row
  // order into h1s, reused as a (TJ, H1) f32 tile; db1 sums it over TJ.
  const int blk = split * n_jt + jt;
  float* pvacc = reinterpret_cast<float*>(h1s);
#pragma unroll 1
  for (int r = 0; r < TI; ++r) {
    if (ti == r) {
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        const int k = 8 * (x >> 1) + 2 * q + (x & 1);
        float* p0 = pvacc + tj0 * H1 + k;
        float* p1 = pvacc + tj1 * H1 + k;
        *p0 = r == 0 ? dpv0[x] : *p0 + dpv0[x];
        *p1 = r == 0 ? dpv1[x] : *p1 + dpv1[x];
      }
    }
    __syncthreads();
  }
  for (int e = t; e < TJ * H1; e += MT) {
    const int r = e / H1, k = e % H1;
    dpv_part[((size_t)split * nv_pad + j0 + r) * H1 + k] = pvacc[e];
  }
  if (t < H1) {
    float s = 0.f;
    for (int r = 0; r < TJ; ++r) s += pvacc[r * H1 + t];
    db1_part[(size_t)blk * H1 + t] = s;
  }
  float* dw2b = dw2_part + (size_t)blk * H1 * H2;
#pragma unroll
  for (int nt = 0; nt < H2 / 8; ++nt) {
    const int n = 8 * nt + 2 * q;
    *reinterpret_cast<float2*>(dw2b + (16 * warp + gq) * H2 + n) =
        make_float2(dw2acc[nt][0], dw2acc[nt][1]);
    *reinterpret_cast<float2*>(dw2b + (16 * warp + gq + 8) * H2 + n) =
        make_float2(dw2acc[nt][2], dw2acc[nt][3]);
  }
  // db2, dw3: each warp holds all 64 columns; add the warps in order.
  *reinterpret_cast<float2*>(red + warp * 2 * H2 + 8 * gq + 2 * q) =
      make_float2(db2acc[0], db2acc[1]);
  *reinterpret_cast<float2*>(red + warp * 2 * H2 + H2 + 8 * gq + 2 * q) =
      make_float2(dw3acc[0], dw3acc[1]);
  __syncthreads();
  if (t < 2 * H2) {
    float s = 0.f;
    for (int w = 0; w < MW; ++w) s += red[w * 2 * H2 + t];
    if (t < H2)
      db2_part[(size_t)blk * H2 + t] = s;
    else
      dw3_part[(size_t)blk * H2 + t - H2] = s;
  }
}

// The backward's split of the drug tiles: whole waves of blocks (see
// wave_split), one block an SM for both dtypes (the fp32 block by its
// shared memory, the bf16 block by its registers: its threads keep dW2 and
// their dPv rows in registers across tiles).  For one fold at Gdataset width (n_jt = 10) it is 13, one
// wave of 130 blocks; for 10 folds it is 5, 500 blocks in 4 waves, where a
// split of 1 would leave 32 of 132 SMs idle through the whole kernel.
int bwd_split(int n_it, int n_jt, int nf) {
  return wave_split(n_it, (long)nf * n_jt);
}

// The bf16 forward's split of the drug tiles: whole waves of two blocks an
// SM (wave_split).  For one fold at Gdataset width (n_jt = 10, n_it = 149)
// it is 26, 260 blocks of 5 or 6 tiles; for 10 folds it is 5, 500 blocks
// of 29 or 30 tiles.
int fwd_split(int n_it, int n_jt, int nf) {
  return wave_split(n_it, (long)nf * n_jt, FWD_BLOCKS);
}

// bf16 runs the forward on the tensor cores, fp32 on the CUDA cores.
int launch_fwd(const float* pd, const float* pv, const float* b1,
               const float* w2, const float* b2, const float* w3,
               const int* seed, float* out, int nf, int nd, int nv,
               unsigned int thresh, float scale, int use_drop, int bf16,
               int row_base, int col_base, void* stream) {
  const int n_jt = (nv + TJ - 1) / TJ, n_it = (nd + TI - 1) / TI;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    const dim3 grid(n_jt, fwd_split(n_it, n_jt, nf), nf);
    grid_fwd_mma_kernel<<<grid, MT, FWD_MMA_SMEM, s>>>(pd, pv, b1, w2, b2, w3, seed, out,
                                                       nd, nv, thresh, scale, use_drop,
                                                       row_base, col_base);
  } else {
    const cudaError_t err = prepare(grid_fwd_kernel, FWD_SMEM);
    if (err != cudaSuccess) return (int)err;
    grid_fwd_kernel<<<dim3(n_jt, n_it, nf), NT, FWD_SMEM * sizeof(float), s>>>(
        pd, pv, b1, w2, b2, w3, seed, out, nd, nv, thresh, scale, use_drop,
        row_base, col_base);
  }
  return (int)cudaGetLastError();
}

int launch_bwd(const float* pd, const float* pv, const float* b1,
               const float* w2, const float* b2, const float* w3,
               const int* seed, const float* g, float* dpd_part,
               float* dpv_part, float* db1_part, float* dw2_part,
               float* db2_part, float* dw3_part, int nf, int nd, int nv,
               unsigned int thresh, float scale, int use_drop, int bf16,
               int row_base, int col_base, void* stream) {
  const int n_jt = (nv + TJ - 1) / TJ;
  const dim3 grid(n_jt, bwd_split((nd + TI - 1) / TI, n_jt, nf), nf);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bf16) {
    err = prepare(grid_bwd_mma_kernel, MMA_SMEM / (int)sizeof(float));
    if (err != cudaSuccess) return (int)err;
    grid_bwd_mma_kernel<<<grid, MT, MMA_SMEM, s>>>(
        pd, pv, b1, w2, b2, w3, seed, g, dpd_part, dpv_part, db1_part, dw2_part,
        db2_part, dw3_part, nd, nv, thresh, scale, use_drop, row_base, col_base);
  } else {
    err = prepare(grid_bwd_kernel, BWD_SMEM);
    if (err != cudaSuccess) return (int)err;
    grid_bwd_kernel<<<grid, NT, BWD_SMEM * sizeof(float), s>>>(
        pd, pv, b1, w2, b2, w3, seed, g, dpd_part, dpv_part, db1_part, dw2_part,
        db2_part, dw3_part, nd, nv, thresh, scale, use_drop, row_base, col_base);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Layout of the backward's partial slabs for nf folds of an nd x nv grid,
// which the caller allocates and sums over their second axis:
//   dpd_part (nf, n_jt, nd_pad, H1), dpv_part (nf, n_split, nv_pad, H1),
//   db1/dw2/db2/dw3 parts (nf, n_split * n_jt, ...).
// layout[] receives {n_jt, n_split, nd_pad, nv_pad}.
void grid_decoder_bwd_layout_batched(int nf, int nd, int nv, int* layout) {
  const int n_it = (nd + TI - 1) / TI, n_jt = (nv + TJ - 1) / TJ;
  layout[0] = n_jt;
  layout[1] = bwd_split(n_it, n_jt, nf);
  layout[2] = n_it * TI;
  layout[3] = n_jt * TJ;
}

// Residency of the backward kernel of one dtype on one SM of this card:
// occ[] receives {blocks, warps a block}.  Returns 0 or the CUDA error.
int grid_decoder_bwd_occupancy(int bf16, int* occ) {
  cudaError_t err;
  int blocks = 0;
  if (bf16) {
    err = prepare(grid_bwd_mma_kernel, MMA_SMEM / (int)sizeof(float));
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, grid_bwd_mma_kernel,
                                                          MT, MMA_SMEM);
  } else {
    err = prepare(grid_bwd_kernel, BWD_SMEM);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, grid_bwd_kernel, NT,
                                                          BWD_SMEM * sizeof(float));
  }
  occ[0] = blocks;
  occ[1] = (bf16 ? MT : NT) / 32;
  return (int)err;
}

// Residency of the forward kernel of one dtype on one SM of this card:
// occ[] receives {blocks, warps a block}.  Returns 0 or the CUDA error.
int grid_decoder_fwd_occupancy(int bf16, int* occ) {
  cudaError_t err;
  int blocks = 0;
  if (bf16) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, grid_fwd_mma_kernel, MT,
                                                        FWD_MMA_SMEM);
  } else {
    err = prepare(grid_fwd_kernel, FWD_SMEM);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, grid_fwd_kernel, NT,
                                                          FWD_SMEM * sizeof(float));
  }
  occ[0] = blocks;
  occ[1] = (bf16 ? MT : NT) / 32;
  return (int)err;
}

// The single-fold layout: the batched one with nf = 1, without its fold axis.
void grid_decoder_bwd_layout(int nd, int nv, int* layout) {
  grid_decoder_bwd_layout_batched(1, nd, nv, layout);
}

int grid_decoder_fwd(const float* pd, const float* pv, const float* b1,
                     const float* w2, const float* b2, const float* w3,
                     const int* seed, float* out, int nd, int nv,
                     unsigned int thresh, float scale, int use_drop, int bf16,
                     int row_base, int col_base, void* stream) {
  return launch_fwd(pd, pv, b1, w2, b2, w3, seed, out, 1, nd, nv, thresh,
                    scale, use_drop, bf16, row_base, col_base, stream);
}

int grid_decoder_bwd(const float* pd, const float* pv, const float* b1,
                     const float* w2, const float* b2, const float* w3,
                     const int* seed, const float* g, float* dpd_part,
                     float* dpv_part, float* db1_part, float* dw2_part,
                     float* db2_part, float* dw3_part, int nd, int nv,
                     unsigned int thresh, float scale, int use_drop, int bf16,
                     int row_base, int col_base, void* stream) {
  return launch_bwd(pd, pv, b1, w2, b2, w3, seed, g, dpd_part, dpv_part,
                    db1_part, dw2_part, db2_part, dw3_part, 1, nd, nv, thresh,
                    scale, use_drop, bf16, row_base, col_base, stream);
}

// nf folds in one launch: pd (nf, nd, H1), pv (nf, nv, H1), b1 (nf, H1),
// w2 (nf, H1, H2), b2 (nf, H2), w3 (nf, H2), seed (nf,), out (nf, nd, nv).
int grid_decoder_fwd_batched(const float* pd, const float* pv, const float* b1,
                             const float* w2, const float* b2, const float* w3,
                             const int* seed, float* out, int nf, int nd, int nv,
                             unsigned int thresh, float scale, int use_drop,
                             int bf16, int row_base, int col_base, void* stream) {
  return launch_fwd(pd, pv, b1, w2, b2, w3, seed, out, nf, nd, nv, thresh,
                    scale, use_drop, bf16, row_base, col_base, stream);
}

// Its backward; g (nf, nd, nv), partial slabs as grid_decoder_bwd_layout_batched.
int grid_decoder_bwd_batched(const float* pd, const float* pv, const float* b1,
                             const float* w2, const float* b2, const float* w3,
                             const int* seed, const float* g, float* dpd_part,
                             float* dpv_part, float* db1_part, float* dw2_part,
                             float* db2_part, float* dw3_part, int nf, int nd,
                             int nv, unsigned int thresh, float scale,
                             int use_drop, int bf16, int row_base, int col_base,
                             void* stream) {
  return launch_bwd(pd, pv, b1, w2, b2, w3, seed, g, dpd_part, dpv_part,
                    db1_part, dw2_part, db2_part, dw3_part, nf, nd, nv, thresh,
                    scale, use_drop, bf16, row_base, col_base, stream);
}

}  // extern "C"

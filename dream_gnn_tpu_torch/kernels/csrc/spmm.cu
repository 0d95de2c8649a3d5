// Segmented row sums for Hopper (sm_90a): the encoder SpMMs and the scale
// decoder's table-gradient scatter.
//
// Replaces four Pallas TPU kernels, all of dream_gnn_tpu/kernels/:
// - _slab_kernel of pallas_spmm_slab.py (spmm_slab), the slabbed layout;
// - _spmm_gather_kernel of pallas_spmm_gather.py (spmm_gather), the grouped
//   layout, also the scale decoder's scatter when its layout has no
//   sequential scatter;
// - _spmm_kernel of pallas_spmm.py (spmm_blocked), the blocked layout:
//     out[n] = sum over the edges e into dst row n of val_e * x[src_e];
// - _seq_scatter_kernel of pallas_seq_scatter.py (seq_scatter):
//     out[n] = sum over the slots k of node n of val_k * x[k],
//   for a slot stream sorted by node.
// All are one segmented sum over a CSR ordering (graph/csr.py): row n owns
// the entries p = ptr[n] .. ptr[n+1]-1, and entry p reads row src[p] of x
// (GATHER, the SpMMs) or row p itself (the scatter, whose slots already lie
// in node order).  The TPU layouts' slabs, groups, windows and chunks exist
// for VMEM and the MXU and have no counterpart here.
//
// Rounding.  The Pallas kernels round their bf16 messages at different
// points, and MODE holds each (rnd rounds to bf16, sums are f32):
//   MODE_F32       x * val, in f32 (every kernel's fp32 mode);
//   MODE_RX        rnd(rnd(x) * val): the slab SpMM, which packs x into
//                  bf16 panels (pallas_spmm_slab.py:180-188), and the grouped
//                  SpMM with packed panels (pallas_spmm_gather.py:313-327 and
//                  270-272); the scatter, whose wrapper rounds val, as the
//                  Pallas kernel multiplies in bf16 (pallas_seq_scatter.py:
//                  179-180);
//   MODE_MSG       rnd(x * val): the grouped SpMM without packed panels (an
//                  odd d), which multiplies the f32 panel by val and rounds
//                  the message;
//   MODE_RX_RV     rnd(rnd(val) * rnd(x)): the blocked SpMM, whose weight
//                  rides the gather one-hot cast to bf16 (pallas_spmm.py:73,
//                  78-79).
// The wrappers hand x over in bf16 where the mode rounds it, which also
// halves the gathered bytes.  A null val weighs every entry 1 (the scale
// decoder's scatter, whose slots carry no weights): no weights are read,
// and rnd(rnd(x) * 1) = rnd(x) gives the same bits as a val of ones.
//
// What bounds it on an H100: bytes.  Per entry it reads a 4-byte index, a
// 4-byte weight and a row of x (256 bytes at d = 128 in bf16) and does 2d
// flops.  At the encoder's shapes x (100k x 128 bf16, 25.6 MB) fits in the
// 50 MB L2, so the least traffic is the indices and weights once, x once
// and out once; the scatter streams its rows of x in order.
//
// Design (simple first): one warp per row, which keeps x's random rows in
// L2 and reads the index stream once, in order.  Each lane owns VEC
// consecutive columns (VEC = 4 when d % 4 == 0: one 8-byte bf16 or 16-byte
// f32 load per entry and lane, so a warp reads a 128-wide row in one
// request); the warp loads 32 entries' indices and weights at once and
// broadcasts them with shuffles.  A row's entries are summed in CSR order in
// f32 by one warp, with no atomics, so two runs give the same bits.
//
// The entry point returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;            // rows per block
constexpr unsigned FULL = 0xffffffffu;
enum Mode { MODE_F32 = 0, MODE_RX = 1, MODE_MSG = 2, MODE_RX_RV = 3 };

__device__ __forceinline__ float rnd_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <int VEC>
__device__ __forceinline__ void load_row(const float* p, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  } else {
    v[0] = *p;
  }
}

template <int VEC>
__device__ __forceinline__ void load_row(const __nv_bfloat16* p, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
  } else {
    v[0] = __bfloat162float(*p);
  }
}

template <typename XT, int VEC, bool GATHER, int MODE>
__global__ void __launch_bounds__(WARPS * 32) segment_sum_kernel(
    const int* __restrict__ ptr, const int* __restrict__ src,
    const float* __restrict__ val, const XT* __restrict__ x,
    float* __restrict__ out, int n_rows, int d) {
  const int row = blockIdx.x * WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= n_rows) return;          // whole warps leave together
  const int p0 = ptr[row], p1 = ptr[row + 1];
  for (int cb = 0; cb < d; cb += 32 * VEC) {
    const int c = cb + lane * VEC;
    const bool active = c < d;        // with VEC = 4, d % 4 == 0: all or none
    float acc[VEC];
#pragma unroll
    for (int u = 0; u < VEC; ++u) acc[u] = 0.f;
    for (int base = p0; base < p1; base += 32) {
      const int p = base + lane;
      int s = 0;
      float v = 0.f;
      if (p < p1) {
        s = GATHER ? src[p] : p;
        v = val != nullptr ? val[p] : 1.f;
        if constexpr (MODE == MODE_RX_RV) v = rnd_bf16(v);
      }
      const int cnt = min(32, p1 - base);
#pragma unroll 4
      for (int q = 0; q < cnt; ++q) {
        const int sq = __shfl_sync(FULL, s, q);
        const float vq = __shfl_sync(FULL, v, q);
        if (active) {
          float xv[VEC];
          load_row<VEC>(x + (size_t)sq * d + c, xv);
#pragma unroll
          for (int u = 0; u < VEC; ++u) {
            if constexpr (MODE == MODE_F32) {
              acc[u] += xv[u] * vq;
            } else if constexpr (MODE == MODE_MSG) {
              acc[u] += rnd_bf16(xv[u] * vq);
            } else {
              acc[u] += rnd_bf16(rnd_bf16(xv[u]) * vq);
            }
          }
        }
      }
    }
    if (active) {
#pragma unroll
      for (int u = 0; u < VEC; ++u) out[(size_t)row * d + c + u] = acc[u];
    }
  }
}

template <typename XT, bool GATHER, int MODE>
cudaError_t launch(const int* ptr, const int* src, const float* val,
                   const void* x, float* out, int n_rows, int d,
                   cudaStream_t s) {
  const dim3 grid((n_rows + WARPS - 1) / WARPS), block(WARPS * 32);
  const XT* xt = static_cast<const XT*>(x);
  if (d % 4 == 0) {
    segment_sum_kernel<XT, 4, GATHER, MODE><<<grid, block, 0, s>>>(
        ptr, src, val, xt, out, n_rows, d);
  } else {
    segment_sum_kernel<XT, 1, GATHER, MODE><<<grid, block, 0, s>>>(
        ptr, src, val, xt, out, n_rows, d);
  }
  return cudaGetLastError();
}

template <typename XT, bool GATHER>
cudaError_t dispatch_mode(const int* ptr, const int* src, const float* val,
                          const void* x, float* out, int n_rows, int d,
                          int mode, cudaStream_t s) {
  switch (mode) {
    case MODE_F32:
      return launch<XT, GATHER, MODE_F32>(ptr, src, val, x, out, n_rows, d, s);
    case MODE_RX:
      return launch<XT, GATHER, MODE_RX>(ptr, src, val, x, out, n_rows, d, s);
    case MODE_MSG:
      return launch<XT, GATHER, MODE_MSG>(ptr, src, val, x, out, n_rows, d, s);
    case MODE_RX_RV:
      return launch<XT, GATHER, MODE_RX_RV>(ptr, src, val, x, out, n_rows, d, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename XT>
cudaError_t dispatch(const int* ptr, const int* src, const float* val,
                     const void* x, float* out, int n_rows, int d, int mode,
                     cudaStream_t s) {
  return src != nullptr
             ? dispatch_mode<XT, true>(ptr, src, val, x, out, n_rows, d, mode, s)
             : dispatch_mode<XT, false>(ptr, src, val, x, out, n_rows, d, mode, s);
}

}  // namespace

extern "C" {

// out (n_rows, d) f32 = the segmented sums above over ptr (n_rows + 1) int32,
// val (nnz,) f32 (null: every weight 1) and x (rows, d), bf16 when x_bf16
// else f32.  src (nnz,) int32 gathers row src[p] of x; a null src reads row
// p.  mode is the rounding (enum Mode above).
int segment_sum(const int* ptr, const int* src, const float* val,
                const void* x, float* out, int n_rows, int d, int x_bf16,
                int mode, void* stream) {
  if (n_rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(x_bf16 ? dispatch<__nv_bfloat16>(ptr, src, val, x, out, n_rows, d, mode, s)
                      : dispatch<float>(ptr, src, val, x, out, n_rows, d, mode, s));
}

}  // extern "C"

// Segmented row sums for Hopper (sm_90a): the scale path's encoder SpMM and
// the scale decoder's table-gradient scatter.
//
// Replaces two Pallas TPU kernels:
// - _slab_kernel of dream_gnn_tpu/kernels/pallas_spmm_slab.py (spmm_slab):
//     out[n] = sum over the edges e into dst row n of val_e * x[src_e];
// - _seq_scatter_kernel of dream_gnn_tpu/kernels/pallas_seq_scatter.py
//   (seq_scatter): out[n] = sum over the slots k of node n of val_k * x[k],
//   for a slot stream sorted by node.
// Both are one segmented sum over a CSR ordering: row n owns the entries
// p = ptr[n] .. ptr[n+1]-1, and entry p reads row src[p] of x (GATHER, the
// SpMM) or row p itself (the scatter, whose slots already lie in node order).
//
// Rounding.  With ROUND (the bf16 mode of both Pallas kernels) an entry's
// message is rnd(rnd(x) * val), rnd rounding to bf16, and the messages are
// summed in f32.  The SpMM's wrapper hands x over in bf16 (the Pallas kernel
// packs x into bf16 panels, pallas_spmm_slab.py:180-188; here it also halves
// the gathered bytes); the scatter's wrapper rounds val, which the Pallas
// kernel multiplies in bf16 (pallas_seq_scatter.py:179-180).  Without ROUND
// the message is x * val in f32.  A null val weighs every entry 1 (the scale
// decoder's scatter, whose slots carry no weights): no weights are read, and
// rnd(rnd(x) * 1) = rnd(x) gives the same bits as a val of ones.
//
// What bounds it on an H100: bytes.  Per entry it reads a 4-byte index, a
// 4-byte weight and a row of x (256 bytes at d = 128 in bf16) and does 2d
// flops.  At the scale path's shapes the SpMM's x (100k x 128 bf16, 25.6 MB)
// fits in the 50 MB L2, so the least traffic is the indices and weights
// once, x once and out once; the scatter streams its rows of x in order.
//
// Design (simple first): one warp per row.  Each lane owns VEC consecutive
// columns (VEC = 4 when d % 4 == 0: one 8-byte bf16 or 16-byte f32 load per
// entry and lane, so a warp reads a 128-wide row in one request); the warp
// loads 32 entries' indices and weights at once and broadcasts them with
// shuffles.  A row's entries are summed in CSR order in f32 by one warp, with
// no atomics, so two runs give the same bits.
//
// The entry point returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;            // rows per block
constexpr unsigned FULL = 0xffffffffu;

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

template <typename XT, int VEC, bool GATHER, bool ROUND>
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
            if constexpr (ROUND) {
              acc[u] += rnd_bf16(rnd_bf16(xv[u]) * vq);
            } else {
              acc[u] += xv[u] * vq;
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

template <typename XT, bool GATHER, bool ROUND>
cudaError_t launch(const int* ptr, const int* src, const float* val,
                   const void* x, float* out, int n_rows, int d,
                   cudaStream_t s) {
  const dim3 grid((n_rows + WARPS - 1) / WARPS), block(WARPS * 32);
  const XT* xt = static_cast<const XT*>(x);
  if (d % 4 == 0) {
    segment_sum_kernel<XT, 4, GATHER, ROUND><<<grid, block, 0, s>>>(
        ptr, src, val, xt, out, n_rows, d);
  } else {
    segment_sum_kernel<XT, 1, GATHER, ROUND><<<grid, block, 0, s>>>(
        ptr, src, val, xt, out, n_rows, d);
  }
  return cudaGetLastError();
}

template <typename XT>
cudaError_t dispatch(const int* ptr, const int* src, const float* val,
                     const void* x, float* out, int n_rows, int d, int round,
                     cudaStream_t s) {
  if (src != nullptr) {
    return round ? launch<XT, true, true>(ptr, src, val, x, out, n_rows, d, s)
                 : launch<XT, true, false>(ptr, src, val, x, out, n_rows, d, s);
  }
  return round ? launch<XT, false, true>(ptr, src, val, x, out, n_rows, d, s)
               : launch<XT, false, false>(ptr, src, val, x, out, n_rows, d, s);
}

}  // namespace

extern "C" {

// out (n_rows, d) f32 = the segmented sums above over ptr (n_rows + 1) int32,
// val (nnz,) f32 (null: every weight 1) and x (rows, d), bf16 when x_bf16
// else f32.  src (nnz,) int32 gathers row src[p] of x; a null src reads row
// p.  round selects the bf16 messages.
int segment_sum(const int* ptr, const int* src, const float* val,
                const void* x, float* out, int n_rows, int d, int x_bf16,
                int round, void* stream) {
  if (n_rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(x_bf16 ? dispatch<__nv_bfloat16>(ptr, src, val, x, out, n_rows, d, round, s)
                      : dispatch<float>(ptr, src, val, x, out, n_rows, d, round, s));
}

}  // extern "C"

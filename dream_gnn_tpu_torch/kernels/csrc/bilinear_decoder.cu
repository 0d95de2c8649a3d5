// The GCMC bilinear decoder with a basis (van den Berg et al., arXiv:1706.02263
// eq. 5-6; DGL's examples/pytorch/gcmc BiDecoder) for Hopper (sm_90a), in
// float32 on the CUDA cores.
//
// Per rating e of user i and movie j, with B basis matrices P_b (D x D) and
// the (R x B) combination a:
//     s_b(e)   = u_i^T P_b v_j = UP[i, b, :] . V[j, :]      (UP = u P, a GEMM)
//     l_r(e)   = sum_b a[r, b] s_b(e)                       (the R logits)
// and its backward from the logits' cotangent g (R, E):
//     ds_b(e)  = sum_r a[r, b] g_r(e)
//     da[r, b] = sum_e g_r(e) s_b(e)
//     dUP[i, b, :] = sum_{e of user i} ds_b(e) V[j(e), :]
//     W[j, b, :]   = sum_{e of movie j} ds_b(e) u[i(e), :]
// from which the wrapper makes du = dUP P^T, dP = u^T dUP and dv = W P with
// dense products (kernels/bilinear_decoder.py).
//
// The ratings come in slot order, sorted by user.  The forward gives each
// warp a chunk of 32 slots; the lanes split D (lane l holds columns l, l+32,
// l+64, l+96), keep UP's row of the current user in registers and gather one
// V row (D floats) a slot.  The B partial dots are reduced over the warp by
// a transposed butterfly (B = 4: 6 shuffles and 4 broadcasts, not 20) and
// lane t keeps slot t's B sums, so that the logits leave in coalesced
// (R, 32) stores.
//
// Backward.  No per-rating f32 row buffer: the node sums run over tasks, each
// a run of at most TASK consecutive ratings of one node (a user in slot
// order, a movie in the movie order of the layout), so that a movie with tens
// of thousands of ratings is spread over many warps.  Each task writes its
// partial row; task_sum_kernel adds a node's partial rows in task order.
// Every sum runs in a fixed order (the slots of a task one by one,
// butterflies, tasks in order, the da partials of each warp summed by the
// wrapper in a fixed order), so two launches give the same bits.  The user
// pass also writes ds (E, B), B floats a rating, which the movie pass
// gathers through its permutation.
//
// What bounds it.  Forward: per rating a 4-byte user and movie id, a V row
// (300 bytes at D = 75, V is 3.2 MB and stays in L2) and R logits out; UP is
// read once per user (84 MB).  Backward: the cotangent (R floats) and ds in
// and out, a V row (user pass) and a u row (movie pass, u is 21 MB) a
// rating, and the partial rows.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARP = 32;
constexpr int WARPS = 8;          // warps a block
constexpr int QMAX = 4;           // D <= 128
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ constexpr int log2i(int b) { return b > 1 ? 1 + log2i(b / 2) : 0; }

// Sums x[0..B) over the warp (B a power of two).  Returns, in every lane,
// the B totals in out[0..B), in a fixed order of additions.  The first
// log2(B) butterfly levels halve the values a lane carries (a lane keeps the
// half its lane bit selects and sends the other), the rest reduce one value;
// the total of b then lives in the lanes whose top log2(B) bits are b.
template <int B>
__device__ __forceinline__ void warp_sums(float (&x)[B], float (&out)[B]) {
  const int lane = threadIdx.x & (WARP - 1);
  int offset = WARP / 2;
#pragma unroll
  for (int c = B; c > 1; c /= 2, offset /= 2) {
    const bool hi = (lane & offset) != 0;
#pragma unroll
    for (int i = 0; i < c / 2; ++i) {
      const float keep = hi ? x[i + c / 2] : x[i];
      const float send = hi ? x[i] : x[i + c / 2];
      x[i] = keep + __shfl_xor_sync(FULL, send, offset);
    }
  }
  for (; offset > 0; offset /= 2) x[0] += __shfl_xor_sync(FULL, x[0], offset);
  constexpr int shift = 5 - log2i(B);
#pragma unroll
  for (int b = 0; b < B; ++b) out[b] = __shfl_sync(FULL, x[0], b << shift);
}

// Logits (R, E) of the slots in user order.
template <int R, int B>
__global__ void __launch_bounds__(WARPS * WARP)
bilinear_fwd_kernel(const float* __restrict__ up, const float* __restrict__ v,
                    const float* __restrict__ a, const int* __restrict__ src,
                    const int* __restrict__ dst, float* __restrict__ logits,
                    int64_t n_edges, int d) {
  const int lane = threadIdx.x & (WARP - 1);
  const int64_t chunk = (int64_t)blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int64_t p0 = chunk * WARP;
  if (p0 >= n_edges) return;
  const int n = (int)min((int64_t)WARP, n_edges - p0);
  const int my_i = lane < n ? src[p0 + lane] : -1;
  const int my_j = lane < n ? dst[p0 + lane] : 0;
  float row[B][QMAX];
  float mine[B];
#pragma unroll
  for (int b = 0; b < B; ++b) mine[b] = 0.f;
  int cur = -1;
  for (int t = 0; t < n; ++t) {
    const int i = __shfl_sync(FULL, my_i, t);
    const int j = __shfl_sync(FULL, my_j, t);
    if (i != cur) {
      cur = i;
      const float* r = up + (int64_t)i * B * d;
#pragma unroll
      for (int b = 0; b < B; ++b)
#pragma unroll
        for (int q = 0; q < QMAX; ++q) {
          const int k = lane + q * WARP;
          row[b][q] = k < d ? __ldg(r + b * d + k) : 0.f;
        }
    }
    const float* vr = v + (int64_t)j * d;
    float part[B];
#pragma unroll
    for (int b = 0; b < B; ++b) part[b] = 0.f;
#pragma unroll
    for (int q = 0; q < QMAX; ++q) {
      const int k = lane + q * WARP;
      const float x = k < d ? __ldg(vr + k) : 0.f;
#pragma unroll
      for (int b = 0; b < B; ++b) part[b] = fmaf(row[b][q], x, part[b]);
    }
    float s[B];
    warp_sums<B>(part, s);
    if (lane == t) {
#pragma unroll
      for (int b = 0; b < B; ++b) mine[b] = s[b];
    }
  }
  if (lane < n) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float l = 0.f;
#pragma unroll
      for (int b = 0; b < B; ++b) l = fmaf(__ldg(a + r * B + b), mine[b], l);
      logits[(int64_t)r * n_edges + p0 + lane] = l;
    }
  }
}

// The user pass: per task (a run of one user's slots), the partial row of
// dUP (B x D) into part[task]; ds (E, B) of every slot; da partials a warp.
template <int R, int B>
__global__ void __launch_bounds__(WARPS * WARP)
bilinear_bwd_user_kernel(const float* __restrict__ g, const float* __restrict__ up,
                         const float* __restrict__ v, const float* __restrict__ a,
                         const int* __restrict__ dst, const int* __restrict__ task_node,
                         const int* __restrict__ task_beg, int n_tasks,
                         int64_t n_edges, int d, float* __restrict__ part,
                         float* __restrict__ ds_out, float* __restrict__ da_part) {
  const int lane = threadIdx.x & (WARP - 1);
  const int warp = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int n_warps = gridDim.x * WARPS;
  float da[R * B];
#pragma unroll
  for (int x = 0; x < R * B; ++x) da[x] = 0.f;
  for (int task = warp; task < n_tasks; task += n_warps) {
    const int node = task_node[task];
    const int64_t beg = task_beg[task], end = task_beg[task + 1];
    const float* r0 = up + (int64_t)node * B * d;
    float row[B][QMAX], acc[B][QMAX];
#pragma unroll
    for (int b = 0; b < B; ++b)
#pragma unroll
      for (int q = 0; q < QMAX; ++q) {
        const int k = lane + q * WARP;
        row[b][q] = k < d ? __ldg(r0 + b * d + k) : 0.f;
        acc[b][q] = 0.f;
      }
    for (int64_t p0 = beg; p0 < end; p0 += WARP) {
      const int n = (int)min((int64_t)WARP, end - p0);
      float my_g[R], my_ds[B], mine[B];
      int my_j = 0;
#pragma unroll
      for (int b = 0; b < B; ++b) my_ds[b] = mine[b] = 0.f;
#pragma unroll
      for (int r = 0; r < R; ++r) my_g[r] = 0.f;
      if (lane < n) {
        my_j = dst[p0 + lane];
#pragma unroll
        for (int r = 0; r < R; ++r) my_g[r] = g[(int64_t)r * n_edges + p0 + lane];
#pragma unroll
        for (int b = 0; b < B; ++b) {
          float s = 0.f;
#pragma unroll
          for (int r = 0; r < R; ++r) s = fmaf(__ldg(a + r * B + b), my_g[r], s);
          my_ds[b] = s;
          ds_out[(p0 + lane) * B + b] = s;
        }
      }
      for (int t = 0; t < n; ++t) {
        const int j = __shfl_sync(FULL, my_j, t);
        float dsb[B], part_s[B];
#pragma unroll
        for (int b = 0; b < B; ++b) {
          dsb[b] = __shfl_sync(FULL, my_ds[b], t);
          part_s[b] = 0.f;
        }
        const float* vr = v + (int64_t)j * d;
#pragma unroll
        for (int q = 0; q < QMAX; ++q) {
          const int k = lane + q * WARP;
          const float x = k < d ? __ldg(vr + k) : 0.f;
#pragma unroll
          for (int b = 0; b < B; ++b) {
            part_s[b] = fmaf(row[b][q], x, part_s[b]);
            acc[b][q] = fmaf(dsb[b], x, acc[b][q]);
          }
        }
        float s[B];
        warp_sums<B>(part_s, s);
        if (lane == t) {
#pragma unroll
          for (int b = 0; b < B; ++b) mine[b] = s[b];
        }
      }
      if (lane < n) {
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int b = 0; b < B; ++b) da[r * B + b] = fmaf(my_g[r], mine[b], da[r * B + b]);
      }
    }
    float* out = part + (int64_t)task * B * d;
#pragma unroll
    for (int b = 0; b < B; ++b)
#pragma unroll
      for (int q = 0; q < QMAX; ++q) {
        const int k = lane + q * WARP;
        if (k < d) out[b * d + k] = acc[b][q];
      }
  }
  // The warp's da: each value summed over the lanes by a butterfly.
#pragma unroll
  for (int x = 0; x < R * B; ++x) {
    float y = da[x];
#pragma unroll
    for (int o = WARP / 2; o > 0; o /= 2) y += __shfl_xor_sync(FULL, y, o);
    if (lane == 0) da_part[(int64_t)warp * R * B + x] = y;
  }
}

// The movie pass: per task (a run of one movie's ratings in the layout's
// movie order), the partial row of W (B x D) into part[task].
template <int B>
__global__ void __launch_bounds__(WARPS * WARP)
bilinear_bwd_movie_kernel(const float* __restrict__ ds, const float* __restrict__ u,
                          const int* __restrict__ perm, const int* __restrict__ m_src,
                          const int* __restrict__ task_beg, int n_tasks, int d,
                          float* __restrict__ part) {
  const int lane = threadIdx.x & (WARP - 1);
  const int task = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (task >= n_tasks) return;
  const int64_t beg = task_beg[task], end = task_beg[task + 1];
  float acc[B][QMAX];
#pragma unroll
  for (int b = 0; b < B; ++b)
#pragma unroll
    for (int q = 0; q < QMAX; ++q) acc[b][q] = 0.f;
  for (int64_t p0 = beg; p0 < end; p0 += WARP) {
    const int n = (int)min((int64_t)WARP, end - p0);
    int my_i = 0;
    float my_ds[B];
#pragma unroll
    for (int b = 0; b < B; ++b) my_ds[b] = 0.f;
    if (lane < n) {
      const int64_t e = perm[p0 + lane];
      my_i = m_src[p0 + lane];
#pragma unroll
      for (int b = 0; b < B; ++b) my_ds[b] = ds[e * B + b];
    }
    for (int t = 0; t < n; ++t) {
      const int i = __shfl_sync(FULL, my_i, t);
      float dsb[B];
#pragma unroll
      for (int b = 0; b < B; ++b) dsb[b] = __shfl_sync(FULL, my_ds[b], t);
      const float* ur = u + (int64_t)i * d;
#pragma unroll
      for (int q = 0; q < QMAX; ++q) {
        const int k = lane + q * WARP;
        const float x = k < d ? __ldg(ur + k) : 0.f;
#pragma unroll
        for (int b = 0; b < B; ++b) acc[b][q] = fmaf(dsb[b], x, acc[b][q]);
      }
    }
  }
  float* out = part + (int64_t)task * B * d;
#pragma unroll
  for (int b = 0; b < B; ++b)
#pragma unroll
    for (int q = 0; q < QMAX; ++q) {
      const int k = lane + q * WARP;
      if (k < d) out[b * d + k] = acc[b][q];
    }
}

// out[n, :] = the sum of part[t, :] over node n's tasks t = tptr[n] ..
// tptr[n+1]-1, in task order (0 for a node without tasks).
__global__ void task_sum_kernel(const float* __restrict__ part,
                                const int* __restrict__ tptr, int n_nodes,
                                int width, float* __restrict__ out) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (int64_t)n_nodes * width) return;
  const int node = (int)(idx / width), c = (int)(idx % width);
  float s = 0.f;
  for (int t = tptr[node]; t < tptr[node + 1]; ++t) s += part[(int64_t)t * width + c];
  out[idx] = s;
}

template <int R, int B>
int fwd(const float* up, const float* v, const float* a, const int* src,
        const int* dst, float* logits, int64_t n_edges, int d, cudaStream_t s) {
  const int64_t chunks = (n_edges + WARP - 1) / WARP;
  const int64_t blocks = (chunks + WARPS - 1) / WARPS;
  bilinear_fwd_kernel<R, B><<<(unsigned)blocks, WARPS * WARP, 0, s>>>(
      up, v, a, src, dst, logits, n_edges, d);
  return (int)cudaGetLastError();
}

template <int R, int B>
int bwd_user(const float* g, const float* up, const float* v, const float* a,
             const int* dst, const int* task_node, const int* task_beg,
             int n_tasks, int64_t n_edges, int d, float* part, float* ds,
             float* da_part, int n_warps, cudaStream_t s) {
  bilinear_bwd_user_kernel<R, B><<<n_warps / WARPS, WARPS * WARP, 0, s>>>(
      g, up, v, a, dst, task_node, task_beg, n_tasks, n_edges, d, part, ds,
      da_part);
  return (int)cudaGetLastError();
}

template <int B>
int bwd_movie(const float* ds, const float* u, const int* perm, const int* m_src,
              const int* task_beg, int n_tasks, int d, float* part, cudaStream_t s) {
  const int blocks = (n_tasks + WARPS - 1) / WARPS;
  bilinear_bwd_movie_kernel<B><<<blocks, WARPS * WARP, 0, s>>>(
      ds, u, perm, m_src, task_beg, n_tasks, d, part);
  return (int)cudaGetLastError();
}

constexpr int UNSUPPORTED = -1;

}  // namespace

extern "C" {

// The (R, B) pairs the kernels are built for, MovieLens' 10 levels and
// DGL's 4 basis matrices; others return -1 before any launch.
#define BILINEAR_SHAPES(X) X(10, 4)

// logits (R, E) f32 of slots (src, dst) (E,) int32 sorted by src, from
// up (n_users, B, d), v (n_movies, d) and a (R, B), all f32.
int bilinear_fwd(const float* up, const float* v, const float* a, const int* src,
                 const int* dst, float* logits, int64_t n_edges, int d, int R,
                 int B, void* stream) {
  if (n_edges == 0) return 0;
  if (d > QMAX * WARP) return UNSUPPORTED;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CASE(r, b) \
  if (R == r && B == b) return fwd<r, b>(up, v, a, src, dst, logits, n_edges, d, s);
  BILINEAR_SHAPES(CASE)
#undef CASE
  return UNSUPPORTED;
}

// The user pass over n_tasks tasks (task_node, task_beg (n_tasks + 1)) of
// the slot order: part (n_tasks, B, d), ds (E, B), da_part (n_warps, R, B);
// n_warps a multiple of 8.
int bilinear_bwd_user(const float* g, const float* up, const float* v,
                      const float* a, const int* dst, const int* task_node,
                      const int* task_beg, int n_tasks, int64_t n_edges, int d,
                      int R, int B, float* part, float* ds, float* da_part,
                      int n_warps, void* stream) {
  if (d > QMAX * WARP || n_warps % WARPS != 0 || n_warps <= 0) return UNSUPPORTED;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CASE(r, b)                                                              \
  if (R == r && B == b)                                                         \
    return bwd_user<r, b>(g, up, v, a, dst, task_node, task_beg, n_tasks,       \
                          n_edges, d, part, ds, da_part, n_warps, s);
  BILINEAR_SHAPES(CASE)
#undef CASE
  return UNSUPPORTED;
}

// The movie pass over n_tasks tasks (task_beg (n_tasks + 1)) of the movie
// order (perm (E,) slot of each position, m_src (E,) its user): part
// (n_tasks, B, d) from ds (E, B) and u (n_users, d).
int bilinear_bwd_movie(const float* ds, const float* u, const int* perm,
                       const int* m_src, const int* task_beg, int n_tasks, int d,
                       int B, float* part, void* stream) {
  if (n_tasks == 0) return 0;
  if (d > QMAX * WARP) return UNSUPPORTED;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 4) return bwd_movie<4>(ds, u, perm, m_src, task_beg, n_tasks, d, part, s);
  return UNSUPPORTED;
}

// out (n_nodes, width) = the partial rows part summed per node over tptr.
int bilinear_task_sum(const float* part, const int* tptr, int n_nodes, int width,
                      float* out, void* stream) {
  const int64_t n = (int64_t)n_nodes * width;
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  task_sum_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(part, tptr, n_nodes,
                                                               width, out);
  return (int)cudaGetLastError();
}

}  // extern "C"

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
// halves the gathered bytes (rnd of a bf16 x is then exact and skipped).  A
// null val weighs every entry 1 (the scale decoder's scatter, whose slots
// carry no weights): rnd(rnd(x) * 1) = rnd(x) gives the bits of a val of
// ones.
//
// What bounds it on an H100.  Per entry it reads a 4-byte index, a 4-byte
// weight and a row of x (256 bytes at d = 128 in bf16) and does about 4 ALU
// operations per element (unpack, multiply, round, add).  At the encoder's
// shapes x (100k x 128 bf16, 25.6 MB) fits in the 50 MB L2, so the least
// DRAM traffic is the indices and weights once, x once and out once; what
// the gathers can reach is the L2's bandwidth for random 256-byte rows,
// with enough of them in flight, and the instruction rate of the arithmetic.
//
// Design of the wide path (d % 8 == 0).  One warp per dst row.  Each lane
// owns 8 consecutive values of a row of x (one 16-byte load in bf16, two in
// f32); the lanes that one row of x needs form a lane group, and the
// G = 32 / (lanes per group) groups of the warp take the row's entries in
// turn (entry k of the row goes to group k % G): at d = 128 a half-warp
// covers a row of x, so in bf16 one load instruction serves two entries.
// The split depends on d only, not on x's dtype, so that an f32 and a bf16
// x of the same values give the same bits (the grouped scatter against
// seq_scatter); the 16-byte loads need an x that starts 16-byte aligned,
// and the entry point refuses one that does not rather than split it
// another way.  Each group keeps UNROLL gathers in flight: all loads of a
// round start before any is summed.  The groups' partial sums of a row are
// combined in a fixed order by shuffles (a reduce-scatter: each group ends
// with d / G of the columns, which it writes), with no atomics: two
// launches give the same bits, and the SpMM and the scatter over the same
// ptr split a row alike, so they give the same bits too.  Measured on the
// H100 and not kept (PERF.md, section 5): 2, 8 or 16 gathers in flight, L2
// evict-first / evict-last hints, loading the next batch of indices ahead,
// one row per lane group, and a minimum of blocks per SM.
//
// Design of the narrow path (any other d: GCMC's float32 rows of 50).  One
// warp per piece of a row: at most K (graph/csr.py:PIECE, 128) consecutive
// entries.  Every row's first piece (the whole of a row of at most K
// entries) writes its output row; each further piece of a longer row,
// listed once per layout (graph/csr.py:SegmentPieces), writes an f32
// partial row, and segment_sum_kernel_combine adds a row's partial rows to
// its output in piece order.  The further pieces, all of K entries but a
// row's last, take the first warps of the grid, so that short rows make
// the tail.  A warp reads each entry's index and weight once (one
// coalesced load a lane for 32 entries, then shuffles) and covers the
// whole width in that one pass: lane l holds columns 2l and 2l + 1 (P = 2,
// one 8-byte load in f32, 4 bytes in bf16) where d is even and x so
// aligned, else column l (P = 1), and up to NC such chunks of 32 lanes
// (wider rows take more passes); NARROW_INFLIGHT chunk loads are in flight
// a warp.  Each column adds the piece's entries one by one in list order
// from 0, so neither the load width nor x's dtype or address changes the
// bits; a row of at most K entries sums in the order of the one-warp-a-row
// kernel this replaced, and a split row differs from it only by the piece
// boundaries.  The split depends on ptr only, so an f32 and a bf16 x, and
// the SpMM and the scatter over the same ptr, still give the same bits; no
// atomics, so two launches give the same bits.
//
// What bounds the narrow path.  At GCMC's size (PERF.md, section 6) a
// relation's x (69,878 x 50 f32, 14 MB, or 10,677 x 50) stays in L2, so
// the sums are bound by L2 gathers of 200-byte rows: about 6.5 GB a
// training step over its 40 launches, where DRAM's bound
// (gnnbench/counts_gcmc.py) is 0.27 ms.  One warp a row, as before, left a
// launch into movies as long as its longest row: 5,063 entries in two
// column passes took 1.16 ms of the step's 10.24 ms on an H100
// (chip_smoke.py phase 33).  Measured there and not kept (PERF.md,
// section 6): pieces of 32, 64, 256 or 512 entries, within the noise of
// 128; whole rows in one pass, 4.3-4.5 ms for the 40 launches against
// 2.2-2.6 ms in pieces; and partial rows for every piece, listed with the
// layout, which held 27 MB more over the cell's 80 layouts.

// The entry point returns cudaGetLastError() after its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int WARPS = 8;            // warps (rows) per block
constexpr int UNROLL = 4;           // gathers in flight per lane group
constexpr int NARROW_INFLIGHT = 8;  // chunk loads in flight a warp, narrow
constexpr unsigned FULL = 0xffffffffu;
enum Mode { MODE_F32 = 0, MODE_RX = 1, MODE_MSG = 2, MODE_RX_RV = 3 };

__device__ __forceinline__ float rnd_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// a and b rounded to bf16 by one packed conversion (the rounding of
// rnd_bf16, round to nearest even).
__device__ __forceinline__ void rnd_pair(float& a, float& b) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(a, b);
  const uint32_t r = *reinterpret_cast<const uint32_t*>(&p);
  a = __uint_as_float(r << 16);
  b = __uint_as_float(r & 0xffff0000u);
}

// A lane's 8 values of a row of x: one 16-byte load in bf16, two in f32.
template <typename XT>
struct Chunk {
  uint4 q[sizeof(XT) / 2];
};

// A lane's share of a row of x: 8 values (E = 8, the wide path), or one
// value as f32 bits (E = 1, the narrow path's P = 1).
template <typename XT, int E>
__device__ __forceinline__ auto load_x(const XT* p) {
  if constexpr (E == 1) {
    if constexpr (std::is_same<XT, float>::value) {
      return __float_as_uint(__ldg(p));
    } else {
      return (uint32_t)__ldg(reinterpret_cast<const unsigned short*>(p)) << 16;
    }
  } else {
    Chunk<XT> c;
#pragma unroll
    for (int k = 0; k < (int)(sizeof(XT) / 2); ++k)
      c.q[k] = __ldg(reinterpret_cast<const uint4*>(p + k * (16 / sizeof(XT))));
    return c;
  }
}

// acc += the messages of one entry (weight v) in MODE's rounding.
template <typename XT, int MODE>
__device__ __forceinline__ void accumulate(float (&acc)[1], uint32_t raw,
                                           float v) {
  float xv = __uint_as_float(raw);
  if constexpr (MODE == MODE_F32) {
    acc[0] += xv * v;
  } else {
    if constexpr (MODE != MODE_MSG && std::is_same<XT, float>::value)
      xv = rnd_bf16(xv);
    acc[0] += rnd_bf16(xv * v);
  }
}

template <typename XT, int MODE>
__device__ __forceinline__ void accumulate(float (&acc)[8], Chunk<XT> c,
                                           float v) {
  float xv[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (std::is_same<XT, float>::value) {
      const uint32_t w[8] = {c.q[0].x, c.q[0].y, c.q[0].z, c.q[0].w,
                             c.q[1].x, c.q[1].y, c.q[1].z, c.q[1].w};
      xv[2 * i] = __uint_as_float(w[2 * i]);
      xv[2 * i + 1] = __uint_as_float(w[2 * i + 1]);
    } else {                           // bf16: element 2i in the low half
      const uint32_t w[4] = {c.q[0].x, c.q[0].y, c.q[0].z, c.q[0].w};
      xv[2 * i] = __uint_as_float(w[i] << 16);
      xv[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  if constexpr (MODE == MODE_F32) {
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] += xv[i] * v;
  } else {
    if constexpr (MODE != MODE_MSG && std::is_same<XT, float>::value) {
#pragma unroll
      for (int i = 0; i < 8; i += 2) rnd_pair(xv[i], xv[i + 1]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) xv[i] *= v;
#pragma unroll
    for (int i = 0; i < 8; i += 2) rnd_pair(xv[i], xv[i + 1]);
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] += xv[i];
  }
}

// One step of the reduce-scatter across lane groups: this lane's group and
// the group `off` lanes away each hold W partial sums of the same columns;
// afterwards acc[0 .. W/2) holds their total over the lower half of those
// columns (hi false) or the upper half (hi true).  Each total is the same
// two terms in either group, so both halves are fixed sums.
template <int W>
__device__ __forceinline__ void fold(float* acc, bool hi, int off) {
#pragma unroll
  for (int i = 0; i < W / 2; ++i) {
    const float send = hi ? acc[i] : acc[W / 2 + i];
    const float keep = hi ? acc[W / 2 + i] : acc[i];
    acc[i] = keep + __shfl_xor_sync(FULL, send, off);
  }
}

template <int W>
__device__ __forceinline__ void store(float* p, const float* v) {
  static_assert(W % 4 == 0 || W == 2, "a group's share");
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int i = 0; i < W; i += 4)
      *reinterpret_cast<float4*>(p + i) =
          make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  } else {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  }
}

// The wide path: E = 8 values of a row of x per lane (d % 8 == 0); G lane
// groups per warp.
template <typename XT, int E, int G, bool GATHER, int MODE>
__global__ void __launch_bounds__(WARPS * 32) segment_sum_kernel(
    const int* __restrict__ ptr, const int* __restrict__ src,
    const float* __restrict__ val, const XT* __restrict__ x,
    float* __restrict__ out, int n_rows, int d) {
  constexpr int LPR = 32 / G;         // lanes of a group
  using Raw = Chunk<XT>;
  const int lane = threadIdx.x % 32, g = lane / LPR, cl = lane % LPR;
  const unsigned gmask = (FULL >> (32 - LPR)) << (g * LPR);
  const int row = blockIdx.x * WARPS + threadIdx.x / 32;
  if (row >= n_rows) return;          // whole warps leave together
  // This group's entries: start + G * j for j < n.
  const int p0 = __ldg(ptr + row), len = __ldg(ptr + row + 1) - p0;
  const int start = p0 + g, n = len > g ? (len - g + G - 1) / G : 0;
  // Entry j of the group's stream: its row of x and its weight.
  auto fetch = [&](int j, int& s, float& v) {
    s = 0;
    v = 0.f;
    if (j < n) {
      const int p = start + G * j;
      if constexpr (GATHER) s = __ldg(src + p);
      v = val != nullptr ? __ldg(val + p) : 1.f;
      if constexpr (MODE == MODE_RX_RV) v = rnd_bf16(v);
    }
  };
  for (int cb = 0; cb < d; cb += LPR * E) {
    const int col = cb + cl * E;
    const bool active = col < d;      // d % 8 == 0
    float acc[E];
#pragma unroll
    for (int i = 0; i < E; ++i) acc[i] = 0.f;
    for (int jb = 0; jb < n; jb += LPR) {
      int s;
      float v;
      fetch(jb + cl, s, v);
      const int cnt = min(LPR, n - jb);
      for (int j0 = 0; j0 < cnt; j0 += UNROLL) {
        Raw raw[UNROLL];
        float vq[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int j = j0 + u;
          const int sq = GATHER ? __shfl_sync(gmask, s, j, LPR)
                                : start + G * (jb + j);
          vq[u] = __shfl_sync(gmask, v, j, LPR);
          raw[u] = Raw{};
          if (j < cnt && active)
            raw[u] = load_x<XT, E>(x + (size_t)sq * d + col);
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
          if (j0 + u < cnt && active)
            accumulate<XT, MODE>(acc, raw[u], vq[u]);
      }
    }
    int off = 0;                      // first column of this group's share
    if constexpr (G >= 2) {
      const bool hi = lane & LPR;
      fold<E>(acc, hi, LPR);
      off += hi ? E / 2 : 0;
    }
    if constexpr (G >= 4) {
      const bool hi = lane & (2 * LPR);
      fold<E / 2>(acc, hi, 2 * LPR);
      off += hi ? E / 4 : 0;
    }
    if (active) store<E / G>(out + (size_t)row * d + col + off, acc);
  }
}

template <typename XT, int E, int G, bool GATHER, int MODE>
cudaError_t launch(const int* ptr, const int* src, const float* val,
                   const XT* x, float* out, int n_rows, int d,
                   cudaStream_t s) {
  static_assert(E == 8 && E % G == 0, "a group's share");
  const dim3 grid((n_rows + WARPS - 1) / WARPS);
  segment_sum_kernel<XT, E, G, GATHER, MODE><<<grid, WARPS * 32, 0, s>>>(
      ptr, src, val, x, out, n_rows, d);
  return cudaGetLastError();
}

// The narrow path's pieces (graph/csr.py:SegmentPieces): row n's first
// piece is its entries ptr[n] .. min(ptr[n] + k, ptr[n+1]) - 1; further
// piece e starts at entry extra_beg[e] of row extra_row[e], takes at most k
// entries and writes partial row e; split row s (row split_row[s]) owns the
// partial rows split_ptr[s] .. split_ptr[s+1]-1.
struct Pieces {
  const int* extra_beg;
  const int* extra_row;
  int n_extra;
  const int* split_row;
  const int* split_ptr;
  int n_split;
  int k;
  float* part;
};

// P consecutive values of a row of x as f32 bits: one load.
template <typename XT, int P>
__device__ __forceinline__ void load_vals(const XT* p, uint32_t (&r)[P]) {
  if constexpr (P == 1) {
    r[0] = load_x<XT, 1>(p);
  } else if constexpr (std::is_same<XT, float>::value) {
    const float2 f = __ldg(reinterpret_cast<const float2*>(p));
    r[0] = __float_as_uint(f.x);
    r[1] = __float_as_uint(f.y);
  } else {                             // bf16: element 0 in the low half
    const uint32_t w = __ldg(reinterpret_cast<const unsigned int*>(p));
    r[0] = w << 16;
    r[1] = w & 0xffff0000u;
  }
}

// The narrow path: one warp a piece; lane l holds columns P l .. P l + P-1
// of each of NC chunks of 32 P columns; U entries' loads in flight.
template <typename XT, int P, int NC, bool GATHER, int MODE>
__global__ void __launch_bounds__(WARPS * 32) segment_sum_kernel_narrow(
    const int* __restrict__ ptr, Pieces pc, const int* __restrict__ src,
    const float* __restrict__ val, const XT* __restrict__ x,
    float* __restrict__ out, int n_rows, int d) {
  constexpr int U = NARROW_INFLIGHT / NC;
  constexpr int CB = NC * 32 * P;     // columns a pass
  const int lane = threadIdx.x % 32;
  const int w = blockIdx.x * WARPS + threadIdx.x / 32;
  if (w >= pc.n_extra + n_rows) return;  // whole warps leave together
  // Warps 0 .. n_extra-1: the further pieces; then each row's first.
  const int r = w < pc.n_extra ? __ldg(pc.extra_row + w) : w - pc.n_extra;
  const int p0 = w < pc.n_extra ? __ldg(pc.extra_beg + w) : __ldg(ptr + r);
  const int n = min(pc.k, __ldg(ptr + r + 1) - p0);
  float* row = w < pc.n_extra ? pc.part + (size_t)w * d : out + (size_t)r * d;
  for (int cb = 0; cb < d; cb += CB) {
    float acc[NC][P][1];
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int q = 0; q < P; ++q) acc[c][q][0] = 0.f;
    for (int jb = 0; jb < n; jb += 32) {
      // Entry jb + lane's row of x and weight, read once.
      int s = 0;
      float v = 0.f;
      if (jb + lane < n) {
        const int p = p0 + jb + lane;
        if constexpr (GATHER) s = __ldg(src + p);
        v = val != nullptr ? __ldg(val + p) : 1.f;
        if constexpr (MODE == MODE_RX_RV) v = rnd_bf16(v);
      }
      const int cnt = min(32, n - jb);
      for (int j0 = 0; j0 < cnt; j0 += U) {
        uint32_t raw[U][NC][P];
        float vq[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int j = j0 + u;
          const int sq = GATHER ? __shfl_sync(FULL, s, j) : p0 + jb + j;
          vq[u] = __shfl_sync(FULL, v, j);
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            const int col = cb + (c * 32 + lane) * P;
#pragma unroll
            for (int q = 0; q < P; ++q) raw[u][c][q] = 0u;
            if (j < cnt && col < d)
              load_vals<XT, P>(x + (size_t)sq * d + col, raw[u][c]);
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
          for (int c = 0; c < NC; ++c)
            if (j0 + u < cnt && cb + (c * 32 + lane) * P < d)
#pragma unroll
              for (int q = 0; q < P; ++q)
                accumulate<XT, MODE>(acc[c][q], raw[u][c][q], vq[u]);
      }
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = cb + (c * 32 + lane) * P;
      if (col < d) {                  // P = 2: d is even, so is col
        if constexpr (P == 2)
          *reinterpret_cast<float2*>(row + col) =
              make_float2(acc[c][0][0], acc[c][1][0]);
        else
          row[col] = acc[c][0][0];
      }
    }
  }
}

// Split row s: its first piece's sum, in out, plus its partial rows in
// piece order.
__global__ void segment_sum_kernel_combine(Pieces pc, float* __restrict__ out,
                                           int d) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)pc.n_split * d) return;
  const int s = (int)(i / d), c = (int)(i % d);
  float* o = out + (size_t)__ldg(pc.split_row + s) * d + c;
  float acc = *o;
  for (int t = __ldg(pc.split_ptr + s); t < __ldg(pc.split_ptr + s + 1); ++t)
    acc += pc.part[(size_t)t * d + c];
  *o = acc;
}

template <typename XT, int P, int NC, bool GATHER, int MODE>
cudaError_t launch_narrow(const int* ptr, const Pieces& pc, const int* src,
                          const float* val, const XT* x, float* out,
                          int n_rows, int d, cudaStream_t s) {
  const dim3 grid((pc.n_extra + n_rows + WARPS - 1) / WARPS);
  segment_sum_kernel_narrow<XT, P, NC, GATHER, MODE>
      <<<grid, WARPS * 32, 0, s>>>(ptr, pc, src, val, x, out, n_rows, d);
  if (pc.n_split > 0) {
    const int64_t n = (int64_t)pc.n_split * d;
    segment_sum_kernel_combine<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
        pc, out, d);
  }
  return cudaGetLastError();
}

// P = 2 values a lane where d is even and x so aligned, else 1; as many
// chunks of 32 lanes as one pass over the entries needs, up to 4.
template <typename XT, bool GATHER, int MODE>
cudaError_t dispatch_narrow(const int* ptr, const Pieces& pc, const int* src,
                            const float* val, const XT* x, float* out,
                            int n_rows, int d, cudaStream_t s) {
  const bool pair = d % 2 == 0 &&
                    reinterpret_cast<uintptr_t>(x) % (2 * sizeof(XT)) == 0;
  const int chunks = (d + (pair ? 64 : 32) - 1) / (pair ? 64 : 32);
  if (pair) {
    if (chunks == 1)
      return launch_narrow<XT, 2, 1, GATHER, MODE>(ptr, pc, src, val, x, out, n_rows, d, s);
    if (chunks == 2)
      return launch_narrow<XT, 2, 2, GATHER, MODE>(ptr, pc, src, val, x, out, n_rows, d, s);
    return launch_narrow<XT, 2, 4, GATHER, MODE>(ptr, pc, src, val, x, out, n_rows, d, s);
  }
  if (chunks == 1)
    return launch_narrow<XT, 1, 1, GATHER, MODE>(ptr, pc, src, val, x, out, n_rows, d, s);
  if (chunks == 2)
    return launch_narrow<XT, 1, 2, GATHER, MODE>(ptr, pc, src, val, x, out, n_rows, d, s);
  return launch_narrow<XT, 1, 4, GATHER, MODE>(ptr, pc, src, val, x, out, n_rows, d, s);
}

// The wide path, 8 values per lane (16-byte loads), when d % 8 == 0, with
// as many lane groups as fit in a warp (up to 4); else the narrow path over
// the pieces.  The choice depends on d only, not on x's dtype or address,
// so an f32 and a bf16 x of the same values split and sum a row alike; an
// x that the 16-byte loads cannot read is refused.
template <typename XT, bool GATHER, int MODE>
cudaError_t dispatch_width(const int* ptr, const int* src, const float* val,
                           const void* xv, float* out, int n_rows, int d,
                           const Pieces& pc, cudaStream_t s) {
  const XT* x = static_cast<const XT*>(xv);
  if (d % 8 != 0) {
    if (pc.k <= 0) return cudaErrorInvalidValue;
    return dispatch_narrow<XT, GATHER, MODE>(ptr, pc, src, val, x, out, n_rows,
                                             d, s);
  }
  if (reinterpret_cast<uintptr_t>(x) % 16 != 0) return cudaErrorMisalignedAddress;
  const int lanes = d / 8;
  if (lanes <= 8)
    return launch<XT, 8, 4, GATHER, MODE>(ptr, src, val, x, out, n_rows, d, s);
  if (lanes <= 16)
    return launch<XT, 8, 2, GATHER, MODE>(ptr, src, val, x, out, n_rows, d, s);
  return launch<XT, 8, 1, GATHER, MODE>(ptr, src, val, x, out, n_rows, d, s);
}

template <typename XT, bool GATHER>
cudaError_t dispatch_mode(const int* ptr, const int* src, const float* val,
                          const void* x, float* out, int n_rows, int d,
                          int mode, const Pieces& pc, cudaStream_t s) {
  switch (mode) {
    case MODE_F32:
      return dispatch_width<XT, GATHER, MODE_F32>(ptr, src, val, x, out, n_rows, d, pc, s);
    case MODE_RX:
      return dispatch_width<XT, GATHER, MODE_RX>(ptr, src, val, x, out, n_rows, d, pc, s);
    case MODE_MSG:
      return dispatch_width<XT, GATHER, MODE_MSG>(ptr, src, val, x, out, n_rows, d, pc, s);
    case MODE_RX_RV:
      return dispatch_width<XT, GATHER, MODE_RX_RV>(ptr, src, val, x, out, n_rows, d, pc, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename XT>
cudaError_t dispatch(const int* ptr, const int* src, const float* val,
                     const void* x, float* out, int n_rows, int d, int mode,
                     const Pieces& pc, cudaStream_t s) {
  return src != nullptr
             ? dispatch_mode<XT, true>(ptr, src, val, x, out, n_rows, d, mode, pc, s)
             : dispatch_mode<XT, false>(ptr, src, val, x, out, n_rows, d, mode, pc, s);
}

}  // namespace

extern "C" {

// out (n_rows, d) f32 = the segmented sums above over ptr (n_rows + 1) int32,
// val (nnz,) f32 (null: every weight 1) and x (rows, d), bf16 when x_bf16
// else f32.  src (nnz,) int32 gathers row src[p] of x; a null src reads row
// p.  mode is the rounding (enum Mode above).  Where d % 8 != 0, the rows'
// pieces (struct Pieces: int32 lists and k > 0) and part, (n_extra, d) f32
// for the partial rows; else those may be null and k 0.
int segment_sum(const int* ptr, const int* src, const float* val,
                const void* x, float* out, int n_rows, int d, int x_bf16,
                int mode, const int* extra_beg, const int* extra_row,
                int n_extra, const int* split_row, const int* split_ptr,
                int n_split, int k, float* part, void* stream) {
  if (n_rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Pieces pc{extra_beg, extra_row, n_extra, split_row, split_ptr,
                  n_split, k, part};
  return (int)(x_bf16 ? dispatch<__nv_bfloat16>(ptr, src, val, x, out, n_rows, d, mode, pc, s)
                      : dispatch<float>(ptr, src, val, x, out, n_rows, d, mode, pc, s));
}

}  // extern "C"

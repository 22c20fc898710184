// Fused blocked AXPBY + column dots for Hopper (sm_90a), paper C3.
//
// Replaces: repro/kernels/fused_update.py:fused_axpby_dots_pallas (the
// Pallas TPU kernel, body `_kernel`).  Computes, for x and y of shape
// (n, bw), row-major,
//
//   y'[r, c] = a[c] * x[r, c] + b[c] * y[r, c]
//   dots[0, c] = sum_r y'[r, c]^2,  dots[1, c] = sum_r x[r, c] y'[r, c],
//   dots[2, c] = sum_r x[r, c]^2          (each only when asked; else 0)
//
// in one sweep.  x and y may have different real types (float64, float32,
// bfloat16, float16); y' has their promoted type, and y', the coefficients
// and the dots live in its accumulation type (float32 for the half types,
// else the type itself).  The dots are taken of y' before it is rounded to
// its output type, as the TPU kernel does.
//
// Bound: memory bandwidth.  The call must read x and y once and write y'
// once, 3 * n * bw values, for at most 8 flops per entry; in float64 that
// is a third of a flop per byte.
//
// Design:
// * The TPU kernel writes one (3, bw) partial per grid step and the wrapper
//   sums them.  Here the n * bw entries are cut into tiles of 8 * T entries,
//   T = (256 / bw) * bw, and a fixed number of thread blocks (the wrapper
//   picks it from n and bw alone, not from the card) take tiles
//   blockIdx.x, blockIdx.x + gridDim.x, ...: at any moment the blocks
//   stream neighbouring addresses.  Within a tile, thread t owns entries
//   t, t + T, ..., t + 7T: each thread always meets the same column
//   (t % bw), neighbouring threads touch neighbouring addresses
//   (coalesced, any bw), and each thread loads its 8 entries of x and of y
//   before it uses any, to keep enough bytes in flight.
// * Each thread sums its entries' dots in order; the block combines its
//   lanes in lane order through shared memory into a (3, bw) partial; a
//   second kernel sums the partials with one warp per dot: lane l sums
//   blocks l, l + 32, ... in order (independent loads, so they overlap),
//   and the lanes combine in a fixed butterfly.  No atomics: the result
//   depends only on n and bw, and repeats bit for bit from run to run.
// * Without dots only the first kernel runs, and it writes no partial.
// * Entries past n * bw load nothing; no padding is needed.

#include <cuda_runtime.h>

#include "dtypes.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kInFlight = 8;       // entries a thread loads before using any
constexpr int kWarp = 32;
constexpr int kDotYY = 1, kDotXY = 2, kDotXX = 4;

// Pass 1: y' over the block's tiles, and (flags != 0) the block's (3, bw)
// partial dots part[blk].
template <typename TX, typename TY>
__global__ void __launch_bounds__(kThreads)
axpby_dots_partial(const TX* __restrict__ x, const TY* __restrict__ y,
                   const typename Acc<typename Promote<TX, TY>::type>::type* a,
                   const typename Acc<typename Promote<TX, TY>::type>::type* b,
                   typename Promote<TX, TY>::type* __restrict__ out,
                   typename Acc<typename Promote<TX, TY>::type>::type* part,
                   long long n, int bw, int flags) {
  using TO = typename Promote<TX, TY>::type;
  using A = typename Acc<TO>::type;
  __shared__ A sh[3][kThreads];

  const int lanes = kThreads / bw;
  const int stride = lanes * bw;
  const int t = threadIdx.x;
  const int c = t % bw;
  const long long e_end = n * bw;
  const long long tile = (long long)kInFlight * stride;

  A s_yy = A(0), s_xy = A(0), s_xx = A(0);
  if (t < stride) {
    const A ac = a[c], bc = b[c];
    for (long long e0 = blockIdx.x * tile + t; e0 < e_end;
         e0 += gridDim.x * tile) {
      A xv[kInFlight], yv[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const long long e = e0 + (long long)u * stride;
        xv[u] = e < e_end ? load_as<A>(x[e]) : A(0);
        yv[u] = e < e_end ? load_as<A>(y[e]) : A(0);
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const long long e = e0 + (long long)u * stride;
        if (e < e_end) {
          const A yn = ac * xv[u] + bc * yv[u];
          out[e] = store_as<TO>(yn);
          s_yy += yn * yn;
          s_xy += xv[u] * yn;
          s_xx += xv[u] * xv[u];
        }
      }
    }
  }
  if (flags == 0) return;                      // uniform across the block

  sh[0][t] = s_yy;
  sh[1][t] = s_xy;
  sh[2][t] = s_xx;
  __syncthreads();
  // one thread per (dot, column) combines the lanes in lane order; past
  // bw = 85 there are more (dot, column) pairs than threads, so a thread
  // takes o = t, t + kThreads, ...
  for (int o = t; o < 3 * bw; o += kThreads) {
    const int d = o / bw, col = o % bw;
    A s = A(0);
    for (int l = 0; l < lanes; ++l) s += sh[d][l * bw + col];
    const bool want = (d == 0 && (flags & kDotYY)) ||
                      (d == 1 && (flags & kDotXY)) ||
                      (d == 2 && (flags & kDotXX));
    part[((long long)blockIdx.x * 3 + d) * bw + col] = want ? s : A(0);
  }
}

// Pass 2: one warp per (dot, column): lane l sums the partials of blocks
// l, l + 32, ... in order, then the lanes combine in a fixed butterfly.
template <typename A>
__global__ void __launch_bounds__(kThreads)
axpby_dots_finish(const A* __restrict__ part, int nblocks, int nd,
                  A* __restrict__ dots) {
  const int o = (blockIdx.x * blockDim.x + threadIdx.x) / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (o >= nd) return;                         // whole warps leave
  A s = A(0);
#pragma unroll 4
  for (int blk = lane; blk < nblocks; blk += kWarp)
    s += part[(long long)blk * nd + o];
#pragma unroll
  for (int w = kWarp / 2; w > 0; w /= 2)
    s += __shfl_xor_sync(0xffffffffu, s, w);
  if (lane == 0) dots[o] = s;
}

template <typename TX, typename TY>
int launch(const void* x, const void* y, const void* a, const void* b,
           void* out, void* part, void* dots, long long n, int bw,
           int nblocks, int flags, cudaStream_t stream) {
  using TO = typename Promote<TX, TY>::type;
  using A = typename Acc<TO>::type;
  if (nblocks > 0) {
    axpby_dots_partial<TX, TY><<<nblocks, kThreads, 0, stream>>>(
        static_cast<const TX*>(x), static_cast<const TY*>(y),
        static_cast<const A*>(a), static_cast<const A*>(b),
        static_cast<TO*>(out), static_cast<A*>(part), n, bw, flags);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if (flags == 0) return 0;
  const int nd = 3 * bw;
  axpby_dots_finish<A><<<(nd * kWarp + kThreads - 1) / kThreads, kThreads,
                         0, stream>>>(static_cast<const A*>(part), nblocks,
                                      nd, static_cast<A*>(dots));
  return (int)cudaGetLastError();
}

template <typename TX>
int launch_y(int y_dtype, const void* x, const void* y, const void* a,
             const void* b, void* out, void* part, void* dots, long long n,
             int bw, int nblocks, int flags, cudaStream_t s) {
  switch (y_dtype) {
    case 0: return launch<TX, double>(x, y, a, b, out, part, dots, n, bw,
                                      nblocks, flags, s);
    case 1: return launch<TX, float>(x, y, a, b, out, part, dots, n, bw,
                                     nblocks, flags, s);
    case 2: return launch<TX, __nv_bfloat16>(x, y, a, b, out, part, dots, n,
                                             bw, nblocks, flags, s);
    case 3: return launch<TX, __half>(x, y, a, b, out, part, dots, n, bw,
                                      nblocks, flags, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes: 0 float64, 1 float32, 2 bfloat16, 3 float16.  a and b hold
// bw coefficients in the accumulation type; part holds nblocks * 3 * bw and
// dots 3 * bw values of it (read and written only when flags != 0; flags:
// 1 <y',y'>, 2 <x,y'>, 4 <x,x>).  out has the promoted type of x and y.
// Returns the first CUDA error of the launches (0 on success).
extern "C" int fused_update_launch(int x_dtype, int y_dtype, const void* x,
                                   const void* y, const void* a,
                                   const void* b, void* out, void* part,
                                   void* dots, long long n, int bw,
                                   int nblocks, int flags, void* stream) {
  if (n < 0 || bw < 1 || bw > kThreads || nblocks < 0 ||
      (n > 0 && nblocks < 1) || (flags & ~7) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (x_dtype) {
    case 0: return launch_y<double>(y_dtype, x, y, a, b, out, part, dots, n,
                                    bw, nblocks, flags, s);
    case 1: return launch_y<float>(y_dtype, x, y, a, b, out, part, dots, n,
                                   bw, nblocks, flags, s);
    case 2: return launch_y<__nv_bfloat16>(y_dtype, x, y, a, b, out, part,
                                           dots, n, bw, nblocks, flags, s);
    case 3: return launch_y<__half>(y_dtype, x, y, a, b, out, part, dots, n,
                                    bw, nblocks, flags, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Fused blocked AXPBY + column dots for Hopper (sm_90a), paper C3.
//
// Replaces: repro/kernels/fused_update.py:fused_axpby_dots_pallas (the
// Pallas TPU kernel, body `_kernel`).  Computes, for x and y of shape
// (n, bw), row-major,
//
//   y'[r, c] = a[c] * x[r, c] + b[c] * y[r, c]
//   dots[0, c] = sum_r conj(y'[r, c]) y'[r, c],
//   dots[1, c] = sum_r conj(x[r, c]) y'[r, c],
//   dots[2, c] = sum_r conj(x[r, c]) x[r, c]   (each only when asked; else 0)
//
// in one sweep.  x and y may have different real types (float64, float32,
// bfloat16, float16); y' has their promoted type, and y', the coefficients
// and the dots live in its accumulation type (float32 for the half types,
// else the type itself).  The dots are taken of y' before it is rounded to
// its output type, as the TPU kernel does.  Complex x and y (complex128 or
// complex64, both of one type: the wrapper widens a real or narrower
// operand exactly) take complex a and b; their dots are conjugate-linear
// in the first argument and are summed in complex128 (the partials too),
// then rounded once to the accumulation type.  The JAX package takes its
// plain path for complex operands, and its sums do not conjugate.
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

// The type the dots are summed in: the accumulation type for real values,
// complex128 for complex ones.
template <typename A> struct DotAcc { using type = A; };
template <typename R> struct DotAcc<Complex<R>> { using type = Complex<double>; };

template <typename D, typename A> __device__ __forceinline__ D widen(A v) {
  return D(v);
}
template <>
__device__ __forceinline__ Complex<double> widen(Complex<float> v) {
  return Complex<double>(v.re, v.im);
}

// One dot term conj(u) v in the dot type.
template <typename D, typename A>
__device__ __forceinline__ D dot_term(A u, A v) {
  return widen<D>(conj_of(u)) * widen<D>(v);
}

template <typename O, typename D> __device__ __forceinline__ O narrow(D v) {
  return O(v);
}
template <>
__device__ __forceinline__ Complex<float> narrow(Complex<double> v) {
  return Complex<float>((float)v.re, (float)v.im);
}

template <typename D>
__device__ __forceinline__ D shfl_xor(D v, int w) {
  return __shfl_xor_sync(0xffffffffu, v, w);
}
template <>
__device__ __forceinline__ Complex<double> shfl_xor(Complex<double> v, int w) {
  return Complex<double>(__shfl_xor_sync(0xffffffffu, v.re, w),
                         __shfl_xor_sync(0xffffffffu, v.im, w));
}

// Pass 1: y' over the block's tiles, and (flags != 0) the block's (3, bw)
// partial dots part[blk].
template <typename TX, typename TY>
__global__ void __launch_bounds__(kThreads)
axpby_dots_partial(const TX* __restrict__ x, const TY* __restrict__ y,
                   const typename Acc<typename Promote<TX, TY>::type>::type* a,
                   const typename Acc<typename Promote<TX, TY>::type>::type* b,
                   typename Promote<TX, TY>::type* __restrict__ out,
                   typename DotAcc<typename Acc<
                       typename Promote<TX, TY>::type>::type>::type* part,
                   long long n, int bw, int flags) {
  using TO = typename Promote<TX, TY>::type;
  using A = typename Acc<TO>::type;
  using D = typename DotAcc<A>::type;
  __shared__ D sh[3][kThreads];

  const int lanes = kThreads / bw;
  const int stride = lanes * bw;
  const int t = threadIdx.x;
  const int c = t % bw;
  const long long e_end = n * bw;
  const long long tile = (long long)kInFlight * stride;

  D s_yy = D(0), s_xy = D(0), s_xx = D(0);
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
          s_yy += dot_term<D>(yn, yn);
          s_xy += dot_term<D>(xv[u], yn);
          s_xx += dot_term<D>(xv[u], xv[u]);
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
    D s = D(0);
    for (int l = 0; l < lanes; ++l) s += sh[d][l * bw + col];
    const bool want = (d == 0 && (flags & kDotYY)) ||
                      (d == 1 && (flags & kDotXY)) ||
                      (d == 2 && (flags & kDotXX));
    part[((long long)blockIdx.x * 3 + d) * bw + col] = want ? s : D(0);
  }
}

// Pass 2: one warp per (dot, column): lane l sums the partials of blocks
// l, l + 32, ... in order, then the lanes combine in a fixed butterfly; the
// sum is rounded once to the dots' type A.
template <typename A, typename D>
__global__ void __launch_bounds__(kThreads)
axpby_dots_finish(const D* __restrict__ part, int nblocks, int nd,
                  A* __restrict__ dots) {
  const int o = (blockIdx.x * blockDim.x + threadIdx.x) / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (o >= nd) return;                         // whole warps leave
  D s = D(0);
#pragma unroll 4
  for (int blk = lane; blk < nblocks; blk += kWarp)
    s += part[(long long)blk * nd + o];
#pragma unroll
  for (int w = kWarp / 2; w > 0; w /= 2) s += shfl_xor(s, w);
  if (lane == 0) dots[o] = narrow<A>(s);
}

template <typename TX, typename TY>
int launch(const void* x, const void* y, const void* a, const void* b,
           void* out, void* part, void* dots, long long n, int bw,
           int nblocks, int flags, cudaStream_t stream) {
  using TO = typename Promote<TX, TY>::type;
  using A = typename Acc<TO>::type;
  using D = typename DotAcc<A>::type;
  if (nblocks > 0) {
    axpby_dots_partial<TX, TY><<<nblocks, kThreads, 0, stream>>>(
        static_cast<const TX*>(x), static_cast<const TY*>(y),
        static_cast<const A*>(a), static_cast<const A*>(b),
        static_cast<TO*>(out), static_cast<D*>(part), n, bw, flags);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if (flags == 0) return 0;
  const int nd = 3 * bw;
  axpby_dots_finish<A, D><<<(nd * kWarp + kThreads - 1) / kThreads,
                            kThreads, 0, stream>>>(
      static_cast<const D*>(part), nblocks, nd, static_cast<A*>(dots));
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

// dtype codes: 0 float64, 1 float32, 2 bfloat16, 3 float16, 4 complex128,
// 5 complex64 (a complex x takes a y of its own type only).  a and b hold
// bw coefficients in the accumulation type; dots holds 3 * bw values of it
// and part nblocks * 3 * bw values of the dot type (complex128 for complex
// operands; both read and written only when flags != 0; flags: 1 <y',y'>,
// 2 <x,y'>, 4 <x,x>).  out has the promoted type of x and y.
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
  if ((x_dtype >= 4 || y_dtype >= 4) && x_dtype != y_dtype)
    return (int)cudaErrorInvalidValue;
  switch (x_dtype) {
    case 0: return launch_y<double>(y_dtype, x, y, a, b, out, part, dots, n,
                                    bw, nblocks, flags, s);
    case 1: return launch_y<float>(y_dtype, x, y, a, b, out, part, dots, n,
                                   bw, nblocks, flags, s);
    case 2: return launch_y<__nv_bfloat16>(y_dtype, x, y, a, b, out, part,
                                           dots, n, bw, nblocks, flags, s);
    case 3: return launch_y<__half>(y_dtype, x, y, a, b, out, part, dots, n,
                                    bw, nblocks, flags, s);
    case 4: return launch<Complex<double>, Complex<double>>(
        x, y, a, b, out, part, dots, n, bw, nblocks, flags, s);
    case 5: return launch<Complex<float>, Complex<float>>(
        x, y, a, b, out, part, dots, n, bw, nblocks, flags, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

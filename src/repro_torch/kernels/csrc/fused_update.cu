// Fused blocked AXPBY + column dots for Hopper (sm_90a), paper C3.
//
// Replaces: repro/kernels/fused_update.py:fused_axpby_dots_pallas (the
// Pallas TPU kernel, body `_kernel`).  Computes, for x and y of shape
// (n, bw), row-major, any bw >= 1,
//
//   y'[r, c] = a[c] * x[r, c] + b[c] * y[r, c]
//   dots[0, c] = sum_r conj(y'[r, c]) y'[r, c],
//   dots[1, c] = sum_r conj(x[r, c]) y'[r, c],
//   dots[2, c] = sum_r conj(x[r, c]) x[r, c]   (each only when asked; else 0)
//
// in one sweep and one launch.  x and y may have different real types
// (float64, float32, bfloat16, float16); y' has their promoted type, and
// y', the coefficients and the dots live in its accumulation type
// (float32 for the half types, else the type itself).  The dots are taken
// of y' before it is rounded to its output type, as the TPU kernel does.
// Complex x and y (complex128 or complex64, both of one type: the wrapper
// widens a real or narrower operand exactly) take complex a and b; their
// dots are conjugate-linear in the first argument and are summed in
// complex128 (the partials too), then rounded once to the accumulation
// type.  The JAX package takes its plain path for complex operands, and
// its sums do not conjugate.
//
// Bound: memory bandwidth.  The call must read x and y once and write y'
// once, three n x bw arrays of (at most) the output type, for at most 8
// flops an entry (38 for complex values); in float64 that is a third of a
// flop a byte, far below the card's ridge point.
//
// What held the first design back (PERF.md, section 6; NVIDIA H100 80GB
// HBM3, measured): not the kernel, whose two launches took 0.141 ms of device
// time in float64 at 4,194,304 x 4 (85 % of the bound), but the wrapper,
// which turned every Python-number coefficient into a card tensor by a
// copy from pageable host memory: two stream synchronisations a call, so
// back-to-back calls took 0.26 ms.  The first design also loaded 8 bytes
// a thread, needed a second launch for the dots and one thread block
// holding a lane of every column (bw <= 256).
//
// Design:
// * Coefficients come by value (two doubles each) or, for a tensor on the
//   card, as a pointer to 1 or bw values in the accumulation type: the
//   host never reads a value and the stream never waits.
// * 16 bytes a thread: the flat n * bw entries are cut into vectors of
//   V = 16 / sizeof(output type) entries (2 float64, 4 float32, 8 for the
//   half types, 1 complex128, 2 complex64; x and y load V entries each, 16
//   bytes or fewer for a narrower input).  A period of P = lcm(bw, V)
//   entries holds Q = P / V vectors ("slots") and whole rows, so slot q of
//   every period covers the same columns.  A block of 256 threads takes
//   `lanes` = 256 / Q periods side by side, thread t on slot t % Q of
//   period t / Q: neighbouring threads read neighbouring 16-byte vectors,
//   and a thread's columns never change, so its dot partials (3 x V
//   values) stay in registers.  Past Q = 256 the slots are cut into
//   `nst` slot tiles of at most 256 (grid.y), one lane each: any bw.
// * Bytes in flight: a thread loads U periods' vectors of x and y before
//   it uses any (U = 4; 2 for the half types, whose 8-value vectors take
//   twice the registers).  Two 256-thread blocks an SM (the launch bounds
//   hold 128 registers a thread, so no instance spills) keep 2 x 256 x 4
//   x 32 bytes = 64 KB an SM in flight in float64, against the ~38 KB an
//   SM that 3.35 TB/s x ~1.5 us of latency needs over 132 SMs.  A ring of
//   1-D bulk copies into shared memory (tools/b5_trials.py's "bulk") ran
//   within 1 % of this design, faster in float64, float32 and complex128
//   and slower in complex64; the registers' design is kept, as simpler.
// * A tile is U * lanes periods; block x of nbx walks tiles x, x + nbx,
//   ... with nbx at most ceil(132 x 2 / nst), one wave on the H100 (a
//   constant: the wrapper picks nbx from n, bw and the dtype, never from
//   the card, so the order of the sums is the same on every card).
// * One launch.  Each thread sums its entries' dots in order; the block
//   combines them into a (3, P) partial, one value a dot and period
//   offset (where Qt divides 32, a butterfly over a warp's lanes of one
//   slot, then the 8 warps in order through shared memory; else the
//   lanes in order); the last block of each group of kGroup blocks to
//   finish (a counter a group in the workspace, after __threadfence) sums
//   the group's partials in block order; the last group to finish sums
//   the groups' sums in group order and folds the P / bw offsets of each
//   column, in order, into dots.  Each counter is set back to 0 by the
//   block that read it last, so the kernel leaves the workspace as it
//   found it.  No value depends on which block came last: the result
//   depends only on n, bw and the dtypes, and repeats bit for bit
//   (kernels/fused_update.py:summation_depth counts the longest chain).
//   Without dots no partial is written and no counter read.  The two
//   finishing levels cost about 5 us a call after the last block (a chain
//   of fences, atomics and L2 round trips; tools/b5_trials.py's probes):
//   one fence fewer, or a warp an entry, took none of it off.
// * Entries past n * bw load nothing: the last period is masked, and x
//   or y off a vector boundary (a view) loads value by value, the same
//   entries in the same order, so the bits do not depend on alignment.

#include <cuda_runtime.h>

#include <cstdint>

#include "dtypes.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 32;   // blocks whose partials one block sums
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

// A partial written by another block: read past L1 (not coherent).
__device__ __forceinline__ float ld_part(const float* p) { return __ldcg(p); }
__device__ __forceinline__ double ld_part(const double* p) { return __ldcg(p); }
__device__ __forceinline__ Complex<double> ld_part(const Complex<double>* p) {
  const double2 t = __ldcg(reinterpret_cast<const double2*>(p));
  return Complex<double>(t.x, t.y);
}

// V neighbouring values of type T, one aligned vector load or store.
template <typename T, int V> struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

// V entries from e on, in the accumulation type A: one vector load where
// the operand lies on a vector boundary and the vector is whole, else
// value by value, zeros past e_end.
template <typename A, typename T, int V>
__device__ __forceinline__ void load_entries(const T* __restrict__ p,
                                             long long e, long long e_end,
                                             bool vec, A (&out)[V]) {
  if (vec) {
    const Vec<T, V> w = *reinterpret_cast<const Vec<T, V>*>(p + e);
#pragma unroll
    for (int j = 0; j < V; ++j) out[j] = load_as<A>(w.v[j]);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j)
      out[j] = e + j < e_end ? load_as<A>(p[e + j]) : A(0);
  }
}

// A coefficient: by value, or read from the card (width 1: one value,
// else one a column).
template <typename A> struct CoefArg {
  const A* p;
  int width;
  A v;
  __device__ __forceinline__ A at(int col) const {
    return p == nullptr ? v : p[width == 1 ? 0 : col];
  }
};

struct Shape {
  long long e_end;   // n * bw
  long long ntiles;  // tiles of unroll * lanes periods
  int bw, P, Q, Qt, lanes, nbx, ngroups, flags;
  int vec_x, vec_y;  // x / y lie on a vector boundary
};

// Periods' vectors a thread loads before it uses any (kernels/
// fused_update.py:partition's unroll: the half types' 8-value vectors take
// twice the registers), and the blocks an SM the launch bounds keep room
// for (128 registers a thread: four blocks of 64 spilled in every
// instance with dots, and ran 1.37x slower in float64).
template <int V> __host__ __device__ constexpr int unroll() {
  return V == 8 ? 2 : 4;
}
template <int V> __host__ __device__ constexpr int min_blocks() {
  return 2;
}

// The block's partial (its lanes in lane order, one value a dot and
// period offset of its slot tile), then the two levels of the finish
// (see the note at the top).
template <typename A, typename D, int V>
__device__ __forceinline__ void finish_dots(D (&acc)[3][V], D* part,
                                            D* gpart, unsigned* counters,
                                            A* dots, const Shape& s) {
  __shared__ D sh[3][kThreads * V];
  __shared__ bool last;
  const int t = threadIdx.x;
  // where a warp holds whole periods (Qt divides 32), its lanes of one
  // slot first combine by a butterfly, and the block's warps follow in
  // order; else the lanes in order
  const bool by_warps = kWarp % s.Qt == 0;
  if (by_warps) {
    for (int w = kWarp / 2; w >= s.Qt; w /= 2) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        acc[0][j] += shfl_xor(acc[0][j], w);
        acc[1][j] += shfl_xor(acc[1][j], w);
        acc[2][j] += shfl_xor(acc[2][j], w);
      }
    }
  }
  const int row = by_warps ? t / kWarp : t / s.Qt;   // warp, or lane
  const int rows = by_warps ? kThreads / kWarp : s.lanes;
  if (!by_warps || t % kWarp < s.Qt) {
    const int slot = by_warps ? t % kWarp : t % s.Qt;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      sh[0][(row * s.Qt + slot) * V + j] = acc[0][j];
      sh[1][(row * s.Qt + slot) * V + j] = acc[1][j];
      sh[2][(row * s.Qt + slot) * V + j] = acc[2][j];
    }
  }
  __syncthreads();
  const long long P = s.P;
  const int tile_off = blockIdx.y * s.Qt * V;
  for (int o = t; o < s.Qt * V && tile_off + o < s.P; o += kThreads) {
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      D v = D(0);
      for (int r = 0; r < rows; ++r) v += sh[d][r * s.Qt * V + o];
      part[((long long)blockIdx.x * 3 + d) * P + tile_off + o] = v;
    }
  }

  // the last block of the group to finish sums the group's partials in
  // block order
  const int group = blockIdx.x / kGroup;
  const int b0 = group * kGroup, b1 = min(s.nbx, b0 + kGroup);
  __threadfence();
  __syncthreads();
  if (t == 0) {
    __threadfence();   // the block's partial, seen through the barrier
    last = atomicAdd(&counters[group], 1u) ==
           (unsigned)((b1 - b0) * gridDim.y - 1);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int o = t; o < 3 * s.P; o += kThreads) {
    D v = D(0);
#pragma unroll 8
    for (int bb = b0; bb < b1; ++bb)
      v += ld_part(part + (long long)bb * 3 * P + o);
    gpart[(long long)group * 3 * P + o] = v;
  }
  if (t == 0) counters[group] = 0u;

  // the last group to finish sums the groups' sums in group order, a
  // column's P / bw offsets in order
  __threadfence();
  __syncthreads();
  if (t == 0) {
    __threadfence();
    last = atomicAdd(&counters[s.ngroups], 1u) == (unsigned)(s.ngroups - 1);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int o = t; o < 3 * s.bw; o += kThreads) {
    const int d = o / s.bw, col = o % s.bw;
    D v = D(0);
    for (int k = col; k < s.P; k += s.bw) {
#pragma unroll 8
      for (int g = 0; g < s.ngroups; ++g)
        v += ld_part(gpart + ((long long)g * 3 + d) * P + k);
    }
    const bool want = (d == 0 && (s.flags & kDotYY)) ||
                      (d == 1 && (s.flags & kDotXY)) ||
                      (d == 2 && (s.flags & kDotXX));
    dots[o] = want ? narrow<A>(v) : A(0);
  }
  if (t == 0) counters[s.ngroups] = 0u;
}

// y' over the block's tiles and, with DOTS, the launch's dots.
template <typename TX, typename TY, int V, bool DOTS>
__global__ void __launch_bounds__(kThreads, min_blocks<V>())
axpby_dots(const TX* __restrict__ x, const TY* __restrict__ y,
           CoefArg<typename Acc<typename Promote<TX, TY>::type>::type> ca,
           CoefArg<typename Acc<typename Promote<TX, TY>::type>::type> cb,
           typename Promote<TX, TY>::type* __restrict__ out,
           typename DotAcc<typename Acc<
               typename Promote<TX, TY>::type>::type>::type* part,
           typename DotAcc<typename Acc<
               typename Promote<TX, TY>::type>::type>::type* gpart,
           unsigned* counters,
           typename Acc<typename Promote<TX, TY>::type>::type* dots,
           const Shape s) {
  using TO = typename Promote<TX, TY>::type;
  using A = typename Acc<TO>::type;
  using D = typename DotAcc<A>::type;
  constexpr int U = unroll<V>();

  const int t = threadIdx.x;
  const int lane = t / s.Qt;
  const int q = blockIdx.y * s.Qt + t % s.Qt;       // slot of the period
  const long long step = (long long)U * s.lanes;    // periods a tile

  D acc[3][V];
#pragma unroll
  for (int j = 0; j < V; ++j) acc[0][j] = acc[1][j] = acc[2][j] = D(0);

  if (lane < s.lanes && q < s.Q) {
    A ac[V], bc[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int col = (q * V + j) % s.bw;
      ac[j] = ca.at(col);
      bc[j] = cb.at(col);
    }
    for (long long tile = blockIdx.x; tile < s.ntiles; tile += s.nbx) {
      const long long p0 = tile * step + lane;
      const bool whole = (tile + 1) * step * s.P <= s.e_end;
      A xv[U][V], yv[U][V];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const long long e = (p0 + (long long)u * s.lanes) * s.P + q * V;
        load_entries<A, TX, V>(x, e, s.e_end, whole && s.vec_x, xv[u]);
        load_entries<A, TY, V>(y, e, s.e_end, whole && s.vec_y, yv[u]);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const long long e = (p0 + (long long)u * s.lanes) * s.P + q * V;
        Vec<TO, V> o;
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const A yn = ac[j] * xv[u][j] + bc[j] * yv[u][j];
          o.v[j] = store_as<TO>(yn);
          if constexpr (DOTS) {
            acc[0][j] += dot_term<D>(yn, yn);
            acc[1][j] += dot_term<D>(xv[u][j], yn);
            acc[2][j] += dot_term<D>(xv[u][j], xv[u][j]);
          }
        }
        if (whole) {
          *reinterpret_cast<Vec<TO, V>*>(out + e) = o;
        } else {
#pragma unroll
          for (int j = 0; j < V; ++j)
            if (e + j < s.e_end) out[e + j] = o.v[j];
        }
      }
    }
  }
  if constexpr (DOTS) finish_dots<A, D, V>(acc, part, gpart, counters, dots, s);
}

template <typename TX, typename TY>
int launch(const void* x, const void* y, const void* a_p, int a_width,
           double a_re, double a_im, const void* b_p, int b_width,
           double b_re, double b_im, void* out, void* part, void* gpart,
           void* counters, void* dots, long long n, int bw, int P, int nst,
           int nbx, int flags, cudaStream_t stream) {
  using TO = typename Promote<TX, TY>::type;
  using A = typename Acc<TO>::type;
  using D = typename DotAcc<A>::type;
  constexpr int V = 16 / (int)sizeof(TO);
  // the partition (kernels/fused_update.py:partition), checked against
  // the wrapper's
  int g = bw, h = V;
  while (h) { const int r = g % h; g = h; h = r; }
  const int Pk = bw / g * V, Q = Pk / V;
  const int nst_k = (Q + kThreads - 1) / kThreads;
  const int Qt = (Q + nst_k - 1) / nst_k;
  const int lanes = kThreads / Qt;
  const long long e_end = n * bw;
  const long long periods = (e_end + Pk - 1) / Pk;
  const long long step = (long long)unroll<V>() * lanes;
  const long long ntiles = (periods + step - 1) / step;
  if (P != Pk || nst != nst_k || nbx < 1 || (nbx > ntiles && ntiles > 0) ||
      (ntiles == 0 && !flags) || (reinterpret_cast<uintptr_t>(out) & 15))
    return (int)cudaErrorInvalidValue;
  const Shape s{e_end, ntiles, bw, Pk, Q, Qt, lanes, nbx,
                (nbx + kGroup - 1) / kGroup, flags,
                (int)((reinterpret_cast<uintptr_t>(x) % (sizeof(TX) * V)) == 0),
                (int)((reinterpret_cast<uintptr_t>(y) % (sizeof(TY) * V)) == 0)};
  const CoefArg<A> ca{static_cast<const A*>(a_p), a_width,
                      make_scalar<A>(a_re, a_im)};
  const CoefArg<A> cb{static_cast<const A*>(b_p), b_width,
                      make_scalar<A>(b_re, b_im)};
  const dim3 grid(nbx, nst);
  auto kern = flags ? axpby_dots<TX, TY, V, true> : axpby_dots<TX, TY, V, false>;
  kern<<<grid, kThreads, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TY*>(y), ca, cb,
      static_cast<TO*>(out), static_cast<D*>(part), static_cast<D*>(gpart),
      static_cast<unsigned*>(counters), static_cast<A*>(dots), s);
  return (int)cudaGetLastError();
}

#define B5_ARGS x, y, a_p, a_width, a_re, a_im, b_p, b_width, b_re, b_im, \
    out, part, gpart, counters, dots, n, bw, P, nst, nbx, flags, s

template <typename TX>
int launch_y(int y_dtype, const void* x, const void* y, const void* a_p,
             int a_width, double a_re, double a_im, const void* b_p,
             int b_width, double b_re, double b_im, void* out, void* part,
             void* gpart, void* counters, void* dots, long long n, int bw,
             int P, int nst, int nbx, int flags, cudaStream_t s) {
  switch (y_dtype) {
    case 0: return launch<TX, double>(B5_ARGS);
    case 1: return launch<TX, float>(B5_ARGS);
    case 2: return launch<TX, __nv_bfloat16>(B5_ARGS);
    case 3: return launch<TX, __half>(B5_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes: 0 float64, 1 float32, 2 bfloat16, 3 float16, 4 complex128,
// 5 complex64 (a complex x takes a y of its own type only).  A coefficient
// is (p, width, re, im): with p null the value re + i im (the imaginary
// part ignored for real types), else width (1 or bw) values of the
// accumulation type at p on the card.  With flags != 0 (1 <y',y'>,
// 2 <x,y'>, 4 <x,x>): part holds nbx * 3 * P and gpart ceil(nbx / 32) *
// 3 * P values of the dot type (complex128 for complex operands),
// counters ceil(nbx / 32) + 1 zeros (left zero), and dots 3 * bw values
// of the accumulation type.  P (the period) and nst (the slot tiles) come
// from kernels/fused_update.py:partition and are checked here; nbx is
// the number of blocks along x.  out has the promoted type of x and y and
// lies on a 16-byte boundary.  Returns the launch's CUDA error (0 on
// success).
extern "C" int fused_update_launch(int x_dtype, int y_dtype, const void* x,
                                   const void* y, const void* a_p,
                                   int a_width, double a_re, double a_im,
                                   const void* b_p, int b_width, double b_re,
                                   double b_im, void* out, void* part,
                                   void* gpart, void* counters, void* dots,
                                   long long n, int bw, int P, int nst,
                                   int nbx, int flags, void* stream) {
  if (n < 0 || bw < 1 || (flags & ~7) != 0 ||
      (a_p && a_width != 1 && a_width != bw) ||
      (b_p && b_width != 1 && b_width != bw) ||
      (flags && (!part || !gpart || !counters || !dots)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((x_dtype >= 4 || y_dtype >= 4) && x_dtype != y_dtype)
    return (int)cudaErrorInvalidValue;
  switch (x_dtype) {
    case 0: return launch_y<double>(y_dtype, B5_ARGS);
    case 1: return launch_y<float>(y_dtype, B5_ARGS);
    case 2: return launch_y<__nv_bfloat16>(y_dtype, B5_ARGS);
    case 3: return launch_y<__half>(y_dtype, B5_ARGS);
    case 4: return launch<Complex<double>, Complex<double>>(B5_ARGS);
    case 5: return launch<Complex<float>, Complex<float>>(B5_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
}

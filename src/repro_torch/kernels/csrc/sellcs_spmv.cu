// Fused SELL-C-sigma SpM(M)V for Hopper (sm_90a), paper C1 + C3.
//
// Replaces: repro/kernels/sellcs_spmv.py:sellcs_spmv_pallas (the Pallas TPU
// kernel, body `_kernel`).  Computes, for every fusion flag,
//
//   y    = alpha * (A - gamma I) x + beta * y_in     (gamma scalar or per column)
//   z    = delta * z_in + eta * y                     (chained axpby)
//   part = per-block <y,y>, <x,y>, <x,x>              ((nblocks, 3, b), float64)
//
// for real float64/float32 compute (values stored as float64, float32,
// bfloat16 or float16) and for complex128/complex64 compute (values stored
// as the compute type, as complex64 under complex128, or as a real type no
// wider than the compute type's parts: a real matrix times complex x).  For complex types <u,v> = sum conj(u) v, `part` is
// complex128, and alpha, beta, gamma, delta and eta may be complex.  The
// wrapper (kernels/sellcs_spmv.py) sums `part` over blocks in float64
// (complex128).
//
// Bound: memory bandwidth.  Each call must stream the stored values and
// column indices once (vals + cols), gather x and write y; at two flops per
// stored slot and column the kernel sits far below the card's ridge point.
//
// Design:
// * One kernel for real and complex values.  A thread block owns one
//   C-row chunk (one slice of up to 16 columns along grid.y), or with
//   dots kDotChunks consecutive chunks.  Each row is spread over TPR
//   neighbouring threads, and each thread owns CPT neighbouring columns
//   of it, loaded and stored as one 16-byte vector (double2 or float4;
//   two complex64 values, or one complex128 value) where the columns
//   allow (kernels/sellcs_spmv.py:launch_geometry picks TPR and CPT).  At
//   b = 16 in float64 that is 8 threads a row and 4 rows a warp: one warp
//   load of x reads 4 whole 128-byte rows, and the y and z stores are
//   contiguous.  At b = 1 it is one thread a row, as a plain SELL-C kernel.
//   Complex values without dots take 32 bytes of columns a thread (2
//   complex128 or 4 complex64 values, two vectors), so half the threads
//   of a row, and half the loads of each value and index.
// * The TPR threads of a row read the same vals[s] and cols[s]; the
//   chunk-column-major layout puts the slots of a chunk's neighbouring
//   rows next to each other, so those loads are broadcasts from one
//   sector and the value and index streams stay coalesced.
// * Gathers in flight set the pace.  A row's slots go kU at a time (8 for
//   real values, 6 for complex, 4 at 32 bytes a thread) and its last,
//   shorter group at its own length (one code path per length), values,
//   indices and gathers of a group in flight together: a 7-slot row is
//   one group, where a loop over the remainder slots one at a time left
//   each waiting for its index and then its gather.  The products are
//   added in slot order either way.  The kernel is held to 64 registers a
//   thread (__launch_bounds__ with two 512-thread blocks).
// * Dots are a template parameter: the instance without them keeps no dot
//   registers.  With dots a thread's running sums live in shared memory,
//   updated once a row, and a block walks kDotChunks chunks before its
//   one reduction (shuffles, a barrier, the warps' sums: at b = 4 the
//   128,000 per-chunk reductions of laplace3d(160) were as much as a
//   fifth of the call).  The wrapper sums one partial a block
//   (kernels/sellcs_spmv.py:dot_parts).  Complex64 and float32 at 512
//   threads need more than the default 48 KB of shared memory.
// * A block has at most kMaxThreads threads; a chunk whose C * TPR is
//   larger (any C: C = 1024, or one chunk of all rows, ELLPACK) is spread
//   over `parts` neighbouring blocks of blockDim / TPR rows each along
//   grid.x (kernels/sellcs_spmv.py:chunk_parts), so a tall chunk fills the
//   card instead of walking its rows in passes on one SM.  With dots,
//   block (group, part) writes partial group * parts + part.
// * Narrow stored values (bf16, f16, or f32 under f64 compute; complex64
//   under complex128) are upcast in registers, so the value stream moves
//   at the storage width.  Real values under a complex compute type (a
//   real matrix on complex vectors, kernels/ops.py) stay real in
//   registers: each product is then two fused multiply-adds, one a part
//   (Factor below), where a complex value with a zero imaginary part would
//   take four.
// * alpha, beta, delta, eta and gamma come by value (two doubles each) or,
//   for a tensor on the card, through a pointer (CoefPtrs; gamma of width
//   1 or b): the wrapper never reads a value on the host, so a call makes
//   no host sync (a Python-float gamma made one before; PERF.md, section
//   6).
// * The dots are reduced in a fixed order (each thread over its rows in
//   chunk and pass order, warp shuffles over the rows of a warp, then
//   warps in order through shared memory) without atomics, so results are
//   bit-for-bit reproducible from run to run.
// * Threads are rounded up to whole warps; rows >= C only feed zeros to
//   the reductions.
// * Each complex product is two fused multiply-adds per part.  On the
//   H100, more registers for deeper unrolling or for prefetching, two
//   vectors a thread for real values, persistent blocks, staging a
//   chunk's values and indices in shared memory and keeping its
//   neighbouring x rows there were all slower (PERF.md section 6).

#include <cuda_runtime.h>
#include <type_traits>

#include "dtypes.cuh"

namespace {

constexpr int kMaxThreads = 512;  // kernels/sellcs_spmv.py:MAX_THREADS
constexpr int kMaxBW = 16;        // columns of one grid.y slice
constexpr int kUnroll = 8;        // slots in flight per thread, long rows
constexpr int kUnrollCx = 6;      // slots in flight per thread, complex
constexpr int kUnrollCxWide = 4;  // ... with 32 bytes of columns a thread
constexpr int kDotChunks = 4;     // chunks of a block with dots
constexpr size_t kDefaultSmem = 48 * 1024;  // dynamic shared memory

enum Flags {
  kHasYin = 1,
  kHasGamma = 2,
  kChain = 4,
  kDotYY = 8,
  kDotXY = 16,
  kDotXX = 32,
};

// A 16-byte vector of the compute type, taken apart and put together.
__device__ __forceinline__ void split16(const double2& t, double* o) {
  o[0] = t.x;
  o[1] = t.y;
}
__device__ __forceinline__ void split16(const float4& t, float* o) {
  o[0] = t.x;
  o[1] = t.y;
  o[2] = t.z;
  o[3] = t.w;
}
__device__ __forceinline__ double2 join16(const double* o) {
  return make_double2(o[0], o[1]);
}
__device__ __forceinline__ float4 join16(const float* o) {
  return make_float4(o[0], o[1], o[2], o[3]);
}
__device__ __forceinline__ void split16(const float4& t, Complex<float>* o) {
  o[0] = Complex<float>(t.x, t.y);
  o[1] = Complex<float>(t.z, t.w);
}
__device__ __forceinline__ float4 join16(const Complex<float>* o) {
  return make_float4(o[0].re, o[0].im, o[1].re, o[1].im);
}
template <typename CT> struct Vec16;
template <> struct Vec16<double> { using type = double2; };
template <> struct Vec16<float> { using type = float4; };
template <> struct Vec16<Complex<float>> { using type = float4; };

// One value through the read-only data cache; a complex value as one
// 8- or 16-byte vector.
template <typename T> __device__ __forceinline__ T ldg_val(const T* p) {
  return __ldg(p);
}
__device__ __forceinline__ Complex<double> ldg_val(const Complex<double>* p) {
  const double2 t = __ldg(reinterpret_cast<const double2*>(p));
  return Complex<double>(t.x, t.y);
}
__device__ __forceinline__ Complex<float> ldg_val(const Complex<float>* p) {
  const float2 t = __ldg(reinterpret_cast<const float2*>(p));
  return Complex<float>(t.x, t.y);
}

// The type of the dot partials: float64, or complex128 for complex values;
// dot_term(u, v) is one term conj(u) v of <u, v> in that type.
template <typename CT> struct Dot { using type = double; };
template <typename R> struct Dot<Complex<R>> { using type = Complex<double>; };
template <typename CT> __device__ __forceinline__ double dot_term(CT u, CT v) {
  return (double)u * (double)v;
}
template <typename R>
__device__ __forceinline__ Complex<double> dot_term(Complex<R> u,
                                                    Complex<R> v) {
  return conj_of(Complex<double>(u.re, u.im)) * Complex<double>(v.re, v.im);
}

// CPT neighbouring values of the compute type: one value, or one or two
// 16-byte vectors (double2, float4; two complex64 values a vector; a
// complex128 value is one vector itself).
template <typename CT, int CPT> struct Pack {
  static constexpr int kPer = 16 / (int)sizeof(CT);  // values a vector
  CT v[CPT];
  __device__ __forceinline__ void load(const CT* p) {
    if constexpr (CPT == 1 || kPer == 1) {
#pragma unroll
      for (int e = 0; e < CPT; ++e) v[e] = ldg_val(p + e);
    } else {
#pragma unroll
      for (int h = 0; h < CPT / kPer; ++h)
        split16(__ldg(reinterpret_cast<const typename Vec16<CT>::type*>(
                    p + h * kPer)),
                v + h * kPer);
    }
  }
  __device__ __forceinline__ void store(CT* p) const {
    if constexpr (CPT == 1 || kPer == 1) {
#pragma unroll
      for (int e = 0; e < CPT; ++e) p[e] = v[e];
    } else {
#pragma unroll
      for (int h = 0; h < CPT / kPer; ++h)
        *reinterpret_cast<typename Vec16<CT>::type*>(p + h * kPer) =
            join16(v + h * kPer);
    }
  }
};

// Sum over the rows of a warp: lanes l, l + tpr, l + 2 tpr, ... hold the
// same columns; afterwards lane l < tpr holds their sum.
__device__ __forceinline__ double rows_sum(double v, int tpr) {
  for (int o = 16; o >= tpr; o >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ Complex<double> rows_sum(Complex<double> v,
                                                    int tpr) {
  return Complex<double>(rows_sum(v.re, tpr), rows_sum(v.im, tpr));
}

// The dots of a thread's columns, summed over its rows, dot k (yy, xy,
// xx) of column e, in shared memory (slot (k, e) of thread t at
// (k * CPT + e) * nt + t); NoDots takes none.
struct NoDots {
  template <typename DT> __device__ __forceinline__ void add(int, int, DT) {}
};
template <typename CT, int CPT> struct SharedDots {
  using DT = typename Dot<CT>::type;
  DT* p;
  int nt;
  __device__ __forceinline__ DT& at(int k, int e) const {
    return p[(k * CPT + e) * nt + threadIdx.x];
  }
  __device__ __forceinline__ void zero() const {
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int e = 0; e < CPT; ++e) at(k, e) = DT(0);
  }
  __device__ __forceinline__ void add(int k, int e, DT t) const {
    at(k, e) += t;
  }
  __device__ __forceinline__ DT get(int k, int e) const { return at(k, e); }
};

// Coefficients read on the card where the wrapper passes a tensor (no
// host sync): null where the value came by value.
template <typename CT> struct CoefPtrs {
  const CT *alpha, *beta, *delta, *eta;
};

// A row's sums acc (CPT columns from kk, at o = row * b + kk) through the
// shift, alpha, beta and the chain into y and z, and into the dots d.
template <typename CT, int CPT, typename Dots>
__device__ __forceinline__ void finish_row(
    const CT (&acc)[CPT], long long o, int kk, const CT* __restrict__ x,
    const CT* __restrict__ y_in, const CT* __restrict__ z_in,
    const CT* __restrict__ gamma, CT* __restrict__ y, CT* __restrict__ z,
    int gamma_width, CT gval, CT alpha, CT beta, CT delta, CT eta, int flags,
    bool need_xrow, Dots& d) {
  Pack<CT, CPT> xr, yv, yi, zi;
  if (need_xrow) xr.load(x + o);
  if (flags & kHasYin) yi.load(y_in + o);
  if (flags & kChain) zi.load(z_in + o);
#pragma unroll
  for (int e = 0; e < CPT; ++e) {
    CT av = acc[e];
    if (flags & kHasGamma)
      av -= (gamma_width == 0 ? gval
                              : gamma[gamma_width == 1 ? 0 : kk + e]) *
            xr.v[e];
    CT yvv = alpha * av;
    if (flags & kHasYin) yvv += beta * yi.v[e];
    yv.v[e] = yvv;
    if (flags & kChain) zi.v[e] = delta * zi.v[e] + eta * yvv;
    if (flags & kDotYY) d.add(0, e, dot_term(yvv, yvv));
    if (flags & kDotXY) d.add(1, e, dot_term(xr.v[e], yvv));
    if (flags & kDotXX) d.add(2, e, dot_term(xr.v[e], xr.v[e]));
  }
  yv.store(y + o);
  if (flags & kChain) zi.store(z + o);
}

// The block's dots in a fixed order (each thread's rows in chunk and pass
// order, the rows of a warp by shuffles, then the warps in order through
// warp_part, nwarps x 3 x bw values after the threads' sums) into
// part[prow].
template <typename CT, int CPT>
__device__ __forceinline__ void reduce_dots(
    const SharedDots<CT, CPT>& d, typename Dot<CT>::type* __restrict__ part,
    long long prow, int b, int bw, int tpr, int sub, int flags) {
  using DT = typename Dot<CT>::type;
  DT* warp_part = d.p + 3 * CPT * d.nt;
  const int warp = threadIdx.x >> 5;
  const int wl = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    if (!(flags & (kDotYY << k))) continue;
#pragma unroll
    for (int e = 0; e < CPT; ++e) {
      const DT s = rows_sum(d.get(k, e), tpr);
      if (wl < tpr) warp_part[(warp * 3 + k) * bw + sub * CPT + e] = s;
    }
  }
  __syncthreads();
  const int nwarps = blockDim.x >> 5;
  for (int t = threadIdx.x; t < 3 * bw; t += blockDim.x) {
    const int dd = t / bw;
    const int col = t % bw;
    const int k = blockIdx.y * bw + col;
    if (k < b) {
      DT s = DT(0);
      if (flags & (kDotYY << dd))
        for (int w = 0; w < nwarps; ++w)
          s += warp_part[(w * 3 + dd) * bw + col];
      part[(prow * 3 + dd) * b + k] = s;
    }
  }
}

// The type a stored value of type VT enters its products in under compute
// type CT: CT itself, or, for real values under a complex CT, the real type
// of CT's precision (mul_add of dtypes.cuh then takes two fused
// multiply-adds a product).
template <typename VT, typename CT> struct Factor { using type = CT; };
template <typename VT, typename R> struct Factor<VT, Complex<R>> {
  using type = std::conditional_t<IsComplex<VT>::value, Complex<R>, R>;
};

// N slots of a row from slot j: values, indices and gathers of all N in
// flight together, then the products added in slot order.
template <int N, typename VT, typename CT, int CPT>
__device__ __forceinline__ void slot_group(
    const VT* __restrict__ vals, const int* __restrict__ cols,
    const CT* __restrict__ x, long long base, int j, int C, int b, int kk,
    CT (&acc)[CPT]) {
  using F = typename Factor<VT, CT>::type;
  F a[N];
  int col[N];
#pragma unroll
  for (int u = 0; u < N; ++u) {
    const long long s = base + (long long)(j + u) * C;
    a[u] = load_as<F>(vals[s]);
    col[u] = __ldg(cols + s);
  }
  Pack<CT, CPT> xv[N];
#pragma unroll
  for (int u = 0; u < N; ++u) xv[u].load(x + (long long)col[u] * b + kk);
#pragma unroll
  for (int u = 0; u < N; ++u)
#pragma unroll
    for (int e = 0; e < CPT; ++e) acc[e] = mul_add(a[u], xv[u].v[e], acc[e]);
}

// A row's last n slots, 1 <= n < N, as one group of their own length.
template <int N, typename VT, typename CT, int CPT>
__device__ __forceinline__ void tail_group(
    int n, const VT* __restrict__ vals, const int* __restrict__ cols,
    const CT* __restrict__ x, long long base, int j, int C, int b, int kk,
    CT (&acc)[CPT]) {
  if constexpr (N > 1) {
    if (n == N - 1)
      slot_group<N - 1>(vals, cols, x, base, j, C, b, kk, acc);
    else
      tail_group<N - 1>(n, vals, cols, x, base, j, C, b, kk, acc);
  }
}

// Slots in flight a thread: kUnroll for real values, kUnrollCx for 16
// bytes of complex columns a thread, kUnrollCxWide for 32.
template <typename CT, int CPT> __host__ __device__ constexpr int unroll() {
  if constexpr (!IsComplex<CT>::value) return kUnroll;
  return sizeof(CT) * CPT > 16 ? kUnrollCxWide : kUnrollCx;
}

// The kernel (see the note at the top).  With DOTS a block walks
// kDotChunks chunks and writes part[blockIdx.x]; its dynamic shared
// memory holds 3 x CPT dot sums of each thread, then the warps' sums
// (nwarps x 3 x bw).
template <typename VT, typename CT, int CPT, bool DOTS>
__global__ void __launch_bounds__(kMaxThreads, 2)
sellcs_spmv_fused(const VT* __restrict__ vals, const int* __restrict__ cols,
                  const int* __restrict__ chunk_off,
                  const int* __restrict__ chunk_len, const CT* __restrict__ x,
                  const CT* __restrict__ y_in, const CT* __restrict__ z_in,
                  const CT* __restrict__ gamma, CT* __restrict__ y,
                  CT* __restrict__ z, typename Dot<CT>::type* __restrict__ part,
                  int nchunks, int C, int b, int bw, int tpr, int parts,
                  int gamma_width, CT gval, CT alpha, CT beta, CT delta,
                  CT eta, const CoefPtrs<CT> cp, int flags) {
  using DT = typename Dot<CT>::type;
  constexpr int kU = unroll<CT, CPT>();
  constexpr int K = DOTS ? kDotChunks : 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const SharedDots<CT, CPT> d{reinterpret_cast<DT*>(smem), (int)blockDim.x};

  const int sub = threadIdx.x % tpr;
  const int rip = threadIdx.x / tpr;  // row within a pass
  const int rows_per_pass = blockDim.x / tpr;
  const int kk = blockIdx.y * bw + sub * CPT;  // first column of the thread
  const bool col_ok = kk < b;  // CPT > 1: b % CPT == 0, all or none
  const bool need_xrow = flags & (kHasGamma | kDotXY | kDotXX);
  const int row_flags = DOTS ? flags : flags & ~(kDotYY | kDotXY | kDotXX);
  if constexpr (DOTS) d.zero();
  if (cp.alpha) alpha = *cp.alpha;
  if (cp.beta) beta = *cp.beta;
  if (cp.delta) delta = *cp.delta;
  if (cp.eta) eta = *cp.eta;

  // a chunk's rows [r_begin, r_end): all of them in passes where the
  // chunk has one block, else this block's one pass of them
  const int group = blockIdx.x / parts;
  const int r_begin = (blockIdx.x % parts) * rows_per_pass;
  const int r_end = parts > 1 ? min(C, r_begin + rows_per_pass) : C;
  const int c_end = min(nchunks, (group + 1) * K);
  for (int c = group * K; c < c_end; ++c) {
    const long long off = (long long)chunk_off[c] * C;
    const int len = chunk_len[c];
    for (int r0 = r_begin; r0 < r_end; r0 += rows_per_pass) {
      const int lr = r0 + rip;
      if (lr >= r_end || !col_ok) continue;
      const long long row = (long long)c * C + lr;
      const long long base = off + lr;

      CT acc[CPT];
#pragma unroll
      for (int e = 0; e < CPT; ++e) acc[e] = CT(0);
      int j = 0;
      for (; j + kU <= len; j += kU)
        slot_group<kU>(vals, cols, x, base, j, C, b, kk, acc);
      if (j < len)  // the same for the whole block
        tail_group<kU>(len - j, vals, cols, x, base, j, C, b, kk, acc);
      if constexpr (DOTS) {
        finish_row<CT, CPT>(acc, row * b + kk, kk, x, y_in, z_in, gamma, y,
                            z, gamma_width, gval, alpha, beta, delta, eta,
                            row_flags, need_xrow, d);
      } else {
        NoDots none;
        finish_row<CT, CPT>(acc, row * b + kk, kk, x, y_in, z_in, gamma, y,
                            z, gamma_width, gval, alpha, beta, delta, eta,
                            row_flags, need_xrow, none);
      }
    }
  }

  if constexpr (DOTS)
    reduce_dots<CT, CPT>(d, part, blockIdx.x, b, bw, tpr, sub, flags);
}

struct Args {
  const void* vals;
  const int* cols;
  const int* chunk_off;
  const int* chunk_len;
  const void* x;
  const void* y_in;
  const void* z_in;
  const void* gamma;
  void* y;
  void* z;
  void* part;
  int nchunks, C, b, bw, tpr, threads, parts, gamma_width, flags;
  double alpha, beta, delta, eta;           // real parts
  double alpha_im, beta_im, delta_im, eta_im;  // imaginary parts
  double gamma_re, gamma_im;                // gamma by value (width 0)
  const void *alpha_p, *beta_p, *delta_p, *eta_p;  // or on the card
};

// The instance with or without dots, and with dots its shared memory,
// above the default 48 KB for complex64 and float32 at 512 threads.
// 32 bytes of columns a thread are taken without dots only.
template <typename VT, typename CT, int CPT>
int launch(const Args& a, cudaStream_t stream) {
  using DT = typename Dot<CT>::type;
  const bool dots = a.flags & (kDotYY | kDotXY | kDotXX);
  const long long groups =
      dots ? (a.nchunks + kDotChunks - 1) / kDotChunks : a.nchunks;
  if (groups * a.parts > 0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)(groups * a.parts), (a.b + a.bw - 1) / a.bw);
  const size_t smem =
      dots ? (size_t)(3 * CPT * a.threads + a.threads / 32 * 3 * a.bw) *
                 sizeof(DT)
           : 0;
  auto kern = sellcs_spmv_fused<VT, CT, CPT, false>;
  if constexpr (sizeof(CT) * CPT <= 16) {
    if (dots) kern = sellcs_spmv_fused<VT, CT, CPT, true>;
  } else if (dots) {
    return (int)cudaErrorInvalidValue;
  }
  if (smem > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<grid, a.threads, smem, stream>>>(
      static_cast<const VT*>(a.vals), a.cols, a.chunk_off, a.chunk_len,
      static_cast<const CT*>(a.x), static_cast<const CT*>(a.y_in),
      static_cast<const CT*>(a.z_in), static_cast<const CT*>(a.gamma),
      static_cast<CT*>(a.y), static_cast<CT*>(a.z),
      static_cast<DT*>(a.part), a.nchunks, a.C, a.b, a.bw, a.tpr, a.parts,
      a.gamma_width, make_scalar<CT>(a.gamma_re, a.gamma_im),
      make_scalar<CT>(a.alpha, a.alpha_im),
      make_scalar<CT>(a.beta, a.beta_im), make_scalar<CT>(a.delta, a.delta_im),
      make_scalar<CT>(a.eta, a.eta_im),
      CoefPtrs<CT>{static_cast<const CT*>(a.alpha_p),
                   static_cast<const CT*>(a.beta_p),
                   static_cast<const CT*>(a.delta_p),
                   static_cast<const CT*>(a.eta_p)},
      a.flags);
  return 0;
}

// CPT is 1, one 16-byte vector of the compute type, or (complex values
// without dots) two.
template <typename VT, typename CT>
int launch_cpt(int cpt, const Args& a, cudaStream_t stream) {
  constexpr int kVec = 16 / (int)sizeof(CT);
  if (cpt == 1) return launch<VT, CT, 1>(a, stream);
  if constexpr (kVec > 1) {
    if (cpt == kVec) return launch<VT, CT, kVec>(a, stream);
  }
  if constexpr (IsComplex<CT>::value) {
    if (cpt == 2 * kVec) return launch<VT, CT, 2 * kVec>(a, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// store: 0 float64, 1 float32, 2 bfloat16, 3 float16, 4 complex128,
// 5 complex64; compute: 0 float64, 1 float32, 2 complex128 (any store),
// 3 complex64 (store 1, 2, 3 or 5): a store no wider than the compute
// type (torch.promote_types of the two is the compute type).  part holds float64 partials, complex128 for a
// complex compute type; the coefficients come as real and imaginary
// parts (the imaginary parts are ignored for a real compute type), or,
// where alpha_p ... eta_p is not null, as one value of the compute type
// on the card; gamma (with the gamma flag) by value where gamma_width is
// 0, else as gamma_width (1 or b) values on the card.  bw
// (columns per grid.y slice, <= 16), tpr (threads per row), cpt (columns
// per thread, tpr * cpt == bw) and threads (per block) come
// from kernels/sellcs_spmv.py:launch_geometry, parts (blocks a chunk,
// each of threads / tpr rows, or 1) from chunk_parts; with dots part holds
// dot_parts(nchunks, parts) rows; cpt > 1 needs b % cpt == 0
// and x, y_in, z_in, y and z on 16-byte boundaries.  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int sellcs_spmv_launch(
    int store, int compute, const void* vals, const void* cols,
    const void* chunk_off, const void* chunk_len, const void* x,
    const void* y_in, const void* z_in, const void* gamma, void* y, void* z,
    void* part, int nchunks, int C, int b, int bw, int tpr, int cpt,
    int threads, int parts, int gamma_width, double alpha, double beta, double delta,
    double eta, double alpha_im, double beta_im, double delta_im,
    double eta_im, double gamma_re, double gamma_im, const void* alpha_p,
    const void* beta_p, const void* delta_p, const void* eta_p, int flags,
    void* stream) {
  if (C < 1 || nchunks < 1 || b < 1 || bw < 1 || bw > kMaxBW || tpr < 1 ||
      cpt < 1 || tpr * cpt != bw || (cpt > 1 && b % cpt) || threads < 32 ||
      threads > kMaxThreads || threads % 32 || 32 % tpr || parts < 1 ||
      (parts > 1 && (long long)(parts - 1) * (threads / tpr) >= C))
    return (int)cudaErrorInvalidValue;
  const Args a{vals, static_cast<const int*>(cols),
               static_cast<const int*>(chunk_off),
               static_cast<const int*>(chunk_len), x, y_in, z_in, gamma, y, z,
               part, nchunks, C, b, bw, tpr, threads, parts, gamma_width,
               flags,
               alpha, beta, delta, eta, alpha_im, beta_im, delta_im, eta_im,
               gamma_re, gamma_im, alpha_p, beta_p, delta_p, eta_p};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  if (compute == 0) {
    switch (store) {
      case 0: rc = launch_cpt<double, double>(cpt, a, s); break;
      case 1: rc = launch_cpt<float, double>(cpt, a, s); break;
      case 2: rc = launch_cpt<__nv_bfloat16, double>(cpt, a, s); break;
      case 3: rc = launch_cpt<__half, double>(cpt, a, s); break;
      default: return (int)cudaErrorInvalidValue;
    }
  } else if (compute == 1) {
    switch (store) {
      case 1: rc = launch_cpt<float, float>(cpt, a, s); break;
      case 2: rc = launch_cpt<__nv_bfloat16, float>(cpt, a, s); break;
      case 3: rc = launch_cpt<__half, float>(cpt, a, s); break;
      default: return (int)cudaErrorInvalidValue;
    }
  } else if (compute == 2) {
    using Z = Complex<double>;
    switch (store) {
      case 0: rc = launch_cpt<double, Z>(cpt, a, s); break;
      case 1: rc = launch_cpt<float, Z>(cpt, a, s); break;
      case 2: rc = launch_cpt<__nv_bfloat16, Z>(cpt, a, s); break;
      case 3: rc = launch_cpt<__half, Z>(cpt, a, s); break;
      case 4: rc = launch_cpt<Z, Z>(cpt, a, s); break;
      case 5: rc = launch_cpt<Complex<float>, Z>(cpt, a, s); break;
      default: return (int)cudaErrorInvalidValue;
    }
  } else if (compute == 3) {
    using Z = Complex<float>;
    switch (store) {
      case 1: rc = launch_cpt<float, Z>(cpt, a, s); break;
      case 2: rc = launch_cpt<__nv_bfloat16, Z>(cpt, a, s); break;
      case 3: rc = launch_cpt<__half, Z>(cpt, a, s); break;
      case 5: rc = launch_cpt<Z, Z>(cpt, a, s); break;
      default: return (int)cudaErrorInvalidValue;
    }
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

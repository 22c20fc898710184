// Batched block-diagonal matmul for Hopper (sm_90a): the block-Jacobi apply.
//
// Replaces: repro/kernels/block_diag.py:block_diag_matmul_pallas (the Pallas
// TPU kernel, body `_kernel`).  Computes
//
//   y[k*bs + i, c] = sum_j B[k, i, j] * x[k*bs + j, c]
//
// for a stack B of nblocks dense (bs, bs) blocks, row-major, and x, y of
// shape (nblocks*bs, b), row-major.  B and x may have different real
// types (float64, float32, bfloat16, float16); y has their promoted type
// and the sums run in its accumulation type (float32 for the half types,
// else the type itself).  Complex blocks (complex128, complex64) take x
// of their type or real x of their precision, and complex64 blocks take
// complex128 x (the blocks widened exactly as they are read); y is
// complex.  A complex product is four fused multiply-adds, a complex block
// entry times a real x two.  Real blocks with complex x never reach this
// file: kernels/ops.py runs them as a real product over x's interleaved
// (re, im) columns, which is exact.
//
// Bound: memory bandwidth.  The call must read the blocks once,
// nblocks * bs^2 values, and x and y once, 2 * nblocks * bs * b values, for
// 2 * nblocks * bs^2 * b flops; at bs = 32, b = 4 in float64 the blocks are
// 8 / 9 of the bytes and the work is a quarter of a flop per byte.  The
// blocks must stream coalesced and each of their entries must feed all b
// columns from registers or shared memory, never be read again.
//
// Design:
// * A thread block owns G consecutive diagonal blocks (G * bs <= 256 rows),
//   whose G * bs^2 entries are one contiguous range of B: its threads copy
//   that range into shared memory with neighbouring threads on
//   neighbouring addresses (coalesced), each thread with 16 loads in
//   flight before it stores, padding each row to bs + 1 entries so that
//   the compute loop reads without bank conflicts.  The G * bs rows
//   of x (one contiguous range too) follow into shared memory.
// * One thread per row then forms its b outputs, four columns at a time in
//   registers, summing over j in order: x is read as a broadcast, the row
//   of B from its padded slot.  The result is rounded once to y's type.
// * G is the largest group of at most 256 rows whose staged blocks and x
//   rows take at most 64 KB of shared memory (so three thread blocks fit
//   on an SM), at least one block; the last thread block may own fewer.
//   No padding of x or of the stack is needed.
// * The TPU kernel's row_tile (a VMEM tile of whole blocks) has no
//   counterpart: the tile here is G blocks, fixed by bs and b.
// * Past bs = 64 (block_diag_stream below) the call is a pure stream: at
//   bs = 128, b = 4 in float64 the blocks are 94 % of the bytes.  A
//   persistent grid (the occupancy API's blocks an SM times the SMs, at
//   most one a diagonal block) walks the diagonal blocks blockIdx.x,
//   blockIdx.x + gridDim.x, ...; each thread block streams its blocks'
//   rows, TR whole rows a stage (TR * bs contiguous entries, about 16 KB),
//   through a ring of four shared-memory stages filled by 16-byte cp.async
//   copies, three stages ahead of the compute, so the first stage of a
//   diagonal block is in flight while the one before is summed.  With the
//   first stage of a diagonal block its bs x b slice of x comes into one of
//   two buffers, transposed (column by column), once.  P = 128 / TR
//   neighbouring threads share a row: thread p reads the row's 16-byte
//   chunks p, p + P, ... (a quarter warp reads 128 contiguous bytes) and
//   the matching runs of each column of x (a broadcast across the warp's
//   rows), and spends exactly b fused multiply-adds on each entry it
//   reads; the P partial sums of a row are added by a butterfly of
//   shuffles, and threads p write y's row whole (column c by thread c mod
//   P).  Every output is summed in the same order on every call: each
//   thread's chunks in order, then the butterfly.  Rows whose bytes are
//   not a multiple of 16 are padded to it in shared memory (filled value
//   by value); a width b past 16 runs in passes of 16 columns (x and y
//   read and written with their row stride b).  Only a block larger than
//   the stages and the x buffers can hold in 227 KB (bs past 1,614 in
//   float64, 3,228 in float32, 807 in complex128) takes
//   block_diag_tiled: a 64-row tile of one
//   diagonal block a thread block, its columns in slabs of 32 staged with
//   the next slab's loads in registers, four threads a row.  At bs = 128,
//   b = 4 in float64 that tiled kernel took 2.931 ms against bmm's 1.509
//   (PERF.md): its first slab's load never overlapped, its
//   16-column x staging spent three of four multiply-adds on zeros at
//   b = 4, and it spilled.

#include <cuda_runtime.h>
#include <stdint.h>
#include <type_traits>

#include "dtypes.cuh"
#include "launch.cuh"

namespace {

constexpr int kMaxRows = 256;      // G * bs, the threads of a block
constexpr int kMaxBs = 64;        // largest bs of the staged groups
constexpr int kColTile = 4;        // outputs a thread keeps in registers
constexpr int kInFlight = 16;      // loads a thread issues before storing
constexpr int kSmemTarget = 64 * 1024;
constexpr int kMaxSmem = 232448;   // a block's shared memory on the H100
constexpr int kTileRows = 64;      // block_diag_tiled: rows of a tile
constexpr int kSlab = 32;          // ... columns j of a slab
constexpr int kColBlock = 16;      // ... columns of x a pass
constexpr int kRowThreads = 4;     // ... threads of a row

// Copies n values of src (global) into dst (shared), converted to A, at
// dst[e + e / pad_every] (pad_every = 0: no padding): each thread issues
// kInFlight independent, coalesced loads before it stores any of them.
template <typename A, typename T>
__device__ __forceinline__ void stage(A* __restrict__ dst,
                                      const T* __restrict__ src, int n,
                                      int pad_every) {
  const int t = threadIdx.x, nt = blockDim.x;
  for (int base = 0; base < n; base += kInFlight * nt) {
    A v[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int e = base + u * nt + t;
      v[u] = e < n ? load_as<A>(src[e]) : A(0);
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int e = base + u * nt + t;
      if (e < n) dst[pad_every ? e + e / pad_every : e] = v[u];
    }
  }
}

// Blocks of the stack per thread block: as many as fit in kMaxRows threads
// and kSmemTarget bytes of staged blocks and x rows, at least one.
int group_size(int bs, int b, int acc_bytes) {
  const long long per_block =
      ((long long)bs * (bs + 1) + (long long)bs * b) * acc_bytes;
  int g = kMaxRows / bs;
  while (g > 1 && g * per_block > kSmemTarget) --g;
  return g;
}

template <typename TB, typename TX>
__global__ void __launch_bounds__(kMaxRows)
block_diag_rows(const TB* __restrict__ blocks, const TX* __restrict__ x,
                typename Promote<TB, TX>::type* __restrict__ y,
                long long nblocks, int bs, int b, int group) {
  using TO = typename Promote<TB, TX>::type;
  using A = typename Acc<TO>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  A* sb = reinterpret_cast<A*>(smem_raw);        // [G * bs][bs + 1]
  A* sx = sb + (long long)group * bs * (bs + 1);  // [G * bs][b]

  const long long first = (long long)blockIdx.x * group;
  long long left = nblocks - first;
  const int nb = left < group ? (int)left : group;
  const int rows = nb * bs;
  const int t = threadIdx.x;

  // the nb blocks are one contiguous range of rows * bs entries; entry e
  // (row e / bs) lands at (e / bs) * (bs + 1) + e % bs = e + e / bs
  stage(sb, blocks + first * bs * bs, rows * bs, bs);
  const long long xoff = first * bs * b;
  stage(sx, x + xoff, rows * b, 0);
  __syncthreads();

  if (t >= rows) return;
  const A* brow = sb + t * (bs + 1);
  const A* xblk = sx + (t / bs) * bs * b;         // x rows of t's block
  TO* yrow = y + xoff + (long long)t * b;
  for (int c0 = 0; c0 < b; c0 += kColTile) {
    A acc[kColTile];
#pragma unroll
    for (int q = 0; q < kColTile; ++q) acc[q] = A(0);
    if (c0 + kColTile <= b) {
      for (int j = 0; j < bs; ++j) {
        const A bij = brow[j];
        const A* xj = xblk + j * b + c0;
#pragma unroll
        for (int q = 0; q < kColTile; ++q) acc[q] = mul_add(bij, xj[q], acc[q]);
      }
#pragma unroll
      for (int q = 0; q < kColTile; ++q) yrow[c0 + q] = store_as<TO>(acc[q]);
    } else {
      const int nc = b - c0;
      for (int j = 0; j < bs; ++j) {
        const A bij = brow[j];
        const A* xj = xblk + j * b + c0;
#pragma unroll
        for (int q = 0; q < kColTile; ++q)
          if (q < nc) acc[q] = mul_add(bij, xj[q], acc[q]);
      }
#pragma unroll
      for (int q = 0; q < kColTile; ++q)
        if (q < nc) yrow[c0 + q] = store_as<TO>(acc[q]);
    }
  }
}

// y = B x for a diagonal block the stream cannot stage (see the note at
// the top): block blockIdx.x owns row tile blockIdx.x % rtiles of diagonal
// block blockIdx.x / rtiles.  Two blocks an SM, so that the float64
// instance keeps its values in registers (it spilled at three).
template <typename TB, typename TX>
__global__ void __launch_bounds__(kTileRows * kRowThreads, 2)
block_diag_tiled(const TB* __restrict__ blocks, const TX* __restrict__ x,
                 typename Promote<TB, TX>::type* __restrict__ y, int bs,
                 int b, int rtiles) {
  using TO = typename Promote<TB, TX>::type;
  using A = typename Acc<TO>::type;
  constexpr int kT = kTileRows * kRowThreads;
  constexpr int kEachB = kTileRows * kSlab / kT;   // B values a thread a slab
  constexpr int kEachX = kSlab * kColBlock / kT;   // x values a thread a slab
  constexpr int kCols = kColBlock / kRowThreads;   // outputs a thread a pass
  __shared__ A sb[kTileRows][kSlab + 1];
  __shared__ A sx[kSlab][kColBlock];
  const long long blk = blockIdx.x / rtiles;
  const int i0 = (blockIdx.x % rtiles) * kTileRows;
  const TB* B = blocks + blk * bs * bs;
  const TX* xb = x + blk * bs * b;
  TO* yb = y + blk * bs * b;
  const int t = threadIdx.x;
  const int row = t / kRowThreads, sub = t % kRowThreads;

  for (int c0 = 0; c0 < b; c0 += kColBlock) {
    const int nc = min(kColBlock, b - c0);
    A vb[kEachB], vx[kEachX];
    auto load = [&](int j0) {
#pragma unroll
      for (int u = 0; u < kEachB; ++u) {
        const int e = u * kT + t;
        const int r = e / kSlab, j = e % kSlab;
        vb[u] = (i0 + r < bs && j0 + j < bs)
                    ? load_as<A>(B[(long long)(i0 + r) * bs + j0 + j])
                    : A(0);
      }
#pragma unroll
      for (int u = 0; u < kEachX; ++u) {
        const int e = u * kT + t;
        const int j = e / kColBlock, c = e % kColBlock;
        vx[u] = (j0 + j < bs && c < nc)
                    ? load_as<A>(xb[(long long)(j0 + j) * b + c0 + c])
                    : A(0);
      }
    };
    A acc[kCols];
#pragma unroll
    for (int q = 0; q < kCols; ++q) acc[q] = A(0);
    load(0);
#pragma unroll 1
    for (int j0 = 0; j0 < bs; j0 += kSlab) {
      __syncthreads();  // every thread is done with the slab before
#pragma unroll
      for (int u = 0; u < kEachB; ++u) {
        const int e = u * kT + t;
        sb[e / kSlab][e % kSlab] = vb[u];
      }
#pragma unroll
      for (int u = 0; u < kEachX; ++u) {
        const int e = u * kT + t;
        sx[e / kColBlock][e % kColBlock] = vx[u];
      }
      __syncthreads();
      if (j0 + kSlab < bs) load(j0 + kSlab);
      const int nj = min(kSlab, bs - j0);
      for (int j = 0; j < nj; ++j) {
        const A bij = sb[row][j];
#pragma unroll
        for (int q = 0; q < kCols; ++q)
          acc[q] = mul_add(bij, sx[j][sub + kRowThreads * q], acc[q]);
      }
    }
    if (i0 + row < bs) {
#pragma unroll
      for (int q = 0; q < kCols; ++q) {
        const int c = sub + kRowThreads * q;
        if (c < nc)
          yb[(long long)(i0 + row) * b + c0 + c] = store_as<TO>(acc[q]);
      }
    }
  }
}

// ------------------------------------------------------------ the stream
constexpr int kStreamThreads = 128;     // threads of a block_diag_stream block
constexpr int kStreamStages = 4;        // the ring
constexpr int kStreamStageBytes = 16384;  // bytes of B a stage, at most
constexpr int kStreamMaxCols = 16;      // columns of one pass

template <typename T> struct RealOf { using type = T; };
template <typename R> struct RealOf<Complex<R>> { using type = R; };

// x's value as a product takes it: the accumulation type, or for real x
// under complex blocks the real type (two fused multiply-adds a product)
template <typename A, typename TX> struct XFactor {
  using type = std::conditional_t<IsComplex<A>::value && !IsComplex<TX>::value,
                                  typename RealOf<A>::type, A>;
};

template <typename A> __device__ __forceinline__ A prod_add(A b, A x, A acc) {
  return mul_add(b, x, acc);
}
template <typename R>
__device__ __forceinline__ Complex<R> prod_add(Complex<R> b, R x,
                                               Complex<R> acc) {
  return mul_add(x, b, acc);
}

__device__ __forceinline__ double shfl_xor(double v, int o) {
  return __shfl_xor_sync(0xffffffffu, v, o);
}
__device__ __forceinline__ float shfl_xor(float v, int o) {
  return __shfl_xor_sync(0xffffffffu, v, o);
}
template <typename R>
__device__ __forceinline__ Complex<R> shfl_xor(Complex<R> v, int o) {
  return Complex<R>(shfl_xor(v.re, o), shfl_xor(v.im, o));
}

// N consecutive values of T in shared memory, N * sizeof(T) bytes aligned to
// that size where it is 8 or 16 (one vector load)
template <typename T, int N> struct alignas(N * sizeof(T) == 16   ? 16
                                            : N * sizeof(T) == 8 ? 8
                                                                 : sizeof(T))
    Run {
  T v[N];
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
template <int N> __device__ __forceinline__ void cp_async(void* dst,
                                                          const void* src) {
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_addr(dst)), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                     smem_addr(dst)), "l"(src), "n"(N) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One value of T global -> shared: cp.async where T is 4, 8 or 16 bytes,
// else a plain load and store.
template <typename T>
__device__ __forceinline__ void copy_value(T* dst, const T* src) {
  if constexpr (sizeof(T) == 4 || sizeof(T) == 8 || sizeof(T) == 16)
    cp_async<(int)sizeof(T)>(dst, src);
  else
    *dst = *src;
}

// y = B x past bs = 64 (see the note at the top), for columns [c0, c0 + nc)
// of x and y (row stride ldx), nc <= CB.  Shared memory: kStreamStages
// stages of TR rows of B, each row padded to rs values (a multiple of 16
// bytes), then two buffers of x's slice, column c of it at c * rs.
template <typename TB, typename TX, int CB>
__global__ void __launch_bounds__(kStreamThreads)
block_diag_stream(const TB* __restrict__ blocks, const TX* __restrict__ x,
                  typename Promote<TB, TX>::type* __restrict__ y,
                  long long nblocks, int bs, int ldx, int c0, int nc, int tr,
                  int rs, int stage_vals, int whole) {
  using TO = typename Promote<TB, TX>::type;
  using A = typename Acc<TO>::type;
  using XV = typename XFactor<A, TX>::type;
  constexpr int V = 16 / (int)sizeof(TB);   // B values of a 16-byte chunk
  constexpr int S = kStreamStages;
  extern __shared__ __align__(16) unsigned char smem[];
  TB* ring = reinterpret_cast<TB*>(smem);
  TX* xbuf = reinterpret_cast<TX*>(smem + (size_t)S * stage_vals * sizeof(TB));
  const int xvals = CB * rs;  // values of one x buffer
  const int t = threadIdx.x;
  const int P = kStreamThreads / tr;  // threads of a row
  const int row = t / P, p = t % P;
  const int rtiles = (bs + tr - 1) / tr;
  const long long G = gridDim.x;
  const long long mine = (nblocks - blockIdx.x + G - 1) / G;
  const long long total = mine * rtiles;  // stages this thread block sums

  // the padding (row values past bs, x values past bs) stays zero
  {
    const int words = (int)(((size_t)S * stage_vals * sizeof(TB) +
                             2 * (size_t)xvals * sizeof(TX)) / 4);
    uint32_t* z = reinterpret_cast<uint32_t*>(smem);
    for (int o = t; o < words; o += kStreamThreads) z[o] = 0u;
  }
  __syncthreads();

  auto fill = [&](long long tau) {
    if (tau < total) {
      const long long kb = blockIdx.x + (tau / rtiles) * G;
      const int rt = (int)(tau % rtiles);
      const int r0 = rt * tr;
      const int rows = min(tr, bs - r0);
      TB* st = ring + (int)(tau % S) * stage_vals;
      const TB* src = blocks + (kb * bs + r0) * bs;
      if (whole) {  // rows of 16-byte multiples, B on 16 bytes: one run
        const int nq = rows * bs / V;
        for (int q = t; q < nq; q += kStreamThreads)
          cp_async<16>(st + q * V, src + (long long)q * V);
      } else {
        for (int e = t; e < rows * bs; e += kStreamThreads)
          copy_value(st + (e / bs) * rs + e % bs, src + e);
      }
      if (rt == 0) {  // the diagonal block's slice of x, transposed
        TX* xs = xbuf + (int)((tau / rtiles) & 1) * xvals;
        const TX* xsrc = x + kb * bs * ldx + c0;
        for (int e = t; e < bs * nc; e += kStreamThreads) {
          const int j = e / nc, c = e % nc;
          copy_value(xs + c * rs + j, xsrc + (long long)j * ldx + c);
        }
      }
    }
    cp_commit();  // empty groups keep the count uniform
  };

#pragma unroll 1
  for (int s = 0; s < S - 1; ++s) fill(s);
#pragma unroll 1
  for (long long tau = 0; tau < total; ++tau) {
    cp_wait<S - 2>();
    __syncthreads();  // stage tau is in; the stage of tau - 1 is free
    fill(tau + S - 1);
    const long long kb = blockIdx.x + (tau / rtiles) * G;
    const int r0 = (int)(tau % rtiles) * tr;
    const TB* brow = ring + (int)(tau % S) * stage_vals + row * rs;
    const TX* xs = xbuf + (int)((tau / rtiles) & 1) * xvals;
    A acc[CB];
#pragma unroll
    for (int c = 0; c < CB; ++c) acc[c] = A(0);
    const int nq = rs / V;  // chunks of a padded row
#pragma unroll 2
    for (int q = p; q < nq; q += P) {
      const Run<TB, V> bv = *reinterpret_cast<const Run<TB, V>*>(brow + q * V);
#pragma unroll
      for (int c = 0; c < CB; ++c) {
        if (c < nc) {
          const Run<TX, V> xv =
              *reinterpret_cast<const Run<TX, V>*>(xs + c * rs + q * V);
#pragma unroll
          for (int e = 0; e < V; ++e)
            acc[c] = prod_add(load_as<A>(bv.v[e]), load_as<XV>(xv.v[e]),
                              acc[c]);
        }
      }
    }
    // the row's P partial sums, by a butterfly (every lane ends with the
    // same bits: each addition is commutative)
    for (int o = P / 2; o > 0; o >>= 1)
#pragma unroll
      for (int c = 0; c < CB; ++c) acc[c] += shfl_xor(acc[c], o);
    if (r0 + row < bs) {
      TO* yrow = y + (kb * bs + r0 + row) * ldx + c0;
#pragma unroll
      for (int c = 0; c < CB; ++c)
        if (c < nc && c % P == p) yrow[c] = store_as<TO>(acc[c]);
    }
  }
  cp_wait<0>();  // no copy outlives the block
}

// The stream's layout for (bs, a pass of cb columns), and whether it fits
// one block's shared memory: TR rows a stage (16, 8 or 4: the most whose
// bytes stay within kStreamStageBytes), rows padded to rs values.
struct StreamShape {
  int tr, rs, stage_vals;
  size_t smem;
};
template <typename TB, typename TX>
StreamShape stream_shape(int bs, int cb) {
  constexpr int V = 16 / (int)sizeof(TB);
  StreamShape sh;
  sh.rs = (bs + V - 1) / V * V;
  sh.tr = 16;
  // at most 16 KB a stage, and at least three stages a diagonal block, so
  // that the ring never holds stages of three diagonal blocks (two x
  // buffers)
  while (sh.tr > 4 &&
         ((long long)sh.tr * sh.rs * sizeof(TB) > kStreamStageBytes ||
          (bs + sh.tr - 1) / sh.tr < kStreamStages - 1))
    sh.tr /= 2;
  sh.stage_vals = sh.tr * sh.rs;
  const size_t xbytes = (size_t)cb * sh.rs * sizeof(TX);
  sh.smem = (size_t)kStreamStages * sh.stage_vals * sizeof(TB) +
            2 * ((xbytes + 15) / 16 * 16);
  return sh;
}

template <typename TB, typename TX, int CB>
int launch_stream(const void* blocks, const void* x, void* y,
                  long long nblocks, int bs, int b, int c0, int nc,
                  const StreamShape& sh, cudaStream_t stream) {
  using TO = typename Promote<TB, TX>::type;
  auto kern = block_diag_stream<TB, TX, CB>;
  int full = 0;
  const cudaError_t e =
      persistent_grid((const void*)kern, kStreamThreads, sh.smem, &full);
  if (e != cudaSuccess) return (int)e;
  const long long grid = nblocks < full ? nblocks : full;
  const int whole =
      (long long)bs * sizeof(TB) % 16 == 0 &&
      (reinterpret_cast<uintptr_t>(blocks) & 15) == 0;
  kern<<<(unsigned)grid, kStreamThreads, sh.smem, stream>>>(
      static_cast<const TB*>(blocks), static_cast<const TX*>(x),
      static_cast<TO*>(y), nblocks, bs, b, c0, nc, sh.tr, sh.rs,
      sh.stage_vals, whole);
  return (int)cudaGetLastError();
}

// Columns of a pass (1, 4 or 16, at most b): the instance whose registers
// hold them, smaller while x's buffers do not fit beside the stages.
template <typename TB, typename TX>
int launch_wide(const void* blocks, const void* x, void* y,
                long long nblocks, int bs, int b, cudaStream_t stream) {
  int cb = b <= 1 ? 1 : b <= 4 ? 4 : kStreamMaxCols;
  while (cb > 1 && stream_shape<TB, TX>(bs, cb).smem > kMaxSmem)
    cb = cb == kStreamMaxCols ? 4 : 1;
  const StreamShape sh = stream_shape<TB, TX>(bs, cb);
  if (sh.smem > kMaxSmem || (bs + sh.tr - 1) / sh.tr < kStreamStages - 1)
    return -1;  // block_diag_tiled takes it
  for (int c0 = 0; c0 < b; c0 += cb) {
    const int nc = b - c0 < cb ? b - c0 : cb;
    int rc;
    if (cb == 1)
      rc = launch_stream<TB, TX, 1>(blocks, x, y, nblocks, bs, b, c0, nc, sh,
                                    stream);
    else if (cb == 4)
      rc = launch_stream<TB, TX, 4>(blocks, x, y, nblocks, bs, b, c0, nc, sh,
                                    stream);
    else
      rc = launch_stream<TB, TX, kStreamMaxCols>(blocks, x, y, nblocks, bs, b,
                                                 c0, nc, sh, stream);
    if (rc != 0) return rc;
  }
  return 0;
}

template <typename TB, typename TX>
int launch(const void* blocks, const void* x, void* y, long long nblocks,
           int bs, int b, cudaStream_t stream) {
  using TO = typename Promote<TB, TX>::type;
  using A = typename Acc<TO>::type;
  if (bs > kMaxBs ||
      ((long long)bs * (bs + 1) + (long long)bs * b) * (long long)sizeof(A) >
          kMaxSmem) {
    const int rc = launch_wide<TB, TX>(blocks, x, y, nblocks, bs, b, stream);
    if (rc >= 0) return rc;
    const int rtiles = (bs + kTileRows - 1) / kTileRows;
    if (nblocks * rtiles > 0x7fffffffLL)
      return (int)cudaErrorInvalidConfiguration;
    block_diag_tiled<TB, TX>
        <<<(unsigned)(nblocks * rtiles), kTileRows * kRowThreads, 0,
           stream>>>(static_cast<const TB*>(blocks),
                     static_cast<const TX*>(x), static_cast<TO*>(y), bs, b,
                     rtiles);
    return (int)cudaGetLastError();
  }
  const int group = group_size(bs, b, (int)sizeof(A));
  const long long grid = (nblocks + group - 1) / group;
  const size_t smem =
      ((size_t)group * bs * (bs + 1) + (size_t)group * bs * b) * sizeof(A);
  int threads = ((group * bs + 31) / 32) * 32;
  cudaError_t e = cudaFuncSetAttribute(
      block_diag_rows<TB, TX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  block_diag_rows<TB, TX><<<(unsigned)grid, threads, smem, stream>>>(
      static_cast<const TB*>(blocks), static_cast<const TX*>(x),
      static_cast<TO*>(y), nblocks, bs, b, group);
  return (int)cudaGetLastError();
}

template <typename TB>
int launch_x(int x_dtype, const void* blocks, const void* x, void* y,
             long long nblocks, int bs, int b, cudaStream_t s) {
  switch (x_dtype) {
    case 0: return launch<TB, double>(blocks, x, y, nblocks, bs, b, s);
    case 1: return launch<TB, float>(blocks, x, y, nblocks, bs, b, s);
    case 2: return launch<TB, __nv_bfloat16>(blocks, x, y, nblocks, bs, b, s);
    case 3: return launch<TB, __half>(blocks, x, y, nblocks, bs, b, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes: 0 float64, 1 float32, 2 bfloat16, 3 float16, 4 complex128,
// 5 complex64; complex blocks take x of their code or of their precision's
// real code (0 with 4, 1 with 5), complex64 blocks complex128 x too.  y has the promoted type of the two (the
// wrapper allocates it).  Returns the first
// CUDA error of the launch (0 on success).
extern "C" int block_diag_launch(int blocks_dtype, int x_dtype,
                                 const void* blocks, const void* x, void* y,
                                 long long nblocks, int bs, int b,
                                 void* stream) {
  if (nblocks < 1 || bs < 1 || b < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (blocks_dtype) {
    case 0: return launch_x<double>(x_dtype, blocks, x, y, nblocks, bs, b, s);
    case 1: return launch_x<float>(x_dtype, blocks, x, y, nblocks, bs, b, s);
    case 2: return launch_x<__nv_bfloat16>(x_dtype, blocks, x, y, nblocks, bs,
                                           b, s);
    case 3: return launch_x<__half>(x_dtype, blocks, x, y, nblocks, bs, b, s);
    case 4:
      if (x_dtype == 4)
        return launch<Complex<double>, Complex<double>>(blocks, x, y, nblocks,
                                                        bs, b, s);
      if (x_dtype == 0)
        return launch<Complex<double>, double>(blocks, x, y, nblocks, bs, b, s);
      return (int)cudaErrorInvalidValue;
    case 5:
      if (x_dtype == 5)
        return launch<Complex<float>, Complex<float>>(blocks, x, y, nblocks,
                                                      bs, b, s);
      if (x_dtype == 1)
        return launch<Complex<float>, float>(blocks, x, y, nblocks, bs, b, s);
      if (x_dtype == 4)
        return launch<Complex<float>, Complex<double>>(blocks, x, y, nblocks,
                                                       bs, b, s);
      return (int)cudaErrorInvalidValue;
    default: return (int)cudaErrorInvalidValue;
  }
}

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
// of their type or real x of their precision (staged as complex), and y
// is complex; each product is then four fused multiply-adds.
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
// * Past bs = 64, or where one block and its x rows do not fit in shared
//   memory (block_diag_tiled below): a thread block owns a tile of 64
//   rows of one diagonal block and walks its columns j in slabs of 32:
//   the tile's 64 x 32 entries of the slab (64 runs of 32 neighbouring
//   values, padded to 33 in shared memory) and the slab's 32 rows of x
//   are staged, the next slab's loaded into registers meanwhile.  Four
//   threads share a row, each with the columns sub, sub + 4, ... of a
//   16-column block of x (an outer loop past 16 columns).  Each output
//   still sums its bs products in order of j, so the result is the same
//   to the bit as the staged groups' arithmetic.  Any bs: at bs = 128,
//   b = 4 in float64 the blocks are 4.29 GB of a 4,194,304-row call.
//   Three blocks an SM (at most 85 registers a thread): at the 128 the
//   compiler took without the bound, two blocks an SM took 3.18 ms there
//   against 2.93 (PERF.md, PR 29).

#include <cuda_runtime.h>

#include "dtypes.cuh"

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

// y = B x for bs past 64 (see the note at the top): block blockIdx.x owns
// row tile blockIdx.x % rtiles of diagonal block blockIdx.x / rtiles.
template <typename TB, typename TX>
__global__ void __launch_bounds__(kTileRows * kRowThreads, 3)
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

template <typename TB, typename TX>
int launch(const void* blocks, const void* x, void* y, long long nblocks,
           int bs, int b, cudaStream_t stream) {
  using TO = typename Promote<TB, TX>::type;
  using A = typename Acc<TO>::type;
  if (bs > kMaxBs ||
      ((long long)bs * (bs + 1) + (long long)bs * b) * (long long)sizeof(A) >
          kMaxSmem) {
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
// real code (0 with 4, 1 with 5).  y has the promoted type of the two (the
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
      return (int)cudaErrorInvalidValue;
    default: return (int)cudaErrorInvalidValue;
  }
}

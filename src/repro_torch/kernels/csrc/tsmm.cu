// Tall-skinny x small GEMM for Hopper (sm_90a), paper C2 (Fig. 7).
//
// Replaces: repro/kernels/tsmm.py:tsmm_pallas (the Pallas TPU kernel, body
// `_kernel`).  Computes
//
//   W_out = alpha * V X + beta * W_in        V (n, m) row-major, X (m, k), W (n, k)
//
// for real float64, float32, bfloat16 and float16 V, W and W_out, and for
// complex128 and complex64 ones (with complex alpha and beta), with the
// products summed in the accumulation type (float32 for the half types,
// else the input type).  The wrapper hands X over in the accumulation
// type (a real X of a complex V's precision converted exactly).
//
// Bound: memory bandwidth.  Each row of V is read once, each row of W_in
// (when given) read once and each row of W_out written once:
// n * (m + k [+ k]) * sizeof(T) bytes for 2 n m k flops, about one flop per
// byte in float64 at m = k = 16 (0.062 ms of float64 operations against
// 0.31 ms of bytes at n = 4,096,000).  So the CUDA cores suffice: wgmma
// and DMMA would speed up the part that is not the limit, and their
// fragment layouts would cost shared-memory shuffles on the part that is.
//
// Design (what keeps 3.35 TB/s in flight):
// * m and k are template parameters for the widths the repo runs: the
//   square widths 1, 2, 4, 8, 16, 32 and 64 (every call in the repo is
//   b x b).  Other (m, k) up to 64 take the same kernel instantiated with
//   M = K = 0, which reads m and k at run time and loads value by value;
//   wider ones take tsmm_dmma or tsmm_tiled (the last point below).
// * A persistent grid: as many blocks as the card holds at once (the
//   occupancy API's count times the SMs, at most one a tile).  Each block
//   loads X into shared memory once, and walks the row tiles blockIdx.x,
//   blockIdx.x + gridDim.x, ...: at any moment the blocks stream
//   neighbouring addresses.
// * A row tile of R rows of V is one contiguous run of R * m values, and of
//   W_in R * k.  The block streams both into a ring of kStages shared-memory
//   stages with 16-byte cp.async copies (every thread copies a share), kept
//   kStages - 1 tiles ahead of the compute: with R chosen so that a stage
//   holds about 16 KB of V and W, two or three blocks an SM keep some
//   48-96 KB in flight an SM, where Little's law asks for about 24 KB.
//   R is a multiple of 16, so every tile starts on 16 bytes where its
//   operand does; where an operand's base is not 16-byte aligned, and for
//   a tile's last partial 16 bytes, the threads load value by value
//   instead.
// * The stages are swizzled: the 16-byte chunk q of a tile is stored at
//   chunk q ^ ((q >> 3) & 7), so the 128-byte lines' chunks rotate with the
//   line.  The threads of a warp that read the same column of several rows
//   then meet distinct banks, where a plain layout (rows 128 bytes apart at
//   m = 16 in float64) puts them all on one bank.
// * A thread owns G neighbouring outputs of a row (16 bytes of the
//   accumulation type; fewer where k is narrower), so a warp's stores of
//   W_out are 16-byte stores to one contiguous run.  The k / G threads of a
//   row read the same V values (a broadcast), 16 bytes at a time where a
//   row allows it.  X's m x G values a thread needs stay in registers where
//   they fit in 64 of them (m <= 16), else it reads them from shared memory.
// * Each output sums its m products in order of i and is then scaled, as
//   before: alpha * acc + beta * W_in.  The result does not depend on the
//   grid or on R.
// * W_out is a new buffer, so W_in may alias V (tsmm_inplace).
// * m or k above 64 (tsmm_dmma and tsmm_tiled below): X no longer fits in
//   one block's shared memory beside a ring (128 KB at m = k = 128 in
//   float64), and the row-per-threads layout above runs out of threads
//   past k = 256.  At m = k = 128 in float64 the call does 2 m k = 32,768
//   flops a row against 3 x 128 x 8 bytes, 10.7 flops a byte: past the
//   CUDA cores' ridge (34 TFLOP/s over 3.35 TB/s, 10), below DMMA's (67
//   TFLOP/s, 20).  So float64 takes the FP64 tensor cores (tsmm_dmma,
//   mma.sync m8n8k4): a block owns a 128 x 128 tile of W_out (at k <= 128
//   V's rows are read once), its sixteen warps 32 x 32 each, and walks m in
//   steps of 16: V's 128 x 16 and X's 16 x 128 values of the step go into
//   shared memory (rows padded so that a fragment's 32 values take two
//   wavefronts, the least for 256 bytes), the next step's are loaded into
//   registers meanwhile, and a warp's step is 8 fragment loads for 16
//   products of 8 x 8 x 4.  The other types take tsmm_tiled, a
//   register-blocked product on the CUDA cores: a block owns 128 x 128
//   (real values) or 64 x 64 (complex ones, whose 64 accumulators a thread
//   would not fit in registers), thread (tx, ty) its rows ty + 16a and
//   columns tx + 16c (a, c < 8, or 4), so a warp's reads of a step are one
//   broadcast run of V and one contiguous run of 16 values of X (16 loads
//   for 64 fused multiply-adds), and its stores of W_out contiguous runs.
//   tsmm_tiled sums each output's m products in order of i from 0, as the
//   instances above do; the tensor cores sum each group of four in their
//   own order.  With W at 4,096,000 x 128 x 128 in float64 (PERF.md, PR
//   29) earlier versions took 14.46 ms (CUDA cores, 4 x 4 thread tiles,
//   64 x 64 blocks), 11.50 ms (CUDA cores, 8 x 8, 128 x 128) and 9.53 ms
//   (DMMA, eight warps of 64 x 32, 255 registers and spills), this one
//   7.66 (sixteen warps, 128 registers, 36 bytes of spills).

#include <cuda_runtime.h>
#include <type_traits>
#include <stdint.h>

#include "dtypes.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kStages = 4;
constexpr int kMaxDim = 64;       // widths of the streaming instances
constexpr int kTileDepth = 16;    // tsmm_tiled: values of i a step
constexpr int kStageTarget = 16384;  // bytes of V and W in one stage
constexpr int kRegXBytes = 256;      // X's share in registers at most

// G: the outputs of a row one thread owns (16 bytes of the accumulation
// type, at most k); k = 0 means run-time k, one output a thread.
template <typename A> __host__ __device__ constexpr int group_of(int k) {
  return k == 0 ? 1 : (k < (int)(16 / sizeof(A)) ? k : (int)(16 / sizeof(A)));
}

__host__ __device__ constexpr int round_up(int v, int to) {
  return (v + to - 1) / to * to;
}

// Rows of a tile: about kStageTarget bytes of V and W (half of it without
// W: larger stages measured slower there on the H100 in bfloat16 and
// complex64), a multiple of 16.  Where a tile has fewer rows than a pass
// of the block's threads covers (narrow k, wide m), the threads past its
// rows wait: a tile of one pass would not fit shared memory at m = 64,
// k = 1.
inline int tile_rows(int m, int k, int tsize) {
  const int r = kStageTarget / ((m + k) * tsize);
  return round_up(r < 1 ? 1 : r, 16);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The byte in a swizzled stage where logical byte b lives.
__device__ __forceinline__ int swz(int b) {
  const int q = b >> 4;
  return ((q ^ ((q >> 3) & 7)) << 4) | (b & 15);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <typename T, int N> struct alignas(N * sizeof(T)) Vec {
  T v[N];
};

// Copy `bytes` (a whole number of T) from global `src` into the swizzled
// stage `dst`: 16-byte cp.async copies where `aligned`, else value by
// value; the last partial 16 bytes value by value.
template <typename T>
__device__ __forceinline__ void fetch(unsigned char* dst, const T* src,
                                      int bytes, bool aligned) {
  const int t = threadIdx.x;
  const unsigned char* s = reinterpret_cast<const unsigned char*>(src);
  int done = 0;
  if (aligned) {
    const int nq = bytes >> 4;
    for (int q = t; q < nq; q += kThreads)
      cp_async16(dst + swz(q << 4), s + (q << 4));
    done = nq << 4;
  }
  for (int b = done + t * (int)sizeof(T); b < bytes;
       b += kThreads * (int)sizeof(T))
    *reinterpret_cast<T*>(dst + swz(b)) = *reinterpret_cast<const T*>(s + b);
}

template <typename T, int M, int K>
__global__ void __launch_bounds__(kThreads, 2)
tsmm_stream(const T* __restrict__ V, const typename Acc<T>::type* __restrict__ X,
            const T* __restrict__ W_in, T* __restrict__ W_out, long long n,
            int m_rt, int k_rt, int R, long long ntiles,
            typename Acc<T>::type alpha, typename Acc<T>::type beta,
            const typename Acc<T>::type* __restrict__ alpha_p,
            const typename Acc<T>::type* __restrict__ beta_p,
            int has_w, int v_al, int w_al) {
  using A = typename Acc<T>::type;
  if (alpha_p) alpha = *alpha_p;  // a coefficient on the card
  if (beta_p) beta = *beta_p;
  constexpr int G = group_of<A>(K);
  constexpr bool kRegX = M > 0 && M * G * (int)sizeof(A) <= kRegXBytes;
  // V is read PW values at a time (a whole row's bytes where under 16)
  constexpr int PW = M == 0 ? 1 : (M * (int)sizeof(T) < 16
                                       ? M : 16 / (int)sizeof(T));
  // the loop over V's values unrolls fully only where X is in registers:
  // with X in shared memory (m >= 32) a full unroll hoists every load of
  // the row and spills
  constexpr int kUnrollI = kRegX ? (M > 0 ? M / PW : 1) : 2;
  const int m = M > 0 ? M : m_rt;
  const int k = K > 0 ? K : k_rt;
  const int tpr = k / G;              // threads of a row
  const int rpp = kThreads / tpr;     // rows a pass of the block covers

  extern __shared__ __align__(128) unsigned char smem[];
  A* sX = reinterpret_cast<A*>(smem);
  unsigned char* ring = smem + round_up(m * k * (int)sizeof(A), 128);
  const int v_bytes = round_up(R * m * (int)sizeof(T), 128);
  const int stride = v_bytes + (has_w ? round_up(R * k * (int)sizeof(T), 128)
                                      : 0);

  const int t = threadIdx.x;
  for (int o = t; o < m * k; o += kThreads) sX[o] = X[o];

  auto rows_of = [&](long long tile) -> int {
    const long long left = n - tile * R;
    return left < R ? (int)left : R;
  };
  auto issue = [&](long long tile, int stage) {
    if (tile < ntiles) {
      const long long r0 = tile * R;
      const int rows = rows_of(tile);
      unsigned char* st = ring + stage * stride;
      fetch<T>(st, V + r0 * m, rows * m * (int)sizeof(T), v_al);
      if (has_w)
        fetch<T>(st + v_bytes, W_in + r0 * k, rows * k * (int)sizeof(T),
                 w_al);
    }
    cp_commit();  // empty groups keep the count uniform
  };

  long long tile = blockIdx.x;
  const long long step = gridDim.x;
#pragma unroll 1
  for (int s = 0; s < kStages - 1; ++s) issue(tile + s * step, s);
  __syncthreads();  // sX

  constexpr int XM = kRegX ? M : 1, XG = kRegX ? G : 1;
  A xr[XM][XG];
  const int trow = t / tpr;
  const int j0 = (t % tpr) * G;
  const bool worker = trow < rpp;
  if constexpr (kRegX) {
    if (worker) {
#pragma unroll
      for (int i = 0; i < XM; ++i)
#pragma unroll
        for (int g = 0; g < XG; ++g) xr[i][g] = sX[i * k + j0 + g];
    }
  }

#pragma unroll 1
  for (int it = 0; tile < ntiles; ++it, tile += step) {
    cp_wait<kStages - 2>();
    __syncthreads();  // tile `it` is in; stage (it - 1) % kStages is free
    issue(tile + (long long)(kStages - 1) * step, (it + kStages - 1) % kStages);
    const unsigned char* sv = ring + (it % kStages) * stride;
    const unsigned char* sw = sv + v_bytes;
    const int rows = rows_of(tile);
    if (!worker) continue;
#pragma unroll 2
    for (int r = trow; r < rows; r += rpp) {
      A acc[G];
#pragma unroll
      for (int g = 0; g < G; ++g) acc[g] = A(0);
      const int rb = r * m * (int)sizeof(T);
      if constexpr (M > 0) {
#pragma unroll kUnrollI
        for (int i0 = 0; i0 < M; i0 += PW) {
          const Vec<T, PW> pv = *reinterpret_cast<const Vec<T, PW>*>(
              sv + swz(rb + i0 * (int)sizeof(T)));
#pragma unroll
          for (int u = 0; u < PW; ++u) {
            const A v = load_as<A>(pv.v[u]);
#pragma unroll
            for (int g = 0; g < G; ++g) {
              if constexpr (kRegX)
                acc[g] = mul_add(v, xr[i0 + u][g], acc[g]);
              else
                acc[g] = mul_add(v, sX[(i0 + u) * k + j0 + g], acc[g]);
            }
          }
        }
      } else {
        for (int i = 0; i < m; ++i) {
          const A v = load_as<A>(*reinterpret_cast<const T*>(
              sv + swz(rb + i * (int)sizeof(T))));
#pragma unroll
          for (int g = 0; g < G; ++g)
            acc[g] = mul_add(v, sX[i * k + j0 + g], acc[g]);
        }
      }
      const int ob = (r * k + j0) * (int)sizeof(T);
      Vec<T, G> wv;
      if (has_w) wv = *reinterpret_cast<const Vec<T, G>*>(sw + swz(ob));
      Vec<T, G> res;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        A y = alpha * acc[g];
        if (has_w) y += beta * load_as<A>(wv.v[g]);
        res.v[g] = store_as<T>(y);
      }
      *reinterpret_cast<Vec<T, G>*>(W_out + (tile * R + r) * k + j0) = res;
    }
  }
  cp_wait<0>();  // no copy outlives the block
}

// The tiled instance's thread tile (rows x columns of W_out a thread):
// 8 x 8 for real values (a block 128 x 128), 4 x 4 for complex ones,
// whose 64 accumulators would not fit in registers (a block 64 x 64).
template <typename T> struct TiledTile { static constexpr int M = 8; };
template <typename R> struct TiledTile<Complex<R>> {
  static constexpr int M = 4;
};

// W_out = alpha V X + beta W_in for m or k above 64 (see the note at the
// top): block blockIdx.x owns row tile blockIdx.x / kslabs and column
// slab blockIdx.x % kslabs of W_out; thread (tx, ty) owns its rows ty +
// 16 a and columns tx + 16 c (a, c < TM).
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
tsmm_tiled(const T* __restrict__ V, const typename Acc<T>::type* __restrict__ X,
           const T* __restrict__ W_in, T* __restrict__ W_out, long long n,
           int m, int k, int kslabs, typename Acc<T>::type alpha,
           typename Acc<T>::type beta,
           const typename Acc<T>::type* __restrict__ alpha_p,
           const typename Acc<T>::type* __restrict__ beta_p, int has_w) {
  using A = typename Acc<T>::type;
  constexpr int TM = TiledTile<T>::M;
  constexpr int kRows = 16 * TM, kCols = 16 * TM;  // the block's tile
  constexpr int kD = kTileDepth;
  constexpr int kEach = kRows * kD / kThreads;  // loads a thread a step
  static_assert(kRows * kD == kThreads * kEach &&
                    kD * kCols == kThreads * kEach,
                "each thread loads kEach values of V and of X a step");
  __shared__ A sV[kD][kRows + 1];  // V's step, transposed
  __shared__ A sX[kD][kCols];
  if (alpha_p) alpha = *alpha_p;  // a coefficient on the card
  if (beta_p) beta = *beta_p;
  const long long r0 = (long long)(blockIdx.x / kslabs) * kRows;
  const int c0 = (blockIdx.x % kslabs) * kCols;
  const int t = threadIdx.x;
  const int tx = t % 16, ty = t / 16;

  A vr[kEach], xr[kEach];
  auto load = [&](int i0) {
#pragma unroll
    for (int u = 0; u < kEach; ++u) {
      const int e = u * kThreads + t;
      const int r = e / kD, i = e % kD;
      vr[u] = (r0 + r < n && i0 + i < m)
                  ? load_as<A>(V[(r0 + r) * m + i0 + i])
                  : A(0);
      const int xi = e / kCols, c = e % kCols;
      xr[u] = (i0 + xi < m && c0 + c < k) ? X[(long long)(i0 + xi) * k + c0 + c]
                                          : A(0);
    }
  };
  A acc[TM][TM];
#pragma unroll
  for (int a = 0; a < TM; ++a)
#pragma unroll
    for (int c = 0; c < TM; ++c) acc[a][c] = A(0);

  load(0);
#pragma unroll 1
  for (int i0 = 0; i0 < m; i0 += kD) {
    __syncthreads();  // every thread is done with the step before
#pragma unroll
    for (int u = 0; u < kEach; ++u) {
      const int e = u * kThreads + t;
      sV[e % kD][e / kD] = vr[u];
      sX[e / kCols][e % kCols] = xr[u];
    }
    __syncthreads();
    if (i0 + kD < m) load(i0 + kD);
    const int steps = min(kD, m - i0);
#pragma unroll 2
    for (int i = 0; i < steps; ++i) {
      A v[TM], x[TM];
#pragma unroll
      for (int a = 0; a < TM; ++a) v[a] = sV[i][ty + 16 * a];
#pragma unroll
      for (int c = 0; c < TM; ++c) x[c] = sX[i][tx + 16 * c];
#pragma unroll
      for (int a = 0; a < TM; ++a)
#pragma unroll
        for (int c = 0; c < TM; ++c) acc[a][c] = mul_add(v[a], x[c], acc[a][c]);
    }
  }
#pragma unroll
  for (int a = 0; a < TM; ++a) {
    const long long row = r0 + ty + 16 * a;
    if (row >= n) continue;
#pragma unroll
    for (int c = 0; c < TM; ++c) {
      const int col = c0 + tx + 16 * c;
      if (col >= k) continue;
      A y = alpha * acc[a][c];
      if (has_w) y += beta * load_as<A>(W_in[row * k + col]);
      W_out[row * k + col] = store_as<T>(y);
    }
  }
}

// The float64 wide instance on the FP64 tensor cores (see the note at the
// top): mma.sync m8n8k4, a block a 128 x 128 tile of W_out, its sixteen
// warps 4 x 4 of 32 x 32, each of 4 x 4 products of 8 x 8; m in steps of
// kDmmaDepth through shared memory, the next step's values loaded into
// registers meanwhile.
constexpr int kDmmaThreads = 512;
constexpr int kDmmaTile = 128;   // rows and columns of W_out a block
constexpr int kDmmaDepth = 16;   // values of i a step
constexpr int kDmmaPadV = 4;     // sV's rows: kDmmaDepth + 4 values
constexpr int kDmmaPadX = 8;     // sX's rows: kDmmaTile + 8 values

__device__ __forceinline__ void dmma(double& d0, double& d1, double a,
                                     double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, "
      "{%3}, {%0, %1};\n"
      : "+d"(d0), "+d"(d1)
      : "d"(a), "d"(b));
}

__global__ void __launch_bounds__(kDmmaThreads, 1)
tsmm_dmma(const double* __restrict__ V, const double* __restrict__ X,
          const double* __restrict__ W_in, double* __restrict__ W_out,
          long long n, int m, int k, int kslabs, double alpha, double beta,
          const double* __restrict__ alpha_p, const double* __restrict__ beta_p,
          int has_w) {
  constexpr int kT = kDmmaTile, kD = kDmmaDepth, kN = kDmmaThreads;
  constexpr int kEach = kT * kD / kN;        // loads a thread a step
  constexpr int kMT = 4, kNT = 4;            // a warp's 8 x 8 products
  __shared__ double sV[kT][kD + kDmmaPadV];
  __shared__ double sX[kD][kT + kDmmaPadX];
  if (alpha_p) alpha = *alpha_p;  // a coefficient on the card
  if (beta_p) beta = *beta_p;
  const long long r0 = (long long)(blockIdx.x / kslabs) * kT;
  const int c0 = (blockIdx.x % kslabs) * kT;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int wr = (warp >> 2) * 32, wc = (warp & 3) * 32;  // the warp's tile
  const int lr = lane >> 2, lk = lane & 3;                // fragment place

  double vr[kEach], xr[kEach];
  auto load = [&](int i0) {
#pragma unroll
    for (int u = 0; u < kEach; ++u) {
      const int e = u * kN + t;
      const int r = e / kD, i = e % kD;
      vr[u] = (r0 + r < n && i0 + i < m) ? V[(r0 + r) * m + i0 + i] : 0.0;
      const int xi = e / kT, c = e % kT;
      xr[u] = (i0 + xi < m && c0 + c < k) ? X[(long long)(i0 + xi) * k + c0 + c]
                                          : 0.0;
    }
  };
  double acc[kMT][kNT][2];
#pragma unroll
  for (int a = 0; a < kMT; ++a)
#pragma unroll
    for (int b = 0; b < kNT; ++b) acc[a][b][0] = acc[a][b][1] = 0.0;

  load(0);
#pragma unroll 1
  for (int i0 = 0; i0 < m; i0 += kD) {
    __syncthreads();  // every warp is done with the step before
#pragma unroll
    for (int u = 0; u < kEach; ++u) {
      const int e = u * kN + t;
      sV[e / kD][e % kD] = vr[u];
      sX[e / kT][e % kT] = xr[u];
    }
    __syncthreads();
    if (i0 + kD < m) load(i0 + kD);
#pragma unroll
    for (int kk = 0; kk < kD; kk += 4) {
      double fa[kMT], fb[kNT];
#pragma unroll
      for (int a = 0; a < kMT; ++a) fa[a] = sV[wr + 8 * a + lr][kk + lk];
#pragma unroll
      for (int b = 0; b < kNT; ++b) fb[b] = sX[kk + lk][wc + 8 * b + lr];
#pragma unroll
      for (int a = 0; a < kMT; ++a)
#pragma unroll
        for (int b = 0; b < kNT; ++b)
          dmma(acc[a][b][0], acc[a][b][1], fa[a], fb[b]);
    }
  }
#pragma unroll
  for (int a = 0; a < kMT; ++a) {
    const long long row = r0 + wr + 8 * a + lr;
    if (row >= n) continue;
#pragma unroll
    for (int b = 0; b < kNT; ++b)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = c0 + wc + 8 * b + 2 * lk + h;
        if (col >= k) continue;
        double y = alpha * acc[a][b][h];
        if (has_w) y += beta * W_in[row * k + col];
        W_out[row * k + col] = y;
      }
  }
}

template <typename T>
int launch_tiled(const void* V, const void* X, const void* W_in, void* W_out,
                 long long n, int m, int k, typename Acc<T>::type alpha,
                 typename Acc<T>::type beta, const void* alpha_p,
                 const void* beta_p, int has_w, cudaStream_t stream) {
  using A = typename Acc<T>::type;
  constexpr bool dmma = std::is_same<T, double>::value;
  constexpr int tile = dmma ? kDmmaTile : 16 * TiledTile<T>::M;
  const int kslabs = (k + tile - 1) / tile;
  const long long grid = (n + tile - 1) / tile * kslabs;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  if constexpr (dmma) {
    tsmm_dmma<<<(unsigned)grid, kDmmaThreads, 0, stream>>>(
        static_cast<const double*>(V), static_cast<const double*>(X),
        static_cast<const double*>(W_in), static_cast<double*>(W_out), n, m,
        k, kslabs, alpha, beta, static_cast<const double*>(alpha_p),
        static_cast<const double*>(beta_p), has_w);
    return (int)cudaGetLastError();
  }
  tsmm_tiled<T><<<(unsigned)grid, kThreads, 0, stream>>>(
      static_cast<const T*>(V), static_cast<const A*>(X),
      static_cast<const T*>(W_in), static_cast<T*>(W_out), n, m, k, kslabs,
      alpha, beta, static_cast<const A*>(alpha_p),
      static_cast<const A*>(beta_p), has_w);
  return (int)cudaGetLastError();
}

template <typename T, int M, int K>
int launch_mk(const void* V, const void* X, const void* W_in, void* W_out,
              long long n, int m, int k, typename Acc<T>::type alpha,
              typename Acc<T>::type beta, const void* alpha_p,
              const void* beta_p, int has_w, cudaStream_t stream) {
  using A = typename Acc<T>::type;
  const int R = tile_rows(m, k, (int)sizeof(T));
  const long long ntiles = (n + R - 1) / R;
  const int smem = round_up(m * k * (int)sizeof(A), 128) +
                   kStages * (round_up(R * m * (int)sizeof(T), 128) +
                              (has_w ? round_up(R * k * (int)sizeof(T), 128)
                                     : 0));
  auto kern = tsmm_stream<T, M, K>;
  // The grid (blocks an SM times SMs) of the last (device, smem) of each
  // has_w, kept so that a call of the same shape asks the runtime nothing,
  // and the shared memory the instantiation may take on each device (the
  // attribute only grows, since the generic instantiation serves many
  // shapes).
  constexpr int kDevs = 16;
  static int last_dev[2] = {-1, -1}, last_smem[2] = {-1, -1};
  static int last_grid[2] = {0, 0};
  static int smem_attr[kDevs] = {0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= kDevs) return (int)cudaErrorInvalidDevice;
  if (smem > smem_attr[dev]) {
    if ((e = cudaFuncSetAttribute(
             kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) !=
        cudaSuccess)
      return (int)e;
    smem_attr[dev] = smem;
  }
  if (last_dev[has_w] != dev || last_smem[has_w] != smem) {
    int sms = 0, per_sm = 0;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
      return (int)e;
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kern, kThreads, smem)) != cudaSuccess)
      return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    last_dev[has_w] = dev;
    last_smem[has_w] = smem;
    last_grid[has_w] = per_sm * sms;
  }
  long long grid = last_grid[has_w];
  if (grid > ntiles) grid = ntiles;
  const int v_al = (reinterpret_cast<uintptr_t>(V) & 15) == 0;
  const int w_al = has_w && (reinterpret_cast<uintptr_t>(W_in) & 15) == 0;
  kern<<<(unsigned)grid, kThreads, smem, stream>>>(
      static_cast<const T*>(V), static_cast<const A*>(X),
      static_cast<const T*>(W_in), static_cast<T*>(W_out), n, m, k, R, ntiles,
      alpha, beta, static_cast<const A*>(alpha_p),
      static_cast<const A*>(beta_p), has_w, v_al, w_al);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* V, const void* X, const void* W_in, void* W_out,
           long long n, int m, int k, double alpha, double beta,
           double alpha_im, double beta_im, const void* alpha_p,
           const void* beta_p, int has_w, cudaStream_t stream) {
  using A = typename Acc<T>::type;
  const A a = make_scalar<A>(alpha, alpha_im);
  const A b = make_scalar<A>(beta, beta_im);
#define TSMM_SQUARE(W)                                                      \
  if (m == W && k == W)                                                     \
    return launch_mk<T, W, W>(V, X, W_in, W_out, n, m, k, a, b, alpha_p,    \
                              beta_p, has_w, stream);
  TSMM_SQUARE(1)
  TSMM_SQUARE(2)
  TSMM_SQUARE(4)
  TSMM_SQUARE(8)
  TSMM_SQUARE(16)
  TSMM_SQUARE(32)
  TSMM_SQUARE(64)
#undef TSMM_SQUARE
  if (m > kMaxDim || k > kMaxDim)
    return launch_tiled<T>(V, X, W_in, W_out, n, m, k, a, b, alpha_p, beta_p,
                           has_w, stream);
  return launch_mk<T, 0, 0>(V, X, W_in, W_out, n, m, k, a, b, alpha_p,
                            beta_p, has_w, stream);
}

}  // namespace

// dtype: 0 float64, 1 float32, 2 bfloat16, 3 float16, 4 complex128,
// 5 complex64 (of V, W_in, W_out); X holds m * k values of the
// accumulation type.  alpha and beta come as real and imaginary parts (the
// imaginary parts are ignored for a real dtype), or, where alpha_p /
// beta_p is not null, as one value of the accumulation type on the card.
// Requires n >= 1, m, k >= 1 and W_out 16-byte aligned; m or k above 64
// take tsmm_dmma (float64) or tsmm_tiled.  Returns the first CUDA error of
// the launch (0 on success).
extern "C" int tsmm_launch(int dtype, const void* V, const void* X,
                           const void* W_in, void* W_out, long long n, int m,
                           int k, double alpha, double beta, double alpha_im,
                           double beta_im, const void* alpha_p,
                           const void* beta_p, int has_w, void* stream) {
  if (n < 1 || m < 1 || k < 1 ||
      (reinterpret_cast<uintptr_t>(W_out) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TSMM_ARGS \
  V, X, W_in, W_out, n, m, k, alpha, beta, alpha_im, beta_im, alpha_p, \
      beta_p, has_w, s
  switch (dtype) {
    case 0: return launch<double>(TSMM_ARGS);
    case 1: return launch<float>(TSMM_ARGS);
    case 2: return launch<__nv_bfloat16>(TSMM_ARGS);
    case 3: return launch<__half>(TSMM_ARGS);
    case 4: return launch<Complex<double>>(TSMM_ARGS);
    case 5: return launch<Complex<float>>(TSMM_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef TSMM_ARGS
}

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
//   TFLOP/s, 20), and DMMA's own time (2.0 ms at 4,096,000 rows) is close
//   to the bytes' (2.5 ms without W).  So float64 takes the FP64 tensor
//   cores (tsmm_dmma, mma.sync m16n8k8, as B2's DMMA instance), and the
//   products must overlap the stream.  tsmm_dmma is persistent: one
//   block an SM (the occupancy API's count), each owning a slab of 128
//   columns of W_out (columns past k masked) and walking row tiles of 32
//   rows.  X's m x 128 slab is loaded into shared memory
//   once a block and stays there, swizzled so that a B fragment meets 32
//   banks; V's tiles stream through a ring of stages (two at m = 128, up
//   to four for narrower m), each filled by one bulk copy a row
//   (cp.async.bulk, completion on the stage's mbarrier; cp.async value by
//   value where m or k is odd or V is off 16 bytes) into rows padded by
//   four values, so that an A fragment's loads meet distinct banks.  Eight
//   warps own 16 x 32 of a 32 x 128 tile: a step of 8 values of i is four
//   mma.sync for 12 fragment loads.  W_in's values of a warp's fragments
//   are loaded into registers before the tile's products, so they are in
//   flight meanwhile; the results go to an output stage and leave by one
//   bulk store a row (whole 128-byte lines) while the next tile's
//   products run.  Past 128 values of i the launch repeats over m in
//   steps of 128, each later one adding alpha V X to W_out (an output the
//   next launch reads as its W_in).  Each output is summed by one warp in
//   a fixed order (steps of 8 in order of i, each in the tensor core's
//   order), with no split of m over blocks and no atomics, so the result
//   does not depend on the grid.  Two alternatives ran slower on the H100
//   at 4,096,000 x 128 x 128, in turns with this design (tools/
//   b34_trials.py, variants b3_vstage and b3_w32; the times are in
//   PERF.md): the results written into V's stage, which frees room for a
//   third stage, and four warps of 32 x 32 (sixteen loads for eight mma,
//   one warp a scheduler).  So bytes in flight do not set the pace, and
//   more loads a product per warp beat fewer warps.
//   The other types take tsmm_tiled, a register-blocked product on the
//   CUDA cores: a block owns 128 x 128
//   (real values) or 64 x 64 (complex ones, whose 64 accumulators a thread
//   would not fit in registers), thread (tx, ty) its rows ty + 16a and
//   columns tx + 16c (a, c < 8, or 4), so a warp's reads of a step are one
//   broadcast run of V and one contiguous run of 16 values of X (16 loads
//   for 64 fused multiply-adds), and its stores of W_out contiguous runs.
//   tsmm_tiled sums each output's m products in order of i from 0, as the
//   instances above do.  With W at 4,096,000 x 128 x 128 in float64
//   (PERF.md) earlier versions took 14.46 ms (CUDA cores, 4 x 4
//   thread tiles, 64 x 64 blocks), 11.50 ms (CUDA cores, 8 x 8, 128 x
//   128), 9.53 ms (DMMA m8n8k4, eight warps of 64 x 32, 255 registers and
//   spills) and 7.56-7.66 ms (a block a 128 x 128 tile of W_out, X's and
//   V's values staged through registers a step of 16 at a time, sixteen
//   warps, 36 bytes of spills; 6.87 ms without W against mm's 3.32).

#include <cuda_runtime.h>
#include <type_traits>
#include <stdint.h>

#include "dtypes.cuh"
#include "launch.cuh"

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
// top).  A block owns a slab of kWideCols columns of W_out and walks its
// 32-row tiles; X's slab for up to kWideDepth values of i stays in shared
// memory, swizzled (value (i, j) at i * kWideCols + (j ^ 4 (i & 3)), so
// that a B fragment's 32 loads meet 32 distinct banks), V's tiles come
// through a ring of stages (rows padded by kWidePad values) and W_out's
// tiles leave through an output stage.  Eight warps, each 16 x 32 of
// W_out: four mma.sync m16n8k8 a step of 8 values of i.
constexpr int kWideCols = 128;    // columns of W_out a block owns
constexpr int kWideThreads = 2 * kWideCols;
constexpr int kWideRows = 32;     // rows of a tile
constexpr int kWideDepth = 128;   // values of i one launch sums
constexpr int kWidePad = 4;       // a V stage's rows: m + 4 values
constexpr int kWideMaxStages = 4;

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(1)
               : "memory");
}
// Arrive once and expect `bytes` of bulk copies to complete on `bar`.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}
// One 1-D bulk copy global -> shared of `bytes` (a multiple of 16, both
// addresses on 16 bytes), completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}
// One 1-D bulk copy shared -> global of `bytes` (a multiple of 16, both
// addresses on 16 bytes), in this thread's bulk group.
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          dst),
      "r"(smem_addr(src)), "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// this thread's bulk stores have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// ... and are done
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d (16 x 8) += a (16 x 8) b (8 x 8): a0..a3 at rows (g, g + 8, g, g + 8)
// and columns (q, q, q + 4, q + 4), b0, b1 at rows q, q + 4 and column g,
// d0, d1 at row g and d2, d3 at row g + 8, columns 2q and 2q + 1
__device__ __forceinline__ void dmma16(double* d, double a0, double a1,
                                       double a2, double a3, double b0,
                                       double b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a0), "d"(a1), "d"(a2), "d"(a3), "d"(b0), "d"(b1));
}

// W_out[:, slab] = alpha V X + beta W_in for m <= kWideDepth values of i
// (V with row stride ldv, X with row stride k).  vec: m and k even, V on 16
// bytes, ldv even: the stages fill by one bulk copy a row, the tiles leave
// by one bulk store a row; else value by value.  W_in may be W_out (the
// wrapper's later launches over i: each value is read, then written, by
// one thread) or V (tsmm_inplace).
__global__ void __launch_bounds__(kWideThreads, 1)
tsmm_dmma(const double* __restrict__ V, long long ldv,
          const double* __restrict__ X, const double* W_in, double* W_out,
          long long n, int m, int k, int kslabs, double alpha, double beta,
          const double* __restrict__ alpha_p,
          const double* __restrict__ beta_p, int has_w, int vec,
          int stages) {
  constexpr int R = kWideRows, N = kWideCols, NT = kWideThreads;
  extern __shared__ __align__(16) double wsm[];
  __shared__ __align__(8) uint64_t bars[kWideMaxStages];
  const int mp = (m + 7) / 8 * 8;
  const int SV = mp + kWidePad;  // a V stage's row stride
  double* sX = wsm;                       // mp x N, swizzled
  double* sO = sX + mp * N;               // R x N, the output stage
  double* ring = sO + R * N;              // stages x R x SV
  if (alpha_p) alpha = *alpha_p;  // a coefficient on the card
  if (beta_p) beta = *beta_p;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int g = lane >> 2, q = lane & 3;  // fragment place
  const int wr = (warp & 1) * 16, wc = (warp >> 1) * 32;  // the warp's tile
  const int j0 = (blockIdx.x % kslabs) * N;
  const int kc = min(N, k - j0);
  const long long ntiles = (n + R - 1) / R;
  const long long first = blockIdx.x / kslabs, step = gridDim.x / kslabs;
  const long long cnt = (ntiles - first + step - 1) / step;  // >= 1

  // X's slab (zeros past m and k), the ring's padding columns (zeros)
  for (int e = t; e < mp * N; e += NT) {
    const int i = e / N, j = e % N;
    sX[i * N + (j ^ ((i & 3) << 2))] =
        (i < m && j < kc) ? X[(long long)i * k + j0 + j] : 0.0;
  }
  for (int e = t; e < stages * R * SV; e += NT) ring[e] = 0.0;
  if (t == 0) {
    for (int st = 0; st < stages; ++st) mbar_init(&bars[st]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  fence_async_shared();
  __syncthreads();

  auto rows_of = [&](long long it) -> int {
    const long long left = n - (first + it * step) * R;
    return left < R ? (int)left : R;
  };
  auto fill = [&](long long it) {
    if (it < cnt) {
      const int st = (int)(it % stages);
      double* sv = ring + st * R * SV;
      const long long r0 = (first + it * step) * R;
      const int rows = rows_of(it);
      if (vec) {
        if (warp == 0) {
          if (lane == 0)
            mbar_expect(&bars[st], (uint32_t)(rows * m * (int)sizeof(double)));
          __syncwarp();
          fence_async_shared();
          for (int r = lane; r < rows; r += 32)
            bulk_load(sv + r * SV, V + (r0 + r) * ldv,
                      (uint32_t)(m * sizeof(double)), &bars[st]);
        }
      } else {
        for (int e = t; e < rows * m; e += NT) {
          const int r = e / m, c = e % m;
          cp_async8(sv + r * SV + c, V + (r0 + r) * ldv + c);
        }
      }
    }
    if (!vec) cp_commit();  // empty groups keep the count uniform
  };
  // the output stage of tile `it` to W_out: one bulk store a row (warp
  // 0's lanes) or value by value
  auto flush = [&](long long it) {
    const long long r0 = (first + it * step) * R;
    const int rows = rows_of(it);
    if (vec) {
      if (warp == 0) {
        for (int r = lane; r < rows; r += 32)
          bulk_store(W_out + (r0 + r) * k + j0, sO + r * N,
                     (uint32_t)(kc * sizeof(double)));
        bulk_commit();
      }
    } else {
      for (int e = t; e < rows * kc; e += NT) {
        const int r = e / kc, c = e % kc;
        W_out[(r0 + r) * k + j0 + c] = sO[r * N + c];
      }
    }
  };
  auto wait_stages = [&]() {  // all but the newest stages - 2 fills done
    if (stages == 2) cp_wait<0>();
    else if (stages == 3) cp_wait<1>();
    else cp_wait<2>();
  };

#pragma unroll 1
  for (int st = 0; st < stages - 1; ++st) fill(st);
  uint32_t phase = 0;  // bit st: parity of stage st's next bulk fill
#pragma unroll 1
  for (long long it = 0; it < cnt; ++it) {
    const int st = (int)(it % stages);
    if (!vec) wait_stages();
    __syncthreads();  // the stage of it - 1 is free, tile it - 1's output in
    if (it > 0) flush(it - 1);
    fill(it + stages - 1);
    const long long r0 = (first + it * step) * R;
    // W_in's values of the warp's fragments, in flight during the products
    double w[4][4];
    if (has_w) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long row = r0 + wr + g + 8 * h;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int col = j0 + wc + 8 * b + 2 * q;
          w[b][2 * h] = row < n && col < k ? W_in[row * k + col] : 0.0;
          w[b][2 * h + 1] =
              row < n && col + 1 < k ? W_in[row * k + col + 1] : 0.0;
        }
      }
    }
    if (vec) {
      mbar_wait(&bars[st], (phase >> st) & 1u);
      phase ^= 1u << st;
    }
    const double* sv = ring + st * R * SV;
    const double* va = sv + (wr + g) * SV + q;
    double acc[4][4];
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[b][e] = 0.0;
    const int sw = q << 2;  // the swizzle of rows q and q + 4
#pragma unroll 4
    for (int i0 = 0; i0 < mp; i0 += 8) {
      const double a0 = va[i0], a1 = va[8 * SV + i0];
      const double a2 = va[i0 + 4], a3 = va[8 * SV + i0 + 4];
      const double* x0 = sX + (i0 + q) * N;
      const double* x1 = x0 + 4 * N;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int j = (wc + 8 * b + g) ^ sw;
        dmma16(acc[b], a0, a1, a2, a3, x0[j], x1[j]);
      }
    }
    if (vec && warp == 0) bulk_wait_read();  // tile it - 1 left sO
    __syncthreads();
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        double2 y;
        y.x = alpha * acc[b][2 * h];
        y.y = alpha * acc[b][2 * h + 1];
        if (has_w) {
          y.x += beta * w[b][2 * h];
          y.y += beta * w[b][2 * h + 1];
        }
        *reinterpret_cast<double2*>(sO + (wr + g + 8 * h) * N + wc + 8 * b +
                                    2 * q) = y;
      }
    if (vec) fence_async_shared();  // sO is read by the bulk stores
  }
  __syncthreads();
  flush(cnt - 1);
  if (vec) {
    if (warp == 0) bulk_wait();
  } else {
    cp_wait<0>();  // no copy outlives the block
  }
}

// The wide float64 instance: X's columns in slabs of kWideCols, m in
// launches of kWideDepth values of i (the later ones add to W_out), a
// persistent grid of the occupancy API's blocks an SM times the SMs, a
// multiple of the slabs.
int launch_dmma(const double* V, const double* X, const double* W_in,
                double* W_out, long long n, int m, int k, double alpha,
                double beta, const double* alpha_p, const double* beta_p,
                int has_w, cudaStream_t stream) {
  const int kslabs = (k + kWideCols - 1) / kWideCols;
  const long long ntiles = (n + kWideRows - 1) / kWideRows;
  for (int i0 = 0; i0 < m; i0 += kWideDepth) {
    const int mc = m - i0 < kWideDepth ? m - i0 : kWideDepth;
    const int mp = (mc + 7) / 8 * 8;
    const int fixed = (mp * kWideCols + kWideRows * kWideCols) *
                      (int)sizeof(double);
    const int per_stage = kWideRows * (mp + kWidePad) * (int)sizeof(double);
    const int room = 232448 - (int)(kWideMaxStages * sizeof(uint64_t));
    int stages = kWideMaxStages;
    while (stages > 2 && fixed + stages * per_stage > room) --stages;
    const int smem = fixed + stages * per_stage;
    int full = 0;
    cudaError_t e = persistent_grid((const void*)tsmm_dmma, kWideThreads,
                                    (size_t)smem, &full);
    if (e != cudaSuccess) return (int)e;
    long long grid = full / kslabs;
    if (grid > ntiles) grid = ntiles;
    if (grid < 1) grid = 1;
    grid *= kslabs;
    if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    const double* Vc = V + i0;
    const int vec = mc % 2 == 0 && m % 2 == 0 && k % 2 == 0 &&
                    (reinterpret_cast<uintptr_t>(Vc) & 15) == 0;
    const bool later = i0 > 0;  // adds to W_out
    tsmm_dmma<<<(unsigned)grid, kWideThreads, smem, stream>>>(
        Vc, m, X + (long long)i0 * k, later ? W_out : W_in, W_out, n, mc, k,
        kslabs, alpha, later ? 1.0 : beta, alpha_p, later ? nullptr : beta_p,
        later ? 1 : has_w, vec, stages);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  return 0;
}

template <typename T>
int launch_tiled(const void* V, const void* X, const void* W_in, void* W_out,
                 long long n, int m, int k, typename Acc<T>::type alpha,
                 typename Acc<T>::type beta, const void* alpha_p,
                 const void* beta_p, int has_w, cudaStream_t stream) {
  using A = typename Acc<T>::type;
  constexpr bool dmma = std::is_same<T, double>::value;
  constexpr int tile = 16 * TiledTile<T>::M;
  const int kslabs = (k + tile - 1) / tile;
  const long long grid = (n + tile - 1) / tile * kslabs;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  if constexpr (dmma) {
    return launch_dmma(static_cast<const double*>(V),
                       static_cast<const double*>(X),
                       static_cast<const double*>(W_in),
                       static_cast<double*>(W_out), n, m, k, alpha, beta,
                       static_cast<const double*>(alpha_p),
                       static_cast<const double*>(beta_p), has_w, stream);
  } else {
    tsmm_tiled<T><<<(unsigned)grid, kThreads, 0, stream>>>(
        static_cast<const T*>(V), static_cast<const A*>(X),
        static_cast<const T*>(W_in), static_cast<T*>(W_out), n, m, k, kslabs,
        alpha, beta, static_cast<const A*>(alpha_p),
        static_cast<const A*>(beta_p), has_w);
    return (int)cudaGetLastError();
  }
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
  int full = 0;
  const cudaError_t e =
      persistent_grid((const void*)kern, kThreads, (size_t)smem, &full);
  if (e != cudaSuccess) return (int)e;
  long long grid = full;
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

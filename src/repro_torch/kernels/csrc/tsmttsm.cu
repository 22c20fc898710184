// Tall-skinny^T x tall-skinny GEMM for Hopper (sm_90a), paper C2 (Fig. 7).
//
// Replaces: repro/kernels/tsmttsm.py:tsmttsm_pallas (the Pallas TPU kernel,
// body `_kernel`).  Computes
//
//   X = alpha * V^T W + beta * X_in        V (n, m), W (n, k) row-major, m, k << n
//
// with an optional Kahan compensation (paper section 5.2), for real
// float64, float32, bfloat16 and float16 inputs and for complex128 and
// complex64 ones, where V^T becomes V^H when `conj` is set (the plain
// version's conj=True) and stays V^T otherwise.  The sums run in the
// accumulation type: float32 for the half types, else the input type.
//
// Bound: memory bandwidth.  The call must read V and W once,
// n * (m + k) * sizeof(T) bytes, for 2 n m k flops; at m = k = 16 that is
// one flop per byte in float64, far below the card's ridge point.  The
// (m, k) result and the cross-block partials are a few hundred KB at most.
//
// Design:
// * The TPU kernel carries one (m, k) accumulator across a sequential grid.
//   Here blocks run in parallel: block `blk` reduces the row range
//   [blk * rows_per_block, ...) into an (m, k) partial (and its Kahan
//   compensation) in a scratch buffer, and a second kernel sums the
//   partials.  No atomics, so the result depends only on the shapes: a
//   chunked solve equals a monolithic one.
// * The bytes in flight live in shared memory, not in registers.  A tile
//   of R consecutive rows of V is one contiguous run of R * m values, and
//   likewise for W, so thread 0 streams both into a ring of three stages
//   with 1-D bulk copies (cp.async.bulk, completion on an mbarrier per
//   stage) while the block computes on the stage before.  Where a tile's
//   base address or size is not a multiple of 16 bytes (a view with an
//   odd offset, odd m or k in a narrow type, the ragged last tile), the
//   threads fill that stage with plain loads instead.  The wrapper picks R
//   (kernels/tsmttsm.py:stage_rows) so that a stage holds at most 32 KB
//   (16 KB for complex128): two stages are in flight while a block
//   computes on a third (deeper rings measured no faster on the H100).
// * Register blocking: a thread owns a TM x TN tile of the result (Tile
//   below) and reads TM values of a V row and TN of the W row from shared
//   memory (as broadcasts, vectorised when a real m and k are multiples
//   of 4), so each loaded value feeds TN (or TM) products.  The G =
//   ceil(m/TM) * ceil(k/TN) tiles of one row are spread over G
//   neighbouring threads; the block's L = 256 / G "row lanes" take the
//   rows of a stage with stride L.  A row of more than 256 tiles (complex
//   values at m * k > 2048, real ones past 4096) is split over grid.y:
//   each block of a slab is one lane over 256 of its tiles, reading the
//   whole rows (float64 takes the DMMA instance instead, the last point).
//   m and k have no upper limit but shared memory: three stages of one
//   row of V and W (m + k up to 16,640 in float32) beside room for
//   complex128's compensation tile.  Past four slabs the wrapper spreads
//   the rows over fewer blocks (at most 2,112 thread blocks in the grid,
//   kernels/tsmttsm.py:row_partition), so the block partials' scratch
//   stays near 2,112 x 256 tiles' values.
// * Kahan (kahan=True): each lane sums groups of KG = 8 of its rows plainly
//   and adds each group's sum with compensation, as the TPU kernel does
//   with its 8-row micro-slabs; the lanes, the blocks and the runs of
//   blocks below are combined with compensation too.  Without Kahan the
//   same groups are added plainly.  A group may straddle two stages: its
//   partial sum stays in registers.  The order of every addition is that
//   of the row partition alone (kernels/tsmttsm.py:summation_depth), not
//   of R.
// * The second kernel gives each result entry a warp: lane l sums the l-th
//   of 32 runs of consecutive blocks' partials in block order, and the
//   runs are then added in run order.  One thread an entry summing all
//   ~527 partials in turn took 0.03-0.07 ms, a tenth of a call.
// * The row count n and the tile edges need no padding: rows past n and
//   result indices past m or k load zeros and store nothing.
// * The partition (rows_per_block, number of blocks) is chosen by the
//   wrapper from n, m, k and the tile alone, not from the card, so the
//   summation order is the same on every card.
// * Complex values (Complex<R> of dtypes.cuh): the stages hold them as
//   stored, a thread conjugates its TM values of V as it reads them
//   (conj), each product is four fused multiply-adds, and Kahan
//   compensates the real and the imaginary parts separately (its
//   additions are those of each part).  A 4 x 4 tile of 16-byte values is
//   192 registers for the sum, compensation and group tiles: the Kahan
//   instance spilled and one block filled an SM.  Complex values take a
//   4 x 2 tile, two blocks an SM; complex128 keeps its compensation tile
//   (touched once every KG rows) in shared memory, so that its sum and
//   group tiles and the operands fit 128 registers.  No instance spills
//   (chip_smoke.py's build phase holds every instance to that).  A 2 x 2
//   tile (three tiles in registers) read twice the operand bytes from
//   shared memory a row and was slower.
// * Float64 rows of more than 256 thread tiles (m * k past about 4096;
//   kernels/tsmttsm.py:uses_dmma) take tsmttsm_dmma on the FP64 tensor
//   cores.  At m = k = 128 the call does 64 flops a byte: its bound is the
//   bytes (2.504 ms at 4,096,000 rows; DMMA's operations 2.003 ms), but
//   the CUDA cores' floor is 3.948 ms, so the slab path (4 x 4 tiles,
//   every row read once a slab) could not reach it (16.77 ms with Kahan,
//   PR 29).  A block owns a result tile of M x N for its row block (Kahan
//   128 x 64, the plain sum 128 x 128; a self-Gram 64 x 64 on and above
//   the diagonal): each row of V's and W's slices is read once a tile, the
//   tiles over grid.x beside the row blocks, so m and k have no limit.  A
//   stage of 32 rows fills by one bulk copy a row slice (cp.async value by
//   value where a row is not on 16 bytes; everywhere, it measured 17 %
//   slower with Kahan and 30 % for the plain sum, tools/b2_trials.py's
//   `cpasync`) into rows padded by 4 values, so that the fragment loads
//   of four rows meet distinct banks; three stages.  Its warps own 32 x WN tiles of mma.sync m16n8k8 fragments
//   (16 x 8 x 8): one instruction is a whole 8-row group.
//   Kahan keeps the TPU kernel's 8-row groups: the group's products and
//   the compensation enter the mma together (its accumulator holds -c, so
//   it returns y = p - c, the nine terms summed in the tensor core's
//   order), then u = s + y, -c = y - (u - s), s = u on the CUDA cores:
//   kahan_add with its first subtraction in the tensor core.  The plain
//   sum accumulates s in the mma.  Registers set the tiles: s and c of a
//   32 x 32 warp tile take 128 registers, so Kahan blocks are 128 x 64
//   (the two column halves of a 128 x 128 result adjacent in the grid,
//   V's rows read twice through L2) in sixteen warps of 32 x 16.  A
//   self-Gram (V is W: block CG's SVQB Gram) computes the 64 x 64 tiles on
//   and above the diagonal (eight warps of 32 x 16 a block, two blocks an
//   SM) and the finishing kernel mirrors the rest.  Measured on an H100
//   80GB HBM3 at 700 W at 4,096,000 x 128 x 128 (PERF.md, PR 30;
//   tools/b2_trials.py): Kahan 6.7 ms, its self-Gram 5.3-5.5, the plain sum
//   3.0-3.6 (addmm 3.0-3.2).  Eight Kahan warps of 32 x 32 took 7.7 ms;
//   the fold as four additions after a group sum from zero 9.6; the
//   compensation tile in shared memory 13.8; m8n8k4 products 10.3 (the
//   plain sum 5.5 against 3.8 with m16n8k8); unrolling a stage's groups
//   spilled or measured slower, deeper rings slower too.  The Kahan
//   blocks without their folds take 5.4 ms against 3.1 for the plain
//   sum's 128 x 128 blocks of as many warps: the half-width blocks (twice
//   the blocks, each stage's copies, barriers and V's rows for half the
//   products), which the registers of s and c force, cost more than the
//   folds (1.3 ms).

#include <cuda_runtime.h>
#include <stdint.h>
#include <type_traits>

#include "dtypes.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kKG = 8;      // rows per plainly summed group
constexpr int kStages = 3;  // shared-memory ring
constexpr int kFinishWarps = 4;  // result entries of a finishing block
constexpr int kFinishChunk = 8;  // partials a lane has in flight

// A thread's tile of the result (M entries of V's row by N of W's), the
// blocks an SM should hold, and whether the Kahan compensation tile lives
// in shared memory (kernels/tsmttsm.py:
// thread_tile and stage_bytes):
// * real values: 4 x 4, one block where the registers ask for it;
// * complex128: 4 x 2, two blocks an SM: its sum and group tiles and the
//   operands take the 128 registers that allows, so the compensation
//   tile, touched once every kKG rows, lives in shared memory,
//   thread-minor; 16 KB stages keep two blocks' rings and tiles in one
//   SM's shared memory;
// * complex64: 4 x 2, whose three tiles fit two blocks an SM.
template <typename T> struct Tile {
  static constexpr int M = 4, N = 4, kMinBlocks = 1;
  static constexpr bool kSharedComp = false;
};
template <> struct Tile<Complex<double>> {
  static constexpr int M = 4, N = 2, kMinBlocks = 2;
  static constexpr bool kSharedComp = true;
};
template <> struct Tile<Complex<float>> {
  static constexpr int M = 4, N = 2, kMinBlocks = 2;
  static constexpr bool kSharedComp = false;
};

// Tiles of one row's (m, k) result.
template <typename T>
__host__ __device__ inline int tiles_of(int m, int k) {
  return ((m + Tile<T>::M - 1) / Tile<T>::M) *
         ((k + Tile<T>::N - 1) / Tile<T>::N);
}

// Adds t to the running sum s with compensation c (the sum is s - c), as
// the TPU kernel's body does: y = t - c; u = s + y; c = (u - s) - y; s = u.
template <typename A>
__device__ __forceinline__ void kahan_add(A& s, A& c, A t) {
  const A y = t - c;
  const A u = s + y;
  c = (u - s) - y;
  s = u;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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
// addresses 16-byte aligned), completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Four consecutive stored values (16-byte or 8-byte aligned in shared
// memory) converted to the accumulation type.
template <typename A>
__device__ __forceinline__ void load4(const double* p, A* out) {
  const double2 a = reinterpret_cast<const double2*>(p)[0];
  const double2 b = reinterpret_cast<const double2*>(p)[1];
  out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
}
template <typename A>
__device__ __forceinline__ void load4(const float* p, A* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
}
template <typename A>
__device__ __forceinline__ void load4(const __nv_bfloat16* p, A* out) {
  const __nv_bfloat162* q = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 a = __bfloat1622float2(q[0]);
  const float2 b = __bfloat1622float2(q[1]);
  out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
}
template <typename A>
__device__ __forceinline__ void load4(const __half* p, A* out) {
  const __half2* q = reinterpret_cast<const __half2*>(p);
  const float2 a = __half22float2(q[0]);
  const float2 b = __half22float2(q[1]);
  out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
}
// N consecutive stored values in the accumulation type: four real ones as
// one or two vectors, complex ones (8 or 16 bytes each) one by one.
template <int N, typename A, typename T>
__device__ __forceinline__ void load_run(const T* p, A* out) {
  if constexpr (N == 4 && !IsComplex<T>::value) {
    load4<A>(p, out);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = load_as<A>(p[i]);
  }
}

// Pass 1: part[blk] = sum over the block's rows of V[r]^T W[r] (V[r]^H
// with conj; plus its compensation comp[blk] when KAHAN).  VEC: m and k
// are multiples of the tile's edges.
// `bulk` says the operands' base addresses and the block and stage sizes
// allow 16-byte bulk copies; each tile checks its own size too.
// Where a row has more tiles than the block has threads (complex values
// at m * k > 2048), the block is one row lane and grid.y splits the tiles
// into slabs of kThreads, each reading the whole rows.
template <typename T, bool KAHAN, bool VEC>
__global__ void __launch_bounds__(kThreads, Tile<T>::kMinBlocks)
tsmttsm_partial(const T* __restrict__ V, const T* __restrict__ W,
                typename Acc<T>::type* __restrict__ part,
                typename Acc<T>::type* __restrict__ comp, long long n, int m,
                int k, long long rows_per_block, int tile_rows,
                int w_offset, int stage_stride, int comp_offset, int bulk,
                int conj) {
  using A = typename Acc<T>::type;
  constexpr int TM = Tile<T>::M;
  constexpr int TN = Tile<T>::N;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bars[kStages];
  const int mk = m * k;

  const int kt = (k + TN - 1) / TN;
  const int G = tiles_of<T>(m, k);
  const bool slabs = G > kThreads;
  const int L = slabs ? 1 : kThreads / G;
  const int t = threadIdx.x;
  const int lane = slabs ? 0 : t / G;
  const int g = slabs ? blockIdx.y * kThreads + t : t % G;
  const int i0 = (g / kt) * TM;
  const int j0 = (g % kt) * TN;
  const bool worker = lane < L && g < G;

  const long long r_begin = (long long)blockIdx.x * rows_per_block;
  long long r_end = r_begin + rows_per_block;
  if (r_end > n) r_end = n;
  const long long nrows = r_end - r_begin;
  const int ntiles = (int)((nrows + tile_rows - 1) / tile_rows);
  const int Q = tile_rows / L;  // rows of one lane in a full tile

  auto rows_of = [&](int tile) -> int {
    const long long left = nrows - (long long)tile * tile_rows;
    return left < tile_rows ? (int)left : tile_rows;
  };
  auto by_bulk = [&](int tile) -> bool {
    const long long rows = rows_of(tile);
    return bulk && (rows * m * (long long)sizeof(T)) % 16 == 0 &&
           (rows * k * (long long)sizeof(T)) % 16 == 0;
  };
  auto stage_v = [&](int s) {
    return reinterpret_cast<T*>(smem + (size_t)s * stage_stride);
  };
  auto stage_w = [&](int s) {
    return reinterpret_cast<T*>(smem + (size_t)s * stage_stride + w_offset);
  };
  auto fetch = [&](int tile) {
    const int s = tile % kStages;
    const long long r0 = r_begin + (long long)tile * tile_rows;
    const uint32_t vb = (uint32_t)(rows_of(tile) * m * sizeof(T));
    const uint32_t wb = (uint32_t)(rows_of(tile) * k * sizeof(T));
    mbar_expect(&bars[s], vb + wb);
    bulk_load(stage_v(s), V + r0 * m, vb, &bars[s]);
    bulk_load(stage_w(s), W + r0 * k, wb, &bars[s]);
  };

  if (t == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&bars[s]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (t == 0) {
    for (int tile = 0; tile < kStages && tile < ntiles; ++tile)
      if (by_bulk(tile)) fetch(tile);
  }

  // the compensation tile: registers, or (kSharedComp) shared memory past
  // the ring and the lane combine's buffer, entry e of thread t at
  // e * kThreads + t
  constexpr bool CS = KAHAN && Tile<T>::kSharedComp;
  A s[TM][TN], c[TM][TN], p[TM][TN];
  A* c_sh = reinterpret_cast<A*>(smem + comp_offset);
  auto comp_of = [&](int a, int b) -> A {
    if constexpr (CS)
      return c_sh[(a * TN + b) * kThreads + t];
    else
      return c[a][b];
  };
#pragma unroll
  for (int a = 0; a < TM; ++a)
#pragma unroll
    for (int b = 0; b < TN; ++b) {
      s[a][b] = p[a][b] = c[a][b] = A(0);
      if constexpr (CS) c_sh[(a * TN + b) * kThreads + t] = A(0);
    }

  auto fold = [&]() {
#pragma unroll
    for (int a = 0; a < TM; ++a)
#pragma unroll
      for (int b = 0; b < TN; ++b) {
        if constexpr (CS)
          kahan_add(s[a][b], c_sh[(a * TN + b) * kThreads + t], p[a][b]);
        else if (KAHAN)
          kahan_add(s[a][b], c[a][b], p[a][b]);
        else
          s[a][b] += p[a][b];
        p[a][b] = A(0);
      }
  };

  uint32_t phase = 0;  // bit s: parity of stage s's next bulk fill
  int in_group = 0;    // rows of this lane's current group seen so far
  bool hit = false;    // the current group holds a row below n
  for (int tile = 0; tile < ntiles; ++tile) {
    const int st = tile % kStages;
    const int rows = rows_of(tile);
    const T* sv = stage_v(st);
    const T* sw = stage_w(st);
    if (by_bulk(tile)) {
      mbar_wait(&bars[st], (phase >> st) & 1u);
      phase ^= 1u << st;
    } else {
      const long long r0 = r_begin + (long long)tile * tile_rows;
      T* dv = stage_v(st);
      T* dw = stage_w(st);
      for (int i = t; i < rows * m; i += kThreads) dv[i] = V[r0 * m + i];
      for (int i = t; i < rows * k; i += kThreads) dw[i] = W[r0 * k + i];
      __syncthreads();
    }
    if (worker) {
      for (int q0 = 0; q0 < Q;) {
        const int run = min(kKG - in_group, Q - q0);
#pragma unroll
        for (int q = 0; q < kKG; ++q) {
          if (q >= run) break;
          const int lr = lane + (q0 + q) * L;
          if (lr < rows) {
            A va[TM], wb[TN];
            if (VEC) {
              load_run<TM>(sv + lr * m + i0, va);
              load_run<TN>(sw + lr * k + j0, wb);
            } else {
#pragma unroll
              for (int a = 0; a < TM; ++a)
                va[a] = (i0 + a < m) ? load_as<A>(sv[lr * m + i0 + a]) : A(0);
#pragma unroll
              for (int b = 0; b < TN; ++b)
                wb[b] = (j0 + b < k) ? load_as<A>(sw[lr * k + j0 + b]) : A(0);
            }
            if (IsComplex<A>::value && conj) {
#pragma unroll
              for (int a = 0; a < TM; ++a) va[a] = conj_of(va[a]);
            }
#pragma unroll
            for (int a = 0; a < TM; ++a)
#pragma unroll
              for (int b = 0; b < TN; ++b)
                p[a][b] = mul_add(va[a], wb[b], p[a][b]);
            hit = true;
          }
        }
        q0 += run;
        in_group += run;
        if (in_group == kKG) {
          if (hit) fold();
          in_group = 0;
          hit = false;
        }
      }
    }
    __syncthreads();  // every thread is done with stage st
    if (t == 0 && tile + kStages < ntiles && by_bulk(tile + kStages)) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      fetch(tile + kStages);
    }
  }
  if (worker && hit) fold();

  if (slabs) {
    // one lane: each thread's entries are the block's, combined as the
    // lane loop below combines one lane
    if (worker) {
#pragma unroll
      for (int a = 0; a < TM; ++a)
#pragma unroll
        for (int b = 0; b < TN; ++b)
          if (i0 + a < m && j0 + b < k) {
            const long long o = (long long)blockIdx.x * mk + (i0 + a) * k +
                                j0 + b;
            A S = A(0), C = A(0);
            if (KAHAN) {
              kahan_add(S, C, s[a][b]);
              kahan_add(S, C, -comp_of(a, b));
              comp[o] = C;
            } else {
              S += s[a][b];
            }
            part[o] = S;
          }
    }
    return;
  }

  // combine the lanes in lane order: first the sums, then (Kahan) the
  // compensations, through the (now idle) ring
  A* sh_s = reinterpret_cast<A*>(smem);
  const int nrounds = KAHAN ? 2 : 1;
  for (int round = 0; round < nrounds; ++round) {
    if (worker) {
#pragma unroll
      for (int a = 0; a < TM; ++a)
#pragma unroll
        for (int b = 0; b < TN; ++b)
          if (i0 + a < m && j0 + b < k)
            sh_s[lane * mk + (i0 + a) * k + j0 + b] =
                round == 0 ? s[a][b] : comp_of(a, b);
    }
    __syncthreads();
    for (int o = t; o < mk; o += kThreads) {
      if (round == 0) {
        A S = A(0), C = A(0);
        for (int l = 0; l < L; ++l) {
          if (KAHAN)
            kahan_add(S, C, sh_s[l * mk + o]);
          else
            S += sh_s[l * mk + o];
        }
        part[(long long)blockIdx.x * mk + o] = S;
        if (KAHAN) comp[(long long)blockIdx.x * mk + o] = C;
      } else {
        // the lanes' compensations enter as -c terms
        A S = part[(long long)blockIdx.x * mk + o];
        A C = comp[(long long)blockIdx.x * mk + o];
        for (int l = 0; l < L; ++l) kahan_add(S, C, -sh_s[l * mk + o]);
        part[(long long)blockIdx.x * mk + o] = S;
        comp[(long long)blockIdx.x * mk + o] = C;
      }
    }
    __syncthreads();
  }
}

// One value of every lane of a warp from lane `src`.
__device__ __forceinline__ double lane_value(double v, int src) {
  return __shfl_sync(0xffffffffu, v, src);
}
__device__ __forceinline__ float lane_value(float v, int src) {
  return __shfl_sync(0xffffffffu, v, src);
}
template <typename R>
__device__ __forceinline__ Complex<R> lane_value(Complex<R> v, int src) {
  return Complex<R>(lane_value(v.re, src), lane_value(v.im, src));
}

// Pass 2: one warp per result entry.  The block partials are cut into 32
// runs of ceil(nblocks / 32) consecutive blocks; lane l sums run l in
// block order (kFinishChunk partials in flight ahead of its sums), and
// the runs' sums are then added in run order
// (kernels/tsmttsm.py:summation_depth).  Lane 0 applies alpha, beta and
// the output type (alpha and beta read on the card where alpha_p and
// beta_p are not null).
template <typename T, bool KAHAN, typename A = typename Acc<T>::type>
__global__ void __launch_bounds__(32 * kFinishWarps)
tsmttsm_finish(const typename Acc<T>::type* __restrict__ part,
               const typename Acc<T>::type* __restrict__ comp, int nblocks,
               int mk, const typename Acc<T>::type* __restrict__ x_in,
               T* __restrict__ x_out, A alpha, A beta,
               const A* __restrict__ alpha_p, const A* __restrict__ beta_p,
               int has_x, int sym) {
  const int o = blockIdx.x * kFinishWarps + threadIdx.x / 32;
  const int l = threadIdx.x & 31;
  if (o >= mk) return;  // the whole warp
  // sym: the partials of a self-Gram (V is W, m = k = sym) hold the
  // entries on and above the diagonal; entry (i, j) below it is (j, i)
  const int src = sym && o / sym > o % sym ? (o % sym) * sym + o / sym : o;
  const int run = (nblocks + 31) / 32;
  const int b_end = min(nblocks, (l + 1) * run);
  A S = A(0), C = A(0);
  for (int b0 = l * run; b0 < b_end; b0 += kFinishChunk) {
    A pv[kFinishChunk], cv[kFinishChunk];
#pragma unroll
    for (int u = 0; u < kFinishChunk; ++u) {
      const bool in = b0 + u < b_end;
      pv[u] = in ? part[(long long)(b0 + u) * mk + src] : A(0);
      cv[u] = (KAHAN && in) ? comp[(long long)(b0 + u) * mk + src] : A(0);
    }
#pragma unroll
    for (int u = 0; u < kFinishChunk; ++u) {
      if (b0 + u >= b_end) break;
      if (KAHAN) {
        kahan_add(S, C, pv[u]);
        kahan_add(S, C, -cv[u]);
      } else {
        S += pv[u];
      }
    }
  }
  A tot = A(0), tc = A(0);
  for (int j = 0; j < 32 && j * run < nblocks; ++j) {
    const A sj = lane_value(S, j);
    if (KAHAN) {
      const A cj = lane_value(C, j);
      kahan_add(tot, tc, sj);
      kahan_add(tot, tc, -cj);
    } else {
      tot += sj;
    }
  }
  if (l == 0) {
    A res = (alpha_p ? *alpha_p : alpha) * tot;
    if (has_x) res += (beta_p ? *beta_p : beta) * x_in[o];
    x_out[o] = store_as<T>(res);
  }
}

// The wide float64 instance on the FP64 tensor cores (see the note at the
// top).  A block owns a result tile of M rows of the result (columns of
// V) by N columns (of W) for the rows of its row block: warps M / 32
// along the tile's rows by N / WN along its columns, each a 32 x WN tile
// of 16 x 8 fragments of mma.sync m16n8k8.  A stage holds kRows rows of
// V's and W's slices, rows padded by kDmmaPad values so that the
// fragment loads of four rows meet distinct banks.
constexpr int kDmmaPad = 4;

template <bool KAHAN, bool SYM> struct DmmaTile;
// Kahan: 128 x 64 a block, sixteen warps of 32 x 16 (s and c are 32
// values a thread), three stages of 32 rows
template <> struct DmmaTile<true, false> {
  static constexpr int M = 128, N = 64, WN = 16, kRows = 32, kStages = 3;
  static constexpr int kMinBlocks = 1;
};
// plain: 128 x 128 a block, sixteen warps of 32 x 32, three stages of 32
// rows
template <> struct DmmaTile<false, false> {
  static constexpr int M = 128, N = 128, WN = 32, kRows = 32, kStages = 3;
  static constexpr int kMinBlocks = 1;
};
// a self-Gram (V is W): 64 x 64 blocks on and above the diagonal, eight
// warps of 32 x 16, two blocks an SM, three stages of 32 rows
template <bool KAHAN> struct DmmaTile<KAHAN, true> {
  static constexpr int M = 64, N = 64, WN = 16, kRows = 32, kStages = 3;
  static constexpr int kMinBlocks = 2;
};
template <bool KAHAN, bool SYM>
constexpr int dmma_threads = DmmaTile<KAHAN, SYM>::M / 32 *
                             (DmmaTile<KAHAN, SYM>::N /
                              DmmaTile<KAHAN, SYM>::WN) * 32;

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

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
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

// Pass 1 of the wide float64 instance: part[blk] (and comp[blk]) over the
// result tile (blockIdx.x % ktiles along k, then along m) of row block
// blk = blockIdx.x / (mtiles * ktiles); SYM (V is W, m = k): over the
// tiles on and above the diagonal, blockIdx.x % (mtiles (mtiles + 1) / 2)
// row by row, whose entries below the diagonal are not written.  `vec`:
// m and k are even and V and W start on 16 bytes, so the stages fill by
// bulk copies, else value by value.
template <bool KAHAN, bool SYM>
__global__ void __launch_bounds__(dmma_threads<KAHAN, SYM>,
                                  DmmaTile<KAHAN, SYM>::kMinBlocks)
tsmttsm_dmma(const double* __restrict__ V, const double* __restrict__ W,
             double* __restrict__ part, double* __restrict__ comp,
             long long n, int m, int k, long long rows_per_block, int mtiles,
             int ktiles, int vec) {
  using Tl = DmmaTile<KAHAN, SYM>;
  constexpr int TM = Tl::M, TN = Tl::N, NT = dmma_threads<KAHAN, SYM>;
  constexpr int R = Tl::kRows, kStages = Tl::kStages;
  constexpr int SV = TM + kDmmaPad, SW = TN + kDmmaPad;
  constexpr int kStage = R * (SV + SW);  // values of one stage
  constexpr int NA = 4, NB = Tl::WN / 8;  // a warp's fragments
  // groups of a stage not unrolled (unrolled by two, they measured slower
  // or spilled)
  constexpr int kGroupUnroll = 1;
  extern __shared__ __align__(16) double ring[];

  int mt, kt;
  long long blk;
  if (SYM) {
    const int ntri = mtiles * (mtiles + 1) / 2;
    int tt = (int)(blockIdx.x % ntri);
    blk = blockIdx.x / ntri;
    mt = 0;
    while (tt >= mtiles - mt) tt -= mtiles - mt++;
    kt = mt + tt;
  } else {
    kt = blockIdx.x % ktiles;
    mt = (blockIdx.x / ktiles) % mtiles;
    blk = blockIdx.x / ((long long)ktiles * mtiles);
  }
  const int i0 = mt * TM, j0 = kt * TN;
  const int mc = min(TM, m - i0), kc = min(TN, k - j0);
  const long long r_begin = blk * rows_per_block;
  const long long nrows =
      min(rows_per_block, n - r_begin);  // at least 1 (row_partition)
  const int ntiles = (int)((nrows + R - 1) / R);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int wr = (warp % (TM / 32)) * 32, wc = (warp / (TM / 32)) * Tl::WN;
  const int g = lane >> 2, q = lane & 3;  // fragment place
  // a warp whose tile lies below the diagonal of a self-Gram waits
  const bool active =
      wr < mc && wc < kc && !(SYM && i0 + wr > j0 + wc + Tl::WN - 1);

  // vec: each stage fills by one bulk copy a row of V's and of W's
  // slices (warp 0's lanes issue them), completing on the stage's barrier
  __shared__ __align__(8) uint64_t bars[kStages];
  // columns past mc (kc) are never filled: zero the ring once
  for (int o = t; o < kStages * kStage; o += NT) ring[o] = 0.0;
  if (t == 0) {
    for (int st = 0; st < kStages; ++st) mbar_init(&bars[st]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  auto rows_of = [&](int tile) -> int {
    const long long left = nrows - (long long)tile * R;
    return left < R ? (int)left : R;
  };
  auto issue = [&](int tile) {
    if (tile < ntiles) {
      double* sv = ring + (tile % kStages) * kStage;
      double* sw = sv + R * SV;
      const long long r0 = r_begin + (long long)tile * R;
      const int rows = rows_of(tile);
      if (vec) {
        // rows past the block's end: zeros (the last tile only)
        for (int e = t; e < (R - rows) * (SV + SW); e += NT) {
          const int r = rows + e / (SV + SW), c = e % (SV + SW);
          if (c < SV)
            sv[r * SV + c] = 0.0;
          else
            sw[r * SW + c - SV] = 0.0;
        }
        if (warp == 0) {
          const int st = tile % kStages;
          if (lane == 0)
            mbar_expect(&bars[st],
                        (uint32_t)(rows * (mc + kc) * (int)sizeof(double)));
          __syncwarp();
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          for (int r = lane; r < rows; r += 32) {
            bulk_load(sv + r * SV, V + (r0 + r) * m + i0,
                      (uint32_t)(mc * sizeof(double)), &bars[st]);
            bulk_load(sw + r * SW, W + (r0 + r) * k + j0,
                      (uint32_t)(kc * sizeof(double)), &bars[st]);
          }
        }
      } else {
        for (int e = t; e < R * TM; e += NT) {
          const int r = e / TM, c = e % TM;
          if (r >= rows)
            sv[r * SV + c] = 0.0;
          else if (c < mc)
            cp_async8(sv + r * SV + c, V + (r0 + r) * m + i0 + c);
        }
        for (int e = t; e < R * TN; e += NT) {
          const int r = e / TN, c = e % TN;
          if (r >= rows)
            sw[r * SW + c] = 0.0;
          else if (c < kc)
            cp_async8(sw + r * SW + c, W + (r0 + r) * k + j0 + c);
        }
      }
    }
    if (!vec) cp_commit();  // empty groups keep the count uniform
  };

  double s[NA][NB][2], c[KAHAN ? NA : 1][KAHAN ? NB : 1][2];
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      s[a][b][0] = s[a][b][1] = 0.0;
      if constexpr (KAHAN) c[a][b][0] = c[a][b][1] = 0.0;
    }

#pragma unroll 1
  for (int st = 0; st < kStages - 1; ++st) issue(st);
  uint32_t phase = 0;  // bit st: parity of stage st's next bulk fill
#pragma unroll 1
  for (int tile = 0; tile < ntiles; ++tile) {
    if (vec) {
      __syncthreads();  // every warp is done with the stage of tile - 1
      issue(tile + kStages - 1);
      const int st = tile % kStages;
      mbar_wait(&bars[st], (phase >> st) & 1u);
      phase ^= 1u << st;
    } else {
      cp_wait<kStages - 2>();
      __syncthreads();  // tile `tile` is in; the stage of tile - 1 is free
      issue(tile + kStages - 1);
    }
    if (!active) continue;
    const double* sv = ring + (tile % kStages) * kStage;
    const double* sw = sv + R * SV;
    const int rows = rows_of(tile);
#pragma unroll kGroupUnroll
    for (int g0 = 0; g0 < R; g0 += 8) {  // one 8-row group
      if (g0 >= rows) break;
      double fa[2][NA], fb[2][NB];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = g0 + 4 * h + q;
#pragma unroll
        for (int a = 0; a < NA; ++a) fa[h][a] = sv[r * SV + wr + 8 * a + g];
#pragma unroll
        for (int b = 0; b < NB; ++b) fb[h][b] = sw[r * SW + wc + 8 * b + g];
      }
#pragma unroll
      for (int a = 0; a < NA; a += 2)
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          // fragments a and a + 1 (16 x 8) of the warp's tile
          double d[4];
          if constexpr (KAHAN) {
            // kahan_add of the group's sum p: y = p - c in the tensor core
            // (c holds -c), then u = s + y, c = (u - s) - y, s = u
#pragma unroll
            for (int e = 0; e < 4; ++e) d[e] = c[a + (e >> 1)][b][e & 1];
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e) d[e] = s[a + (e >> 1)][b][e & 1];
          }
          dmma16(d, fa[0][a], fa[0][a + 1], fa[1][a], fa[1][a + 1], fb[0][b],
                 fb[1][b]);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            double& se = s[a + (e >> 1)][b][e & 1];
            if constexpr (KAHAN) {
              const double u = se + d[e];
              c[a + (e >> 1)][b][e & 1] = d[e] - (u - se);
              se = u;
            } else {
              se = d[e];
            }
          }
        }
    }
  }
  if (!vec) cp_wait<0>();  // no copy outlives the block (the bulk copies
                          // of the last tiles were waited for)
  if (!active) return;
  const long long base = blk * (long long)m * k;
#pragma unroll
  for (int a = 0; a < NA; ++a) {
    const int i = wr + 8 * a + g;
    if (i >= mc) continue;
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = wc + 8 * b + 2 * q + h;
        if (j >= kc) continue;
        const long long o = base + (long long)(i0 + i) * k + j0 + j;
        part[o] = s[a][b][h];
        if constexpr (KAHAN) comp[o] = -c[a][b][h];
      }
  }
}

struct Args {
  const void* V;
  const void* W;
  void* part;
  void* comp;
  long long n;
  int m, k;
  long long rows_per_block;
  int nblocks, tile_rows, bulk;
  const void* x_in;
  void* x_out;
  double alpha, beta, alpha_im, beta_im;
  const void *alpha_p, *beta_p;
  int has_x, conj, sym;
};

inline int round16(long long bytes) { return (int)((bytes + 15) / 16 * 16); }

// Pass 2 over the block partials of a.nblocks row blocks.
template <typename T, bool KAHAN>
int finish(const Args& a, cudaStream_t stream) {
  using A = typename Acc<T>::type;
  const int mk = a.m * a.k;
  tsmttsm_finish<T, KAHAN><<<(mk + kFinishWarps - 1) / kFinishWarps,
                             32 * kFinishWarps, 0, stream>>>(
      static_cast<const A*>(a.part), static_cast<const A*>(a.comp),
      a.nblocks, mk, static_cast<const A*>(a.x_in), static_cast<T*>(a.x_out),
      make_scalar<A>(a.alpha, a.alpha_im), make_scalar<A>(a.beta, a.beta_im),
      static_cast<const A*>(a.alpha_p), static_cast<const A*>(a.beta_p),
      a.has_x, a.sym);
  return (int)cudaGetLastError();
}

template <typename T, bool KAHAN, bool VEC>
int launch(const Args& a, cudaStream_t stream) {
  using A = typename Acc<T>::type;
  const int mk = a.m * a.k;
  if (a.nblocks > 0) {
    const int G = tiles_of<T>(a.m, a.k);
    const int L = G > kThreads ? 1 : kThreads / G;
    const int w_offset = round16((long long)a.tile_rows * a.m * sizeof(T));
    const int stride =
        w_offset + round16((long long)a.tile_rows * a.k * sizeof(T));
    int smem = kStages * stride;
    const int combine = G > kThreads ? 0 : L * mk * (int)sizeof(A);
    if (combine > smem) smem = combine;
    const int comp_offset = round16(smem);
    if (KAHAN && Tile<T>::kSharedComp)
      smem = comp_offset + Tile<T>::M * Tile<T>::N * kThreads * (int)sizeof(A);
    auto kern = tsmttsm_partial<T, KAHAN, VEC>;
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid(a.nblocks, (G + kThreads - 1) / kThreads);
    kern<<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(a.V), static_cast<const T*>(a.W),
        static_cast<A*>(a.part), static_cast<A*>(a.comp), a.n, a.m, a.k,
        a.rows_per_block, a.tile_rows, w_offset, stride, comp_offset, a.bulk,
        a.conj);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return finish<T, KAHAN>(a, stream);
}

// The wide float64 instance: tsmttsm_dmma over the row blocks and result
// tiles (a self-Gram's on and above the diagonal), then the finishing
// kernel.
template <bool KAHAN, bool SYM>
int launch_dmma(const Args& a, cudaStream_t stream) {
  using Tl = DmmaTile<KAHAN, SYM>;
  if (a.nblocks > 0) {
    const int mtiles = (a.m + Tl::M - 1) / Tl::M;
    const int ktiles = (a.k + Tl::N - 1) / Tl::N;
    const long long tiles =
        SYM ? (long long)mtiles * (mtiles + 1) / 2 : (long long)mtiles * ktiles;
    const long long grid = (long long)a.nblocks * tiles;
    if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    const int smem = Tl::kStages * Tl::kRows *
                     (Tl::M + kDmmaPad + Tl::N + kDmmaPad) *
                     (int)sizeof(double);
    auto kern = tsmttsm_dmma<KAHAN, SYM>;
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    const int vec = a.m % 2 == 0 && a.k % 2 == 0 &&
                    (reinterpret_cast<uintptr_t>(a.V) & 15) == 0 &&
                    (reinterpret_cast<uintptr_t>(a.W) & 15) == 0;
    kern<<<(unsigned)grid, dmma_threads<KAHAN, SYM>, smem, stream>>>(
        static_cast<const double*>(a.V), static_cast<const double*>(a.W),
        static_cast<double*>(a.part), static_cast<double*>(a.comp), a.n, a.m,
        a.k, a.rows_per_block, mtiles, ktiles, vec);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return finish<double, KAHAN>(a, stream);
}

template <typename T>
int launch_t(int kahan, const Args& args, cudaStream_t s) {
  // a stage holds whole sweeps of the row lanes
  const int G = tiles_of<T>(args.m, args.k);
  if constexpr (std::is_same<T, double>::value) {
    // float64 rows of more than kThreads tiles: the FP64 tensor cores
    if (G > kThreads) {
      if (args.sym)
        return kahan ? launch_dmma<true, true>(args, s)
                     : launch_dmma<false, true>(args, s);
      return kahan ? launch_dmma<true, false>(args, s)
                   : launch_dmma<false, false>(args, s);
    }
  }
  Args a = args;
  a.sym = 0;  // the other instances compute every entry
  if (a.nblocks > 0 && a.tile_rows % (G > kThreads ? 1 : kThreads / G))
    return (int)cudaErrorInvalidValue;
  const bool vec = a.m % Tile<T>::M == 0 && a.k % Tile<T>::N == 0;
  if (kahan)
    return vec ? launch<T, true, true>(a, s) : launch<T, true, false>(a, s);
  return vec ? launch<T, false, true>(a, s) : launch<T, false, false>(a, s);
}

}  // namespace

// dtype: 0 float64, 1 float32, 2 bfloat16, 3 float16, 4 complex128,
// 5 complex64; conj (complex only) gives V^H W.  alpha and beta come as
// real and imaginary parts (the imaginary parts are ignored for a real
// dtype), or, where alpha_p / beta_p is not null, as one value of the
// accumulation type on the card.  part and comp hold
// nblocks * m * k values of the accumulation type (comp only for kahan);
// x_in holds m * k values of the accumulation type (read when has_x).
// sym says V is W (same pointer, m = k): the float64 DMMA instance then
// computes the entries on and above the diagonal and mirrors the rest.
// tile_rows is a multiple of the row lanes (kernels/tsmttsm.py:stage_rows);
// bulk says V and W start on 16-byte boundaries and rows_per_block and
// tile_rows rows of each are whole multiples of 16 bytes.
// Returns the first CUDA error of the launches (0 on success).
extern "C" int tsmttsm_launch(int dtype, int kahan, int conj, const void* V,
                              const void* W, void* part, void* comp,
                              long long n, int m, int k,
                              long long rows_per_block, int nblocks,
                              int tile_rows, int bulk, const void* x_in,
                              void* x_out, double alpha, double beta,
                              double alpha_im, double beta_im,
                              const void* alpha_p, const void* beta_p,
                              int has_x, int sym, void* stream) {
  if (m < 1 || k < 1 || n < 0 || nblocks < 0 ||
      (nblocks > 0 && (rows_per_block < 1 || tile_rows < 1)))
    return (int)cudaErrorInvalidValue;
  // sym: V is W (m = k), which the DMMA instance uses
  const Args a{V,       W,        part,      comp,     n,       m,
               k,       rows_per_block, nblocks, tile_rows, bulk, x_in,
               x_out,   alpha,    beta,      alpha_im, beta_im, alpha_p,
               beta_p,  has_x,    conj,      sym && m == k ? m : 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_t<double>(kahan, a, s);
    case 1: return launch_t<float>(kahan, a, s);
    case 2: return launch_t<__nv_bfloat16>(kahan, a, s);
    case 3: return launch_t<__half>(kahan, a, s);
    case 4: return launch_t<Complex<double>>(kahan, a, s);
    case 5: return launch_t<Complex<float>>(kahan, a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

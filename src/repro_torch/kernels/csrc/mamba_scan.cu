// State-resident selective-SSM (Mamba) scan for Hopper (sm_90a).
//
// Replaces: repro/kernels/mamba_scan.py:mamba_scan_pallas (the Pallas TPU
// kernel, body `_kernel`).  For dt, xc of shape (B, S, di), Bc, Cc of shape
// (B, S, N) and A of shape (di, N), all float32 and row-major, it computes
//
//   h[b, s, d, n] = exp(dt[b, s, d] * A[d, n]) * h[b, s-1, d, n]
//                   + dt[b, s, d] * xc[b, s, d] * Bc[b, s, n]
//   y[b, s, d]    = sum_n h[b, s, d, n] * Cc[b, s, n]
//
// with h[b, -1, d, n] = 0, recurrent over the whole of s.
//
// Bound: at the Mamba layers' shapes (N = 16), the exponentials and the
// bytes about equally.  The call must read dt and xc and write y, 12 bytes
// per (b, s, d), plus Bc, Cc and A, which are N / di of that; and it must
// evaluate B * S * di * N exponentials, which the special-function units
// (MUFU) issue at 16 per clock per SM, a quarter of a warp per clock on
// each of the SM's four schedulers.  So a warp's step over its states is
// SFU-bound while it issues fewer than 8 instructions per state, and the
// loads of dt and xc must stay in flight meanwhile.  No state is ever
// written to device memory.
//
// Design:
// * One exponential is one MUFU.EX2.  Each thread forms a2 = A * log2(e)
//   once, at entry, and takes exp(dt A) as ex2.approx.ftz.f32(dt * a2):
//   an FMUL and a MUFU, where expf is a libdevice routine of several FMA
//   pipe instructions around its MUFU.  A is a trained parameter, so
//   exp(dt A[d, n]) cannot be formed as powers of one exponential per
//   channel.  Why this is accurate enough: ex2.approx is within 2 ulp of
//   the correctly rounded 2^x (2.5 ulp of 2^x, a relative 5u with u =
//   2^-24), the rounding of a2 and of dt * a2 perturbs the exponent by 3
//   units of roundoff (a relative 3 |dt A| u in the result), and .ftz
//   flushes results below 2^-126 to 0, an absolute error of at most 2^-126
//   on a factor that multiplies a state.  kernels/mamba_scan.py:error_bound
//   charges each of these, and chip_smoke.py measures ex2 on every float32
//   argument <= 0 through mamba_exp2_launch below.  The inline
//   PTX touches this exponential alone: no file-wide fast-math flags.
// * A state update is then five instructions: FMUL (dt a2), MUFU.EX2, FMUL
//   (dt xc Bc), FFMA (h), FFMA (the share of y), with Bc and Cc read from
//   shared memory as float4 broadcasts.  Per timestep a thread adds two
//   shared-memory loads (dt, xc), a product and a store, which its NPL
//   states share: about 6.1 instructions a state in all.
// * The TPU kernel keeps a (d_tile, N) state in VMEM while its grid walks
//   (batch x d_tile) in order.  Here each channel (b, d) belongs to LANES
//   neighbouring threads of one warp, and each of them keeps NPL of its N
//   states and the same entries of a2 in registers for the whole sequence;
//   nothing carries between thread blocks, so any number run at once.  At
//   N <= 16 one thread owns a whole channel: no shuffle, no duplicate
//   loads of dt and xc, and 16 independent exponentials per timestep
//   (128 registers a thread: at B = 4, di = 16384, 512 blocks of 128
//   threads, four per SM, in one wave).  Above N = 16, LANES = 2, 4, 8,
//   16 or 32 lanes of 16 states add their shares of y with warp shuffles
//   (any N up to 512; from 8 lanes on a lane's states are interleaved
//   with its neighbours' four at a time, so the lanes read Bc and Cc as
//   one run: side by side they met on four banks, and N = 128 took 37.69
//   ms at B 4 x S 4096 x d_inner 16384, PERF.md, PR 29).  Past 512 states the launcher runs the scan once
//   a group of at most 512 of them (A, Bc and Cc read with their row
//   stride N), the later groups adding their share to y (ADD): a state
//   never meets another group's, so only y's sum is split, and its
//   roundings stay within error_bound's N of them.
// * A thread block takes CH = 128 / LANES consecutive channels d of batch
//   row b (blockIdx.y), so its rows of dt, xc and y are contiguous.  More
//   than 65,535 batch rows (grid.y's limit) go in launches of 65,535.
// * The block copies kTile timesteps of dt, xc (its CH channels), Bc and Cc
//   (all N states; 16 timesteps, 8 at 16 lanes and 4 at 32, so the ring
//   stays within the 48 KB of static shared memory) into a two-stage ring
//   in shared memory with cp.async,
//   the next stage in flight while the current one is used, so that no
//   register holds a load in flight (dt and xc 16 bytes a copy where every
//   row is 16-byte aligned, 4 bytes otherwise).  The entries no copy
//   writes are zero: states past N (a2 = 0 and Bc = Cc = 0, so such a
//   state stays 0 and adds 0: no branch on N in the inner loop) and
//   channels past di (computed on and never stored).
// * Any S, di and B: the ragged ends are masked; no padding in memory.
//   Threads of channels past di compute on zeros and store nothing, so
//   every lane of a warp reaches every shuffle.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;   // threads per block
constexpr int kMaxLaneStates = 32 * 16;  // states of one launch: 32 lanes
constexpr int kMaxBatch = 65535;         // grid.y

// timesteps per shared-memory stage: 16, fewer where a timestep of Bc and
// Cc takes more than 128 states
template <int LANES> __host__ __device__ constexpr int tile_steps() {
  return LANES <= 8 ? 16 : 16 * 8 / LANES;
}

// 2^x by one MUFU.EX2: within 2 ulp of the rounded 2^x, results below
// 2^-126 flushed to 0
__device__ __forceinline__ float ex2(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ unsigned smem(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
               :: "r"(smem(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :: "r"(smem(dst)), "l"(src) : "memory");
}

// Whether a lane's states are interleaved with its neighbours' four at a
// time (state 4 (q LANES + lane) + k is its j = 4 q + k), so that the
// lanes of a channel read one contiguous run of Bc and Cc: at 8 lanes and
// more, 16 states a lane side by side put every lane's float4 on the same
// four banks of shared memory (a 4-way conflict at N = 128).
template <int LANES> __host__ __device__ constexpr bool interleaved() {
  return LANES >= 8;
}

// One timestep of one lane: NPL states, returns the channel's y (summed
// over its LANES lanes).  bt and ct point at the lane's first state; its
// float4 q lies q (interleaved: q LANES) float4s further.
template <int LANES, int NPL>
__device__ __forceinline__ float step(float (&h)[NPL], const float (&a2)[NPL],
                                      float dt, float x, const float* bt,
                                      const float* ct) {
  constexpr int kQ = interleaved<LANES>() ? LANES : 1;
  const float dtx = dt * x;
  const float4* b4 = reinterpret_cast<const float4*>(bt);
  const float4* c4 = reinterpret_cast<const float4*>(ct);
  float acc[2] = {0.f, 0.f};                 // two chains of the y sum
#pragma unroll
  for (int q = 0; q < NPL / 4; ++q) {
    const float4 bq = b4[q * kQ], cq = c4[q * kQ];
    const float bv[4] = {bq.x, bq.y, bq.z, bq.w};
    const float cv[4] = {cq.x, cq.y, cq.z, cq.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = 4 * q + k;
      h[j] = fmaf(ex2(dt * a2[j]), h[j], dtx * bv[k]);
      acc[k & 1] = fmaf(h[j], cv[k], acc[k & 1]);
    }
  }
  float y = acc[0] + acc[1];
#pragma unroll
  for (int o = LANES / 2; o > 0; o /= 2)
    y += __shfl_xor_sync(0xffffffffu, y, o);
  return y;
}

// N states of this launch, read with row stride ldn (N itself, or the
// whole state size where the launcher runs a group of them); ADD adds the
// channel's share to y instead of storing it.
template <int LANES, int NPL, bool ADD>
__global__ void __launch_bounds__(kThreads, NPL > 8 ? 4 : 8)
mamba_scan_rows(const float* __restrict__ dt, const float* __restrict__ xc,
                const float* __restrict__ Bc, const float* __restrict__ Cc,
                const float* __restrict__ A, float* __restrict__ y, int S,
                int di, int N, int ldn) {
  constexpr int kTile = tile_steps<LANES>();
  constexpr int NS = LANES * NPL;              // padded states per row
  constexpr int CH = kThreads / LANES;         // channels per block
  static_assert(CH % 4 == 0, "16-byte copies of whole channel rows");
  __shared__ __align__(16) float sb[2][kTile][NS];
  __shared__ __align__(16) float sc[2][kTile][NS];
  __shared__ __align__(16) float sd[2][kTile][CH];
  __shared__ __align__(16) float sx[2][kTile][CH];

  const int b = blockIdx.y;
  const int lane = threadIdx.x % LANES;
  const int c = threadIdx.x / LANES;           // this thread's channel
  const int d0 = blockIdx.x * CH;
  const int d = d0 + c;
  const int nch = min(CH, di - d0);            // channels of this block
  const bool active = c < nch;
  // the lane's first state, and its state j
  const int n0 = interleaved<LANES>() ? 4 * lane : lane * NPL;
  auto state = [&](int j) {
    return interleaved<LANES>() ? 4 * (j / 4 * LANES + lane) + j % 4
                                : n0 + j;
  };

  float a2[NPL], h[NPL];
#pragma unroll
  for (int j = 0; j < NPL; ++j) {
    a2[j] = (active && state(j) < N)
                ? A[(long long)d * ldn + state(j)] * 1.4426950408889634f
                : 0.f;
    h[j] = 0.f;
  }

  const long long row0 = (long long)b * S;   // timestep 0 of batch row b
  // zeros where no copy ever writes: states past N, channels past di
  for (int i = threadIdx.x; i < 2 * kTile * NS; i += kThreads)
    if (i % NS >= N) (&sb[0][0][0])[i] = (&sc[0][0][0])[i] = 0.f;
  for (int i = threadIdx.x; i < 2 * kTile * CH; i += kThreads)
    if (i % CH >= nch) (&sd[0][0][0])[i] = (&sx[0][0][0])[i] = 0.f;
  // 16-byte copies of dt and xc where every row of the block is aligned
  const bool vec = di % 4 == 0 &&
                   ((reinterpret_cast<unsigned long long>(dt) |
                     reinterpret_cast<unsigned long long>(xc)) & 15) == 0;
  auto stage = [&](int s0) {                 // kTile timesteps of everything
    const int buf = (s0 / kTile) & 1, ts = min(kTile, S - s0);
    const float* bb = Bc + (row0 + s0) * ldn;
    const float* cb = Cc + (row0 + s0) * ldn;
    for (int i = threadIdx.x; i < ts * NS; i += kThreads) {
      const int t = i / NS, n = i % NS;
      if (n < N) {
        cp_async4(&sb[buf][t][n], bb + t * ldn + n);
        cp_async4(&sc[buf][t][n], cb + t * ldn + n);
      }
    }
    const float* db = dt + (row0 + s0) * di + d0;
    const float* xb = xc + (row0 + s0) * di + d0;
    if (vec) {
      for (int i = threadIdx.x; i < ts * (CH / 4); i += kThreads) {
        const int t = i / (CH / 4), q = 4 * (i % (CH / 4));
        if (q < nch) {
          cp_async16(&sd[buf][t][q], db + (long long)t * di + q);
          cp_async16(&sx[buf][t][q], xb + (long long)t * di + q);
        }
      }
    } else {
      for (int i = threadIdx.x; i < ts * CH; i += kThreads) {
        const int t = i / CH, q = i % CH;
        if (q < nch) {
          cp_async4(&sd[buf][t][q], db + (long long)t * di + q);
          cp_async4(&sx[buf][t][q], xb + (long long)t * di + q);
        }
      }
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };
  stage(0);

  float* py = y + row0 * di + d;             // this channel's y, next step
  const bool store = active && lane == 0;

  for (int s0 = 0; s0 < S; s0 += kTile) {
    asm volatile("cp.async.wait_group 0;" ::: "memory");
    __syncthreads();                           // stage in, the other consumed
    if (s0 + kTile < S) stage(s0 + kTile);
    const int buf = (s0 / kTile) & 1, ts = min(kTile, S - s0);
    const float* bt = &sb[buf][0][n0];
    const float* ct = &sc[buf][0][n0];
    const float* dp = &sd[buf][0][c];
    const float* xp = &sx[buf][0][c];
    if (ts == kTile) {
      // the hot loop: one stage, unrolled by 8 timesteps
#pragma unroll 8
      for (int t = 0; t < kTile; ++t) {
        const float v = step<LANES, NPL>(h, a2, dp[t * CH], xp[t * CH],
                                         bt + t * NS, ct + t * NS);
        if (store) *py = ADD ? *py + v : v;
        py += di;
      }
    } else {                                   // the ragged last stage
      for (int t = 0; t < ts; ++t) {
        const float v = step<LANES, NPL>(h, a2, dp[t * CH], xp[t * CH],
                                         bt + t * NS, ct + t * NS);
        if (store) *py = ADD ? *py + v : v;
        py += di;
      }
    }
  }
}

template <int LANES, int NPL>
int launch(const float* dt, const float* xc, const float* Bc,
           const float* Cc, const float* A, float* y, int B, int S, int di,
           int N, int ldn, bool add, cudaStream_t stream) {
  constexpr int per_block = kThreads / LANES;
  const long long step = (long long)S * di;  // values of one batch row
  for (int b0 = 0; b0 < B; b0 += kMaxBatch) {
    const dim3 grid((di + per_block - 1) / per_block, min(kMaxBatch, B - b0));
    const long long o = b0 * step, on = (long long)b0 * S * ldn;
    if (add)
      mamba_scan_rows<LANES, NPL, true><<<grid, kThreads, 0, stream>>>(
          dt + o, xc + o, Bc + on, Cc + on, A, y + o, S, di, N, ldn);
    else
      mamba_scan_rows<LANES, NPL, false><<<grid, kThreads, 0, stream>>>(
          dt + o, xc + o, Bc + on, Cc + on, A, y + o, S, di, N, ldn);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

// The states [n0, n0 + N) of ldn, on the instance whose lanes hold N.
int launch_group(const float* dt, const float* xc, const float* Bc,
                 const float* Cc, const float* A, float* y, int B, int S,
                 int di, int N, int ldn, int n0, cudaStream_t s) {
  const bool add = n0 > 0;
  Bc += n0;
  Cc += n0;
  A += n0;
  // (lanes per channel, states per lane)
  if (N <= 4) return launch<1, 4>(dt, xc, Bc, Cc, A, y, B, S, di, N, ldn, add, s);
  if (N <= 8) return launch<1, 8>(dt, xc, Bc, Cc, A, y, B, S, di, N, ldn, add, s);
  if (N <= 16) return launch<1, 16>(dt, xc, Bc, Cc, A, y, B, S, di, N, ldn, add, s);
  if (N <= 32) return launch<2, 16>(dt, xc, Bc, Cc, A, y, B, S, di, N, ldn, add, s);
  if (N <= 64) return launch<4, 16>(dt, xc, Bc, Cc, A, y, B, S, di, N, ldn, add, s);
  if (N <= 128) return launch<8, 16>(dt, xc, Bc, Cc, A, y, B, S, di, N, ldn, add, s);
  if (N <= 256) return launch<16, 16>(dt, xc, Bc, Cc, A, y, B, S, di, N, ldn, add, s);
  return launch<32, 16>(dt, xc, Bc, Cc, A, y, B, S, di, N, ldn, add, s);
}

__global__ void exp2_apply(const float* __restrict__ x, float* __restrict__ r,
                           long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += stride)
    r[i] = ex2(x[i]);
}

}  // namespace

// y (B, S, di) from dt, xc (B, S, di), Bc, Cc (B, S, N) and A (di, N), all
// float32 and contiguous.  Any N >= 1 (groups of 512 states past 512) and
// any B (launches of 65,535 rows); B, S or di of 0 launch nothing.
// Returns the first CUDA error of the launches (0 on success).
extern "C" int mamba_scan_launch(const void* dt, const void* xc,
                                 const void* Bc, const void* Cc,
                                 const void* A, void* y, int B, int S, int di,
                                 int N, void* stream) {
  if (B < 0 || S < 0 || di < 0 || N < 1) return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0 || di == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int n0 = 0; n0 < N; n0 += kMaxLaneStates) {
    const int rc = launch_group(
        static_cast<const float*>(dt), static_cast<const float*>(xc),
        static_cast<const float*>(Bc), static_cast<const float*>(Cc),
        static_cast<const float*>(A), static_cast<float*>(y), B, S, di,
        min(kMaxLaneStates, N - n0), N, n0, s);
    if (rc != 0) return rc;
  }
  return 0;
}

// r[i] = the scan's exponential of x[i] (ex2.approx.ftz.f32), for i < n:
// lets a test measure its error over every float32 argument.  Returns the
// CUDA error of the launch (0 on success).
extern "C" int mamba_exp2_launch(const void* x, void* r, long long n,
                                 void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const long long blocks = (n + 255) / 256;
  exp2_apply<<<(unsigned)(blocks < 65536 ? blocks : 65536), 256, 0,
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(r), n);
  return (int)cudaGetLastError();
}

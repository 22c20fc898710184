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
// issue at 16 per clock per SM.  No state is ever written to device memory.
//
// Design:
// * The TPU kernel keeps a (d_tile, N) state in VMEM while its grid walks
//   (batch x d_tile) in order.  Here each channel (b, d) belongs to LANES
//   neighbouring threads of one warp, and each of them keeps NPL of its N
//   states and the same entries of A in registers for the whole sequence;
//   nothing carries between thread blocks, so any number run at once.
//   Splitting a channel over lanes puts more warps in flight (at B = 4,
//   di = 16384, N = 16: two lanes of 8 states, 31 warps per SM) and
//   shortens each thread's chain of dependent operations per timestep.
//   Each lane sums its states' share of y, and the lanes add theirs with
//   warp shuffles.
// * A thread block takes 128 / LANES consecutive channels d of batch row b
//   (blockIdx.y), so a warp's loads of dt and xc and its stores of y are
//   contiguous.  __launch_bounds__ keeps registers at 64 or below, so that
//   eight blocks fit on an SM and B = 4, di = 16384 runs in one wave.
// * All channels of a batch row share Bc[b, s, :] and Cc[b, s, :]: the
//   block stages them in shared memory, kTile timesteps at a time, rows
//   padded with zeros to LANES * NPL states, and a lane reads its NPL
//   entries as float4 broadcasts.  A padded state has A = 0 and Bc = Cc = 0,
//   so it stays 0 and adds 0: no branch on N in the inner loop.
// * A thread loads dt and xc for kUnroll timesteps before it uses any, so
//   that many loads are in flight while the recurrence runs; it walks
//   pointers to dt, xc and y one row (di entries) per timestep instead of
//   computing 64-bit offsets, which cost as much as the state update.
// * expf, not __expf (A is a trained parameter: exp(dt * A[d, n]) cannot be
//   rewritten as powers of one exponential), and no fast-math flags.
// * Any S, di and B: the ragged ends are masked; no padding in memory.
//   Threads of channels past di compute on zeros and store nothing, so
//   every lane of a warp reaches every shuffle.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;   // threads per block
constexpr int kTile = 64;       // timesteps of Bc, Cc staged at a time
constexpr int kUnroll = 8;      // timesteps of dt, xc loaded before use
constexpr int kMaxN = 64;

template <int LANES, int NPL>
__global__ void __launch_bounds__(kThreads, 8)
mamba_scan_rows(const float* __restrict__ dt, const float* __restrict__ xc,
                const float* __restrict__ Bc, const float* __restrict__ Cc,
                const float* __restrict__ A, float* __restrict__ y, int S,
                int di, int N) {
  constexpr int NS = LANES * NPL;              // padded states per row
  __shared__ __align__(16) float sb[kTile][NS];
  __shared__ __align__(16) float sc[kTile][NS];

  const int b = blockIdx.y;
  const int lane = threadIdx.x % LANES;
  const int d = blockIdx.x * (kThreads / LANES) + threadIdx.x / LANES;
  const bool active = d < di;
  const int n0 = lane * NPL;

  float a[NPL], h[NPL];
#pragma unroll
  for (int j = 0; j < NPL; ++j) {
    a[j] = (active && n0 + j < N) ? A[(long long)d * N + n0 + j] : 0.f;
    h[j] = 0.f;
  }

  const long long row0 = (long long)b * S;   // timestep 0 of batch row b
  const float* bb = Bc + row0 * N;
  const float* cb = Cc + row0 * N;
  // this channel's entries of dt, xc and y at the next timestep to load
  // or store; each step is di entries further on
  const float* pdt = dt + row0 * di + d;
  const float* pxc = xc + row0 * di + d;
  float* py = y + row0 * di + d;
  const bool store = active && lane == 0;

  for (int s0 = 0; s0 < S; s0 += kTile) {
    const int ts = min(kTile, S - s0);
    __syncthreads();                           // the last tile is consumed
    for (int i = threadIdx.x; i < ts * NS; i += kThreads) {
      const int t = i / NS, n = i - t * NS;
      const long long src = (long long)(s0 + t) * N + n;
      sb[t][n] = n < N ? bb[src] : 0.f;
      sc[t][n] = n < N ? cb[src] : 0.f;
    }
    __syncthreads();
    for (int t0 = 0; t0 < ts; t0 += kUnroll) {
      float dv[kUnroll], xv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const bool ok = active && t0 + u < ts;
        dv[u] = ok ? *pdt : 0.f;
        xv[u] = ok ? *pxc : 0.f;
        pdt += di;
        pxc += di;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int t = t0 + u;
        if (t < ts) {                          // uniform across the block
          const float dtx = dv[u] * xv[u];
          const float4* b4 = reinterpret_cast<const float4*>(&sb[t][n0]);
          const float4* c4 = reinterpret_cast<const float4*>(&sc[t][n0]);
          float acc = 0.f;
#pragma unroll
          for (int q = 0; q < NPL / 4; ++q) {
            const float4 bq = b4[q], cq = c4[q];
            const float bv[4] = {bq.x, bq.y, bq.z, bq.w};
            const float cv[4] = {cq.x, cq.y, cq.z, cq.w};
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const int j = 4 * q + k;
              h[j] = expf(dv[u] * a[j]) * h[j] + dtx * bv[k];
              acc += h[j] * cv[k];
            }
          }
#pragma unroll
          for (int o = LANES / 2; o > 0; o /= 2)
            acc += __shfl_xor_sync(0xffffffffu, acc, o);
          if (store) *py = acc;
          py += di;
        }
      }
    }
  }
}

template <int LANES, int NPL>
int launch(const float* dt, const float* xc, const float* Bc,
           const float* Cc, const float* A, float* y, int B, int S, int di,
           int N, cudaStream_t stream) {
  constexpr int per_block = kThreads / LANES;
  const dim3 grid((di + per_block - 1) / per_block, B);
  mamba_scan_rows<LANES, NPL><<<grid, kThreads, 0, stream>>>(
      dt, xc, Bc, Cc, A, y, S, di, N);
  return (int)cudaGetLastError();
}

}  // namespace

// y (B, S, di) from dt, xc (B, S, di), Bc, Cc (B, S, N) and A (di, N), all
// float32 and contiguous.  1 <= N <= 64; B, S or di of 0 launch nothing.
// Returns the CUDA error of the launch (0 on success).
extern "C" int mamba_scan_launch(const void* dt, const void* xc,
                                 const void* Bc, const void* Cc,
                                 const void* A, void* y, int B, int S, int di,
                                 int N, void* stream) {
  if (B < 0 || S < 0 || di < 0 || N < 1 || N > kMaxN || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0 || di == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* p_dt = static_cast<const float*>(dt);
  const float* p_xc = static_cast<const float*>(xc);
  const float* p_b = static_cast<const float*>(Bc);
  const float* p_c = static_cast<const float*>(Cc);
  const float* p_a = static_cast<const float*>(A);
  float* p_y = static_cast<float*>(y);
  // (lanes per channel, states per lane)
  if (N <= 4) return launch<1, 4>(p_dt, p_xc, p_b, p_c, p_a, p_y, B, S, di, N, s);
  if (N <= 8) return launch<1, 8>(p_dt, p_xc, p_b, p_c, p_a, p_y, B, S, di, N, s);
  if (N <= 16) return launch<2, 8>(p_dt, p_xc, p_b, p_c, p_a, p_y, B, S, di, N, s);
  if (N <= 32) return launch<4, 8>(p_dt, p_xc, p_b, p_c, p_a, p_y, B, S, di, N, s);
  return launch<4, 16>(p_dt, p_xc, p_b, p_c, p_a, p_y, B, S, di, N, s);
}

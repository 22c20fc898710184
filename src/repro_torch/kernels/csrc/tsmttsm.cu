// Tall-skinny^T x tall-skinny GEMM for Hopper (sm_90a), paper C2 (Fig. 7).
//
// Replaces: repro/kernels/tsmttsm.py:tsmttsm_pallas (the Pallas TPU kernel,
// body `_kernel`).  Computes
//
//   X = alpha * V^T W + beta * X_in        V (n, m), W (n, k) row-major, m, k << n
//
// with an optional Kahan compensation (paper section 5.2), for real
// float64, float32, bfloat16 and float16 inputs.  The sums run in the
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
//   partials over the blocks in block order.  No atomics, so the result
//   depends only on the shapes: a chunked solve equals a monolithic one.
// * Register blocking: a thread owns a TM x TN tile of the result, loads
//   TM values of a V row and TN of the W row and does TM * TN products,
//   so each loaded value feeds TN (or TM) products.  The G = ceil(m/TM) *
//   ceil(k/TN) tiles of one row are spread over G neighbouring threads;
//   the block's L = 256 / G "row lanes" walk the block's rows with stride
//   L, so the lanes of a warp read neighbouring rows.
// * Kahan (kahan=True): each lane sums groups of KG = 8 of its rows plainly
//   and adds each group's sum with compensation, as the TPU kernel does
//   with its 8-row micro-slabs; the lanes, and then the blocks, are
//   combined with compensation too.  Without Kahan the same groups are
//   added plainly.
// * The row count n and the tile edges need no padding: rows past n and
//   result indices past m or k load zeros and store nothing.
// * The partition (rows_per_block, number of blocks) is chosen by the
//   wrapper from n, m and k alone, not from the card, so the summation
//   order is the same on every card.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTM = 4;
constexpr int kTN = 4;
constexpr int kKG = 8;  // rows per plainly summed group

template <typename T> struct Acc { using type = T; };
template <> struct Acc<__nv_bfloat16> { using type = float; };
template <> struct Acc<__half> { using type = float; };

template <typename A> __device__ __forceinline__ A load_as(double v) { return (A)v; }
template <typename A> __device__ __forceinline__ A load_as(float v) { return (A)v; }
template <typename A> __device__ __forceinline__ A load_as(__nv_bfloat16 v) {
  return (A)__bfloat162float(v);
}
template <typename A> __device__ __forceinline__ A load_as(__half v) {
  return (A)__half2float(v);
}

template <typename T> __device__ __forceinline__ T store_as(double v) { return (T)v; }
template <typename T> __device__ __forceinline__ T store_as(float v) { return (T)v; }
template <> __device__ __forceinline__ __nv_bfloat16 store_as(float v) {
  return __float2bfloat16(v);
}
template <> __device__ __forceinline__ __half store_as(float v) {
  return __float2half(v);
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

// Pass 1: part[blk] = sum over the block's rows of V[r]^T W[r] (plus its
// compensation comp[blk] when KAHAN).
template <typename T, bool KAHAN>
__global__ void __launch_bounds__(kThreads)
tsmttsm_partial(const T* __restrict__ V, const T* __restrict__ W,
                typename Acc<T>::type* __restrict__ part,
                typename Acc<T>::type* __restrict__ comp, long long n, int m,
                int k, long long rows_per_block) {
  using A = typename Acc<T>::type;
  // [L][m*k] lane results; L * m * k <= kThreads * kTM * kTN
  __shared__ A sh_s[kThreads * kTM * kTN];
  const int mk = m * k;

  const int kt = (k + kTN - 1) / kTN;
  const int G = ((m + kTM - 1) / kTM) * kt;
  const int L = kThreads / G;
  const int t = threadIdx.x;
  const int lane = t / G;
  const int g = t % G;
  const int i0 = (g / kt) * kTM;
  const int j0 = (g % kt) * kTN;
  const bool worker = lane < L;

  A s[kTM][kTN], c[kTM][kTN];
#pragma unroll
  for (int a = 0; a < kTM; ++a)
#pragma unroll
    for (int b = 0; b < kTN; ++b) s[a][b] = c[a][b] = A(0);

  const long long r_begin = (long long)blockIdx.x * rows_per_block;
  long long r_end = r_begin + rows_per_block;
  if (r_end > n) r_end = n;

  if (worker) {
    for (long long r0 = r_begin + lane; r0 < r_end; r0 += (long long)L * kKG) {
      A p[kTM][kTN];
#pragma unroll
      for (int a = 0; a < kTM; ++a)
#pragma unroll
        for (int b = 0; b < kTN; ++b) p[a][b] = A(0);
#pragma unroll 2
      for (int q = 0; q < kKG; ++q) {
        const long long r = r0 + (long long)q * L;
        if (r >= r_end) break;
        A va[kTM], wb[kTN];
#pragma unroll
        for (int a = 0; a < kTM; ++a)
          va[a] = (i0 + a < m) ? load_as<A>(V[r * m + i0 + a]) : A(0);
#pragma unroll
        for (int b = 0; b < kTN; ++b)
          wb[b] = (j0 + b < k) ? load_as<A>(W[r * k + j0 + b]) : A(0);
#pragma unroll
        for (int a = 0; a < kTM; ++a)
#pragma unroll
          for (int b = 0; b < kTN; ++b) p[a][b] += va[a] * wb[b];
      }
#pragma unroll
      for (int a = 0; a < kTM; ++a)
#pragma unroll
        for (int b = 0; b < kTN; ++b) {
          if (KAHAN)
            kahan_add(s[a][b], c[a][b], p[a][b]);
          else
            s[a][b] += p[a][b];
        }
    }
  }

  // combine the lanes in lane order: first the sums, then (Kahan) the
  // compensations, through shared memory
  const int nrounds = KAHAN ? 2 : 1;
  for (int round = 0; round < nrounds; ++round) {
    if (worker) {
#pragma unroll
      for (int a = 0; a < kTM; ++a)
#pragma unroll
        for (int b = 0; b < kTN; ++b)
          if (i0 + a < m && j0 + b < k)
            sh_s[lane * mk + (i0 + a) * k + j0 + b] =
                round == 0 ? s[a][b] : c[a][b];
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

// Pass 2: one thread per result entry sums the block partials in block
// order and applies alpha, beta and the output type.
template <typename T, bool KAHAN>
__global__ void __launch_bounds__(kThreads)
tsmttsm_finish(const typename Acc<T>::type* __restrict__ part,
               const typename Acc<T>::type* __restrict__ comp, int nblocks,
               int mk, const typename Acc<T>::type* __restrict__ x_in,
               T* __restrict__ x_out, double alpha, double beta, int has_x) {
  using A = typename Acc<T>::type;
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= mk) return;
  A S = A(0), C = A(0);
  for (int b = 0; b < nblocks; ++b) {
    if (KAHAN) {
      kahan_add(S, C, part[(long long)b * mk + o]);
      kahan_add(S, C, -comp[(long long)b * mk + o]);
    } else {
      S += part[(long long)b * mk + o];
    }
  }
  A res = (A)alpha * S;
  if (has_x) res += (A)beta * x_in[o];
  x_out[o] = store_as<T>(res);
}

template <typename T, bool KAHAN>
int launch(const void* V, const void* W, void* part, void* comp, long long n,
           int m, int k, long long rows_per_block, int nblocks,
           const void* x_in, void* x_out, double alpha, double beta,
           int has_x, cudaStream_t stream) {
  using A = typename Acc<T>::type;
  const int mk = m * k;
  if (nblocks > 0) {
    tsmttsm_partial<T, KAHAN><<<nblocks, kThreads, 0, stream>>>(
        static_cast<const T*>(V), static_cast<const T*>(W),
        static_cast<A*>(part), static_cast<A*>(comp), n, m, k,
        rows_per_block);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  tsmttsm_finish<T, KAHAN><<<(mk + kThreads - 1) / kThreads, kThreads, 0,
                             stream>>>(
      static_cast<const A*>(part), static_cast<const A*>(comp), nblocks, mk,
      static_cast<const A*>(x_in), static_cast<T*>(x_out), alpha, beta,
      has_x);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_k(int kahan, const void* V, const void* W, void* part, void* comp,
             long long n, int m, int k, long long rows_per_block, int nblocks,
             const void* x_in, void* x_out, double alpha, double beta,
             int has_x, cudaStream_t s) {
  if (kahan)
    return launch<T, true>(V, W, part, comp, n, m, k, rows_per_block,
                           nblocks, x_in, x_out, alpha, beta, has_x, s);
  return launch<T, false>(V, W, part, comp, n, m, k, rows_per_block, nblocks,
                          x_in, x_out, alpha, beta, has_x, s);
}

}  // namespace

// dtype: 0 float64, 1 float32, 2 bfloat16, 3 float16.  part and comp hold
// nblocks * m * k values of the accumulation type (comp only for kahan);
// x_in holds m * k values of the accumulation type (read when has_x).
// Returns the first CUDA error of the launches (0 on success).
extern "C" int tsmttsm_launch(int dtype, int kahan, const void* V,
                              const void* W, void* part, void* comp,
                              long long n, int m, int k,
                              long long rows_per_block, int nblocks,
                              const void* x_in, void* x_out, double alpha,
                              double beta, int has_x, void* stream) {
  if (m < 1 || k < 1 || n < 0 || nblocks < 0 ||
      ((m + kTM - 1) / kTM) * ((k + kTN - 1) / kTN) > kThreads ||
      (nblocks > 0 && rows_per_block < 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_k<double>(kahan, V, W, part, comp, n, m, k,
                                    rows_per_block, nblocks, x_in, x_out,
                                    alpha, beta, has_x, s);
    case 1: return launch_k<float>(kahan, V, W, part, comp, n, m, k,
                                   rows_per_block, nblocks, x_in, x_out,
                                   alpha, beta, has_x, s);
    case 2: return launch_k<__nv_bfloat16>(kahan, V, W, part, comp, n, m, k,
                                           rows_per_block, nblocks, x_in,
                                           x_out, alpha, beta, has_x, s);
    case 3: return launch_k<__half>(kahan, V, W, part, comp, n, m, k,
                                    rows_per_block, nblocks, x_in, x_out,
                                    alpha, beta, has_x, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

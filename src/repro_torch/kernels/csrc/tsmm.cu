// Tall-skinny x small GEMM for Hopper (sm_90a), paper C2 (Fig. 7).
//
// Replaces: repro/kernels/tsmm.py:tsmm_pallas (the Pallas TPU kernel, body
// `_kernel`).  Computes
//
//   W_out = alpha * V X + beta * W_in        V (n, m) row-major, X (m, k), W (n, k)
//
// for real float64, float32, bfloat16 and float16 V, W and W_out, with the
// products summed in the accumulation type (float32 for the half types,
// else the input type).  The wrapper hands X over in the accumulation type.
//
// Bound: memory bandwidth.  Each row of V is read once, each row of W_in
// (when given) read once and each row of W_out written once:
// n * (m + k [+ k]) * sizeof(T) bytes for 2 n m k flops, about one flop per
// byte in float64 at m = k = 16.
//
// Design:
// * X (at most 64 x 64 values) is loaded once per block into shared memory
//   and stays there; as on the TPU it never streams.
// * A thread owns TN = 4 neighbouring outputs of one row: it reads the m
//   values of its V row (the ceil(k/TN) threads of one row read the same
//   V row, which the L1 cache serves once), reads TN-wide rows of X from
//   shared memory (a broadcast within the warp), and writes its TN outputs;
//   neighbouring threads write neighbouring addresses, so the stores of a
//   warp are coalesced.
// * The grid covers n * ceil(k/TN) threads; the tail is masked, so no
//   padding is needed for any n or k.
// * W_out is a new buffer, so W_in may alias V (tsmm_inplace).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTN = 4;
constexpr int kMaxDim = 64;

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
tsmm_rows(const T* __restrict__ V, const typename Acc<T>::type* __restrict__ X,
          const T* __restrict__ W_in, T* __restrict__ W_out, long long n,
          int m, int k, double alpha, double beta, int has_w) {
  using A = typename Acc<T>::type;
  __shared__ A sx[kMaxDim * kMaxDim];
  for (int o = threadIdx.x; o < m * k; o += blockDim.x) sx[o] = X[o];
  __syncthreads();

  const int kt = (k + kTN - 1) / kTN;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long r = idx / kt;
  if (r >= n) return;
  const int j0 = (int)(idx % kt) * kTN;

  A acc[kTN];
#pragma unroll
  for (int b = 0; b < kTN; ++b) acc[b] = A(0);
  const T* vr = V + r * m;
  for (int i = 0; i < m; ++i) {
    const A v = load_as<A>(vr[i]);
    const A* xr = sx + i * k + j0;
#pragma unroll
    for (int b = 0; b < kTN; ++b)
      if (j0 + b < k) acc[b] += v * xr[b];
  }
  const A a = (A)alpha;
  const A be = (A)beta;
#pragma unroll
  for (int b = 0; b < kTN; ++b) {
    if (j0 + b < k) {
      const long long o = r * k + j0 + b;
      A res = a * acc[b];
      if (has_w) res += be * load_as<A>(W_in[o]);
      W_out[o] = store_as<T>(res);
    }
  }
}

template <typename T>
int launch(const void* V, const void* X, const void* W_in, void* W_out,
           long long n, int m, int k, double alpha, double beta, int has_w,
           cudaStream_t stream) {
  using A = typename Acc<T>::type;
  const long long threads = n * ((k + kTN - 1) / kTN);
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  tsmm_rows<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(V), static_cast<const A*>(X),
      static_cast<const T*>(W_in), static_cast<T*>(W_out), n, m, k, alpha,
      beta, has_w);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float64, 1 float32, 2 bfloat16, 3 float16 (of V, W_in, W_out);
// X holds m * k values of the accumulation type.  Requires n >= 1 and
// 1 <= m, k <= 64.  Returns cudaGetLastError() after the launch.
extern "C" int tsmm_launch(int dtype, const void* V, const void* X,
                           const void* W_in, void* W_out, long long n, int m,
                           int k, double alpha, double beta, int has_w,
                           void* stream) {
  if (n < 1 || m < 1 || k < 1 || m > kMaxDim || k > kMaxDim)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<double>(V, X, W_in, W_out, n, m, k, alpha, beta, has_w, s);
    case 1: return launch<float>(V, X, W_in, W_out, n, m, k, alpha, beta, has_w, s);
    case 2: return launch<__nv_bfloat16>(V, X, W_in, W_out, n, m, k, alpha, beta, has_w, s);
    case 3: return launch<__half>(V, X, W_in, W_out, n, m, k, alpha, beta, has_w, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

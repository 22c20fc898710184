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
//   b x b).  Other (m, k) take the same kernel instantiated with M = K = 0,
//   which reads m and k at run time and loads value by value.
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

#include <cuda_runtime.h>
#include <stdint.h>

#include "dtypes.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kStages = 4;
constexpr int kMaxDim = 64;
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
  return launch_mk<T, 0, 0>(V, X, W_in, W_out, n, m, k, a, b, alpha_p,
                            beta_p, has_w, stream);
}

}  // namespace

// dtype: 0 float64, 1 float32, 2 bfloat16, 3 float16, 4 complex128,
// 5 complex64 (of V, W_in, W_out); X holds m * k values of the
// accumulation type.  alpha and beta come as real and imaginary parts (the
// imaginary parts are ignored for a real dtype), or, where alpha_p /
// beta_p is not null, as one value of the accumulation type on the card.
// Requires n >= 1 and
// 1 <= m, k <= 64; W_out 16-byte aligned.  Returns the first CUDA error of
// the launch (0 on success).
extern "C" int tsmm_launch(int dtype, const void* V, const void* X,
                           const void* W_in, void* W_out, long long n, int m,
                           int k, double alpha, double beta, double alpha_im,
                           double beta_im, const void* alpha_p,
                           const void* beta_p, int has_w, void* stream) {
  if (n < 1 || m < 1 || k < 1 || m > kMaxDim || k > kMaxDim ||
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

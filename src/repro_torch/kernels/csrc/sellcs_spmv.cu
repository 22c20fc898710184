// Fused SELL-C-sigma SpM(M)V for Hopper (sm_90a), paper C1 + C3.
//
// Replaces: repro/kernels/sellcs_spmv.py:sellcs_spmv_pallas (the Pallas TPU
// kernel, body `_kernel`).  Computes, for every fusion flag,
//
//   y    = alpha * (A - gamma I) x + beta * y_in     (gamma scalar or per column)
//   z    = delta * z_in + eta * y                     (chained axpby)
//   part = per-chunk <y,y>, <x,y>, <x,x>              ((nchunks, 3, b), float64)
//
// The wrapper (kernels/sellcs_spmv.py) sums `part` over chunks in float64.
//
// Bound: memory bandwidth.  Each call must stream the stored values and
// column indices once (vals + cols), gather x and write y; at two flops per
// stored slot and column the kernel sits far below the card's ridge point.
//
// Design:
// * One thread block owns one C-row chunk; thread `lane` owns row
//   chunk*C + lane and walks the chunk's whole padded width.  The
//   chunk-column-major layout puts vals[(off+j)*C + lane] of neighbouring
//   lanes next to each other, so the value and index streams are coalesced.
//   There is no TPU-style (w_tile, C) slab, so any chunk width works.
// * x is gathered row-major (x[col*b + k]); the b columns of one row sit
//   together, so a block vector amortises each index load over b products.
// * The block width is a template parameter BW <= 16 with the accumulators
//   in registers; wider blocks use more blocks along grid.y.
// * Narrow stored values (bf16, f16, or f32 under f64 compute) are upcast in
//   registers, so the value stream moves at the storage width.
// * The dots are reduced in a fixed order (warp shuffles, then warps in
//   order through shared memory) without atomics, so results are
//   bit-for-bit reproducible from run to run.
// * Lanes are rounded up to whole warps; lanes >= C only feed zeros to the
//   reductions.

#include <cuda_runtime.h>

#include "dtypes.cuh"

namespace {

constexpr int kMaxThreads = 256;            // largest C the wrapper accepts
constexpr int kMaxWarps = kMaxThreads / 32;

enum Flags {
  kHasYin = 1,
  kHasGamma = 2,
  kChain = 4,
  kDotYY = 8,
  kDotXY = 16,
  kDotXX = 32,
};

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

template <typename VT, typename CT, int BW>
__global__ void __launch_bounds__(kMaxThreads)
sellcs_spmv_fused(const VT* __restrict__ vals, const int* __restrict__ cols,
                  const int* __restrict__ chunk_off,
                  const int* __restrict__ chunk_len, const CT* __restrict__ x,
                  const CT* __restrict__ y_in, const CT* __restrict__ z_in,
                  const CT* __restrict__ gamma, CT* __restrict__ y,
                  CT* __restrict__ z, double* __restrict__ part, int C, int b,
                  int gamma_width, CT alpha, CT beta, CT delta, CT eta,
                  int flags) {
  __shared__ double warp_part[kMaxWarps][3 * BW];

  const int c = blockIdx.x;
  const int lane = threadIdx.x;
  const int k0 = blockIdx.y * BW;
  const bool active = lane < C;
  const long long row = (long long)c * C + lane;

  CT acc[BW];
#pragma unroll
  for (int k = 0; k < BW; ++k) acc[k] = CT(0);

  if (active) {
    const long long base = (long long)chunk_off[c] * C + lane;
    const int len = chunk_len[c];
    for (int j = 0; j < len; ++j) {
      const long long s = base + (long long)j * C;
      const CT a = load_as<CT>(vals[s]);
      const CT* xr = x + (long long)cols[s] * b + k0;
#pragma unroll
      for (int k = 0; k < BW; ++k)
        if (k0 + k < b) acc[k] += a * xr[k];
    }
  }

  const bool any_dot = flags & (kDotYY | kDotXY | kDotXX);
  const bool need_xrow = flags & (kHasGamma | kDotXY | kDotXX);
  const int warp = threadIdx.x >> 5;
  const int wl = threadIdx.x & 31;

#pragma unroll
  for (int k = 0; k < BW; ++k) {
    if (k0 + k >= b) break;  // uniform across the block
    double p_yy = 0.0, p_xy = 0.0, p_xx = 0.0;
    if (active) {
      const long long o = row * b + k0 + k;
      const CT xv = need_xrow ? x[o] : CT(0);
      CT a = acc[k];
      if (flags & kHasGamma) a -= gamma[gamma_width == 1 ? 0 : k0 + k] * xv;
      CT yv = alpha * a;
      if (flags & kHasYin) yv += beta * y_in[o];
      y[o] = yv;
      if (flags & kChain) z[o] = delta * z_in[o] + eta * yv;
      if (flags & kDotYY) p_yy = (double)yv * (double)yv;
      if (flags & kDotXY) p_xy = (double)xv * (double)yv;
      if (flags & kDotXX) p_xx = (double)xv * (double)xv;
    }
    if (any_dot) {
      p_yy = warp_sum(p_yy);
      p_xy = warp_sum(p_xy);
      p_xx = warp_sum(p_xx);
      if (wl == 0) {
        warp_part[warp][k] = p_yy;
        warp_part[warp][BW + k] = p_xy;
        warp_part[warp][2 * BW + k] = p_xx;
      }
    }
  }

  if (any_dot) {
    __syncthreads();
    const int nwarps = blockDim.x >> 5;
    for (int t = threadIdx.x; t < 3 * BW; t += blockDim.x) {
      const int d = t / BW;
      const int k = t % BW;
      if (k0 + k < b) {
        double s = 0.0;
        for (int w = 0; w < nwarps; ++w) s += warp_part[w][t];
        part[((long long)c * 3 + d) * b + k0 + k] = s;
      }
    }
  }
}

struct Args {
  const void* vals;
  const int* cols;
  const int* chunk_off;
  const int* chunk_len;
  const void* x;
  const void* y_in;
  const void* z_in;
  const void* gamma;
  void* y;
  void* z;
  double* part;
  int nchunks, C, b, gamma_width, flags;
  double alpha, beta, delta, eta;
};

template <typename VT, typename CT, int BW>
void launch_bw(const Args& a, cudaStream_t stream) {
  const dim3 grid(a.nchunks, (a.b + BW - 1) / BW);
  const dim3 block(((a.C + 31) / 32) * 32);
  sellcs_spmv_fused<VT, CT, BW><<<grid, block, 0, stream>>>(
      static_cast<const VT*>(a.vals), a.cols, a.chunk_off, a.chunk_len,
      static_cast<const CT*>(a.x), static_cast<const CT*>(a.y_in),
      static_cast<const CT*>(a.z_in), static_cast<const CT*>(a.gamma),
      static_cast<CT*>(a.y), static_cast<CT*>(a.z), a.part, a.C, a.b,
      a.gamma_width, (CT)a.alpha, (CT)a.beta, (CT)a.delta, (CT)a.eta,
      a.flags);
}

template <typename VT, typename CT>
void launch_ct(const Args& a, cudaStream_t stream) {
  if (a.b <= 1)
    launch_bw<VT, CT, 1>(a, stream);
  else if (a.b <= 2)
    launch_bw<VT, CT, 2>(a, stream);
  else if (a.b <= 4)
    launch_bw<VT, CT, 4>(a, stream);
  else if (a.b <= 8)
    launch_bw<VT, CT, 8>(a, stream);
  else
    launch_bw<VT, CT, 16>(a, stream);
}

}  // namespace

// store: 0 float64, 1 float32, 2 bfloat16, 3 float16; compute: 0 float64,
// 1 float32.  Returns cudaGetLastError() after the launch (0 on success).
extern "C" int sellcs_spmv_launch(
    int store, int compute, const void* vals, const void* cols,
    const void* chunk_off, const void* chunk_len, const void* x,
    const void* y_in, const void* z_in, const void* gamma, void* y, void* z,
    void* part, int nchunks, int C, int b, int gamma_width, double alpha,
    double beta, double delta, double eta, int flags, void* stream) {
  if (C < 1 || C > kMaxThreads || nchunks < 1 || b < 1)
    return (int)cudaErrorInvalidValue;
  const Args a{vals, static_cast<const int*>(cols),
               static_cast<const int*>(chunk_off),
               static_cast<const int*>(chunk_len), x, y_in, z_in, gamma, y, z,
               static_cast<double*>(part), nchunks, C, b, gamma_width, flags,
               alpha, beta, delta, eta};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (compute == 0) {
    switch (store) {
      case 0: launch_ct<double, double>(a, s); break;
      case 1: launch_ct<float, double>(a, s); break;
      case 2: launch_ct<__nv_bfloat16, double>(a, s); break;
      case 3: launch_ct<__half, double>(a, s); break;
      default: return (int)cudaErrorInvalidValue;
    }
  } else if (compute == 1) {
    switch (store) {
      case 1: launch_ct<float, float>(a, s); break;
      case 2: launch_ct<__nv_bfloat16, float>(a, s); break;
      case 3: launch_ct<__half, float>(a, s); break;
      default: return (int)cudaErrorInvalidValue;
    }
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

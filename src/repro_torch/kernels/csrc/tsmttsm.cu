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
//   partials over the blocks in block order.  No atomics, so the result
//   depends only on the shapes: a chunked solve equals a monolithic one.
// * The bytes in flight live in shared memory, not in registers.  A tile
//   of R consecutive rows of V is one contiguous run of R * m values, and
//   likewise for W, so thread 0 streams both into a ring of kStages stages
//   with 1-D bulk copies (cp.async.bulk, completion on an mbarrier per
//   stage) while the block computes on the stage before.  Where a tile's
//   base address or size is not a multiple of 16 bytes (a view with an
//   odd offset, odd m or k in a narrow type, the ragged last tile), the
//   threads fill that stage with plain loads instead.  The wrapper picks R
//   (kernels/tsmttsm.py:stage_rows) so that a stage holds at most 32 KB:
//   two stages, 64 KB, are in flight while a block computes on a third,
//   and two blocks share an SM where the registers allow (the Kahan
//   float64 instance needs 146 a thread, so there one block fills an SM's
//   register file; deeper rings measured no faster on the H100).
// * Register blocking: a thread owns a TM x TN tile of the result and
//   reads TM values of a V row and TN of the W row from shared memory (as
//   broadcasts, vectorised when m and k are multiples of 4), so each
//   loaded value feeds TN (or TM) products.  The G = ceil(m/TM) *
//   ceil(k/TN) tiles of one row are spread over G neighbouring threads;
//   the block's L = 256 / G "row lanes" take the rows of a stage with
//   stride L.
// * Kahan (kahan=True): each lane sums groups of KG = 8 of its rows plainly
//   and adds each group's sum with compensation, as the TPU kernel does
//   with its 8-row micro-slabs; the lanes, and then the blocks, are
//   combined with compensation too.  Without Kahan the same groups are
//   added plainly.  A group may straddle two stages: its partial sum stays
//   in registers.  The order of every addition is that of the row
//   partition alone (kernels/tsmttsm.py:summation_depth), not of R.
// * The row count n and the tile edges need no padding: rows past n and
//   result indices past m or k load zeros and store nothing.
// * The partition (rows_per_block, number of blocks) is chosen by the
//   wrapper from n, m and k alone, not from the card, so the summation
//   order is the same on every card.
// * Complex values (Complex<R> of dtypes.cuh) take the same path: the
//   stages hold them as stored, a thread conjugates its TM values of V
//   as it reads them (conj), each product is four fused multiply-adds,
//   and Kahan compensates the real and the imaginary parts separately
//   (its additions are those of each part).  A complex128 thread's three
//   4 x 4 tiles (sum, compensation, group) take 192 registers, so its
//   Kahan instances spill a little (the build log says how much).

#include <cuda_runtime.h>
#include <stdint.h>

#include "dtypes.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTM = 4;
constexpr int kTN = 4;
constexpr int kKG = 8;      // rows per plainly summed group
constexpr int kStages = 3;  // shared-memory ring

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
template <typename A, typename R>
__device__ __forceinline__ void load4(const Complex<R>* p, A* out) {
  out[0] = p[0]; out[1] = p[1]; out[2] = p[2]; out[3] = p[3];
}

// Pass 1: part[blk] = sum over the block's rows of V[r]^T W[r] (V[r]^H
// with conj; plus its compensation comp[blk] when KAHAN).  VEC: m and k
// are multiples of 4.
// `bulk` says the operands' base addresses and the block and stage sizes
// allow 16-byte bulk copies; each tile checks its own size too.
template <typename T, bool KAHAN, bool VEC>
__global__ void __launch_bounds__(kThreads)
tsmttsm_partial(const T* __restrict__ V, const T* __restrict__ W,
                typename Acc<T>::type* __restrict__ part,
                typename Acc<T>::type* __restrict__ comp, long long n, int m,
                int k, long long rows_per_block, int tile_rows,
                int w_offset, int stage_stride, int bulk, int conj) {
  using A = typename Acc<T>::type;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bars[kStages];
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

  A s[kTM][kTN], c[kTM][kTN], p[kTM][kTN];
#pragma unroll
  for (int a = 0; a < kTM; ++a)
#pragma unroll
    for (int b = 0; b < kTN; ++b) s[a][b] = c[a][b] = p[a][b] = A(0);

  auto fold = [&]() {
#pragma unroll
    for (int a = 0; a < kTM; ++a)
#pragma unroll
      for (int b = 0; b < kTN; ++b) {
        if (KAHAN)
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
            A va[kTM], wb[kTN];
            if (VEC) {
              load4<A>(sv + lr * m + i0, va);
              load4<A>(sw + lr * k + j0, wb);
            } else {
#pragma unroll
              for (int a = 0; a < kTM; ++a)
                va[a] = (i0 + a < m) ? load_as<A>(sv[lr * m + i0 + a]) : A(0);
#pragma unroll
              for (int b = 0; b < kTN; ++b)
                wb[b] = (j0 + b < k) ? load_as<A>(sw[lr * k + j0 + b]) : A(0);
            }
            if (IsComplex<A>::value && conj) {
#pragma unroll
              for (int a = 0; a < kTM; ++a) va[a] = conj_of(va[a]);
            }
#pragma unroll
            for (int a = 0; a < kTM; ++a)
#pragma unroll
              for (int b = 0; b < kTN; ++b)
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

  // combine the lanes in lane order: first the sums, then (Kahan) the
  // compensations, through the (now idle) ring
  A* sh_s = reinterpret_cast<A*>(smem);
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
// order and applies alpha, beta and the output type.  The partials are
// read kChunk at a time ahead of the (sequential) sums.
template <typename T, bool KAHAN, typename A = typename Acc<T>::type>
__global__ void __launch_bounds__(kThreads)
tsmttsm_finish(const typename Acc<T>::type* __restrict__ part,
               const typename Acc<T>::type* __restrict__ comp, int nblocks,
               int mk, const typename Acc<T>::type* __restrict__ x_in,
               T* __restrict__ x_out, A alpha, A beta, int has_x) {
  constexpr int kChunk = 16;
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= mk) return;
  A S = A(0), C = A(0);
  for (int b0 = 0; b0 < nblocks; b0 += kChunk) {
    A pv[kChunk], cv[kChunk];
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      const bool in = b0 + u < nblocks;
      pv[u] = in ? part[(long long)(b0 + u) * mk + o] : A(0);
      cv[u] = (KAHAN && in) ? comp[(long long)(b0 + u) * mk + o] : A(0);
    }
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      if (b0 + u >= nblocks) break;
      if (KAHAN) {
        kahan_add(S, C, pv[u]);
        kahan_add(S, C, -cv[u]);
      } else {
        S += pv[u];
      }
    }
  }
  A res = alpha * S;
  if (has_x) res += beta * x_in[o];
  x_out[o] = store_as<T>(res);
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
  int has_x, conj;
};

inline int round16(long long bytes) { return (int)((bytes + 15) / 16 * 16); }

template <typename T, bool KAHAN, bool VEC>
int launch(const Args& a, cudaStream_t stream) {
  using A = typename Acc<T>::type;
  const int mk = a.m * a.k;
  if (a.nblocks > 0) {
    const int G = ((a.m + kTM - 1) / kTM) * ((a.k + kTN - 1) / kTN);
    const int L = kThreads / G;
    const int w_offset = round16((long long)a.tile_rows * a.m * sizeof(T));
    const int stride =
        w_offset + round16((long long)a.tile_rows * a.k * sizeof(T));
    int smem = kStages * stride;
    const int combine = L * mk * (int)sizeof(A);
    if (combine > smem) smem = combine;
    auto kern = tsmttsm_partial<T, KAHAN, VEC>;
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    kern<<<a.nblocks, kThreads, smem, stream>>>(
        static_cast<const T*>(a.V), static_cast<const T*>(a.W),
        static_cast<A*>(a.part), static_cast<A*>(a.comp), a.n, a.m, a.k,
        a.rows_per_block, a.tile_rows, w_offset, stride, a.bulk, a.conj);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  tsmttsm_finish<T, KAHAN><<<(mk + kThreads - 1) / kThreads, kThreads, 0,
                             stream>>>(
      static_cast<const A*>(a.part), static_cast<const A*>(a.comp),
      a.nblocks, mk, static_cast<const A*>(a.x_in), static_cast<T*>(a.x_out),
      make_scalar<A>(a.alpha, a.alpha_im), make_scalar<A>(a.beta, a.beta_im),
      a.has_x);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_t(int kahan, const Args& a, cudaStream_t s) {
  const bool vec = a.m % 4 == 0 && a.k % 4 == 0;
  if (kahan)
    return vec ? launch<T, true, true>(a, s) : launch<T, true, false>(a, s);
  return vec ? launch<T, false, true>(a, s) : launch<T, false, false>(a, s);
}

}  // namespace

// dtype: 0 float64, 1 float32, 2 bfloat16, 3 float16, 4 complex128,
// 5 complex64; conj (complex only) gives V^H W.  alpha and beta come as
// real and imaginary parts (the imaginary parts are ignored for a real
// dtype).  part and comp hold
// nblocks * m * k values of the accumulation type (comp only for kahan);
// x_in holds m * k values of the accumulation type (read when has_x).
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
                              double alpha_im, double beta_im, int has_x,
                              void* stream) {
  const int G = ((m + kTM - 1) / kTM) * ((k + kTN - 1) / kTN);
  if (m < 1 || k < 1 || n < 0 || nblocks < 0 || G > kThreads ||
      (nblocks > 0 &&
       (rows_per_block < 1 || tile_rows < 1 || tile_rows % (kThreads / G))))
    return (int)cudaErrorInvalidValue;
  const Args a{V,  W,        part,  comp,  n,    m,     k,
               rows_per_block, nblocks, tile_rows, bulk, x_in, x_out,
               alpha, beta, alpha_im, beta_im, has_x, conj};
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

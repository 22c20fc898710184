// Hermitian eigensolver for small matrices on Hopper (sm_90a): one thread
// block a matrix, cyclic Jacobi in shared memory.
//
// Replaces no TPU kernel.  The block-Krylov solvers (solvers/block.py)
// take the eigendecomposition of a (b, b) Gram matrix every iteration.
// Inside the JAX package's jitted loop jnp.linalg.eigh is one more device
// operation; torch.linalg.eigh on the card checks its `info` on the host
// after every call, so each call stalls the host until the card has caught
// up.  This kernel computes the same decomposition and leaves everything,
// its convergence flag included, on the device.
//
// Computes, for each of `batch` Hermitian (m, m) matrices A (row-major, of
// which the lower triangle is read, as torch.linalg.eigh reads it, and the
// diagonal's real part), A = U diag(w) U^H with w ascending and U's
// columns orthonormal, for float64, float32, complex128 and complex64
// (w in the real type), any m >= 1.
//
// Bound: neither bytes nor a peak rate.  The call reads m^2 and writes
// m^2 + m values; a sweep does about 8 m^3 real operations (32 m^3 for
// complex), some 10 sweeps at m = 64.  At the sizes block Krylov uses
// (m = 16) that is a few microseconds of arithmetic at any rate; what the
// kernel costs is its chain of dependent rounds (m - 1 a sweep, each with
// three barriers), a latency and not a throughput.
//
// Design:
// * Up to m = 64 the matrix and U (2 m^2 values, 128 KB for complex128 at
//   m = 64) live in dynamic shared memory for the whole solve, with 256
//   threads: nothing goes back to device memory until the result.
// * Past m = 64 (the wide instance, 1024 threads; float64 and complex128
//   only: the wrapper solves float32 and complex64 matrices in those and
//   rounds the result, since over the sweeps at m = 128 a float32 U
//   drifted from orthonormal by more than 16 m eps) A and U do not both
//   fit in shared memory (256 KB at m = 128 in float64).  U lives in a
//   workspace in device memory that the wrapper allocates (m^2 values a
//   matrix: 128 KB at m = 128 in float64, resident in L2), and A stays in
//   shared memory where it fits beside the rotation arrays (float64 to m
//   = 165, complex128 to m = 116); a wider A lives in the workspace too.
//   The rounds read and write those entries through the same code; a
//   __syncthreads orders device-memory accesses within the block as it
//   orders shared ones.  Two other designs were slower at m = 128
//   (PERF.md, PR 29): U replayed from a log of the rotations once A had
//   converged, so that the rounds touched shared memory alone (10.75 ms
//   against 9.34 on a block-CG Gram: the rounds do not wait on U), and a
//   pair's threads taking its columns and a row's threads its pairs in
//   rows padded to m + 1 (10.89 / 26.68 ms against 10.55 / 22.13 in
//   float64 / complex128, tools/eig_trials.py).  The rotation arrays (m/2
//   pairs) and the ranks go into dynamic shared memory, and a round's
//   pairs are spread over the threads in a loop where m/2 exceeds them.
//   The ~10 sweeps of 127 rounds at m = 128 leave U's columns
//   orthonormal to about 18 m eps (||U^H U - I||_F, float64, two
//   eigenvalues of multiplicity m/2), past the 16 m eps the narrow design
//   keeps; one Newton-Schulz step, U <- U - U (U^H U - I) / 2, two m^3
//   products at the end, takes that to the rounding of the products.
// * A sweep is m' - 1 rounds (m' = m rounded up to even) of the
//   round-robin ("chess tournament") order: in each round the m'/2 pairs
//   (p, q) are disjoint, so their rotations commute and are applied
//   together.  Thread k of the first m'/2 computes pair k's rotation from
//   the current 2 x 2 block [[a, g], [conj(g), b]]: with e = g / |g| it is
//   J = [[c, s e], [-s conj(e), c]], where (c, s) is the real symmetric
//   Jacobi rotation of [[a, |g|], [|g|, b]] (Golub and Van Loan, sym.schur2:
//   tau = (b - a) / 2|g|, t = sign(tau) / (|tau| + hypot(1, tau))).  Then
//   all threads apply J^H to the pairs' rows (one thread an entry pair),
//   then J to their columns and to U's; the new diagonal entries a - t|g|
//   and b + t|g| and the zeroed (p, q) entries are written exactly.
// * A pair whose |g| is negligible, |g| <= eps (sqrt|a b| + eps ||A||_F)
//   with eps the real type's machine epsilon, is not rotated: its two
//   entries are set to 0 (moving no eigenvalue by more than that bound).
//   The solve has converged when a whole sweep rotates nothing, and stops
//   there or after kMaxSweeps sweeps.  (A test of off(A) <= eps ||A||_F
//   alone stalls: within a cluster of equal eigenvalues the rotations'
//   rounding keeps off(A) near eps ||A|| for many sweeps, in float32 at
//   m = 64 past any sweep limit.)  Every thread reads the same shared
//   flag, so the loop's branches are uniform.
// * The flag is written to device memory: the number of sweeps the solve
//   took (the last one rotating nothing), or 0 where it did not converge;
//   such a matrix keeps its last iterate, and nothing else runs instead.
// * The result is sorted by rank: thread i counts the eigenvalues below
//   w_i (ties by index), and writes w_i and U's column i to that place.

#include <cuda_runtime.h>
#include <float.h>

#include "dtypes.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWideThreads = 1024;  // the wide instance, m > kMaxDim
constexpr int kMaxDim = 64;
constexpr int kMaxPairs = kMaxDim / 2;
constexpr int kMaxSmem = 232448;  // a block's shared memory on the H100
constexpr int kMaxSweeps = 30;
// a block's shared memory, static and dynamic, without the opt-in
constexpr int kDefaultSmem = 48 * 1024;

template <typename T> struct Real { using type = T; };
template <typename R> struct Real<Complex<R>> { using type = R; };

__device__ __forceinline__ double re_of(double v) { return v; }
__device__ __forceinline__ float re_of(float v) { return v; }
template <typename R> __device__ __forceinline__ R re_of(Complex<R> v) {
  return v.re;
}

__device__ __forceinline__ double abs2(double v) { return v * v; }
__device__ __forceinline__ float abs2(float v) { return v * v; }
template <typename R> __device__ __forceinline__ R abs2(Complex<R> v) {
  return v.re * v.re + v.im * v.im;
}

__device__ __forceinline__ double abs_of(double v) { return fabs(v); }
__device__ __forceinline__ float abs_of(float v) { return fabsf(v); }
__device__ __forceinline__ double abs_of(Complex<double> v) {
  return hypot(v.re, v.im);
}
__device__ __forceinline__ float abs_of(Complex<float> v) {
  return hypotf(v.re, v.im);
}

// v / |v| for v != 0 (a sign for a real v, a phase for a complex one).
__device__ __forceinline__ double unit(double v, double) {
  return v < 0 ? -1.0 : 1.0;
}
__device__ __forceinline__ float unit(float v, float) {
  return v < 0 ? -1.0f : 1.0f;
}
template <typename R>
__device__ __forceinline__ Complex<R> unit(Complex<R> v, R a) {
  return Complex<R>(v.re / a, v.im / a);
}

__device__ __forceinline__ double scal(double c, double v) { return c * v; }
__device__ __forceinline__ float scal(float c, float v) { return c * v; }
template <typename R>
__device__ __forceinline__ Complex<R> scal(R c, Complex<R> v) {
  return Complex<R>(c * v.re, c * v.im);
}

// The block's sum of `v` (every thread's of NT), returned to every thread.
template <int NT, typename R>
__device__ __forceinline__ R block_sum(R v, R* red) {
  const int t = threadIdx.x;
  red[t] = v;
  __syncthreads();
#pragma unroll
  for (int w = NT / 2; w > 0; w /= 2) {
    if (t < w) red[t] += red[t + w];
    __syncthreads();
  }
  const R s = red[0];
  __syncthreads();  // red is free again
  return s;
}

// Where the wide instance keeps things: dynamic shared memory holds A
// (where a_shared), then the m/2 pairs' rotations and the m ranks; the
// workspace holds, a matrix, U and then A where not a_shared (2 m^2
// values).
template <typename T>
__host__ __device__ inline size_t wide_rotation_bytes(int m) {
  using R = typename Real<T>::type;
  const size_t pairs = (size_t)(m + 1) / 2;
  return pairs * (3 * sizeof(R) + 2 * sizeof(T) + 2 * sizeof(int)) +
         (size_t)m * sizeof(int);
}
template <typename T>
__host__ __device__ inline size_t wide_a_bytes(int m) {
  return ((size_t)m * m * sizeof(T) + 15) / 16 * 16;
}

// NT threads; WIDE: the layout of the note's wide instance, else A and U
// in dynamic shared memory and the rotations in static arrays.
template <typename T, int NT, bool WIDE>
__global__ void __launch_bounds__(NT)
herm_eig_block(const T* __restrict__ A_in,
               typename Real<T>::type* __restrict__ w_out,
               T* __restrict__ U_out, int* __restrict__ conv_out, int m,
               T* work, int a_shared) {
  using R = typename Real<T>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ R red[NT];
  __shared__ int rotated[2];  // sweep s rotated something: rotated[s & 1]
  T *sA, *sU, *rot_se, *rot_sec;
  R *rot_c, *rot_a, *rot_b;
  int *rot_p, *rot_q, *rank;
  if constexpr (WIDE) {
    const int pairs = (m + 1) / 2;
    T* mine = work + (long long)blockIdx.x * 2 * m * m;
    unsigned char* p = smem;
    if (a_shared) {
      sA = reinterpret_cast<T*>(p);
      p += wide_a_bytes<T>(m);
    } else {
      sA = mine + m * m;
    }
    sU = mine;
    rot_se = reinterpret_cast<T*>(p);
    rot_sec = rot_se + pairs;
    rot_c = reinterpret_cast<R*>(rot_sec + pairs);
    rot_a = rot_c + pairs;
    rot_b = rot_a + pairs;
    rot_p = reinterpret_cast<int*>(rot_b + pairs);
    rot_q = rot_p + pairs;
    rank = rot_q + pairs;
  } else {
    __shared__ R st_c[kMaxPairs], st_a[kMaxPairs], st_b[kMaxPairs];
    __shared__ T st_se[kMaxPairs], st_sec[kMaxPairs];
    __shared__ int st_p[kMaxPairs], st_q[kMaxPairs];
    __shared__ int st_rank[kMaxDim];
    sA = reinterpret_cast<T*>(smem);  // [m][m]
    sU = sA + m * m;                  // [m][m]
    rot_c = st_c;
    rot_a = st_a;
    rot_b = st_b;
    rot_se = st_se;
    rot_sec = st_sec;
    rot_p = st_p;
    rot_q = st_q;
    rank = st_rank;
  }

  const int t = threadIdx.x;
  const int mm = m * m;
  const long long base = (long long)blockIdx.x * mm;
  A_in += base;
  U_out += base;
  w_out += (long long)blockIdx.x * m;

  // the Hermitian matrix of the lower triangle, and U = I
  R fro = R(0);
  for (int o = t; o < mm; o += NT) {
    const int i = o / m, j = o % m;
    T v = i >= j ? A_in[o] : conj_of(A_in[j * m + i]);
    if (i == j) v = T(re_of(v));
    sA[o] = v;
    sU[o] = T(i == j ? R(1) : R(0));
    fro += abs2(v);
  }
  if (t == 0) rotated[0] = 0;
  const R fro2 = block_sum<NT>(fro, red);  // its barriers publish sA, sU, rotated
  const R eps = sizeof(R) == 8 ? (R)DBL_EPSILON : (R)FLT_EPSILON;
  const R tiny = eps * sqrt(fro2);

  const int mp = m + (m & 1);
  const int npairs = mp / 2;
  int converged = 0;  // the sweeps it took (the last rotating none), or 0
  for (int sweep = 0; sweep < kMaxSweeps && isfinite(fro2); ++sweep) {
    for (int r = 0; r < mp - 1; ++r) {
      for (int kp = t; kp < npairs; kp += NT) {
        const int p = kp == 0 ? r : (r + kp) % (mp - 1);
        const int q = kp == 0 ? mp - 1 : (r - kp + mp - 1) % (mp - 1);
        int keep = -1;
        if (p < m && q < m) {
          const T g = sA[p * m + q];
          const R ag = abs_of(g);
          const R a = re_of(sA[p * m + p]), b = re_of(sA[q * m + q]);
          if (!(ag > eps * (sqrt(fabs(a * b)) + tiny))) {
            sA[p * m + q] = T(R(0));
            sA[q * m + p] = T(R(0));
          } else {
            const R tau = (b - a) / (R(2) * ag);
            const R tt = copysign(R(1), tau) / (fabs(tau) + hypot(R(1), tau));
            const R c = R(1) / sqrt(R(1) + tt * tt);
            const R s = tt * c;
            const T e = unit(g, ag);
            rot_c[kp] = c;
            rot_se[kp] = scal(s, e);
            rot_sec[kp] = scal(s, conj_of(e));
            rot_a[kp] = a - tt * ag;
            rot_b[kp] = b + tt * ag;
            rot_q[kp] = q;
            keep = p;
            rotated[sweep & 1] = 1;
          }
        }
        rot_p[kp] = keep;
      }
      __syncthreads();
      // every thread has read the flag of the sweep before (it passed this
      // sweep's first barrier), so its slot serves the next sweep
      if (t == 0 && r == 0) rotated[(sweep + 1) & 1] = 0;
      // rows: A <- J^H A
      for (int o = t; o < npairs * m; o += NT) {
        const int k = o / m, j = o % m;
        const int p = rot_p[k];
        if (p < 0) continue;
        const int q = rot_q[k];
        const R c = rot_c[k];
        const T ap = sA[p * m + j], aq = sA[q * m + j];
        sA[p * m + j] = scal(c, ap) - rot_se[k] * aq;
        sA[q * m + j] = rot_sec[k] * ap + scal(c, aq);
      }
      __syncthreads();
      // columns: A <- A J, U <- U J
      for (int o = t; o < m * npairs; o += NT) {
        const int i = o / npairs, k = o % npairs;
        const int p = rot_p[k];
        if (p < 0) continue;
        const int q = rot_q[k];
        const R c = rot_c[k];
        const T se = rot_se[k], sec = rot_sec[k];
        T ap = sA[i * m + p], aq = sA[i * m + q];
        T np_ = scal(c, ap) - sec * aq, nq = se * ap + scal(c, aq);
        if (i == p) {
          np_ = T(rot_a[k]);
          nq = T(R(0));
        } else if (i == q) {
          np_ = T(R(0));
          nq = T(rot_b[k]);
        }
        sA[i * m + p] = np_;
        sA[i * m + q] = nq;
        ap = sU[i * m + p];
        aq = sU[i * m + q];
        sU[i * m + p] = scal(c, ap) - sec * aq;
        sU[i * m + q] = se * ap + scal(c, aq);
      }
      __syncthreads();
    }
    if (!rotated[sweep & 1]) {
      converged = sweep + 1;
      break;
    }
  }

  // ascending eigenvalues, U's columns with them
  for (int i = t; i < m; i += NT) {
    const R wi = re_of(sA[i * m + i]);
    int k = 0;
    for (int j = 0; j < m; ++j) {
      const R wj = re_of(sA[j * m + j]);
      k += (wj < wi) || (wj == wi && j < i);
    }
    rank[i] = k;
    w_out[k] = wi;
  }
  __syncthreads();
  if constexpr (WIDE) {
    // one Newton-Schulz step on U: G = U^H U - I into A's storage (its
    // diagonal is read), then U - U G / 2 (see the note at the top)
    for (int o = t; o < mm; o += NT) {
      const int i = o / m, j = o % m;
      T g = T(0);
      for (int l = 0; l < m; ++l)
        g = mul_add(conj_of(sU[l * m + i]), sU[l * m + j], g);
      sA[o] = i == j ? g - T(R(1)) : g;
    }
    __syncthreads();
    for (int o = t; o < mm; o += NT) {
      const int i = o / m, j = o % m;
      T g = T(0);
      for (int l = 0; l < m; ++l) g = mul_add(sU[i * m + l], sA[l * m + j], g);
      U_out[i * m + rank[j]] = sU[o] - scal(R(0.5), g);
    }
  } else {
    for (int o = t; o < mm; o += NT) {
      const int i = o / m, j = o % m;
      U_out[i * m + rank[j]] = sU[o];
    }
  }
  if (t == 0) conv_out[blockIdx.x] = converged;
}

template <typename T>
int launch(const void* A, void* w, void* U, int* conv, void* work, int batch,
           int m, cudaStream_t stream) {
  using R = typename Real<T>::type;
  const T* a = static_cast<const T*>(A);
  R* wr = static_cast<R*>(w);
  T* u = static_cast<T*>(U);
  if (m <= kMaxDim) {
    const int smem = 2 * m * m * (int)sizeof(T);
    // the static arrays: red, the rotations of kMaxPairs pairs, the ranks
    constexpr int fixed = kThreads * sizeof(R) + kMaxPairs * (3 * sizeof(R) +
                                                              2 * sizeof(T) +
                                                              2 * sizeof(int)) +
                          kMaxDim * sizeof(int) + 64;
    if (smem + fixed > kDefaultSmem) {
      cudaError_t e = cudaFuncSetAttribute(
          herm_eig_block<T, kThreads, false>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return (int)e;
    }
    herm_eig_block<T, kThreads, false><<<batch, kThreads, smem, stream>>>(
        a, wr, u, conv, m, nullptr, 0);
    return (int)cudaGetLastError();
  }
  // float32 and complex64 past m = 64 are solved in float64 (complex128)
  // by the wrapper: their U drifted from orthonormal by more than 16 m eps
  // over the sweeps at m = 128
  if constexpr (sizeof(R) == 4) {
    return (int)cudaErrorInvalidValue;
  } else {
  if (work == nullptr) return (int)cudaErrorInvalidValue;
  // static: red[kWideThreads] and the flags
  const size_t fixed = kWideThreads * sizeof(R) + 64;
  const size_t rot = wide_rotation_bytes<T>(m);
  const int a_shared = wide_a_bytes<T>(m) + rot + fixed <= (size_t)kMaxSmem;
  const size_t smem = (a_shared ? wide_a_bytes<T>(m) : 0) + rot;
  if (smem + fixed > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kern = herm_eig_block<T, kWideThreads, true>;
  if (smem + fixed > (size_t)kDefaultSmem) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<batch, kWideThreads, smem, stream>>>(a, wr, u, conv, m,
                                              static_cast<T*>(work), a_shared);
  return (int)cudaGetLastError();
  }
}

}  // namespace

// dtype: 0 float64, 1 float32, 4 complex128, 5 complex64 (of A and U; w
// is of the real type).  A holds batch matrices of m x m values, U as
// many, w batch * m values and conv batch ints (sweeps taken, 0 where a
// matrix did not converge).  work (m > 64 only; may be null otherwise)
// holds 2 * batch * m * m values of A's type.
// Requires batch >= 1 and m >= 1, and m <= 64 for float32 and complex64.
// Returns the first CUDA error of the launch (0 on success).
extern "C" int herm_eig_launch(int dtype, const void* A, void* w, void* U,
                               void* conv, void* work, int batch, int m,
                               void* stream) {
  if (batch < 1 || m < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* c = static_cast<int*>(conv);
  switch (dtype) {
    case 0: return launch<double>(A, w, U, c, work, batch, m, s);
    case 1: return launch<float>(A, w, U, c, work, batch, m, s);
    case 4: return launch<Complex<double>>(A, w, U, c, work, batch, m, s);
    case 5: return launch<Complex<float>>(A, w, U, c, work, batch, m, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

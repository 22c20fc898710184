// Hermitian eigensolver for small matrices on Hopper (sm_90a): one thread
// block a matrix, cyclic Jacobi in shared memory up to m = 64, block
// Jacobi past it.
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
// three barriers; in the wide instance mp / 8 - 1 rounds a sweep of 15
// dependent inner rounds a warp), a latency and not a throughput.
//
// Design:
// * Up to m = 64 the matrix and U (2 m^2 values, 128 KB for complex128 at
//   m = 64) live in dynamic shared memory for the whole solve, with 256
//   threads: nothing goes back to device memory until the result.
// * Past m = 64, the wide instance: block Jacobi (float64 and complex128
//   only: the wrapper solves float32 and complex64 matrices in those and
//   rounds the result, since over the sweeps at m = 128 a float32 U
//   drifted from orthonormal by more than 16 m eps).  The order is cut
//   into blocks of kBW = 8 indices (zero rows and columns pad it to whole
//   pairs of blocks, mp; they are never rotated).  A sweep is mp / 8 - 1
//   rounds of the round-robin order over the blocks; in a round each of
//   the mp / 16 pairs of blocks (P, Q) is one warp's 16 x 16 Hermitian
//   subproblem A[P u Q, P u Q], which the warp solves by one cyclic Jacobi
//   sweep (15 inner rounds of 8 disjoint rotations, as below, with only
//   __syncwarp between them), accumulating its 16 x 16 unitary factor G.
//   The block then applies every pair's factor at once: A <- G^H A G and
//   U <- U G for the block-diagonal G (in the round's order), as small
//   products: on the FP64 tensor cores for float64 (A G a 16-row block
//   and a pair at a time, then G^H (A G) a pair and 8 columns at a time,
//   mma.sync m16n8k8), on the CUDA cores for complex128 (the rows of
//   G^H A, A's conjugate transpose in place, the rows of G^H again, A
//   being Hermitian).  Each pair's own 16 x 16 block of the new A is its
//   subproblem's result, with its exact zeros and diagonal.  A round
//   whose pairs rotate nothing applies nothing, and a pair that rotated
//   nothing keeps its rows and columns (its G is I).  At m = 128: 15
//   rounds a sweep against 127 for cyclic scalar Jacobi, each round three
//   barriers of the block; the sweep count stays about that of the scalar
//   order (9-11 on a block-CG Gram, up to 20 with clusters of equal
//   eigenvalues).
// * Where things live: A (row stride mp + 4 for float64, so that the
//   fragments of four rows meet distinct banks; mp + 1 for complex), the
//   subproblems and two rounds' factors in shared memory where they fit
//   (float64 to m = 128 with A; the subproblems alone much further), the
//   rest in a workspace the wrapper allocates (herm_eig_work_values);
//   U^T (so that every product reads rows) always in the workspace, in
//   L2.  384 threads: where the pairs leave warps spare (mp / 16 < 12,
//   float64), those apply the round before's factors to U during the
//   subproblems.  Measured on an H100 80GB HBM3 at 700 W (PERF.md, PR 30;
//   chip_smoke.py phase 12d, tools/eig_trials.py): 2.57 ms on a block-CG
//   Gram at m = 128 against 9.29 for PR 29's scalar design; on a random
//   Gram of 11 sweeps 3.15 ms, where designs on the way took 10.3
//   (products on the CUDA cores, a thread a row and a pair), 9.1 (rows
//   only, with U^T and a transpose), 5.5 (DMMA products), 3.7 (256
//   threads, U after A's products).
// * The scalar design below leaves U's columns orthonormal to about
//   18 m eps at m = 128 (||U^H U - I||_F, float64, two eigenvalues of
//   multiplicity m/2), the block design to about 2 x 16 m eps, past the
//   16 m eps the narrow design keeps; one Newton-Schulz step, U <- U -
//   U (U^H U - I) / 2, two m^3 products at the end (on DMMA for float64
//   with A in shared memory), takes that to the rounding of the products.
// * The scalar design (up to m = 64, and each warp's inner sweep): a
//   sweep is m' - 1 rounds (m' = m rounded up to even) of the
//   round-robin ("chess tournament") order: in each round the m'/2 pairs
//   (p, q) are disjoint, so their rotations commute and are applied
//   together.  Thread k of the first m'/2 computes pair k's rotation from
//   the current 2 x 2 block [[a, g], [conj(g), b]]: with e = g / |g| it is
//   J = [[c, s e], [-s conj(e), c]], where (c, s) is the real symmetric
//   Jacobi rotation of [[a, |g|], [|g|, b]] (Golub and Van Loan, sym.schur2:
//   tau = (b - a) / 2|g|, t = sign(tau) / (|tau| + hypot(1, tau)); the
//   wide instance's warps take t = sign(d) 2|g| / (|d| + hypot(d, 2|g|))
//   with d = b - a, the same root by one division fewer).  Then all
//   threads apply J^H to the pairs' rows (one thread an entry pair), then
//   J to their columns and to U's (a warp's lanes: J_i^H B J_j on each
//   2 x 2 block B of pairs i and j); the new diagonal entries a - t|g|
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
constexpr int kWideThreads = 384;  // the wide instance, m > kMaxDim
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

// A and U in dynamic shared memory, NT threads, the rotations in static
// arrays (m <= kMaxDim).
template <typename T, int NT>
__global__ void __launch_bounds__(NT)
herm_eig_block(const T* __restrict__ A_in,
               typename Real<T>::type* __restrict__ w_out,
               T* __restrict__ U_out, int* __restrict__ conv_out, int m) {
  using R = typename Real<T>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ R red[NT];
  __shared__ int rotated[2];  // sweep s rotated something: rotated[s & 1]
  __shared__ R rot_c[kMaxPairs], rot_a[kMaxPairs], rot_b[kMaxPairs];
  __shared__ T rot_se[kMaxPairs], rot_sec[kMaxPairs];
  __shared__ int rot_p[kMaxPairs], rot_q[kMaxPairs];
  __shared__ int rank[kMaxDim];
  T* sA = reinterpret_cast<T*>(smem);  // [m][m]
  T* sU = sA + m * m;                  // [m][m]
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
  for (int o = t; o < mm; o += NT) {
    const int i = o / m, j = o % m;
    U_out[i * m + rank[j]] = sU[o];
  }
  if (t == 0) conv_out[blockIdx.x] = converged;
}

// ---- the wide instance (m > kMaxDim): block Jacobi, see the note ----
constexpr int kWideWarps = kWideThreads / 32;
constexpr int kBW = 8;             // indices a block of the order
constexpr int kSub = 2 * kBW;      // order of a pair's subproblem
constexpr int kSubLd = kSub + 1;   // its row stride
constexpr int kSubVals = kSub * kSubLd;
constexpr int kGLd = kSub + 2;     // a factor G's row stride (4 banks a row)
constexpr int kGVals = kSub * kGLd;
constexpr int kHalf = kSub / 2;    // outputs a thread keeps at a time
// columns of A (or of U^T) a thread takes with the same factor: real
// values two (each value of G read feeds two products), complex one
template <typename T> struct StepCols {
  static constexpr int N = 2, H = kHalf;
};
// complex values: one column and four outputs at a time (the registers)
template <typename R> struct StepCols<Complex<R>> {
  static constexpr int N = 1, H = kHalf / 2;
};

// m rounded up to whole pairs of blocks: the order the solve runs at
// (the padding rows and columns are zero and never rotated)
__host__ __device__ inline int wide_order(int m) {
  return (m + kSub - 1) / kSub * kSub;
}
// A's row stride: mp + 4 for float64 (the tensor cores' fragments of four
// rows meet distinct banks), mp + 1 for complex values (a column's
// values do)
template <typename T> __host__ __device__ inline int wide_lda(int mp) {
  return mp + (sizeof(T) == 8 ? 4 : 1);
}
// Values of the workspace a matrix: U^T (mp x m), A (mp x (mp + 4)), the
// subproblems S (npairs x kSubVals) and their factors G (two rounds'
// worth, npairs x kGVals each), each where shared memory cannot hold it.
__host__ __device__ inline size_t wide_work_values(int m) {
  const size_t mp = wide_order(m), npairs = mp / kSub;
  return (size_t)m * mp + mp * (mp + 4) + npairs * (kSubVals + 2 * kGVals);
}

// Position of pair kp in round r of the round-robin order over n (even)
// items: (p, q), disjoint within a round, every pair once in n - 1 rounds.
__device__ __forceinline__ void tour(int r, int kp, int n, int& p, int& q) {
  p = kp == 0 ? r : (r + kp) % (n - 1);
  q = kp == 0 ? n - 1 : (r - kp + n - 1) % (n - 1);
}

// M[I_kp][0, cols) <- op(G_kp) M[I_kp][0, cols) for every pair kp of round
// r (I_kp its 16 indices, G_kp at Gr + kp * kGVals): out[c] = sum_l
// g[l][c] M[I(l)][j] with g = conj(G) (CONJ: the rows of G^H A) or G (U^T
// <- G^T U^T).  A thread takes StepCols columns ncb apart (neighbouring
// threads, neighbouring columns) of one pair, kHalf outputs at a time.
// OWN: a pair's own columns take its subproblem's values (S), which hold
// their exact zeros and diagonal.
template <bool CONJ, bool OWN, typename T>
__device__ __forceinline__ void row_step(T* M, int ld, int cols, int r,
                                         const T* Gr, const T* S, int nb,
                                         int npairs) {
  using R = typename Real<T>::type;
  constexpr int RB = StepCols<T>::N, H = StepCols<T>::H;
  // complex values: one group of H outputs at a time (registers)
  constexpr int kGroups = sizeof(T) == 8 ? kSub / H : 1;
  const int ncb = (cols + RB - 1) / RB;
  for (int task = threadIdx.x; task < ncb * npairs; task += kWideThreads) {
    const int jb = task % ncb, kp = task / ncb;
    const T* Gk = Gr + (size_t)kp * kGVals;
    int P, Q;
    tour(r, kp, nb, P, Q);
    auto idx = [&](int l) { return l < kBW ? P * kBW + l : Q * kBW + l - kBW; };
    T a[RB][kSub];
#pragma unroll
    for (int u = 0; u < RB; ++u) {
      const int j = jb + u * ncb;
#pragma unroll
      for (int l = 0; l < kSub; ++l)
        a[u][l] = j < cols ? M[(size_t)idx(l) * ld + j] : T(R(0));
    }
#pragma unroll kGroups
    for (int h = 0; h < kSub; h += H) {
      T out[RB][H];
#pragma unroll
      for (int u = 0; u < RB; ++u)
#pragma unroll
        for (int c = 0; c < H; ++c) out[u][c] = T(R(0));
#pragma unroll
      for (int l = 0; l < kSub; ++l)
#pragma unroll
        for (int c = 0; c < H; c += 2) {
          T g0 = Gk[l * kGLd + h + c], g1 = Gk[l * kGLd + h + c + 1];
          if (CONJ) {
            g0 = conj_of(g0);
            g1 = conj_of(g1);
          }
#pragma unroll
          for (int u = 0; u < RB; ++u) {
            out[u][c] = mul_add(g0, a[u][l], out[u][c]);
            out[u][c + 1] = mul_add(g1, a[u][l], out[u][c + 1]);
          }
        }
#pragma unroll
      for (int u = 0; u < RB; ++u) {
        const int j = jb + u * ncb;
        if (j >= cols) continue;
        int jl = -1;
        if (OWN)
          jl = j / kBW == P ? j % kBW : j / kBW == Q ? kBW + j % kBW : -1;
#pragma unroll
        for (int c = 0; c < H; ++c)
          M[(size_t)idx(h + c) * ld + j] =
              jl >= 0 ? S[(size_t)kp * kSubVals + (h + c) * kSubLd + jl]
                      : out[u][c];
      }
    }
  }
}

// d (16 x 8) += a (16 x 8) b (8 x 8) on the FP64 tensor cores: a0..a3 at
// rows (g, g + 8, g, g + 8) and columns (q, q, q + 4, q + 4), b0, b1 at
// rows q, q + 4 and column g, d0, d1 at row g and d2, d3 at row g + 8,
// columns 2q and 2q + 1 (g = lane / 4, q = lane % 4)
__device__ __forceinline__ void dmma16(double* d, const double* a,
                                       double b0, double b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b0), "d"(b1));
}

// Float64 on the FP64 tensor cores.  Warps w0 .. w0 + nw - 1 share the
// work: each takes one pair at a time (pairs kp = w / wpp, ...), and of
// that pair a contiguous range of its 16-row (8-column) blocks, so that
// it loads the pair's factor once, then a block at a time (the operands
// of two or four blocks loaded together measured slower at 384 threads,
// or spilled).

struct PairShare {
  int kp0, kstep, lo, hi;  // pairs kp0, kp0 + kstep, ...; blocks [lo, hi)
  bool active;
};
__device__ __forceinline__ PairShare pair_share(int blocks, int npairs,
                                                int w0, int nw) {
  const int wi = (int)(threadIdx.x >> 5) - w0;
  const int wpp = nw >= npairs ? nw / npairs : 1;
  const int slots = nw / wpp;
  const int part = wi % wpp;
  PairShare s;
  s.kp0 = wi / wpp;
  s.kstep = slots;
  s.lo = part * blocks / wpp;
  s.hi = (part + 1) * blocks / wpp;
  s.active = wi >= 0 && wi < slots * wpp;
  return s;
}

// A[rows][I_kp] <- A[rows][I_kp] G_kp for every pair kp of round r.
__device__ __forceinline__ void cols_dmma(double* A, int lda, int mp, int r,
                                          const double* Gr, const int* prot,
                                          int nb, int npairs, int w0,
                                          int nw) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const PairShare ps = pair_share(mp / 16, npairs, w0, nw);
  if (!ps.active) return;
  for (int kp = ps.kp0; kp < npairs; kp += ps.kstep) {
    if (!prot[kp]) continue;  // G_kp = I
    const double* Gk = Gr + (size_t)kp * kGVals;
    int P, Q;
    tour(r, kp, nb, P, Q);
    // b: G's k-step h (rows 8h..) by output block o (columns 8o..)
    double b[2][2][2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int o = 0; o < 2; ++o) {
        b[h][o][0] = Gk[(8 * h + q) * kGLd + 8 * o + g];
        b[h][o][1] = Gk[(8 * h + q + 4) * kGLd + 8 * o + g];
      }
    for (int rb = ps.lo; rb < ps.hi; ++rb) {
      // a: 16 rows of A by the pair's columns, k-step h = block P, then Q
      const int i0 = rb * 16;
      double a[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c0 = (h ? Q : P) * kBW;
        a[h][0] = A[(size_t)(i0 + g) * lda + c0 + q];
        a[h][1] = A[(size_t)(i0 + g + 8) * lda + c0 + q];
        a[h][2] = A[(size_t)(i0 + g) * lda + c0 + q + 4];
        a[h][3] = A[(size_t)(i0 + g + 8) * lda + c0 + q + 4];
      }
#pragma unroll
      for (int o = 0; o < 2; ++o) {
        double d[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll
        for (int h = 0; h < 2; ++h) dmma16(d, a[h], b[h][o][0], b[h][o][1]);
        const int c = (o ? Q : P) * kBW + 2 * q;
        A[(size_t)(i0 + g) * lda + c] = d[0];
        A[(size_t)(i0 + g) * lda + c + 1] = d[1];
        A[(size_t)(i0 + g + 8) * lda + c] = d[2];
        A[(size_t)(i0 + g + 8) * lda + c + 1] = d[3];
      }
    }
  }
}

// M[I_kp][0, cols) <- G_kp^T M[I_kp][0, cols) (G^H for real G) for every
// pair kp of round r, in blocks of 8 columns; OWN: a pair's own columns
// take its subproblem's values (S), which hold their exact zeros and
// diagonal.
template <bool OWN>
__device__ __forceinline__ void rows_dmma(double* M, int ld, int cols,
                                          int r, const double* Gr,
                                          const double* S, const int* prot,
                                          int nb, int npairs, int w0,
                                          int nw) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const PairShare ps = pair_share((cols + 7) / 8, npairs, w0, nw);
  if (!ps.active) return;
  for (int kp = ps.kp0; kp < npairs; kp += ps.kstep) {
    const double* Gk = Gr + (size_t)kp * kGVals;
    const double* Sk = S + (size_t)kp * kSubVals;
    int P, Q;
    tour(r, kp, nb, P, Q);
    if (!prot[kp]) {  // G_kp = I: only the pair's own block changes
      if (OWN) {
        for (int cb = ps.lo; cb < ps.hi; ++cb) {
          if (cb != P && cb != Q) continue;
          const int c0 = cb == P ? 0 : kBW;
          for (int e = lane; e < kSub * kBW; e += 32) {
            const int i = e / kBW, c = e % kBW;
            M[(size_t)(i < kBW ? P * kBW + i : Q * kBW + i - kBW) * ld +
              cb * kBW + c] = Sk[i * kSubLd + c0 + c];
          }
        }
      }
      continue;
    }
    // a: G^T, rows g and g + 8 (the outputs), k-step h = G's rows 8h..
    double a[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      a[h][0] = Gk[(8 * h + q) * kGLd + g];
      a[h][1] = Gk[(8 * h + q) * kGLd + g + 8];
      a[h][2] = Gk[(8 * h + q + 4) * kGLd + g];
      a[h][3] = Gk[(8 * h + q + 4) * kGLd + g + 8];
    }
    for (int cb = ps.lo; cb < ps.hi; ++cb) {
      const int j = cb * 8 + g;  // the B fragment's column
      double d[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r0 = (h ? Q : P) * kBW;
        dmma16(d, a[h], j < cols ? M[(size_t)(r0 + q) * ld + j] : 0.0,
               j < cols ? M[(size_t)(r0 + q + 4) * ld + j] : 0.0);
      }
      const int j0 = cb * 8 + 2 * q;
      int own = -1;  // the subproblem's column of j0 (cb is P or Q)
      if (OWN) own = cb == P ? 2 * q : cb == Q ? kBW + 2 * q : -1;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (j0 + e >= cols) continue;
        M[(size_t)(P * kBW + g) * ld + j0 + e] =
            own >= 0 ? Sk[g * kSubLd + own + e] : d[e];
        M[(size_t)(Q * kBW + g) * ld + j0 + e] =
            own >= 0 ? Sk[(g + 8) * kSubLd + own + e] : d[2 + e];
      }
    }
  }
}

// The Newton-Schulz step in float64 on the FP64 tensor cores (A in shared
// memory): U, zero-padded to mp x mp, into A's storage (Us, row stride
// lda), E = Us^T Us - I into E (mp x mp in device memory), then
// U_out[i][rank[j]] = (Us - Us E / 2)[i][j]; a warp a 16 x 8 tile at a
// time.
__device__ __forceinline__ void newton_schulz_dmma(const double* Ut,
                                                   double* Us, int lda,
                                                   double* E, int m, int mp,
                                                   const int* rank,
                                                   double* U_out) {
  const int t = threadIdx.x, lane = t & 31, g = lane >> 2, q = lane & 3;
  for (int o = t; o < mp * mp; o += kWideThreads) {
    const int j = o / mp, i = o % mp;
    Us[(size_t)i * lda + j] = i < m && j < m ? Ut[(size_t)j * m + i] : 0.0;
  }
  __syncthreads();
  const int ntiles = (mp / 16) * (mp / 8);
  for (int tile = t >> 5; tile < ntiles; tile += kWideWarps) {
    const int i0 = (tile / (mp / 8)) * 16, j0 = (tile % (mp / 8)) * 8;
    double d[4] = {0.0, 0.0, 0.0, 0.0};
    for (int k0 = 0; k0 < mp; k0 += 8) {
      const double a[4] = {Us[(size_t)(k0 + q) * lda + i0 + g],
                           Us[(size_t)(k0 + q) * lda + i0 + g + 8],
                           Us[(size_t)(k0 + q + 4) * lda + i0 + g],
                           Us[(size_t)(k0 + q + 4) * lda + i0 + g + 8]};
      dmma16(d, a, Us[(size_t)(k0 + q) * lda + j0 + g],
             Us[(size_t)(k0 + q + 4) * lda + j0 + g]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i0 + g + 8 * (e >> 1), j = j0 + 2 * q + (e & 1);
      E[(size_t)i * mp + j] = i == j ? d[e] - 1.0 : d[e];
    }
  }
  __syncthreads();
  const int mt = (m + 15) / 16, nt = (m + 7) / 8;
  for (int tile = t >> 5; tile < mt * nt; tile += kWideWarps) {
    const int i0 = (tile / nt) * 16, j0 = (tile % nt) * 8;
    double d[4] = {0.0, 0.0, 0.0, 0.0};
    for (int k0 = 0; k0 < mp; k0 += 8) {
      const double a[4] = {Us[(size_t)(i0 + g) * lda + k0 + q],
                           Us[(size_t)(i0 + g + 8) * lda + k0 + q],
                           Us[(size_t)(i0 + g) * lda + k0 + q + 4],
                           Us[(size_t)(i0 + g + 8) * lda + k0 + q + 4]};
      dmma16(d, a, E[(size_t)(k0 + q) * mp + j0 + g],
             E[(size_t)(k0 + q + 4) * mp + j0 + g]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i0 + g + 8 * (e >> 1), j = j0 + 2 * q + (e & 1);
      if (i < m && j < m)
        U_out[(size_t)i * m + rank[j]] =
            Us[(size_t)i * lda + j] - 0.5 * d[e];
    }
  }
}

// One value of every lane of a warp from lane `src`.
__device__ __forceinline__ double lane_value(double v, int src) {
  return __shfl_sync(0xffffffffu, v, src);
}
template <typename R>
__device__ __forceinline__ Complex<R> lane_value(Complex<R> v, int src) {
  return Complex<R>(__shfl_sync(0xffffffffu, v.re, src),
                    __shfl_sync(0xffffffffu, v.im, src));
}

// The rotation J = [[c, s e], [-s conj(e), c]] that zeroes g of the 2 x 2
// block [[a, g], [conj(g), b]] (|g| = ag > 0, e = g / |g|): c, s e and
// the new diagonal entries a - t |g|, b + t |g|, with t = tan(theta) =
// sign(d) 2|g| / (|d| + hypot(d, 2|g|)), the smaller root, d = b - a, and
// c = 1 / sqrt(1 + t^2)
template <typename T, typename R>
__device__ __forceinline__ void rotation(T g, R ag, R a, R b, R& c, T& se,
                                         R& na, R& nb) {
  const R d = b - a, y = R(2) * ag, r2 = d * d + y * y;
  // hypot(d, y), by way of r2 where that neither overflows nor underflows
  const R r = r2 < R(1e300) && r2 > R(1e-300) ? sqrt(r2) : hypot(d, y);
  const R tt = copysign(y, d) / (fabs(d) + r);
  c = rsqrt(R(1) + tt * tt);
  se = scal(tt * c, unit(g, ag));
  na = a - tt * ag;
  nb = b + tt * ag;
}

// SG: the subproblems and factors in shared memory; AS: A too (both
// template parameters, so that their accesses compile to shared ones).
template <typename T, bool SG, bool AS>
__global__ void __launch_bounds__(kWideThreads, 1)
herm_eig_wide(const T* __restrict__ A_in,
              typename Real<T>::type* __restrict__ w_out,
              T* __restrict__ U_out, int* __restrict__ conv_out, int m,
              T* __restrict__ work) {
  using R = typename Real<T>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ R red[kWideThreads];
  __shared__ int rflag[2];  // round i rotated something: rflag[i & 1]

  const int mp = wide_order(m), lda = wide_lda<T>(mp);
  const int nb = mp / kBW, npairs = nb / 2;
  const size_t n_s = (size_t)npairs * kSubVals, n_g = (size_t)npairs * kGVals;
  T* Ut = work + (size_t)blockIdx.x * wide_work_values(m);  // [mp][m]
  T* wA = Ut + (size_t)m * mp;
  T* wS = wA + (size_t)mp * (mp + 4);
  T* sS = reinterpret_cast<T*>(smem);
  T* S = SG ? sS : wS;
  T* G = S + n_s;
  // where S and G live in device memory, a warp solves its subproblem in
  // a scratch copy of S_k and G_k in shared memory
  constexpr size_t kScratch = kSubVals + kGVals;
  T* sA = sS + (SG ? n_s + 2 * n_g : kWideWarps * kScratch);
  T* A = AS ? sA : wA;
  int* rank = reinterpret_cast<int*>(sA + (AS ? (size_t)mp * lda : 0));
  // pair kp of round i rotated something: prot_of[(i & 1) * npairs + kp]
  int* prot_of = rank + m;

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const long long base = (long long)blockIdx.x * m * m;
  A_in += base;
  U_out += base;
  w_out += (long long)blockIdx.x * m;

  // the Hermitian matrix of the lower triangle, zero-padded to mp, and
  // U^T = I
  R fro = R(0);
  for (int o = t; o < mp * mp; o += kWideThreads) {
    const int i = o / mp, j = o % mp;
    T v = T(R(0));
    if (i < m && j < m) {
      v = i >= j ? A_in[i * m + j] : conj_of(A_in[j * m + i]);
      if (i == j) v = T(re_of(v));
    }
    A[i * lda + j] = v;
    fro += abs2(v);
  }
  for (int o = t; o < mp * m; o += kWideThreads)
    Ut[o] = T(R(o / m == o % m ? 1 : 0));
  if (t == 0) rflag[0] = rflag[1] = 0;
  const R fro2 = block_sum<kWideThreads>(fro, red);  // publishes A, Ut, rflag
  const R eps = sizeof(R) == 8 ? (R)DBL_EPSILON : (R)FLT_EPSILON;
  const R tiny = eps * sqrt(fro2);

  int converged = 0;  // the sweeps it took (the last rotating none), or 0
  int rid = 0;        // rounds so far: G and rflag alternate on rid & 1
  // float64 with warps to spare in the subproblem phase: they apply the
  // round before's factors to U^T there (pend_r: that round, or -1)
  const bool u_spare = sizeof(T) == 8 && npairs < kWideWarps;
  int pend_r = -1;
  for (int sweep = 0; sweep < kMaxSweeps && isfinite(fro2); ++sweep) {
    int swept = 0;
    for (int r = 0; r < nb - 1; ++r, ++rid) {
      const int buf = rid & 1;
      T* Gr = G + (size_t)buf * n_g;
      int* prot = prot_of + buf * npairs;
      const int* pprev = prot_of + (buf ^ 1) * npairs;
      // ---- the subproblems: a warp a pair, one cyclic Jacobi sweep each
      if (t == 0) rflag[buf ^ 1] = 0;  // the round before's, read by all
      for (int kp = warp; kp < npairs; kp += kWideWarps) {
        T* const Sg = S + (size_t)kp * kSubVals;
        T* const Gg = Gr + (size_t)kp * kGVals;
        T* Sk = SG ? Sg : sS + warp * kScratch;
        T* Gk = SG ? Gg : sS + warp * kScratch + kSubVals;
        int P, Q;
        tour(r, kp, nb, P, Q);
#pragma unroll 2
        for (int o = lane; o < kSub * kSub; o += 32) {
          const int i = o / kSub, j = o % kSub;
          const int gi = i < kBW ? P * kBW + i : Q * kBW + i - kBW;
          const int gj = j < kBW ? P * kBW + j : Q * kBW + j - kBW;
          Sk[i * kSubLd + j] = A[(size_t)gi * lda + gj];
          Gk[i * kGLd + j] = T(R(i == j ? 1 : 0));
        }
        // lane: column pair bj of S and G, row pairs bi0 and bi0 + 4 of S,
        // rows bi0 + 4 k of G
        const int bj = lane % kBW, bi0 = lane / kBW;
        unsigned any = 0;
        // the round-robin positions of pairs bj, bi0 and bi0 + 4: from one
        // inner round to the next every index but kSub - 1 moves up by one
        // (mod kSub - 1)
        int pj, qj, pi[2], qi[2];
        tour(0, bj, kSub, pj, qj);
        tour(0, bi0, kSub, pi[0], qi[0]);
        tour(0, bi0 + 4, kSub, pi[1], qi[1]);
        auto next = [](int& x) {
          if (x != kSub - 1) x = x == kSub - 2 ? 0 : x + 1;
        };
        for (int ir = 0; ir < kSub - 1; ++ir) {
          if (ir > 0) {
            next(pj);
            next(qj);
#pragma unroll
            for (int v = 0; v < 2; ++v) {
              next(pi[v]);
              next(qi[v]);
            }
          }
          __syncwarp();  // the round before's stores are seen
          // every lane tests its column pair bj: a pair whose |g| is
          // negligible, |g| <= eps (sqrt|a b| + eps ||A||_F), is not rotated
          const T gj = Sk[pj * kSubLd + qj];
          const R agj = abs_of(gj);
          const R aj0 = re_of(Sk[pj * kSubLd + pj]);
          const R bj0 = re_of(Sk[qj * kSubLd + qj]);
          const bool rj = agj > eps * (sqrt(fabs(aj0 * bj0)) + tiny);
          const unsigned rot = __ballot_sync(0xffffffffu, rj);
          if (rot == 0) {  // nothing rotates: the pairs' entries become 0
            __syncwarp();
            if (lane < kBW) {
              Sk[pj * kSubLd + qj] = T(R(0));
              Sk[qj * kSubLd + pj] = T(R(0));
            }
            continue;
          }
          any |= rot;
          // the rotation of pair bj; those of the row pairs come from
          // lanes bi0 and bi0 + 4
          R cj, aj, bjn;
          T sej;
          rotation(gj, agj, aj0, bj0, cj, sej, aj, bjn);
          R ci[2];
          T sei[2];
          bool ri[2];
#pragma unroll
          for (int v = 0; v < 2; ++v) {
            const int src = bi0 + 4 * v;
            ci[v] = __shfl_sync(0xffffffffu, cj, src);
            sei[v] = lane_value(sej, src);
            ri[v] = (rot >> src) & 1u;
          }
          T x[2][4], gv[4][2];
#pragma unroll
          for (int v = 0; v < 2; ++v) {
            x[v][0] = Sk[pi[v] * kSubLd + pj];
            x[v][1] = Sk[pi[v] * kSubLd + qj];
            x[v][2] = Sk[qi[v] * kSubLd + pj];
            x[v][3] = Sk[qi[v] * kSubLd + qj];
          }
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            gv[k][0] = Gk[(bi0 + 4 * k) * kGLd + pj];
            gv[k][1] = Gk[(bi0 + 4 * k) * kGLd + qj];
          }
          __syncwarp();  // every lane has read what this round reads
          // A's 2 x 2 blocks of pairs (bi, bj) <- J_bi^H A J_bj; a pair not
          // rotated is negligible: its two off-diagonal entries become 0
#pragma unroll
          for (int v = 0; v < 2; ++v) {
            T x00 = x[v][0], x01 = x[v][1], x10 = x[v][2], x11 = x[v][3];
            if (bi0 + 4 * v == bj) {
              if (rj) {
                x00 = T(aj);
                x11 = T(bjn);
              }
              x01 = x10 = T(R(0));
            } else {
              if (ri[v]) {  // rows: J^H
                const T se = sei[v], sec = conj_of(se);
                const T y00 = scal(ci[v], x00) - se * x10;
                const T y01 = scal(ci[v], x01) - se * x11;
                x10 = sec * x00 + scal(ci[v], x10);
                x11 = sec * x01 + scal(ci[v], x11);
                x00 = y00;
                x01 = y01;
              }
              if (rj) {  // columns: J
                const T sec = conj_of(sej);
                const T y00 = scal(cj, x00) - sec * x01;
                const T y10 = scal(cj, x10) - sec * x11;
                x01 = sej * x00 + scal(cj, x01);
                x11 = sej * x10 + scal(cj, x11);
                x00 = y00;
                x10 = y10;
              }
            }
            Sk[pi[v] * kSubLd + pj] = x00;
            Sk[pi[v] * kSubLd + qj] = x01;
            Sk[qi[v] * kSubLd + pj] = x10;
            Sk[qi[v] * kSubLd + qj] = x11;
          }
          if (rj) {  // G <- G J
            const T sec = conj_of(sej);
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              Gk[(bi0 + 4 * k) * kGLd + pj] =
                  scal(cj, gv[k][0]) - sec * gv[k][1];
              Gk[(bi0 + 4 * k) * kGLd + qj] =
                  sej * gv[k][0] + scal(cj, gv[k][1]);
            }
          }
        }
        if constexpr (!SG) {
          __syncwarp();
          for (int o = lane; o < kSubVals; o += 32) Sg[o] = Sk[o];
          for (int o = lane; o < kGVals; o += 32) Gg[o] = Gk[o];
          __syncwarp();
        }
        if (lane == 0) {
          prot[kp] = any != 0;
          if (any) rflag[buf] = 1;
        }
      }
      if constexpr (sizeof(T) == 8) {
        if (u_spare && pend_r >= 0)
          rows_dmma<false>(Ut, m, m, pend_r, G + (size_t)(buf ^ 1) * n_g, S,
                           pprev, nb, npairs, npairs, kWideWarps - npairs);
      }
      __syncthreads();
      const int did = rflag[buf];
      swept |= did;
      pend_r = u_spare && did ? r : -1;
      if (did) {
        if constexpr (sizeof(T) == 8) {
          // ---- A' = G^H (A G) and U^T <- G^T U^T on the FP64 tensor
          // cores, each pair's own block of A' from its subproblem
          cols_dmma(A, lda, mp, r, Gr, prot, nb, npairs, 0, kWideWarps);
          if (!u_spare)
            rows_dmma<false>(Ut, m, m, r, Gr, S, prot, nb, npairs, 0,
                             kWideWarps);
          __syncthreads();
          rows_dmma<true>(A, lda, mp, r, Gr, S, prot, nb, npairs, 0,
                          kWideWarps);
        } else {
          // ---- A' = G^H A G as G^H (G^H A)^H, A being Hermitian: the
          // rows of G^H A (and U^T <- G^T U^T), its conjugate transpose in
          // place, and the rows of G^H again, each pair's own block from
          // its subproblem
          row_step<true, false>(A, lda, mp, r, Gr, S, nb, npairs);
          row_step<false, false>(Ut, m, m, r, Gr, S, nb, npairs);
          __syncthreads();
          for (int i = warp; i < mp; i += kWideWarps)
            for (int j = i + lane; j < mp; j += 32) {
              const T x = A[(size_t)i * lda + j];
              A[(size_t)i * lda + j] = conj_of(A[(size_t)j * lda + i]);
              A[(size_t)j * lda + i] = conj_of(x);
            }
          __syncthreads();
          row_step<true, true>(A, lda, mp, r, Gr, S, nb, npairs);
        }
      }
      __syncthreads();
    }
    if (!swept) {
      converged = sweep + 1;
      break;
    }
  }
  if constexpr (sizeof(T) == 8) {
    if (pend_r >= 0) {  // the last round's factors, on every warp
      rows_dmma<false>(Ut, m, m, pend_r, G + (size_t)((rid - 1) & 1) * n_g,
                       S, prot_of + ((rid - 1) & 1) * npairs, nb, npairs, 0,
                       kWideWarps);
      __syncthreads();
    }
  }

  // ascending eigenvalues, U's columns with them
  for (int i = t; i < m; i += kWideThreads) {
    const R wi = re_of(A[(size_t)i * lda + i]);
    int k = 0;
    for (int j = 0; j < m; ++j) {
      const R wj = re_of(A[(size_t)j * lda + j]);
      k += (wj < wi) || (wj == wi && j < i);
    }
    rank[i] = k;
    w_out[k] = wi;
  }
  __syncthreads();
  // one Newton-Schulz step on U (see the note at the top)
  if constexpr (sizeof(T) == 8 && AS) {
    newton_schulz_dmma(Ut, A, lda, wA, m, mp, rank, U_out);
  } else {
    // U into A's storage (row stride m + 1; A's diagonal is read), E =
    // U^H U - I into U^T's, then U - U E / 2, a thread a row i
    // (neighbouring threads, neighbouring rows) and kNS columns
    constexpr int kNS = StepCols<T>::H;
    T* Us = A;
    T* E = Ut;
    const int ldu = m + 1;
    for (int o = t; o < m * m; o += kWideThreads) {
      const int j = o / m, i = o % m;
      Us[(size_t)i * ldu + j] = Ut[o];
    }
    __syncthreads();
    const int njb = (m + kNS - 1) / kNS;
    for (int task = t; task < m * njb; task += kWideThreads) {
      const int i = task % m, j0 = task / m * kNS;
      T e[kNS];
  #pragma unroll
      for (int c = 0; c < kNS; ++c) e[c] = T(R(0));
      for (int l = 0; l < m; ++l) {
        const T u = conj_of(Us[(size_t)l * ldu + i]);
  #pragma unroll
        for (int c = 0; c < kNS; ++c)
          if (j0 + c < m) e[c] = mul_add(u, Us[(size_t)l * ldu + j0 + c], e[c]);
      }
  #pragma unroll
      for (int c = 0; c < kNS; ++c)
        if (j0 + c < m)
          E[(size_t)i * m + j0 + c] = i == j0 + c ? e[c] - T(R(1)) : e[c];
    }
    __syncthreads();
    for (int task = t; task < m * njb; task += kWideThreads) {
      const int i = task % m, j0 = task / m * kNS;
      T e[kNS];
  #pragma unroll
      for (int c = 0; c < kNS; ++c) e[c] = T(R(0));
      for (int l = 0; l < m; ++l) {
        const T u = Us[(size_t)i * ldu + l];
  #pragma unroll
        for (int c = 0; c < kNS; ++c)
          if (j0 + c < m) e[c] = mul_add(u, E[(size_t)l * m + j0 + c], e[c]);
      }
  #pragma unroll
      for (int c = 0; c < kNS; ++c)
        if (j0 + c < m)
          U_out[i * m + rank[j0 + c]] =
              Us[(size_t)i * ldu + j0 + c] - scal(R(0.5), e[c]);
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
          herm_eig_block<T, kThreads>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return (int)e;
    }
    herm_eig_block<T, kThreads><<<batch, kThreads, smem, stream>>>(a, wr, u,
                                                                   conv, m);
    return (int)cudaGetLastError();
  }
  // float32 and complex64 past m = 64 are solved in float64 (complex128)
  // by the wrapper: their U drifted from orthonormal by more than 16 m eps
  // over the sweeps at m = 128
  if constexpr (sizeof(R) == 4) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (work == nullptr) return (int)cudaErrorInvalidValue;
    // static: red and the flags
    constexpr size_t fixed = kWideThreads * sizeof(R) + 64;
    const size_t mp = wide_order(m), npairs = mp / kSub;
    const size_t sg = npairs * (kSubVals + 2 * kGVals) * sizeof(T);
    const size_t a_bytes = mp * wide_lda<T>((int)mp) * sizeof(T);
    // the ranks, and a flag a pair
    const size_t ranks = ((size_t)m + 2 * npairs) * sizeof(int);
    // the subproblems and their factors first (every inner round touches
    // them), then A
    const bool sg_shared = fixed + sg + ranks <= (size_t)kMaxSmem;
    const bool a_shared = sg_shared && fixed + sg + a_bytes + ranks <=
                                           (size_t)kMaxSmem;
    // without S and G, the warps' scratch copies of theirs
    const size_t scratch = (size_t)kWideWarps * (kSubVals + kGVals) * sizeof(T);
    const size_t smem =
        (sg_shared ? sg : scratch) + (a_shared ? a_bytes : 0) + ranks;
    if (smem + fixed > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
    auto kern = a_shared    ? herm_eig_wide<T, true, true>
                : sg_shared ? herm_eig_wide<T, true, false>
                            : herm_eig_wide<T, false, false>;
    if (smem + fixed > (size_t)kDefaultSmem) {
      cudaError_t e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    kern<<<batch, kWideThreads, smem, stream>>>(a, wr, u, conv, m,
                                                static_cast<T*>(work));
    return (int)cudaGetLastError();
  }
}

}  // namespace

// dtype: 0 float64, 1 float32, 4 complex128, 5 complex64 (of A and U; w
// is of the real type).  A holds batch matrices of m x m values, U as
// many, w batch * m values and conv batch ints (sweeps taken, 0 where a
// matrix did not converge).  work (m > 64 only; may be null otherwise)
// holds batch * herm_eig_work_values(m) values of A's type.
// Requires batch >= 1 and m >= 1, and m <= 64 for float32 and complex64.
// Returns the first CUDA error of the launch (0 on success).
extern "C" long long herm_eig_work_values(int m) {
  return m > kMaxDim ? (long long)wide_work_values(m) : 0;
}

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

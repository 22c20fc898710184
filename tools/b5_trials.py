"""Design trials of kernel B5 (``kernels/csrc/fused_update.cu``) on the
card, and the coefficient hand-over's host syncs of a package.

Kernel variants: ``package`` is the package's own build of the current
source (``kernels/_build.py``); each other is the current source with a
few textual replacements (the table ``VARIANTS``; ``bulk`` stages x and y
through a ring of 1-D bulk copies into shared memory, completing on
mbarriers, in place of the registers' loads), or a whole source given
with ``--source NAME=PATH``; each must keep the C interface
``fused_update_launch``.  The script builds every variant with the
package's nvcc flags, one ``nvcc`` per variant, all started together,
into ``build/b5_trials/``; prints each variant's spilling instances; runs
each variant in a process of its own, in turns (the order reversed every
other round): there it launches the variant on the main shapes (float64
and float32 at 4,194,304 x 4, complex128 and complex64 at 4,096,000 x 4,
with all three dots and without) with the partition of
``kernels/fused_update.py``, holds y' and the dots against the plain
version (1e-12 of the largest entry in float64 and complex128, 1e-5
else), checks that a second launch gives the same bits, and times the
launches alone with CUDA events; the times are printed beside the bytes
bound at 3.35 TB/s.

Packages (``--packages ROOT,...``): for each checkout root, in turns and
each in a fresh process, the host syncs of B5 with Python-number
coefficients (float64 and complex128), B1 with a Python-float gamma, one
step of ChebFD's filter and one KPM moment step on laplace3d(160) (torch's
sync debug mode), and B5 through ``ops.fused_axpby_dots`` at the main
shapes with numbers and with card tensors as coefficients: CUDA events
over back-to-back calls, the device time a call from ``torch.profiler``
and the syncs a call.  An earlier commit is unpacked with ``git archive
<commit> | tar -x -C build/parent``.  Run from the root of a checkout, on
a machine with the card:

    python tools/b5_trials.py --variants package,bulk,unroll8 --rounds 2 \\
        --packages build/parent,.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HBM_BYTES_PER_S = 3.35e12
#: (dtype, rows) of the timed shapes, all at width 4
SHAPES = (("float64", 4_194_304), ("float32", 4_194_304),
          ("complex128", 4_096_000), ("complex64", 4_096_000))

#: the ring of bulk copies in place of the registers' loads: x and y of a
#: whole tile (contiguous where the block holds every slot) land in one of
#: BULK_STAGES stages of dynamic shared memory, issued by thread 0
#: BULK_STAGES tiles ahead; the threads read their vectors from there
BULK_STAGES = 3
_BULK_HELPERS = r'''
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)), "r"(1) : "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile("{\n.reg .pred p;\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  }
}
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)), "l"(src), "r"(bytes),
      "r"(smem_addr(bar)) : "memory");
}
constexpr int kStages = %STAGES%;
__host__ __device__ inline int round16(long long v) {
  return (int)((v + 15) / 16 * 16);
}

struct Shape {'''
_BULK_LOOP_OLD = '''    for (long long tile = blockIdx.x; tile < s.ntiles; tile += s.nbx) {
      const long long p0 = tile * step + lane;
      const bool whole = (tile + 1) * step * s.P <= s.e_end;
      A xv[U][V], yv[U][V];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const long long e = (p0 + (long long)u * s.lanes) * s.P + q * V;
        load_entries<A, TX, V>(x, e, s.e_end, whole && s.vec_x, xv[u]);
        load_entries<A, TY, V>(y, e, s.e_end, whole && s.vec_y, yv[u]);
      }'''
_BULK_LOOP_NEW = '''    for (long long tile = blockIdx.x, k = 0; tile < s.ntiles;
         tile += s.nbx, ++k) {
      const long long p0 = tile * step + lane;
      const bool whole = (tile + 1) * step * s.P <= s.e_end;
      const bool use = staged && whole;
      if (use) mbar_wait(&bars[k % kStages], (uint32_t)((k / kStages) & 1));
      A xv[U][V], yv[U][V];
      if (use) {
        unsigned char* st = ring + (k % kStages) * stage;
        const TX* xs = reinterpret_cast<const TX*>(st);
        const TY* ys = reinterpret_cast<const TY*>(st + y_off);
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const long long o = ((long long)u * s.lanes + lane) * s.P + q * V;
          load_entries<A, TX, V>(xs, o, tile_elems, active, xv[u]);
          load_entries<A, TY, V>(ys, o, tile_elems, active, yv[u]);
        }
      } else {
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const long long e = (p0 + (long long)u * s.lanes) * s.P + q * V;
          load_entries<A, TX, V>(x, e, s.e_end, whole && s.vec_x && active,
                                 xv[u]);
          load_entries<A, TY, V>(y, e, s.e_end, whole && s.vec_y && active,
                                 yv[u]);
        }
      }'''
_BULK_PROLOGUE_OLD = '''  if (lane < s.lanes && q < s.Q) {
    A ac[V], bc[V];'''
_BULK_PROLOGUE_NEW = '''  const bool active = lane < s.lanes && q < s.Q;
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t bars[kStages];
  const long long tile_elems = step * s.P;
  const int y_off = round16(tile_elems * (long long)sizeof(TX));
  const int stage = y_off + round16(tile_elems * (long long)sizeof(TY));
  const bool staged = gridDim.y == 1 &&
                      reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(y) % 16 == 0 &&
                      (tile_elems * sizeof(TX)) % 16 == 0 &&
                      (tile_elems * sizeof(TY)) % 16 == 0;
  auto issue = [&](int st, long long tile) {
    const uint32_t xb = (uint32_t)(tile_elems * sizeof(TX));
    const uint32_t yb = (uint32_t)(tile_elems * sizeof(TY));
    mbar_expect(&bars[st], xb + yb);
    bulk_load(ring + st * stage, x + tile * tile_elems, xb, &bars[st]);
    bulk_load(ring + st * stage + y_off, y + tile * tile_elems, yb, &bars[st]);
  };
  if (staged) {
    if (t == 0) {
      for (int st = 0; st < kStages; ++st) mbar_init(&bars[st]);
      asm volatile("fence.mbarrier_init.release.cluster;\\n" ::: "memory");
    }
    __syncthreads();
    if (t == 0)
      for (int st = 0; st < kStages; ++st) {
        const long long tile = blockIdx.x + (long long)st * s.nbx;
        if (tile < s.ntiles && (tile + 1) * step * s.P <= s.e_end)
          issue(st, tile);
      }
  }
  {
    A ac[V], bc[V];'''
_BULK_STORE_OLD = '''        if (whole) {
          *reinterpret_cast<Vec<TO, V>*>(out + e) = o;
        } else {
#pragma unroll
          for (int j = 0; j < V; ++j)
            if (e + j < s.e_end) out[e + j] = o.v[j];
        }
      }
    }
  }'''
_BULK_STORE_NEW = '''        if (!active) continue;
        if (whole) {
          *reinterpret_cast<Vec<TO, V>*>(out + e) = o;
        } else {
#pragma unroll
          for (int j = 0; j < V; ++j)
            if (e + j < s.e_end) out[e + j] = o.v[j];
        }
      }
      if (staged) {
        __syncthreads();
        const long long next = tile + (long long)kStages * s.nbx;
        if (t == 0 && next < s.ntiles && (next + 1) * step * s.P <= s.e_end) {
          asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");
          issue((int)(k % kStages), next);
        }
      }
    }
  }'''
_BULK_COEF_OLD = '''      const int col = (q * V + j) % s.bw;'''
_BULK_COEF_NEW = '''      const int col = ((active ? q : 0) * V + j) % s.bw;'''
_BULK_DOTS_OLD = '''          if constexpr (DOTS) {
            acc[0][j] += dot_term<D>(yn, yn);'''
_BULK_DOTS_NEW = '''          if (DOTS && active) {
            acc[0][j] += dot_term<D>(yn, yn);'''
_BULK_LAUNCH_OLD = '''  kern<<<grid, kThreads, 0, stream>>>('''
_BULK_LAUNCH_NEW = '''  const long long tile_elems = (long long)unroll<V>() * lanes * Pk;
  const int smem = kStages * (round16(tile_elems * (long long)sizeof(TX)) +
                              round16(tile_elems * (long long)sizeof(TY)));
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, kThreads, smem, stream>>>('''
_PREFETCH_OLD = """    for (long long tile = blockIdx.x; tile < s.ntiles; tile += s.nbx) {
      const long long p0 = tile * step + lane;
      const bool whole = (tile + 1) * step * s.P <= s.e_end;
      A xv[U][V], yv[U][V];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const long long e = (p0 + (long long)u * s.lanes) * s.P + q * V;
        load_entries<A, TX, V>(x, e, s.e_end, whole && s.vec_x, xv[u]);
        load_entries<A, TY, V>(y, e, s.e_end, whole && s.vec_y, yv[u]);
      }"""
_PREFETCH_NEW = """    // the next tile's vectors load while this tile's are used
    A xv[U][V], yv[U][V];
    auto load_tile = [&](long long tile, A (&xs)[U][V], A (&ys)[U][V]) {
      const long long p0 = tile * step + lane;
      const bool whole = (tile + 1) * step * s.P <= s.e_end;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const long long e = (p0 + (long long)u * s.lanes) * s.P + q * V;
        load_entries<A, TX, V>(x, e, s.e_end, whole && s.vec_x, xs[u]);
        load_entries<A, TY, V>(y, e, s.e_end, whole && s.vec_y, ys[u]);
      }
    };
    if (blockIdx.x < s.ntiles) load_tile(blockIdx.x, xv, yv);
    for (long long tile = blockIdx.x; tile < s.ntiles; tile += s.nbx) {
      const long long p0 = tile * step + lane;
      const bool whole = (tile + 1) * step * s.P <= s.e_end;
      A xn[U][V], yn2[U][V];
      if (tile + s.nbx < s.ntiles) load_tile(tile + s.nbx, xn, yn2);"""
_PREFETCH_TAIL_OLD = """          for (int j = 0; j < V; ++j)
            if (e + j < s.e_end) out[e + j] = o.v[j];
        }
      }
    }
  }"""
_PREFETCH_TAIL_NEW = """          for (int j = 0; j < V; ++j)
            if (e + j < s.e_end) out[e + j] = o.v[j];
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int j = 0; j < V; ++j) {
          xv[u][j] = xn[u][j];
          yv[u][j] = yn2[u][j];
        }
    }
  }"""
_BULK = [("\nstruct Shape {", _BULK_HELPERS.replace("%STAGES%",
                                                   str(BULK_STAGES))),
         (_BULK_PROLOGUE_OLD, _BULK_PROLOGUE_NEW),
         (_BULK_COEF_OLD, _BULK_COEF_NEW),
         (_BULK_LOOP_OLD, _BULK_LOOP_NEW),
         (_BULK_DOTS_OLD, _BULK_DOTS_NEW),
         (_BULK_STORE_OLD, _BULK_STORE_NEW),
         (_BULK_LAUNCH_OLD, _BULK_LAUNCH_NEW)]
_LEAN = [("""  __threadfence();
  __syncthreads();
  if (t == 0) {
    __threadfence();   // the block's partial""", """  __syncthreads();
  if (t == 0) {
    __threadfence();   // the block's partial"""),
         ("""  __threadfence();
  __syncthreads();
  if (t == 0) {
    __threadfence();
    last = atomicAdd(&counters[s.ngroups]""", """  __syncthreads();
  if (t == 0) {
    __threadfence();
    last = atomicAdd(&counters[s.ngroups]""")]
_WARP_GROUP_OLD = """  for (int o = t; o < 3 * s.P; o += kThreads) {
    D v = D(0);
#pragma unroll 8
    for (int bb = b0; bb < b1; ++bb)
      v += ld_part(part + (long long)bb * 3 * P + o);
    gpart[(long long)group * 3 * P + o] = v;
  }"""
_WARP_GROUP_NEW = """  if (3 * s.P <= 64) {    // a warp an entry: lane l holds block b0 + l
    const int w = t / kWarp, l = t % kWarp;
    for (int o = w; o < 3 * s.P; o += kThreads / kWarp) {
      D v = b0 + l < b1 ? ld_part(part + (long long)(b0 + l) * 3 * P + o)
                        : D(0);
      for (int m = kWarp / 2; m > 0; m /= 2) v += shfl_xor(v, m);
      if (l == 0) gpart[(long long)group * 3 * P + o] = v;
    }
  } else {
  for (int o = t; o < 3 * s.P; o += kThreads) {
    D v = D(0);
#pragma unroll 8
    for (int bb = b0; bb < b1; ++bb)
      v += ld_part(part + (long long)bb * 3 * P + o);
    gpart[(long long)group * 3 * P + o] = v;
  }
  }"""
_WARP_FINAL_OLD = """  for (int o = t; o < 3 * s.bw; o += kThreads) {
    const int d = o / s.bw, col = o % s.bw;
    D v = D(0);
    for (int k = col; k < s.P; k += s.bw) {
#pragma unroll 8
      for (int g = 0; g < s.ngroups; ++g)
        v += ld_part(gpart + ((long long)g * 3 + d) * P + k);
    }"""
_WARP_FINAL_NEW = """  const bool by_warp = 3 * s.bw <= 64;
  const int step_o = by_warp ? kThreads / kWarp : kThreads;
  for (int o = by_warp ? t / kWarp : t; o < 3 * s.bw; o += step_o) {
    const int d = o / s.bw, col = o % s.bw;
    D v = D(0);
    if (by_warp) {   // lane l sums (offset, group) pairs l, l + 32, ...
      const int l = t % kWarp, pairs = (s.P / s.bw) * s.ngroups;
      for (int i = l; i < pairs; i += kWarp)
        v += ld_part(gpart + ((long long)(i % s.ngroups) * 3 + d) * P +
                     col + (i / s.ngroups) * s.bw);
      for (int m = kWarp / 2; m > 0; m /= 2) v += shfl_xor(v, m);
      if (l != 0) continue;
    } else {
    for (int k = col; k < s.P; k += s.bw) {
#pragma unroll 8
      for (int g = 0; g < s.ngroups; ++g)
        v += ld_part(gpart + ((long long)g * 3 + d) * P + k);
    }
    }"""

#: name -> replacements (old, new) applied to the current source; each old
#: text must occur in it
VARIANTS = {
    "current": [],
    # twice the periods in flight a thread
    "unroll8": [("  return V == 8 ? 2 : 4;", "  return V == 8 ? 4 : 8;")],
    # four blocks an SM (64 registers a thread: the first design)
    "blocks4": [("  return 2;", "  return V == 8 ? 3 : 4;")],
    "bulk": _BULK,
    "bulk_4stages": [(old, new.replace("kStages = 3;", "kStages = 4;"))
                     for old, new in _BULK],
    # register double-buffering: tile k + 1's loads in flight over tile k
    "prefetch": [(_PREFETCH_OLD, _PREFETCH_NEW),
                 (_PREFETCH_TAIL_OLD, _PREFETCH_TAIL_NEW)],
    # one fence less a level: the partials' writers fence no more before
    # the barrier, thread 0 fences after it
    "lean": _LEAN,
    # and a warp an entry at both finishing levels where 3 P <= 64
    "lean_warp": _LEAN + [(_WARP_GROUP_OLD, _WARP_GROUP_NEW),
                          (_WARP_FINAL_OLD, _WARP_FINAL_NEW)],
    # timing probes (their dots are wrong): the block partials without
    # the two finishing levels, and the loop alone without the partials
    "probe_no_finish": [("  // the last block of the group to finish sums",
                         "  if (s.flags >= 0) return;\n"
                         "  // the last block of the group to finish sums")],
    "probe_no_partial": [("  __shared__ D sh[3][kThreads * V];\n",
                          "  __shared__ D sh[3][kThreads * V];\n"
                          "  if (s.flags >= 0) return;\n")],
}
#: blocks an SM a variant's launch bounds keep room for, where it differs
#: from the wrapper's: the blocks along x are at most this times 132
PER_SM = {"blocks4": 4}


# ------------------------------------------------------------ a package
def package_run(root: str) -> None:
    """The syncs and B5 timings of the package under ``root`` (printed
    as ``[b5 package]`` lines); runs in its own process."""
    sys.path.insert(0, str(Path(root).resolve() / "src"))
    import numpy as np
    import torch
    from repro_torch.core import SpmvOpts, from_coo
    from repro_torch.kernels.ops import fused_axpby_dots, sellcs_spmv
    from repro_torch.matrices import laplace3d
    from repro_torch.solvers import make_operator
    from repro_torch.solvers.chebfd import _cheb_filter

    def time_ms(fn, warmup=20, iters=100):
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        for _ in range(iters):
            fn()
        ev[1].record()
        ev[1].synchronize()
        return ev[0].elapsed_time(ev[1]) / iters

    def syncs(fn, calls=1):
        fn()
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            for _ in range(calls):
                fn()
            torch.cuda.set_sync_debug_mode("default")
        return sum("synchroniz" in str(w.message)
                   and "prototype" not in str(w.message)
                   for w in caught) / calls

    def device_ms(fn, iters=20):
        from torch.profiler import ProfilerActivity, profile
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total = sum(e.time_range.end - e.time_range.start
                    for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and "axpby" in e.name)
        return total * 1e-3 / iters if total else None

    tag = f"[b5 package] {root}"
    r, c, v, n = laplace3d(160)
    kw = dict(C=32, sigma=1024, device="cuda")
    A64 = from_coo(r, c, v, (n, n), dtype=np.float64, **kw)
    A16 = from_coo(r, c, v, (n, n), dtype=np.float32,
                   store_dtype=torch.bfloat16, **kw)
    g = torch.Generator(device="cuda").manual_seed(21)
    m = A64.nrows_pad
    x4, y4 = (torch.randn(m, 4, generator=g, dtype=torch.float64,
                          device="cuda") for _ in range(2))
    xc, yc = (torch.randn(m, 4, generator=g, dtype=torch.complex128,
                          device="cuda") for _ in range(2))
    V = torch.randn(m, 8, generator=g, dtype=torch.float64, device="cuda")
    w = torch.randn(m, 4, generator=g, dtype=torch.float32, device="cuda")
    mu = torch.ones(4, dtype=torch.float32, device="cuda")
    op64, op16 = make_operator(A64), make_operator(A16)

    def kpm_step():        # kpm.moment_step, written out for any package
        w2, _, d = op16.mv_fused(w, y=w, opts=SpmvOpts(
            alpha=1 / 3, beta=-1.0, gamma=6.0, dot_yy=True, dot_xy=True))
        return w2, 2.0 * d[1].to(mu.dtype) - mu, 2.0 * d[0].to(mu.dtype) - mu

    dots = dict(dot_yy=True, dot_xy=True, dot_xx=True)
    counts = {
        "B5 f64 numbers": syncs(lambda: fused_axpby_dots(x4, y4, 0.75, -0.5,
                                                         **dots)),
        "B5 complex128 numbers": syncs(lambda: fused_axpby_dots(
            xc, yc, 0.5 - 1.5j, -1.0 + 0.25j, **dots)),
        "B1 Python-float gamma, b=8": syncs(lambda: sellcs_spmv(
            A64, V, opts=SpmvOpts(alpha=1 / 6, gamma=6.0))),
        "ChebFD filter step, b=8": syncs(lambda: _cheb_filter(
            op64, V, 2, 6.0, 6.0, 1.0, 2.0)),
        "KPM moment step, 4 probes": syncs(kpm_step),
    }
    print(f"{tag} host syncs a call: {json.dumps(counts)}", flush=True)
    del A64, A16, op64, op16, x4, y4, xc, yc, V, w
    for name, rows in SHAPES:
        dt = getattr(torch, name)
        x, y = (torch.randn(rows, 4, generator=g, dtype=dt, device="cuda")
                for _ in range(2))
        num = (0.5 - 1.5j, -1.0 + 0.25j) if dt.is_complex else (0.75, -0.5)
        tens = tuple(torch.full((4,), v, dtype=dt, device="cuda")
                     for v in num)
        bound = 1e3 * 3 * x.numel() * x.element_size() / HBM_BYTES_PER_S
        for kind, (a, b) in (("numbers", num), ("card tensors", tens)):
            for fl_name, fl in (("all dots", dots), ("no dots", {})):
                fn = lambda: fused_axpby_dots(x, y, a, b, **fl)  # noqa: E731
                ms = time_ms(fn)
                dev = device_ms(fn)
                dev_text = "not measured" if dev is None else f"{dev:.4f}"
                print(f"{tag} {name} {rows}x4 {kind} {fl_name}: events "
                      f"{ms:.4f} ms, device {dev_text} ms a call, bound "
                      f"{bound:.4f} ms, syncs a call {syncs(fn, 5):.2f}",
                      flush=True)
        del x, y


# ------------------------------------------------------------ variants
def build(sources: dict) -> None:
    """Compile each variant's source into ``build/b5_trials/``."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke  # noqa: F401  (puts src/ on the path)
    from repro_torch.kernels import _build
    out = ROOT / "build" / "b5_trials"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        src = out / f"fused_update_{name}.cu"
        src.write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
             "-o", str(out / f"lib_{name}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"{name}: nvcc exited {proc.returncode}\n{log}")
        spills = [line.strip() for line in log.splitlines()
                  if "spill" in line and " 0 bytes spill stores" not in line]
        print(f"[ptxas] {name}: {len(spills)} instances spill"
              + (f", the most {max(spills, key=lambda l: int(l.split()[4]))}"
                 if spills else ""))


def launcher(fn, x, y, a, b, flags, per_sm=None):
    """A launch of ``fn`` computing y' = a x + b y (and the dots) into
    buffers made once, and the result; the partition is the wrapper's,
    with at most ``per_sm`` x 132 blocks along x where given."""
    import torch
    from repro_torch.core.spmv import storage_acc_dtype
    from repro_torch.kernels import fused_update as b5
    from repro_torch.kernels.tsmttsm import DTYPE_CODES
    n, bw = x.shape
    acc = storage_acc_dtype(x.dtype)
    p = b5.partition(n, bw, x.dtype)
    if per_sm is not None:
        nbx = min(p.ntiles, -(-b5.SMS * per_sm // p.slot_tiles))
        p = p._replace(nbx=nbx, ngroups=-(-nbx // b5.GROUP))
    out = torch.empty_like(x)
    dd = torch.complex128 if acc.is_complex else acc
    part = torch.full(((p.nbx + p.ngroups) * 3 * p.period,), float("nan"),
                      dtype=dd, device="cuda")
    gpart = part[p.nbx * 3 * p.period:]
    counters = torch.zeros(64, dtype=torch.int32, device="cuda")
    dots = torch.empty((3, bw), dtype=acc, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    args = (DTYPE_CODES[x.dtype], DTYPE_CODES[y.dtype], x.data_ptr(),
            y.data_ptr(), None, 0, a.real, a.imag, None, 0, b.real, b.imag,
            out.data_ptr(), *((part.data_ptr(), gpart.data_ptr(),
                               counters.data_ptr(), dots.data_ptr())
                              if flags else (None,) * 4),
            n, bw, p.period, p.slot_tiles, p.nbx, flags, stream)

    # the kernel writes through raw pointers: the tensors must outlive
    # every launch, or the allocator hands their memory on
    def launch(_alive=(out, part, counters, dots)):
        rc = fn(*args)
        if rc:
            raise RuntimeError(f"launch failed with CUDA error {rc}")
    return launch, lambda: (out.clone(), dots.clone() if flags else None)


def variant_run(name: str, iters: int) -> None:
    """One variant's built library, alone in this process: each shape
    held to the plain version and to a second launch, then timed;
    printed as one JSON line."""
    import torch
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from repro_torch.kernels import fused_update as b5
    from repro_torch.kernels.ref import fused_axpby_dots_ref
    from repro_torch.kernels import _build
    lib = (_build.load("fused_update") if name == "package" else
           ctypes.CDLL(str(ROOT / "build" / "b5_trials" / f"lib_{name}.so")))
    fn = lib.fused_update_launch
    fn.argtypes, fn.restype = b5._ARGTYPES, ctypes.c_int
    g = torch.Generator(device="cuda").manual_seed(5)
    times = {}
    for dname, rows in SHAPES:
        dt = getattr(torch, dname)
        x, y = (torch.randn(rows, 4, generator=g, dtype=dt, device="cuda")
                for _ in range(2))
        coef = (0.5 - 1.5j, -1.0 + 0.25j) if dt.is_complex else (0.75, -0.5)
        wide = torch.complex128 if dt.is_complex else torch.float64
        want, wdots = fused_axpby_dots_ref(
            x.to(wide), y.to(wide), *coef, dot_yy=True, dot_xy=True,
            dot_xx=True)
        tol = 1e-12 if dt in (torch.float64, torch.complex128) else 1e-5
        for flags in (7, 0):
            call, result = launcher(fn, x, y, *(complex(v) for v in coef),
                                    flags, PER_SM.get(name))
            call()
            got, d = result()
            call()
            again, d2 = result()
            torch.cuda.synchronize()
            err = chip_smoke.rel_err(got, want)
            derr = chip_smoke.rel_err(d, wdots) if flags else 0.0
            err2 = chip_smoke.rel_err(again, want)
            derr2 = chip_smoke.rel_err(d2, wdots) if flags else 0.0
            if not (torch.equal(got, again) and (
                    d is None or torch.equal(d, d2))) or max(
                        err, derr, err2, derr2) > tol:
                print(f"[b5 variant] {name} {dname} flags {flags}: launch 1 "
                      f"y' {err:.3e} dots {derr:.3e}, launch 2 y' "
                      f"{err2:.3e} dots {derr2:.3e} off the plain version",
                      flush=True)
            times[f"{dname} {'all dots' if flags else 'no dots'}"] = (
                chip_smoke.time_ms(call, iters=iters))
        del x, y, want, wdots
    print("[b5 variant] " + json.dumps({"name": name, "ms": times}),
          flush=True)


def variants(a, card) -> None:
    from repro_torch.kernels import _build
    text = (_build.CSRC / "fused_update.cu").read_text()
    sources = {}
    for name in a.variants.split(","):
        if name == "package":   # the package's own build of the source
            continue
        t = text
        for old, new in VARIANTS[name]:
            if old not in t:
                sys.exit(f"{name}: {old!r} is not in the source")
            t = t.replace(old, new)
        sources[name] = t
    for spec in a.source:
        name, path = spec.split("=", 1)
        sources[name] = Path(path).read_text()
    build(sources)
    names, ms = a.variants.split(",") + list(sources)[len(
        [n for n in a.variants.split(",") if n != "package"]):], {}
    for rnd in range(a.rounds):
        for name in names if rnd % 2 == 0 else names[::-1]:
            out = subprocess.run(
                [sys.executable, __file__, "--variant-run", name,
                 "--iters", str(a.iters)], check=True, stdout=subprocess.PIPE,
                text=True).stdout
            print("\n".join(line for line in out.splitlines()
                            if "off the plain version" in line), flush=True)
            row = json.loads("{" + out.split("[b5 variant] {", 1)[1])
            for case, t in row["ms"].items():
                ms.setdefault(case, {}).setdefault(name, []).append(t)
    for dname, rows in SHAPES:
        elem = {"float64": 8, "float32": 4, "complex128": 16,
                "complex64": 8}[dname]
        bound = 1e3 * 3 * rows * 4 * elem / HBM_BYTES_PER_S
        for kind in ("all dots", "no dots"):
            case = f"{dname} {kind}"
            print(f"[b5] {dname} {rows}x4 {kind} (bound {bound:.4f} ms): "
                  + "  ".join(f"{name} " + "/".join(
                      f"{t:.4f}" for t in ms[case][name]) for name in names)
                  + f" ms  [{card}]", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default="",
                    help="comma-separated names of VARIANTS")
    ap.add_argument("--source", action="append", default=[],
                    help="NAME=PATH: a whole source as one more variant")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--packages", default="",
                    help="comma-separated checkout roots, run in turns "
                         "(each twice, the order reversed the second time)")
    ap.add_argument("--package-run", help=argparse.SUPPRESS)
    ap.add_argument("--variant-run", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.package_run:
        package_run(a.package_run)
        return 0
    if a.variant_run:
        variant_run(a.variant_run, a.iters)
        return 0
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    card = chip_smoke.phase_environment()
    if a.variants or a.source:
        variants(a, card)
    roots = [r for r in a.packages.split(",") if r]
    for root in roots + roots[::-1]:
        subprocess.run([sys.executable, __file__, "--package-run", root],
                       check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Design trials of kernel B6 (``src/repro_torch/kernels/csrc/mamba_scan.cu``)
on the card, at the jamba prefill's shape (B 4, S 4096, d_inner 16384,
N 16).

Each variant is the current source with a few textual replacements (the
table ``VARIANTS``), or a whole source given with ``--source NAME=PATH``
(for instance an earlier commit's file, unpacked with ``git show``).  The
script builds every variant with the package's nvcc flags, one ``nvcc``
per variant, all started together, into ``build/b6_trials/``; prints each
template instance's registers and spills and the instructions per state
update of its hot loop (``cuobjdump -sass``); holds each variant's output
at the main shape against the float64 plain version within
``kernels/mamba_scan.py:error_bound``; and times the variants in turns
(the order reversed every other round) with CUDA events.  ``--mufu``
also times ex2.approx.ftz alone (``MUFU_SOURCE``), the rate the SFU bound
assumes.  Run from the root of a checkout, on a machine with the card:

    python tools/b6_trials.py --variants current,expf,lanes2 \\
        --source parent=build/parent_mamba_scan.cu --rounds 4
"""
from __future__ import annotations

import argparse
import ctypes
import re
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (puts src/ on the path)
from repro_torch.kernels import _build  # noqa: E402
from tools import trials  # noqa: E402

OUT = ROOT / "build" / "b6_trials"
#: name -> replacements (old, new) applied to the current source; each old
#: text must occur in it
VARIANTS = {
    "current": [],
    # the accurate expf of the earlier kernel, on the new structure
    "expf": [("ex2(dt * a2[j])", "expf(dt * a2[j])"),
             (" * 1.4426950408889634f", "")],
    "noftz": [('"ex2.approx.ftz.f32', '"ex2.approx.f32')],
    "lanes2": [("if (N <= 16) return launch<1, 16>",
                "if (N <= 16) return launch<2, 8>")],
    "lanes2u4": [("if (N <= 16) return launch<1, 16>",
                  "if (N <= 16) return launch<2, 8>"),
                 ("#pragma unroll 8", "#pragma unroll 4")],
    "lanes2u2": [("if (N <= 16) return launch<1, 16>",
                  "if (N <= 16) return launch<2, 8>"),
                 ("#pragma unroll 8", "#pragma unroll 2")],
    "unroll4": [("#pragma unroll 8", "#pragma unroll 4")],
    "unroll16": [("#pragma unroll 8", "#pragma unroll 16")],
    "tile8": [("return LANES <= 8 ? 16 : 16 * 8 / LANES;",
               "return LANES <= 8 ? 8 : 8 * 8 / LANES;")],
    "oneacc": [("acc[k & 1] = fmaf(h[j], cv[k], acc[k & 1]);",
                "acc[0] = fmaf(h[j], cv[k], acc[0]);")],
    # blocks of two warps
    # (32 lanes of 16 states would leave two channels a block: 16 of 32)
    "threads64": [("constexpr int kThreads = 128;", "constexpr int kThreads = 64;"),
                  ("kThreads, NPL > 8 ? 4 : 8", "kThreads, NPL > 8 ? 8 : 16"),
                  ("return launch<32, 16>(", "return launch<16, 32>(")],
    # the next stage's rows of dt and xc prefetched into L2 one stage ahead
    # of their copy
    "l2pf": [('    asm volatile("cp.async.commit_group;" ::: "memory");\n  };',
              """    for (int i = threadIdx.x; i < 2 * kTile * (CH / 32); i += kThreads) {
      const int r = i % (kTile * (CH / 32)), t = r / (CH / 32);
      const int q = 32 * (r % (CH / 32));
      const float* p = (i < kTile * (CH / 32) ? db : xb)
                       + (long long)(kTile + t) * di + q;
      if (s0 + kTile + t < S && q < nch)
        asm volatile("prefetch.global.L2 [%0];" :: "l"(p));
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };""")],
    # dt and xc of a group of 8 timesteps read from shared memory first
    "grouploads": [("""#pragma unroll 8
      for (int t = 0; t < kTile; ++t) {
        const float v = step<LANES, NPL>(h, a2, dp[t * CH], xp[t * CH],
                                         bt + t * NS, ct + t * NS);
        if (store) *py = ADD ? *py + v : v;
        py += di;
      }""", """#pragma unroll 1
      for (int t0 = 0; t0 < kTile; t0 += 8) {
        float dv[8], xv[8];
#pragma unroll
        for (int u = 0; u < 8; ++u)
          dv[u] = dp[(t0 + u) * CH], xv[u] = xp[(t0 + u) * CH];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int t = t0 + u;
          const float v = step<LANES, NPL>(h, a2, dv[u], xv[u],
                                           bt + t * NS, ct + t * NS);
          if (store) *py = ADD ? *py + v : v;
          py += di;
        }
      }""")],
    # ablations (wrong results, not checked): no copy of dt and xc (the
    # hot loop's instructions unchanged, their operands stale); the
    # exponentials alone (an FFMA, the MUFU and an FADD a state); every
    # step but with an FMUL in place of the MUFU
    "exponly": [("""      h[j] = fmaf(ex2(dt * a2[j]), h[j], dtx * bv[k]);
      acc[k & 1] = fmaf(h[j], cv[k], acc[k & 1]);""",
                 """      h[j] = ex2(fmaf(dt, a2[j], h[j]));
      acc[k & 1] += h[j];""")],
    "nomufu": [('asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));',
                "r = x * 0.5f;")],
    "nocopy": [("""          cp_async16(&sd[buf][t][q], db + (long long)t * di + q);
          cp_async16(&sx[buf][t][q], xb + (long long)t * di + q);""", "")],
}
ABLATIONS = {"nocopy", "exponly", "nomufu"}

#: the rate of MUFU.EX2 alone (``--mufu``): every thread of a full card
#: (16 blocks of 128 threads an SM) runs 8 independent chains x <- 2^(x c),
#: an FMUL and a MUFU each, as many exponentials as B6 at its main shape
MUFU_SOURCE = r"""
#include <cuda_runtime.h>
__global__ void __launch_bounds__(128, 16) mufu_chains(float* out,
                                                       long long iters) {
  float x[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) x[k] = -1e-3f * (threadIdx.x + k);
  for (long long i = 0; i < iters; ++i) {
#pragma unroll
    for (int k = 0; k < 8; ++k)
      asm volatile("ex2.approx.ftz.f32 %0, %1;" : "=f"(x[k]) : "f"(x[k] * -0.5f));
  }
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k) s += x[k];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int mufu_rate_launch(void* out, long long iters, int blocks,
                                void* stream) {
  mufu_chains<<<blocks, 128, 0, (cudaStream_t)stream>>>((float*)out, iters);
  return (int)cudaGetLastError();
}
"""


def _sources(names, extra):
    base = (_build.CSRC / "mamba_scan.cu").read_text()
    out = {name: trials.apply(base, VARIANTS[name], f"variant {name}")
           for name in names}
    for spec in extra:
        name, path = spec.split("=", 1)
        out[name] = Path(path).read_text()
    return out


def _build_all(sources):
    built = trials.build(OUT, {name: (src, None)
                               for name, src in sources.items()})
    libs = {}
    for name, (lib, log) in built.items():
        trials.report(name, log, chip_smoke.SCAN_INSTANCE,
                      lambda m: "mamba_scan_rows<" + ",".join(
                          g for g in m.groups() if g) + ">")
        for inst, (n, mufu, hist) in chip_smoke.sass_hot_loop(lib).items():
            mix = ", ".join(f"{op} {k}" for op, k in
                            sorted(hist.items(), key=lambda kv: -kv[1]))
            print(f"[sass] {name} mamba_scan_rows{inst}: {n} instructions "
                  f"for {mufu} MUFU.EX2 = {n / max(mufu, 1):.2f} per state "
                  f"update ({mix})")
        libs[name] = trials.entry(lib, "mamba_scan_launch",
                                  [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                                  + [ctypes.c_void_p])
    return libs


def _mufu_rate(card, nexp):
    """Times ``MUFU_SOURCE`` for ``nexp`` exponentials; prints them per
    clock per SM at the SM clock sampled meanwhile."""
    lib, _ = trials.build(OUT, {"mufu_rate": (MUFU_SOURCE, None)})[
        "mufu_rate"]
    fn = trials.entry(lib, "mufu_rate_launch",
                      [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_void_p])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = 16 * sms
    iters = nexp // (blocks * 128 * 8)
    out = torch.empty(blocks * 128, device="cuda")

    def run():
        if fn(out.data_ptr(), iters, blocks,
              torch.cuda.current_stream().cuda_stream) != 0:
            raise RuntimeError("mufu_rate launch failed")
    with chip_smoke.ClockSampler() as sampler:
        t0 = chip_smoke.time.perf_counter()
        ms = chip_smoke.time_ms(run, warmup=3, iters=20)
        note = sampler.during(t0, chip_smoke.time.perf_counter())
    clocks = [float(c) for c in re.findall(r"SM clock (\d+)-(\d+)", note)[0]]
    n = blocks * 128 * 8 * iters
    print(f"[mufu] {n} ex2.approx.ftz.f32 in 8 chains a thread, 16 blocks "
          f"of 128 threads an SM: {ms:.4f} ms, "
          f"{n / (ms * 1e-3 * sms * max(clocks) * 1e6):.2f}-"
          f"{n / (ms * 1e-3 * sms * min(clocks) * 1e6):.2f} per clock per "
          f"SM; {note}  [{card}]")


def _run(fn, args, y):
    B, S, di = args[0].shape
    rc = fn(*(t.data_ptr() for t in args), y.data_ptr(), B, S, di,
            args[4].shape[1], torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"launch failed with CUDA error {rc}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default="current",
                    help=f"comma-separated, of {sorted(VARIANTS)}")
    ap.add_argument("--source", action="append", default=[],
                    help="NAME=PATH: a whole source as a further variant")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--mufu", action="store_true",
                    help="also time MUFU.EX2 alone (MUFU_SOURCE)")
    opts = ap.parse_args()
    card = trials.card()
    print(card)
    libs = _build_all(_sources([v for v in opts.variants.split(",") if v],
                               opts.source))
    B, S, di, N = 4, 4096, 16384, 16
    if opts.mufu:
        _mufu_rate(card, B * S * di * N)
    args = list(chip_smoke._b6_inputs(B, S, di, N, seed=21))
    args[0] = args[0].clamp(max=1.0)          # dt as the model has it
    want = chip_smoke.mamba_scan_ref(*(a.double() for a in args))
    bound = chip_smoke.scan_error_bound(*args)
    y = torch.empty((B, S, di), dtype=torch.float32, device="cuda")
    for name, fn in libs.items():
        if name in ABLATIONS:
            continue
        y.fill_(float("nan"))
        _run(fn, args, y)
        ratio = float(((y.double() - want).abs() / bound).max())
        print(f"[check] {name}: error {ratio:.4f} of error_bound")
        if not ratio <= 1.0:
            raise SystemExit(f"variant {name} outside its bound")
    del want, bound
    clocks = {}
    with chip_smoke.ClockSampler() as sampler:
        def timed(name, **kw):
            t0 = chip_smoke.time.perf_counter()
            ms = chip_smoke.time_ms(lambda: _run(libs[name], args, y), **kw)
            clocks[name] = sampler.during(t0, chip_smoke.time.perf_counter())
            return ms
        times = trials.in_turns({name: name for name in libs}, opts.rounds,
                                timed, warmup=3, iters=20)
    for name, ts in times.items():
        print(f"[time] {name}{' (ablation)' if name in ABLATIONS else ''}: "
              f"{trials.times_text(ts)}; last window: {clocks[name]}  "
              f"[{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())

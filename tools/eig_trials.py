"""Design trials of the port's wide eigensolver instance
(``src/repro_torch/kernels/csrc/herm_eig.cu``, m > 64) on the card, at the
width-128 block CG's order.

Each variant is the current source with a few textual replacements (the
table ``VARIANTS``).  The script builds every variant with the package's
nvcc flags, one ``nvcc`` per variant, all started together, into
``build/eig_trials/``; prints the wide instances' registers and spills;
holds each variant's eigenvalues on a Gram matrix of order ``--m`` (float64
and complex128) against ``torch.linalg.eigvalsh`` within 4 m eps ||A||_F
and its U's ||U^H U - I||_F within 16 m eps (ablations, which compute
wrong results on purpose, are timed only); and times the variants in
turns (the order reversed every other round) with CUDA events.  Run from
the root of a checkout, on a machine with the card:

    python tools/eig_trials.py --variants current,fixed,noA,noU --m 128
"""
from __future__ import annotations

import argparse
import ctypes
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (puts src/ on the path)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import herm_eig as he  # noqa: E402
from repro_torch.kernels.tsmttsm import DTYPE_CODES  # noqa: E402
from tools import trials  # noqa: E402

OUT = ROOT / "build" / "eig_trials"
#: name -> replacements (old, new) applied to the current source; each old
#: text must occur in it
FIXED_SWEEPS = 11
FIXED = [("    if (!swept) {\n      converged = sweep + 1;",
          "    if (sweep + 1 == %d) {\n      converged = sweep + 1;"
          % FIXED_SWEEPS)]
VARIANTS = {
    "current": [],
    # the ablations below run exactly FIXED_SWEEPS sweeps (a block-CG Gram
    # at m = 128 takes 11), and "fixed" is the current source so held
    "fixed": FIXED,
    # instrumentation (timed, but its U is wrong): thread 0 prints the
    # clock cycles of each phase, summed over the rounds
    "prof": [("#include <float.h>\n", "#include <float.h>\n#include <cstdio>\n"),
             ("  int converged = 0;  // the sweeps it took (the last rotating none), or 0\n  int rid = 0;",
              "  long long c_s = 0, c_c = 0, c_r = 0, c_x = clock64(), c_t;\n"
              "  int converged = 0;  // the sweeps it took (the last rotating none), or 0\n  int rid = 0;"),
             ("      if (t == 0) rflag[buf ^ 1] = 0;  // the round before's, read by all",
              "      c_t = clock64();\n      if (t == 0) rflag[buf ^ 1] = 0;  // the round before's, read by all"),
             ("      const int did = rflag[buf];\n",
              "      const int did = rflag[buf];\n      c_s += clock64() - c_t; c_t = clock64();\n"),
             ("          __syncthreads();\n          rows_dmma<true>(A, lda, mp, r, Gr, S, prot, nb, npairs, 0,\n                          kWideWarps);",
              "          __syncthreads();\n          c_c += clock64() - c_t; c_t = clock64();\n"
              "          rows_dmma<true>(A, lda, mp, r, Gr, S, prot, nb, npairs, 0,\n                          kWideWarps);\n"
              "          __syncthreads();\n          c_r += clock64() - c_t;"),
             ("  if (t == 0) conv_out[blockIdx.x] = converged;\n}\n\ntemplate <typename T>\nint launch(",
              "  if (t == 0 && blockIdx.x == 0) printf(\"[prof] cycles: subproblems %lld, cols+U %lld, rows %lld, all %lld\\n\", c_s, c_c, c_r, clock64() - c_x);\n"
              "  if (t == 0) conv_out[blockIdx.x] = converged;\n}\n\ntemplate <typename T>\nint launch(")],
    # 256 or 512 threads (no, or eight, warps spare to update U while eight
    # solve)
    "t256": [("constexpr int kWideThreads = 384;", "constexpr int kWideThreads = 256;")],
    "t512": [("constexpr int kWideThreads = 384;", "constexpr int kWideThreads = 512;")],
    # ablation: no products of A or U with the pairs' factors
    "noA": FIXED + [("      if (did) {\n        if constexpr (sizeof(T) == 8) {",
                     "      if (false) {\n        if constexpr (sizeof(T) == 8) {"),
                    ("        if (u_spare && pend_r >= 0)", "        if (false)")],
    # ablation: no updates of U
    "noU": FIXED + [("        if (u_spare && pend_r >= 0)", "        if (false)"),
                    ("          if (!u_spare)\n", "          if (false)\n"),
                    ("    if (pend_r >= 0) {  // the last", "    if (false) {  // the last"),
                    ("          row_step<false, false>(Ut, m, m, r, Gr, S, nb, npairs);\n", "")],
    # ablation: no inner rounds (every round still updates A and U)
    "noinner": FIXED + [("        for (int ir = 0; ir < kSub - 1; ++ir) {",
                         "        for (int ir = 0; ir < 0; ++ir) {"),
                        ("          prot[kp] = any != 0;\n          if (any) rflag[buf] = 1;",
                         "          prot[kp] = 1;\n          rflag[buf] = 1;")],
    # ablation: no Newton-Schulz step
    "noNS": [("  for (int task = t; task < m * njb; task += kWideThreads) {",
              "  for (int task = t; task < 0; task += kWideThreads) {")],
}
ABLATIONS = {"noA", "noU", "noinner", "noNS"}


def _build_all(names):
    base = (_build.CSRC / "herm_eig.cu").read_text()
    sources = {name: (trials.apply(base, VARIANTS[name], f"variant {name}"),
                      _build.CSRC) for name in names}
    libs = {}
    for name, (lib, log) in trials.build(OUT, sources).items():
        trials.report(name, log, r"(herm_eig_wide)I")
        libs[name] = trials.entry(
            lib, "herm_eig_launch", [ctypes.c_int] + [ctypes.c_void_p] * 5
            + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    return libs


def _run(fn, A, w, U, conv, work):
    rc = fn(DTYPE_CODES[A.dtype], A.data_ptr(), w.data_ptr(), U.data_ptr(),
            conv.data_ptr(), work.data_ptr(), 1, A.shape[-1],
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"launch failed with CUDA error {rc}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default="current",
                    help=f"comma-separated, of {sorted(VARIANTS)}")
    ap.add_argument("--m", type=int, default=128)
    ap.add_argument("--rounds", type=int, default=4)
    opts = ap.parse_args()
    card = trials.card()
    print(card)
    libs = _build_all([v for v in opts.variants.split(",") if v])
    m = opts.m
    g = torch.Generator(device="cuda").manual_seed(m)
    for dt in (torch.float64, torch.complex128):
        X = torch.randn(m, m, generator=g, dtype=dt, device="cuda")
        A = (X @ X.mH).contiguous()
        real = A.real.dtype if A.is_complex() else A.dtype
        w = torch.empty(m, dtype=real, device="cuda")
        U = torch.empty_like(A)
        conv = torch.empty((), dtype=torch.int32, device="cuda")
        eps, norm = torch.finfo(real).eps, float(torch.linalg.norm(A))
        ref = torch.linalg.eigvalsh(A)
        eye = torch.eye(m, dtype=dt, device="cuda")
        work = torch.empty(he.work_values(m), dtype=dt, device="cuda")
        for name, lib in libs.items():
            _run(lib, A, w, U, conv, work)
            torch.cuda.synchronize()
            if name in ABLATIONS:
                continue
            ew = float((w - ref).abs().max()) / (4 * m * eps * norm)
            eu = float(torch.linalg.norm(U.mH @ U - eye)) / (16 * m * eps)
            print(f"[check] {name} {str(dt)[6:]} m={m}: {int(conv)} sweeps, "
                  f"eigenvalues {ew:.3f}, orthogonality {eu:.3f} of their "
                  f"bounds")
            if not (ew <= 1.0 and eu <= 1.0 and int(conv) > 0):
                raise SystemExit(f"variant {name} outside its bounds")
        times = trials.in_turns(
            {name: (lambda lib=lib: _run(lib, A, w, U, conv, work))
             for name, lib in libs.items()},
            opts.rounds, chip_smoke.time_ms, warmup=3, iters=20)
        for name, ts in times.items():
            print(f"[time] {name}{' (ablation)' if name in ABLATIONS else ''}"
                  f" {str(dt)[6:]} m={m}: {trials.times_text(ts)}  [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())

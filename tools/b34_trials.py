"""Trials of B3's wide float64 instance (``tsmm_dmma`` in
``src/repro_torch/kernels/csrc/tsmm.cu``) and B4's wide instance
(``block_diag_stream`` in ``csrc/block_diag.cu``) on the card.

Each variant is the current pair of sources with a few textual
replacements (the table ``VARIANTS``: among them the two B3 designs the
kernel's note compares, ``b3_vstage`` and ``b3_w32``); ``--source NAME=DIR`` (repeatable)
adds DIR's ``tsmm.cu`` and ``block_diag.cu`` (another checkout's
``src/repro_torch/kernels/csrc``, or a directory holding other versions
of the two with a ``dtypes.cuh``) as the variant NAME.  The script builds every variant with the package's
nvcc flags, one ``nvcc`` per source and variant, all started together,
into ``build/b34_trials/``; prints the wide instances' registers and
spills; holds each variant against the float64 plain versions at a few
shapes (``chip_smoke.py``'s bounds: B3 to m + 2 units of ``|V| |X|``,
B4 to bs + 2 units of ``|B| |x|``); and times the variants in turns (the
order reversed every other round) with CUDA events: B3 at ``--n`` x
``--m`` x ``--m`` with and without W beside ``torch.addmm`` and
``torch.mm``, B4 at ``--rows`` rows of blocks of ``--bs`` and ``--b``
columns beside ``torch.bmm``.  Run from the root of a checkout, on a
machine with the card:

    python tools/b34_trials.py --variants current,b3_vstage,b3_w32 \
        --source parent=build/parent/src/repro_torch/kernels/csrc

``--rounds 0`` checks without timing.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (puts src/ on the path)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import block_diag as b4  # noqa: E402
from repro_torch.kernels import tsmm as b3  # noqa: E402
from repro_torch.kernels.ref import block_diag_matmul_ref, tsmm_ref  # noqa: E402
from tools import trials  # noqa: E402

OUT = ROOT / "build" / "b34_trials"
SOURCES = ("tsmm", "block_diag")
#: B3's results written into the stage that held the tile's V (no output
#: stage), which leaves room for a third stage at m = 128
B3_VSTAGE = [
    ("  __shared__ __align__(8) uint64_t bars[kWideMaxStages];\n", ""),
    ("""  const int SV = mp + kWidePad;  // a V stage's row stride
  double* sX = wsm;                       // mp x N, swizzled
  double* sO = sX + mp * N;               // R x N, the output stage
  double* ring = sO + R * N;              // stages x R x SV""",
     """  const int SV = (mp > N ? mp : N) + kWidePad;  // a stage's row stride
  double* ring = wsm;                            // stages x R x SV
  double* sX = ring + stages * R * SV;           // mp x N, swizzled
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + SV - kWidePad);"""),
    ("  for (int e = t; e < stages * R * SV; e += NT) ring[e] = 0.0;\n",
     "  for (int e = t; e < stages * R * SV; e += NT) ring[e] = 0.0;\n"
     "  __syncthreads();\n"),
    ("bulk_store(W_out + (r0 + r) * k + j0, sO + r * N,",
     "bulk_store(W_out + (r0 + r) * k + j0,\n"
     "                     ring + (int)(it % stages) * R * SV + r * SV,"),
    ("W_out[(r0 + r) * k + j0 + c] = sO[r * N + c];",
     "W_out[(r0 + r) * k + j0 + c] =\n"
     "            ring[(int)(it % stages) * R * SV + r * SV + c];"),
    ("""    if (it > 0) flush(it - 1);
    fill(it + stages - 1);""", """    if (it > 0) {
      flush(it - 1);
      // the stage of it - 1 is refilled below: its result must have left
      if (!vec) __syncthreads();
      else if (warp == 0) bulk_wait_read();
    }
    fill(it + stages - 1);"""),
    ("    const double* sv = ring + st * R * SV;\n",
     "    double* sv = ring + st * R * SV;\n"),
    ("    if (vec && warp == 0) bulk_wait_read();  // tile it - 1 left sO\n"
     "    __syncthreads();\n", "    __syncthreads();  // V's tile is done with\n"),
    ("*reinterpret_cast<double2*>(sO + (wr + g + 8 * h) * N + wc + 8 * b +",
     "*reinterpret_cast<double2*>(sv + (wr + g + 8 * h) * SV + wc + 8 * b +"),
    ("""    const int fixed = (mp * kWideCols + kWideRows * kWideCols) *
                      (int)sizeof(double);
    const int per_stage = kWideRows * (mp + kWidePad) * (int)sizeof(double);
    const int room = 232448 - (int)(kWideMaxStages * sizeof(uint64_t));""",
     """    const int fixed = mp * kWideCols * (int)sizeof(double);
    const int per_stage = kWideRows *
                          ((mp > kWideCols ? mp : kWideCols) + kWidePad) *
                          (int)sizeof(double);
    const int room = 232448;"""),
]
#: B3 in four warps of 32 x 32 (two A fragments and four B fragments a
#: step: sixteen loads for eight mma.sync), one warp a scheduler
B3_W32 = [
    ("constexpr int kWideThreads = 2 * kWideCols;",
     "constexpr int kWideThreads = kWideCols;"),
    ("const int wr = (warp & 1) * 16, wc = (warp >> 1) * 32;",
     "const int wr = 0, wc = warp * 32;"),
    ("""    double w[4][4];
    if (has_w) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {""", """    double w[4][8];
    if (has_w) {
#pragma unroll
      for (int h = 0; h < 4; ++h) {"""),
    ("""    double acc[4][4];
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[b][e] = 0.0;""", """    double acc[2][4][4];
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[0][b][e] = acc[1][b][e] = 0.0;"""),
    ("""      const double a2 = va[i0 + 4], a3 = va[8 * SV + i0 + 4];""",
     """      const double a2 = va[i0 + 4], a3 = va[8 * SV + i0 + 4];
      const double c0 = va[16 * SV + i0], c1 = va[24 * SV + i0];
      const double c2 = va[16 * SV + i0 + 4], c3 = va[24 * SV + i0 + 4];"""),
    ("        dmma16(acc[b], a0, a1, a2, a3, x0[j], x1[j]);",
     "        const double b0 = x0[j], b1 = x1[j];\n"
     "        dmma16(acc[0][b], a0, a1, a2, a3, b0, b1);\n"
     "        dmma16(acc[1][b], c0, c1, c2, c3, b0, b1);"),
    ("""    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        double2 y;
        y.x = alpha * acc[b][2 * h];
        y.y = alpha * acc[b][2 * h + 1];""", """    for (int h = 0; h < 4; ++h)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        double2 y;
        y.x = alpha * acc[h >> 1][b][2 * (h & 1)];
        y.y = alpha * acc[h >> 1][b][2 * (h & 1) + 1];"""),
]
#: name -> {source: replacements (old, new)} applied to the current
#: sources; each old text must occur in its source
VARIANTS = {
    "current": {},
    "b3_vstage": {"tsmm": B3_VSTAGE},
    "b3_w32": {"tsmm": B3_W32},
    # B4: stages of 8 KB or 32 KB, or three stages
    "b4_8k": {"block_diag": [("constexpr int kStreamStageBytes = 16384;",
                              "constexpr int kStreamStageBytes = 8192;")]},
    "b4_32k": {"block_diag": [("constexpr int kStreamStageBytes = 16384;",
                               "constexpr int kStreamStageBytes = 32768;")]},
    "b4_s3": {"block_diag": [("constexpr int kStreamStages = 4;",
                              "constexpr int kStreamStages = 3;")]},
}
#: the wide instances whose compiler report is printed: B3's, and B4's
#: float64 ones (blocks and x both double)
WIDE = r"(tsmm_dmma|block_diag_stream|block_diag_tiled)(?:I(\w+?)E+v)?"


def _label(m):
    if m.group(1).startswith("block_diag") and not (m.group(2) or
                                                    "").startswith("dd"):
        return None
    return m.group(1) + (f"<{m.group(2)}>" if m.group(2) else "")


def _build_all(names, dirs):
    sources = {}
    for name in names:
        for source in SOURCES:
            if name in dirs:
                include = Path(dirs[name])
                src = (include / f"{source}.cu").read_text()
            else:
                include = _build.CSRC
                src = trials.apply((_build.CSRC / f"{source}.cu").read_text(),
                                   VARIANTS[name].get(source, []),
                                   f"variant {name} {source}.cu")
            sources[f"{name}_{source}"] = (src, include)
    built = trials.build(OUT, sources)
    libs = {}
    for name in names:
        for source in SOURCES:
            lib, log = built[f"{name}_{source}"]
            trials.report(name, log, WIDE, _label)
            module = b3 if source == "tsmm" else b4
            libs.setdefault(name, {})[source] = trials.entry(
                lib, f"{source}_launch", module._ARGTYPES)
    return libs


def _check(b3_call, b4_call, name) -> bool:
    """The variant against the float64 plain versions; prints what it found
    and returns whether every check held."""
    f64 = torch.float64
    g = torch.Generator(device="cuda").manual_seed(31)
    failed, n_cases = [], 0
    for n in (37, 4099, 1 << 18):
        for m, k in ((65, 65), (128, 128), (200, 72), (72, 200)):
            V, X, W = (torch.randn(*s, generator=g, dtype=f64, device="cuda")
                       for s in ((n, m), (m, k), (n, k)))
            for Win in (None, W):
                got = b3_call(V, X, Win, 1.5, -0.5 if Win is not None else 0.0)
                want = tsmm_ref(V, X, Win, 1.5, -0.5 if Win is not None
                                else 0.0)
                scale = 1.5 * (V.abs() @ X.abs()) + (
                    0.5 * W.abs() if Win is not None else 0.0)
                lim = (m + 2) * 2.0 ** -53 * scale + 1e-300
                if not bool(((got - want).abs() <= lim).all()):
                    failed.append(f"B3 n={n} m={m} k={k} W={Win is not None}")
                n_cases += 1
    for bs in (65, 128, 500):
        for b in (1, 4, 17):
            blocks = torch.randn(7, bs, bs, generator=g, dtype=f64,
                                 device="cuda")
            x = torch.randn(7 * bs, b, generator=g, dtype=f64, device="cuda")
            got = b4_call(blocks, x)
            want = block_diag_matmul_ref(blocks, x)
            lim = (bs + 2) * 2.0 ** -53 * block_diag_matmul_ref(
                blocks.abs(), x.abs()) + 1e-300
            if not bool(((got - want).abs() <= lim).all()):
                failed.append(f"B4 bs={bs} b={b}")
            n_cases += 1
    print(f"[check] {name}: {n_cases} cases against the plain versions; "
          f"{len(failed)} failed")
    for f in failed:
        print(f"[check] {name} FAILED {f}")
    return not failed


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default="current",
                    help=f"comma-separated, of {sorted(VARIANTS)}")
    ap.add_argument("--n", type=int, default=4_096_000)
    ap.add_argument("--m", type=int, default=128)
    ap.add_argument("--rows", type=int, default=4_194_304)
    ap.add_argument("--bs", type=int, default=128)
    ap.add_argument("--b", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--source", action="append", default=[],
                    help="NAME=DIR: DIR's tsmm.cu and block_diag.cu, built "
                         "as the variant NAME")
    opts = ap.parse_args()
    card = trials.card()
    print(card)
    names = [v for v in opts.variants.split(",") if v]
    dirs = dict(item.split("=", 1) for item in opts.source)
    names += list(dirs)
    libs = _build_all(names, dirs)
    b3s = {name: trials.through(b3, fns["tsmm"], b3.tsmm_cuda)
           for name, fns in libs.items()}
    b4s = {name: trials.through(b4, fns["block_diag"], b4.block_diag_cuda)
           for name, fns in libs.items()}
    rc = 0
    for name in libs:
        rc |= not _check(b3s[name], b4s[name], name)
    f64 = torch.float64
    g = torch.Generator(device="cuda").manual_seed(12)
    n, m = opts.n, opts.m
    V, W = (torch.randn(n, m, generator=g, dtype=f64, device="cuda")
            for _ in range(2))
    X = torch.randn(m, m, generator=g, dtype=f64, device="cuda")
    cases = {}
    for name in libs:
        cases[f"{name} tsmm with W"] = (
            lambda c=b3s[name]: c(V, X, W, 1.0, 1.0))
        cases[f"{name} tsmm without W"] = lambda c=b3s[name]: c(V, X)
    cases["addmm"] = lambda: torch.addmm(W, V, X, beta=1.0, alpha=1.0)
    cases["mm"] = lambda: torch.mm(V, X)
    bs, b = opts.bs, opts.b
    blocks = torch.randn(opts.rows // bs, bs, bs, generator=g, dtype=f64,
                         device="cuda")
    x = torch.randn(opts.rows, b, generator=g, dtype=f64, device="cuda")
    for name in libs:
        cases[f"{name} block_diag"] = lambda c=b4s[name]: c(blocks, x)
    cases["bmm"] = lambda: torch.bmm(blocks, x.view(-1, bs, b))
    times = trials.in_turns(cases, opts.rounds, chip_smoke.time_ms,
                            warmup=3, iters=10)
    for key, ts in times.items():
        if not ts:
            continue
        shape = (f"bs={bs} rows={opts.rows} b={b}" if "block" in key
                 or key == "bmm" else f"n={n} m=k={m}")
        print(f"[time] {key} {shape}: {trials.times_text(ts)}  [{card}]")
    return int(rc)


if __name__ == "__main__":
    sys.exit(main())

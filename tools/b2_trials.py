"""Design trials of B2's wide float64 instance (``tsmttsm_dmma`` in
``src/repro_torch/kernels/csrc/tsmttsm.cu``) on the card.

Each variant is the current source with a few textual replacements (the
table ``VARIANTS``); ``--parent DIR`` adds DIR's ``tsmttsm.cu`` (another
checkout's ``src/repro_torch/kernels/csrc``) as the variant ``parent``.
The script builds every variant with the package's nvcc flags, one
``nvcc`` per variant, all started together, into ``build/b2_trials/``;
prints the DMMA instances' registers and spills; holds each variant's
Kahan and plain sums at the (m, k) of ``--check`` against the float64
plain version (``chip_smoke.py``'s bounds) and, at the most rows, V^T W
and the self-Gram against exact sums (``chip_smoke._require_exact_kahan``:
the Kahan error within its bound and at most ``KAHAN_GAIN`` of the plain
sum's); and times the variants in turns (the order reversed every other
round) with CUDA events at ``--n`` x ``--m`` x ``--m``, beside
``torch.addmm`` on the same operands.  The variants of ``FAULTS`` are
broken on purpose: each must fail the exact check (the script exits 1
where one passes), and is not timed unless it is also an ablation.  Run
from the root of a checkout, on a machine with the card:

    python tools/b2_trials.py --variants current,cpasync,nofold,flipc --m 128

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
from repro_torch.kernels import tsmttsm as b2  # noqa: E402
from repro_torch.kernels.ref import tsmttsm_ref  # noqa: E402
from tools import trials  # noqa: E402

OUT = ROOT / "build" / "b2_trials"
#: name -> replacements (old, new) applied to the current source; each old
#: text must occur in it
VARIANTS = {
    "current": [],
    # the Kahan fold as four additions after a group sum from zero (the
    # compensation's subtraction outside the tensor core)
    "pfold": [("for (int e = 0; e < 4; ++e) d[e] = c[a + (e >> 1)][b][e & 1];",
               "for (int e = 0; e < 4; ++e) d[e] = 0.0;"),
              ("              const double u = se + d[e];\n"
               "              c[a + (e >> 1)][b][e & 1] = d[e] - (u - se);\n"
               "              se = u;",
               "              kahan_add(se, c[a + (e >> 1)][b][e & 1], d[e]);"),
              ("comp[o] = -c[a][b][h];", "comp[o] = c[a][b][h];")],
    # Kahan in eight warps of 32 x 32, or stages of 16 rows (four)
    "kahan_w32": [("M = 128, N = 64, WN = 16, kRows = 32, kStages = 3;",
                   "M = 128, N = 64, WN = 32, kRows = 32, kStages = 3;")],
    "kahan_r16": [("M = 128, N = 64, WN = 16, kRows = 32, kStages = 3;",
                   "M = 128, N = 64, WN = 16, kRows = 16, kStages = 4;")],
    # deeper rings: four stages of 32 rows, or eight of 16
    "kahan_s4": [("M = 128, N = 64, WN = 16, kRows = 32, kStages = 3;",
                  "M = 128, N = 64, WN = 16, kRows = 32, kStages = 4;")],
    "kahan_r16s8": [("M = 128, N = 64, WN = 16, kRows = 32, kStages = 3;",
                     "M = 128, N = 64, WN = 16, kRows = 16, kStages = 8;")],
    "plain_r16s6": [("M = 128, N = 128, WN = 32, kRows = 32, kStages = 3;",
                     "M = 128, N = 128, WN = 32, kRows = 16, kStages = 6;")],
    # the self-Gram's blocks in four warps of 32 x 32
    "sym_w32": [("  static constexpr int M = 64, N = 64, WN = 16, kRows = 32, kStages = 3;",
                 "  static constexpr int M = 64, N = 64, WN = 32, kRows = 32, kStages = 3;")],
    # the self-Gram's groups unrolled by two, as the plain blocks' are; or
    # its stages of 16 rows (four)
    "sym_u2": [("constexpr int kGroupUnroll = 1;",
                "constexpr int kGroupUnroll = SYM ? 2 : 1;")],
    "sym_r16": [("  static constexpr int M = 64, N = 64, WN = 16, kRows = 32, kStages = 3;",
                 "  static constexpr int M = 64, N = 64, WN = 16, kRows = 16, kStages = 4;")],
    # plain sums in eight warps of 32 x 64 with their groups unrolled by
    # two, or in sixteen warps unrolled by two, or stages of 16 rows (four)
    "plain_w64": [("M = 128, N = 128, WN = 32, kRows = 32, kStages = 3;",
                   "M = 128, N = 128, WN = 64, kRows = 32, kStages = 3;"),
                  ("constexpr int kGroupUnroll = 1;",
                   "constexpr int kGroupUnroll = KAHAN || SYM ? 1 : 2;")],
    "plain_u2": [("constexpr int kGroupUnroll = 1;",
                  "constexpr int kGroupUnroll = KAHAN || SYM ? 1 : 2;")],
    "plain_r16": [("M = 128, N = 128, WN = 32, kRows = 32, kStages = 3;",
                   "M = 128, N = 128, WN = 32, kRows = 16, kStages = 4;")],
    # the stages filled by cp.async value by value even where the bulk
    # copies could take them
    "cpasync": [("const int vec = a.m % 2 == 0 && a.k % 2 == 0 &&",
                 "const int vec = 0 && a.m % 2 == 0 && a.k % 2 == 0 &&")],
    # faults: the compensation's sign flipped (c added where it should be
    # taken away)
    "flipc": [("c[a + (e >> 1)][b][e & 1] = d[e] - (u - se);",
               "c[a + (e >> 1)][b][e & 1] = (u - se) - d[e];")],
    # ablation and fault: the Kahan blocks without their folds
    "nofold": [("          if constexpr (KAHAN) {\n            // kahan_add",
                "          if constexpr (false) {\n            // kahan_add"),
               ("            if constexpr (KAHAN) {\n              const double u",
                "            if constexpr (false) {\n              const double u")],
}
#: variants timed but not checked, and variants that must fail the checks
ABLATIONS = {"nofold"}
FAULTS = {"nofold", "flipc"}


def _build_all(names, parent=None):
    base = (_build.CSRC / "tsmttsm.cu").read_text()
    sources = {}
    for name in names:
        src = base if name != "parent" else (Path(parent)
                                             / "tsmttsm.cu").read_text()
        sources[name] = (trials.apply(src, VARIANTS.get(name, []),
                                      f"variant {name}"), _build.CSRC)
    libs = {}
    for name, (lib, log) in trials.build(OUT, sources).items():
        trials.report(name, log, r"tsmttsm_dmmaILb(\d)E",
                      lambda m: "tsmttsm_dmma "
                      + ("kahan" if m.group(1) == "1" else "plain"))
        libs[name] = trials.entry(lib, "tsmttsm_launch", b2._ARGTYPES)
    return libs


def _with(fn):
    """``b2.tsmttsm_cuda`` through the variant's entry ``fn``."""
    return trials.through(b2, fn, b2.tsmttsm_cuda)


def _check(call, name, dims) -> bool:
    """The variant against the plain version (every n) and against exact
    sums (the most rows); prints what it found and returns whether every
    check held."""
    f64 = torch.float64
    g = torch.Generator(device="cuda").manual_seed(30)
    worst, failed = 0.0, []
    ns = (37, 4109, 1 << 18)
    for n in ns:
        for m, k in dims:
            V, W = (torch.randn(n, d, generator=g, dtype=f64, device="cuda")
                    for d in (m, k))
            want = tsmttsm_ref(V, W)
            scale = V.abs().T @ W.abs()
            for kahan in (False, True):
                got = call(V, W, kahan=kahan)
                depth = (chip_smoke.kahan_depth(n, m, k, f64, f64) if kahan
                         else b2.summation_depth(n, m, k, f64))
                try:
                    err = chip_smoke._tsm_check(got, want, scale, f64, depth,
                                                n, f"{name} n={n} m={m} k={k}")
                except chip_smoke.SmokeFailure as exc:
                    failed.append(f"plain version: {exc}")
                    continue
                lim = ((depth + 3) + (n + 3)) * 2.0 ** -53 * scale + 1e-300
                worst = max(worst, float((err / lim).max()))
            if n != ns[-1]:
                continue
            for what, (A, B) in (("V^T W", (V, W)), ("self-Gram", (W, W))):
                tag = f"{name} {what} n={n} m={m} k={B.shape[1]}"
                try:
                    print(f"[check] {tag}: " + chip_smoke._require_exact_kahan(
                        A, B, call(A, B, kahan=True), call(A, B), g, tag))
                except chip_smoke.SmokeFailure as exc:
                    failed.append(f"exact sums: {exc}")
    print(f"[check] {name}: {len(dims) * 6} cases against the plain "
          f"version (worst {worst:.3f} of its bound), {len(dims) * 2} "
          f"against exact sums; {len(failed)} failed")
    for f in failed:
        print(f"[check] {name} FAILED {f}")
    return not failed


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default="current",
                    help=f"comma-separated, of {sorted(VARIANTS)}")
    ap.add_argument("--n", type=int, default=4_096_000)
    ap.add_argument("--m", type=int, default=128)
    ap.add_argument("--check", default="65x65,128x128,200x136",
                    help="(m, k) checked against the plain version")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--parent", default=None,
                    help="a directory holding another tsmttsm.cu, built as "
                         "the variant 'parent'")
    opts = ap.parse_args()
    card = trials.card()
    print(card)
    names = [v for v in opts.variants.split(",") if v]
    if opts.parent:
        names.append("parent")
    libs = _build_all(names, opts.parent)
    dims = [tuple(int(x) for x in d.split("x"))
            for d in opts.check.split(",") if d]
    calls = {name: _with(fn) for name, fn in libs.items()}
    rc = 0
    for name, call in calls.items():
        held = _check(call, name, dims)
        if name in FAULTS:
            print(f"[check] fault {name}: "
                  + ("caught" if not held else "NOT CAUGHT"))
            rc |= held
        elif not held:
            rc = 1
    calls = {name: call for name, call in calls.items()
             if name not in FAULTS or name in ABLATIONS}
    n, m = opts.n, opts.m
    g = torch.Generator(device="cuda").manual_seed(12)
    V, W = (torch.randn(n, m, generator=g, dtype=torch.float64,
                        device="cuda") for _ in range(2))
    X = torch.zeros(m, m, dtype=torch.float64, device="cuda")
    cases = {f"{name} {'kahan' if kahan else 'plain'}":
             (lambda c=call, kh=kahan: c(V, W, kahan=kh))
             for name, call in calls.items() for kahan in (True, False)}
    # the self-Gram (V is W), block CG's SVQB Gram
    cases.update({f"{name} self-Gram kahan":
                  (lambda c=call: c(W, W, kahan=True))
                  for name, call in calls.items()})
    cases["addmm"] = lambda: torch.addmm(X, V.mT, W, beta=0.0, alpha=1.0)
    times = trials.in_turns(cases, opts.rounds, chip_smoke.time_ms,
                            warmup=3, iters=10)
    for key, ts in times.items():
        if not ts:
            continue
        print(f"[time] {key} n={n} m=k={m}: {trials.times_text(ts)}  "
              f"[{card}]")
    return int(rc)


if __name__ == "__main__":
    sys.exit(main())

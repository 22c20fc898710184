"""Design trials of kernel B1 (``src/repro_torch/kernels/csrc/sellcs_spmv.cu``)
on the card, on laplace3d(160) (C 32, sigma 1024): float64, float32,
bfloat16 stored under float32 compute, and its U(1)-phased Hermitian
variant (``chip_smoke.phased``) in complex128 and complex64.

Each variant is the current source with a few textual replacements (the
table ``VARIANTS``), or a whole source given with ``--source NAME=PATH``
(for instance an earlier commit's file, unpacked with ``git show``); each
must keep the C interface ``sellcs_spmv_launch``.  The script builds every
variant with the package's nvcc flags, one ``nvcc`` per variant, all
started together, into ``build/b1_trials/``; prints each instance's
spills where there are any; launches each variant with the geometry of
``kernels/sellcs_spmv.py:launch_geometry`` (a variant that refuses it is
reported so), holds its y and its <x, y> against the plain version
(float64 and complex128 within 1e-12 of the largest entry, the rest
within 1e-5); and times the variants' launches alone (the wrapper's sum
of the partials left out) in turns, the order reversed every other
round, with CUDA events.  The dot partials are summed over a zeroed
buffer of one row a chunk, so a variant may write one row a chunk or one
a block of chunks.  Run from the root of a checkout, on a machine with
the card:

    python tools/b1_trials.py --variants current,unroll6 \\
        --source parent=build/parent_sellcs_spmv.cu --rounds 2
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (puts src/ on the path)
from repro_torch.core import SpmvOpts, from_coo  # noqa: E402
from repro_torch.core.spmv import dot_acc_dtype  # noqa: E402
from repro_torch.kernels import _build, sellcs_spmv as b1  # noqa: E402
from repro_torch.kernels.ref import sellcs_spmv_ref  # noqa: E402
from repro_torch.matrices import laplace3d  # noqa: E402

OUT = ROOT / "build" / "b1_trials"
#: name -> replacements (old, new) applied to the current source; each old
#: text must occur in it
VARIANTS = {
    "current": [],
    "unroll6": [("constexpr int kUnroll = 8;", "constexpr int kUnroll = 6;")],
}
#: (matrix, b, <x, y>) timed by default
CASES = ([("f64", b, d) for b in (1, 4, 8, 16) for d in (False, True)]
         + [("f32", b, d) for b in (4, 16) for d in (False, True)]
         + [("bf16/f32", 4, True), ("bf16/f32", 16, False)]
         + [(k, b, d) for k in ("c128", "c64")
            for b, d in ((1, True), (4, True), (8, False), (16, False))])


def build(sources: dict) -> dict:
    """Compile each variant's source; return name -> C entry point."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        src = OUT / f"sellcs_spmv_{name}.cu"
        src.write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
             "-o", str(OUT / f"lib_{name}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"{name}: nvcc exited {proc.returncode}\n{log}")
        for line in log.splitlines():
            if "spill" in line and " 0 bytes spill stores" not in line:
                print(f"[ptxas] {name}: {line.strip()}")
        fn = ctypes.CDLL(str(OUT / f"lib_{name}.so")).sellcs_spmv_launch
        fn.argtypes, fn.restype = b1._ARGTYPES, ctypes.c_int
        fns[name] = fn
    return fns


def matrices() -> dict:
    r, c, v, n = laplace3d(chip_smoke.NX)
    kw = dict(C=32, sigma=1024, device="cuda")
    pv = chip_smoke.phased(r, c, v, n, chip_smoke.CX_SEED)
    return {
        "f64": from_coo(r, c, v, (n, n), dtype=np.float64, **kw),
        "f32": from_coo(r, c, v, (n, n), dtype=np.float32, **kw),
        "bf16/f32": from_coo(r, c, v, (n, n), dtype=np.float32,
                             store_dtype=torch.bfloat16, **kw),
        "c128": from_coo(r, c, pv, (n, n), dtype=np.complex128, **kw),
        "c64": from_coo(r, c, pv, (n, n), dtype=np.complex64, **kw),
    }


def launcher(fn, A, x, dot):
    """A launch of ``fn`` computing y = A x (and the partials of <x, y>)
    into buffers made once, and a function returning y and <x, y>; None
    where the variant refuses the geometry."""
    ct, b, C = A.dtype, x.shape[1], A.C
    nchunks = int(A.chunk_off.shape[0])
    geo = b1.launch_geometry(b, C, ct, x.data_ptr() % 16 == 0, dots=dot)
    y = torch.empty((nchunks * C, b), dtype=ct, device="cuda")
    part = (torch.zeros((nchunks, 3, b), dtype=dot_acc_dtype(ct),
                        device="cuda") if dot else None)
    stream = torch.cuda.current_stream().cuda_stream
    args = (b1._STORE_CODES[A.vals.dtype], b1._COMPUTE_CODES[ct],
            A.vals.data_ptr(), A.cols.data_ptr(), A.chunk_off.data_ptr(),
            A.chunk_len.data_ptr(), x.data_ptr(), None, None, None,
            y.data_ptr(), None, None if part is None else part.data_ptr(),
            nchunks, C, b, geo.bw, geo.tpr, geo.cpt, geo.threads, 0,
            1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
            b1._DOT_XY if dot else 0, stream)

    def launch():
        rc = fn(*args)
        if rc:
            raise RuntimeError(f"launch failed with CUDA error {rc}")
    try:
        launch()
        torch.cuda.synchronize()
    except RuntimeError:
        return None
    return launch, lambda: (y, None if part is None else part.sum(dim=0))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default="current",
                    help="comma-separated names of VARIANTS")
    ap.add_argument("--source", action="append", default=[],
                    help="NAME=PATH: a whole source as one more variant")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--iters", type=int, default=100)
    a = ap.parse_args()
    card = chip_smoke.phase_environment()
    text = (_build.CSRC / "sellcs_spmv.cu").read_text()
    sources = {}
    for name in a.variants.split(","):
        t = text
        for old, new in VARIANTS[name]:
            if old not in t:
                sys.exit(f"{name}: {old!r} is not in the source")
            t = t.replace(old, new)
        sources[name] = t
    for spec in a.source:
        name, path = spec.split("=", 1)
        sources[name] = Path(path).read_text()
    fns = build(sources)
    mats = matrices()
    for key, b, dot in CASES:
        A = mats[key]
        g = torch.Generator(device="cuda").manual_seed(2)
        x = torch.randn(A.nrows_pad, b, dtype=A.dtype, device="cuda",
                        generator=g)
        want = sellcs_spmv_ref(A, x, opts=SpmvOpts(dot_xy=dot))
        tol = (1e-12 if A.dtype in (torch.float64, torch.complex128)
               else 1e-5)
        calls, ms = {}, {}
        for name, fn in fns.items():
            got = launcher(fn, A, x, dot)
            if got is None:
                print(f"[b1] {key} b={b} dots={dot}: {name} refuses the "
                      f"geometry")
                continue
            call, result = got
            y, d = result()
            err = chip_smoke.rel_err(y, want[0])
            derr = chip_smoke.rel_err(d, want[2]) if dot else 0.0
            chip_smoke.require(err <= tol and derr <= tol,
                               f"{name} {key} b={b}: y {err}, dots {derr}")
            calls[name] = call
        names = list(calls)
        for rnd in range(a.rounds):
            for name in names if rnd % 2 == 0 else names[::-1]:
                ms.setdefault(name, []).append(
                    chip_smoke.time_ms(calls[name], iters=a.iters))
        print(f"[b1] {key} b={b} dots={dot}: " + "  ".join(
            f"{name} " + "/".join(f"{t:.4f}" for t in ms[name])
            for name in names) + f" ms  [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

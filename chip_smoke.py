#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the CUDA kernels from ``src/repro_torch/kernels/csrc/`` (one
``nvcc`` per source, started together) and drives the port's paths on
the card, holding every kernel against its plain PyTorch version:

1. environment: card name and power limit, CUDA and nvcc versions;
2. build: seconds and the compiler's register/shared-memory/spill report;
3. B1 (fused SpMV) against plain over a grid of chunk heights, sorting
   windows, store/compute dtypes, block widths and fusion flags;
4. B2 (tsmttsm, with and without Kahan) and B3 (tsmm, with and without
   the output operand) against their plain versions computed in float64,
   over row counts, widths, dtypes and alpha/beta pairs;
5. the paper's case study (MATPDE, CG) with B1's launch count;
6. slice 1's main path at full width: column CG (``block=False``, four
   independent right-hand sides) on laplace3d(160) (4,096,000 rows) in
   float64 and with bfloat16 storage, plus a chunked float64 solve that
   must equal the monolithic one bit for bit;
7. the quickstart SpMMV (shift, axpby, all dots) at full width;
8. slice 2's main path at full width: block CG (``block=True``, BCGrQ,
   width 16) on the same float64 matrix, with the launches of B1, B2 and
   B3 per iteration, the column-CG sweep count on the same right-hand
   side, and a chunked block solve equal to the monolithic one;
9. block MINRES at full width;
10. eigensolvers: Lanczos extrema of laplace3d(160), ChebFD on a
    laplace3d window with closed-form eigenvalues, KPM moments at full
    width;
11. timing of every kernel, its plain version and one PyTorch call that
    computes the same function, beside the memory-bandwidth bound, and
    the time split of one full-width block-CG iteration.

Each phase prints its seconds.  It prints one JSON line describing every
kernel, then as its last line ``{"ok": true, "device": {...}}``.  Any
failure exits non-zero before the last line.  It imports nothing of JAX
or of the JAX package.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core import SpmvOpts, execution, from_coo  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.ops import sellcs_spmv, tsmm, tsmttsm  # noqa: E402
from repro_torch.kernels.ref import (sellcs_spmv_ref, tsmm_ref,  # noqa: E402
                                     tsmttsm_ref)
from repro_torch.kernels.tsmttsm import MAX_DIM, summation_depth  # noqa: E402
from repro_torch.matrices import laplace3d, matpde  # noqa: E402
from repro_torch.solvers import (cg, cg_finalize, cg_init, cg_step,  # noqa: E402
                                 chebfd, kpm_dos_moments, lanczos_extrema,
                                 make_operator, minres)
from repro_torch.solvers import block  # noqa: E402

#: H100 SXM device-memory rate (NVIDIA data sheet), the bound's denominator
HBM_BYTES_PER_S = 3.35e12
KERNEL = "sellcs_spmv"
#: every kernel: its CUDA source and the TPU kernel (file:line) it replaces
KERNELS = {
    "sellcs_spmv": ("src/repro_torch/kernels/csrc/sellcs_spmv.cu",
                    "src/repro/kernels/sellcs_spmv.py:128"),
    "tsmttsm": ("src/repro_torch/kernels/csrc/tsmttsm.cu",
                "src/repro/kernels/tsmttsm.py:90"),
    "tsmm": ("src/repro_torch/kernels/csrc/tsmm.cu",
             "src/repro/kernels/tsmm.py:42"),
}
# max |kernel - plain| / max |plain|, by compute dtype
TOL = {torch.float64: {"vec": 1e-12, "dots": 1e-12},
       torch.float32: {"vec": 1e-5, "dots": 1e-6}}
GRID_PAIRS = [(torch.float64, np.float64), (torch.float32, np.float32),
              (torch.bfloat16, np.float32), (torch.float16, np.float32),
              (torch.float32, np.float64)]


#: where the phases run, and the full-width grid (a CPU rehearsal of the
#: control flow may lower them; the card run uses these values)
DEVICE = "cuda"
NX = 160
#: block width of the block-Krylov main path, and the TSM grid's row counts
WIDTH = 16
TSM_NS = (0, 1, 37, 4109, 1 << 20)
TSM_DIMS = (1, 3, 8, 16, MAX_DIM)
#: ChebFD on laplace3d(CHEB_NX): window, degree and sweeps with which the
#: JAX package converges on the CPU (four eigenvalues inside the window)
CHEB_NX, CHEB_TARGET, CHEB_DEGREE, CHEB_SWEEPS = 16, (0.05, 0.25), 150, 4


def sync() -> None:
    if DEVICE == "cuda":
        torch.cuda.synchronize()


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def rel_err(got, want) -> float:
    if got is None and want is None:
        return 0.0
    got = got.double()
    want = want.double()
    require(got.shape == want.shape,
            f"shape {tuple(got.shape)} != {tuple(want.shape)}")
    if want.numel() == 0:
        return 0.0
    diff = (got - want).abs().max().item()
    scale = want.abs().max().item()
    return diff / scale if scale > 0 else diff


def time_ms(fn, warmup: int = 20, iters: int = 100) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# ------------------------------------------------------------------ phase 1
def phase_environment() -> str:
    require(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__}  torch.version.cuda {torch.version.cuda}"
          f"  device {torch.cuda.get_device_name(0)}"
          f"  capability {torch.cuda.get_device_capability(0)}")
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    print("nvcc:", nvcc[-1] if nvcc else "?")
    return card


# ------------------------------------------------------------------ phase 2
def phase_build() -> None:
    t0 = time.perf_counter()
    _build.build()
    print(f"[build] {_build.sources()} in {time.perf_counter() - t0:.1f} s")
    for name in _build.sources():
        log = _build.build_logs.get(name)
        if log is None:
            print(f"[build] {name}: already built, no compiler report")
            continue
        # one line per template instance: registers, shared memory, spills
        entry, spill = "?", ""
        for line in log.splitlines():
            m = re.search(r"Function properties for (\S+)", line)
            if m:
                inst = re.search(r"(sellcs_spmv_fused|tsmttsm_partial|"
                                 r"tsmttsm_finish|tsmm_rows)I(\w+?)EEv",
                                 m.group(1))
                entry = (f"{inst.group(1)}<{inst.group(2)}>" if inst
                         else m.group(1))
            elif "spill" in line:
                spill = line.strip()
            elif "registers" in line:
                regs = re.search(r"Used \d+ registers", line)
                smem = re.search(r"\d+ bytes smem", line)
                print(f"[ptxas] {name}{entry}: "
                      f"{regs.group(0) if regs else '?'}, "
                      f"{smem.group(0) if smem else 'no smem'}; {spill}")


# ------------------------------------------------------------------ phase 3
def _grid_coo(n: int, ncols: int, rng, empty_every: int = 0):
    """Random COO with ragged rows (0..23 entries, a few of 60)."""
    rowlen = rng.integers(0, 24, n)
    rowlen[rng.random(n) < 0.02] = 60
    if empty_every:
        rowlen[::empty_every] = 0
        rowlen[: min(n, 70)] = 0                      # whole empty chunks
    rows = np.repeat(np.arange(n), rowlen)
    cols = rng.integers(0, ncols, rows.size)
    vals = rng.standard_normal(rows.size)
    return rows, cols, vals


def _flag_cases(b: int, rng, np_ct):
    gam = rng.standard_normal(b).astype(np_ct)
    return [
        ("plain", SpmvOpts(), False, False),
        ("alpha_beta", SpmvOpts(alpha=0.7, beta=-1.3), True, False),
        ("gamma_scalar", SpmvOpts(alpha=1.2, gamma=0.25), False, False),
        ("gamma_column", SpmvOpts(gamma=gam), True, False),
        ("chain", SpmvOpts(alpha=1.1, beta=0.5, delta=0.3, eta=-0.8),
         True, True),
        ("dots", SpmvOpts(alpha=0.9, beta=0.4, dot_yy=True, dot_xy=True,
                          dot_xx=True), True, False),
    ]


def _compare(A, x, y, z, opts, tol, tag, worst):
    yk, zk, dk = sellcs_spmv(A, x, y, z, opts)
    yr, zr, dr = sellcs_spmv_ref(A, x, y, z, opts)
    sync()
    errs = {"y": rel_err(yk, yr), "z": rel_err(zk, zr),
            "dots": rel_err(dk, dr)}
    for key, lim in (("y", tol["vec"]), ("z", tol["vec"]),
                     ("dots", tol["dots"])):
        require(errs[key] <= lim,
                f"kernel vs plain {tag}: {key} rel err {errs[key]:.3e} > {lim}")
    e = max(errs.values())
    if e >= worst[0]:
        worst[:] = [e, tag]
    return e


def phase_grid() -> None:
    rng = np.random.default_rng(0)
    dev = DEVICE
    n_cases = 0
    t0 = time.perf_counter()
    for sd, np_ct in GRID_PAIRS:
        ct = torch.float64 if np_ct is np.float64 else torch.float32
        tol = TOL[ct]
        per_flag = {}
        for C in (8, 32, 128):
            n = 16 * C + 5                        # ragged last chunk
            rows, cols, vals = _grid_coo(n, n, rng)
            for sigma in (1, C, 4 * C):
                A = from_coo(rows, cols, vals, (n, n), C=C, sigma=sigma,
                             dtype=np_ct, store_dtype=sd, device=dev)
                for b in (1, 3, 8, 16):
                    x = torch.randn(A.nrows_pad, b, dtype=ct, device=dev)
                    y = torch.randn_like(x)
                    z = torch.randn_like(x)
                    for name, opts, with_y, with_z in _flag_cases(b, rng, np_ct):
                        worst = per_flag.setdefault(name, [0.0, ""])
                        _compare(A, x, y if with_y else None,
                                 z if with_z else None, opts, tol,
                                 f"{sd}/{ct} C={C} sigma={sigma} b={b} {name}",
                                 worst)
                        n_cases += 1
            # a rectangular part: x has ncols rows; no shift, no x-dots
            m = 11 * C + 3
            rr, rc, rv = _grid_coo(n, m, rng)
            R = from_coo(rr, rc, rv, (n, m), C=C, sigma=4 * C, dtype=np_ct,
                         store_dtype=sd, device=dev)
            for b in (1, 3, 8, 16):
                x = torch.randn(m, b, dtype=ct, device=dev)
                y = torch.randn(R.nrows_pad, b, dtype=ct, device=dev)
                z = torch.randn_like(y)
                opts = SpmvOpts(alpha=0.6, beta=1.5, delta=2.0, eta=0.5,
                                dot_yy=True)
                _compare(R, x, y, z, opts, tol,
                         f"{sd}/{ct} C={C} b={b} rectangular",
                         per_flag.setdefault("rectangular", [0.0, ""]))
                n_cases += 1
        # empty rows (and whole empty chunks), and empty matrices
        n = 999
        rows, cols, vals = _grid_coo(n, n, rng, empty_every=3)
        extra = [("empty_rows", rows, cols, vals, n),
                 ("empty_matrix", [], [], [], 100),
                 ("zero_rows", [], [], [], 0)]
        for name, r_, c_, v_, nn in extra:
            A = from_coo(r_, c_, v_, (nn, nn), C=32, sigma=128, dtype=np_ct,
                         store_dtype=sd, device=dev)
            for b in (1, 3, 16):
                x = torch.randn(A.nrows_pad, b, dtype=ct, device=dev)
                y = torch.randn_like(x)
                opts = SpmvOpts(alpha=1.0, beta=-1.0, gamma=0.5, dot_yy=True,
                                dot_xy=True, dot_xx=True)
                _compare(A, x, y, None, opts, tol, f"{sd}/{ct} {name} b={b}",
                         per_flag.setdefault(name, [0.0, ""]))
                n_cases += 1
        for name, (err, tag) in per_flag.items():
            print(f"[grid] store={str(sd)[6:]} compute={str(ct)[6:]} "
                  f"{name:13s} max rel err {err:.3e}  (worst: {tag})")
    print(f"[grid] {n_cases} cases within tolerance "
          f"(f64 1e-12; f32 vectors 1e-5, dots 1e-6) in "
          f"{time.perf_counter() - t0:.1f} s")


# ------------------------------------------------------------------ phase 4
def phase_case_study() -> None:
    r, c, v, n = matpde(16, beta_c=0.0)
    A = from_coo(r, c, v, (n, n), C=16, sigma=32, w_align=4, dtype=np.float32,
                 device=DEVICE)
    require(A.beta > 0.5, f"beta {A.beta}")
    op = make_operator(A)
    b = np.random.default_rng(0).standard_normal((n, 2)).astype(np.float32)
    execution.reset_launch_counts()
    res = cg(op, A.permute(b), tol=1e-6, maxiter=600)
    sync()
    launches = execution.launch_counts().get(KERNEL, 0)
    conv = bool(res.converged.all())
    print(f"[case study] matpde(16) f32 b=2: {res.iters} iterations, "
          f"converged={conv}, kernel launches {launches}")
    require(conv, "case study did not converge")
    require(launches == res.iters + 1,
            f"case study: {launches} launches != iters + 1 = {res.iters + 1}")


# ------------------------------------------------------------------ phase 5
def _true_relres(A, b, x) -> float:
    Ax, _, _ = sellcs_spmv_ref(A, x)
    return ((b - Ax).norm(dim=0) / b.norm(dim=0)).max().item()


def _solve(A, b, tol, label, card):
    op = make_operator(A)
    execution.reset_launch_counts()
    sync()
    t0 = time.perf_counter()
    res = cg(op, b, tol=tol, maxiter=3000)
    sync()
    secs = time.perf_counter() - t0
    launches = execution.launch_counts().get(KERNEL, 0)
    relres = _true_relres(A, b, res.x)
    conv = bool(res.converged.all())
    print(f"[full width] {label}: {res.iters} iterations in {secs:.3f} s "
          f"({1e3 * secs / max(res.iters, 1):.3f} ms/iter), converged={conv}, "
          f"true rel residual {relres:.3e} (tol {tol}), kernel launches "
          f"{launches}  [{card}]")
    require(conv, f"{label}: not converged")
    require(relres <= 10 * tol, f"{label}: true residual {relres} > {10 * tol}")
    require(launches == res.iters + 1,
            f"{label}: {launches} launches != iters + 1 = {res.iters + 1}")
    return res, launches, secs


def phase_full_width(card):
    r, c, v, n = laplace3d(NX)
    rng = np.random.default_rng(0)
    b_host = rng.standard_normal((n, 4))
    out = {}

    t0 = time.perf_counter()
    A64 = from_coo(r, c, v, (n, n), C=32, sigma=1024, dtype=np.float64,
                   device=DEVICE)
    sync()
    print(f"[full width] laplace3d({NX}) n={n} nnz={A64.nnz} cap={A64.cap} "
          f"beta={A64.beta:.4f}: f64 build {time.perf_counter() - t0:.1f} s")
    b64 = A64.permute(torch.from_numpy(b_host))
    res64, launches, secs = _solve(A64, b64, 1e-8, "(a) column CG f64 b=4", card)
    out["launches"], out["solve_s"] = launches, {"f64": secs}

    # the same solve in cg_step chunks of 64 must equal it bit for bit
    op = make_operator(A64)
    st = cg_init(op, b64, tol=1e-8, maxiter=3000)
    while st.it < st.maxiter and not bool(st.done.all()):
        st = cg_step(op, st, 64)
    ch = cg_finalize(st)
    same = (ch.iters == res64.iters and torch.equal(ch.x, res64.x)
            and torch.equal(ch.resnorm, res64.resnorm))
    print(f"[full width] (a) as cg_step chunks of 64: {ch.iters} iterations, "
          f"bit-identical to the monolithic solve: {same}")
    require(same, "chunked f64 solve differs from the monolithic one")

    t0 = time.perf_counter()
    A16 = from_coo(r, c, v, (n, n), C=32, sigma=1024, dtype=np.float32,
                   store_dtype=torch.bfloat16, device=DEVICE)
    sync()
    print(f"[full width] bf16-store/f32 build {time.perf_counter() - t0:.1f} s")
    b32 = A16.permute(torch.from_numpy(b_host.astype(np.float32)))
    _, launches16, secs = _solve(A16, b32, 1e-5,
                                 "(b) column CG bf16 store, f32 compute, b=4", card)
    out["solve_s"]["bf16-store/f32"] = secs
    out["launches16"] = launches16
    out["A64"], out["A16"] = A64, A16
    out["coo"] = (r, c, v, n)
    return out


# ------------------------------------------------------------------ phase 6
def phase_quickstart(A) -> None:
    g = torch.Generator(device=DEVICE).manual_seed(1)
    x = torch.randn(A.nrows_pad, 4, dtype=A.dtype, device=DEVICE, generator=g)
    y = torch.randn(A.nrows_pad, 4, dtype=A.dtype, device=DEVICE, generator=g)
    opts = SpmvOpts(alpha=1.0, beta=-1.0, gamma=np.array([0.5, -0.25, 1.0, 2.0]),
                    dot_yy=True, dot_xy=True, dot_xx=True)
    worst = [0.0, ""]
    e = _compare(A, x, y, None, opts, TOL[torch.float64], "quickstart", worst)
    print(f"[quickstart] laplace3d({NX}) f64 b=4, alpha=1 beta=-1 per-column "
          f"gamma, all dots: kernel vs plain max rel err {e:.3e}")


# ------------------------------------------------------------------ phase 7
def _library_csr(A, coo):
    """The same matrix, permuted, as a torch CSR tensor (yardstick only)."""
    r, c, v, n = coo
    ip = A.iperm.cpu().numpy().astype(np.int64)
    idx = torch.from_numpy(np.stack([ip[r], ip[c]])).cuda()
    val = torch.from_numpy(np.asarray(v, np.float64)).cuda()
    with warnings.catch_warnings():        # sparse CSR is "beta" in torch
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_coo_tensor(idx, val, (A.nrows_pad, A.nrows_pad)
                                       ).coalesce().to_sparse_csr()


def phase_timing(fw, card):
    A64, A16 = fw["A64"], fw["A16"]
    csr = _library_csr(A64, fw["coo"])
    rows = []
    for label, A in (("f64", A64), ("bf16-store/f32", A16)):
        for b in (1, 4):
            g = torch.Generator(device="cuda").manual_seed(2)
            x = torch.randn(A.nrows_pad, b, dtype=A.dtype, device="cuda",
                            generator=g)
            opts = SpmvOpts(dot_xy=True)           # what CG asks of the kernel
            yk, _, dk = sellcs_spmv(A, x, opts=opts)
            yr, _, dr = sellcs_spmv_ref(A, x, opts=opts)
            err = (yk.double() - yr.double()).abs().max().item()
            dots_err = rel_err(dk, dr)
            require(dots_err <= TOL[A.dtype]["dots"],
                    f"timing inputs: dots rel err {dots_err}")
            ms = time_ms(lambda: sellcs_spmv(A, x, opts=opts))
            plain_ms = time_ms(lambda: sellcs_spmv_ref(A, x, opts=opts),
                               warmup=3, iters=20)
            lib_ms = None
            if A.dtype == torch.float64:
                lib_err = rel_err(csr @ x, yk)
                require(lib_err <= 1e-12, f"library product disagrees {lib_err}")
                lib_ms = time_ms(lambda: csr @ x)
            nbytes = sum(t.numel() * t.element_size() for t in
                         (A.vals, A.cols, A.chunk_off, A.chunk_len, x, yk, dk))
            bound_ms = 1e3 * nbytes / HBM_BYTES_PER_S
            gbs = nbytes / (ms * 1e-3) / 1e9
            print(f"[timing] {label} b={b}: kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, library(csr@x) "
                  f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound "
                  f"{bound_ms:.4f} ms ({nbytes / 1e6:.1f} MB), "
                  f"{gbs:.1f} GB/s = {100 * bound_ms / ms:.1f}% of bound, "
                  f"y max abs err {err:.3e}, dots rel err {dots_err:.3e}  "
                  f"[{card}]")
            rows.append(dict(label=label, b=b, ms=ms, plain_ms=plain_ms,
                             library_ms=lib_ms, bound_ms=bound_ms, err=err))
    return rows




# ------------------------------------------------------------------ phase 4
#: unit roundoff of the accumulation dtype (float32 for the half types)
#: and of the output dtype (the result rounds once more)
_ACC_UNIT = {torch.float64: 2.0 ** -53, torch.float32: 2.0 ** -24,
             torch.bfloat16: 2.0 ** -24, torch.float16: 2.0 ** -24}
_OUT_UNIT = {torch.float64: 0.0, torch.float32: 0.0,
             torch.bfloat16: 2.0 ** -8, torch.float16: 2.0 ** -11}
#: (alpha, beta, with the output operand)
TSM_COEFS = ((1.0, 0.0, False), (0.5, -2.0, True), (-1.0, 1.0, True))
#: float32 inputs over many rows: the root-mean-square error of the Kahan
#: sum must be at most this share of the plain sum's on the same inputs
#: (a float32 emulation of the kernel's order gives about 1/4 at 2^20 and
#: at 4,096,000 rows; a kernel that ignored ``kahan`` would give 1)
KAHAN_GAIN = 0.5


def kahan_depth(n: int, m: int, k: int, dt) -> float:
    """The depth of the compensated bound of the Kahan kernel: a lane's
    8-row group summed plainly (with the products' rounding), then three
    compensated levels (the lane's groups, the lanes, the blocks) at
    ``2u + O(N u^2)`` each, with ``N`` at most the plain depth."""
    d = summation_depth(n, m, k)
    return 8 + 3 * (2 + 2 * d * d * _ACC_UNIT[dt])


def _tsm_check(got, want, scale, dt, depth, n_plain, tag, worst=None):
    """``got`` against the float64 plain ``want``.  A sum of depth ``d`` in
    unit roundoff ``u`` errs by at most ``d * u * sum |terms|`` in any
    order (``scale`` = sum |terms|): the kernel's depth in its
    accumulation dtype (or the compensated depth of :func:`kahan_depth`),
    plus the float64 plain version's (at most its length), plus
    alpha/beta and the output's own rounding (relative, or one subnormal
    spacing near zero).  Returns ``|got - want|``."""
    require(got.shape == want.shape and got.dtype == dt,
            f"{tag}: got {tuple(got.shape)} {got.dtype}")
    fi = torch.finfo(dt)          # the output's subnormal spacing: tiny * eps
    lim = (((depth + 3) * _ACC_UNIT[dt] + (n_plain + 3) * 2.0 ** -53) * scale
           + _OUT_UNIT[dt] * want.abs() + fi.tiny * fi.eps)
    err = (got.double() - want).abs()
    if err.numel() == 0:
        return err
    ratio, emax = float((err / (lim + 1e-300)).max()), float(err.max())
    require(ratio <= 1.0, f"tsm {tag}: error {emax:.3e} above its "
                          f"bound ({ratio:.2f}x)")
    if worst is not None and ratio >= worst[0]:
        worst[:] = [ratio, tag, emax]
    return err


def _rms(errs) -> float:
    return float(torch.cat([e.flatten() for e in errs]).square().mean().sqrt())


def _require_kahan_gain(errs, tag) -> str:
    """The Kahan sum's error at most :data:`KAHAN_GAIN` of the plain sum's
    (root-mean-square, over ``errs[True]`` and ``errs[False]``)."""
    kahan, plain = _rms(errs[True]), _rms(errs[False])
    require(kahan <= KAHAN_GAIN * plain or DEVICE == "cpu",
            f"{tag}: Kahan rms error {kahan:.3e} not below {KAHAN_GAIN} x "
            f"the plain sum's {plain:.3e}")
    return (f"rms error Kahan {kahan:.3e}, plain {plain:.3e} "
            f"({kahan / max(plain, 1e-300):.3f}, at most {KAHAN_GAIN})")


def phase_tsm_grid() -> None:
    g = torch.Generator(device=DEVICE).manual_seed(3)
    worst = {}
    n_cases = 0
    gain = {False: [], True: []}      # float32 at the most rows
    for dt in (torch.float64, torch.float32, torch.bfloat16, torch.float16):
        for n in TSM_NS:
            for m in TSM_DIMS:
                for k in TSM_DIMS:
                    V, W, X, Xs = (torch.randn(*shape, generator=g,
                                               dtype=torch.float64,
                                               device=DEVICE).to(dt)
                                   for shape in ((n, m), (n, k), (m, k),
                                                 (m, k)))
                    Vd, Wd, Xd, Xsd = (t.double() for t in (V, W, X, Xs))
                    vw = Vd.abs().T @ Wd.abs()
                    vx = Vd.abs() @ Xsd.abs()
                    d2 = summation_depth(n, m, k)
                    for alpha, beta, out in TSM_COEFS:
                        tag = (f"{str(dt)[6:]} n={n} m={m} k={k} "
                               f"alpha={alpha} beta={beta}")
                        want = tsmttsm_ref(Vd, Wd, Xd if out else None,
                                           alpha, beta)
                        scale = abs(alpha) * vw + abs(beta) * Xd.abs()
                        for kahan in (False, True):
                            got = tsmttsm(V, W, X if out else None, alpha,
                                          beta, kahan=kahan)
                            key = ("tsmttsm" + (" kahan" if kahan else ""),
                                   str(dt)[6:])
                            depth = (kahan_depth(n, m, k, dt) if kahan
                                     else d2)
                            err = _tsm_check(
                                got, want, scale, dt, depth, n,
                                tag + f" kahan={kahan}",
                                worst.setdefault(key, [0.0, "", 0.0]))
                            if dt == torch.float32 and n == max(TSM_NS):
                                gain[kahan].append(err)
                        want = tsmm_ref(Vd, Xsd, Wd if out else None, alpha,
                                        beta)
                        scale = abs(alpha) * vx + abs(beta) * Wd.abs()
                        got = tsmm(V, Xs, W if out else None, alpha, beta)
                        key = ("tsmm" + (" W" if out else ""), str(dt)[6:])
                        _tsm_check(got, want, scale, dt, m, m, tag,
                                   worst.setdefault(key, [0.0, "", 0.0]))
                        n_cases += 3
    for (kern, dt), (ratio, tag, err) in sorted(worst.items()):
        print(f"[tsm grid] {kern:13s} {dt:9s} worst error {err:.3e} = "
              f"{ratio:.3f} of its bound  (at {tag})")
    print(f"[tsm grid] {n_cases} cases within their bounds: n in {TSM_NS}, "
          f"m, k in {TSM_DIMS}, alpha/beta {TSM_COEFS}")
    print(f"[tsm grid] tsmttsm float32 n={max(TSM_NS)}, all m, k, alpha/beta: "
          + _require_kahan_gain(gain, "tsm grid float32"))



# ------------------------------------------------------------------ phase 8
BLOCK_KERNELS = ("sellcs_spmv", "tsmttsm", "tsmm")


def _counts():
    got = execution.launch_counts()
    return {k: got.get(k, 0) for k in BLOCK_KERNELS}


def _colwise_relres(A, b, x) -> torch.Tensor:
    """True relative residual per column, through the plain SpMV."""
    Ax, _, _ = sellcs_spmv_ref(A, x)
    return (b - Ax).norm(dim=0) / b.norm(dim=0)


def phase_block_cg(fw, card):
    """Slice 2's main path: cg(block=True) at full width."""
    A = fw["A64"]
    op = make_operator(A)
    g = torch.Generator(device=DEVICE).manual_seed(4)
    b = A.permute(torch.randn(A.nrows, WIDTH, generator=g,
                              dtype=torch.float64, device=DEVICE))
    tol = 1e-8
    execution.reset_launch_counts()
    sync()
    t0 = time.perf_counter()
    res = cg(op, b, tol=tol, maxiter=3000, block=True)
    sync()
    secs = time.perf_counter() - t0
    launches = _counts()
    it = res.iters
    relres = _colwise_relres(A, b, res.x)
    ms_iter = 1e3 * secs / max(it, 1)
    print(f"[block cg] laplace3d({NX}) f64 width {WIDTH} tol {tol}: {it} "
          f"iterations in {secs:.3f} s ({ms_iter:.3f} ms/iter), converged="
          f"{bool(res.converged.all())}  [{card}]")
    print(f"[block cg] true relative residual per column: "
          f"{' '.join(f'{r:.2e}' for r in relres.tolist())}")
    print(f"[block cg] launches {launches} (per iteration: 1 sellcs_spmv, "
          f"2 tsmttsm, 4 tsmm; init: 1 each)")
    require(bool(res.converged.all()), "block CG: not converged")
    require(float(relres.max()) <= 10 * tol,
            f"block CG: true residual {float(relres.max())} > {10 * tol}")
    want = {"sellcs_spmv": it + 1, "tsmttsm": 2 * it + 1, "tsmm": 4 * it + 1}
    require(launches == want or DEVICE == "cpu",
            f"block CG launches {launches} != {want}")

    # the same right-hand side through column CG: block sweeps <= column
    sync()
    t0 = time.perf_counter()
    col = cg(op, b, tol=tol, maxiter=3000)
    sync()
    col_secs = time.perf_counter() - t0
    print(f"[block cg] sweeps: block {it}, column CG on the same rhs "
          f"{col.iters} ({col.iters / max(it, 1):.2f}x); time to solution: "
          f"block {secs:.3f} s, column {col_secs:.3f} s "
          f"({1e3 * col_secs / max(col.iters, 1):.3f} ms/iter)  [{card}]")
    require(bool(col.converged.all()), "column CG: not converged")
    require(it <= col.iters, f"block CG took {it} > column {col.iters}")

    # cg_step chunks of 64 must equal the monolithic solve bit for bit
    st = cg_init(op, b, tol=tol, maxiter=3000, block=True)
    while st.it < st.maxiter and not bool(st.done.all()):
        st = cg_step(op, st, 64)
    ch = cg_finalize(st)
    same = (ch.iters == it and torch.equal(ch.x, res.x)
            and torch.equal(ch.resnorm, res.resnorm))
    print(f"[block cg] as cg_step chunks of 64: {ch.iters} iterations, "
          f"bit-identical to the monolithic solve: {same}")
    require(same, "chunked block CG differs from the monolithic one")
    return dict(iters=it, secs=secs, ms_iter=ms_iter, launches=launches,
                op=op, b=b, state=st)


# ------------------------------------------------------------------ phase 9
def phase_block_minres(fw, card) -> None:
    A = fw["A64"]
    op = make_operator(A)
    g = torch.Generator(device=DEVICE).manual_seed(5)
    b = A.permute(torch.randn(A.nrows, WIDTH, generator=g,
                              dtype=torch.float64, device=DEVICE))
    tol = 1e-6
    execution.reset_launch_counts()
    sync()
    t0 = time.perf_counter()
    res = minres(op, b, tol=tol, maxiter=3000, block=True)
    sync()
    secs = time.perf_counter() - t0
    launches = _counts()
    relres = _colwise_relres(A, b, res.x)
    print(f"[block minres] laplace3d({NX}) f64 width {WIDTH} tol {tol}: "
          f"{res.iters} iterations in {secs:.3f} s "
          f"({1e3 * secs / max(res.iters, 1):.3f} ms/iter), converged="
          f"{bool(res.converged.all())}, max true relative residual "
          f"{float(relres.max()):.3e}, launches {launches} (per iteration: 1 "
          f"sellcs_spmv, 4 tsmttsm, 9 tsmm; init: 1 each)  [{card}]")
    require(bool(res.converged.all()), "block MINRES: not converged")
    require(float(relres.max()) <= 10 * tol,
            f"block MINRES: true residual {float(relres.max())} > {10 * tol}")
    it = res.iters
    want = {"sellcs_spmv": it + 1, "tsmttsm": 4 * it + 1, "tsmm": 9 * it + 1}
    require(launches == want or DEVICE == "cpu",
            f"block MINRES launches {launches} != {want}")


# ----------------------------------------------------------------- phase 10
def _laplace3d_eigs(nx: int) -> np.ndarray:
    """All eigenvalues of laplace3d(nx): sum over d of 2 - 2 cos(k_d pi / (nx+1))."""
    h = 2.0 - 2.0 * np.cos(np.arange(1, nx + 1) * np.pi / (nx + 1))
    return np.sort((h[:, None, None] + h[None, :, None]
                    + h[None, None, :]).ravel())


def phase_eigen(fw, card) -> None:
    # Lanczos extrema of laplace3d(NX) must bracket the analytic extremes
    execution.reset_launch_counts()
    lo, hi = lanczos_extrema(make_operator(fw["A64"]))
    emin = 6.0 - 6.0 * np.cos(np.pi / (NX + 1))
    emax = 6.0 + 6.0 * np.cos(np.pi / (NX + 1))
    print(f"[eigen] lanczos_extrema laplace3d({NX}) f64: [{lo:.6f}, "
          f"{hi:.6f}] around the analytic [{emin:.6f}, {emax:.6f}], "
          f"launches {_counts()}")
    require(lo <= emin and hi >= emax, "Lanczos extrema do not bracket")

    # ChebFD on a laplace3d window with closed-form eigenvalues
    r, c, v, n = laplace3d(CHEB_NX)
    A = from_coo(r, c, v, (n, n), C=32, sigma=1, dtype=np.float64,
                 device=DEVICE)
    op = make_operator(A)
    ev = _laplace3d_eigs(CHEB_NX)
    t_lo, t_hi = CHEB_TARGET
    inside = ev[(ev >= t_lo) & (ev <= t_hi)]
    execution.reset_launch_counts()
    res = chebfd(op, CHEB_TARGET, block_size=8, degree=CHEB_DEGREE,
                 sweeps=CHEB_SWEEPS)
    sync()
    conv = (res.eigenvalues >= t_lo) & (res.eigenvalues <= t_hi)
    got, resid = res.eigenvalues[conv], res.residuals[conv]
    print(f"[eigen] chebfd laplace3d({CHEB_NX}) window {CHEB_TARGET}, "
          f"degree {CHEB_DEGREE}, {CHEB_SWEEPS} sweeps: Ritz values "
          f"{np.array2string(got, precision=10)} residuals "
          f"{np.array2string(resid, precision=2)}; analytic "
          f"{np.array2string(inside, precision=10)}; launches {_counts()}")
    require(got.size == inside.size,
            f"chebfd: {got.size} Ritz values in the window, "
            f"{inside.size} eigenvalues")
    require(bool(np.all(np.abs(got - inside) <= resid + 1e-12)),
            "chebfd: a Ritz value lies farther from its eigenvalue than its "
            "residual")

    # KPM moments at full width (float32 probes, bf16-store/f32 operator)
    op16 = make_operator(fw["A16"])
    execution.reset_launch_counts()
    mus = kpm_dos_moments(op16, 64, n_probes=4).double().cpu().numpy()
    print(f"[eigen] kpm_dos_moments laplace3d({NX}) bf16-store/f32, 4 "
          f"probes, 64 moments: mu_0 = {mus[0]:.7f}, max |mu_m| "
          f"(m >= 1) = {np.abs(mus[1:]).max():.5f}, launches {_counts()}")
    # mu_m = <v, T_m(A_s) v> with ||v|| = 1 and ||T_m(A_s)|| <= 1; the
    # float32 recurrence of 64 steps rounds by far less than 1e-3
    require(abs(mus[0] - 1.0) <= 1e-5, f"kpm: mu_0 = {mus[0]}")
    require(bool(np.all(np.abs(mus) <= 1.0 + 1e-3)), "kpm: |mu_m| > 1")


# ----------------------------------------------------------------- phase 11
#: H100 SXM peak rates outside the tensor cores (NVIDIA data sheet), the
#: operations bound's denominators
PEAK_FLOPS = {torch.float64: 34e12, torch.float32: 67e12}


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def phase_tsm_timing(fw, card):
    """B2 and B3 at the block-CG shapes (n rows, width 16): kernel, plain
    version and one PyTorch call computing the same function."""
    n = fw["A64"].nrows_pad
    rows = {}
    gains = []
    for dt in (torch.float64, torch.float32):
        g = torch.Generator(device="cuda").manual_seed(6)
        V, W = (torch.randn(n, WIDTH, generator=g, dtype=dt, device="cuda")
                for _ in range(2))
        X = torch.randn(WIDTH, WIDTH, generator=g, dtype=dt, device="cuda")
        Vd, Wd, Xd = V.double(), W.double(), X.double()
        flops = 2.0 * n * WIDTH * WIDTH
        vw, vx = Vd.abs().T @ Wd.abs(), Vd.abs() @ Xd.abs()
        d2 = summation_depth(n, WIDTH, WIDTH)
        # (..., oracle, sum |terms|, summation depth, oracle's depth)
        cases = [
            ("tsmttsm", "kahan", lambda: tsmttsm(V, W, kahan=True),
             lambda: tsmttsm_ref(V, W, kahan=True),
             lambda: torch.addmm(X, V.mT, W, beta=0.0, alpha=1.0),
             lambda: tsmttsm_ref(Vd, Wd), (V, W), vw,
             kahan_depth(n, WIDTH, WIDTH, dt), n),
            ("tsmttsm", "plain sum", lambda: tsmttsm(V, W),
             lambda: tsmttsm_ref(V, W),
             lambda: torch.addmm(X, V.mT, W, beta=0.0, alpha=1.0),
             lambda: tsmttsm_ref(Vd, Wd), (V, W), vw, d2, n),
            ("tsmm", "with W", lambda: tsmm(V, X, W, 1.0, 1.0),
             lambda: tsmm_ref(V, X, W, 1.0, 1.0),
             lambda: torch.addmm(W, V, X, beta=1.0, alpha=1.0),
             lambda: tsmm_ref(Vd, Xd, Wd, 1.0, 1.0), (V, X, W),
             vx + Wd.abs(), WIDTH, WIDTH),
            ("tsmm", "without W", lambda: tsmm(V, X), lambda: tsmm_ref(V, X),
             lambda: torch.mm(V, X), lambda: tsmm_ref(Vd, Xd), (V, X), vx,
             WIDTH, WIDTH),
        ]
        errs = {}
        for (name, variant, kern, plain, lib, oracle, inputs, scale, depth,
             n_plain) in cases:
            got = kern()
            abs_err = _tsm_check(got, oracle(), scale, dt, depth, n_plain,
                                 f"{name} {variant} {str(dt)[6:]} n={n}")
            if name == "tsmttsm":
                errs[variant == "kahan"] = [abs_err]
            err = float(abs_err.max())
            ms = time_ms(kern)
            slow = variant == "kahan"            # a Python loop over blocks
            plain_ms = time_ms(plain, warmup=1 if slow else 3,
                               iters=2 if slow else 20)
            lib_ms = time_ms(lib)
            # bytes: each input read once, the result written once
            nbytes = _nbytes(*inputs, got)
            bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
            ops_ms = 1e3 * flops / PEAK_FLOPS[dt]
            bound_ms = max(bytes_ms, ops_ms)
            print(f"[timing] {name} {variant} {str(dt)[6:]} n={n} m=k={WIDTH}:"
                  f" kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
                  f"{lib_ms:.4f} ms, bound {bound_ms:.4f} ms "
                  f"({nbytes / 1e6:.1f} MB; operations {ops_ms:.4f} ms), "
                  f"{100 * bound_ms / ms:.1f}% of bound, max abs err "
                  f"{err:.3e}  [{card}]")
            rows[(name, variant, dt)] = dict(
                ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bound_ms,
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                err=err)
            if name == "tsmttsm" and dt == torch.float32 and len(errs) == 2:
                gains.append(f"[timing] tsmttsm float32 n={n}: "
                             + _require_kahan_gain(errs, "main shape"))
    print("\n".join(gains))
    return rows


def phase_block_split(fw, bcg, tsm, card) -> None:
    """Where one full-width block-CG iteration goes: each component timed
    alone at the iteration's shapes (CUDA events), times its count per
    iteration, against the measured ms per iteration.  B1 at this width is
    held against its plain version first."""
    op, st = bcg["op"], bcg["state"]
    P = st.p
    T = op.mv(P)
    e = rel_err(T, sellcs_spmv_ref(fw["A64"], P)[0])
    print(f"[block cg split] sellcs_spmv b={WIDTH} f64 against plain: max rel "
          f"err {e:.3e} (at most {TOL[torch.float64]['vec']})")
    require(e <= TOL[torch.float64]["vec"],
            f"sellcs_spmv b={WIDTH}: rel err {e:.3e} against plain")
    G = block._herm(tsmttsm(P, T, kahan=True))
    eye = torch.eye(WIDTH, dtype=G.dtype, device=G.device)
    rel = 2.0 ** -52 * WIDTH

    def small():
        gamma = block._spd_solve(G, eye)
        tr, rho = block.svqb_factors(G, rel_eps=rel)
        return gamma @ st.cmat, rho @ st.cmat, rho.conj().T

    f64 = torch.float64
    parts = [
        ("sellcs_spmv (b=16)", 1, time_ms(lambda: op.mv(P))),
        ("tsmttsm kahan", 2, tsm[("tsmttsm", "kahan", f64)]["ms"]),
        ("tsmm with W", 3, tsm[("tsmm", "with W", f64)]["ms"]),
        ("tsmm without W", 1, tsm[("tsmm", "without W", f64)]["ms"]),
        ("(b, b) algebra", 1, time_ms(small, warmup=5, iters=50)),
    ]
    total = bcg["ms_iter"]
    rest = total - sum(k * ms for _, k, ms in parts)
    print(f"[block cg split] one iteration = {total:.3f} ms (laplace3d({NX}) "
          f"f64, width {WIDTH})  [{card}]")
    for name, k, ms in parts:
        print(f"[block cg split]   {name:20s} {k} x {ms:.4f} ms = "
              f"{k * ms:.4f} ms ({100 * k * ms / total:.1f}%)")
    print(f"[block cg split]   {'rest':20s} {rest:.4f} ms "
          f"({100 * rest / total:.1f}%): vector arithmetic, launches and "
          f"the per-iteration host synchronisation")


def timed(label, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"[phase] {label}: {time.perf_counter() - t0:.1f} s")
    return out


def _kernel_entry(name, launches, row):
    source, replaces = KERNELS[name]
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": row["err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row.get("bound_by", "bytes"),
            "library_ms": row["library_ms"]}


def main() -> int:
    card = timed("environment", phase_environment)
    timed("build", phase_build)
    timed("spmv grid", phase_grid)
    timed("tsm grid", phase_tsm_grid)
    timed("case study", phase_case_study)
    fw = timed("full width column CG", phase_full_width, card)
    timed("quickstart", phase_quickstart, fw["A64"])
    bcg = timed("block CG", phase_block_cg, fw, card)
    timed("block MINRES", phase_block_minres, fw, card)
    timed("eigensolvers", phase_eigen, fw, card)
    rows = timed("spmv timing", phase_timing, fw, card)
    tsm = timed("tsm timing", phase_tsm_timing, fw, card)
    timed("block CG split", phase_block_split, fw, bcg, tsm, card)
    for r in rows:
        if r["b"] == 4:
            n = fw["launches"] if r["label"] == "f64" else fw["launches16"]
            kern_s = n * r["ms"] * 1e-3
            solve_s = fw["solve_s"][r["label"]]
            print(f"[time split] {r['label']} column CG b=4: {n} launches x "
                  f"{r['ms']:.4f} ms = {kern_s:.3f} s of the {solve_s:.3f} s "
                  f"solve ({100 * kern_s / solve_s:.1f}% in the SpMV kernel)")
    main_row = next(r for r in rows if r["label"] == "f64" and r["b"] == 4)
    f64 = torch.float64
    print(json.dumps({"kernels": [
        _kernel_entry(KERNEL, fw["launches"], main_row),
        _kernel_entry("tsmttsm", bcg["launches"]["tsmttsm"],
                      tsm[("tsmttsm", "kahan", f64)]),
        _kernel_entry("tsmm", bcg["launches"]["tsmm"],
                      tsm[("tsmm", "with W", f64)]),
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

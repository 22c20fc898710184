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
    the time split of one full-width block-CG iteration;
12. B4 (block-diagonal matmul, the block-Jacobi apply) and B5 (fused
    axpby + dots) against their plain versions computed in float64, over
    block sizes, widths, block counts, row counts, dtypes, coefficients
    and dot flags, each held to a stated error bound;
13. slice 4's main path at full width: block-Jacobi preconditioned CG
    (``M=make_preconditioner("block_jacobi", ...)``, bs = C = 32) on
    anisotropic_laplace2d(2048, eps=1e-2) (4,194,304 rows, sigma=1),
    float64, four right-hand sides, with the host set-up time, launches of
    B1 and B4, the true residual per column, a chunked solve equal to the
    monolithic one, and plain CG on the same right-hand sides beside it;
    the true residual checked again through B5 (its only path: no solver
    calls it, in either package);
14. block-Jacobi preconditioned MINRES on the same matrix, and
    Chebyshev-preconditioned CG on anisotropic_laplace2d(1024);
15. timing of B4 and B5 at the main shapes, and the time split of one
    preconditioned CG iteration.

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
from repro_torch.kernels import fused_update  # noqa: E402
from repro_torch.kernels.block_diag import MAX_BS  # noqa: E402
from repro_torch.kernels.ops import (block_jacobi_apply,  # noqa: E402
                                     fused_axpby_dots, sellcs_spmv, tsmm,
                                     tsmttsm)
from repro_torch.kernels.ref import (block_diag_matmul_ref,  # noqa: E402
                                     fused_axpby_dots_ref, sellcs_spmv_ref,
                                     tsmm_ref, tsmttsm_ref)
from repro_torch.kernels.tsmttsm import MAX_DIM, summation_depth  # noqa: E402
from repro_torch.matrices import (anisotropic_laplace2d,  # noqa: E402
                                  laplace3d, matpde)
from repro_torch.solvers import (cg, cg_finalize, cg_init, cg_step,  # noqa: E402
                                 chebfd, kpm_dos_moments,
                                 lanczos_extrema, make_operator,
                                 make_preconditioner, minres,
                                 minres_finalize, minres_init, minres_step)
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
    "block_diag_matmul": ("src/repro_torch/kernels/csrc/block_diag.cu",
                          "src/repro/kernels/block_diag.py:50"),
    "fused_axpby_dots": ("src/repro_torch/kernels/csrc/fused_update.cu",
                         "src/repro/kernels/fused_update.py:42"),
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
#: slice 4: the preconditioned main path's grid (anisotropic_laplace2d,
#: eps 1e-2, C=32, sigma=1, so the aligned bs=32 blocks are segments of
#: the strong grid lines, as in the JAX package's benchmarks/table_precond.py),
#: the grid of the Chebyshev-preconditioned solve, and the block size
PRECOND_NX, CHEB_PCG_NX, PRECOND_EPS, PRECOND_C = 2048, 1024, 1e-2, 32
PCG_TOL, PMINRES_TOL, PRECOND_WIDTH = 1e-8, 1e-6, 4
#: B4 and B5 grids
B4_BS = (1, 4, 8, 16, 32, 48, MAX_BS)
B4_B = (1, 3, 4, 16)
B4_NB = (0, 1, 7, 4096)
B5_NS = (0, 1, 37, 4109, 1 << 20)
#: (from bw = 86 on a thread block has fewer threads than (dot, column) pairs)
B5_BW = (1, 3, 4, 16, 86, 256)


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
                                 r"tsmttsm_finish|tsmm_rows|block_diag_rows|"
                                 r"axpby_dots_partial|axpby_dots_finish)"
                                 r"I(\w+?)EEv",
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
PRECOND_KERNELS = ("sellcs_spmv", "block_diag_matmul")


def _counts(names=BLOCK_KERNELS):
    got = execution.launch_counts()
    return {k: got.get(k, 0) for k in names}


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


# ----------------------------------------------------------------- phase 12
#: (blocks dtype, x dtype) of the B4 grid: four dtypes and one mixed pair
B4_PAIRS = ((torch.float64, torch.float64), (torch.float32, torch.float32),
            (torch.bfloat16, torch.bfloat16), (torch.float16, torch.float16),
            (torch.bfloat16, torch.float32))


def _unit(dt) -> float:
    """Unit roundoff of ``dt``'s accumulation dtype."""
    return 2.0 ** -53 if dt == torch.float64 else 2.0 ** -24


def _b4_check(blocks, x, tag, worst):
    """B4 against its plain version computed in float64 from the same
    inputs.  A row sums ``bs`` products in order, so it errs by at most
    ``(bs + 2) u_acc sum_j |B_ij| |x_jc|`` (the products' rounding
    included), plus the float64 plain version's ``(bs + 2) 2^-53`` of the
    same sum, plus the output's own rounding (relative, or one subnormal
    spacing near zero).  Returns the worst ratio of error to bound and the
    largest error."""
    got = block_jacobi_apply(blocks, x)
    bs = blocks.shape[1]
    out = torch.promote_types(blocks.dtype, x.dtype)
    x2 = x if x.ndim == 2 else x[:, None]
    want = block_diag_matmul_ref(blocks.double(), x2.double())
    scale = block_diag_matmul_ref(blocks.double().abs(), x2.double().abs())
    if x.ndim == 1:
        want, scale = want[:, 0], scale[:, 0]
    require(got.dtype == out and got.shape == want.shape,
            f"B4 {tag}: got {tuple(got.shape)} {got.dtype}")
    fi = torch.finfo(out)
    lim = ((bs + 2) * (_unit(out) + 2.0 ** -53) * scale
           + _OUT_UNIT[out] * want.abs() + fi.tiny * fi.eps)
    err = (got.double() - want).abs()
    if err.numel() == 0:
        return 0.0
    ratio, emax = float((err / lim).max()), float(err.max())
    require(ratio <= 1.0, f"B4 {tag}: error {emax:.3e} above its bound "
                          f"({ratio:.2f}x)")
    if ratio >= worst[0]:
        worst[:] = [ratio, tag, emax]
    return emax


def phase_b4_grid() -> None:
    g = torch.Generator(device=DEVICE).manual_seed(7)
    worst = {}
    n_cases = 0
    for bd, xd in B4_PAIRS:
        key = f"{str(bd)[6:]} x {str(xd)[6:]}"
        w = worst.setdefault(key, [0.0, "", 0.0])
        for bs in B4_BS:
            for nb in B4_NB:
                blocks = torch.randn(nb, bs, bs, generator=g,
                                     dtype=torch.float64,
                                     device=DEVICE).to(bd)
                for b in B4_B:
                    x = torch.randn(nb * bs, b, generator=g,
                                    dtype=torch.float64, device=DEVICE).to(xd)
                    _b4_check(blocks, x, f"{key} bs={bs} nb={nb} b={b}", w)
                    n_cases += 1
                x = torch.randn(nb * bs, generator=g, dtype=torch.float64,
                                device=DEVICE).to(xd)
                _b4_check(blocks, x, f"{key} bs={bs} nb={nb} 1-d", w)
                n_cases += 1
    sync()
    for key, (ratio, tag, err) in worst.items():
        print(f"[b4 grid] {key:19s} worst error {err:.3e} = {ratio:.3f} of "
              f"its bound  (at {tag})")
    print(f"[b4 grid] {n_cases} cases within the bound (bs + 2)(u_acc + "
          f"2^-53) sum|B||x| + u_out |y|: bs in {B4_BS}, b in {B4_B} and "
          f"1-d, nblocks in {B4_NB}")


def _b5_check(x, y, a, b, flags, tag, worst):
    """B5 against its plain version computed in float64 from the same
    inputs (``a``/``b`` as the kernel sees them, in the accumulation
    dtype).  ``y'`` errs by at most ``3 u_acc (|a x| + |b y|)`` plus the
    output's rounding; each dot by at most ``(depth + 6) u_acc`` times the
    sum of its terms' magnitudes (``depth`` the kernel's longest addition
    chain, ``fused_update.summation_depth``) plus the float64 plain
    version's ``(n + 6) 2^-53`` of the same sum."""
    out = torch.promote_types(x.dtype, y.dtype)
    acc = torch.float64 if out == torch.float64 else torch.float32
    n, bw = x.shape
    av = fused_update.coefficients(a, bw, acc, DEVICE).double()
    bv = fused_update.coefficients(b, bw, acc, DEVICE).double()
    got, dots = fused_axpby_dots(x, y, a, b, dot_yy=flags[0],
                                 dot_xy=flags[1], dot_xx=flags[2])
    xd, yd = x.double(), y.double()
    want, wdots = fused_axpby_dots_ref(xd, yd, av, bv, dot_yy=flags[0],
                                       dot_xy=flags[1], dot_xx=flags[2])
    require(got.dtype == out and got.shape == want.shape,
            f"B5 {tag}: got {tuple(got.shape)} {got.dtype}")
    u = _unit(out)
    mag = av.abs() * xd.abs() + bv.abs() * yd.abs()
    fi = torch.finfo(out)
    lim = 3 * u * mag + _OUT_UNIT[out] * want.abs() + fi.tiny * fi.eps
    ratio = float((((got.double() - want).abs()) / lim).max()) if n else 0.0
    require(ratio <= 1.0, f"B5 {tag}: y' error {ratio:.2f}x its bound")
    if not any(flags):
        require(dots is None, f"B5 {tag}: dots without a flag")
    else:
        require(dots is not None and dots.dtype == acc
                and dots.shape == (3, bw), f"B5 {tag}: dots {dots}")
        depth = fused_update.summation_depth(n, bw)
        scale = torch.stack([(mag * mag).sum(0), (xd.abs() * mag).sum(0),
                             (xd * xd).sum(0)])
        dlim = ((depth + 6) * u + (n + 6) * 2.0 ** -53) * scale + 1e-300
        derr = (dots.double() - wdots).abs()
        r2 = float((derr / dlim).max())
        require(r2 <= 1.0, f"B5 {tag}: dots error {float(derr.max()):.3e} "
                           f"{r2:.2f}x their bound")
        ratio = max(ratio, r2)
    if ratio >= worst[0]:
        worst[:] = [ratio, tag]


B5_FLAGS = tuple((yy, xy, xx) for yy in (False, True) for xy in (False, True)
                 for xx in (False, True))


def phase_b5_grid() -> None:
    g = torch.Generator(device=DEVICE).manual_seed(8)
    worst = {}
    n_cases = 0
    for dt in (torch.float64, torch.float32, torch.bfloat16, torch.float16):
        w = worst.setdefault(str(dt)[6:], [0.0, ""])
        for n in B5_NS:
            for bw in B5_BW:
                x, y = (torch.randn(n, bw, generator=g, dtype=torch.float64,
                                    device=DEVICE).to(dt) for _ in range(2))
                coefs = [(0.75, -1.25, "scalar"),
                         (torch.randn(bw, generator=g, dtype=torch.float64,
                                      device=DEVICE),
                          torch.randn(bw, generator=g, dtype=torch.float64,
                                      device=DEVICE), "per-column")]
                for a, b, kind in coefs:
                    for flags in B5_FLAGS:
                        _b5_check(x, y, a, b, flags,
                                  f"{str(dt)[6:]} n={n} bw={bw} {kind} "
                                  f"dots={flags}", w)
                        n_cases += 1
        x1, y1 = (torch.randn(4109, generator=g, dtype=torch.float64,
                              device=DEVICE).to(dt) for _ in range(2))
        out, dots = fused_axpby_dots(x1, y1, 2.0, 0.5, dot_yy=True,
                                     dot_xy=True, dot_xx=True)
        want, wdots = fused_axpby_dots(x1[:, None], y1[:, None], 2.0, 0.5,
                                       dot_yy=True, dot_xy=True, dot_xx=True)
        require(out.shape == (4109,) and dots.shape == (3,)
                and torch.equal(out, want[:, 0])
                and torch.equal(dots, wdots[:, 0]),
                f"B5 1-d {dt}: differs from the (n, 1) call")
        n_cases += 1
    sync()
    for key, (ratio, tag) in worst.items():
        print(f"[b5 grid] {key:9s} worst error = {ratio:.3f} of its bound  "
              f"(at {tag})")
    print(f"[b5 grid] {n_cases} cases within their bounds (y': 3 u_acc "
          f"(|a x| + |b y|) + u_out |y'|; dots: (depth + 6) u_acc sum|terms|):"
          f" n in {B5_NS}, bw in {B5_BW}, scalar and per-column a/b, every "
          f"combination of the dot flags, and 1-d inputs")


# ----------------------------------------------------------------- phase 13
def _aniso(nx: int):
    r, c, v, n = anisotropic_laplace2d(nx, epsilon=PRECOND_EPS)
    t0 = time.perf_counter()
    A = from_coo(r, c, v, (n, n), C=PRECOND_C, sigma=1, dtype=np.float64,
                 device=DEVICE)
    sync()
    print(f"[precond] anisotropic_laplace2d({nx}, eps={PRECOND_EPS}) n={n} "
          f"nnz={A.nnz} C={PRECOND_C} sigma=1: f64 build "
          f"{time.perf_counter() - t0:.1f} s")
    return A


def phase_precond_cg(card):
    """Slice 4's main path: block-Jacobi preconditioned CG at full width."""
    A = _aniso(PRECOND_NX)
    op = make_operator(A)
    # the host set-up as a user makes it: extraction and factorization on
    # the host, then the copy of the inverses to the card
    t0 = time.perf_counter()
    M = make_preconditioner("block_jacobi", matrix=A)
    sync()
    t_setup = time.perf_counter() - t0
    print(f"[pcg] host set-up: make_preconditioner('block_jacobi') "
          f"{t_setup:.2f} s (bs = {M.block_size}, "
          f"{M.inv_blocks.shape[0]} blocks, "
          f"{M.inv_blocks.numel() * 8 / 1e9:.3f} GB of f64 inverses on the "
          f"card)")
    g = torch.Generator(device=DEVICE).manual_seed(9)
    b = A.permute(torch.randn(A.nrows, PRECOND_WIDTH, generator=g,
                              dtype=torch.float64, device=DEVICE))
    maxiter = 8 * A.nrows
    execution.reset_launch_counts()
    sync()
    t0 = time.perf_counter()
    res = cg(op, b, tol=PCG_TOL, maxiter=maxiter, M=M)
    sync()
    secs = time.perf_counter() - t0
    launches = _counts(PRECOND_KERNELS)
    it = res.iters
    relres = _colwise_relres(A, b, res.x)
    ms_iter = 1e3 * secs / max(it, 1)
    print(f"[pcg] block_jacobi PCG f64 b={PRECOND_WIDTH} tol {PCG_TOL}: {it} "
          f"iterations in {secs:.3f} s ({ms_iter:.3f} ms/iter), converged="
          f"{bool(res.converged.all())}  [{card}]")
    print(f"[pcg] true relative residual per column: "
          f"{' '.join(f'{r:.2e}' for r in relres.tolist())}")
    print(f"[pcg] launches {launches} (per iteration 1 sellcs_spmv and 1 "
          f"block_diag_matmul; cg_init 1 each)")
    require(bool(res.converged.all()), "PCG: not converged")
    require(float(relres.max()) <= 10 * PCG_TOL,
            f"PCG: true residual {float(relres.max())} > {10 * PCG_TOL}")
    want = {"sellcs_spmv": it + 1, "block_diag_matmul": it + 1}
    require(launches == want or DEVICE == "cpu",
            f"PCG launches {launches} != {want}")

    # cg_step chunks of 256 must equal the monolithic solve bit for bit
    st = cg_init(op, b, tol=PCG_TOL, maxiter=maxiter, M=M)
    while st.it < st.maxiter and not bool(st.done.all()):
        st = cg_step(op, st, 256, M=M)
    ch = cg_finalize(st)
    same = (ch.iters == it and torch.equal(ch.x, res.x)
            and torch.equal(ch.resnorm, res.resnorm))
    print(f"[pcg] as cg_step chunks of 256: {ch.iters} iterations, "
          f"bit-identical to the monolithic solve: {same}")
    require(same, "chunked PCG differs from the monolithic one")

    # plain CG on the same right-hand sides: sweeps and time to solution
    sync()
    t0 = time.perf_counter()
    plain = cg(op, b, tol=PCG_TOL, maxiter=maxiter)
    sync()
    plain_secs = time.perf_counter() - t0
    prel = _colwise_relres(A, b, plain.x)
    print(f"[pcg] plain CG on the same rhs: {plain.iters} iterations in "
          f"{plain_secs:.3f} s ({1e3 * plain_secs / max(plain.iters, 1):.3f}"
          f" ms/iter), converged={bool(plain.converged.all())}, max true "
          f"relative residual {float(prel.max()):.2e}; PCG takes "
          f"{plain.iters / max(it, 1):.2f}x fewer iterations and "
          f"{plain_secs / secs:.2f}x less time  [{card}]")
    require(bool(plain.converged.all()), "plain CG: not converged")
    return dict(A=A, op=op, M=M, b=b, res=res, iters=it, secs=secs,
                ms_iter=ms_iter, launches=launches, state=st,
                plain_iters=plain.iters, plain_secs=plain_secs)


def phase_b5_residual(pcg, card) -> int:
    """B5 on its one path in this script: the true residual of the PCG
    solution, ``r = b - A x`` with ``<r, r>`` and ``<b, b>`` in one sweep,
    held against the plain SpMV's residual.  Returns B5's launches."""
    op, b, x = pcg["op"], pcg["b"], pcg["res"].x
    execution.reset_launch_counts()
    Ax = op.mv(x)
    r, dots = fused_axpby_dots(b, Ax, 1.0, -1.0, dot_yy=True, dot_xx=True)
    relres = torch.sqrt(dots[0] / dots[2])
    sync()
    launches = execution.launch_counts().get("fused_axpby_dots", 0)
    plain = _colwise_relres(pcg["A"], b, x)
    diff = float(((relres - plain).abs() / plain).max())
    print(f"[b5 path] PCG true relative residual through fused_axpby_dots: "
          f"{' '.join(f'{v:.6e}' for v in relres.tolist())}; through the "
          f"plain SpMV: {' '.join(f'{v:.6e}' for v in plain.tolist())}; "
          f"max relative difference {diff:.2e}; fused_axpby_dots launches "
          f"{launches}")
    # r is the difference of nearly equal vectors (|r| ~ 1e-8 |b|), so
    # the two SpMVs' different summation orders show at ~1e-8 of |r|
    require(diff <= 1e-4, f"B5 residual differs from plain by {diff}")
    require(launches == 1 or DEVICE == "cpu",
            f"fused_axpby_dots launches {launches} != 1")
    return launches


def _m_relres(M, A, b, x) -> torch.Tensor:
    """True relative residual in the M-norm, sqrt(<r, M r> / <b, M b>):
    the norm preconditioned MINRES converges in."""
    Ax, _, _ = sellcs_spmv_ref(A, x)
    r = b - Ax
    return torch.sqrt((r * M.apply(r)).sum(0) / (b * M.apply(b)).sum(0))


def phase_precond_minres(pcg, card) -> None:
    A, op, M = pcg["A"], pcg["op"], pcg["M"]
    g = torch.Generator(device=DEVICE).manual_seed(10)
    b = A.permute(torch.randn(A.nrows, PRECOND_WIDTH, generator=g,
                              dtype=torch.float64, device=DEVICE))
    maxiter = 8 * A.nrows
    execution.reset_launch_counts()
    sync()
    t0 = time.perf_counter()
    res = minres(op, b, tol=PMINRES_TOL, maxiter=maxiter, M=M)
    sync()
    secs = time.perf_counter() - t0
    launches = _counts(PRECOND_KERNELS)
    it = res.iters
    mrel = _m_relres(M, A, b, res.x)
    relres = _colwise_relres(A, b, res.x)
    print(f"[pminres] block_jacobi MINRES f64 b={PRECOND_WIDTH} tol "
          f"{PMINRES_TOL}: {it} iterations in {secs:.3f} s "
          f"({1e3 * secs / max(it, 1):.3f} ms/iter), converged="
          f"{bool(res.converged.all())}; true relative residual per column "
          f"in the M-norm {' '.join(f'{v:.2e}' for v in mrel.tolist())}, in "
          f"the 2-norm {' '.join(f'{v:.2e}' for v in relres.tolist())}; "
          f"launches {launches} (per iteration 1 sellcs_spmv, 1 "
          f"block_diag_matmul; init 1 and 2)  [{card}]")
    require(bool(res.converged.all()), "PMINRES: not converged")
    require(float(mrel.max()) <= 10 * PMINRES_TOL,
            f"PMINRES: M-norm residual {float(mrel.max())} > "
            f"{10 * PMINRES_TOL}")
    want = {"sellcs_spmv": it + 1, "block_diag_matmul": it + 2}
    require(launches == want or DEVICE == "cpu",
            f"PMINRES launches {launches} != {want}")
    st = minres_init(op, b, tol=PMINRES_TOL, maxiter=maxiter, M=M)
    while st.it < st.maxiter and not bool(st.done.all()):
        st = minres_step(op, st, 256, M=M)
    ch = minres_finalize(st)
    same = ch.iters == it and torch.equal(ch.x, res.x)
    print(f"[pminres] as minres_step chunks of 256: {ch.iters} iterations, "
          f"bit-identical to the monolithic solve: {same}")
    require(same, "chunked PMINRES differs from the monolithic one")


def phase_chebyshev_pcg(card) -> None:
    """Chebyshev-preconditioned CG (degree 4, spectrum from the port's
    Lanczos): B1 only, (degree - 1) SpMVs per apply plus the outer one."""
    A = _aniso(CHEB_PCG_NX)
    op = make_operator(A)
    t0 = time.perf_counter()
    spectrum = lanczos_extrema(op)
    M = make_preconditioner("chebyshev:4", op=op, spectrum=spectrum)
    sync()
    t_setup = time.perf_counter() - t0
    g = torch.Generator(device=DEVICE).manual_seed(11)
    b = A.permute(torch.randn(A.nrows, PRECOND_WIDTH, generator=g,
                              dtype=torch.float64, device=DEVICE))
    execution.reset_launch_counts()
    sync()
    t0 = time.perf_counter()
    res = cg(op, b, tol=PCG_TOL, maxiter=8 * A.nrows, M=M)
    sync()
    secs = time.perf_counter() - t0
    launches = _counts(PRECOND_KERNELS)
    it = res.iters
    relres = _colwise_relres(A, b, res.x)
    print(f"[cheb pcg] chebyshev:4 PCG f64 b={PRECOND_WIDTH} tol {PCG_TOL}, "
          f"spectrum ({spectrum[0]:.6g}, {spectrum[1]:.6g}) -> interval "
          f"({M.lo:.6g}, {M.hi:.6g}), set-up {t_setup:.2f} s: {it} iterations"
          f" in {secs:.3f} s ({1e3 * secs / max(it, 1):.3f} ms/iter), "
          f"converged={bool(res.converged.all())}, max true relative "
          f"residual {float(relres.max()):.2e}, launches {launches} "
          f"(4 sellcs_spmv per iteration and at init)  [{card}]")
    require(bool(res.converged.all()), "Chebyshev PCG: not converged")
    require(float(relres.max()) <= 10 * PCG_TOL,
            f"Chebyshev PCG: true residual {float(relres.max())}")
    want = {"sellcs_spmv": M.degree * (it + 1), "block_diag_matmul": 0}
    require(launches == want or DEVICE == "cpu",
            f"Chebyshev PCG launches {launches} != {want}")


# ----------------------------------------------------------------- phase 15
def phase_precond_timing(pcg, card):
    """B4 at the PCG main shape (f64, and f32 / bf16-block rows beside
    it) and B5 at n = 4,194,304, bw = 4, f64 with all three dots: kernel,
    plain version, one PyTorch call where one computes the same function,
    and the bound."""
    inv = pcg["M"].inv_blocks
    nb, bs, _ = inv.shape
    n = nb * bs
    g = torch.Generator(device="cuda").manual_seed(12)
    x64 = torch.randn(n, PRECOND_WIDTH, generator=g, dtype=torch.float64,
                      device="cuda")
    rows = {}
    cases = [("f64", inv, x64), ("f32", inv.float(), x64.float()),
             ("bf16 blocks, f32 x", inv.to(torch.bfloat16), x64.float())]
    for label, B, x in cases:
        worst = [0.0, "", 0.0]
        err = _b4_check(B, x, f"timing {label}", worst)
        ms = time_ms(lambda: block_jacobi_apply(B, x))
        plain_ms = time_ms(lambda: block_diag_matmul_ref(B, x), warmup=3,
                           iters=20)
        lib_ms = None
        if B.dtype == x.dtype:       # one call computes it: a batched GEMM
            Bv, xv = B.view(nb, bs, bs), x.view(nb, bs, PRECOND_WIDTH)
            lib_ms = time_ms(lambda: torch.bmm(Bv, xv))
        out_bytes = n * PRECOND_WIDTH * torch.finfo(
            torch.promote_types(B.dtype, x.dtype)).bits // 8
        nbytes = _nbytes(B, x) + out_bytes
        bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
        acc = torch.float64 if label == "f64" else torch.float32
        ops_ms = 1e3 * 2.0 * nb * bs * bs * PRECOND_WIDTH / PEAK_FLOPS[acc]
        bound_ms = max(bytes_ms, ops_ms)
        print(f"[timing] block_diag_matmul {label} nblocks={nb} bs={bs} "
              f"b={PRECOND_WIDTH}: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
              f"ms, library(bmm) "
              f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound "
              f"{bound_ms:.4f} ms ({nbytes / 1e6:.1f} MB; operations "
              f"{ops_ms:.4f} ms), {100 * bound_ms / ms:.1f}% of bound, "
              f"max abs err {err:.3e} ({worst[0]:.3f} of its bound)  "
              f"[{card}]")
        rows[("block_diag_matmul", label)] = dict(
            ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
            bound_by="bytes" if bytes_ms >= ops_ms else "operations",
            err=err)

    y = torch.randn(n, PRECOND_WIDTH, generator=g, dtype=torch.float64,
                    device="cuda")
    a = torch.randn(PRECOND_WIDTH, generator=g, dtype=torch.float64,
                    device="cuda")
    flags = dict(dot_yy=True, dot_xy=True, dot_xx=True)
    worst = [0.0, ""]
    _b5_check(x64, y, a, -0.5, (True, True, True), "timing f64", worst)
    out, dots = fused_axpby_dots(x64, y, a, -0.5, **flags)
    want, _ = fused_axpby_dots_ref(x64, y, a, -0.5, **flags)
    err = float((out - want).abs().max())
    ms = time_ms(lambda: fused_axpby_dots(x64, y, a, -0.5, **flags))
    plain_ms = time_ms(lambda: fused_axpby_dots_ref(x64, y, a, -0.5,
                                                    **flags))
    nbytes = _nbytes(x64, y, a, out, dots) + 8 * PRECOND_WIDTH
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    ops_ms = 1e3 * 8.0 * n * PRECOND_WIDTH / PEAK_FLOPS[torch.float64]
    bound_ms = max(bytes_ms, ops_ms)
    print(f"[timing] fused_axpby_dots f64 n={n} bw={PRECOND_WIDTH}, all "
          f"three dots: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
          f"n/a (no single PyTorch call computes it), bound {bound_ms:.4f} "
          f"ms ({nbytes / 1e6:.1f} MB; operations {ops_ms:.4f} ms), "
          f"{100 * bound_ms / ms:.1f}% of bound, y' max abs err {err:.3e} "
          f"(bounds: {worst[0]:.3f} of the stated ones)  [{card}]")
    rows[("fused_axpby_dots", "f64")] = dict(
        ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms,
        bound_by="bytes" if bytes_ms >= ops_ms else "operations", err=err)
    return rows


def phase_pcg_split(pcg, card) -> None:
    """Where one full-width PCG iteration goes: B1 at b=4 with CG's flags
    and B4, each timed alone with CUDA events at the iteration's shapes,
    against the measured ms per iteration."""
    op, M, st = pcg["op"], pcg["M"], pcg["state"]
    opts = SpmvOpts(dot_xy=True)
    spmv_ms = time_ms(lambda: op.mv_fused(st.p, opts=opts))
    b4_ms = time_ms(lambda: M.apply(st.r))
    total = pcg["ms_iter"]
    rest = total - spmv_ms - b4_ms
    print(f"[pcg split] one iteration = {total:.3f} ms (anisotropic_laplace2d"
          f"({PRECOND_NX}) f64, b={PRECOND_WIDTH})  [{card}]")
    for name, ms in ((f"sellcs_spmv (b={PRECOND_WIDTH})", spmv_ms),
                     ("block_diag_matmul", b4_ms)):
        print(f"[pcg split]   {name:20s} 1 x {ms:.4f} ms "
              f"({100 * ms / total:.1f}%)")
    print(f"[pcg split]   {'rest':20s} {rest:.4f} ms ({100 * rest / total:.1f}"
          f"%): vector arithmetic (about ten passes over ({PRECOND_NX}^2, "
          f"{PRECOND_WIDTH}) vectors), launches and the per-iteration host "
          f"synchronisation")
    print(f"[pcg split] time to solution: PCG {pcg['secs']:.3f} s "
          f"({pcg['iters']} iterations), plain CG {pcg['plain_secs']:.3f} s "
          f"({pcg['plain_iters']} iterations)")


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
    timed("b4 grid", phase_b4_grid)
    timed("b5 grid", phase_b5_grid)
    pcg = timed("preconditioned CG", phase_precond_cg, card)
    b5_launches = timed("b5 path", phase_b5_residual, pcg, card)
    timed("preconditioned MINRES", phase_precond_minres, pcg, card)
    timed("chebyshev PCG", phase_chebyshev_pcg, card)
    pre = timed("precond timing", phase_precond_timing, pcg, card)
    timed("pcg split", phase_pcg_split, pcg, card)
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
        _kernel_entry("block_diag_matmul",
                      pcg["launches"]["block_diag_matmul"],
                      pre[("block_diag_matmul", "f64")]),
        # B5 has no solver path: its launches are the PCG residual check's
        _kernel_entry("fused_axpby_dots", b5_launches,
                      pre[("fused_axpby_dots", "f64")]),
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

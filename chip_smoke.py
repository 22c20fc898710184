#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the CUDA kernels from ``src/repro_torch/kernels/csrc/`` and
drives the port's main path — COO triplets -> SELL-C-sigma -> fused SpMV
kernel -> GhostOperator -> resumable CG — on the card, holding every
kernel against its plain PyTorch version:

1. environment: card name and power limit, CUDA and nvcc versions;
2. build: seconds and the compiler's register/shared-memory/spill report;
3. kernel against plain on the card over a grid of chunk heights, sorting
   windows, store/compute dtypes, block widths and fusion flags;
4. the paper's case study (MATPDE, CG) with the kernel's launch count;
5. full width: block CG on laplace3d(160) (4,096,000 rows) in float64 and
   with bfloat16 storage, plus a chunked float64 solve that must equal the
   monolithic one bit for bit;
6. the quickstart SpMMV (shift, axpby, all dots) at full width;
7. timing of the kernel, its plain version and one PyTorch sparse product
   at the full-width shapes, beside the memory-bandwidth bound.

It prints one JSON line describing every kernel, then as its last line
``{"ok": true, "device": {...}}``.  Any failure exits non-zero before the
last line.  It imports nothing of JAX or of the JAX package.
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
from repro_torch.kernels.ops import sellcs_spmv  # noqa: E402
from repro_torch.kernels.ref import sellcs_spmv_ref  # noqa: E402
from repro_torch.matrices import laplace3d, matpde  # noqa: E402
from repro_torch.solvers import (cg, cg_finalize, cg_init, cg_step,  # noqa: E402
                                 make_operator)

#: H100 SXM device-memory rate (NVIDIA data sheet), the bound's denominator
HBM_BYTES_PER_S = 3.35e12
KERNEL = "sellcs_spmv"
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/sellcs_spmv.cu"
KERNEL_REPLACES = "src/repro/kernels/sellcs_spmv.py:128"
# max |kernel - plain| / max |plain|, by compute dtype
TOL = {torch.float64: {"vec": 1e-12, "dots": 1e-12},
       torch.float32: {"vec": 1e-5, "dots": 1e-6}}
GRID_PAIRS = [(torch.float64, np.float64), (torch.float32, np.float32),
              (torch.bfloat16, np.float32), (torch.float16, np.float32),
              (torch.float32, np.float64)]


#: where the phases run, and the full-width grid (a CPU rehearsal of the
#: control flow may lower both; the card run uses these values)
DEVICE = "cuda"
NX = 160


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
                inst = re.search(r"_fusedI(\w+?)Li(\d+)E", m.group(1))
                entry = f"<{inst.group(1)},{inst.group(2)}>" if inst else m.group(1)
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
    res64, launches, secs = _solve(A64, b64, 1e-8, "(a) f64 b=4", card)
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
                                 "(b) bf16 store, f32 compute, b=4", card)
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


def main() -> int:
    card = phase_environment()
    phase_build()
    phase_grid()
    phase_case_study()
    fw = phase_full_width(card)
    phase_quickstart(fw["A64"])
    rows = phase_timing(fw, card)
    for r in rows:
        if r["b"] == 4:
            n = fw["launches"] if r["label"] == "f64" else fw["launches16"]
            kern_s = n * r["ms"] * 1e-3
            solve_s = fw["solve_s"][r["label"]]
            print(f"[time split] {r['label']} CG b=4: {n} launches x "
                  f"{r['ms']:.4f} ms = {kern_s:.3f} s of the {solve_s:.3f} s "
                  f"solve ({100 * kern_s / solve_s:.1f}% in the SpMV kernel)")
    main_row = next(r for r in rows if r["label"] == "f64" and r["b"] == 4)
    print(json.dumps({"kernels": [{
        "name": KERNEL, "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": fw["launches"],
        "max_abs_err": main_row["err"], "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"], "bound_ms": main_row["bound_ms"],
        "bound_by": "bytes", "library_ms": main_row["library_ms"]}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

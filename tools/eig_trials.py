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

    python tools/eig_trials.py --variants current,t512,t256 --m 128
"""
from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (puts src/ on the path)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.tsmttsm import DTYPE_CODES  # noqa: E402

OUT = ROOT / "build" / "eig_trials"
#: name -> replacements (old, new) applied to the current source; each old
#: text must occur in it
VARIANTS = {
    "current": [],
    # fewer threads in the wide instance: more entries a thread, cheaper
    # barriers
    "t512": [("constexpr int kWideThreads = 1024;",
              "constexpr int kWideThreads = 512;")],
    "t256": [("constexpr int kWideThreads = 1024;",
              "constexpr int kWideThreads = 256;")],
    # ablation (U wrong, timed only): the rounds without U's updates
    "noU": [("""        ap = sU[i * m + p];
        aq = sU[i * m + q];
        sU[i * m + p] = scal(c, ap) - sec * aq;
        sU[i * m + q] = se * ap + scal(c, aq);
""", "")],
}
ABLATIONS = {"noU"}


def _build_all(names):
    base = (_build.CSRC / "herm_eig.cu").read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        src = base
        for old, new in VARIANTS[name]:
            if old not in src:
                raise SystemExit(f"variant {name}: {old!r} not in the source")
            src = src.replace(old, new)
        cu = OUT / f"{name}.cu"
        cu.write_text(src)
        lib = OUT / f"lib{name}.so"
        jobs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
             "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"variant {name} failed to build:\n{log}")
        entry = "?"
        for line in log.splitlines():
            m = re.search(r"Function properties for \S*herm_eig_block(\w+)",
                          line)
            if m:
                entry = m.group(1)
            elif "Used" in line and "Lb1E" in entry:
                regs = re.search(r"Used \d+ registers", line)
                print(f"[ptxas] {name} herm_eig_block{entry}: "
                      f"{regs.group(0) if regs else line.strip()}")
            elif "spill" in line and "Lb1E" in entry:
                print(f"[ptxas] {name} herm_eig_block{entry}: {line.strip()}")
        dll = ctypes.CDLL(str(lib))
        fn = dll.herm_eig_launch
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 5 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        libs[name] = fn
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
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
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
        work = torch.empty(2 * m * m, dtype=dt, device="cuda")
        times = {name: [] for name in libs}
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
        names = list(libs)
        for r in range(opts.rounds):
            for name in (names if r % 2 == 0 else names[::-1]):
                lib = libs[name]
                times[name].append(chip_smoke.time_ms(
                    lambda: _run(lib, A, w, U, conv, work), warmup=3,
                    iters=20))
        for name, ts in times.items():
            print(f"[time] {name}{' (ablation)' if name in ABLATIONS else ''}"
                  f" {str(dt)[6:]} m={m}: "
                  f"{' / '.join(f'{t:.4f}' for t in ts)} ms, best "
                  f"{min(ts):.4f}  [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Build the CUDA sources under ``kernels/csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into a shared library with
a plain C interface, at first use, into ``build/repro_torch/`` at the root
of the checkout (git-ignored).  The library's file name carries a hash of
the source, the shared headers (``csrc/*.cuh``) and the flags, so an
edited source or header never loads a stale build.
``build()`` starts one ``nvcc`` per source, all together, and waits for
them; ``load()`` builds what is missing and returns the loaded library.

A missing ``nvcc`` or a failed compile raises: there is no path that
skips the kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Optional

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "sources", "build", "load",
           "build_logs"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: Dict[str, ctypes.CDLL] = {}
#: name -> compiler output (ptxas registers, shared memory, spills) of the
#: builds made by this process
build_logs: Dict[str, str] = {}


def sources() -> List[str]:
    """Names of the CUDA sources (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME/bin; the "
                       "CUDA kernels cannot be built")


def _library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Optional[Iterable[str]] = None) -> None:
    """Compile the named sources (default: all) that have no current build,
    one ``nvcc`` per source, started together."""
    names = sources() if names is None else list(names)
    jobs = []
    for name in names:
        out = _library_path(name)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((name, out, tmp, proc))
    failed = []
    for name, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        build_logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = _libs[name] = ctypes.CDLL(str(_library_path(name)))
    return lib

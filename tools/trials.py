"""What the kernel design-trial scripts (``tools/*_trials.py``) share: the
card's name line, textual variants of a source, building them all at once
with the package's nvcc flags, the compiler's report per function, an entry
point through ctypes, a wrapper run through another build's entry, and
timing in turns.  Needs the card machine's toolchain for ``build``; the
rest runs anywhere."""
from __future__ import annotations

import ctypes
import re
import subprocess
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

#: (old, new) text replacements applied to a source in order
Replacements = Sequence[Tuple[str, str]]


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def apply(src: str, replacements: Replacements, what: str) -> str:
    """``src`` with each replacement made; every old text must occur."""
    for old, new in replacements:
        if old not in src:
            raise SystemExit(f"{what}: {old!r} not in the source")
        src = src.replace(old, new)
    return src


def build(out: Path, sources: Dict[str, Tuple[str, Optional[Path]]]
          ) -> Dict[str, Tuple[Path, str]]:
    """Builds each ``tag -> (source text, include directory or None)`` into
    ``out/lib<tag>.so``, one ``nvcc`` each, all started together; returns
    ``tag -> (library, compiler log)`` and exits on the first failure."""
    from repro_torch.kernels import _build
    out.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for tag, (src, include) in sources.items():
        cu, lib = out / f"{tag}.cu", out / f"lib{tag}.so"
        cu.write_text(src)
        inc = ["-I", str(include)] if include is not None else []
        jobs[tag] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, *inc, "-o", str(lib),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    built = {}
    for tag, (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"{tag} failed to build:\n{log}")
        built[tag] = (lib, log)
    return built


def functions(log: str) -> List[Tuple[str, str, str]]:
    """``(mangled name, spill line, registers line)`` of each function in a
    ``ptxas -v`` report."""
    found, name, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name, spill = m.group(1), ""
        elif name and "spill" in line:
            spill = line.strip()
        elif name and "Used" in line:
            regs = re.search(r"Used \d+ registers", line)
            found.append((name, spill, regs.group(0) if regs
                          else line.strip()))
            name = None
    return found


def report(tag: str, log: str, pattern: str,
           label: Callable[[re.Match], Optional[str]] = lambda m: m.group(1)
           ) -> None:
    """Prints registers and spills of the functions of ``log`` whose mangled
    name matches ``pattern``, each named by ``label`` (None: skipped)."""
    for name, spill, regs in functions(log):
        m = re.search(pattern, name)
        if m and label(m) is not None:
            print(f"[ptxas] {tag} {label(m)}: {regs}; {spill}")


def entry(lib: Path, symbol: str, argtypes: Iterable) -> Callable:
    """The C function ``symbol`` of ``lib``, returning an int."""
    fn = getattr(ctypes.CDLL(str(lib)), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def through(module, fn: Callable, wrapped: Callable) -> Callable:
    """``wrapped`` (a wrapper of ``module``) with ``module._entry`` giving
    ``fn`` for the duration of each call."""
    def call(*args, **kw):
        saved = module._entry
        module._entry = lambda: fn
        try:
            return wrapped(*args, **kw)
        finally:
            module._entry = saved
    return call


def in_turns(cases: Dict[str, Callable], rounds: int, time_ms: Callable,
             **kw) -> Dict[str, List[float]]:
    """Times every case ``rounds`` times with ``time_ms(fn, **kw)``, in
    turns, the order reversed every other round; returns each case's
    times."""
    times = {key: [] for key in cases}
    keys = list(cases)
    for r in range(rounds):
        for key in (keys if r % 2 == 0 else keys[::-1]):
            times[key].append(time_ms(cases[key], **kw))
    return times


def times_text(ts: Sequence[float]) -> str:
    """``a / b / c ms, best x``."""
    return (f"{' / '.join(f'{t:.4f}' for t in ts)} ms, best "
            f"{min(ts):.4f}")

"""The port stands alone: no JAX and nothing of the JAX package under
``src/repro_torch/`` or in ``chip_smoke.py``, no path that hides the card
or the kernel, and entry points that run on the card unless told
otherwise."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import execution, from_coo
from repro_torch.interop import sellcs_from_arrays
from repro_torch.kernels import _build
from tools.ghostlint import lint_paths

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
PORT_FILES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(REPO)) for p in PORT_FILES])
def test_no_jax_or_reference_imports(path):
    roots = set(_imported_roots(path))
    assert not roots & {"jax", "jaxlib", "repro"}, roots


def test_port_has_its_modules():
    want = {"core/sellcs.py", "core/spmv.py", "core/execution.py",
            "core/blockvec.py",
            "kernels/ops.py", "kernels/ref.py", "kernels/sellcs_spmv.py",
            "kernels/tsmttsm.py", "kernels/tsmm.py",
            "kernels/block_diag.py", "kernels/fused_update.py",
            "kernels/_build.py", "kernels/csrc/sellcs_spmv.cu",
            "kernels/csrc/tsmttsm.cu", "kernels/csrc/tsmm.cu",
            "kernels/csrc/block_diag.cu", "kernels/csrc/fused_update.cu",
            "kernels/csrc/dtypes.cuh",
            "matrices/generators.py", "matrices/mmio.py",
            "solvers/operator.py", "solvers/stepper.py", "solvers/cg.py",
            "solvers/block.py", "solvers/minres.py", "solvers/lanczos.py",
            "solvers/chebfd.py", "solvers/kpm.py", "solvers/precond.py",
            "interop.py"}
    have = {str(p.relative_to(PORT)) for p in PORT.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}
    assert want <= have


NO_TRY = ["kernels/ops.py", "kernels/sellcs_spmv.py", "kernels/tsmttsm.py",
          "kernels/tsmm.py", "kernels/block_diag.py",
          "kernels/fused_update.py", "kernels/ref.py", "kernels/_build.py",
          "core/spmv.py",
          "core/execution.py", "core/blockvec.py", "solvers/block.py",
          "solvers/cg.py", "solvers/minres.py", "solvers/lanczos.py",
          "solvers/chebfd.py", "solvers/kpm.py", "../../chip_smoke.py"]


@pytest.mark.parametrize("rel", NO_TRY)
def test_no_try_around_build_or_launch(rel):
    """A kernel that fails to build or launch raises; nothing catches it,
    and no phase of chip_smoke.py is wrapped in a ``try``."""
    tree = ast.parse((PORT / rel).read_text())
    assert not any(isinstance(n, ast.Try) for n in ast.walk(tree))
    assert "REPRO_" not in (PORT / rel).read_text()


@pytest.mark.parametrize("name", ["sellcs_spmv", "tsmttsm", "tsmm",
                                  "block_diag", "fused_update"])
def test_cuda_sources_return_the_launch_error(name):
    """Every CUDA source states what it replaces and its bound, and its C
    entry point returns ``cudaGetLastError()``."""
    src = (PORT / "kernels" / "csrc" / f"{name}.cu").read_text()
    assert "Replaces: repro/kernels/" in src and "Bound:" in src
    assert f'extern "C" int {name}_launch' in src
    assert "return (int)cudaGetLastError();" in src


@pytest.mark.parametrize("name", ["sellcs_spmv", "tsmttsm", "tsmm",
                                  "block_diag", "fused_update"])
def test_cuda_sources_share_one_dtype_policy(name):
    """The accumulation type, promotion and half conversions live in
    ``csrc/dtypes.cuh`` alone; no source keeps a copy of them."""
    src = (PORT / "kernels" / "csrc" / f"{name}.cu").read_text()
    assert '#include "dtypes.cuh"' in src
    for own in ("struct Acc", "struct Promote", "load_as(double",
                "store_as(float", "upcast("):
        assert own not in src, own


def _no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_the_card(monkeypatch):
    _no_gpu(monkeypatch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        from_coo([0], [0], [1.0], (1, 1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        execution.resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sellcs_from_arrays({}, {})
    assert execution.resolve_device("cpu") == torch.device("cpu")
    A = from_coo([0], [0], [1.0], (1, 1), device="cpu")
    assert A.device == torch.device("cpu")


def test_launch_counters():
    execution.reset_launch_counts()
    execution.count_launch("k")
    execution.count_launch("k")
    assert execution.launch_counts()["k"] == 2
    counts = execution.launch_counts()
    counts["k"] = 99                       # a copy, not the counters
    execution.reset_launch_counts()
    assert execution.launch_counts()["k"] == 0


def test_build_layout_and_missing_compiler(monkeypatch, tmp_path):
    assert _build.sources() == ["block_diag", "fused_update", "sellcs_spmv",
                                "tsmm", "tsmttsm"]
    lib = _build._library_path("sellcs_spmv")
    assert lib.parent == REPO / "build" / "repro_torch"
    assert lib.name.startswith("libsellcs_spmv-") and lib.suffix == ".so"
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()


def test_a_header_edit_renames_every_library(monkeypatch, tmp_path):
    """``_library_path`` hashes ``csrc/*.cuh`` too, so a library built
    against an older header is never loaded."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for p in _build.CSRC.iterdir():
        (csrc / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = {n: _build._library_path(n) for n in _build.sources()}
    assert before == {n: _build._library_path(n) for n in _build.sources()}
    with open(csrc / "dtypes.cuh", "a") as f:
        f.write("\n// edited\n")
    after = {n: _build._library_path(n) for n in _build.sources()}
    assert all(after[n] != before[n] for n in before)


def _run_smoke(cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_chip_smoke_fails_alone(tmp_path):
    (tmp_path / "chip_smoke.py").write_text(
        (REPO / "chip_smoke.py").read_text())
    out = _run_smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run in full")
    out = _run_smoke(REPO)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "torch.cuda.is_available() is false" in out.stderr


def test_port_is_lint_clean():
    findings, n = lint_paths([str(PORT)])
    assert n >= 15
    assert findings == [], "\n".join(f.format() for f in findings)


def test_interop_round_trips_bfloat16():
    from repro_torch.interop import tensor_from_array
    ml_dtypes = pytest.importorskip("ml_dtypes")
    a = np.array([1.5, -2.25, 3.0], dtype=ml_dtypes.bfloat16)
    t = tensor_from_array(a, "cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), a.astype(np.float32))


def test_chip_smoke_grid_rehearses_on_cpu(monkeypatch):
    """chip_smoke.py's kernel-against-plain grid, run on the CPU: both
    sides are then the plain version, so this checks the phase's shapes,
    flags and control flow, not the kernel."""
    monkeypatch.syspath_prepend(str(REPO))
    import chip_smoke
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    chip_smoke.phase_grid()


def test_chip_smoke_block_phases_rehearse_on_cpu(monkeypatch):
    """chip_smoke.py's tall-skinny grid, block CG, block MINRES and
    eigensolver phases, run on the CPU at a small size: the kernels' plain
    versions stand in (the launch counts are then 0), so this checks the
    phases' shapes, tolerances and control flow, not the kernels."""
    monkeypatch.syspath_prepend(str(REPO))
    import chip_smoke
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "NX", 12)
    monkeypatch.setattr(chip_smoke, "TSM_NS", (0, 1, 37, 600))
    monkeypatch.setattr(chip_smoke, "TSM_DIMS", (1, 3, 16, 64))
    chip_smoke.phase_tsm_grid()
    r, c, v, n = chip_smoke.laplace3d(12)
    fw = {"A64": from_coo(r, c, v, (n, n), C=32, sigma=1024,
                          dtype=np.float64, device="cpu"),
          "A16": from_coo(r, c, v, (n, n), C=32, sigma=1024,
                          dtype=np.float32, store_dtype=torch.bfloat16,
                          device="cpu")}
    bcg = chip_smoke.phase_block_cg(fw, "cpu rehearsal")
    assert bcg["iters"] > 0 and bcg["state"].it == bcg["iters"]
    chip_smoke.phase_block_minres(fw, "cpu rehearsal")
    chip_smoke.phase_eigen(fw, "cpu rehearsal")


def test_chip_smoke_precond_phases_rehearse_on_cpu(monkeypatch):
    """chip_smoke.py's B4 and B5 grids, preconditioned CG (with the B5
    residual check), preconditioned MINRES and Chebyshev PCG, run on the
    CPU at a small size: the kernels' plain versions stand in (the launch
    counts are then 0), so this checks the phases' shapes, bounds and
    control flow, not the kernels."""
    monkeypatch.syspath_prepend(str(REPO))
    import chip_smoke
    for name, value in (("DEVICE", "cpu"), ("PRECOND_NX", 64),
                        ("CHEB_PCG_NX", 32), ("B4_NB", (0, 1, 7, 40)),
                        ("B5_NS", (0, 1, 37, 600))):
        monkeypatch.setattr(chip_smoke, name, value)
    chip_smoke.phase_b4_grid()
    chip_smoke.phase_b5_grid()
    pcg = chip_smoke.phase_precond_cg("cpu rehearsal")
    assert pcg["iters"] > 0 and pcg["plain_iters"] > pcg["iters"]
    assert pcg["state"].it == pcg["iters"]
    assert chip_smoke.phase_b5_residual(pcg, "cpu rehearsal") == 0
    chip_smoke.phase_precond_minres(pcg, "cpu rehearsal")
    chip_smoke.phase_chebyshev_pcg("cpu rehearsal")

"""The port stands alone: no JAX and nothing of the JAX package under
``src/repro_torch/`` or in ``chip_smoke.py``, no path that hides the card
or the kernel, and entry points that run on the card unless told
otherwise."""
import ast
import dataclasses
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


def test_training_modules_are_scanned():
    """The training half of the LM scaffold is among the files scanned
    for JAX imports, and no file of the port names ``ml_dtypes``."""
    names = {str(p.relative_to(PORT)) for p in PORT_FILES
             if PORT in p.parents}
    assert {"data/pipeline.py", "train/optimizer.py", "train/checkpoint.py",
            "train/trainer.py", "launch/train.py"} <= names
    for path in PORT_FILES:
        assert "ml_dtypes" not in set(_imported_roots(path)), path


def test_planning_layer_is_scanned():
    """The LM scaffold's planning layer (the H100 table and mesh shapes,
    the sharding rules, the dry run, the hill climbing, the cost
    refresh and the roofline) is among the files scanned for JAX
    imports."""
    names = {str(p.relative_to(PORT)) for p in PORT_FILES
             if PORT in p.parents}
    assert {"launch/mesh.py", "launch/costmodel.py", "models/sharding.py",
            "launch/dryrun.py", "launch/hillclimb.py",
            "launch/refresh_costs.py", "launch/roofline.py"} <= names


def test_mesh_training_is_scanned():
    """The multi-device half of training (ranks and the host mesh,
    placement by the sharding rules, the sharded batch, the compressed
    all-reduce, the mesh trainer, the elastic checkpoint, the launcher,
    the MoE's dispatch of a rank's rows) lives in files that are scanned for
    JAX imports and hold no ``try``."""
    from repro_torch.data import pipeline
    from repro_torch.launch import mesh, train
    from repro_torch.models import moe, sharding
    from repro_torch.train import checkpoint, optimizer, trainer
    names = {str(p.relative_to(PORT)) for p in PORT_FILES
             if PORT in p.parents}
    files = {"launch/mesh.py", "models/sharding.py", "data/pipeline.py",
             "train/optimizer.py", "train/trainer.py",
             "train/checkpoint.py", "launch/train.py", "models/moe.py"}
    assert files <= names and files <= set(NO_TRY)
    for module, fns in ((mesh, ("init_ranks", "make_host_mesh")),
                        (sharding, ("shard_index", "shard", "gather")),
                        (pipeline, ("make_global_batch",)),
                        (optimizer, ("compressed_psum",)),
                        (moe, ("RowShare",))):
        assert set(fns) <= set(module.__all__), module.__name__
    assert "mesh" in trainer.Trainer.__init__.__code__.co_varnames
    assert "barrier" in checkpoint.CheckpointManager.__init__.__code__.co_varnames
    assert callable(train.main)


def test_runtime_is_scanned():
    """The serving runtime and the heterogeneous engine are among the
    files scanned for JAX imports."""
    runtime = {p.name for p in PORT_FILES if p.parent.name == "runtime"}
    assert runtime == {"__init__.py", "service.py", "devicepool.py",
                       "split.py", "pipeline.py", "engine.py"}


def test_port_has_its_modules():
    want = {"core/sellcs.py", "core/spmv.py", "core/execution.py",
            "core/blockvec.py",
            "kernels/ops.py", "kernels/ref.py", "kernels/sellcs_spmv.py",
            "kernels/tsmttsm.py", "kernels/tsmm.py",
            "kernels/block_diag.py", "kernels/fused_update.py",
            "kernels/mamba_scan.py",
            "kernels/_build.py", "kernels/csrc/sellcs_spmv.cu",
            "kernels/csrc/tsmttsm.cu", "kernels/csrc/tsmm.cu",
            "kernels/csrc/block_diag.cu", "kernels/csrc/fused_update.cu",
            "kernels/csrc/mamba_scan.cu", "kernels/csrc/dtypes.cuh",
            "models/layers.py", "models/ssm.py", "models/moe.py",
            "models/transformer.py", "configs/base.py",
            "configs/jamba_1_5_large_398b.py", "launch/serve.py",
            "matrices/generators.py", "matrices/mmio.py",
            "solvers/operator.py", "solvers/stepper.py", "solvers/cg.py",
            "solvers/block.py", "solvers/minres.py", "solvers/lanczos.py",
            "solvers/chebfd.py", "solvers/kpm.py", "solvers/precond.py",
            "runtime/__init__.py", "runtime/service.py", "interop.py",
            "core/partition.py", "core/distributed.py",
            "configs/ghost_spmv.py", "launch/costmodel.py",
            "launch/hillclimb.py", "runtime/devicepool.py",
            "runtime/split.py", "runtime/pipeline.py", "runtime/engine.py",
            "data/pipeline.py", "train/optimizer.py", "train/checkpoint.py",
            "train/trainer.py", "launch/train.py", "launch/mesh.py",
            "models/sharding.py", "launch/dryrun.py",
            "launch/refresh_costs.py", "launch/roofline.py"}
    have = {str(p.relative_to(PORT)) for p in PORT.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}
    assert want <= have


NO_TRY = ["kernels/ops.py", "kernels/sellcs_spmv.py", "kernels/tsmttsm.py",
          "kernels/tsmm.py", "kernels/block_diag.py",
          "kernels/fused_update.py", "kernels/mamba_scan.py",
          "kernels/ref.py", "kernels/_build.py", "models/layers.py",
          "models/ssm.py", "models/moe.py", "models/transformer.py",
          "launch/serve.py", "interop.py",
          "core/spmv.py",
          "core/execution.py", "core/blockvec.py", "solvers/block.py",
          "solvers/cg.py", "solvers/minres.py", "solvers/lanczos.py",
          "solvers/chebfd.py", "solvers/kpm.py", "runtime/service.py",
          "core/partition.py", "core/distributed.py", "solvers/operator.py",
          "runtime/devicepool.py", "runtime/split.py", "runtime/pipeline.py",
          "runtime/engine.py", "data/pipeline.py", "train/optimizer.py",
          "train/checkpoint.py", "train/trainer.py", "launch/train.py",
          "models/xlstm.py", "models/sharding.py", "launch/mesh.py",
          "launch/costmodel.py", "launch/hillclimb.py",
          "../../chip_smoke.py"]


@pytest.mark.parametrize("rel", NO_TRY)
def test_no_try_around_build_or_launch(rel):
    """A kernel that fails to build or launch raises; nothing catches it,
    and no phase of chip_smoke.py is wrapped in a ``try``."""
    tree = ast.parse((PORT / rel).read_text())
    assert not any(isinstance(n, ast.Try) for n in ast.walk(tree))
    assert "REPRO_" not in (PORT / rel).read_text()


@pytest.mark.parametrize("name", ["sellcs_spmv", "tsmttsm", "tsmm",
                                  "block_diag", "fused_update", "mamba_scan"])
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
    assert _build.sources() == ["block_diag", "fused_update", "herm_eig",
                                "mamba_scan", "sellcs_spmv", "tsmm",
                                "tsmttsm"]
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


def test_chip_smoke_eig_grid_rehearses_on_cpu(monkeypatch):
    """chip_smoke.py's eigensolver grid on the CPU: ``ops.herm_eig`` is
    ``torch.linalg.eigh`` there, so this checks the matrices, the bounds
    and the control flow, not the kernel."""
    monkeypatch.syspath_prepend(str(REPO))
    import chip_smoke
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "EIG_MS", (1, 3, 17))
    chip_smoke.phase_eig_grid()


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
                        ("B5_NS", (0, 1, 37, 600)), ("B5_WIDE_NS", (0, 37))):
        monkeypatch.setattr(chip_smoke, name, value)
    chip_smoke.phase_b4_grid()
    chip_smoke.phase_b5_grid()
    pcg = chip_smoke.phase_precond_cg("cpu rehearsal")
    assert pcg["iters"] > 0 and pcg["plain_iters"] > pcg["iters"]
    assert pcg["state"].it == pcg["iters"]
    assert chip_smoke.phase_b5_residual(pcg, "cpu rehearsal") == 0
    chip_smoke.phase_precond_minres(pcg, "cpu rehearsal")
    chip_smoke.phase_chebyshev_pcg("cpu rehearsal")


def test_chip_smoke_stepper_phase_rehearses_on_cpu(monkeypatch):
    """chip_smoke.py's comparison of the late-read ``run_chunk`` with the
    loop that reads ``done`` every iteration, on the CPU at a small size
    (the profiler split and the sync count need the card and are left
    out there): it checks the states' equality and the control flow."""
    monkeypatch.syspath_prepend(str(REPO))
    import chip_smoke
    for name, value in (("DEVICE", "cpu"), ("PRECOND_NX", 64),
                        ("STEP_ITERS", {"cg": 7, "cg_precond": 5,
                                        "block_cg": 3, "block_minres": 3})):
        monkeypatch.setattr(chip_smoke, name, value)
    r, c, v, n = chip_smoke.laplace3d(12)
    fw = {"A64": from_coo(r, c, v, (n, n), C=32, sigma=1024,
                          dtype=np.float64, device="cpu")}
    bcg = chip_smoke.phase_block_cg(fw, "cpu rehearsal")
    pcg = chip_smoke.phase_precond_cg("cpu rehearsal")
    execution.reset_launch_counts()
    chip_smoke.phase_stepper(fw, bcg, pcg, "cpu rehearsal")
    assert execution.discarded_counts().get("cg", 0) == 0


def test_chip_smoke_coef_syncs_phase_rehearses_on_cpu(monkeypatch):
    """chip_smoke.py's count of the coefficient hand-over's host syncs, on
    the CPU at a small size: each call (B5 with numbers, real and complex;
    B1 with a Python-float gamma; a ChebFD filter step; a KPM moment step)
    runs once through the plain versions, and nothing is counted (the
    count needs the card)."""
    monkeypatch.syspath_prepend(str(REPO))
    import chip_smoke
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    r, c, v, n = chip_smoke.laplace3d(12)
    fw = {"A64": from_coo(r, c, v, (n, n), C=32, sigma=1024,
                          dtype=np.float64, device="cpu"),
          "A16": from_coo(r, c, v, (n, n), C=32, sigma=1024,
                          dtype=np.float32, store_dtype=torch.bfloat16,
                          device="cpu")}
    execution.reset_launch_counts()
    assert chip_smoke.phase_coef_syncs(fw, "cpu rehearsal") == {}
    assert not any(execution.launch_counts().values())


def test_chip_smoke_lm_phases_rehearse_on_cpu(monkeypatch):
    """chip_smoke.py's B6 grid and slice 8a's phases (prefill, serve,
    float32 decode against forward, MoE), run on the CPU at the registered
    SMOKE widths and small shapes: the scan's plain version stands in (the
    launch counts are then 0), and the MoE phase compares the CPU with
    itself, so this checks the phases' shapes, bounds and control flow,
    not the kernel."""
    monkeypatch.syspath_prepend(str(REPO))
    import chip_smoke
    for name, value in (("DEVICE", "cpu"), ("LM_WIDTHS", "smoke"),
                        ("LM_BATCH", 2), ("LM_SEQ", 12), ("SERVE_PROMPT", 3),
                        ("SERVE_GEN", 4), ("DECODE_SEQ", 6),
                        ("B6_B", (1, 2)), ("B6_S", (1, 7, 70)),
                        ("B6_DI", (1, 9)), ("B6_N", (1, 4, 64))):
        monkeypatch.setattr(chip_smoke, name, value)
    chip_smoke.phase_b6_grid()
    lm = chip_smoke.phase_prefill("cpu rehearsal")
    assert lm["cfg"].moe is None and lm["cfg"].n_layers == 8
    assert lm["cfg"].ssm.scan_impl == "kernel"
    assert chip_smoke._n_mamba(lm["cfg"]) == 7
    chip_smoke.phase_serve(lm, "cpu rehearsal")
    chip_smoke.phase_decode_vs_forward("cpu rehearsal")
    chip_smoke.phase_moe("cpu rehearsal")
    full = chip_smoke.get_config("jamba_1_5_large_398b")
    monkeypatch.setattr(chip_smoke, "LM_WIDTHS", "full")
    cfg = chip_smoke.lm_config(torch.bfloat16)
    assert (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff,
            cfg.vocab_size) == (full.d_model, full.n_heads, full.n_kv_heads,
                                full.d_ff, full.vocab_size)
    assert cfg.ssm.inner(cfg.d_model) == 16384 and cfg.ssm.d_state == 16


@pytest.mark.parametrize("arch", ["llama3_2_3b", "qwen2_5_3b", "minitron_8b",
                                  "mistral_nemo_12b", "qwen2_vl_7b",
                                  "grok_1_314b", "llama4_maverick_400b",
                                  "whisper_medium", "xlstm_1_3b"])
def test_chip_smoke_arch_phases_rehearse_on_cpu(monkeypatch, arch):
    """chip_smoke.py's slice-8b phase for one architecture (prefill,
    serve, float32 decode against forward, the SMOKE model on the "card"
    against the CPU), run on the CPU at the registered SMOKE widths and
    small shapes: it checks the phase's shapes, gates and control flow.
    The widths the phase takes on the card are the JAX package's FULL
    config's, and only the stated cuts in depth differ."""
    from repro.configs import get_config as jax_get_config
    monkeypatch.syspath_prepend(str(REPO))
    import chip_smoke
    assert arch in chip_smoke.ARCHS_8B
    frames = chip_smoke.WHISPER_FRAMES
    for name, value in (("DEVICE", "cpu"), ("LM_WIDTHS", "smoke"),
                        ("LM_BATCH", 2), ("LM_SEQ", 12), ("SERVE_PROMPT", 3),
                        ("SERVE_GEN", 4), ("DECODE_SEQ", 6),
                        ("WHISPER_FRAMES", 24), ("XLSTM_SEQ", 12)):
        monkeypatch.setattr(chip_smoke, name, value)
    row = chip_smoke.phase_arch(arch, "cpu rehearsal")
    assert row["f32_err"] <= chip_smoke.DECODE_TOL
    assert row["card_cpu_err"] == 0.0         # the CPU against itself
    assert (row["B"], row["S"]) == (2, 6 if arch == "whisper_medium" else 12)
    if arch == "xlstm_1_3b":
        assert row["mlstm_bound_by"] in ("state traffic", "launches")

    monkeypatch.setattr(chip_smoke, "LM_WIDTHS", "full")
    cfg = chip_smoke.arch_config(arch, torch.bfloat16)
    ref = jax_get_config(arch)
    for field in ("d_model", "n_heads", "n_kv_heads", "hd", "d_ff",
                  "vocab_size", "pattern", "rope", "rope_theta", "qkv_bias",
                  "norm", "act", "tie_embeddings", "enc_dec",
                  "dec_len_ratio"):
        assert getattr(cfg, field) == getattr(ref, field), field
    for sub in ("moe", "xlstm"):
        assert (getattr(cfg, sub) is None) == (getattr(ref, sub) is None)
        if getattr(ref, sub) is not None:
            assert dataclasses.asdict(getattr(cfg, sub)) == \
                dataclasses.asdict(getattr(ref, sub)), sub
    periods = {"grok_1_314b": 1, "llama4_maverick_400b": 1}.get(arch)
    assert cfg.n_layers == (ref.n_layers if periods is None
                            else periods * ref.period)
    assert cfg.n_enc_layers == ref.n_enc_layers
    one = chip_smoke.arch_config(arch, torch.float32, periods=1)
    assert one.n_layers == ref.period and one.d_model == ref.d_model
    assert one.n_enc_layers == (ref.period if ref.enc_dec else 0)
    if arch == "whisper_medium":
        assert (frames, frames // cfg.dec_len_ratio) == (1500, 187)
    if arch == "llama4_maverick_400b":
        moe = chip_smoke._no_drop(one).moe
        assert int(max(1, 64 * moe.top_k * moe.capacity_factor
                       / moe.n_experts)) == 64


def test_chip_smoke_exp2_phase_rehearses_on_cpu(monkeypatch):
    """chip_smoke.py's check of B6's exponential, on the CPU over a
    stride of the float32 arguments <= 0, with ``torch.exp2`` flushed
    below 2^-126 standing in for ``ex2.approx.ftz``: it checks the
    phase's ulp, relative and absolute measures and its gates."""
    monkeypatch.syspath_prepend(str(REPO))
    import chip_smoke
    for name, value in (("DEVICE", "cpu"), ("EXP2_CHUNK", 1 << 14),
                        ("EXP2_STRIDE", 65537)):
        monkeypatch.setattr(chip_smoke, name, value)
    chip_smoke.phase_b6_exp2()


def test_chip_smoke_finds_the_hot_loop_in_sass(monkeypatch):
    """The build phase's count of instructions per state update: the
    innermost backward branch with the most MUFU.EX2, per instance."""
    monkeypatch.syspath_prepend(str(REPO))
    import chip_smoke
    sass = """
        Function : _ZN12_GLOBAL__N_115mamba_scan_rowsILi1ELi16EEEvPKfS2_
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   MUFU.EX2 R2, R2 ;
        /*0020*/                   FMUL R3, R2, R4 ;
        /*0030*/                   MUFU.EX2 R5, R3 ;
        /*0040*/                   FFMA R6, R5, R6, R7 ;
        /*0050*/                   LDS.128 R8, [R9] ;
        /*0060*/               @P0 BRA 0x30 ;
        /*0070*/                   MUFU.EX2 R2, R2 ;
        /*0080*/              @!P1 BRA 0x70 ;
        /*0090*/                   EXIT ;
        /*00a0*/                   BRA 0xa0;
        Function : _ZN12_GLOBAL__N_110exp2_applyEPKfPfx
        /*0000*/                   MUFU.EX2 R2, R2 ;
        /*0010*/                   BRA 0x0 ;
    """
    n, mufu, hist = chip_smoke.hot_loops(sass)["<1,16>"]
    assert (n, mufu) == (4, 1)
    assert hist == {"MUFU": 1, "FFMA": 1, "LDS": 1, "BRA": 1}
    assert list(chip_smoke.hot_loops(sass)) == ["<1,16>"]


def test_chip_smoke_serving_phase_rehearses_on_cpu(monkeypatch):
    """chip_smoke.py's serving phase (slice 6: mixed traffic against one
    solve per request, FIFO against bucketed SLO traffic, block and
    block-Jacobi requests, card against CPU under a virtual clock, the
    drain split), run on the CPU at a small size: the kernels' plain
    versions stand in (the launch counts are then 0, and the est_iter_s
    gate, a statement about the card's clock, is only printed), so this
    checks the phase's requests, gates and control flow, not the
    kernels."""
    monkeypatch.syspath_prepend(str(REPO))
    import chip_smoke
    for name, value in (("DEVICE", "cpu"), ("PRECOND_NX", 32),
                        ("SERVE_REQUESTS", 10), ("SLO_HARD", 2),
                        ("SLO_EASY", 6), ("SERVE_BLOCK", 4),
                        ("SERVE_PRECOND_NX", 32), ("SERVE_PRECOND", 3),
                        ("SERVE_VC_NX", 6)):
        monkeypatch.setattr(chip_smoke, name, value)
    r, c, v, n = chip_smoke.laplace3d(10)
    fw = {"A64": from_coo(r, c, v, (n, n), C=32, sigma=1024,
                          dtype=np.float64, device="cpu")}
    pcg = {"A": chip_smoke._aniso(32)}
    chip_smoke.phase_serving(fw, pcg, "cpu rehearsal")


def test_chip_smoke_engine_phases_rehearse_on_cpu(monkeypatch):
    """chip_smoke.py's slice-7 phases (the paper's workload on 1 and 4
    shards and on two, CG through DistOperator, the rebalance loop and
    engine-backed serving), run on the CPU with every shard on the host
    and the ``smoke`` workload: the plain version stands in for B1 (the
    launch counts are then 0), so this checks the phases' gates and
    control flow, not the kernel.  (The bandwidth phase needs the card.)"""
    monkeypatch.syspath_prepend(str(REPO))
    import chip_smoke
    for name, value in (("DEVICE", "cpu"), ("MLGEER", "smoke"),
                        ("REBALANCE_CALLS", 2)):
        monkeypatch.setattr(chip_smoke, name, value)
    mlg = chip_smoke.phase_mlgeer("cpu rehearsal")
    assert mlg["launches"] == 0 and set(mlg["ms"]) == {
        "1 card shard", "4 card shards", "cpu + card"}
    r, c, v, n = chip_smoke.laplace3d(10)
    fw = {"coo": (r, c, v, n), "solve_s": {"f64": 1.0}, "iters64": 1,
          "A64": from_coo(r, c, v, (n, n), C=32, sigma=1024,
                          dtype=np.float64, device="cpu"),
          "b_host": np.random.default_rng(0).standard_normal((n, 4))}
    ecg = chip_smoke.phase_engine_cg(fw, "cpu rehearsal")
    assert ecg["4 card shards"]["iters"] == ecg["cpu + card"]["iters"] > 0
    reb = chip_smoke.phase_rebalance(ecg["cpu + card"]["eng"], fw,
                                     "cpu rehearsal")
    assert len(reb["gens"]) == chip_smoke.REBALANCE_STEPS + 1
    assert chip_smoke.phase_engine_serving(ecg["4 card shards"]["eng"], fw,
                                           "cpu rehearsal") == 0


def test_chip_smoke_train_phase_rehearses_on_cpu(monkeypatch):
    """chip_smoke.py's phase 23 (the full-width train step, every
    architecture's SMOKE train step on the "card" against the CPU, kill
    and restart), run on the CPU at the registered SMOKE widths and a
    short sequence: it checks the phase's steps, gates and control flow.
    The full-width step's widths on the card are llama3.2-3b's published
    ones."""
    monkeypatch.syspath_prepend(str(REPO))
    import chip_smoke
    assert (chip_smoke.TRAIN_BATCH, chip_smoke.TRAIN_SEQ) == (2, 2048)
    for name, value in (("DEVICE", "cpu"), ("LM_WIDTHS", "smoke"),
                        ("TRAIN_SEQ", 16), ("TRAIN_STEPS", 3)):
        monkeypatch.setattr(chip_smoke, name, value)
    out = chip_smoke.phase_train("cpu rehearsal")
    assert np.isfinite(out["first"]["loss"]) and out["last"]["gnorm"] > 0
    assert out["bound_ms"] > 0
    assert set(out["card_cpu"]) == set(chip_smoke.list_archs())
    assert all(err == 0.0 for err in out["card_cpu"].values())
    assert out["f32_card_cpu"] == 0.0
    assert out["resume"]["rest"] == 0.0          # the CPU: bit for bit
    assert not (REPO / "build" / "chip_smoke_train").exists()
    monkeypatch.setattr(chip_smoke, "LM_WIDTHS", "full")
    cfg = chip_smoke.arch_config(chip_smoke.TRAIN_ARCH, torch.bfloat16)
    assert (cfg.n_layers, cfg.d_model, cfg.vocab_size) == (28, 3072, 128256)


def test_chip_smoke_dryrun_phase_rehearses_on_cpu(monkeypatch):
    """chip_smoke.py's dry-run phase on the CPU: the structural pass of
    all 32 cells and the roofline over them (the measured pass needs the
    card and is left out there); the measured cells are dry-run cells and
    jamba's train cell is among them."""
    from repro_torch.configs import dryrun_cells
    from repro_torch.launch import dryrun as DR
    monkeypatch.syspath_prepend(str(REPO))
    import chip_smoke
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(DR, "OUT_DIR", DR.OUT_DIR)
    assert chip_smoke.phase_dryrun("cpu rehearsal") == {}
    assert not (REPO / "build" / "chip_smoke_dryrun").exists()
    assert set(chip_smoke.DRYRUN_MEASURED) <= set(dryrun_cells())
    assert set(chip_smoke.DRYRUN_NO_FIT) <= set(chip_smoke.DRYRUN_MEASURED)


def test_chip_smoke_mesh_phase_rehearses_on_cpu(monkeypatch):
    """chip_smoke.py's phase 25 (training on a mesh of 4 ranks) on the
    CPU: four ``gloo`` ranks, ``compressed_psum``, the SMOKE parity of
    every layout (an MoE config at its own capacity factor too), resume
    and elastic restore, and the full-width part at
    the registered SMOKE widths and a short sequence (the ranks take the
    settings of this process); the card run's shapes are llama3.2-3b's
    published widths, 2 periods, global batch 4 x S 2048 on (2, 2)."""
    monkeypatch.syspath_prepend(str(REPO))
    import chip_smoke
    assert (chip_smoke.MESH_FULL_BATCH, chip_smoke.MESH_FULL_SEQ,
            chip_smoke.MESH_FULL_PERIODS) == (4, 2048, 2)
    for name, value in (("DEVICE", "cpu"), ("LM_WIDTHS", "smoke"),
                        ("MESH_PSUM_N", 1000), ("MESH_FULL_SEQ", 16),
                        ("MESH_FULL_TIMED", 1)):
        monkeypatch.setattr(chip_smoke, name, value)
    out = chip_smoke.phase_mesh("cpu rehearsal")
    assert out["backend"] == "gloo" and len(out["ranks"]) == 4
    for rank in out["ranks"]:
        assert rank["devices"] == ["cpu"] * 4
        assert rank["psum"]["err16"] <= 2.0 ** -6
        assert len(rank["smoke"]) == 3 * 3 + 1
        full = rank["full"]
        assert len(full["resumed"]) == 2 and np.isfinite(full["losses"]).all()
        assert full["gap"] <= chip_smoke.MESH_BF16_TOL
        assert 10 * full["gap"] <= full["gap_control"]
        assert all(r["held_o"] == r["want_o"] > 0 for r in full["per_rank"])
    assert not (REPO / "build" / "chip_smoke_mesh").exists()

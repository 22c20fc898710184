"""chip_smoke.py's phases of the instances past the narrow designs
(phases 12b-12d), rehearsed on the CPU at a small size.

A file of its own, apart from ``tests/test_torch_isolation.py``'s other
rehearsals, so that a run that spreads the files over workers runs it
beside them, not after them.
The plain versions stand in for the kernels there (the launch counts are
then 0), so the test checks the phases' shapes, bounds and control flow,
not the kernels.
"""
import types
from pathlib import Path

import numpy as np
import torch

from repro_torch.core import from_coo

REPO = Path(__file__).resolve().parents[1]


def test_chip_smoke_wide_phases_rehearse_on_cpu(monkeypatch):
    """chip_smoke.py's phases of the instances past the narrow designs
    (the wide grid, block CG at width 128, the wide timing rows and the
    paths of B1's tall chunks, B4 at bs = 128 and B6 at N = 128) on the
    CPU at a small size, each timed call run once in place of the card's
    timer: the plain versions stand in for the kernels (the launch counts
    are then 0), so this checks the phases' shapes, bounds and control
    flow, not the kernels."""
    monkeypatch.syspath_prepend(str(REPO))
    import chip_smoke
    for name, value in (("DEVICE", "cpu"), ("NX", 12),
                        ("WIDE_TSM_NS", (37,)), ("WIDE_B4_NB", (1,)),
                        ("WIDE_EIG_MS", (65,)), ("WIDE_C", (512, None)),
                        ("WIDE_B1_B", (4,)),
                        ("WIDE_B6", ((1, 20, 8, 65), (1, 5, 8, 520),
                                     (65537, 2, 2, 16))),
                        ("WIDE_B1_ROWS", {512: 600, 4096: 4100, None: 700}),
                        ("WIDE_B4_ROWS", 1024), ("WIDE_PCG_NX", 64),
                        ("WIDE_B6_SHAPE", (1, 40, 64)),
                        ("WIDE_B6_CHECK_S", 16)):
        monkeypatch.setattr(chip_smoke, name, value)
    chip_smoke.phase_wide_grid()
    r, c, v, n = chip_smoke.laplace3d(12)
    fw = {"A64": from_coo(r, c, v, (n, n), C=32, sigma=1024,
                          dtype=np.float64, device="cpu"),
          "coo": (r, c, v, n), "iters64": 0,
          "b_host": np.random.default_rng(0).standard_normal((n, 4))}
    bcg = chip_smoke.phase_block_cg_wide(fw, "cpu rehearsal")
    assert bcg["iters"] > 0
    monkeypatch.setattr(chip_smoke, "time_ms", lambda fn, **kw: (fn(), 1.0)[1])
    monkeypatch.setattr(chip_smoke, "_sm_clock_hz", lambda: 1.98e9)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: types.SimpleNamespace(
                            multi_processor_count=132))
    rows, launches = chip_smoke.phase_wide_timing(fw, bcg, "cpu rehearsal")
    for key in (("tsmttsm", "kahan"), ("tsmm", "with W"), "herm_eig",
                "sellcs_spmv", "block_diag_matmul", "mamba_scan"):
        assert rows[key]["bound_ms"] > 0 and rows[key]["ms"] == 1.0
    assert rows[("tsmttsm", "kahan")]["library_ms"] == 1.0
    assert set(launches) == {"sellcs_spmv", "block_diag_matmul",
                             "mamba_scan"}


def test_chip_smoke_mixed_phase_rehearses_on_cpu(monkeypatch):
    """chip_smoke.py's mixed-dtype phase (13e: every new pair of B1-B4, B2
    past shared memory, B1's real values under complex128 x, the two
    solves against the plain versions' counts) on the CPU at a small size,
    the timer run once: the plain versions stand in for the kernels, so
    this checks the phase's shapes, gates and control flow."""
    monkeypatch.syspath_prepend(str(REPO))
    import chip_smoke
    for name, value in (("DEVICE", "cpu"), ("NX", 12), ("MIXED_N", 99),
                        ("MIXED_MK", ((16, 16),)), ("MIXED_BS", (32,)),
                        ("MIXED_B1_NX", 6),
                        ("MIXED_WIDE", ((torch.float32, 8400),)),
                        ("MIXED_WIDE_N", 3), ("MIXED_PCG_NX", 32),
                        ("MIXED_HOST_NX", 12), ("MIXED_HOST_PCG_NX", 32)):
        monkeypatch.setattr(chip_smoke, name, value)
    monkeypatch.setattr(chip_smoke, "time_ms", lambda fn, **kw: (fn(), 1.0)[1])
    r, c, v, n = chip_smoke.laplace3d(12)
    fw = {"A64": from_coo(r, c, v, (n, n), C=32, sigma=1024,
                          dtype=np.float64, device="cpu")}
    out = chip_smoke.phase_mixed_dtypes(fw, "cpu rehearsal")
    assert out["column"]["iters"] == out["column"]["plain_iters"] == 49
    assert out["pcg"]["iters"] == out["pcg"]["plain_iters"] > 0
    host = list(out["host"].values())
    assert host[0]["iters"] == {"cpu": 49}
    assert host[1]["iters"]["cpu"] > 0
